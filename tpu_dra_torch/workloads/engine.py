"""Serving engine: continuous batching over a paged KV cache.

Counterpart of ``tpu_dra/workloads/engine.py`` for greedy serving: the
sequence-state store (:class:`_Sequence`), FIFO admission gated on a
free slot and a worst-case page reservation, batched chunked prefill
(chunks of every prefilling sequence in one padded bucket per
iteration), and decode in chunks of ``scan_chunk`` steps with
admission and eviction only between chunks. The exact-parity oracles
are the same knobs: ``contiguous=True`` (fixed consecutive page
ranges) and ``fused=False`` (one host round trip per token) must give
the same tokens as the paged, fused engine.

The JAX engine jits a ``lax.scan`` over the chunk; here the chunk is a
Python loop over ``steps`` eager decode steps that returns ``[steps,
B]`` tokens with ONE device->host copy per chunk, and the device copies
of (tables, lengths, last tokens, active) are fed back between chunks
until host bookkeeping changes (``_dev_state``). Each decode step runs
the paged-decode attention and the fused decode MLP once per layer —
the CUDA kernels on the card, their torch twins on the CPU.

Entry points run on the card: ``Engine(..., device=None)`` means
``"cuda"`` and raises RuntimeError without a CUDA device; tests pass
``device="cpu"``.

Not in this slice, refused at construction or in ``add_request``
rather than ignored: sampling (``temperature > 0``), speculative
decoding (``spec_k``), int8 KV and int8 weights, mesh sharding, prefix
sharing (``Request.prefix_id``), lease gates other than the always-open
one, and metrics export.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_dra_torch.workloads import paged_kv
from tpu_dra_torch.workloads.convert import unroll_tree
from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.generate import (
    KV_QUANT_MODES,
    WEIGHT_QUANT_MODES,
    _finish_block,
    _mm,
    _project_qkv,
    _rms,
)
from tpu_dra_torch.workloads.models.llama import (
    LlamaConfig,
    as_tree,
    rope_frequencies,
)
from tpu_dra_torch.workloads.ops.attention import (
    paged_decode_attention,
    paged_multiquery_attention,
)


class LeaseGate:
    """May the engine touch the chip right now? The always-open gate
    (exclusive claim, no multiplexing) — the only one this slice
    serves behind."""

    def ready(self) -> bool:
        return True

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return True

    def close(self) -> None:
        pass


@dataclasses.dataclass
class Request:
    rid: str
    prompt: np.ndarray  # 1-D int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0  # offset on the engine's clock; 0 = immediate
    ttft_preobserved: bool = False
    prefix_id: "str | None" = None
    prefix_len: int = 0
    sample_seed: "int | None" = None
    sample_serial: "int | None" = None


@dataclasses.dataclass
class Completion:
    rid: str
    tokens: np.ndarray  # the generated tokens (prompt excluded)
    t_submit: float
    t_arrival: float  # t_submit + the request's trace arrival offset
    t_first_token: float
    t_done: float

    @property
    def latency_s(self) -> float:
        """Completion latency from ARRIVAL."""
        return self.t_done - self.t_arrival

    @property
    def ttft_s(self) -> float:
        return self.t_first_token - self.t_arrival


class _Sequence:
    """Engine-internal per-request state (the sequence-state store)."""

    __slots__ = (
        "req", "context", "out", "slot", "pages", "reserved_left",
        "prefill_cursor", "prefill_done", "t_submit", "t_first", "drains",
        "serial", "sample_serial",
    )

    def __init__(self, req: Request, t_submit: float, serial: int = 0):
        self.serial = serial  # admission order
        self.sample_serial = (
            req.sample_serial if req.sample_serial is not None else serial
        )
        self.req = req
        self.context = np.asarray(req.prompt, np.int32)
        self.out: List[int] = []  # every emitted token
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        self.reserved_left = 0
        self.prefill_cursor = 0
        self.prefill_done = False
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        self.drains = 0

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.out)


@dataclasses.dataclass
class EngineConfig:
    page_size: int = 16
    max_slots: int = 4
    max_pages_per_seq: int = 16
    num_pages: int = 0  # 0 => 1 + max_slots * max_pages_per_seq
    scan_chunk: int = 8  # decode steps per chunk
    prefill_chunk: int = 32  # Sarathi chunk budget per engine iteration
    kv_quant: str = "none"
    weight_quant: str = "none"
    fused: bool = True  # one host copy per chunk; False = per-token oracle
    contiguous: bool = False  # unpaged oracle: fixed consecutive pages
    temperature: float = 0.0
    top_k: int = 0
    sample_seed: int = 0
    sharded: bool = False
    spec_k: int = 0
    spec_lookup_order: int = 3
    # 0 = one bucket holds every prefilling sequence; n caps its rows.
    prefill_batch: int = 0
    prefix_cache_entries: int = 8

    def resolved_num_pages(self) -> int:
        return self.num_pages or 1 + self.max_slots * self.max_pages_per_seq


def _check_supported(ec: EngineConfig, gate, metrics) -> None:
    if ec.scan_chunk < 1 or ec.prefill_chunk < 1:
        raise ValueError("scan_chunk and prefill_chunk must be >= 1")
    if ec.spec_k < 0 or ec.prefill_batch < 0:
        raise ValueError("spec_k and prefill_batch must be >= 0")
    if ec.kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"unknown kv_quant {ec.kv_quant!r}")
    if ec.weight_quant not in WEIGHT_QUANT_MODES:
        raise ValueError(f"unknown weight_quant {ec.weight_quant!r}")
    unported = [
        (ec.temperature > 0.0, "sampling (temperature > 0)"),
        (ec.spec_k > 0, "speculative decoding (spec_k > 0)"),
        (ec.kv_quant == "int8", "int8 KV (kv_quant='int8')"),
        (ec.weight_quant == "int8", "int8 weights (weight_quant='int8')"),
        (ec.sharded, "mesh-sharded decode (sharded=True)"),
        (
            gate is not None and type(gate) is not LeaseGate,
            "lease gates other than the always-open LeaseGate",
        ),
        (metrics is not None, "metrics export"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to the torch engine yet"
            )


class Engine:
    """Continuous-batching greedy serving engine over a paged KV cache.

    ``params`` is a :class:`~.models.llama.LlamaParams` or a nested dict
    of tensors in either layout (stacked trees are unrolled once).
    ``device`` defaults to the CUDA device (see :func:`resolve_device`).
    """

    def __init__(
        self,
        config: LlamaConfig,
        params,
        engine_config: Optional[EngineConfig] = None,
        gate: Optional[LeaseGate] = None,
        metrics=None,
        clock=time.monotonic,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.ec = engine_config or EngineConfig()
        _check_supported(self.ec, gate, metrics)
        self.params = unroll_tree(as_tree(params, self.device))
        self.gate = gate or LeaseGate()
        self.clock = clock

        P = self.ec.resolved_num_pages()
        if self.ec.contiguous:
            need = 1 + self.ec.max_slots * self.ec.max_pages_per_seq
            if P < need:
                raise ValueError(
                    f"contiguous mode needs {need} pages "
                    f"(1 + slots*max_pages_per_seq), got {P}"
                )
        self.cache = paged_kv.init_paged_cache(
            config, P, self.ec.page_size, device=self.device
        )
        self.allocator = paged_kv.PageAllocator(P)
        B, M = self.ec.max_slots, self.ec.max_pages_per_seq
        self._tables = np.zeros((B, M), np.int32)  # SCRATCH_PAGE default
        self._lengths = np.zeros((B,), np.int32)
        self._last_tokens = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._slots: List[Optional[_Sequence]] = [None] * B
        # Device copies of (tables, lengths, last, active): a chunk's
        # lengths/last outputs feed the next chunk directly; any
        # host-side mutation (page alloc, admission, eviction, prefill)
        # invalidates them.
        self._dev_state = None

        self._queue: collections.deque = collections.deque()
        self._prefilling: collections.deque = collections.deque()
        self._pending_zero: List[int] = []
        self._serial = 0
        self._rids: set = set()
        self._progress = 0
        self.completed: Dict[str, Completion] = {}
        # Work counters (read by chip_smoke.py and the tests): decode
        # steps run, host seconds spent in decode chunks (each ends in
        # its device->host copy), and prefill buckets of chunk length 1
        # (their s=1 layers also run the fused decode MLP).
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.prefill_single_token_buckets = 0

    # --- public API ------------------------------------------------------

    def add_request(self, req: Request) -> None:
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: need >= 1 prompt token and >= 1 "
                f"new token"
            )
        if req.rid in self._rids:
            raise ValueError(f"duplicate request rid {req.rid!r}")
        if req.prefix_id is not None:
            raise NotImplementedError(
                f"request {req.rid}: prefix sharing (prefix_id) is not "
                f"ported to the torch engine yet"
            )
        if (
            req.sample_seed is not None
            and req.sample_seed != self.ec.sample_seed
        ):
            raise ValueError(
                f"request {req.rid}: pinned sample_seed "
                f"{req.sample_seed} != engine seed {self.ec.sample_seed}"
            )
        total = len(req.prompt) + req.max_new_tokens + self.ec.scan_chunk
        if total > self.ec.max_pages_per_seq * self.ec.page_size:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} (+ chunk slack "
                f"{self.ec.scan_chunk}) exceeds the per-sequence page "
                f"budget {self.ec.max_pages_per_seq}x{self.ec.page_size}"
            )
        self._rids.add(req.rid)
        self._serial += 1
        self._queue.append(
            _Sequence(req, t_submit=self.clock(), serial=self._serial)
        )

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._prefilling or any(self._slots))

    @property
    def progress(self) -> int:
        """Monotonic heartbeat: bumps on every admission, prefill chunk
        and decode chunk that moved work."""
        return self._progress

    def step(self) -> bool:
        """One engine iteration: admissions, one prefill bucket, one
        decode chunk. Returns True while work remains."""
        now = self.clock()
        self._admit(now)
        self._prefill_tick(now)
        self._decode_tick(now)
        return self.busy

    def run(
        self, requests=None, poll_seconds: float = 0.002
    ) -> Dict[str, Completion]:
        """Submit ``requests`` (optional) and step until idle, sleeping
        while the queue waits on a future arrival."""
        for r in requests or []:
            self.add_request(r)
        while self.busy:
            before = self._progress
            self.step()
            if self._progress == before:
                time.sleep(poll_seconds)
        self._flush_zero()
        return self.completed

    def close(self) -> None:
        self.gate.close()

    # --- admission / slots ------------------------------------------------

    def _pages_for(self, seq: _Sequence) -> int:
        """Worst-case page count: full context + every generated token +
        one decode chunk of post-completion slack."""
        total = len(seq.context) + seq.remaining + self.ec.scan_chunk
        return -(-total // self.ec.page_size)

    def _admit(self, now: float) -> None:
        while self._queue:
            seq = self._queue[0]
            if seq.t_submit + seq.req.arrival_s > now and not seq.drains:
                return  # FIFO: the head hasn't arrived yet
            slot = next(
                (i for i, s in enumerate(self._slots) if s is None), None
            )
            if slot is None:
                return
            need = self._pages_for(seq)
            if not self.ec.contiguous and not self.allocator.reserve(need):
                # Admission waits until evictions free pages (FIFO).
                if not any(s is not None for s in self._slots):
                    raise paged_kv.PageExhaustedError(
                        f"request {seq.req.rid} needs {need} pages but "
                        f"the pool ({self.allocator.num_pages} pages) "
                        f"cannot cover it even empty — raise num_pages "
                        f"or lower max_pages_per_seq"
                    )
                return
            self._queue.popleft()
            seq.slot = slot
            seq.reserved_left = 0 if self.ec.contiguous else need
            self._slots[slot] = seq
            self._dev_state = None
            self._prefilling.append(seq)
            self._progress += 1

    def _flush_zero(self) -> None:
        """Batch-zero every page released since the last flush; runs
        before any page can be re-allocated."""
        if self._pending_zero:
            paged_kv.zero_pages(self.cache, self._pending_zero)
            self._pending_zero = []

    def _alloc_page(self, seq: _Sequence) -> int:
        self._flush_zero()
        if self.ec.contiguous:
            page = 1 + seq.slot * self.ec.max_pages_per_seq + len(seq.pages)
        else:
            self.allocator.unreserve(1)
            seq.reserved_left -= 1
            page = self.allocator.alloc()
        seq.pages.append(page)
        self._tables[seq.slot, len(seq.pages) - 1] = page
        self._dev_state = None
        return page

    def _ensure_pages(self, seq: _Sequence, upto: int) -> None:
        """Grow the block table until it covers positions [0, upto)."""
        need = -(-upto // self.ec.page_size)
        while len(seq.pages) < need:
            self._alloc_page(seq)

    def _release_slot(self, slot: int) -> None:
        seq = self._slots[slot]
        freed = []
        if not self.ec.contiguous:
            for page in seq.pages:
                if self.allocator.decref(page):
                    freed.append(page)
            if seq.reserved_left:
                self.allocator.unreserve(seq.reserved_left)
                seq.reserved_left = 0
        else:
            freed = list(seq.pages)
        # Zeroing is deferred and batched (_flush_zero) before reuse.
        self._pending_zero.extend(freed)
        seq.pages = []
        seq.slot = None
        self._slots[slot] = None
        self._tables[slot] = paged_kv.SCRATCH_PAGE
        self._lengths[slot] = 0
        self._last_tokens[slot] = 0
        self._active[slot] = False
        self._dev_state = None

    # --- prefill ----------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> a device copy (never a view of the host array,
        which the bookkeeping mutates in place)."""
        return torch.tensor(arr, device=self.device)

    def _prefill_tick(self, now: float) -> None:
        """One batched-prefill iteration: chunks from up to
        ``prefill_batch`` (0 = all) prefilling sequences in ONE padded
        bucket; the chunk length and the row count are padded to powers
        of two (row count capped at max_slots). Pad positions and idle
        rows write to the scratch page."""
        if not self._prefilling:
            return
        limit = (
            len(self._prefilling) if self.ec.prefill_batch == 0
            else self.ec.prefill_batch
        )
        rows = list(self._prefilling)[:limit]
        takes = [
            min(self.ec.prefill_chunk, len(seq.context) - seq.prefill_cursor)
            for seq in rows
        ]
        bucket = 1
        while bucket < max(takes):
            bucket *= 2
        bucket = min(bucket, self.ec.prefill_chunk)
        B = 1
        while B < len(rows):
            B *= 2
        B = min(B, self.ec.max_slots)
        tokens = np.zeros((B, bucket), np.int32)
        starts = np.zeros((B,), np.int32)
        valids = np.zeros((B,), np.int32)
        trows = np.zeros((B,) + self._tables.shape[1:], np.int32)
        for i, (seq, take) in enumerate(zip(rows, takes)):
            self._ensure_pages(seq, seq.prefill_cursor + take)
            tokens[i, :take] = seq.context[
                seq.prefill_cursor: seq.prefill_cursor + take
            ]
            starts[i] = seq.prefill_cursor
            valids[i] = take
            trows[i] = self._tables[seq.slot]
        if bucket == 1:
            self.prefill_single_token_buckets += 1
        logits = _prefill_batch(
            self.config, self.params, self.cache, self._upload(trows),
            self._upload(starts), self._upload(tokens), self._upload(valids),
        )
        logits_h = None
        finished: List[_Sequence] = []
        for i, (seq, take) in enumerate(zip(rows, takes)):
            slot = seq.slot
            seq.prefill_cursor += take
            if seq.prefill_cursor == len(seq.context):
                finished.append(seq)
                seq.prefill_done = True
                if logits_h is None:
                    logits_h = logits.cpu().numpy()
                first = self._pick_first(logits_h[i])
                self._record_tokens(seq, [first])
                if seq.slot is not None:  # not finished by that token
                    self._lengths[slot] = len(seq.context)
                    self._last_tokens[slot] = first
                    self._active[slot] = True
        for seq in finished:
            self._prefilling.remove(seq)
        self._progress += 1
        self._dev_state = None

    def _pick_first(self, logits: np.ndarray) -> int:
        """First generated token from the prefill logits (greedy)."""
        return int(np.argmax(logits))

    # --- decode ------------------------------------------------------------

    def _decode_tick(self, now: float) -> None:
        if not self._active.any():
            return
        steps = self.ec.scan_chunk
        for slot, seq in enumerate(self._slots):
            if seq is not None and self._active[slot]:
                self._ensure_pages(seq, int(self._lengths[slot]) + steps)
        if self._dev_state is None:
            self._dev_state = (
                self._upload(self._tables),
                self._upload(self._lengths),
                self._upload(self._last_tokens),
                self._upload(self._active),
            )
        tables_d, lengths_d, last_d, active_d = self._dev_state
        t0 = time.perf_counter()
        if self.ec.fused:
            lengths, last, out_d = _decode_chunk(
                self.config, self.params, self.cache, tables_d, lengths_d,
                last_d, active_d, steps=steps,
            )
            out = out_d.cpu().numpy()  # the chunk's one device->host copy
        else:
            # Per-token oracle: the same step math, one host copy per
            # token.
            lengths, last, outs = lengths_d, last_d, []
            for _ in range(steps):
                lengths, last, _ = _decode_step(
                    self.config, self.params, self.cache, tables_d,
                    lengths, last, active_d,
                )
                outs.append(last.cpu().numpy())
            out = np.stack(outs)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += steps
        self._dev_state = (tables_d, lengths, last, active_d)
        # Host mirror without another copy: every active slot advanced
        # one position per step, and the last step's tokens are every
        # slot's last token (inactive slots pass theirs through).
        self._lengths = self._lengths + steps * self._active.astype(np.int32)
        self._last_tokens = np.array(out[-1], np.int32)
        active_slots = [
            (slot, seq) for slot, seq in enumerate(self._slots)
            if seq is not None and self._active[slot]
        ]
        for slot, seq in active_slots:
            self._record_tokens(seq, out[:, slot].tolist())

    def _record_tokens(self, seq: _Sequence, toks) -> None:
        # Clock read after the chunk's host copy, so latencies include
        # the chunk's own compute.
        now = self.clock()
        take = min(len(toks), seq.remaining)
        if take <= 0:
            return
        if seq.t_first is None:
            seq.t_first = now
        seq.out.extend(int(t) for t in toks[:take])
        self._progress += 1
        if seq.remaining == 0:
            self._finish(seq, now)

    def _finish(self, seq: _Sequence, now: float) -> None:
        if seq.req.rid in self.completed:
            return
        self._release_slot(seq.slot)
        self.completed[seq.req.rid] = Completion(
            rid=seq.req.rid,
            tokens=np.asarray(seq.out, np.int32),
            t_submit=seq.t_submit,
            t_arrival=seq.t_submit + seq.req.arrival_s,
            t_first_token=seq.t_first if seq.t_first is not None else now,
            t_done=now,
        )


# --- forward functions ---------------------------------------------------


def _embed(c: LlamaConfig, params: dict, tokens: torch.Tensor):
    return params["embed"]["embedding"].to(c.dtype)[tokens.long()]


def _decode_step(c, params, cache, tables, lengths, tokens, active):
    """One paged decode step for the whole slot batch. tables [B, M],
    lengths/tokens [B] int32, active [B] bool. Writes each active
    slot's new K/V at position ``lengths`` in place (inactive slots
    write to the scratch page and attend with length 0), then attends
    and runs the fused MLP once per layer. Returns (lengths after the
    write, next tokens — inactive slots pass theirs through, fp32
    logits [B, vocab])."""
    B = tokens.shape[0]
    page = cache.page_size
    x = _embed(c, params, tokens)[:, None, :]  # [B, 1, d]
    cos, sin = rope_frequencies(c, lengths[:, None])  # [B, 1, hd/2]
    rows = torch.clamp(lengths // page, max=tables.shape[1] - 1).long()
    pids = torch.gather(tables, 1, rows[:, None])[:, 0]
    pids = torch.where(active, pids, paged_kv.SCRATCH_PAGE).long()
    offs = torch.where(active, lengths % page, 0).long()
    len_eff = lengths + active.to(lengths.dtype)
    for layer in range(c.n_layers):
        lp = params[f"layer_{layer}"]
        q, k, v = _project_qkv(c, lp, x, cos, sin, B, 1)
        cache.k[layer][pids, offs] = k[:, 0]
        cache.v[layer][pids, offs] = v[:, 0]
        out = paged_decode_attention(
            q[:, 0], cache.k[layer], cache.v[layer], tables, len_eff,
            impl=c.paged_decode_impl,
        )[:, None].to(c.dtype)
        x = _finish_block(c, lp, x, out, B, 1)
    x = _rms(x, params["final_norm"]["scale"], c.norm_eps)
    logits = _mm(x, params["lm_head"]).to(torch.float32)[:, 0]
    nxt = torch.where(active, _pick_tokens(logits, tokens.dtype), tokens)
    return len_eff, nxt, logits


def _pick_tokens(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Greedy next tokens for the slot batch (ties to the lowest id,
    as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(dtype)


def _decode_chunk(c, params, cache, tables, lengths, tokens, active, *,
                  steps: int):
    """``steps`` decode steps back to back on the device (the JAX
    engine's ``lax.scan`` chunk). Returns (lengths, last tokens, tokens
    [steps, B]) as device tensors; the caller copies the tokens to the
    host once."""
    outs = []
    for _ in range(steps):
        lengths, tokens, _ = _decode_step(
            c, params, cache, tables, lengths, tokens, active
        )
        outs.append(tokens)
    return lengths, tokens, torch.stack(outs)


def _prefill_batch(c, params, cache, tables, starts, tokens, valids):
    """One batched prefill bucket: row i writes and attends its chunk
    tokens[i, :valids[i]] at positions starts[i] + j through its table
    (pad positions and idle rows write to the scratch page and are never
    read). Returns fp32 logits [B, vocab] at each row's last valid
    position (only rows finishing their prefill read them)."""
    B, s = tokens.shape
    page = cache.page_size
    dev = tokens.device
    ar = torch.arange(s, device=dev)
    positions = starts[:, None] + ar[None]  # [B, s]
    in_valid = ar[None] < valids[:, None]
    safe_rows = torch.clamp(positions // page, max=tables.shape[1] - 1)
    pids = torch.where(
        in_valid, torch.gather(tables, 1, safe_rows.long()),
        paged_kv.SCRATCH_PAGE,
    ).long()
    offs = torch.where(in_valid, positions % page, 0).long()
    x = _write_then_attend(
        c, params, cache, tables, pids, offs, starts, tokens, positions
    )
    last_idx = torch.clamp(valids - 1, min=0).long()
    x_last = x[torch.arange(B, device=dev), last_idx][:, None]  # [B, 1, d]
    return _mm(x_last, params["lm_head"]).to(torch.float32)[:, 0]


def _write_then_attend(c, params, cache, tables, pids, offs, pos_q, toks,
                       positions):
    """Embed ``toks`` [B, S], write every position's K/V through the
    caller's (pids, offs) scatter, attend all S positions causally via
    paged_multiquery_attention with per-row chunk starts ``pos_q``, and
    return the final-norm hidden states."""
    B, S = toks.shape
    x = _embed(c, params, toks)  # [B, S, d]
    cos, sin = rope_frequencies(c, positions)  # [B, S, hd/2]
    for layer in range(c.n_layers):
        lp = params[f"layer_{layer}"]
        q, k, v = _project_qkv(c, lp, x, cos, sin, B, S)
        cache.k[layer][pids, offs] = k
        cache.v[layer][pids, offs] = v
        out = paged_multiquery_attention(
            q, cache.k[layer], cache.v[layer], tables, pos_q,
        ).to(c.dtype)
        x = _finish_block(c, lp, x, out, B, S)
    return _rms(x, params["final_norm"]["scale"], c.norm_eps)
