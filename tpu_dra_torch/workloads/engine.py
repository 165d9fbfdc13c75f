"""Serving engine: continuous batching over a paged KV cache.

Counterpart of ``tpu_dra/workloads/engine.py``: the sequence-state
store (:class:`_Sequence`), FIFO admission gated on a free slot and a
worst-case page reservation, batched chunked prefill (chunks of every
prefilling sequence in one padded bucket per iteration), and decode in
chunks of ``scan_chunk`` steps with admission and eviction only between
chunks — or, with ``spec_k > 0``, one speculative verify pass per
iteration. The exact-parity oracles are the same knobs:
``contiguous=True`` (fixed consecutive page ranges) and ``fused=False``
(one host round trip per token) must give the same tokens as the paged,
fused engine, greedy or sampled, speculative or not.

The JAX engine jits a ``lax.scan`` over the chunk; here the chunk is a
Python loop over ``steps`` eager decode steps that returns ``[steps,
B]`` tokens with ONE device->host copy per chunk, and the device copies
of (tables, lengths, last tokens, active) are fed back between chunks
until host bookkeeping changes (``_dev_state``). Each decode step runs
the paged-decode attention and the fused decode MLP once per layer —
the CUDA kernels on the card, their torch twins on the CPU.

Sampling (``temperature > 0``, ``top_k``, ``sample_seed``), as in the
JAX engine: the token at position p of a sequence draws with the key
``fold_in(fold_in(PRNGKey(sample_seed), sample_serial), p)`` — the
first token from the prefill logits (:meth:`Engine._pick_first`), the
rest inside the decode step (:func:`_pick_tokens`) or the verify pass
(:func:`_pick_tokens_batched`), each one launch of the fused pick
(ops/sample.py) over the slot batch with the keys made on the device.
A draw is a pure function of (seed, serial, position, logits), so the
fused, unfused, chunked and speculative paths draw the same tokens, and
they are JAX's.

Speculative decoding (``spec_k``): a :class:`~.specdraft.DraftSource`
(default :class:`~.specdraft.NgramDraft`) proposes up to ``spec_k``
tokens a sequence; the verify pass writes their K/V, evaluates all
``spec_k + 1`` positions at once (:func:`_verify_chunk`) and accepts on
the device; rejected positions rewind host-side (:meth:`Engine._rewind`).

int8 serving, as in the JAX engine: ``weight_quant="int8"`` quantizes
the unrolled tree once at construction (every projection, MLP matmul
and the logits head then run the int8mm kernel, and the MLP takes the
plain chain instead of the fused block); ``kv_quant="int8"`` keeps int8
pools with f32 per-(token, kv head) scale pools, quantizing each new
K/V row in flight before the scatter.

Copy-on-write prefix sharing (``Request.prefix_id``), as in the JAX
engine: the first sequence of a prefix registers its pages at prefill
completion (full pages shared in place, a mid-page boundary frozen into
a private copy), later sequences whose prompt tokens match attach them
by ``PageAllocator.incref`` and fork a shared page
(:func:`~.paged_kv.copy_page`) before their first write into it. The
registry is an LRU of ``prefix_cache_entries`` that sheds under page
pressure and flushes on a drain and on idle exit.

Lease gates and the drain: the engine runs behind a :class:`LeaseGate`
(:class:`EventGate` for drills, :class:`MultiplexLeaseGate` over the
multiplex daemon, :func:`auto_gate`). When the gate closes, every
in-flight sequence is checkpointed host-side (prompt + emitted tokens)
and its pages freed; on re-acquire the drained sequences resume at the
front of the queue, oldest first, re-prefilled from their checkpoint.

Metrics: ``metrics`` is any object with ``inc``, ``set_gauge`` and
``observe``; the engine exports the JAX engine's ``engine_*`` names.

Entry points run on the card: ``Engine(..., device=None)`` means
``"cuda"`` and raises RuntimeError without a CUDA device; tests pass
``device="cpu"``.

Cross-replica methods, as in the JAX engine, so the serving fabric's
Router and autoscaler drive this engine unchanged: :meth:`Engine.evacuate`
(the drain, then the whole live set handed back as :class:`Evacuated`
host checkpoints), and live KV migration — :meth:`Engine.decoding_rids`,
:meth:`Engine.export_sequence` (a :class:`SequenceExtent` holding the
sequence's pages as a :class:`~.paged_kv.KVExtent`) and
:meth:`Engine.import_sequence` (graft them and resume decode at the
exact position, no position recomputed). Requests are duck-typed: the
Router hands in the JAX package's ``Request`` objects.

Mesh-sharded decode (``sharded=True``), as in the JAX engine: a
(batch x model) decode mesh over the ranks of the default process group
(``parallel/mesh.py`` ``build_decode_mesh``; (1, 1) without a group),
the config kept (the kernels run on this rank's heads and ffn columns,
as at one rank; JAX's ``sharded_safe_config`` forces XLA there), this
rank's column shard of the weights (``shard_decode_params``) and its kv
heads of the pools.
Every rank runs the same engine on the same requests: the clock reading
and the gate state each ``step()`` (and each ``add_request``) acts on
are agreed over the mesh (:meth:`.DecodeMesh.agree`: the first rank's
clock, ready only when every gate is), so host scheduling is the same on
every rank; the decode rows split over the batch axis when
``max_slots`` tiles it (``_put_row``), each step gathering the new K/V
rows over it before the pool write and each chunk its tokens. Over one
rank the mesh is (1, 1), no collective is issued and the kernels run as
unsharded. The cross-replica methods give on every rank what JAX's
sharded engine gives: ``export_sequence`` gathers the ranks' kv-head
blocks of the extent over the model axis, so every rank holds the whole
extent an unsharded engine exports for the sequence; ``import_sequence``
grafts this rank's kv-head block of a whole extent (from a sharded
engine, an unsharded one or JAX's); ``evacuate`` drains at the agreed
clock. Their slot, page and rid decisions are host decisions on state
that is the same on every rank.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
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
    _maybe_quantize_params,
    _mm,
    _project_qkv,
    _rms,
)
from tpu_dra_torch.workloads.models.llama import (
    LlamaConfig,
    as_tree,
    rope_frequencies,
)
from tpu_dra_torch.workloads.multiplex_client import (
    LeaseCooldownError,
    MultiplexClient,
)
from tpu_dra_torch.workloads.ops.attention import (
    paged_decode_attention,
    paged_multiquery_attention,
)
from tpu_dra_torch.workloads.ops.sample import sample_pick
from tpu_dra_torch.workloads.parallel import mesh as meshlib
from tpu_dra_torch.workloads.quantize import quantize_kv
from tpu_dra_torch.workloads.specdraft import NgramDraft


class LeaseGate:
    """May the engine touch the chip right now? The default gate is
    always open (exclusive claim, no multiplexing)."""

    def ready(self) -> bool:
        return True

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return True

    def close(self) -> None:
        pass


class EventGate(LeaseGate):
    """Test/drill gate: revoke() closes it, restore() reopens it."""

    def __init__(self, ready: bool = True):
        self._ready = ready
        self.waits = 0

    def ready(self) -> bool:
        return self._ready

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        self.waits += 1
        return self._ready

    def revoke(self) -> None:
        self._ready = False

    def restore(self) -> None:
        self._ready = True


class MultiplexLeaseGate(LeaseGate):
    """Holds the claim's chip lease through the multiplex daemon.
    ready() pumps the client's event stream (a status RPC) so an async
    revocation closes the gate; wait_ready() re-acquires, sitting out
    any post-revocation cooldown the daemon imposes."""

    def __init__(self, client):
        assert isinstance(client, MultiplexClient)
        self._client = client
        self._lease = None

    def ready(self) -> bool:
        if self._lease is None:
            return False
        self._client.status()  # drains pending async revocation events
        if self._client.revoked:
            self._client.revoked = False
            self._lease = None
            return False
        return True

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        if self._lease is not None:
            return True
        try:
            self._lease = self._client.acquire()
            return True
        except LeaseCooldownError as e:
            time.sleep(min(e.retry_after, timeout if timeout else 0.1))
            return False

    def close(self) -> None:
        if self._lease is not None:
            self._client.release()
            self._lease = None
        self._client.close()


def auto_gate(environ=None) -> LeaseGate:
    """MultiplexLeaseGate iff this process runs in a multiplexed
    container (the CDI-injected env contract of
    multiplex_client.auto_lease), the always-open gate otherwise."""
    environ = os.environ if environ is None else environ
    if environ.get("TPU_PROCESS_MULTIPLEXING") != "true":
        return LeaseGate()
    return MultiplexLeaseGate(
        MultiplexClient(environ["TPU_MULTIPLEX_SOCKET_DIR"])
    )


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


@dataclasses.dataclass
class Evacuated:
    """One sequence handed back by :meth:`Engine.evacuate` — the
    host-side checkpoint the serving fabric moves to another replica:
    the ORIGINAL request, every token this engine emitted for it, and
    the arrival-side timestamps. ``remaining`` new tokens are still
    owed; a resume prefills ``prompt + emitted`` and generates the
    rest."""

    req: Request
    emitted: np.ndarray  # tokens THIS engine emitted (may be empty)
    t_submit: float
    t_first: Optional[float]  # None when no token was emitted yet

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.emitted)


@dataclasses.dataclass
class SequenceExtent:
    """One sequence lifted off an engine by :meth:`Engine.export_sequence`
    — the live-migration unit. Unlike :class:`Evacuated` (host
    checkpoint, resume re-prefills), this carries the sequence's KV
    pages themselves (:class:`~.paged_kv.KVExtent`), so
    :meth:`Engine.import_sequence` grafts them into the destination and
    decode resumes without recomputing a position. ``req`` + ``emitted``
    still suffice to rebuild by re-prefill (the crash fallback)."""

    req: Request  # the SOURCE engine's request (prompt = its context)
    emitted: np.ndarray  # tokens the source engine emitted (>= 1)
    extent: object  # paged_kv.KVExtent covering [0, kv_len)
    kv_len: int  # positions written on the source = len(prompt')-1
    t_submit: float
    t_first: Optional[float]
    sample_seed: int  # the source engine's seed — pinned on resume
    sample_serial: int  # the source sequence's sampling serial

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.emitted)

    def resume_request(self) -> Request:
        """The destination-side request: emitted tokens fold into the
        prompt, the sampling schedule pins, and TTFT rides
        ``ttft_preobserved`` (the first token already happened on the
        source)."""
        return Request(
            rid=self.req.rid,
            prompt=np.concatenate([
                np.asarray(self.req.prompt, np.int32),
                np.asarray(self.emitted, np.int32),
            ]),
            max_new_tokens=self.remaining,
            arrival_s=0.0,
            ttft_preobserved=self.t_first is not None,
            prefix_id=self.req.prefix_id,
            prefix_len=self.req.prefix_len,
            sample_seed=self.sample_seed,
            sample_serial=self.sample_serial,
        )


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


class _SharedPrefix:
    """One registered shared prefix: the verified tokens, and the pages
    covering them (full pages shared in place with the registering
    sequence; a mid-page boundary is a frozen private copy with a zero
    tail), each holding one registry reference."""

    __slots__ = ("prefix_id", "tokens", "length", "pages")

    def __init__(self, prefix_id, tokens, length, pages):
        self.prefix_id = prefix_id
        self.tokens = tokens  # np.int32 [length]
        self.length = length
        self.pages = pages  # ordered page ids covering [0, length)


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

    def sampling(self) -> "tuple | None":
        """(temperature, top_k) when sampling is on, None for greedy."""
        if self.temperature <= 0.0:
            return None
        return (self.temperature, self.top_k)


def _check_supported(ec: EngineConfig) -> None:
    if ec.scan_chunk < 1 or ec.prefill_chunk < 1:
        raise ValueError("scan_chunk and prefill_chunk must be >= 1")
    if ec.spec_k < 0 or ec.prefill_batch < 0:
        raise ValueError("spec_k and prefill_batch must be >= 0")
    if ec.kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"unknown kv_quant {ec.kv_quant!r}")
    if ec.weight_quant not in WEIGHT_QUANT_MODES:
        raise ValueError(f"unknown weight_quant {ec.weight_quant!r}")
    if ec.spec_k > 0 and not ec.fused:
        raise ValueError(
            "spec_k requires fused=True — the unfused per-token path IS "
            "the exactness oracle speculation is verified against"
        )
    if ec.spec_k > 0 and ec.sharded:
        raise ValueError(
            "spec_k with sharded=True is not supported (the verify pass "
            "has no sharding rules); run speculation on one device"
        )


class Engine:
    """Continuous-batching serving engine over a paged KV cache.

    ``params`` is a :class:`~.models.llama.LlamaParams` or a nested dict
    of tensors in either layout (stacked trees are unrolled once).
    ``device`` defaults to the CUDA device (see :func:`resolve_device`).
    ``draft_source`` proposes speculative drafts when ``spec_k > 0``
    (default: ``NgramDraft(spec_lookup_order)``). ``gate`` defaults to
    the always-open LeaseGate (pass :func:`auto_gate` () in multiplexed
    containers); ``metrics`` is an optional object with ``inc``,
    ``set_gauge`` and ``observe`` that receives the ``engine_*``
    series. With ``sharded=True`` every rank of the default process
    group constructs the engine alike and feeds it the same requests.
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
        draft_source=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.ec = engine_config or EngineConfig()
        _check_supported(self.ec)
        self._draft = draft_source
        if self._draft is None and self.ec.spec_k > 0:
            self._draft = NgramDraft(self.ec.spec_lookup_order)
        params = _maybe_quantize_params(
            unroll_tree(as_tree(params, self.device)), self.ec.weight_quant
        )
        self.mesh = None
        # [lo, hi) of the decode rows this rank holds when they split
        # over the batch axis; None when every rank holds every row.
        self._rows = None
        if self.ec.sharded:
            self.mesh = meshlib.build_decode_mesh(config, device=self.device)
            meshlib.check_decode_config(config, self.mesh)
            params = meshlib.shard_decode_params(self.mesh, params)
            B = self.ec.max_slots
            if self.mesh.shape["batch"] > 1 and meshlib.decode_data_sharding(
                    self.mesh, B) == ("batch",):
                self._rows = self.mesh.row_block(B)
        self.params = params
        self.gate = gate or LeaseGate()
        self.metrics = metrics
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
            config, P, self.ec.page_size, kv_quant=self.ec.kv_quant,
            device=self.device, mesh=self.mesh,
        )
        self.allocator = paged_kv.PageAllocator(P)
        B, M = self.ec.max_slots, self.ec.max_pages_per_seq
        self._tables = np.zeros((B, M), np.int32)  # SCRATCH_PAGE default
        self._lengths = np.zeros((B,), np.int32)
        self._last_tokens = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._seeds = np.zeros((B,), np.int32)  # per-slot sampling serial
        self._slots: List[Optional[_Sequence]] = [None] * B
        # The engine-wide sample seed, a device scalar beside the state.
        self._seed_d = torch.tensor(
            self.ec.sample_seed, dtype=torch.int32, device=self.device)
        # Device copies of (tables, lengths, last, active, seeds, seed):
        # a chunk's lengths/last outputs feed the next chunk directly;
        # any host-side mutation (page alloc, admission, eviction,
        # prefill) invalidates them.
        self._dev_state = None

        self._queue: collections.deque = collections.deque()
        self._prefilling: collections.deque = collections.deque()
        self._pending_zero: List[int] = []
        self._blocked_on_pages = False
        self._stalled_since: Optional[float] = None
        self._exhausted_exported = 0
        # Prefix-sharing registry: prefix_id -> _SharedPrefix, an
        # insertion-ordered dict used as an LRU. Entries pin their pages
        # (incref); flushed on a drain and on idle exit, evicted at the
        # cap and shed under page pressure.
        self._prefix_registry: Dict[str, _SharedPrefix] = {}
        self._serial = 0
        self._rids: set = set()
        self._progress = 0
        self.completed: Dict[str, Completion] = {}
        # Work counters (read by chip_smoke.py and the tests): decode
        # steps run, host seconds spent in decode chunks (each ends in
        # its device->host copy), prefill buckets run, and those of
        # chunk length 1 (their s=1 layers also run the fused decode
        # MLP).
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self.prefill_buckets = 0
        self.prefill_single_token_buckets = 0
        # Speculation: drafts proposed and accepted, verify passes run.
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.verify_passes = 0
        # Prefix sharing: attaches, copy-on-write forks, and the
        # high-water of the page allocations sharing stood in for.
        self.prefix_attached = 0
        self.cow_copies = 0
        self.prefix_saved_hw = 0

    # --- public API ------------------------------------------------------

    def add_request(self, req: Request) -> None:
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: need >= 1 prompt token and >= 1 "
                f"new token"
            )
        if req.rid in self._rids:
            raise ValueError(f"duplicate request rid {req.rid!r}")
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
            _Sequence(req, t_submit=self._now(), serial=self._serial)
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
        """One engine iteration: gate check (drain on backpressure),
        admissions, one prefill bucket, one decode chunk. Returns True
        while work remains; never blocks on the gate (run() waits).
        Over more than one rank the clock reading and the gate state are
        agreed over the mesh first."""
        now, ready = self.clock(), self.gate.ready()
        if self._spans_ranks:
            now, ready = self.mesh.agree(now, ready)
        if not ready:
            self._enter_stall(now)
            self._export()
            return self.busy
        self._exit_stall()
        self._admit(now)
        self._prefill_tick(now)
        self._decode_tick(now)
        self._export()
        return self.busy

    def run(
        self, requests=None, poll_seconds: float = 0.002
    ) -> Dict[str, Completion]:
        """Submit ``requests`` (optional) and step until idle; waits on
        the lease gate and on future arrivals between steps."""
        for r in requests or []:
            self.add_request(r)
        while self.busy:
            stalled = self._stalled_since is not None
            before = self._progress
            self.step()
            made_progress = self._progress != before
            if self._stalled_since is not None:
                if not self.gate.wait_ready(timeout=poll_seconds):
                    # A gate whose wait does not block (stub gates)
                    # must not turn the stall into a hot spin.
                    time.sleep(poll_seconds)
            elif not made_progress and not stalled:
                time.sleep(poll_seconds)  # waiting on a future arrival
        # Idle exit: the prefix cache drops its page pins, so a finished
        # run leaves the allocator whole; the next run re-registers.
        self._flush_prefix_registry()
        self._flush_zero()
        self._export()
        return self.completed

    def close(self) -> None:
        self.gate.close()

    @property
    def _spans_ranks(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _now(self) -> float:
        """The clock, agreed over the mesh when it spans ranks."""
        now = self.clock()
        if self._spans_ranks:
            now, _ = self.mesh.agree(now)
        return now

    def evacuate(self) -> List[Evacuated]:
        """Drain every in-flight sequence to host state (pages freed,
        contexts folded), then hand the WHOLE live set — drained and
        still-queued alike — back to the caller, leaving the engine
        empty: the autoscaler's scale-down primitive. The evacuees
        resume elsewhere by prefilling ``prompt + emitted``; rids are
        forgotten, so a sequence may later come back here."""
        self._drain(self._now())
        out: List[Evacuated] = []
        while self._queue:
            seq = self._queue.popleft()
            self._rids.discard(seq.req.rid)
            out.append(Evacuated(
                req=seq.req,
                emitted=np.asarray(seq.out, np.int32),
                t_submit=seq.t_submit,
                t_first=seq.t_first,
            ))
        self._flush_zero()
        self._inc("engine_evacuated_total", len(out))
        self._export()
        return out

    # --- live KV migration ------------------------------------------------

    def decoding_rids(self) -> List[str]:
        """rids of sequences that finished prefill and are decoding —
        the migration candidates a prefill-role replica ships."""
        return [
            s.req.rid
            for s in self._slots
            if s is not None and s.prefill_done and s.out
        ]

    def export_sequence(self, rid: str) -> SequenceExtent:
        """Lift a decoding sequence off this engine: serialize its
        block-table extent (every pool, int8 scales included), release
        its slot and pages (each page decref'd once — shared-prefix
        pages stay pinned by the registry and other tables), and forget
        the rid so a fallback may resubmit here. On a mesh every rank
        calls it alike and gets the whole extent (its pools' kv-head
        blocks gathered over the model axis)."""
        if self.ec.contiguous:
            raise ValueError(
                "contiguous (oracle) engines do not export extents — "
                "their block tables are fixed physical ranges"
            )
        seq = next(
            (s for s in self._slots if s is not None and s.req.rid == rid),
            None,
        )
        if seq is None or not seq.prefill_done or not seq.out:
            raise ValueError(
                f"rid {rid!r} is not an exportable decoding sequence"
            )
        slot = seq.slot
        kv_len = int(self._lengths[slot])
        keep = -(-kv_len // self.ec.page_size)
        # Pages past the written extent are scan-chunk slack, entirely
        # zero: they stay behind and free with the slot.
        gather = None
        kvh = self.config.n_kv_heads
        if meshlib.local_kv_heads(self.mesh, kvh) != kvh:
            def gather(x):  # [L, n, page, kvh/m, ...]: heads on dim 3
                return self.mesh.gather_model(x, 3)
        extent = paged_kv.serialize_extent(self.cache, seq.pages[:keep],
                                           kv_len, gather=gather)
        sx = SequenceExtent(
            req=seq.req,
            emitted=np.asarray(seq.out, np.int32),
            extent=extent,
            kv_len=kv_len,
            t_submit=seq.t_submit,
            t_first=seq.t_first,
            sample_seed=self.ec.sample_seed,
            sample_serial=seq.sample_serial,
        )
        self._release_slot(slot)
        self._rids.discard(rid)
        self._progress += 1
        self._inc("engine_kv_exports_total")
        return sx

    def import_sequence(self, sx, req=None) -> bool:
        """Graft an exported sequence (``sx``: a :class:`SequenceExtent`
        or the JAX engine's, its extent this package's
        :class:`~.paged_kv.KVExtent`) and resume its decode at position
        ``kv_len`` — no position recomputed. False when the engine lacks
        a free slot or page headroom right now (the caller falls back to
        re-prefill); every mismatch raises. Leading full pages of a
        registered matching prefix attach by incref instead of copying,
        and the imported prefix registers here for later sharers. On a
        mesh every rank calls it alike with the whole extent and grafts
        the kv-head block its pools hold."""
        if self.ec.contiguous:
            raise ValueError(
                "contiguous (oracle) engines do not import extents"
            )
        req = req if req is not None else sx.resume_request()
        if req.rid in self._rids:
            raise ValueError(f"duplicate request rid {req.rid!r}")
        if (
            req.sample_seed is not None
            and req.sample_seed != self.ec.sample_seed
        ):
            raise ValueError(
                f"request {req.rid}: pinned sample_seed "
                f"{req.sample_seed} != engine seed {self.ec.sample_seed}"
            )
        if sx.extent.page_size != self.ec.page_size:
            raise ValueError(
                f"extent page_size {sx.extent.page_size} != engine "
                f"page_size {self.ec.page_size}"
            )
        extent = sx.extent
        lo, n = meshlib.kv_head_block(self.mesh, self.config.n_kv_heads)
        if n != self.config.n_kv_heads:
            extent = paged_kv.head_block(extent, lo, n,
                                         self.config.n_kv_heads)
        if len(req.prompt) != sx.kv_len + 1 or req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: prompt must cover kv_len "
                f"{sx.kv_len} + 1 not-yet-written token, with >= 1 "
                f"token still owed"
            )
        total = len(req.prompt) + req.max_new_tokens + self.ec.scan_chunk
        if total > self.ec.max_pages_per_seq * self.ec.page_size:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} (+ chunk slack "
                f"{self.ec.scan_chunk}) exceeds the per-sequence page "
                f"budget {self.ec.max_pages_per_seq}x{self.ec.page_size}"
            )
        slot = next(
            (i for i, s in enumerate(self._slots) if s is None), None
        )
        if slot is None:
            return False
        self._serial += 1
        seq = _Sequence(req, t_submit=sx.t_submit, serial=self._serial)
        seq.t_first = sx.t_first
        seq.prefill_done = True
        seq.prefill_cursor = len(seq.context)
        need = self._pages_for(seq)
        if not self.allocator.reserve(need):
            while self._prefix_registry and not (
                self.allocator.can_reserve(need)
            ):
                self._evict_one_prefix()
            if not self.allocator.reserve(need):
                return False
        self._rids.add(req.rid)
        seq.slot = slot
        seq.reserved_left = need
        # Import-side by-id carry: leading FULL pages of a registered
        # matching prefix attach by incref; prefill K/V is a function of
        # the tokens, so those pages hold the payload's content.
        attach: Dict[int, int] = {}
        entry = (
            self._prefix_registry.get(req.prefix_id)
            if req.prefix_id else None
        )
        if entry is not None and np.array_equal(
            seq.context[: entry.length], entry.tokens
        ):
            n_full = min(entry.length // self.ec.page_size,
                         sx.extent.n_pages)
            for j in range(n_full):
                attach[j] = entry.pages[j]
        # Deferred zeroing lands before a freed page joins the graft.
        self._flush_zero()

        def _alloc():
            self.allocator.unreserve(1)
            seq.reserved_left -= 1
            return self.allocator.alloc()

        self.cache, pages = paged_kv.graft_extent(
            self.cache, self.allocator, extent,
            alloc=_alloc, attach=attach,
        )
        if attach:
            # Attached pages come off the worst-case reservation.
            release = min(len(attach), seq.reserved_left)
            if release > 0:
                self.allocator.unreserve(release)
                seq.reserved_left -= release
            self.prefix_attached += 1
            self._inc("engine_prefix_attached_total")
        seq.pages = pages
        self._slots[slot] = seq
        self._tables[slot, : len(pages)] = pages
        self._lengths[slot] = sx.kv_len
        self._last_tokens[slot] = int(seq.context[-1])
        self._active[slot] = True
        self._seeds[slot] = seq.sample_serial
        # The device copies of the slot state hold the previous
        # occupant's row until the next upload.
        self._dev_state = None
        self._maybe_register_prefix(seq)
        self._track_shared()
        self._progress += 1
        self._inc("engine_kv_imports_total")
        return True

    def _live(self):
        """Every not-yet-completed sequence, exactly once (prefilling
        sequences are in both _prefilling and _slots)."""
        seen = set()
        for s in (
            list(self._queue) + list(self._prefilling)
            + [x for x in self._slots if x is not None]
        ):
            if id(s) not in seen:
                seen.add(id(s))
                yield s

    # --- backpressure ------------------------------------------------------

    def _enter_stall(self, now: float) -> None:
        if self._stalled_since is None:
            self._stalled_since = now
            if self._drain(now):
                # Only stalls that drained work count: a cold engine
                # waiting for its first lease is not an incident.
                self._inc("engine_backpressure_drains_total")

    def _exit_stall(self) -> None:
        self._stalled_since = None

    def _drain(self, now: float) -> int:
        """Checkpoint every in-flight sequence host-side and free its
        pages (the prefix cache's pins too): the co-tenant gets the chip
        and the pages. Drained sequences resume at the front of the
        queue, oldest first, with their emitted tokens folded into the
        context; the first re-prefilled sharer re-registers its prefix
        and the rest re-attach. Returns how many sequences drained."""
        self._flush_prefix_registry()
        drained: List[_Sequence] = []
        for slot, seq in enumerate(self._slots):
            if seq is None:
                continue
            self._release_slot(slot)
            seq.context = np.concatenate(
                [np.asarray(seq.req.prompt, np.int32),
                 np.asarray(seq.out, np.int32)]
            )
            seq.prefill_cursor = 0
            seq.prefill_done = False
            seq.drains += 1
            drained.append(seq)
        self._prefilling.clear()
        # appendleft reverses, so walk newest first; the admission
        # serial breaks t_submit ties (a coarse clock stamps a burst
        # with one value).
        for seq in sorted(
            drained, key=lambda s: (s.t_submit, s.serial), reverse=True
        ):
            self._queue.appendleft(seq)
        return len(drained)

    # --- admission / slots ------------------------------------------------

    def _pages_for(self, seq: _Sequence) -> int:
        """Worst-case page count: full context + every generated token +
        one decode chunk of post-completion slack."""
        total = len(seq.context) + seq.remaining + self.ec.scan_chunk
        return -(-total // self.ec.page_size)

    def _admit(self, now: float) -> None:
        self._blocked_on_pages = False
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
            if not self.ec.contiguous:
                # A cache never blocks admission: shed prefix pins first
                # (their pages free only once no table references them).
                while self._prefix_registry and not (
                    self.allocator.can_reserve(need)
                ):
                    self._evict_one_prefix()
            if not self.ec.contiguous and not self.allocator.reserve(need):
                # Admission waits until evictions free pages (FIFO).
                # Backpressure, exported as the blocked-on-pages gauge —
                # never as engine_page_exhausted_total, which counts an
                # allocation the reservations promised and could not
                # serve.
                self._blocked_on_pages = True
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
            self._seeds[slot] = seq.sample_serial
            self._dev_state = None
            self._prefilling.append(seq)
            self._progress += 1
            self._inc("engine_admitted_total")

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
        self._seeds[slot] = 0
        self._dev_state = None

    # --- prefix sharing ---------------------------------------------------

    def _try_attach_prefix(self, seq: _Sequence) -> None:
        """Map a registered prefix's pages into this sequence's table by
        incref and skip prefilling those positions. The id is a hint:
        the registered tokens must match the sequence's own context."""
        pid = seq.req.prefix_id
        if not pid or self.ec.contiguous:
            return
        entry = self._prefix_registry.get(pid)
        if entry is None or entry.length > len(seq.context) - 1:
            return
        if not np.array_equal(seq.context[: entry.length], entry.tokens):
            return
        for pg in entry.pages:
            self.allocator.incref(pg)
        seq.pages = list(entry.pages)
        self._tables[seq.slot, : len(entry.pages)] = entry.pages
        seq.prefill_cursor = entry.length
        # The attached pages come off the worst-case reservation, less
        # one page for the copy-on-write fork of a mid-page boundary.
        release = len(entry.pages) - (
            1 if entry.length % self.ec.page_size else 0)
        release = min(release, seq.reserved_left)
        if release > 0:
            self.allocator.unreserve(release)
            seq.reserved_left -= release
        # LRU touch: re-insert at the tail.
        self._prefix_registry[pid] = self._prefix_registry.pop(pid)
        self.prefix_attached += 1
        self._dev_state = None
        self._inc("engine_prefix_attached_total")
        self._track_shared()

    def _maybe_register_prefix(self, seq: _Sequence) -> None:
        """Register this sequence's prefix pages for later sharers (at
        prefill completion, when the pages exist): full pages shared in
        place, a mid-page boundary frozen into a private copy holding
        exactly [0, p) with a zero tail, so every sharer forks from a
        clean page and the registering sequence keeps its own."""
        pid = seq.req.prefix_id
        plen = seq.req.prefix_len
        if not pid or plen < 1 or self.ec.contiguous:
            return
        if pid in self._prefix_registry:
            return
        # Inside the PROMPT (a drained context carries emitted tokens),
        # and one context token short, whose prefill gives the logits of
        # the first generated token.
        p = min(plen, len(seq.req.prompt), len(seq.context) - 1)
        if p < 1:
            return
        page = self.ec.page_size
        n_full, partial = divmod(p, page)
        pages = list(seq.pages[:n_full])
        if partial:
            # The frozen copy needs a page of unreserved headroom: a
            # cache never eats into admission guarantees.
            if self.allocator.free_pages - self.allocator.reserved_pages < 1:
                return
            self._flush_zero()
            frozen = self.allocator.alloc()
            paged_kv.copy_page_prefix(
                self.cache, seq.pages[n_full], frozen, partial)
            pages.append(frozen)
        for pg in pages[:n_full]:
            self.allocator.incref(pg)
        self._prefix_registry[pid] = _SharedPrefix(
            pid, np.asarray(seq.context[:p], np.int32).copy(), p, pages
        )
        while len(self._prefix_registry) > max(
            self.ec.prefix_cache_entries, 1
        ):
            self._evict_one_prefix(exclude=pid)
        self._inc("engine_prefix_registered_total")
        self._track_shared()

    def _evict_one_prefix(self, exclude: Optional[str] = None) -> bool:
        """Drop the least recently used entry's page pins; a page is
        queued for zeroing only when its last reference goes."""
        for key in self._prefix_registry:
            if key != exclude:
                entry = self._prefix_registry.pop(key)
                for pg in entry.pages:
                    if self.allocator.decref(pg):
                        self._pending_zero.append(pg)
                return True
        return False

    def _flush_prefix_registry(self) -> None:
        while self._evict_one_prefix():
            pass

    def _cow_range(self, seq: _Sequence, lo: int, hi: int) -> None:
        """Copy-on-write guard for a write to positions [lo, hi): every
        mapped page there still shared with another table (refcount > 1)
        is copied whole (values and scales) into a new page that takes
        its place in this table; the shared page loses one reference and
        is never freed or zeroed here."""
        if self.ec.contiguous:
            return
        page = self.ec.page_size
        for j in range(lo // page, min(-(-hi // page), len(seq.pages))):
            old = seq.pages[j]
            if self.allocator.refcount(old) <= 1:
                continue
            self._flush_zero()
            if seq.reserved_left > 0:
                self.allocator.unreserve(1)
                seq.reserved_left -= 1
            new = self.allocator.alloc()
            paged_kv.copy_page(self.cache, old, new)
            self.allocator.decref(old)
            seq.pages[j] = new
            self._tables[seq.slot, j] = new
            self.cow_copies += 1
            self._dev_state = None
            self._inc("engine_cow_copies_total")

    def _track_shared(self) -> int:
        """Page allocations that sharing stands in for now (the
        registry's own pins discounted: a prefix registered and never
        shared saves nothing); raises the high-water mark."""
        pins: Dict[int, int] = {}
        for entry in self._prefix_registry.values():
            for pg in entry.pages:
                pins[pg] = pins.get(pg, 0) + 1
        saved = self.allocator.shared_extra(discount=pins)
        if saved > self.prefix_saved_hw:
            self.prefix_saved_hw = saved
        return saved

    # --- prefill ----------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> a device copy (never a view of the host array,
        which the bookkeeping mutates in place)."""
        return torch.tensor(arr, device=self.device)

    def _put_row(self, arr: np.ndarray) -> torch.Tensor:
        """Host batch array -> device: this rank's row block when the
        decode rows split over the batch axis (``decode_data_sharding``),
        the whole array otherwise."""
        if self._rows is not None:
            lo, hi = self._rows
            arr = arr[lo:hi]
        return self._upload(arr)

    def _prefill_tick(self, now: float) -> None:
        """One batched-prefill iteration: chunks from up to
        ``prefill_batch`` (0 = all) prefilling sequences in ONE padded
        bucket; the chunk length and the row count are padded to powers
        of two (row count capped at max_slots). Pad positions and idle
        rows write to the scratch page. A sequence that has not started
        attaches its registered prefix first; one whose prefix a row of
        this bucket will register waits a tick and attaches then."""
        if not self._prefilling:
            return
        limit = (
            len(self._prefilling) if self.ec.prefill_batch == 0
            else self.ec.prefill_batch
        )
        rows: List[_Sequence] = []
        leading: set = set()
        for seq in self._prefilling:
            if len(rows) >= limit:
                break
            if seq.prefill_cursor == 0 and not seq.pages:
                self._try_attach_prefix(seq)
            pid = seq.req.prefix_id
            unregistered = (
                pid and seq.req.prefix_len > 0
                and pid not in self._prefix_registry
                and not self.ec.contiguous
            )
            if unregistered and pid in leading:
                continue
            if unregistered:
                leading.add(pid)
            rows.append(seq)
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
            self._cow_range(
                seq, seq.prefill_cursor, seq.prefill_cursor + take)
            self._ensure_pages(seq, seq.prefill_cursor + take)
            tokens[i, :take] = seq.context[
                seq.prefill_cursor: seq.prefill_cursor + take
            ]
            starts[i] = seq.prefill_cursor
            valids[i] = take
            trows[i] = self._tables[seq.slot]
        self.prefill_buckets += 1
        if bucket == 1:
            self.prefill_single_token_buckets += 1
        logits = _prefill_batch(
            self.config, self.params, self.cache, self._upload(trows),
            self._upload(starts), self._upload(tokens), self._upload(valids),
        )
        finished: List[_Sequence] = []
        for i, (seq, take) in enumerate(zip(rows, takes)):
            seq.prefill_cursor += take
            self._inc("engine_prefill_tokens_total", take)
            if seq.prefill_cursor == len(seq.context):
                finished.append((i, seq))
                seq.prefill_done = True
        # Every finishing row's first token, then one host copy of them.
        firsts = [self._pick_first(seq, logits[i]) for i, seq in finished]
        if finished:
            firsts = torch.stack(firsts).cpu().tolist()
        for (_, seq), first in zip(finished, firsts):
            slot = seq.slot
            self._maybe_register_prefix(seq)
            self._record_tokens(seq, [first])
            if seq.slot is not None:  # not finished by that token
                self._lengths[slot] = len(seq.context)
                self._last_tokens[slot] = first
                self._active[slot] = True
        for _, seq in finished:
            self._prefilling.remove(seq)
        self._progress += 1
        self._dev_state = None

    def _pick_first(self, seq: _Sequence, logits: torch.Tensor):
        """First generated token (a device scalar) from the row's prefill
        logits [vocab]: argmax, or under sampling the key schedule of the
        decode step at position len(context), so a re-prefill after a
        drain draws what the decode step would have."""
        sampling = self.ec.sampling()
        if sampling is None:
            return torch.argmax(logits).to(torch.int32)
        meta = self._upload(
            np.array([seq.sample_serial, len(seq.context)], np.int32))
        return sample_pick(
            logits[None], *sampling, seed=self._seed_d, serials=meta[:1],
            positions=meta[1:],
        )[0]

    # --- decode ------------------------------------------------------------

    def _device_state(self) -> tuple:
        """(tables, lengths, last, active, seeds, seed) on the device,
        uploaded again only after host bookkeeping changed; greedy
        engines upload no seeds (None)."""
        if self._dev_state is None:
            sampled = self.ec.sampling() is not None
            self._dev_state = (
                self._put_row(self._tables),
                self._put_row(self._lengths),
                self._put_row(self._last_tokens),
                self._put_row(self._active),
                self._put_row(self._seeds) if sampled else None,
                self._seed_d,
            )
        return self._dev_state

    def _decode_tick(self, now: float) -> None:
        if not self._active.any():
            return
        if self.ec.spec_k > 0:
            return self._spec_tick(now)
        steps = self.ec.scan_chunk
        for slot, seq in enumerate(self._slots):
            if seq is not None and self._active[slot]:
                self._ensure_pages(seq, int(self._lengths[slot]) + steps)
        tables_d, lengths_d, last_d, active_d, seeds_d, seed_d = (
            self._device_state())
        pick = dict(sampling=self.ec.sampling(), seeds=seeds_d,
                    sample_seed=seed_d, rows_split=self._rows is not None)
        # The mesh counts this chunk's collectives under "decode/".
        phase = (contextlib.nullcontext() if self.mesh is None
                 else self.mesh.in_phase("decode"))
        t0 = time.perf_counter()
        with phase:
            if self.ec.fused:
                lengths, last, out_d = _decode_chunk(
                    self.config, self.params, self.cache, tables_d,
                    lengths_d, last_d, active_d, steps=steps, **pick,
                )
                out = out_d.cpu().numpy()  # the chunk's one device->host copy
            else:
                # Per-token oracle: the same step math, one host copy per
                # token.
                lengths, last, outs = lengths_d, last_d, []
                for _ in range(steps):
                    lengths, last, _ = _decode_step(
                        self.config, self.params, self.cache, tables_d,
                        lengths, last, active_d, **pick,
                    )
                    rows = last
                    if self._rows is not None:
                        rows = self.mesh.gather_batch(last)
                    outs.append(rows.cpu().numpy())
                out = np.stack(outs)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += steps
        self._dev_state = (tables_d, lengths, last, active_d, seeds_d, seed_d)
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

    # --- speculative decode ----------------------------------------------

    def _spec_tick(self, now: float) -> None:
        """One speculative iteration: the draft source proposes up to
        spec_k tokens per active sequence (host-side, from its own
        history), and ONE verify pass writes their K/V, evaluates all
        spec_k + 1 positions with the per-token pick schedule and accepts
        on the device. Rejected positions rewind host-side."""
        K = self.ec.spec_k
        B = self.ec.max_slots
        drafts = np.zeros((B, K), np.int32)
        counts = np.zeros((B,), np.int32)
        for slot, seq in enumerate(self._slots):
            if seq is None or not self._active[slot]:
                continue
            cap = min(K, seq.remaining - 1)
            if cap > 0 and self._draft is not None:
                history = np.concatenate([
                    np.asarray(seq.req.prompt, np.int32),
                    np.asarray(seq.out, np.int32),
                ])
                d = np.asarray(
                    self._draft.propose(history, cap), np.int32
                ).ravel()[:cap]
                # A proposer's out-of-vocab id would index the embedding
                # out of bounds: cut at the first one (later drafts
                # depend on it anyway).
                bad = np.flatnonzero((d < 0) | (d >= self.config.vocab_size))
                if bad.size:
                    d = d[: int(bad[0])]
                drafts[slot, : len(d)] = d
                counts[slot] = len(d)
            # The verify pass writes only private pages (what _rewind
            # relies on): fork any shared page in its range first.
            L = int(self._lengths[slot])
            upto = L + int(counts[slot]) + 1
            self._cow_range(seq, L, upto)
            self._ensure_pages(seq, upto)
        tables_d, lengths_d, last_d, active_d, seeds_d, seed_d = (
            self._device_state())
        t0 = time.perf_counter()
        new_len, new_last, n_acc, picked = _verify_chunk(
            self.config, self.params, self.cache, tables_d, lengths_d,
            last_d, self._upload(drafts), self._upload(counts), active_d,
            sampling=self.ec.sampling(), seeds=seeds_d, sample_seed=seed_d,
        )
        # n_acc and the picks in one device->host copy.
        host = torch.cat([n_acc[:, None].to(picked.dtype), picked], 1)
        host = host.cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
        self.verify_passes += 1
        # Verified lengths/last tokens ARE next iteration's inputs.
        self._dev_state = (
            tables_d, new_len, new_last, active_d, seeds_d, seed_d)
        n_acc_h, picked_h = host[:, 0], host[:, 1:]
        active_slots = [
            (slot, seq) for slot, seq in enumerate(self._slots)
            if seq is not None and self._active[slot]
        ]
        for slot, seq in active_slots:
            na = int(n_acc_h[slot])
            npp = int(counts[slot])
            self.spec_proposed += npp
            self.spec_accepted += na
            if npp:
                self._inc("engine_spec_proposed_total", npp)
            if na:
                self._inc("engine_spec_accepted_total", na)
            written = int(self._lengths[slot]) + npp + 1
            valid = int(self._lengths[slot]) + na + 1
            # Host mirror of the device state, before a finish resets it.
            self._lengths[slot] = valid
            self._last_tokens[slot] = picked_h[slot, na]
            self._record_tokens(seq, picked_h[slot, : na + 1].tolist())
            if seq.slot is not None and written > valid:
                self._rewind(seq, valid, written)

    def _rewind(self, seq: _Sequence, valid_len: int,
                written_len: int) -> None:
        """Host-side speculative rewind: the verify pass wrote K/V at
        positions [valid_len, written_len) that acceptance rejected.
        Pages wholly past the accepted extent leave the block table and
        free (batch-zeroed before reuse) and go back into the
        sequence's reservation; the kept boundary page's rejected tail
        is zeroed in place."""
        page = self.ec.page_size
        keep = -(-valid_len // page)
        dropped = seq.pages[keep:]
        if dropped:
            seq.pages = seq.pages[:keep]
            if self.ec.contiguous:
                self._pending_zero.extend(dropped)
            else:
                for pg in dropped:
                    if self.allocator.decref(pg):
                        self._pending_zero.append(pg)
                # Every dropped page was private and was just freed, so
                # the headroom exists; a failure here means a page was
                # not freed, and a later allocation would steal another
                # sequence's reserved headroom.
                if not self.allocator.reserve(len(dropped)):
                    raise RuntimeError(
                        f"rewind of {seq.req.rid} could not restore "
                        f"{len(dropped)} reserved pages — a dropped page "
                        f"was not freed (shared page in the rejected "
                        f"extent?)"
                    )
                seq.reserved_left += len(dropped)
            self._tables[seq.slot, keep:] = paged_kv.SCRATCH_PAGE
            self._dev_state = None
        off = valid_len % page
        if off and written_len > valid_len:
            paged_kv.zero_page_tail(self.cache, seq.pages[keep - 1], off)

    def _record_tokens(self, seq: _Sequence, toks) -> None:
        # Clock read after the chunk's host copy, so latencies include
        # the chunk's own compute.
        now = self.clock()
        take = min(len(toks), seq.remaining)
        if take <= 0:
            return
        if seq.t_first is None:
            seq.t_first = now
            if self.metrics is not None and not seq.req.ttft_preobserved:
                # From arrival, as Completion.ttft_s. A drain keeps
                # t_first, so a resume never observes again; a request
                # resumed on another replica carries ttft_preobserved.
                self.metrics.observe(
                    "engine_ttft_seconds",
                    now - (seq.t_submit + seq.req.arrival_s),
                )
        seq.out.extend(int(t) for t in toks[:take])
        self._progress += 1
        self._inc("engine_tokens_total", take)
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
        self._inc("engine_completed_total")
        if self.metrics is not None:
            # From arrival, as Completion.latency_s.
            self.metrics.observe(
                "engine_request_latency_seconds",
                now - (seq.t_submit + seq.req.arrival_s),
            )

    # --- metrics -----------------------------------------------------------

    def _inc(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.inc(name, value)

    def _export(self) -> None:
        if self.metrics is None:
            return
        m = self.metrics
        m.set_gauge(
            "engine_active_sequences",
            float(sum(1 for s in self._slots if s is not None)),
        )
        m.set_gauge("engine_queued_sequences", float(len(self._queue)))
        m.set_gauge("engine_pages_free", float(self.allocator.free_pages))
        stalled = (
            self.clock() - self._stalled_since
            if self._stalled_since is not None else 0.0
        )
        m.set_gauge("engine_admission_stalled", stalled)
        m.set_gauge(
            "engine_admission_blocked_on_pages",
            1.0 if self._blocked_on_pages else 0.0,
        )
        # The page allocations shared tables stand in for right now.
        m.set_gauge(
            "engine_prefix_shared_pages", float(self._track_shared()))
        delta = self.allocator.exhausted - self._exhausted_exported
        if delta:
            m.inc("engine_page_exhausted_total", delta)
            self._exhausted_exported = self.allocator.exhausted


# --- forward functions ---------------------------------------------------


def _embed(c: LlamaConfig, params: dict, tokens: torch.Tensor):
    return params["embed"]["embedding"].to(c.dtype)[tokens.long()]


def _decode_step(c, params, cache, tables, lengths, tokens, active, *,
                 sampling=None, seeds=None, sample_seed=None,
                 rows_split=False):
    """One paged decode step for the whole slot batch. tables [B, M],
    lengths/tokens [B] int32, active [B] bool. Writes each active
    slot's new K/V at position ``lengths`` in place, quantized first
    for int8 pools (inactive slots write to the scratch page and attend
    with length 0), then attends and runs the MLP block once per layer.
    ``sampling`` is (temperature, top_k) or None for greedy; sampled
    tokens draw with the keys of (sample_seed, seeds [B], position).
    Returns (lengths after the write, next tokens — inactive slots pass
    theirs through, fp32 logits [B, vocab]).

    Over a sharded tree (its mesh on ``params``) the layers run this
    rank's heads and gather over the model axis (``_finish_block``, the
    logits); with ``rows_split`` the inputs are this rank's row block of
    the batch axis, and the write positions and each layer's new K/V
    rows are gathered over it, so every rank's pools take every row."""
    B = tokens.shape[0]
    page = cache.page_size
    mesh = meshlib.params_mesh(params)
    split = rows_split and mesh is not None
    x = _embed(c, params, tokens)[:, None, :]  # [B, 1, d]
    cos, sin = rope_frequencies(c, lengths[:, None])  # [B, 1, hd/2]
    rows = torch.clamp(lengths // page, max=tables.shape[1] - 1).long()
    pids = torch.gather(tables, 1, rows[:, None])[:, 0]
    pids = torch.where(active, pids, paged_kv.SCRATCH_PAGE).long()
    offs = torch.where(active, lengths % page, 0).long()
    if split:
        pids, offs = mesh.gather_batch(torch.stack([pids, offs]), dim=1)
    len_eff = lengths + active.to(lengths.dtype)
    for layer in range(c.n_layers):
        lp = params[f"layer_{layer}"]
        q, k, v = _project_qkv(c, lp, x, cos, sin, B, 1)
        k, v = k[:, 0], v[:, 0]
        if split:
            kv = mesh.gather_batch(torch.stack([k, v], dim=1))
            k, v = kv[:, 0], kv[:, 1]
        scales = _write_kv(cache, layer, pids, offs, k, v)
        out = paged_decode_attention(
            q[:, 0], cache.k[layer], cache.v[layer], tables, len_eff,
            *scales, impl=c.paged_decode_impl, plan_kv_heads=c.n_kv_heads,
        )[:, None].to(c.dtype)
        x = _finish_block(c, lp, x, out, B, 1, mesh)
    x = _rms(x, params["final_norm"]["scale"], c.norm_eps)
    logits = meshlib.gather_model(
        mesh, _mm(x, params["lm_head"]).to(torch.float32)[:, 0])
    nxt = _pick_tokens(
        sampling, logits, seeds, len_eff, tokens.dtype, sample_seed)
    return len_eff, torch.where(active, nxt, tokens), logits


def _pick_tokens(sampling, logits, seeds, positions, dtype, sample_seed):
    """Next tokens for the slot batch: argmax (ties to the lowest id, as
    jnp.argmax), or under ``sampling`` = (temperature, top_k) one launch
    of the fused pick with row b's key fold(fold(PRNGKey(sample_seed),
    seeds[b]), positions[b]) — the token that will sit AT
    ``positions[b]``, the key the prefill pick uses for the first."""
    if sampling is None:
        return torch.argmax(logits, dim=-1).to(dtype)
    return sample_pick(
        logits, *sampling, seed=sample_seed, serials=seeds,
        positions=positions,
    ).to(dtype)


def _pick_tokens_batched(sampling, logits, seeds, positions, dtype,
                         sample_seed):
    """:func:`_pick_tokens` over [B, S] positions (logits [B, S, vocab])
    in one launch over B*S rows: position s of sequence b draws with
    the single-step key of (seeds[b], positions[b, s])."""
    B, S, V = logits.shape
    if sampling is None:
        return torch.argmax(logits, dim=-1).to(dtype)
    return sample_pick(
        logits.reshape(B * S, V), *sampling, seed=sample_seed,
        serials=seeds, positions=positions.reshape(B * S),
        rows_per_serial=S,
    ).reshape(B, S).to(dtype)


def _decode_chunk(c, params, cache, tables, lengths, tokens, active, *,
                  steps: int, **pick):
    """``steps`` decode steps back to back on the device (the JAX
    engine's ``lax.scan`` chunk). Returns (lengths, last tokens, tokens
    [steps, B]) as device tensors; the caller copies the tokens to the
    host once. ``pick`` holds :func:`_decode_step`'s sampling and
    ``rows_split`` arguments: with split rows, lengths and last tokens
    stay this rank's rows and the chunk's tokens are gathered over the
    batch axis once, at the end."""
    outs = []
    for _ in range(steps):
        lengths, tokens, _ = _decode_step(
            c, params, cache, tables, lengths, tokens, active, **pick
        )
        outs.append(tokens)
    out = torch.stack(outs)
    mesh = meshlib.params_mesh(params)
    if pick.get("rows_split") and mesh is not None:
        out = mesh.gather_batch(out, dim=1)
    return lengths, tokens, out


def _prefill_batch(c, params, cache, tables, starts, tokens, valids):
    """One batched prefill bucket: row i writes and attends its chunk
    tokens[i, :valids[i]] at positions starts[i] + j through its table
    (pad positions and idle rows write to the scratch page and are never
    read). Returns fp32 logits [B, vocab] at each row's last valid
    position (only rows finishing their prefill read them). Over a
    sharded tree the bucket runs whole on every rank of a batch column
    (replicated over the batch axis, as in JAX) and the logits are
    gathered over the model axis."""
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
    return meshlib.gather_model(meshlib.params_mesh(params), _mm(
        x_last, params["lm_head"]).to(torch.float32)[:, 0])


def _write_kv(cache, layer: int, pids, offs, k, v) -> tuple:
    """Scatter new K/V rows into layer ``layer``'s pools at (pids, offs),
    in place — for int8 pools quantized first, with their scales going
    through the same scatter. Returns the layer's (k_scale, v_scale)
    pools, or (None, None)."""
    if not cache.quantized:
        cache.k[layer][pids, offs] = k
        cache.v[layer][pids, offs] = v
        return None, None
    kq, ksc = quantize_kv(k)
    vq, vsc = quantize_kv(v)
    cache.k[layer][pids, offs] = kq
    cache.v[layer][pids, offs] = vq
    cache.k_scale[layer][pids, offs] = ksc
    cache.v_scale[layer][pids, offs] = vsc
    return cache.k_scale[layer], cache.v_scale[layer]


def _write_then_attend(c, params, cache, tables, pids, offs, pos_q, toks,
                       positions):
    """Embed ``toks`` [B, S], write every position's K/V (quantized in
    flight for int8 pools) through the caller's (pids, offs) scatter,
    attend all S positions causally via
    paged_multiquery_attention with per-row chunk starts ``pos_q``, and
    return the final-norm hidden states."""
    B, S = toks.shape
    mesh = meshlib.params_mesh(params)
    x = _embed(c, params, toks)  # [B, S, d]
    cos, sin = rope_frequencies(c, positions)  # [B, S, hd/2]
    for layer in range(c.n_layers):
        lp = params[f"layer_{layer}"]
        q, k, v = _project_qkv(c, lp, x, cos, sin, B, S)
        scales = _write_kv(cache, layer, pids, offs, k, v)
        out = paged_multiquery_attention(
            q, cache.k[layer], cache.v[layer], tables, pos_q, *scales,
        ).to(c.dtype)
        x = _finish_block(c, lp, x, out, B, S, mesh)
    return _rms(x, params["final_norm"]["scale"], c.norm_eps)


def _verify_chunk(c, params, cache, tables, lengths, tokens, drafts,
                  draft_count, active, *, sampling=None, seeds=None,
                  sample_seed=None):
    """The speculative verify pass: K+1 positions per sequence against
    the paged cache in one pass.

    tokens [B]: each sequence's real last token (not yet written);
    drafts [B, K] (pad past draft_count [B]). Writes K/V for
    [token, d_0, ..., d_{K-1}] at positions [L, L+K] (masked rows and
    pads go to the scratch page), attends every position causally
    through the block tables, and picks every position's next token
    with the per-token key schedule. Acceptance stays on the device:
    n_acc is the longest prefix where pick[i] == draft[i], and the
    emitted run is pick[0..n_acc]. pick[i] depends only on K/V at
    positions <= L + i, which hold real tokens whenever i <= n_acc, so
    the run is what the per-token path emits, whatever was proposed.
    Returns (new lengths, new last tokens, n_acc, picks [B, K+1]) as
    device tensors."""
    B, K = drafts.shape
    S = K + 1
    page = cache.page_size
    dev = tokens.device
    toks = torch.cat([tokens[:, None], drafts], dim=1)  # [B, S]
    ar = torch.arange(S, dtype=lengths.dtype, device=dev)
    positions = lengths[:, None] + ar[None]  # [B, S]
    write_ok = active[:, None] & (ar[None] < (draft_count + 1)[:, None])
    safe_rows = torch.clamp(positions // page, max=tables.shape[1] - 1)
    pids = torch.where(
        write_ok, torch.gather(tables, 1, safe_rows.long()),
        paged_kv.SCRATCH_PAGE,
    ).long()
    offs = torch.where(write_ok, positions % page, 0).long()
    pos_q = torch.where(active, lengths, 0)
    x = _write_then_attend(
        c, params, cache, tables, pids, offs, pos_q, toks, positions
    )
    logits = _mm(x, params["lm_head"]).to(torch.float32)  # [B, S, V]
    picked = _pick_tokens_batched(
        sampling, logits, seeds, positions + 1, tokens.dtype, sample_seed
    )
    match = (picked[:, :K] == drafts) & (ar[None, :K] < draft_count[:, None])
    n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    n_acc = n_acc.to(lengths.dtype)
    new_len = torch.where(active, lengths + 1 + n_acc, lengths)
    new_last = torch.where(
        active, torch.gather(picked, 1, n_acc.long()[:, None])[:, 0], tokens
    )
    return new_len, new_last, n_acc, picked
