#!/usr/bin/env python3
"""Where the tensor-core decode MLP (tpu_dra_torch/csrc/decode_mlp_sm90.cu)
spends its time, on one NVIDIA GPU.

    python3 decode_mlp_ablation.py [variants] [plans] [generate]

(no argument runs every phase). Phases, one JSON line each after the
card's nvidia-smi line, all at Llama-3-8B widths (d = 4096, ffn =
14336), bf16, B = 8 unless named:

1. variants — the source built as it is and with one part changed
   (VARIANTS: exact source text replaced; a changed source raises and
   builds nothing): the down pass launched without programmatic
   dependent launch (no PDL: it starts once gate/up has ended); the
   gate/up CTAs letting the down pass launch as they start (trigger
   early) instead of once their last stage is issued; the gate/up pass
   without its norm (x's copies issued and never waited for, xn left
   raw); no weight copies (the ring is read as it lies); the launch
   alone (every CTA leaves at once). All but "as_is", "no_pdl" and
   "trigger_early" give wrong results; only their times count. Each is timed as chip_smoke.py times a
   kernel (time_ms: L2 flushed, host enqueue kept out, median of 60) in
   two rounds, with each pass's device µs from torch.profiler.
2. plans — the kernel as it is under other plans (PLANS: width, cluster
   and ring depth of one pass, the wrapper's plan for the other), timed
   the same way, B = 8 and B = 16; and how many clusters of each
   configuration the card holds at once (cudaOccupancyMaxActiveClusters,
   through the source's entry).
3. generate — greedy_generate (32 layers, random weights, b = 8,
   prompt 256, 32 new tokens, bf16) with the decode MLP on the
   tensor-core route ("sm90") or forced onto decode_mlp.cu ("simt", the
   route before it), in turns sm90, simt, simt, sm90 after one untimed
   call of each: wall seconds and tok/s.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "decode_mlp_sm90.cu"
ENTRY = "tpu_decode_mlp_sm90"
PDL = "  cfg.numAttrs = gate_up ? 1 : 2;\n"
W_COPY = "      cp_async16(stage + w_dst[j], ok ? w_src[j] : a.w0, ok);\n"
PROLOGUE = "  if (GATE_UP) {\n    // Each row's sum of x^2"
TRIGGER = "    if (n_stages < slots) grid_dependents_launch();\n"
TRIGGER_LOOP = ("    if (GATE_UP && s == n_stages - slots) "
                "grid_dependents_launch();\n")
KERNEL_TOP = "  constexpr int kRed = kMats * kRows * 16;  // a warp's sums\n"
# name: (old, new) replacements of decode_mlp_sm90.cu.
VARIANTS = {
    "as_is": [],
    "no_pdl": [(PDL, "  cfg.numAttrs = 1;\n")],
    "trigger_early": [(TRIGGER, "    grid_dependents_launch();\n"),
                      (TRIGGER_LOOP, "")],
    "no_norm": [(PROLOGUE, "  if (GATE_UP && a.M < 0) {\n"
                           "    // Each row's sum of x^2")],
    "no_w_copy": [(W_COPY, "      (void)ok;\n")],
    "launch_only": [(KERNEL_TOP, KERNEL_TOP + "  if (a.M > 0) return;\n")],
}
# pass: ((width, cluster, slots or None for the wrapper's), ...).
PLANS = {
    "gate_up": ((128, 1, 3), (128, 1, 4), (128, 1, 5), (64, 1, None),
                (64, 2, None)),
    "down": ((128, 3, None), (128, 4, None), (64, 1, None), (128, 2, None),
             (64, 4, None), (64, 2, 3), (64, 2, 4)),
}
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
    ctypes.c_float, ctypes.c_void_p]


def build_variants(kernels) -> dict:
    """Each variant's C entry, built into build/decode_mlp_ablation/."""
    out_dir = os.path.join(REPO, "build", "decode_mlp_ablation")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(kernels.CSRC, SOURCE)).read()
    procs = {}
    for name, reps in VARIANTS.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"decode_mlp_sm90_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", os.path.join(out_dir, f"decode_mlp_sm90_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"decode_mlp_sm90_{name}.so"))
        fn = getattr(lib, ENTRY)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


class Call:
    """One call of a decode_mlp_sm90.cu entry on fixed inputs and
    outputs, under a given plan (DM.MlpPlan)."""

    def __init__(self, C, DM, kernels, gen, b):
        self.DM, self.kernels = DM, kernels
        self.x, self.scale, tree = C.mlp_inputs(gen, b)
        self.ws = C.mlp_weights(tree)
        self.b, self.d = self.x.shape
        self.ffn = self.ws[0].shape[1]
        self.act = torch.empty(self.b, self.ffn, dtype=torch.bfloat16,
                               device="cuda")
        self.out = torch.empty_like(self.x)
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.plan = DM.mlp_sm90_plan(self.b, self.d, self.ffn, self.sms)

    def __call__(self, fn, plan=None):
        gu, dn = (plan or self.plan)[1:]
        self.kernels.check(fn(
            self.x.data_ptr(), self.scale.data_ptr(),
            *(w.data_ptr() for w in self.ws), self.act.data_ptr(),
            self.out.data_ptr(), self.b, self.d, self.ffn, gu.width,
            gu.cluster, gu.cta_steps, gu.slots, dn.width, dn.cluster,
            dn.cta_steps, dn.slots, 1e-5,
            torch.cuda.current_stream().cuda_stream), "decode_mlp variant")

    def other(self, which: str, width: int, cluster: int, slots):
        """The wrapper's plan with pass ``which`` at (width, cluster,
        slots); None when that pass does not fit."""
        gate_up = which == "gate_up"
        k, n = (self.d, self.ffn) if gate_up else (self.ffn, self.d)
        p = self.DM._mlp_pass(self.plan.planes, k, n, gate_up, width,
                              cluster)
        if p is None:
            return None
        if slots is not None:
            stage = 16384 if gate_up else p.smem // p.slots
            p = p._replace(slots=slots, smem=p.smem - (p.slots - slots)
                           * stage)
        return self.plan._replace(**{which: p})


def variants_phase(C, DM, kernels, rates) -> dict:
    fns = build_variants(kernels)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    call = Call(C, DM, kernels, gen, 8)
    ms = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            ms[name].append(C.time_ms(lambda: call(fn), flush))
    passes = {name: C.mlp_pass_profile(lambda: call(fn), flush)
              for name, fn in fns.items()}
    d, ffn = call.d, call.ffn
    return {
        "shape": f"B=8, d={d}, ffn={ffn}, bf16",
        "plan": C.mlp_plan_dict(call.plan), "ms": ms, "passes_us": passes,
        **C.bound(3 * d * ffn * 2 + d * 2 + 2 * call.x.numel() * 2,
                  6 * 8 * d * ffn, rates),
    }


def plans_phase(C, DM, kernels) -> dict:
    fn = kernels.function(SOURCE, ENTRY, ARGTYPES)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for b in (8, 16):
        call = Call(C, DM, kernels, gen, b)
        row = {"plan": C.mlp_plan_dict(call.plan),
               "wrapper_plan_ms": C.time_ms(lambda: call(fn), flush),
               "wrapper_plan_passes": C.mlp_pass_profile(
                   lambda: call(fn), flush)}
        for which, options in PLANS.items():
            for width, cluster, slots in options:
                plan = call.other(which, width, cluster, slots)
                key = f"{which}_w{width}_c{cluster}_s{slots or 'max'}"
                if plan is None:
                    row[key] = "does not fit shared memory"
                    continue
                p = getattr(plan, which)
                row[key] = {"ctas": p.ctas, "slots": p.slots,
                            "ms": C.time_ms(lambda: call(fn, plan), flush),
                            "passes": C.mlp_pass_profile(
                                lambda: call(fn, plan), flush)}
        out[f"b{b}"] = row
        del call
    query = kernels.function(SOURCE, "tpu_decode_mlp_sm90_max_clusters",
                             [ctypes.c_int] * 6)
    occupancy = {}
    for gate_up, width in ((True, 128), (True, 64), (False, 128),
                           (False, 64)):
        k, n = (4096, 14336) if gate_up else (14336, 4096)
        row = {}
        for cluster in range(1, 9):
            p = DM._mlp_pass(1, k, n, gate_up, width, cluster)
            if p is not None:
                row[cluster] = query(1, int(gate_up), width, p.cluster,
                                     p.cta_steps, p.slots)
        occupancy[f"{'gate_up' if gate_up else 'down'}_w{width}_b8"] = row
    out["max_active_clusters"] = occupancy
    return out


class ForceSimt:
    """While active, the decode MLPs that would take the tensor-core
    kernel take decode_mlp.cu instead."""

    def __init__(self, DM, on: bool):
        self.DM, self.on = DM, on

    def __enter__(self):
        self.orig = self.DM._decode_mlp_route
        if self.on:
            self.DM._decode_mlp_route = lambda x, ws: "simt"

    def __exit__(self, *exc):
        self.DM._decode_mlp_route = self.orig


def generate_phase(G, DM, kernels, cfg, params) -> dict:
    import numpy as np

    b, s, new = 8, 256, 32
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(1, cfg.vocab_size, (b, s))
        .astype(np.int32))
    runs = {"sm90": [], "simt": []}
    launches = {}
    for i, route in enumerate(("sm90", "simt") + ("sm90", "simt", "simt",
                                                  "sm90")):
        kernels.reset_launches()
        with ForceSimt(DM, route == "simt"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            G.greedy_generate(cfg, params, prompt, new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches[route] = {k: kernels.LAUNCHES[k]
                           for k in ("decode_mlp", "decode_mlp_sm90")}
        if i >= 2:
            runs[route].append(wall)
    return {
        "batch": b, "prompt": s, "new_tokens": new, "wall_seconds": runs,
        "tok_s": {k: [b * new / w for w in v] for k, v in runs.items()},
        "launches": launches,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_mlp_ablation: no CUDA device", file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke as C
    from tpu_dra_torch import kernels
    from tpu_dra_torch.workloads import generate as G
    from tpu_dra_torch.workloads.models.llama import LLAMA3_8B, init_params
    from tpu_dra_torch.workloads.ops import decode_mlp as DM

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rates = C.peaks(torch.cuda.get_device_name(0))
    phases = sys.argv[1:] or ["variants", "plans", "generate"]
    unknown = set(phases) - {"variants", "plans", "generate"}
    if unknown:
        print(f"decode_mlp_ablation: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    kernels.build()
    if "variants" in phases:
        C.emit("variants", **variants_phase(C, DM, kernels, rates))
    if "plans" in phases:
        C.emit("plans", **plans_phase(C, DM, kernels))
    if "generate" in phases:
        cfg = LLAMA3_8B
        params = init_params(cfg,
                             torch.Generator(device="cuda").manual_seed(0))
        C.emit("generate", **generate_phase(G, DM, kernels, cfg, params))
    return 0


if __name__ == "__main__":
    sys.exit(main())
