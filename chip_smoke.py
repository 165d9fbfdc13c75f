#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_dra_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result:

1. device  — needs CUDA (else exits 1 at once); prints the card's name
   and power limit as nvidia-smi reports them; TF32 off.
2. build   — builds every kernel from tpu_dra_torch/csrc with nvcc
   (one process per source, in parallel) into build/torch_kernels/;
   prints each instantiation's registers, shared memory and spills, and
   for the wgmma kernels (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu,
   flash_bwd_sm90.cu, int8mm_sm90.cu) the dynamic shared memory a CTA
   asks for; every instantiation of the wgmma kernels, of the decode
   bodies (decode_split_kernel, decode_combine_kernel in paged_decode.cu
   and decode.cu), of the tensor-core int8 GEMV
   (int8mm_gemv_sm90.cu: the mma.sync body at 1 and 2 planes, the
   wgmma body at 4 planes with 2, 4 and 8 tiles a warp, at 8 with 2
   and 4 and at 16 with 2) and of the tensor-core decode MLP
   (decode_mlp_sm90.cu: gate/up and down at 1, 2, 4, 8 and 16 planes)
   must spill 0 bytes.
2b. bootstrap — the slice bootstrap and collective smokes
   (tpu_dra_torch/workloads/{bootstrap,smoke,icibandwidth,
   rendezvous_smoke}.py), at most about 60 s: matmul_smoke (bf16
   1024 x 1024) and decode_smoke on the card, the default one
   (SMOKE_LLAMA, bf16, batch 2, 16 new tokens) launching
   csrc/decode.cu and the tensor-core decode MLP once a layer a decode
   step (its launches go to the kernels line), each kernel held against
   its plain version on every input that run gave it (the bf16 bar
   below), and at fp32 (decode.cu's fp32 build and decode_mlp.cu, each
   launched once a layer a step; the plain arm launches none) its
   tokens identical to the same call with the plain attention and MLP; a
   world-1 NCCL process group built by bootstrap.rendezvous (the path
   initialize_from_env takes), running pmap_psum_smoke and
   measure_collectives (one rank: the hbm_copy probe, 64 MB, 10 reps,
   printed beside the nvidia-smi line; one card shows no fabric);
   rendezvous_smoke as 2 gloo ranks on the host from config dirs
   rendered as the slice daemon renders them (psum 3, the same loss on
   both); and python -m tpu_dra_torch.workloads.train --distributed
   --model tiny --steps 2 with a 1-process env. Every subprocess has its
   own timeout (SLICE_TIMEOUT_S) and is reaped.
3. parity  — each kernel against its plain PyTorch version and the fp32
   reference, in bf16 at Llama-3-8B widths (h=32, kvh=8, hd=128,
   d=4096, ffn=14336, vocab 128256): paged decode with B=8, page 16,
   513 pages and lengths [0,1,15,16,17,255,512,1000], then lengths on
   the split boundaries and at the capacity [63,64,65,127,128,129,1023,
   1024], then one slot of 8192 keys, with bf16 pools and with int8
   pools, and a block table whose 8 slots alias the same 12 leading
   pages (a shared prefix) against one where each slot reads private
   copies of them (paged_kv.copy_page): bit-identical; decode MLP with
   B in {1, 8, 13, 16, 17, 24, 32, 48, 64, 65, 96, 127, 128} (1, 2, 4,
   8 and 16 planes of 8 rows), each on the tensor-core route (sm90,
   decode_mlp_sm90.cu, one launch with its plan; reruns bit-identical),
   and at B in {129, 200} through the wrapper's blocks of 128 rows (a
   launch a block, each block's plan), and decode_mlp.cu
   (the simt route: fp32) launched directly at fp32 B = 8 and bf16
   B = 32 (whose route is now sm90: the row holds the kernel it
   replaced there) and through the wrapper at fp32 B = 128, against the
   plain version on the same inputs; the int8 matmul at
   M in {1, 8, 1024} for (K, N) in {(4096, 14336), (14336, 4096),
   (4096, 1024), (4096, 128256)}, at M in {17, 129, 2048} for
   4096 x 14336, wq/wo's 4096 x 4096 at M in {1024, 2048}, the
   lm_head at M = 2048, M in {2, 13, 16, 24, 32, 33, 48, 64, 65, 96,
   127, 128} for 4096 x 14336 and M in {32, 64, 128} at the other four
   decode shapes (INT8MM_PARITY), with an all-zero weight column, each
   row naming its route (gemv_sm90, the tensor-core GEMV, which every
   row with M <= 128 must take, with its plan: 1 or 2 planes of 8 rows
   on its mma.sync body, 4, 8 or 16 on its wgmma body; sm90, the wgmma
   tile, which every bf16 row with M > 128 must take); each row with
   M <= 16 also holds int8mm.cu's weight-streaming GEMV, which still
   serves fp32 and the shapes the new one does not take, on the same
   inputs (zero column, reruns bit-identical); each row with
   17 <= M <= 128 also holds int8mm_sm90.cu's wgmma tile, which served
   those rows before the GEMV's wgmma body, launched directly on the
   same inputs (the same bars, zero column, reruns bit-identical); each
   row with M > 128 also holds int8mm.cu's WMMA tile, which
   serves the bf16 shapes the wgmma tile does not take, on the same
   inputs (zero column, reruns bit-identical); the
   contiguous decode, bf16 and int8 caches, b=8, max_seq 1024, lengths
   {1, 63, 64, 65, 129, 255, 256, 257, 1000}, and b=1 with 8192 keys
   (the decode kernels split the keys over CTAs: at fp32 each is held
   to the plain split form with the kernel's split plan, and reruns
   are bit-identical); both decode kernels past that shape, held the
   same way (decode_grid: hd in GRID_HDS, 16 to 256, x n_rep in
   GRID_REPS, 1 to 32, at kvh 2, bf16 and int8 caches, paged with a
   dead slot and a slot at the table's capacity, contiguous at lengths
   0, 1, 333 and 1024); the three flash kernels (forward, dQ,
   dK/dV) at b=2, h=32, kvh=8, hd=128 for s=2048 causal and non-causal,
   ragged s=1000 causal and suffix queries sq=512 over skv=2048 (with a
   non-zero lse cotangent folded into delta), and the ring's chunk pairs
   on a tp=2 head shard, sq = skv = 1024 at h 16 over kvh 4, causal and
   full, each with an lse cotangent, each against its plain
   version on the same inputs, bf16 and fp32, reruns bit-identical;
   each case names the forward's, the dQ and the dK/dV kernel's routes
   (sm90: the wgmma kernels for bf16 at hd 64/128, which every bf16 case
   must take; wmma: flash_attention.cu's kernels, fp32 here).
   Tolerance: rtol 2e-2 plus, per row (one head of one slot or token,
   one token of the MLP, one output row of the matmul), an atol of two
   bf16 ulps of that row's largest |reference| value. At fp32 each new
   kernel matches its plain version within 1e-5 of the output's largest
   magnitude (the flash lse too); the flash gradients within 1e-4, as
   they sum up to n_rep * s rows in another order.
4. timing  — CUDA events around single launches after warm-up, the L2
   cleared before each by reading a 64 MB buffer (L2_EVICT), median of
   60, the host's enqueue time kept out
   of the interval (time_ms): kernel, plain version, and the least time
   the card could take (bytes over the memory rate vs operations over
   the bf16 peak, whichever is larger). Each kernel also has
   ``ms_with_host``, timed with the wrapper's host time included. The
   decode MLP at B = 8, 32, 64, 96 and 128 (MLP_TIMING_ROWS) on the
   tensor-core kernel, with the kernel it replaced on this route on the
   same inputs (decode_mlp.cu up to 64 rows; at 96 and 128 the blocked
   route, the kernel launched on each block of 64 rows), each pass's
   device time from torch.profiler, and as the library yardstick a chain
   of PyTorch library calls for the same block (rms_norm, three cuBLAS
   GEMMs, silu, mul, add: a chain, not one call). The MLP's two halves
   on a model shard (mlp_halves: 3 rows, one of 2 column blocks, fp32 on
   decode_mlp.cu and bf16 on decode_mlp_sm90.cu, as engine_sharded's
   world-2 ranks run them), each held against its plain half, the
   gate/up half's act against the same columns of the whole gate/up
   half and the down half against the fused kernel bit for bit, with
   its plain half's time and, for the down half, torch.addmm's (the one
   library call for x + act · w_down). The flash kernels at b=2, s=2048, causal, bf16, with SDPA's forward and
   its backward (the dQ + dK/dV pair) as the library yardsticks, each
   with achieved TFLOP/s and share of the bound; each flash row also
   times the WMMA kernel it replaced, on the same inputs, and the dK/dV
   row the pair's time (dQ + dK/dV) beside SDPA's backward. The int8
   contiguous-decode row times SDPA over the live K/V dequantized to
   bf16 as its yardstick (no PyTorch call takes the int8 cache). The
   int8 matmul's tensor-core GEMV at every decode shape (M = 8), each
   row asserted to take it, with its plan, share of the bound and
   int8mm.cu's GEMV on the same inputs (old_gemv_ms); the GEMV's wgmma
   body at a w8 engine's 17-128 decode rows (INT8MM_WIDE_TIMING:
   gate/up at M = 32, 64, 96 and 128, every other decode shape at
   M = 32 and 128), each row asserted to take it at 4, 8 or 16 planes,
   with its plan, the wgmma tile
   it replaced there on the same inputs (sm90_tile_ms), a bf16 matmul on
   a dequantized copy as the yardstick and share of the bound; and the
   wgmma tile at each prefill shape (INT8MM_PREFILL_TIMING: every
   projection at the engine bucket's M = 1024, the lm_head at the
   generate prefill's M = 2048), each row asserted to take the wgmma
   tile, with the WMMA tile it replaced on the same inputs (its output
   held against the plain version), a bf16 matmul on a dequantized copy
   as the yardstick,
   TFLOP/s and share of the bound. The
   decode rows print their split plan (splits, row groups, CTAs), two
   long rows time one 8192-key sequence (decode_attention_long,
   paged_decode_attention_long), and three rows past Llama-3-8B's
   heads: paged bf16 at Llama-3.2-3B's (kvh 8, n_rep 3, hd 128) and at
   hd 256 (kvh 8, n_rep 2), contiguous bf16 at hd 256, each with its
   SDPA yardstick.
4b. sampling — the fused pick (csrc/sample.cu) at [8, 128256] fp32,
   seeded logits and a copy rounded through bf16 (ties at the top),
   for (temperature, top_k) in PICK_CASES and both key layouts (the
   engine's per-row (seed, serial, position) keys, sample_generate's
   one folded key for the block): the kernel, its plain version on the
   card and the plain version on the CPU draw identical tokens over
   identical candidates; the plain jax.random twins give the same
   Threefry bits and uniforms on the card as on the CPU and Gumbel
   values within 2 ulps of max(|g|, 1); topk_exact agrees; the pick's
   time beside its bound, the plain pick and argmax.
5. tiny    — fp32 TINY_LLAMA at its own width (dim 64, hd 16) on the
   card (kernels) and on the CPU
   (plain versions): the bf16-config engine agrees on >= 0.97 of the
   tokens; the w8+kv8 engine and greedy_generate in all four
   (kv_quant, weight_quant) combinations give identical tokens; the
   twin config of tests/test_torch_train.py (dim 256, 2 layers, hd 64,
   fp32) trains 3 steps with the same losses within 1e-5 relative; a
   prefix-sharing trace (5 requests, a 14-token prefix of 4-token
   pages) run shared and private on the card, shared on the CPU, and
   through an EventGate drain (drain_drill) on the card: shared vs
   private, drained vs undrained and card vs CPU each agree on >= 0.97
   of the tokens (first difference and top-2 gap reported).
6. engine  — Llama-3-8B widths, all 32 layers, vocab 128256, bf16,
   random weights from a seeded CUDA generator; 8 seeded requests
   (prompts 64-512, 32-64 new tokens) through the paged engine. Every
   request completes with its token count, the allocator ends
   leak-free, and both bf16 kernels launch once per layer per decode
   step, every decode MLP on the tensor-core route; a profile of steady
   decode names the decode attention's split and combine kernels' and
   the decode MLP's kernels' device ms per step (the MLP: the two passes
   of decode_mlp_sm90.cu, one launch each per layer per step, and none
   of decode_mlp.cu's) and the MLP's share of the step's device time.
   Then, with all 8 slots
   decoding the same prompts, one decode
   step runs from one state with kernels, plain versions, fp32
   reference versions and each kernel alone (STEP_VARIANTS): with fp32
   weights every pair's logits agree above cosine 0.9999; in bf16 see
   step_gates. The same step with the depth cut to 2 layers, in bf16,
   holds every pair above 0.999.
6b. decode_shapes — (a) Llama-3.2-3B's widths (LLAMA32_3B: hd 128,
   n_rep 3), 28 layers, bf16, random weights from a seeded CUDA
   generator: the engine phase's requests (decode tok/s, TTFT p50; 28
   paged-attention launches a decode step, as reckoned), the one-state
   decode step of every STEP_VARIANTS variant under step_gates (bf16 at
   28 layers, fp32, bf16 at 2 layers), greedy_generate at b=8, prompt
   256, 32 new tokens (28 contiguous-decode launches a step), and the
   routes the decode MLP and the int8 matmul take at its shapes; (b)
   each SHAPE_GRID (hd, heads, kv heads) at 2 layers, fp32: the engine
   with the kernels gives the tokens of the engine with the plain paged
   attention and MLP, with and without kv_quant int8, the kernels'
   launches as reckoned and no plain version called on a CUDA tensor.
   The phase prints its seconds.
7. engine_w8kv8 — the same requests with weight_quant="int8" and
   kv_quant="int8": every request completes, the allocator ends
   leak-free with every pool (scales included) zero; per decode step
   225 int8 matmul launches (7 projections x 32 layers + the lm_head),
   every launch with M > 128 (the prefill projections) on the wgmma tile
   and every other on the tensor-core GEMV (int8mm.cu's GEMV never), 32
   paged-decode launches on int8 pools and no fused-MLP launch; a
   profile of its steady decode as for the bf16 engine, with the int8
   matmul's device ms and launches a step (225, all the tensor-core
   GEMV's: one launch a call; rounded, as the trace can come back a few
   records short, while the profiled window's own launch counters, set
   to 0 just before it, are held to the count exactly
   (hold_window_launches); so are the MLP counts of the engine,
   engine_wide and engine_wide128 profiles), and of one prefill bucket (8 rows x a
   128-token chunk, M = 1024) by kernel with the int8 matmul's share.
   The one-state
   decode-step check with W8_STEP_VARIANTS, at bf16, fp32 activations
   and bf16 cut to 2 layers.
7b. engine_sampled — the engine phase's config and requests with
   temperature 0.8, top_k 40, sample_seed 11: fused is token-identical
   to fused=False, contiguous=True; paged-decode and tensor-core MLP
   launches as greedy's, sample_pick one a decode step plus one a
   finishing prefill row; a decode step at most 16 launches above the
   greedy step's (profile); decode tok/s and TTFT beside greedy's. The
   tiny fp32 sampled engine is token-identical on the card and the CPU.
7c. engine_spec — spec_k 4: the tiny fp32 spec engine (greedy, sampled,
   and both under w8kv8, n-gram drafts on lookup-friendly prompts) is
   token-identical to its fused=False, contiguous=True oracle on the
   card (else the first differing position and its top-2 logit gap),
   its pool whole and zero; at 8B widths (bf16, 32 layers) with the
   n-gram draft and a replay of the greedy run's tokens, on the engine
   phase's first SPEC8_REQUESTS (4) requests cut to SPEC8_NEW_TOKENS
   (16) new tokens: proposed, accepted, decode tok/s against the
   non-spec engine and token agreement with the greedy run's first
   tokens (no identity gate: the verify pass runs the plain attention
   and MLP chain, the per-token step the kernels); w8kv8 with the
   n-gram draft on the same requests, every verify-pass matmul (M = 40)
   on the tensor-core GEMV's wgmma body (8 planes). The cut took the
   two 8B bf16 runs from 39.2 and
   42.0 s (8 requests, 32-64 new tokens) to 13.5 and 12.1 s, the phase
   from 136.7 to 91.2 s (NVIDIA H100 80GB HBM3, 700.00 W); the w8kv8 run
   took the same cut when the fabric phase (7f) came.
7d. engine_prefix — the engine phase's config, 8 requests sharing a
   seeded 200-token prompt (12 full pages and a frozen boundary page)
   with 16-64-token suffixes and 32 new tokens, run shared
   (prefix_id "sys") and private, each with a MetricsRecorder: pools
   whole and zero, the kernels launched as in the engine phase; shared:
   7 attaches, 7 forks, prefix_saved_hw 7 x 12 + 6 (the 7 followers
   attach the frozen page in one tick before they fork it), the
   shared-pages gauge's peak 7 x 12, peak pages at least 7 x 12 - 1
   under the private run's, and the recorder's attach, fork, token and
   completion counters equal to the engine's; then the shared trace
   again under an EventGate revoked two steps after the followers
   attach (drain_drill): one drain, every request once with its tokens
   and its pre-drain tokens first, sharing resumed. Reported: token
   agreement (first difference, top-2 gap), prefill buckets and
   tokens, TTFT p50, and a fork's launches and ms.
7e. engine_migrate — evacuation and live KV migration at 8B widths
   (the engine phase's config and requests; bf16 at 32 layers, w8kv8
   cut to MIGRATE_W8_LAYERS (2) layers on one int8 tree for every w8kv8
   engine), each arm in bf16 and in w8kv8: the handoff (a source engine
   as a prefill-role replica, a fresh destination as a decode-role one,
   in Replica._loop's order: grafts between steps, steps, exports of
   every decoding_rids()) and the whole batch (every decoding sequence
   exported at the step boundary after the last prefill, imported in
   slot order into a fresh engine) token-identical to the unmigrated
   completions (bf16: the engine phase's; w8kv8: one engine's run of
   the same requests at its depth) (else the first difference and its
   top-2 gap); the handoff's launches read around it (L paged-decode
   launches a decode step of both engines, and the bf16 MLP's or the
   int8 GEMV's); the evacuation (at the first step boundary where a
   sequence decodes, resumed on a fresh engine as Request(prompt +
   emitted)) reported as token agreement, first difference and top-2
   gap (a re-prefill rounds otherwise than decode-written KV). Each
   extent's bytes as reckoned (bf16 2 MiB a page, w8kv8 1.03 MiB at 32
   layers, a sixteenth of it at 2),
   serialize and graft ms and GB/s beside a 256 MiB pinned copy each
   way, and the longest sequence's re-prefill alone to its first token
   (the fallback migration replaces). At tiny fp32 on the card, greedy
   and sampled: the handoff, the whole batch and the evacuation
   token-identical to the unmigrated run. After every arm each engine's
   pool is whole and zero.
7f. fabric — the port's serving tier (tpu_dra_torch/serving/) on the
   card: its Router (one INTERACTIVE tenant, FABRIC_INFLIGHT sequences
   a replica) over replica threads (Replica.start), each an Engine of
   the engine phase's config on one shared 8B bf16 weight tree (32
   layers), warmed before its thread starts; the engine phase's
   FABRIC_REQUESTS requests with the shortest prompts cut to
   FABRIC_NEW_TOKENS new tokens, in four arms (FABRIC_ARMS): colocated
   (two "both" replicas), disaggregated (a "prefill" and a "decode"
   replica: extents shipped through the Router's migration path), crash
   and stall (inject_fault, armed on the first replica whose step leaves
   a sequence mid-generation; the stall watchdog FABRIC_STALL_S).
   Gates (fabric_arm): every request completes once with its token
   count, no duplicate, the journal closed with each sequence
   re-dispatched at most once; the Router's deaths equal the injected
   faults, no replica has another error and none dies where nothing was
   injected; the stall detected within the watchdog's deadline plus
   FABRIC_STALL_MARGIN_S; paged-decode and MLP launches 32 a decode
   step summed over the replicas (as engine_migrate reckons them); every
   pool whole and zero. Reported: token agreement with the engine
   phase's completions (first difference, top-2 gap), TTFT p50/p99,
   decode tokens over the arm's wall beside the engine phase's, each
   replica's decode steps and step seconds, the longest step, extents
   shipped and their ms. At tiny fp32 on the card, greedy and sampled:
   the four arms and a scale-down through the ClaimAutoscaler (over
   tpu_dra_torch.serving.claims.ClaimStore), each token-identical to one
   engine's run.
7g. fabric_bench — the port's fabric benches (tpu_dra_torch/serving/
   fabricbench.py, faultbench.py, disaggbench.py, repack.py) through
   their own functions on the card, over the default ClaimStore, with no
   timing bypass set. At tiny fp32: fabricbench.run_fairness_pair (the
   quiet tenant's TTFT p99 within FAIRNESS_MAX_X of its hot-absent
   baseline or under FAIRNESS_FLOOR_MS) and run_autoscale_drill;
   faultbench.run_crash_drill greedy and sampled (the recovery p99 under
   its 20 s bound) and run_crash_loop_drill; disaggbench.run_parity and
   run_kill_drill, each with every gate of its own; and one
   mid-generation migration through FabricRepackAdapter called in the
   Repacker's order (begin_drain, drain_done, finish_drain, rebind),
   token-identical to one engine's run, with begin_drain and abort on a
   second replica that keeps serving. At Llama-3-8B widths, 32 layers,
   bf16 (one weight tree): fabricbench.run_headline on the smoke's
   tenant mix over 2 replicas (BENCH_8B_HEADLINE) and
   disaggbench.run_measure, 2 colocated replicas against 1 prefill + 1
   decode (BENCH_8B_DISAGG), the Router's watchdog at BENCH_8B_STALL_S:
   every admitted request completes once;
   reported: TTFT p50/p99 by tenant, ITL, disagg_vs_colocated_ttft and
   _itl, token shares, peak concurrency, affinity hits, prefix pages
   saved, and token agreement with one engine's run. Every arm runs
   under a BenchWatch (no replica error but an injected ReplicaFault,
   the Routers' deaths equal the faults injected, every engine's pool
   whole and zero, each Router's stall watchdog beside the longest
   replica step) and bench_launch_gate (paged-decode and MLP launches L
   a decode step over every engine the benches built).
8. generate — greedy_generate at the same widths, b=8, prompt 256, 32
   new tokens, once in bf16 and once with int8 weights and KV: 32
   contiguous-decode launches per decode step, and 32 fused-MLP (bf16,
   all on the tensor-core route) or 225 int8 matmul (w8kv8) launches per
   step; the w8kv8 prefill's
   225 (M = 2048, the lm_head over every position) all on the wgmma
   tile, the decode steps' all on the tensor-core GEMV.
8c. generate_wide, engine_wide128, engine_wide (run right after phase
   8, on its weights) — greedy_generate in bf16 at b = 128 (WIDE_GEN:
   prompt 32, 4 new tokens): it runs, and each decode step launches the
   decode attention 32 times and the tensor-core MLP 32 times (one
   launch of 128 rows at 16 planes a layer); token agreement with the
   plain bf16 run reported. Then the paged engine at 128 slots (JAX's
   serve bench at --batch 64: EngineConfig(page_size=16,
   max_slots=128, max_pages_per_seq=16, scan_chunk=8,
   prefill_chunk=128)), 128 seeded requests with prompts of 16 or 64
   tokens and 16 new tokens each (engine_wide128): every request
   completes, the allocator ends whole, paged decode L a decode step,
   the MLP L a decode step and a single-token prefill bucket, all on
   the tensor-core kernel at 16 planes, one row block each; a profile of
   one steady decode chunk (2 L mlp_sm90_kernel and L rms_kernel
   launches a step, rounded; no other MLP kernel), decode tok/s, TTFT
   p50, device and host ms a step, the MLP's share of device time and
   the arm's part seconds; the decode step from one state with all 128
   slots live, each STEP_VARIANTS variant, in bf16 and bf16 cut to 2
   layers, held by step_gates (decode_step_wide128). Then the paged
   engine at
   32 slots (JAX's serve bench at its default batch of 16:
   EngineConfig(page_size=16, max_slots=32, max_pages_per_seq=16,
   scan_chunk=8, prefill_chunk=128)), 32 seeded requests with prompts
   of 16, 64 or 128 tokens and 16-32 new tokens: every request
   completes, the allocator ends whole, paged decode L a decode step,
   the MLP L a decode step and a single-token prefill bucket, all on the
   tensor-core kernel (4 planes), decode_mlp.cu and the halves never;
   decode tok/s, TTFT p50 and the steady step's MLP device ms and share
   (profile_decode); the decode step from one state with all 32 slots
   live, each STEP_VARIANTS variant, in bf16, fp32 and bf16 cut to 2
   layers, held by step_gates (decode_step_wide).
8d. engine_wide_w8kv8, engine_wide128_w8kv8 (on one int8 tree
   quantized once from phase 8's weights) — engine_wide's config and
   requests with weight_quant and kv_quant "int8": every request
   completes with its token count, the allocator ends whole with every
   pool (scales included) zero; a decode step (M = 32 rows) makes its
   225 int8 matmuls on the tensor-core GEMV's wgmma body at 4 planes (a
   prefill bucket's past 128 rows on the wgmma tile; int8mm.cu's GEMV
   and WMMA tile never) and 32 paged-decode launches on int8 pools; a
   profile of steady decode: 225 launches of
   int8_gemv_sm90_kernel_wgmma<4, *> a step (rounded: the trace can come
   back a few records short; the window's own launch counters are held
   to the count exactly)
   and no other int8 matmul kernel, their device ms a step and share,
   device against host ms,
   busy share; decode tok/s, TTFT p50, the phase's seconds; the decode
   step from one state with all 32 slots live, each W8_STEP_VARIANTS
   variant, in bf16 and bf16 cut to 2 layers, held by step_gates
   (decode_step_wide_w8kv8). Then engine_wide128's config and requests
   (128 slots: JAX's serve bench at --batch 64 with int8 weights) the
   same way: a decode step (M = 128 rows) makes its 225 int8 matmuls on
   the GEMV's wgmma body at 16 planes (225 launches of
   int8_gemv_sm90_kernel_wgmma<16, *> a step in the profile), the same
   gates and report, and the decode step from one state with all 128
   slots live in bf16 and bf16 cut to 2 layers under step_gates
   (decode_step_wide128_w8kv8).
8a. engine_sharded — mesh-sharded decode (tpu_dra_torch/workloads/
   parallel/mesh.py). World 1, inside a world-1 NCCL group built by
   bootstrap.rendezvous: the engine phase's requests through
   EngineConfig(sharded=True) (run in phase 6, on its weights) and the
   generate phase's bf16 call over shard_decode_params (run in phase 8):
   a (1, 1) mesh, the config kept (so the kernels), no collective, the
   kernel launches and the tokens of the unsharded runs. World 2:
   python -m tpu_dra_torch.workloads.shardbench as two ranks sharing
   the card over gloo (NCCL puts no two ranks on one GPU; gloo takes
   the CUDA tensors of the gathers and stages them through host memory),
   from config dirs rendered as the slice daemon renders them, at
   Llama-3-8B widths cut to 2 layers, fp32, weights from one seeded
   CUDA generator: the (1, 2) mesh's greedy_generate and engine (greedy
   and sampled) tokens identical to the unsharded runs of the same
   config on both ranks, else the first decode step's logits at
   cosine >= 0.9999998 (SHARDED_FP32_COSINE), recorded; the config is
   kept on a shard, so each rank runs the kernels: the paged or
   contiguous decode attention on its heads (planned as the unsharded
   heads') and the fused MLP as its two halves around the gather of
   silu(gate)·up (decode_mlp.cu's in fp32), each engine arm's launches
   at their reckoned counts (a layer of a decode step: one attention
   call, one gate/up and one down launch) and 0 plain calls of a
   kernel-capable op on the card, gathered from both ranks into the
   kernel line; each rank's heads and act columns of the kernels bit
   for bit the unsharded calls' and the down half the fused kernel's
   output (shardbench kernel_shard_check, fp32 and bf16); a bf16 engine
   arm (the tensor-core halves) whose first decode step's logits reach
   BF16_COSINE against the unsharded bf16 engine's (its tokens
   reported); the gathers a decode step, their host ms, the decode ms a
   step, the logit cosine and whether a column block of an fp32 product
   equals those columns of the full product bit for bit. In the same
   launch, live migration
   at world 2 (shardbench's ``migrate``): the first decoding sequence
   exported from the (1, 2) engine, its pools' kv-head blocks gathered
   over the model axis (2 gathers: k and v), holds each rank's pool
   pages bit for bit (and so do the pages an import into a fresh (1, 2)
   engine grafts: the round trip is lossless), is the sequence the
   unsharded engine exports at the same step (the same length, tokens
   and pages) with its K/V within shardbench's MIGRATE_FP32_REL (1e-5)
   of the largest value, and finishes token-identical to the unmigrated
   run once imported; reported: whether the extent is the unsharded
   one's bit for bit (not on the card: cuBLAS rounds a 512-column block
   of wk/wv otherwise than the 1024-column product, as
   column_slice_bit_identical shows for w_gate), the largest difference,
   the extent's MB, export and import ms.
8b. bench_serve — the port's serve and decode benches through their
   entry points. enginebench.run_serve_bench on the tiny fp32 model on
   the card (TINY_SERVE_ENV, a saturating rate), with every identity
   assert inside the helpers: the prefix fleet's shared against private
   tokens, spec against non-spec on the lookup trace. Then, at
   Llama-3-8B widths (32 layers, bf16, random weights from a seeded CUDA
   generator): decodebench.measure_step_breakdown at batch 8, context
   512, 10 reps, every part's host and device ms, the step's launches
   and busy share; and run_serve_bench SERVE_RUNS times over SERVE_ENV,
   the launch counts set to 0 before each run: every arm's requests
   complete with their token counts and its allocator ends whole
   (ArmWatch), each arm moves the launch counters ARM_LAUNCHES names
   and no flash counter, batched prefill's TTFT p50 is under serial's,
   and the shared against private and spec against non-spec token
   agreement (not asserted: in bf16 a row's product depends on the
   shape it rides in) is reported; each run's result and arms print as
   a "bench_serve_run" line, then each end-to-end key's median and
   spread (min, max) over the runs, and decode tok/s's.
9. train   — the Trainer at Llama-3-8B widths cut to 4 layers, bf16,
   remat "nothing", TrainConfig() defaults, b=2, s=2048, 5 steps on one
   seeded batch: the loss is finite and falls, and every step launches
   exactly 2L flash forwards (the remat recompute is the second), L dQ
   and L dK/dV, all on the wgmma route; step ms, trained tok/s, MFU,
   peak memory and the flash forward's, dQ's and dK/dV's device ms in a
   profiled step.
   Then one step's loss and gradients from the initial weights, kernels
   against the plain versions (attention_impl="torch"): at fp32 with 2
   layers the loss within 1e-5 relative and every gradient leaf above
   cosine 0.99999; in bf16 each leaf's gap (1 - cosine) to an fp32
   reference at most BF16_GAP_RATIO times the plain version's (gaps
   under 1e-5 count as equal).
9b. train_mixtral — the same phase (train_phase) at Mixtral-8x7B widths
   (d 4096, ffn 14336, 8 experts, top-2, 32 heads over 8 kv heads, hd
   128, vocab 32000, rope theta 1e6, capacity factor 1.25) cut to 2
   layers (AdamW state for 3.16 B parameters, ~32 GB), bf16, remat
   "nothing", b=2, s=2048, 5 steps: the same launch, loss and step
   bars, and besides: the MoE layer's device ms in the profiled step
   split into router, dispatch, experts and combine (moe_split), the
   share of top-2 routing decisions that agree between the compared
   arms, and an MFU on the active parameters
   (mixtral_active_flops_per_token).
9c. train_sharded — sharded Llama training (tpu_dra_torch/workloads/
   parallel/: the training mesh, ring and Ulysses attention) through
   python -m tpu_dra_torch.workloads.train --distributed as two gloo
   ranks sharing the card (NCCL puts no two ranks on one GPU), at
   Llama-3-8B widths cut to 2 layers, bf16, remat "nothing", b=2,
   s=2048, 2 steps, weights from the seeded CUDA generator, on
   TRAIN_SHARDED_RUNS in order: sp=2 ring, tp=2, fsdp=2 (train
   --distributed's default at world 2), then sp=2 Ulysses while the
   phase is within TRAIN_SHARDED_BUDGET_S. Before them, on the card, the
   unsharded Trainer's 2 steps on the same weights and tokens and the
   fp32 reference loss (reference attention) of step 1. Each run: every
   step's loss the same on both ranks; every step's flash launches on
   each rank (forward, dQ and dK/dV, all on the wgmma route, nothing
   else launched) equal to the count reckoned from the mesh
   (reckoned_flash_launches: at sp=2 the ring's rank 0 runs one chunk
   pair a layer, rank 1 two); step 1's loss gap to the fp32 reference
   at most BF16_GAP_RATIO times the unsharded loss's (gaps under
   TRAIN_SHARDED_GAP_FLOOR, a bf16 ulp of a mean over b·s tokens, count
   as equal); the step ms and the collectives by kind (count, host ms,
   MB, staged through pinned host memory) of each rank.
9d. train_moe_sharded — Mixtral on a training mesh (the ep axis, the
   shard-aware MoE: capacity and positions over the global sequence,
   the load-balance loss over the global batch, experts over ep and tp)
   through the same two gloo ranks (train --distributed --model
   mixtral-8x7b), Mixtral-8x7B widths, bf16, remat "nothing", b=2,
   s=2048, 2 steps, on TRAIN_MOE_RUNS in order: ep=2 at 2 layers (a rank
   holds 4 of the 8 experts: 1.755 B parameters), then sp=2 with ring
   attention at 1 layer (a rank holds all 1.711 B parameters) while the
   phase is within TRAIN_MOE_BUDGET_S. Before each run, on the card, the
   unsharded Trainer's 2 steps and the fp32 reference loss of its
   config, released before the ranks start. The bars and the report are
   train_sharded's: losses equal on both ranks, step 1's gap ratio at
   most BF16_GAP_RATIO, every step's flash launches as reckoned (at ep=2
   the unsharded count: attention is replicated over ep; at sp=2 the
   ring's); besides, each rank's peak memory.
9e. train_pipeline — the pipeline relay (tpu_dra_torch/workloads/
   parallel/pipeline.py) through python -m
   tpu_dra_torch.workloads.pipestep as two gloo ranks sharing the card,
   pp=2: Llama-3-8B widths cut to 2 layers, one a stage, bf16, b=2,
   s=2048, 2 microbatches, the weights of the seeded CUDA generator;
   each rank runs pipelined_llama_forward and its backward on the
   next-token loss TRAIN_PIPELINE_STEPS times (no optimizer, the first
   warms up), then the unpipelined forward and backward of the same
   weights. Before the launch, on the card, the
   unsharded Trainer's loss on those weights and the fp32 reference
   loss (unsharded_reference), released before the ranks start. Bars:
   the loss equal on both ranks bit for bit; its gap to the fp32
   reference at most BF16_GAP_RATIO times the unsharded gap (floor
   TRAIN_SHARDED_GAP_FLOOR); rank i's stage is layer i and every leaf of
   it has a nonzero gradient; every gradient leaf's cosine to the
   unpipelined gradient at least TRAIN_PIPELINE_COSINE on each rank,
   and the cosines of embed, final_norm and lm_head (whole on every
   rank) equal on both; every step's flash launches on each rank as
   reckoned (reckoned_pipeline_launches: 3 ticks of one layer, so 3
   forwards, 3 dQ and 3 dK/dV, all on the wgmma route, nothing else
   launched). Reported: the ppermutes' count and MB, the step ms and
   the peak memory of each rank. The phase took 23.4 s, the engine_sharded world-2 launch
   with its round trip 26.9 s (22.8 s before it; the same card).

Every phase's line carries ``at_s``, the script's seconds when it was
printed. The line before last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import collections
import contextlib
import ast
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

from tpu_dra_torch.serving.claims import ClaimStore
from tpu_dra_torch.workloads.enginebench import (
    MetricsRecorder,
    first_difference,
    token_agreement,
)

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets), keyed by a substring of the
# name nvidia-smi reports: (memory bytes/s, dense bf16 flop/s, fp32
# flop/s outside the tensor cores).
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM: "NVIDIA H100 80GB HBM3"
}
TIMING_ITERS = 60
# The engine_prefix phase's shared system prompt: 12 full pages of 16
# and 8 tokens of a frozen boundary page.
PREFIX_LEN = 200
# ~1 ms of device sleep at the H100's clocks: longer than any timed call
# takes on the host to enqueue its launches (time_ms).
HOST_SHIELD_CYCLES = 2_000_000
BF16_RTOL = 2e-2
FP32_REL = 1e-5
# Bars for the decode-step logits of the STEP_VARIANTS (step_gates).
FP32_COSINE = 0.9999
BF16_COSINE = 0.999
BF16_GAP_RATIO = 1.5
# engine_spec's 8B runs (bf16 with the n-gram draft and the greedy
# replay, w8kv8 with the n-gram draft): the engine phase's first 4
# requests, at most 16 new tokens each.
SPEC8_REQUESTS, SPEC8_NEW_TOKENS = 4, 16
# The fabric phase: the engine phase's 4 requests with the shortest
# prompts (95-153 tokens; prefill is the fleet's costly, host-bound
# part) cut to 24 new tokens, at most 2 in flight a replica; the control
# loop's poll
# interval (a busy poll would hold the interpreter from the replica
# threads); each arm's deadline; the stall watchdog's deadline at 8B
# (with two replica threads on the card a 128-token prefill step comes
# near the Router's default 5 s: PERF.md, Fabric) and at tiny fp32, and
# the stall drill's bound past it.
FABRIC_REQUESTS, FABRIC_NEW_TOKENS = 4, 24
FABRIC_INFLIGHT = 2
FABRIC_POLL_S = 0.002
FABRIC_ARM_TIMEOUT_S = 120.0
FABRIC_STALL_S, FABRIC_TINY_STALL_S = 10.0, 1.0
FABRIC_STALL_MARGIN_S = 2.0
# Llama-3-8B: 7 int8 projections per layer (q, k, v, o, gate, up,
# down) plus the lm_head.
INT8MM_PER_LAYER = 7
# Flash gradients at fp32: up to n_rep * s rows summed in another order.
FP32_GRAD_REL = 1e-4
# Train-step gradients: fp32 leaf cosine bar; bf16 gaps below this
# count as equal (it is the fp32 bar's gap).
TRAIN_FP32_COSINE = 0.99999
TRAIN_GAP_FLOOR = 1e-5
# The train phases' batch and sequence length.
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
FLASH_CASES = (
    # name, sq, skv, causal, lse cotangent, heads, kv heads
    ("s2048_causal", 2048, 2048, True, False, 32, 8),
    ("s2048_noncausal", 2048, 2048, False, False, 32, 8),
    ("s1000_causal", 1000, 1000, True, False, 32, 8),
    ("suffix_512_of_2048", 512, 2048, True, True, 32, 8),
    # The ring's chunk pairs on a tp=2 head shard (train_sharded): the
    # diagonal and a full chunk, each merged by logsumexp, so its lse
    # gets a cotangent.
    ("ring_s1024_h16_causal", 1024, 1024, True, True, 16, 4),
    ("ring_s1024_h16_full", 1024, 1024, False, True, 16, 4),
)


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - T_START,
                      **fields}), flush=True)


def bf16_row_atol(ref: torch.Tensor, atol_floor: float = 0.0):
    """Per-row atol for a bf16 result against the fp32 reference: two
    bf16 ulps of each row's own largest |reference| value (a row is the
    last axis: one head of one slot or token, one token of the MLP, one
    output row of a matmul), so a row of small values is held to its own
    scale. A row of zeros must come out exactly zero, unless the caller
    gives ``atol_floor``: the atol of a gradient row is never below it,
    since a gradient element carries the absolute error of the sums that
    produce it however small it is (dQ of the first causal rows is
    dP - delta, two sums that cancel)."""
    top = ref.float().abs().amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    atol = torch.where(top > 0, 2 * ulp, torch.zeros_like(top))
    return torch.clamp(atol, min=atol_floor)


def compare(name: str, got, ref, rtol: float = BF16_RTOL,
            atol_floor: float = 0.0) -> dict:
    """Every element within its row's atol plus rtol * |ref|."""
    got, ref = got.float(), ref.float()
    atol = bf16_row_atol(ref, atol_floor)
    err = (got - ref).abs()
    limit = atol + rtol * ref.abs()
    over = torch.where(limit > 0, err / limit,
                       torch.where(err > 0, torch.inf, 0.0))
    out = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp(min=1e-6)).max()),
        "worst_err_over_limit": float(over.max()),
        "row_atol_range": [float(atol.min()), float(atol.max())],
        "rtol": rtol,
    }
    if out["worst_err_over_limit"] > 1:
        raise AssertionError(
            f"{name}: {int((over > 1).sum())} elements outside two bf16 "
            f"ulps of their row's max |ref| plus rtol {rtol}; {out}"
        )
    return out


def compare_fp32(name: str, got, ref, rel: float = FP32_REL) -> dict:
    """fp32 kernel vs its plain version: the same arithmetic in another
    summation order, so every element within ``rel`` (FP32_REL) of the
    output's largest magnitude (a matmul over K = 14336 accumulates
    rounding error of that order relative to its outputs)."""
    err = float((got.float() - ref.float()).abs().max())
    top = max(float(ref.float().abs().max()), 1e-30)
    out = {"max_abs_err": err, "max_err_over_max_ref": err / top}
    if err > rel * top:
        raise AssertionError(f"{name} at fp32: {out} (bar {rel})")
    return out


def short_name(fn: str) -> str:
    """A demangled kernel name without namespaces and arguments."""
    for ns in ("(anonymous namespace)::", "tpu_dra::attention::",
               "tpu_dra::", "void "):
        fn = fn.replace(ns, "")
    return fn.split("(")[0]


def evict_by_writing(flush: torch.Tensor) -> None:
    """Evict the inputs from the 50 MB L2 by writing a 64 MB buffer: the
    L2 is left full of dirty lines, which a timed read then writes back
    as it evicts them."""
    flush.zero_()


def evict_by_reading(flush: torch.Tensor) -> None:
    """Evict the inputs from the 50 MB L2 by reading a 64 MB buffer: any
    dirty line is written back during the read, and the L2 is left
    holding clean lines only."""
    flush.view(torch.int64).sum()


# How time_ms clears the L2 before each timed call. Reading: on an H100
# 80GB HBM3 at 700 W, writing made the paged decode, decode MLP and
# decode GEMV rows 8.0 %, 6.7 % and 25.0 % slower, each beyond its
# spread (l2_flush_ablation.py).
L2_EVICT = evict_by_reading


def time_ms(fn, flush: torch.Tensor, shield: bool = True,
            evict=None) -> float:
    """Median device time of one call of ``fn`` between CUDA events,
    the L2 cleared before each by ``evict`` (default L2_EVICT) over the
    buffer ``flush``. With ``shield`` the stream first sleeps for
    HOST_SHIELD_CYCLES, so the host enqueues the call's launches
    (wrapper checks, allocations, ctypes) while the device is still
    busy and the interval holds device work only; without it the
    wrapper's host time falls inside the interval whenever it exceeds
    the kernel's. A call that syncs with the host
    inside (the plain paged walk reads its longest length) is host
    bound either way."""
    evict = evict or L2_EVICT
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(TIMING_ITERS):
        evict(flush)
        if shield:
            torch.cuda._sleep(HOST_SHIELD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def yardstick_ms(fn, flush) -> "float | str":
    """Time a PyTorch call kept only as a yardstick; a refusal records
    why it is absent instead of failing the run."""
    try:
        return time_ms(fn, flush)
    except RuntimeError as e:
        return f"not measured: {e}"[:200]


def peaks(name: str) -> tuple:
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks for {name!r}")


def bound(nbytes: float, flops: float, rates: tuple) -> dict:
    """The least time the card could take: bytes over the memory rate
    or operations over the bf16 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / rates[0] * 1e3, flops / rates[1] * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def paged_inputs(gen, lengths, page=16, num_pages=513, kvh=8, n_rep=4,
                 hd=128):
    b = len(lengths)
    max_pages = (num_pages - 1) // b
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(b, max_pages).to(torch.int32).contiguous()
    bf = torch.bfloat16
    q = torch.randn(b, kvh * n_rep, hd, generator=gen, device="cuda").to(bf)
    kp = torch.randn(num_pages, page, kvh, hd, generator=gen,
                     device="cuda").to(bf)
    vp = torch.randn(num_pages, page, kvh, hd, generator=gen,
                     device="cuda").to(bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def int8_pools(Q, kp, vp) -> tuple:
    """bf16 pools -> (int8 k, int8 v, {"k_scale", "v_scale"})."""
    (kq, ks), (vq, vs) = Q.quantize_kv(kp), Q.quantize_kv(vp)
    return kq, vq, {"k_scale": ks, "v_scale": vs}


def mlp_inputs(gen, b, d=4096, ffn=14336):
    bf = torch.bfloat16
    x = torch.randn(b, d, generator=gen, device="cuda").to(bf)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(bf)

    def w(*shape):
        return torch.empty(shape, dtype=bf, device="cuda").normal_(
            0.0, 0.02, generator=gen
        )

    tree = {
        "w_gate": {"kernel": w(d, ffn)},
        "w_up": {"kernel": w(d, ffn)},
        "w_down": {"kernel": w(ffn, d)},
    }
    return x, scale, tree


def mlp_weights(tree) -> tuple:
    return tuple(tree[n]["kernel"] for n in ("w_gate", "w_up", "w_down"))


def mlp_library_chain(x, scale, tree, eps=1e-5):
    """The decode MLP block as a chain of PyTorch library calls (the
    timing yardstick; the port never runs it): rms_norm, three cuBLAS
    GEMMs, silu, mul and the residual add."""
    wg, wu, wd = mlp_weights(tree)
    h = torch.nn.functional.rms_norm(x, (x.shape[-1],), scale, eps)
    return x + (torch.nn.functional.silu(h @ wg) * (h @ wu)) @ wd


def int8mm_inputs(Q, gen, m, k, n, dtype=torch.bfloat16, zero_col=None):
    """x [m, k] and one int8 weight [k, n] quantized from normal(0.02)
    (an all-zero column at ``zero_col``)."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = torch.empty(k, n, device="cuda").normal_(0.0, 0.02, generator=gen)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    q = Q.quantize_weight(w)
    del w
    return x, q["kernel_q"], q["scale"]


# The int8 matmul's parity rows (M, K, N): decode (M <= 128, the GEMV)
# and prefill (the wgmma tile in bf16) at every projection's shape, the
# tile's edge at M = 129, wq/wo (4096 x 4096, the 256-row tile at both
# prefill M) and the generate prefill's M = 2048 with the lm_head over
# every position; the GEMV at M = 2, 13 and 16 too (one plane of 8 rows
# of x, two planes, the most rows of the mma.sync body), and its wgmma
# body at M = 17, 24, 32 (4 planes), 33, 48, 64 (8 planes), 65, 96, 127,
# 128 (16 planes) at gate/up and at M = 32, 64 and 128 at every other
# decode shape (a w8 engine of 17-128 slots decoding).
INT8MM_PARITY = tuple(
    (m, k, n)
    for k, n in ((4096, 14336), (14336, 4096), (4096, 1024), (4096, 128256))
    for m in (1, 8, 1024)
) + ((17, 4096, 14336), (129, 4096, 14336), (2048, 4096, 14336),
     (1024, 4096, 4096), (2048, 4096, 4096), (2048, 4096, 128256),
     (2, 4096, 14336), (13, 4096, 14336), (16, 4096, 14336)) + tuple(
    (m, 4096, 14336) for m in (24, 32, 33, 48, 64, 65, 96, 127, 128)) + tuple(
    (m, k, n) for k, n in ((4096, 4096), (4096, 1024), (14336, 4096),
                           (4096, 128256)) for m in (32, 64, 128))
# The GEMV serves bf16 up to this many rows; the wgmma tile past it.
GEMV_SM90_MAX_ROWS = 128
# The prefill timing rows: each projection at the engine bucket's M and
# the lm_head at the generate prefill's (label, M, K, N).
INT8MM_PREFILL_TIMING = (
    ("int8mm_prefill", 1024, 4096, 14336),  # gate, up
    ("int8mm_prefill_wq", 1024, 4096, 4096),  # wq, wo
    ("int8mm_prefill_wk", 1024, 4096, 1024),  # wk, wv
    ("int8mm_prefill_down", 1024, 14336, 4096),
    ("int8mm_prefill_lm_head", 2048, 4096, 128256),
)
# The GEMV's wgmma body at a w8 engine's 17-128 decode slots: gate/up
# at M = 32, 64, 96 and 128 (the rows the prefill tile served before),
# every other decode shape at M = 32 and 128 (label, M, K, N).
INT8MM_WIDE_TIMING = (
    ("int8mm_m32", 32, 4096, 14336),  # gate, up
    ("int8mm_m64", 64, 4096, 14336),
    ("int8mm_m32_wq", 32, 4096, 4096),  # wq, wo
    ("int8mm_m32_wk", 32, 4096, 1024),  # wk, wv
    ("int8mm_m32_down", 32, 14336, 4096),
    ("int8mm_m32_lm_head", 32, 4096, 128256),
    ("int8mm_m96", 96, 4096, 14336),
    ("int8mm_m128", 128, 4096, 14336),
    ("int8mm_m128_wq", 128, 4096, 4096),
    ("int8mm_m128_wk", 128, 4096, 1024),
    ("int8mm_m128_down", 128, 14336, 4096),
    ("int8mm_m128_lm_head", 128, 4096, 128256),
)
# Kernel names of the int8 matmul, both sources.
INT8MM_KERNELS = ("int8_matmul_sm90_kernel", "int8_gemv_sm90_kernel",
                  "gemv_kernel", "finish_kernel", "mma_bf16_kernel",
                  "sgemm_kernel")


def int8mm_wmma(kernels, I8, x, w_q, w_s):
    """int8mm.cu's WMMA tile on x, w_q, w_s, launched directly (not
    counted in LAUNCHES): it served every bf16 M > 16 product before
    int8mm_sm90.cu and still serves the bf16 shapes that tile does not
    take, so parity holds it at the prefill shapes and timing sets its
    time beside the new tile's."""
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    kernels.check(kernels.function(
        "int8mm.cu", "tpu_int8_matmul", I8._INT8MM_ARGTYPES)(
        x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(), None,
        1, m, k, n, 1, 16, 1, 1, torch.cuda.current_stream().cuda_stream),
        "int8mm wmma")
    return out


def int8mm_tile(kernels, I8, x, w_q, w_s):
    """int8mm_sm90.cu's wgmma tile on x, w_q, w_s, launched directly with
    the wrapper's rows (not counted in LAUNCHES): it served bf16 at
    17-128 rows before the GEMV's wgmma body, so parity holds it at
    those rows and timing sets its time beside the GEMV's."""
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    kernels.check(kernels.function(
        "int8mm_sm90.cu", "tpu_int8_matmul_sm90", I8._INT8MM_SM90_ARGTYPES)(
        x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(), m, k,
        n, I8._sm90_rows(m, n, x.device),
        torch.cuda.current_stream().cuda_stream), "int8mm tile")
    return out


def int8mm_route_of(m: int) -> str:
    """The route every bf16 int8 matmul of the path takes at M rows."""
    return "sm90" if m > GEMV_SM90_MAX_ROWS else "gemv_sm90"


def gemv_planes_of(m: int) -> int:
    """The 8-row planes the GEMV must run M rows at: 1 and 2 on its
    mma.sync body, 4 (17-32 rows), 8 (33-64) and 16 (65-128) on its
    wgmma body."""
    return next(p for p in (1, 2, 4, 8, 16) if m <= 8 * p)


def int8mm_gemv(kernels, I8, x, w_q, w_s):
    """int8mm.cu's weight-streaming GEMV on x, w_q, w_s (M <= 16),
    launched directly with the wrapper's plan (not counted in LAUNCHES):
    it served every decode product before int8mm_gemv_sm90.cu and still
    serves fp32 and the shapes that kernel does not take, so parity holds
    it at the decode shapes and timing sets its time beside the new
    kernel's."""
    m, k = x.shape
    n = w_q.shape[1]
    rows_tile, vec, splits = I8._gemv_plan(m, k, n, w_q.data_ptr(),
                                           x.device)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    partial = (torch.empty(splits, m, n, dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    kernels.check(kernels.function(
        "int8mm.cu", "tpu_int8_matmul", I8._INT8MM_ARGTYPES)(
        x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        I8._DTYPE_CODES[x.dtype], m, k, n, rows_tile, vec, splits,
        int(k % 8 == 0 and x.data_ptr() % 16 == 0),
        torch.cuda.current_stream().cuda_stream), "int8mm gemv")
    return out


class RouteLog:
    """Records (M, route) of every int8 matmul launch while active, by
    wrapping ``int8mm._int8mm_route``, which the wrapper calls once
    before each launch."""

    def __init__(self, I8):
        self.I8, self.calls = I8, []

    def __enter__(self):
        self.orig = self.I8._int8mm_route

        def traced(x, w_q):
            route = self.orig(x, w_q)
            self.calls.append((x.shape[0], route))
            return route

        self.I8._int8mm_route = traced
        return self

    def __exit__(self, *exc):
        self.I8._int8mm_route = self.orig

    def check(self, name: str) -> dict:
        """Every launch with M > 128 took the wgmma tile and every other
        the tensor-core GEMV (all bf16 here); returns launches by route
        and every M seen."""
        wrong = [(m, r) for m, r in self.calls if r != int8mm_route_of(m)]
        if wrong:
            raise AssertionError(f"{name}: int8 matmul routes {wrong[:8]}")
        routes = {}
        for m, r in self.calls:
            routes[r] = routes.get(r, 0) + 1
        return {"launches_by_route": routes,
                "m": sorted({m for m, _ in self.calls})}


def int8mm_prefill_timing(kernels, I8, Q, gen, rates, flush) -> dict:
    """The wgmma tile at each prefill shape (INT8MM_PREFILL_TIMING):
    kernel, the WMMA tile it replaced on the same inputs, the plain
    version, a bf16 matmul on a copy dequantized ahead (the yardstick: no
    PyTorch call takes int8 weights with per-column scales), bound,
    achieved TFLOP/s and share of the bound."""
    rows = {}
    for label, m, k, n in INT8MM_PREFILL_TIMING:
        x, w_q, w_s = int8mm_inputs(Q, gen, m, k, n)
        nbytes = k * n + n * 4 + m * k * 2 + m * n * 2
        flops = 2 * m * k * n
        route = I8._int8mm_route(x, w_q)
        if route != "sm90":
            raise AssertionError(f"{label}: route {route}, want sm90")
        call = functools.partial(I8.int8_matmul, x, w_q, w_s, impl="cuda")
        w_bf = (w_q.float() * w_s).to(torch.bfloat16)
        wmma_vs_plain = compare(
            f"{label} wmma vs plain", int8mm_wmma(kernels, I8, x, w_q, w_s),
            I8.int8_matmul(x, w_q, w_s, impl="torch"))
        row = {
            "shape": f"M={m}, K={k}, N={n}, bf16 x, int8 W",
            "route": route,
            "tile_rows": I8._sm90_rows(m, n, x.device),
            "ms": time_ms(call, flush),
            "ms_with_host": time_ms(call, flush, shield=False),
            "wmma_kernel_ms": time_ms(functools.partial(
                int8mm_wmma, kernels, I8, x, w_q, w_s), flush),
            "plain_ms": time_ms(
                lambda: I8.int8_matmul(x, w_q, w_s, impl="torch"), flush),
            "library_ms": None,
            "dequantized_bf16_matmul_ms": yardstick_ms(lambda: x @ w_bf,
                                                       flush),
            **bound(nbytes, flops, rates),
        }
        row["tflops"] = flops / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["wmma_over_kernel"] = row["wmma_kernel_ms"] / row["ms"]
        row["plain_over_kernel"] = row["plain_ms"] / row["ms"]
        row["wmma_vs_plain"] = wmma_vs_plain
        rows[label] = row
        del x, w_q, w_s, w_bf
    return rows


def int8mm_wide_timing(kernels, I8, Q, gen, sms, rates, flush) -> dict:
    """The GEMV's wgmma body at a w8 engine's 17-128 decode rows
    (INT8MM_WIDE_TIMING), each row asserted to take gemv_sm90 at 4, 8 or
    16 planes: kernel (ms and ms_with_host), the plain version, the wgmma
    tile it replaced on the same inputs (sm90_tile_ms), a bf16 matmul on
    a copy dequantized ahead (the yardstick), bound, share of the bound
    and the plan."""
    rows = {}
    for label, m, k, n in INT8MM_WIDE_TIMING:
        x, w_q, w_s = int8mm_inputs(Q, gen, m, k, n)
        route = I8._int8mm_route(x, w_q)
        plan = I8.gemv_sm90_plan(m, k, n, sms)
        if route != "gemv_sm90" or plan.planes != gemv_planes_of(m):
            raise AssertionError(f"{label}: route {route}, plan {plan}, "
                                 f"want gemv_sm90 at 4, 8 or 16 planes")
        call = functools.partial(I8.int8_matmul, x, w_q, w_s, impl="cuda")
        w_bf = (w_q.float() * w_s).to(torch.bfloat16)
        row = {
            "shape": f"M={m}, K={k}, N={n}, bf16 x, int8 W",
            "route": route, "plan": plan._asdict(),
            "ms": time_ms(call, flush),
            "ms_with_host": time_ms(call, flush, shield=False),
            "sm90_tile_ms": time_ms(functools.partial(
                int8mm_tile, kernels, I8, x, w_q, w_s), flush),
            "plain_ms": time_ms(
                lambda: I8.int8_matmul(x, w_q, w_s, impl="torch"), flush),
            "library_ms": None,
            "dequantized_bf16_matmul_ms": yardstick_ms(lambda: x @ w_bf,
                                                       flush),
            **bound(k * n + n * 4 + m * k * 2 + m * n * 2, 2 * m * k * n,
                    rates),
        }
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["sm90_tile_over_kernel"] = row["sm90_tile_ms"] / row["ms"]
        if isinstance(row["dequantized_bf16_matmul_ms"], float):
            row["dequantized_over_kernel"] = (
                row["dequantized_bf16_matmul_ms"] / row["ms"])
        rows[label] = row
        del x, w_q, w_s, w_bf
    return rows


def profile_prefill(E, I8, eng, prompts) -> dict:
    """One prefill bucket of ``eng`` under torch.profiler: the prompts
    are admitted and one ``_prefill_tick`` runs alone (no decode chunk).
    Device ms by kernel, the int8 matmul's share, the device busy share
    of the host window, and the bucket's M; the engine then finishes the
    requests."""
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        eng.add_request(E.Request(rid=f"pre{i}", prompt=p, max_new_tokens=4))
    now = eng.clock()
    eng._admit(now)
    torch.cuda.synchronize()
    with RouteLog(I8) as log, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._prefill_tick(now)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    kernels_ = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels_.append((ev.self_device_time_total, ev.count, ev.key))
    if not kernels_:
        return {"device_busy_share": "not measured",
                "reason": "profiler recorded no device time"}
    kernels_.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels_) / 1e3
    int8mm = [(us, n, key) for us, n, key in kernels_
              if any(name in key for name in INT8MM_KERNELS)]
    int8mm_ms = sum(k[0] for k in int8mm) / 1e3
    return {
        "bucket_m": sorted({m for m, _ in log.calls}),
        "routes": log.check("prefill bucket")["launches_by_route"],
        "window_ms": window_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "kernel_launches": sum(k[1] for k in kernels_),
        "int8mm_device_ms": int8mm_ms,
        "int8mm_share_of_device_time": int8mm_ms / device_ms,
        "int8mm_kernels": [
            {"name": short_name(key)[:60], "device_ms": us / 1e3, "count": n}
            for us, n, key in int8mm],
        "top_kernels": [{"name": key[:90], "device_ms": us / 1e3, "count": n}
                        for us, n, key in kernels_[:12]],
    }


def contiguous_inputs(Q, gen, b=8, max_seq=1024, kvh=8, n_rep=4, hd=128,
                      dtype=torch.bfloat16, int8=False):
    q = torch.randn(b, kvh * n_rep, hd, generator=gen, device="cuda")
    k = torch.randn(b, max_seq, kvh, hd, generator=gen, device="cuda")
    v = torch.randn(b, max_seq, kvh, hd, generator=gen, device="cuda")
    if int8:
        (k, ks), (v, vs) = Q.quantize_kv(k), Q.quantize_kv(v)
        return q.to(dtype), k, v, {"k_scale": ks, "v_scale": vs}
    return q.to(dtype), k.to(dtype), v.to(dtype), {}


# The decode step is run once per variant: (paged_decode_impl,
# decode_mlp_impl, int8 matmul impl), "auto" being the kernel on the
# card. STEP_VARIANTS serve plain weights (the int8 impl is unused);
# W8_STEP_VARIANTS serve int8 weights, whose MLP is the plain chain of
# int8 matmuls under every decode_mlp impl but "reference".
STEP_VARIANTS = {
    "kernels": ("auto", "auto", "auto"),
    "torch": ("torch", "torch", "torch"),
    "reference": ("reference", "reference", "reference"),
    "attn_kernel": ("auto", "torch", "torch"),
    "mlp_kernel": ("torch", "auto", "torch"),
}
W8_STEP_VARIANTS = {
    "kernels": ("auto", "auto", "auto"),
    "torch": ("torch", "torch", "torch"),
    "reference": ("reference", "reference", "reference"),
    "attn_kernel": ("auto", "torch", "torch"),
    "int8mm_kernel": ("torch", "torch", "auto"),
}


def step_logits(E, I8, cfg, eng, prompts, variants,
                new_tokens: int = 64) -> dict:
    """Admit ``prompts`` into ``eng`` (``new_tokens`` each) and step until
    every slot decodes, then run one ``_decode_step`` from that state
    once per variant and compare the logits row by row (cosine, worst
    row): each variant against "torch", and "torch" against "reference".
    The engine then finishes its requests."""
    for i, p in enumerate(prompts):
        eng.add_request(E.Request(rid=f"cos{i}", prompt=p,
                                  max_new_tokens=new_tokens))
    while eng._prefilling or eng._queue:
        eng.step()
    if not eng._active.all():
        raise AssertionError(
            f"compared step needs every slot live: {eng._active.tolist()}")
    # The page for position `lengths` must exist, as _decode_tick makes
    # sure before every chunk: an unmapped table entry is the scratch
    # page, where the inactive slots' writes land too.
    for slot, seq in enumerate(eng._slots):
        eng._ensure_pages(seq, int(eng._lengths[slot]) + 1)
    state = [torch.tensor(a, device=eng.device) for a in (
        eng._tables, eng._lengths, eng._last_tokens, eng._active)]
    lengths = eng._lengths.tolist()
    logits = {}
    try:
        for name, (paged, mlp, mm) in variants.items():
            c = dataclasses.replace(
                cfg, paged_decode_impl=paged, decode_mlp_impl=mlp)
            I8.MM_IMPL = mm
            logits[name] = E._decode_step(c, eng.params, eng.cache, *state)[2]
    finally:
        I8.MM_IMPL = "auto"
    eng.run()

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(
            logits[a], logits[b], dim=-1).min().item()

    pairs = [("kernels", "torch"), ("kernels", "reference"),
             ("torch", "reference")] + [
        (v, "torch") for v in variants
        if v not in ("kernels", "torch", "reference")]
    return {
        "rows": len(lengths),
        "lengths": lengths,
        "cosine_min": {f"{a}_vs_{b}": cosine(a, b) for a, b in pairs},
        "argmax": {k: v.argmax(-1).tolist() for k, v in logits.items()},
        "finite": all(bool(torch.isfinite(v).all()) for v in logits.values()),
    }


def step_gates(steps_cmp: dict) -> dict:
    """Hold the compared decode steps to their bars; raise on a miss.

    fp32, 32 layers: every pair above FP32_COSINE. bf16, 2 layers:
    every pair above BF16_COSINE. bf16, 32 layers: 32 random layers
    amplify any difference in rounding into a logits gap of ~1e-3
    (1 - cosine), the two plain versions included, so the bar there is
    relative: every pair with a kernel at most BF16_GAP_RATIO times the
    gap between the plain version and the fp32 reference (PERF.md,
    parity contract). The bf16 step is always held; the fp32 and 2-layer
    arms wherever the caller ran them (engine_wide_w8kv8 runs no fp32
    arm)."""
    gates = {}
    for name, bar in (("fp32", FP32_COSINE), ("bf16_2_layers", BF16_COSINE)):
        if name not in steps_cmp:
            continue
        worst = min(steps_cmp[name]["cosine_min"].values())
        gates[name] = {"worst_cosine": worst, "bar": bar}
        if not (steps_cmp[name]["finite"] and worst > bar):
            raise AssertionError(f"{name} decode-step logits: {gates}")
    cos = steps_cmp["bf16"]["cosine_min"]
    plain_gap = 1 - cos["torch_vs_reference"]
    ratios = {k: (1 - v) / max(plain_gap, 1e-9)
              for k, v in cos.items() if k != "torch_vs_reference"}
    gates["bf16"] = {
        "gap_over_plain_gap": ratios, "bar": BF16_GAP_RATIO,
        "kernels_vs_torch_above_0.999": cos["kernels_vs_torch"] > BF16_COSINE,
    }
    if not (steps_cmp["bf16"]["finite"]
            and max(ratios.values()) <= BF16_GAP_RATIO):
        raise AssertionError(f"bf16 decode-step logits: {gates}")
    return gates


def profile_decode(E, eng, prompts, chunks: int = 2,
                   new_tokens: int = 40) -> dict:
    """Trace ``chunks`` steady decode chunks with torch.profiler once
    every slot is decoding (``prompts`` admitted, ``new_tokens`` each):
    device busy share of the host window, CUDA kernel launches per
    decode step, and the kernels with the most device time. Reports
    "not measured" where the profiler records no device time. Always
    reports the window's decode steps and its own launch counters
    (``launches``: set to 0 just before the window, read just after),
    which hold_window_launches holds exactly."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_dra_torch import kernels

    for i, p in enumerate(prompts):
        eng.add_request(E.Request(rid=f"prof{i}", prompt=p,
                                  max_new_tokens=new_tokens))
    while eng._prefilling or eng._queue:
        eng.step()
    steps0 = eng.decode_steps
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES)
    steps = eng.decode_steps - steps0
    eng.run()
    kernels_ = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.key and not ev.key.startswith(("cuda", "aten")):
            kernels_.append((dev_us, ev.count, ev.key))
    device_ms = sum(k[0] for k in kernels_) / 1e3
    if not kernels_:
        return {"device_busy_share": "not measured",
                "reason": "profiler recorded no device time",
                "decode_steps": steps, "launches": launches}
    kernels_.sort(reverse=True)
    attention = {
        name: {
            "device_ms_per_step": sum(
                us for us, _, key in kernels_ if name in key) / 1e3 / steps,
            "launches_per_step": sum(
                n for _, n, key in kernels_ if name in key) / steps,
        }
        for name in DECODE_BODY_KERNELS
    }
    int8mm = [(us, n, key) for us, n, key in kernels_
              if any(name in key for name in INT8MM_KERNELS)]
    mlp = [(us, n, key) for us, n, key in kernels_
           if any(name in key for name in MLP_KERNELS)]
    mlp_ms = sum(k[0] for k in mlp) / 1e3 / steps
    return {
        "decode_attention_kernels": attention,
        "int8mm_kernels": {
            short_name(key)[:60]: {"device_ms_per_step": us / 1e3 / steps,
                                   "launches_per_step": n / steps}
            for us, n, key in int8mm},
        "int8mm_device_ms_per_step": sum(k[0] for k in int8mm) / 1e3 / steps,
        "int8mm_launches_per_step": sum(k[1] for k in int8mm) / steps,
        "mlp_kernels": {
            short_name(key)[:60]: {"device_ms_per_step": us / 1e3 / steps,
                                   "launches_per_step": n / steps}
            for us, n, key in mlp},
        "mlp_device_ms_per_step": mlp_ms,
        "mlp_launches_per_step": sum(k[1] for k in mlp) / steps,
        "device_ms_per_step": device_ms / steps,
        "mlp_share_of_device_time": mlp_ms / (device_ms / steps),
        "decode_steps": steps,
        "launches": launches,
        "window_ms": window_ms,
        "step_ms": window_ms / steps,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "kernel_launches_per_step": sum(k[1] for k in kernels_) / steps,
        "top_kernels": [
            {"name": name[:90], "device_ms": us / 1e3, "count": n}
            for us, n, name in kernels_[:10]
        ],
    }


def hold_window_launches(label, profile, per_step: dict) -> None:
    """The profiled window's own launch counters (profile_decode's
    ``launches``) must be ``per_step`` (counter: launches a decode step)
    times its decode steps, exactly. The trace's count a step is held
    rounded beside it, since a trace can come back a few records short
    (3 of 1,792 for one kernel on an H100 80GB HBM3 at 700 W)."""
    steps = profile["decode_steps"]
    got = {k: profile["launches"][k] for k in per_step}
    if steps <= 0 or got != {k: v * steps for k, v in per_step.items()}:
        raise AssertionError(
            f"{label}: the profiled window's launches {got} over {steps} "
            f"decode steps, want {per_step} a step")


def serve(E, kernels, cfg, params, ec, reqs, **engine_kw) -> tuple:
    """Run ``reqs`` through a fresh engine (``engine_kw`` go to its
    constructor) with the launch counts set to 0 just before; returns
    (engine, completions, launches, wall s). Every request must complete
    with its token count and ids in range, and the allocator must end
    leak-free."""
    eng = E.Engine(cfg, params, ec, **engine_kw)
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for r in reqs:
        n = len(done[r.rid].tokens)
        if n != r.max_new_tokens:
            raise AssertionError(f"{r.rid}: {n} tokens, want {r.max_new_tokens}")
        if not (0 <= done[r.rid].tokens.min()
                and done[r.rid].tokens.max() < cfg.vocab_size):
            raise AssertionError(f"{r.rid}: token ids out of range")
    alloc = eng.allocator
    if alloc.free_pages != alloc.num_pages - 1 or alloc.reserved_pages:
        raise AssertionError(
            f"allocator leaked: {alloc.free_pages} free of "
            f"{alloc.num_pages - 1}, {alloc.reserved_pages} reserved"
        )
    return eng, done, launches, wall


def serve_summary(eng, done, launches, wall) -> dict:
    decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
    ttft = sorted(c.ttft_s for c in done.values())
    steps = eng.decode_steps
    return {
        "requests": len(done), "wall_seconds": wall, "decode_steps": steps,
        "decode_seconds": eng.decode_seconds, "decode_tokens": decode_tokens,
        "decode_tok_s": decode_tokens / eng.decode_seconds,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "prefill_buckets": eng.prefill_buckets, "launches": launches,
    }


# engine_wide: JAX's serve bench at its default batch of 16 makes an
# engine of 2 x 16 = 32 slots (tpu_dra/workloads/enginebench.py
# equal_memory_engine_config); WIDE_REQUESTS requests, prompts of
# WIDE_PROMPTS tokens, 16-32 new tokens each. generate_wide: a fixed
# batch past the 64 rows of one launch.
WIDE_SLOTS = 32
WIDE_REQUESTS = 32
WIDE_PROMPTS = (16, 64, 128)
WIDE_GEN = (128, 32, 4)  # batch, prompt, new tokens


def wide_requests(E, cfg) -> list:
    """engine_wide's WIDE_REQUESTS seeded requests: prompts of
    WIDE_PROMPTS tokens, 16-32 new tokens each."""
    rng = np.random.default_rng(25)
    return [
        E.Request(
            rid=f"w{i}",
            prompt=rng.integers(1, cfg.vocab_size, int(rng.choice(
                WIDE_PROMPTS))).astype(np.int32),
            max_new_tokens=int(rng.integers(16, 33)),
        )
        for i in range(WIDE_REQUESTS)
    ]


def engine_wide(E, I8, kernels, cfg, params) -> tuple:
    """The engine at WIDE_SLOTS slots (bf16, the decode MLP at 17-64
    rows on the tensor-core kernel's 4 planes): every request completes
    with its token count, the allocator ends whole; a decode step's
    paged attention L launches and its MLP L launches of the tensor-core
    kernel (every prefill bucket of single-token rows too), decode_mlp.cu
    and the halves none; a profile of steady decode (two launches of
    mlp_sm90_kernel and one of its rms_kernel a layer, nothing else of
    the MLP); then the decode
    step from one state with every slot live, once per STEP_VARIANTS.
    Returns (report, launches, bf16 step comparison, config, the
    prompts the step comparison admitted)."""
    L = cfg.n_layers
    ec = E.EngineConfig(page_size=16, max_slots=WIDE_SLOTS,
                        max_pages_per_seq=16, scan_chunk=8,
                        prefill_chunk=128)
    reqs = wide_requests(E, cfg)
    eng, done, launches, wall = serve(E, kernels, cfg, params, ec, reqs)
    steps = eng.decode_steps
    want_mlp = L * (steps + eng.prefill_single_token_buckets)
    simt = {k: launches[k] for k in ("decode_mlp_gate_up", "decode_mlp_down",
                                     "decode_mlp_sm90_gate_up",
                                     "decode_mlp_sm90_down")}
    if not (launches["paged_decode_attention"] == L * steps > 0
            and launches["decode_mlp"] == launches["decode_mlp_sm90"]
            == want_mlp > 0 and not any(simt.values())):
        raise AssertionError(
            f"engine_wide: launches {launches}, want {L * steps} paged "
            f"decode and {want_mlp} tensor-core MLP launches, no other")
    summary = serve_summary(eng, done, launches, wall)
    profile = profile_decode(E, eng, [np.resize(r.prompt, 128)
                                      for r in reqs])
    hold_window_launches("engine_wide profile", profile,
                         {"decode_mlp": L, "decode_mlp_sm90": L})
    if "mlp_kernels" in profile:
        per_step = {k: v["launches_per_step"]
                    for k, v in profile["mlp_kernels"].items()}
        sm90 = sum(v for k, v in per_step.items() if MLP_SM90_KERNEL in k)
        rms = sum(v for k, v in per_step.items() if MLP_RMS_KERNEL in k)
        if (round(sm90) != 2 * L or round(rms) != L
                or abs(profile["mlp_launches_per_step"] - sm90 - rms) > 1e-6):
            raise AssertionError(
                f"engine_wide profile: decode MLP kernels a step "
                f"{per_step}, want {2 * L} {MLP_SM90_KERNEL} and {L} "
                f"{MLP_RMS_KERNEL} launches")
    prompts = [r.prompt for r in reqs]
    step = step_logits(E, I8, cfg, eng, prompts, STEP_VARIANTS)
    report = {
        "slots": WIDE_SLOTS, **summary,
        "launches_per_decode_step": {
            k: launches[k] / steps for k in (
                "paged_decode_attention", "decode_mlp", "decode_mlp_sm90")},
        "profile": {k: profile.get(k) for k in (
            "mlp_device_ms_per_step", "mlp_share_of_device_time",
            "mlp_kernels", "device_ms_per_step", "step_ms",
            "device_busy_share", "kernel_launches_per_step",
            "decode_steps", "top_kernels", "reason")},
    }
    return report, launches, step, ec, prompts


def engine_wide_w8kv8(E, I8, kernels, cfg, qparams, ec, reqs,
                      label: str = "engine_wide_w8kv8") -> tuple:
    """A wide engine's config (``ec``: engine_wide's 32 slots or
    engine_wide128's 128) and requests (``reqs``) with int8 weights and
    KV, on an int8 tree quantized ahead (``qparams``): every request
    completes with its token count, the allocator ends whole with every
    pool (scales included) zero; a decode step (M = max_slots rows) makes
    its 7 L + 1 int8 matmuls on the GEMV's wgmma body (4 planes at 32
    slots, 16 at 128), none on the wgmma tile, int8mm.cu's GEMV or the
    WMMA tile (every launch with M > 128, a prefill bucket's, on the
    tile), and L paged-decode launches on the int8 pools; a profile of
    steady decode (7 L + 1 launches of int8_gemv_sm90_kernel_wgmma<planes,
    *> a step, rounded, the window's launch counters exactly, and no
    other int8 matmul kernel; its device ms
    and share); then the decode step from one state with every slot
    live, once per W8_STEP_VARIANTS. Returns (report, launches, bf16
    step comparison)."""
    L = cfg.n_layers
    slots = ec.max_slots
    w8 = dataclasses.replace(ec, weight_quant="int8", kv_quant="int8")
    with RouteLog(I8) as log:
        eng, done, launches, wall = serve(E, kernels, cfg, qparams, w8, reqs)
    steps = eng.decode_steps
    mm_per_pass = INT8MM_PER_LAYER * L + 1
    routes = log.check(label)
    decode_calls = sum(1 for m, _ in log.calls if m == slots)
    planes = gemv_planes_of(slots)
    if not (launches["int8mm"] == mm_per_pass * (steps + eng.prefill_buckets)
            and launches["int8mm_gemv_sm90"]
            == routes["launches_by_route"].get("gemv_sm90", 0)
            and launches["int8mm_sm90"]
            == routes["launches_by_route"].get("sm90", 0)
            and launches["int8mm_sm90"] + launches["int8mm_gemv_sm90"]
            == launches["int8mm"]
            and launches["int8mm_gemv"] == 0
            and decode_calls >= mm_per_pass * steps > 0
            and planes == {WIDE_SLOTS: 4, WIDE128_SLOTS: 16}[slots]
            and launches["paged_decode_attention_int8"] == L * steps
            and launches["paged_decode_attention"] == 0
            and launches["decode_mlp"] == 0):
        raise AssertionError(
            f"{label}: launches {launches}, routes {routes}: want "
            f"{mm_per_pass} int8 matmuls a forward pass ({steps} decode "
            f"steps at M = {slots}, {eng.prefill_buckets} prefill "
            f"buckets) on gemv_sm90 ({planes} planes) up to "
            f"{GEMV_SM90_MAX_ROWS} rows and sm90 past them, {L} int8 paged "
            f"launches a step")
    pools_zero = all(bool((layer[1:] == 0).all())
                     for _, pool in eng.cache._pools() for layer in pool)
    if not (eng.cache.quantized and pools_zero):
        raise AssertionError(f"{label}: freed pages (values, scales) not "
                             f"zero")
    summary = serve_summary(eng, done, launches, wall)
    parts = {"serve": wall}
    # The profile and the step check run what they need: one profiled
    # chunk (a trace of two took most of the phase's seconds:
    # part_seconds), every slot decoding through it and through the
    # compared step.
    t = time.perf_counter()
    profile = profile_decode(E, eng, [np.resize(r.prompt, 128)
                                      for r in reqs], chunks=1,
                             new_tokens=3 * w8.scan_chunk)
    parts["profile"] = time.perf_counter() - t
    hold_window_launches(f"{label} profile", profile,
                         {"int8mm": mm_per_pass,
                          "int8mm_gemv_sm90": mm_per_pass})
    if "int8mm_kernels" in profile:
        per_step = {k: v["launches_per_step"]
                    for k, v in profile["int8mm_kernels"].items()}
        body = sum(v for k, v in per_step.items()
                   if f"{GEMV_SM90_WGMMA_KERNEL}<{planes}" in k)
        if (round(body) != mm_per_pass
                or abs(profile["int8mm_launches_per_step"] - body) > 1e-6):
            raise AssertionError(
                f"{label} profile: int8 matmul kernels a step "
                f"{per_step}, want {mm_per_pass} of "
                f"{GEMV_SM90_WGMMA_KERNEL}<{planes}, *> and nothing else")
    t = time.perf_counter()
    step = step_logits(E, I8, cfg, eng, [r.prompt for r in reqs],
                       W8_STEP_VARIANTS, new_tokens=2 * w8.scan_chunk + 2)
    parts["step_check"] = time.perf_counter() - t
    report = {
        "slots": slots, **summary, "int8mm_routes": routes,
        "gemv_planes": planes, "part_seconds": parts,
        "launches_per_decode_step": {
            "int8mm_decode_calls": decode_calls / steps,
            "paged_decode_attention_int8":
                launches["paged_decode_attention_int8"] / steps},
        "profile": {k: profile.get(k) for k in (
            "int8mm_device_ms_per_step", "int8mm_launches_per_step",
            "int8mm_kernels", "device_ms_per_step", "step_ms", "window_ms",
            "device_busy_share", "kernel_launches_per_step",
            "decode_steps", "top_kernels", "reason")},
    }
    if isinstance(profile.get("device_ms_per_step"), float):
        report["profile"]["int8mm_share_of_device_time"] = (
            profile["int8mm_device_ms_per_step"]
            / profile["device_ms_per_step"])
    return report, launches, step


# engine_wide128: JAX's serve bench at --batch 64 makes an engine of
# 2 x 64 = 128 slots (tpu_dra/workloads/enginebench.py
# equal_memory_engine_config, slots_factor 2): its decode MLP takes 128
# rows, one launch of the tensor-core kernel at 16 planes a layer.
WIDE128_SLOTS = 128
WIDE128_PROMPTS = (16, 64)
WIDE128_NEW_TOKENS = 16


def wide128_requests(E, cfg) -> list:
    """engine_wide128's WIDE128_SLOTS seeded requests: prompts of
    WIDE128_PROMPTS tokens, WIDE128_NEW_TOKENS new tokens each."""
    rng = np.random.default_rng(28)
    return [
        E.Request(
            rid=f"v{i}",
            prompt=rng.integers(1, cfg.vocab_size, int(rng.choice(
                WIDE128_PROMPTS))).astype(np.int32),
            max_new_tokens=WIDE128_NEW_TOKENS,
        )
        for i in range(WIDE128_SLOTS)
    ]


def engine_wide128(E, I8, DM, kernels, cfg, params) -> tuple:
    """The bf16 engine at WIDE128_SLOTS slots (the decode MLP at 128
    rows: one launch of the tensor-core kernel at 16 planes a layer):
    every request completes with its token count, the allocator ends
    whole; a decode step's paged attention L launches and its MLP L
    calls of the tensor-core kernel, one row block each (every prefill
    bucket of single-token rows too), decode_mlp.cu and the halves none;
    a profile of one steady decode chunk (two launches of
    mlp_sm90_kernel and one of its rms_kernel a layer a step, rounded:
    the window's own counters hold the exact count; nothing else of the
    MLP); then
    the decode step from one state with every slot live, once per
    STEP_VARIANTS. Returns (report, launches, bf16 step comparison,
    config, the prompts the step comparison admitted)."""
    L = cfg.n_layers
    ec = E.EngineConfig(page_size=16, max_slots=WIDE128_SLOTS,
                        max_pages_per_seq=16, scan_chunk=8,
                        prefill_chunk=128)
    if (len(DM.row_blocks(WIDE128_SLOTS, "sm90")) != 1
            or DM.planes_of(WIDE128_SLOTS) != 16):
        raise AssertionError("engine_wide128: 128 rows must be one row "
                             "block of 16 planes")
    reqs = wide128_requests(E, cfg)
    parts = {}
    t = time.perf_counter()
    eng, done, launches, wall = serve(E, kernels, cfg, params, ec, reqs)
    parts["serve"] = time.perf_counter() - t
    steps = eng.decode_steps
    want_mlp = L * (steps + eng.prefill_single_token_buckets)
    other = {k: launches[k] for k in ("decode_mlp_gate_up", "decode_mlp_down",
                                      "decode_mlp_sm90_gate_up",
                                      "decode_mlp_sm90_down")}
    if not (launches["paged_decode_attention"] == L * steps > 0
            and launches["decode_mlp"] == launches["decode_mlp_sm90"]
            == want_mlp > 0 and not any(other.values())):
        raise AssertionError(
            f"engine_wide128: launches {launches}, want {L * steps} paged "
            f"decode and {want_mlp} tensor-core MLP launches, no other")
    summary = serve_summary(eng, done, launches, wall)
    prompts = [r.prompt for r in reqs]
    t = time.perf_counter()
    profile = profile_decode(E, eng, prompts, chunks=1,
                             new_tokens=3 * ec.scan_chunk)
    parts["profile"] = time.perf_counter() - t
    hold_window_launches("engine_wide128 profile", profile,
                         {"decode_mlp": L, "decode_mlp_sm90": L})
    if "mlp_kernels" in profile:
        per_step = {k: v["launches_per_step"]
                    for k, v in profile["mlp_kernels"].items()}
        sm90 = sum(v for k, v in per_step.items() if MLP_SM90_KERNEL in k)
        rms = sum(v for k, v in per_step.items() if MLP_RMS_KERNEL in k)
        if (round(sm90) != 2 * L or round(rms) != L
                or abs(profile["mlp_launches_per_step"] - sm90 - rms) > 1e-6):
            raise AssertionError(
                f"engine_wide128 profile: decode MLP kernels a step "
                f"{per_step}, want {2 * L} {MLP_SM90_KERNEL} and {L} "
                f"{MLP_RMS_KERNEL} launches and nothing else")
    t = time.perf_counter()
    step = step_logits(E, I8, cfg, eng, prompts, STEP_VARIANTS,
                       new_tokens=2 * ec.scan_chunk + 2)
    parts["step_check"] = time.perf_counter() - t
    report = {
        "slots": WIDE128_SLOTS, **summary, "part_seconds": parts,
        "launches_per_decode_step": {
            k: launches[k] / steps for k in (
                "paged_decode_attention", "decode_mlp", "decode_mlp_sm90")},
        "profile": {k: profile.get(k) for k in (
            "mlp_device_ms_per_step", "mlp_share_of_device_time",
            "mlp_kernels", "device_ms_per_step", "step_ms", "window_ms",
            "device_busy_share", "kernel_launches_per_step",
            "decode_steps", "top_kernels", "reason")},
    }
    return report, launches, step, ec, prompts


def generate_wide(G, DM, kernels, cfg, params) -> tuple:
    """greedy_generate at WIDE_GEN (b = 128, bf16): it runs, its output
    has the prompt and ids in range, every decode step launches the
    decode attention L times and the tensor-core MLP L times a row block
    of its route (one block of 128 rows at 16 planes: L a step); token
    agreement with the plain bf16 run (the plain attention and MLP) is
    reported, not gated. Returns (report, launches)."""
    b, s, new = WIDE_GEN
    L = cfg.n_layers
    prompt = torch.from_numpy(
        np.random.default_rng(25).integers(1, cfg.vocab_size, (b, s))
        .astype(np.int32))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.greedy_generate(cfg, params, prompt, new)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = new - 1
    blocks = len(DM.row_blocks(b, "sm90"))
    if blocks != 1 or DM.planes_of(b) != 16:
        raise AssertionError(f"generate_wide: b = {b} in {blocks} row "
                             f"blocks, want one of 16 planes")
    want = {"decode_attention": L * steps,
            "decode_mlp": L * blocks * steps,
            "decode_mlp_sm90": L * blocks * steps}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"generate_wide: launches {launches}, want "
                             f"{want}")
    if not (out.shape == (b, s + new) and torch.equal(out[:, :s], prompt)
            and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size):
        raise AssertionError(f"generate_wide: bad output {out.shape}")
    plain = G.greedy_generate(dataclasses.replace(
        cfg, decode_impl="torch", decode_mlp_impl="torch"), params, prompt,
        new)
    return {
        "batch": b, "prompt": s, "new_tokens": new, "wall_seconds": wall,
        "launches": launches,
        "launches_per_decode_step": {k: v / steps for k, v in want.items()},
        "row_blocks": blocks, "planes": DM.planes_of(b),
        "token_agreement_with_plain": float(
            (out[:, s:] == plain[:, s:]).float().mean()),
    }, launches


# The decode attention body (csrc/decode_attention.cuh): the kernels of
# its two launches, and the sources that instantiate it.
DECODE_BODY_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
DECODE_BODY_SOURCES = ("paged_decode.cu", "decode.cu")


def decode_body_build(kernels, report) -> dict:
    """Registers and spill bytes of every instantiation of the decode
    body; raises unless each one spills nothing."""
    out = {}
    for source in DECODE_BODY_SOURCES:
        out[source] = {
            short_name(fn): {"registers": p["registers"],
                             "spill_store_bytes": p["spill_stores"]}
            for fn, p in kernels.ptxas_report(report[source]["log"]).items()
        }
        names = " ".join(out[source])
        if not all(k in names for k in DECODE_BODY_KERNELS):
            raise AssertionError(f"{source}: no ptxas report for the decode "
                                 f"body: {sorted(out[source])}")
        spills = {k: v for k, v in out[source].items()
                  if v["spill_store_bytes"]}
        if spills:
            raise AssertionError(f"{source}: instantiations spill: {spills}")
    return out


def plan_of(A, b: int, kvh: int, key_range: int, live: list,
            n_rep: int = 1) -> dict:
    """The decode kernels' split plan for a call, with the CTAs it
    launches (a kv head's row groups each take a CTA a split) and those
    whose range starts below their row's length."""
    rows, groups = A.decode_groups(n_rep)
    splits, chunk = A.split_plan(
        b, kvh * groups, key_range, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    return {"splits": splits, "chunk": chunk, "rows": rows,
            "groups": groups, "ctas": splits * kvh * groups * b,
            "live_ctas": kvh * groups * sum(min(-(-n // chunk), splits)
                                            for n in live),
            "combine": splits > 1}


def body_profile(call, flush, reps: int = 20) -> dict:
    """Device µs of each decode-body kernel (split, combine) a call
    takes, from torch.profiler over ``reps`` calls with the L2 flushed
    before each, and its CUDA launches a call."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            L2_EVICT(flush)
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        for name in DECODE_BODY_KERNELS:
            if name in ev.key and dev_us > 0:
                out[f"{name}_us"] = dev_us / ev.count
                out[f"{name}_launches_per_call"] = ev.count / reps
    return out or {"profile": "not measured: no device time recorded"}


def share(ms: float, nbytes: float, rates: tuple) -> dict:
    """A bytes-bound kernel's achieved rate and share of its bound."""
    return {"tb_per_s": nbytes / ms / 1e9,
            "share_of_bound": nbytes / rates[0] * 1e3 / ms}


def paged_timing(A, q, k_, v_, sc, tables, lens, lengths, rates,
                 flush) -> dict:
    """One paged-decode timing row. Yardstick only (not the same
    inputs): SDPA over the same live K/V already gathered into
    contiguous [B, kvh, L, hd] bf16 buffers (dequantized for int8
    pools); every slot holds the same length L."""
    b, h, hd = q.shape
    kvh, page = k_.shape[2], k_.shape[1]
    live = sum(lengths)
    pages_read = sum(-(-n // page) for n in lengths)
    kv_bytes = 1 if sc else 2
    nbytes = (2 * q.numel() * 2 + live * kvh * hd * kv_bytes * 2
              + (live * kvh * 4 * 2 if sc else 0)
              + pages_read * 4 + b * 4)
    args = (q, k_, v_, tables, lens)
    call = functools.partial(A.paged_decode_attention, *args, **sc,
                             impl="cuda")
    ms = time_ms(call, flush)
    host_ms = time_ms(call, flush, shield=False)
    plain_ms = time_ms(lambda: A.paged_decode_attention(
        *args, **sc, impl="torch"), flush)
    n = lengths[0]
    kd = k_.float() * sc["k_scale"][..., None] if sc else k_
    vd = v_.float() * sc["v_scale"][..., None] if sc else v_
    kc = A._gather_flat(kd.to(torch.bfloat16), tables)[:, :n].permute(
        0, 2, 1, 3).contiguous()
    vc = A._gather_flat(vd.to(torch.bfloat16), tables)[:, :n].permute(
        0, 2, 1, 3).contiguous()
    del kd, vd
    sdpa_ms = yardstick_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True), flush)
    return {
        "shape": f"B={b} x {n} tokens, page {page}, {tables.shape[1]} "
                 f"pages a slot, h={h} kvh={kvh} hd={hd}, bf16 q, "
                 f"{'int8' if sc else 'bf16'} pools",
        "split_plan": plan_of(A, b, kvh, tables.shape[1] * page, lengths,
                              h // kvh),
        "ms": ms, "ms_with_host": host_ms, "plain_ms": plain_ms,
        "library_ms": None, "sdpa_contiguous_ms": sdpa_ms,
        **bound(nbytes, 4 * live * h * hd, rates),
        **share(ms, nbytes, rates),
        "kernels": body_profile(call, flush),
    }


def contiguous_timing(A, q, k_, v_, sc, L, rates, flush) -> dict:
    """One contiguous-decode timing row at length L, with SDPA over the
    live keys as its library call (bf16), or over them dequantized to
    bf16 ahead as a yardstick (int8: no PyTorch call takes the cache)."""
    b, h, hd = q.shape
    kvh, max_seq = k_.shape[2], k_.shape[1]
    int8 = bool(sc)
    nbytes = (2 * q.numel() * 2 + b * L * kvh * hd * (1 if int8 else 2)
              * 2 + (b * L * kvh * 4 * 2 if int8 else 0))
    call = functools.partial(
        A.decode_attention, q, k_, v_, L, **sc, impl="cuda")
    ms = time_ms(call, flush)
    host_ms = time_ms(call, flush, shield=False)
    plain_ms = time_ms(lambda: A.decode_attention(q, k_, v_, L, **sc,
                                                  impl="torch"), flush)
    row = {
        "shape": f"b={b}, length {L} of max_seq {max_seq}, h={h} kvh={kvh} "
                 f"hd={hd}, bf16 q, {'int8' if int8 else 'bf16'} cache",
        "split_plan": plan_of(A, b, kvh, L, [L] * b, h // kvh),
        "ms": ms, "ms_with_host": host_ms, "plain_ms": plain_ms,
        "library_ms": None,
        **bound(nbytes, 4 * b * L * h * hd, rates),
        **share(ms, nbytes, rates),
        "kernels": body_profile(call, flush),
    }
    if not int8:
        # The same function in one PyTorch call: SDPA over the live
        # keys, views of the cache (no copy).
        row["library_ms"] = yardstick_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k_[:, :L].transpose(1, 2),
                v_[:, :L].transpose(1, 2), enable_gqa=True), flush)
        if isinstance(row["library_ms"], str):
            row["library_note"] = row.pop("library_ms")
            row["library_ms"] = None
    else:
        kd, vd = ((c[:, :L].float() * sc[n][:, :L, :, None]).to(
            torch.bfloat16).transpose(1, 2)
            for c, n in ((k_, "k_scale"), (v_, "v_scale")))
        row["sdpa_dequantized_ms"] = yardstick_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kd, vd, enable_gqa=True), flush)
    return row


def paged_parity(A, name, q, k_, v_, sc, tables, lens) -> dict:
    """The paged kernel against the plain walk and the fp32 reference in
    bf16, against the plain split form with its own plan at fp32 (the
    same cache under fp32 activations, an int8 cache as it is); reruns
    bit-identical, dead slots exact zeros."""
    args = (q, k_, v_, tables, lens)
    got = A.paged_decode_attention(*args, **sc, impl="cuda")
    again = A.paged_decode_attention(*args, **sc, impl="cuda")
    plain = A.paged_decode_attention(*args, **sc, impl="torch")
    ref = A.paged_decode_attention(*args, **sc, impl="reference")
    f32 = (q.float(), k_ if sc else k_.float(), v_ if sc else v_.float(),
           tables, lens)
    lengths = lens.tolist()
    plan = plan_of(A, q.shape[0], k_.shape[2], tables.shape[1] * k_.shape[1],
                   lengths, q.shape[1] // k_.shape[2])
    torch.cuda.synchronize()
    out = {
        "split_plan": plan,
        "vs_plain": compare(f"{name} vs plain", got, plain),
        "vs_reference": compare(f"{name} vs reference", got, ref),
        "fp32_vs_split": compare_fp32(
            name, A.paged_decode_attention(*f32, **sc, impl="cuda"),
            A.paged_decode_attention(*f32, **sc, impl="torch",
                                     split_keys=plan["chunk"])),
        "rerun_bit_identical": bool(torch.equal(got, again)),
        "dead_slot_exact_zero": all(
            bool(torch.all(got[i] == 0)) for i, n in enumerate(lengths)
            if n == 0),
    }
    if not (out["rerun_bit_identical"] and out["dead_slot_exact_zero"]):
        raise AssertionError(f"{name}: reruns must give identical bits and "
                             f"a length-0 slot exact zeros: {out}")
    return out


def contiguous_parity(A, name, q, k_, v_, sc, length) -> dict:
    """The contiguous kernel as paged_parity holds the paged one."""
    got = A.decode_attention(q, k_, v_, length, **sc, impl="cuda")
    again = A.decode_attention(q, k_, v_, length, **sc, impl="cuda")
    plain = A.decode_attention(q, k_, v_, length, **sc, impl="torch")
    ref = A.decode_attention(q, k_, v_, length, **sc, impl="reference")
    f32 = (q.float(), k_ if sc else k_.float(), v_ if sc else v_.float())
    plan = plan_of(A, q.shape[0], k_.shape[2], length, [length] * q.shape[0],
                   q.shape[1] // k_.shape[2])
    torch.cuda.synchronize()
    out = {
        "split_plan": plan,
        "vs_plain": compare(f"{name} vs plain", got, plain),
        "vs_reference": compare(f"{name} vs reference", got, ref),
        "fp32_vs_split": compare_fp32(
            name, A.decode_attention(*f32, length, **sc, impl="cuda"),
            A.decode_attention(*f32, length, **sc, impl="torch",
                               split_keys=plan["chunk"])),
        "rerun_bit_identical": bool(torch.equal(got, again)),
    }
    if not out["rerun_bit_identical"]:
        raise AssertionError(f"{name}: reruns must give identical bits")
    return out


# The decode kernels' shapes past Llama-3-8B's (phase parity): head dims
# padded into their bucket (16, 32, 48 in 64; 96 in 128; 192 in 256) and
# the 256 bucket itself, and n_rep in one row group (1, 3, 5) and in
# several (16, 32).
GRID_HDS = (16, 32, 48, 96, 192, 256)
GRID_REPS = (1, 3, 5, 16, 32)
GRID_LENGTHS = (0, 1, 77, 300, 1024)  # paged: 64 pages of 16 a slot
GRID_CONTIG = (0, 1, 333, 1024)       # contiguous: max_seq 1024


def grid_parity(A, Q, gen) -> dict:
    """paged_parity and contiguous_parity at GRID_HDS x GRID_REPS, kvh 2,
    with bf16 pools and int8 pools (each kernel against its plain
    version and the fp32 reference at the bf16 bar, and at fp32 against
    the plain split form with its plan; reruns bit-identical): paged
    with a dead slot and a slot at the table's full capacity
    (GRID_LENGTHS), contiguous at GRID_CONTIG (length 0 exact zeros).
    Raises on a miss; returns the count of checks and the worst figure
    of each bar."""
    worst = {"fp32": 0.0, "bf16": 0.0}
    checks = 0

    def note(res):
        nonlocal checks
        checks += 1
        worst["fp32"] = max(worst["fp32"],
                            res["fp32_vs_split"]["max_err_over_max_ref"])
        worst["bf16"] = max(worst["bf16"], *(
            res[k]["worst_err_over_limit"]
            for k in ("vs_plain", "vs_reference")))

    for hd in GRID_HDS:
        for n_rep in GRID_REPS:
            tag = f"hd={hd} n_rep={n_rep}"
            q, kp, vp, tables, lens = paged_inputs(
                gen, list(GRID_LENGTHS), num_pages=1 + 64 * len(
                    GRID_LENGTHS), kvh=2, n_rep=n_rep, hd=hd)
            for name, (k_, v_, sc) in (
                    ("paged_decode_attention", (kp, vp, {})),
                    ("paged_decode_attention_int8", int8_pools(Q, kp, vp))):
                note(paged_parity(A, f"{name} {tag}", q, k_, v_, sc, tables,
                                  lens))
            for int8 in (False, True):
                q, k_, v_, sc = contiguous_inputs(
                    Q, gen, b=3, max_seq=1024, kvh=2, n_rep=n_rep, hd=hd,
                    int8=int8)
                name = f"decode_attention{'_int8' if int8 else ''} {tag}"
                for length in GRID_CONTIG:
                    if length:
                        note(contiguous_parity(A, name, q, k_, v_, sc,
                                               length))
                    elif not bool(torch.all(A.decode_attention(
                            q, k_, v_, 0, **sc, impl="cuda") == 0)):
                        raise AssertionError(f"{name}: length 0 must give "
                                             f"exact zeros")
            del q, kp, vp, tables, lens, k_, v_, sc
    return {"checks": checks, "fp32_bar": FP32_REL, "bf16_rtol": BF16_RTOL,
            "worst_fp32": worst["fp32"], "worst_bf16_over_limit": worst["bf16"]}


# decode_shapes (a): Llama-3.2-3B's widths (its published config.json:
# hidden 3072, 28 layers, 24 heads, 8 kv heads, intermediate 8192, vocab
# 128256, rope theta 500000): head dim 128, n_rep 3. LlamaConfig has no
# rope scaling and no tied embeddings, so these are the model's shapes,
# not the model. (b): (hd, n_heads, n_kv_heads) at 2 layers, fp32, dim
# hd x n_heads, ffn twice the dim: a padded bucket at each size, the 256
# bucket with groups of 2, and n_rep 16 and 32 (MQA).
LLAMA32_3B = {"dim": 3072, "n_layers": 28, "n_heads": 24, "n_kv_heads": 8,
              "ffn_dim": 8192, "vocab_size": 128256, "rope_theta": 500000.0}
SHAPE_GRID = ((32, 8, 8), (96, 32, 32), (192, 16, 16), (256, 16, 8),
              (128, 32, 2), (64, 32, 1))
SHAPE_GRID_VOCAB = 1024


def shapes_routes(DM, I8, cfg, m_prefill: int) -> dict:
    """The routes the decode MLP (bf16, 8 slots) and the int8 matmul
    (bf16 x at 8 rows and at the prefill's rows) take at ``cfg``'s
    widths: route functions on empty tensors of those shapes, nothing
    launched."""
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    hd, kvh = d // cfg.n_heads, cfg.n_kv_heads
    bf = torch.bfloat16
    x = torch.empty(8, d, dtype=bf, device="cuda")
    ws = (torch.empty(d, f, dtype=bf, device="cuda"),
          torch.empty(d, f, dtype=bf, device="cuda"),
          torch.empty(f, d, dtype=bf, device="cuda"))
    out = {"decode_mlp_b8": DM._decode_mlp_route(x, ws)}
    for label, k, n in (("wq_wo", d, d), ("wk_wv", d, kvh * hd),
                        ("gate_up", d, f), ("down", f, d), ("lm_head", d, v)):
        w = torch.empty(k, n, dtype=torch.int8, device="cuda")
        out[f"int8mm_{label}"] = {
            f"m{m}": I8._int8mm_route(torch.empty(m, k, dtype=bf,
                                                  device="cuda"), w)
            for m in (8, m_prefill)}
    return out


def llama32_3b_arm(E, G, I8, DM, kernels, init_params, base, ec,
                   reqs) -> tuple:
    """decode_shapes (a): LLAMA32_3B's widths at full depth, bf16, random
    weights from a seeded CUDA generator. The engine phase's requests
    through the engine (every decode step L paged-attention launches and
    L tensor-core MLP launches, nothing on the int8 branch), the one
    decode step of every STEP_VARIANTS variant compared under
    step_gates (bf16 at 28 layers, fp32, bf16 at 2 layers), and
    greedy_generate at b=8, prompt 256, 32 new tokens (L contiguous
    decode launches a step). Returns (report, the runs' launches)."""
    cfg = dataclasses.replace(base, **LLAMA32_3B)
    L = cfg.n_layers
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng, done, launches, wall = serve(E, kernels, cfg, params, ec, reqs)
    steps = eng.decode_steps
    mlp_want = L * (steps + eng.prefill_single_token_buckets)
    if not (launches["paged_decode_attention"] == L * steps > 0
            and launches["decode_mlp"] == launches["decode_mlp_sm90"]
            == mlp_want and launches["paged_decode_attention_int8"] == 0):
        raise AssertionError(f"decode_shapes 3B engine: launches {launches}, "
                             f"want {L} a decode step ({steps} steps)")
    engine = serve_summary(eng, done, launches, wall)
    engine["launches"] = {k: v for k, v in launches.items() if v}
    engine["launches_per_decode_step"] = {
        k: v / steps for k, v in launches.items() if v}
    engine["paged_attention_launches_per_step_reckoned"] = L
    prompts = [r.prompt for r in reqs]
    cmp = {"bf16": step_logits(E, I8, cfg, eng, prompts, STEP_VARIANTS)}
    del eng
    b, s, new = 8, 256, 32
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = G.greedy_generate(cfg, params, prompt, new)
    gen_wall = time.perf_counter() - t0
    gen_launches = dict(kernels.LAUNCHES)
    want = {k: L * (new - 1) for k in (
        "decode_attention", "decode_mlp", "decode_mlp_sm90")}
    if any(gen_launches[k] != v for k, v in want.items()) or not (
            out.shape == (b, s + new) and torch.equal(out[:, :s], prompt)
            and 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size):
        raise AssertionError(f"decode_shapes 3B generate: launches "
                             f"{gen_launches}, want {want}; {out.shape}")
    del params, out
    torch.cuda.empty_cache()
    for name, c in (
            ("fp32", dataclasses.replace(cfg, dtype=torch.float32,
                                         param_dtype=torch.float32)),
            ("bf16_2_layers", dataclasses.replace(cfg, n_layers=2))):
        e = E.Engine(c, init_params(
            c, torch.Generator(device="cuda").manual_seed(0)), ec)
        cmp[name] = step_logits(E, I8, c, e, prompts, STEP_VARIANTS)
        del e
        torch.cuda.empty_cache()
    total = collections.Counter(launches)
    total.update(gen_launches)
    return {
        "model": "Llama-3.2-3B widths (hd 128, n_rep 3), 28 layers, bf16, "
                 "random weights",
        "routes": shapes_routes(DM, I8, cfg, b * s),
        "engine": engine,
        "generate": {"batch": b, "prompt": s, "new_tokens": new,
                     "wall_seconds": gen_wall, "tok_s": b * new / gen_wall,
                     "launches": {k: v for k, v in gen_launches.items() if v},
                     "launches_per_decode_step": {
                         k: v / (new - 1) for k, v in want.items()}},
        "decode_step": cmp, "gates": step_gates(cmp),
    }, dict(total)


def shape_grid_engines(E, SB, A, kernels, init_params, base) -> tuple:
    """decode_shapes (b): each SHAPE_GRID config at 2 layers, fp32, on
    the card, an engine run with the kernels (launches counted, plain
    versions' calls on a CUDA tensor counted and held at 0) against the
    same run with the plain paged attention and MLP, with the cache of
    the model dtype and with kv_quant int8: tokens identical. Returns
    (report, the kernel runs' launches)."""
    rng = np.random.default_rng(26)
    trace = [(f"g{i}", rng.integers(1, SHAPE_GRID_VOCAB, int(n)).astype(
        np.int32), 8) for i, n in enumerate((5, 17, 33, 48))]
    out, total = {}, collections.Counter()
    for hd, nh, nkv in SHAPE_GRID:
        cfg = dataclasses.replace(
            base, dim=hd * nh, n_heads=nh, n_kv_heads=nkv, n_layers=2,
            ffn_dim=2 * hd * nh, vocab_size=SHAPE_GRID_VOCAB,
            dtype=torch.float32, param_dtype=torch.float32)
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(hd))
        cell = {}
        for quant in ("none", "int8"):
            ec = E.EngineConfig(page_size=16, max_slots=4, max_pages_per_seq=4,
                                scan_chunk=4, prefill_chunk=32,
                                kv_quant=quant)
            runs = {}
            for arm, c in (("kernels", cfg), ("plain", dataclasses.replace(
                    cfg, paged_decode_impl="torch", decode_mlp_impl="torch"))):
                eng = E.Engine(c, params, ec)
                kernels.reset_launches()
                with SB.plain_on_card() as plain_calls:
                    runs[arm] = eng.run([E.Request(rid=r, prompt=p,
                                                   max_new_tokens=n)
                                         for r, p, n in trace])
                torch.cuda.synchronize()
                launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
                if arm == "kernels":
                    key = "paged_decode_attention" + (
                        "_int8" if quant == "int8" else "")
                    want = cfg.n_layers * eng.decode_steps
                    mlp = cfg.n_layers * (eng.decode_steps
                                          + eng.prefill_single_token_buckets)
                    if (launches.get(key) != want or dict(plain_calls)
                            or launches.get("decode_mlp") != mlp):
                        raise AssertionError(
                            f"decode_shapes hd={hd} {quant}: launches "
                            f"{launches} (want {want} of {key}, {mlp} of "
                            f"decode_mlp), plain calls {dict(plain_calls)}")
                    total.update(launches)
                    kernel_launches, kernel_plain = launches, dict(
                        plain_calls)
                elif launches:
                    raise AssertionError(f"decode_shapes hd={hd} plain arm "
                                         f"launched {launches}")
            same = all(np.array_equal(runs["kernels"][r].tokens,
                                      runs["plain"][r].tokens)
                       for r, _, _ in trace)
            cell[f"kv_{quant}"] = {"tokens_identical": same,
                                   "launches": kernel_launches,
                                   "plain_calls_on_card": kernel_plain}
            if not same:
                raise AssertionError(f"decode_shapes hd={hd} nh={nh} "
                                     f"nkv={nkv} kv {quant}: kernel tokens "
                                     f"differ from the plain versions'")
        out[f"hd{hd}_h{nh}_kvh{nkv}"] = {
            "n_rep": nh // nkv,
            "rows_groups": list(A.decode_groups(nh // nkv)), **cell}
        del params
    return out, dict(total)


# The wgmma kernels' sources, the C entries that give the dynamic shared
# memory a CTA asks for, and the template argument each entry takes (the
# flash kernels' head dim, the int8 matmul's CTA tile rows).
SM90_SOURCES = {
    "flash_fwd_sm90.cu": ("tpu_flash_fwd_sm90_smem", (64, 128)),
    "flash_bwd_dq_sm90.cu": ("tpu_flash_bwd_dq_sm90_smem", (64, 128)),
    "flash_bwd_sm90.cu": ("tpu_flash_bwd_dkv_sm90_smem", (64, 128)),
    "int8mm_sm90.cu": ("tpu_int8_matmul_sm90_smem", (128, 256)),
}


# The decode GEMV's source and its instantiations: the mma.sync body at
# 1 and 2 planes of 8 rows of x, the wgmma body
# (int8_gemv_sm90_kernel_wgmma<planes, tiles>) at 4 planes with 2, 4 or
# 8 tiles a warp, at 8 planes with 2 or 4 and at 16 planes with 2.
GEMV_SM90_SOURCE = "int8mm_gemv_sm90.cu"
GEMV_SM90_KERNEL = "int8_gemv_sm90_kernel"
GEMV_SM90_WGMMA_KERNEL = "int8_gemv_sm90_kernel_wgmma"
GEMV_SM90_INSTANTIATIONS = 8


def gemv_sm90_build(kernels, report) -> dict:
    """Registers and spill bytes of each instantiation of the decode
    GEMV (every planes and tiles); raises unless ptxas reported all
    GEMV_SM90_INSTANTIATIONS and none spills."""
    out = {
        short_name(fn): {"registers": p["registers"],
                         "spill_store_bytes": p["spill_stores"],
                         "static_smem_bytes": p["smem_bytes"]}
        for fn, p in kernels.ptxas_report(
            report[GEMV_SM90_SOURCE]["log"]).items()
    }
    if sum(GEMV_SM90_KERNEL in k for k in out) != GEMV_SM90_INSTANTIATIONS:
        raise AssertionError(f"{GEMV_SM90_SOURCE}: no ptxas report for "
                             f"every instantiation: {sorted(out)}")
    spills = {k: v for k, v in out.items() if v["spill_store_bytes"]}
    if spills:
        raise AssertionError(f"{GEMV_SM90_SOURCE}: instantiations spill: "
                             f"{spills}")
    return out


# The tensor-core decode MLP's source and kernel: instantiations for
# (1, 2, 4, 8 or 16 planes of 8 rows) x (gate/up, down).
MLP_SM90_INSTANTIATIONS = 10
MLP_SM90_SOURCE = "decode_mlp_sm90.cu"
MLP_SM90_KERNEL = "mlp_sm90_kernel"
# The decode MLP's kernels by name: the tensor-core kernel's two passes
# and, at 17-128 rows, its RMS-norm launch; decode_mlp.cu's three
# kernels.
MLP_RMS_KERNEL = "rms_kernel"
MLP_KERNELS = (MLP_SM90_KERNEL, MLP_RMS_KERNEL, "gate_up_kernel",
               "down_kernel", "residual_kernel")


def mlp_sm90_build(kernels, report) -> dict:
    """Registers, static shared memory and spill bytes of each
    instantiation of the tensor-core decode MLP; raises unless ptxas
    reported all MLP_SM90_INSTANTIATIONS and none spills."""
    out = {
        short_name(fn): {"registers": p["registers"],
                         "spill_store_bytes": p["spill_stores"],
                         "static_smem_bytes": p["smem_bytes"]}
        for fn, p in kernels.ptxas_report(
            report[MLP_SM90_SOURCE]["log"]).items()
    }
    if sum(MLP_SM90_KERNEL in k for k in out) != MLP_SM90_INSTANTIATIONS:
        raise AssertionError(f"{MLP_SM90_SOURCE}: no ptxas report for "
                             f"every instantiation: {sorted(out)}")
    spills = {k: v for k, v in out.items() if v["spill_store_bytes"]}
    if spills:
        raise AssertionError(f"{MLP_SM90_SOURCE}: instantiations spill: "
                             f"{spills}")
    return out


def mlp_plan_dict(plan) -> dict:
    return {"planes": plan.planes, "gate_up": plan.gate_up._asdict(),
            "down": plan.down._asdict()}


def mlp_pass_profile(call, flush, reps: int = 20) -> dict:
    """Device µs a call of the tensor-core decode MLP spends in each
    pass (gate/up, down), from torch.profiler over ``reps`` calls with
    the L2 flushed before each."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            L2_EVICT(flush)
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and (MLP_SM90_KERNEL in ev.key
                           or MLP_RMS_KERNEL in ev.key):
            name = ("rms" if MLP_RMS_KERNEL in ev.key
                    else "gate_up" if "true>" in ev.key else "down")
            out[f"{name}_us"] = dev_us / ev.count
            out[f"{name}_launches_per_call"] = ev.count / reps
    return out or {"profile": "not measured: no device time recorded"}


# The decode MLP's parity rows: every plane count of the tensor-core
# kernel (1, 2, 4, 8, 16 planes of 8 rows; 65-128 one launch), then two
# blocks of 128 rows (129 and 200); and its timing rows: the engine
# phase's 8 slots, the 32 and 64 rows of wider engines (engine_wide runs
# 32 slots), 96 and 128 (generate_wide and engine_wide128 run 128).
MLP_PARITY_ROWS = (1, 8, 13, 16, 17, 24, 32, 48, 64, 65, 96, 127, 128, 129,
                   200)
MLP_TIMING_ROWS = (8, 32, 64, 96, 128)
# The most rows one launch took before the 16-plane body: its timing rows
# past it time that blocked route beside the kernel.
MLP_OLD_ROW_BLOCK = 64


def mlp_blocked(DM, x, scale, ws, out):
    """The route the 16-plane body replaced past MLP_OLD_ROW_BLOCK rows:
    the tensor-core kernel launched on each block of that many rows of
    x into ``out``, each block a full pass over the weights (launches
    not counted)."""
    for lo in range(0, x.shape[0], MLP_OLD_ROW_BLOCK):
        hi = min(x.shape[0], lo + MLP_OLD_ROW_BLOCK)
        DM._sm90_decode_mlp(x[lo:hi], scale, *ws, 1e-5, out=out[lo:hi])
    return out


def mlp_timing(DM, gen, b, sms, rates, flush) -> dict:
    """The fused decode MLP at B = b, d = 4096, ffn = 14336, bf16, on
    the tensor-core route: kernel ms (L2 evicted; with and without the
    host's enqueue), the kernel it replaced on the same inputs
    (``replaced_kernel_ms``: decode_mlp.cu at every B up to 64; past 64
    rows the blocked route, this kernel launched on each block of
    MLP_OLD_ROW_BLOCK rows, each a full pass over the weights), the
    plain version, the library chain, each pass's device µs and the
    bound (bytes against the bf16 peak's operations)."""
    x, scale, tree = mlp_inputs(gen, b)
    ws = mlp_weights(tree)
    d, ffn = x.shape[1], tree["w_gate"]["kernel"].shape[1]
    route = DM._decode_mlp_route(x, ws)
    if route != "sm90":
        raise AssertionError(f"decode_mlp timing b={b}: route {route}, "
                             f"want sm90")
    nbytes = 3 * d * ffn * 2 + d * 2 + 2 * x.numel() * 2
    flops = 2 * b * d * ffn * 3
    call = functools.partial(DM.decode_mlp, x, scale, tree, 1e-5,
                             impl="cuda")
    ms = time_ms(call, flush)
    host_ms = time_ms(call, flush, shield=False)
    if b <= MLP_OLD_ROW_BLOCK:
        replaced = "decode_mlp.cu"
        old_ms = time_ms(lambda: DM._simt_decode_mlp(x, scale, *ws, 1e-5),
                         flush)
    else:
        replaced = (f"decode_mlp_sm90.cu in blocks of {MLP_OLD_ROW_BLOCK} "
                    f"rows")
        out = torch.empty_like(x)
        blocked_vs_kernel = compare(f"decode_mlp b={b} blocked vs kernel",
                                    mlp_blocked(DM, x, scale, ws, out),
                                    call())
        old_ms = time_ms(lambda: mlp_blocked(DM, x, scale, ws, out), flush)
    plain_ms = time_ms(
        lambda: DM.decode_mlp(x, scale, tree, 1e-5, impl="torch"), flush)
    library_ms = yardstick_ms(lambda: mlp_library_chain(x, scale, tree),
                              flush)
    row = {
        "shape": f"B={b}, d={d}, ffn={ffn}, bf16",
        "route": route,
        "plan": mlp_plan_dict(DM.mlp_sm90_plan(b, d, ffn, sms)),
        "ms": ms, "ms_with_host": host_ms, "replaced_kernel_ms": old_ms,
        "replaced_kernel": replaced,
        **({} if b <= MLP_OLD_ROW_BLOCK else
           {"replaced_vs_kernel": blocked_vs_kernel}),
        "plain_ms": plain_ms,
        "library_ms": library_ms if isinstance(library_ms, float) else None,
        "library_note": "a chain of library calls (rms_norm, three cuBLAS "
                        "GEMMs, silu, mul, add), not one call"
                        + ("" if isinstance(library_ms, float)
                           else f"; {library_ms}"),
        "passes": mlp_pass_profile(call, flush),
        **bound(nbytes, flops, rates),
    }
    row["share_of_bound"] = row["bound_ms"] / ms
    row["replaced_over_kernel"] = old_ms / ms
    row["plain_over_kernel"] = plain_ms / ms
    if isinstance(library_ms, float):
        row["library_over_kernel"] = library_ms / ms
    passes = row["passes"]
    if "gate_up_us" in passes and "down_us" in passes:
        row["pass_us"] = {"gate_up": passes["gate_up_us"],
                          "down": passes["down_us"]}
    return row


# The MLP's halves as engine_sharded's world-2 ranks run them: the
# engine's slots and a model axis of 2.
MLP_HALF_ROWS, MLP_HALF_SHARDS = 3, 2


def mlp_halves(DM, gen, rates, flush) -> dict:
    """The decode MLP's two halves on a model shard (ops/decode_mlp.py
    ``mlp_gate_up`` / ``mlp_down``) at Llama-3-8B widths, MLP_HALF_ROWS
    rows, one of MLP_HALF_SHARDS column blocks, in fp32 (decode_mlp.cu)
    and bf16 (decode_mlp_sm90.cu): each against its plain half on the
    same inputs (fp32 at FP32_REL, bf16 at the bf16 bar); the gate/up
    half's act against the same columns of the whole gate/up half and
    the down half against the fused kernel, bit for bit; then each
    kernel's time, its plain half's, a library call's where one computes
    the same function (down: ``torch.addmm``), and its bound. Returns
    {counter name: row}."""
    out = {}
    for dtype, prefix, route in ((torch.float32, "decode_mlp", "simt"),
                                 (torch.bfloat16, "decode_mlp_sm90", "sm90")):
        x, scale, tree = mlp_inputs(gen, MLP_HALF_ROWS)
        x, scale = x.to(dtype), scale.to(dtype)
        tree = {k: {"kernel": v["kernel"].to(dtype)} for k, v in tree.items()}
        b, d = x.shape
        ffn = tree["w_gate"]["kernel"].shape[1]
        cols = ffn // MLP_HALF_SHARDS
        shard = dict(tree, **{n: {"kernel": tree[n]["kernel"][:, :cols]
                                  .contiguous()}
                              for n in ("w_gate", "w_up")})
        wd = tree["w_down"]["kernel"]
        whole = DM.mlp_gate_up(x, scale, tree, 1e-5, impl="cuda")
        routes = (DM._gate_up_route(x, shard["w_gate"]["kernel"],
                                    shard["w_up"]["kernel"], ffn),
                  DM._down_route(x, whole, wd))
        if routes != (route, route):
            raise AssertionError(f"{prefix} halves: routes {routes}, want "
                                 f"{route}")
        act = DM.mlp_gate_up(x, scale, shard, 1e-5, ffn=ffn, impl="cuda")
        plain_act = DM.mlp_gate_up(x, scale, shard, 1e-5, impl="torch")
        got = DM.mlp_down(x, whole, tree, impl="cuda")
        plain = DM.mlp_down(x, whole, tree, impl="torch")
        fused = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        torch.cuda.synchronize()
        held = compare_fp32 if dtype == torch.float32 else compare
        es = x.element_size()
        ops_rates = (rates[0], rates[2]) if dtype == torch.float32 else rates
        for half, call, plain_call, library, nbytes, flops, par in (
            ("gate_up",
             functools.partial(DM.mlp_gate_up, x, scale, shard, 1e-5,
                               ffn=ffn, impl="cuda"),
             lambda: DM.mlp_gate_up(x, scale, shard, 1e-5, impl="torch"),
             None, (2 * d * cols + b * d + d + b * cols) * es,
             2 * 2 * b * d * cols,
             {"vs_plain": held(f"{prefix}_gate_up vs plain", act, plain_act),
              "columns_bit_identical": bool(torch.equal(
                  act, whole[:, :cols]))}),
            ("down",
             functools.partial(DM.mlp_down, x, whole, tree, impl="cuda"),
             lambda: DM.mlp_down(x, whole, tree, impl="torch"),
             lambda: torch.addmm(x, whole, wd),
             (ffn * d + b * ffn + 2 * b * d) * es, 2 * b * ffn * d,
             {"vs_plain": held(f"{prefix}_down vs plain", got, plain),
              "fused_bit_identical": bool(torch.equal(got, fused))}),
        ):
            if not all(v for k, v in par.items() if k.endswith("identical")):
                raise AssertionError(f"{prefix}_{half}: not the unsharded "
                                     f"kernel's bits: {par}")
            ms = time_ms(call, flush)
            lib = None if library is None else yardstick_ms(library, flush)
            row = {
                "shape": f"B={b}, d={d}, ffn={ffn}, a shard of {cols} "
                         f"columns, {str(dtype).split('.')[-1]}",
                "route": route, "parity": par, "ms": ms,
                "ms_with_host": time_ms(call, flush, shield=False),
                "plain_ms": time_ms(plain_call, flush),
                "library_ms": lib if isinstance(lib, float) else None,
                **bound(nbytes, flops, ops_rates),
            }
            if half == "gate_up":
                row["library_note"] = (
                    "no one PyTorch call: rms_norm, two GEMMs, silu and mul")
            elif not isinstance(lib, float):
                row["library_note"] = lib
            row["share_of_bound"] = row["bound_ms"] / ms
            out[f"{prefix}_{half}"] = row
        del x, scale, tree, shard, whole, act, plain_act, got, plain, fused
    return out


def sm90_build(kernels, report) -> dict:
    """The wgmma kernels' instantiations, by source: registers and spill
    bytes from ptxas, and the dynamic shared memory a CTA asks for at
    launch; raises unless ptxas reported each source and each
    instantiation spills nothing."""
    out = {}
    for source, (entry, args) in SM90_SOURCES.items():
        smem = kernels.function(source, entry, [ctypes.c_int])
        out[source] = {}
        for fn, p in kernels.ptxas_report(report[source]["log"]).items():
            arg = next((d for d in args
                        if f"<{d}>" in fn or f"ILi{d}E" in fn), None)
            out[source][short_name(fn)] = {
                "registers": p["registers"],
                "spill_store_bytes": p["spill_stores"],
                "static_smem_bytes": p["smem_bytes"],
                "dynamic_smem_bytes": smem(arg) if arg else None,
            }
        if not out[source]:
            raise AssertionError(f"{source}: no ptxas report")
        spills = {k: v for k, v in out[source].items()
                  if v["spill_store_bytes"]}
        if spills:
            raise AssertionError(f"{source}: instantiations spill: {spills}")
    return out


def flash_inputs(gen, sq, skv, dtype, b=2, h=32, kvh=8, hd=128):
    """q, k, v, dO in the public layouts and a lse cotangent [b, h, sq]."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return (rand(b, sq, h, hd), rand(b, skv, kvh, hd), rand(b, skv, kvh, hd),
            rand(b, sq, h, hd),
            torch.randn(b, h, sq, generator=gen, device="cuda"))


def flash_delta(out, do, g_lse=None):
    """delta = rowsum(dO . O) [b, h, sq] f32, minus the lse cotangent —
    what the autograd.Function hands both backward kernels."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    return (delta if g_lse is None else delta - g_lse).contiguous()


def flash_parity(A, gen) -> dict:
    """Each flash kernel against its plain version on the same inputs:
    the backward pair takes the plain forward's lse and delta. Every
    bf16 case must take the wgmma forward, dQ and dK/dV kernels."""
    out = {}
    for name, sq, skv, causal, with_glse, h, kvh in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, g_lse = flash_inputs(gen, sq, skv, dtype, h=h,
                                              kvh=kvh)
            o_k, lse_k = A._cuda_flash_fwd(q, k, v, causal)
            o_p, lse_p = A._torch_flash_fwd(q, k, v, causal)
            delta = flash_delta(o_p, do, g_lse if with_glse else None)
            bwd = (q, k, v, do, lse_p, delta, causal)
            dq_k = A._cuda_flash_bwd_dq(*bwd)
            dk_k, dv_k = A._cuda_flash_bwd_dkv(*bwd)
            dq_p = A._torch_flash_bwd_dq(*bwd)
            dk_p, dv_p = A._torch_flash_bwd_dkv(*bwd)
            again = (A._cuda_flash_fwd(q, k, v, causal)[0],
                     A._cuda_flash_bwd_dq(*bwd),
                     *A._cuda_flash_bwd_dkv(*bwd))
            torch.cuda.synchronize()
            tag = f"flash_{name}_{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            pairs = {"out": (o_k, o_p), "dq": (dq_k, dq_p), "dk": (dk_k, dk_p),
                     "dv": (dv_k, dv_p)}
            if dtype == torch.bfloat16:
                # Gradient rows: atol never below the fp32 bar of the
                # tensor's largest magnitude (see bf16_row_atol).
                row = {f"{n}_vs_plain": compare(
                    f"{tag} {n}", a, b_, atol_floor=FP32_REL * float(
                        b_.float().abs().max()) if n != "out" else 0.0)
                    for n, (a, b_) in pairs.items()}
                row["lse_vs_plain"] = compare_fp32(f"{tag} lse", lse_k, lse_p)
            else:
                row = {f"{n}_vs_plain": compare_fp32(
                    f"{tag} {n}", a, b_, FP32_REL if n == "out" else
                    FP32_GRAD_REL) for n, (a, b_) in pairs.items()}
                row["lse_vs_plain"] = compare_fp32(f"{tag} lse", lse_k, lse_p)
            row["fwd_route"] = A._flash_fwd_route(q)
            row["dq_route"] = A._flash_bwd_dq_route(q)
            row["dkv_route"] = A._flash_bwd_dkv_route(q)
            if dtype == torch.bfloat16 and {
                    row["fwd_route"], row["dq_route"],
                    row["dkv_route"]} != {"sm90"}:
                raise AssertionError(f"{tag}: bf16 hd 128 must take the "
                                     f"sm90 routes, not {row}")
            row["rerun_bit_identical"] = all(
                bool(torch.equal(a, b_)) for a, b_ in zip(
                    again, (o_k, dq_k, dk_k, dv_k)))
            if not row["rerun_bit_identical"]:
                raise AssertionError(f"{tag}: reruns must give identical bits")
            out[tag] = row
            del q, k, v, do, o_k, o_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p, again
    return out


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the attention computes per (batch, head)."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(skv, i + off + 1) for i in range(sq))


def flash_timing(A, kernels, gen, rates, flush) -> dict:
    """The three kernels at the train phase's attention shape (b=2,
    s=2048, h=32, kvh=8, hd=128, causal, bf16): kernel, plain version,
    bound, and SDPA as the library yardstick (its forward for the
    forward, its backward for the dQ + dK/dV pair), each with its
    achieved TFLOP/s and the kernel's share of the bound. Each row also
    times the WMMA kernel (flash_attention.cu) that served bf16 before
    the wgmma one, on the same inputs; the dK/dV row adds the pair's
    time (dQ + dK/dV) beside SDPA's backward."""
    F = torch.nn.functional
    b, s, h, kvh, hd = 2, 2048, 32, 8, 128
    q, k, v, do, _ = flash_inputs(gen, s, s, torch.bfloat16, b, h, kvh, hd)
    out, lse = A._cuda_flash_fwd(q, k, v, True)
    delta = flash_delta(out, do)
    bwd = (q, k, v, do, lse, delta, True)
    pairs = b * h * visible_pairs(s, s, True)
    n_q, n_kv = q.numel() * 2, k.numel() * 2  # bf16 bytes
    rows_f32 = b * h * s * 4
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_times() -> tuple:
        with torch.no_grad():
            fwd = time_ms(sdpa, flush)
        o_lib = sdpa()
        bwd = time_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), flush)
        return fwd, bwd

    # name: the WMMA kernel's (table, argtypes, inputs, outputs' likes,
    # scales).
    wmma_args = {
        "flash_fwd": (A._FLASH_FWD_KERNELS, A._FLASH_FWD_ARGTYPES, (q, k, v),
                      (q, lse), (hd ** -0.5 * A.LOG2_E,)),
        "flash_bwd_dq": (A._FLASH_DQ_KERNELS, A._FLASH_DQ_ARGTYPES, bwd[:6],
                         (q,), (hd ** -0.5 * A.LOG2_E, hd ** -0.5)),
        "flash_bwd_dkv": (A._FLASH_DKV_KERNELS, A._FLASH_DKV_ARGTYPES,
                          bwd[:6], (k, v), (hd ** -0.5 * A.LOG2_E, hd ** -0.5)),
    }

    def wmma(name):
        """flash_attention.cu's kernel for row ``name``, which served bf16
        at hd 128 before the wgmma kernels, on the same inputs: the
        earlier kernel's time, measured beside the new one's."""
        table, argtypes, ins, like, scales = wmma_args[name]
        source, entry = table["wmma"]
        outs = [torch.empty_like(t) for t in like]
        kernels.check(kernels.function(source, entry, argtypes)(
            *(t.data_ptr() for t in (*ins, *outs)),
            *A._flash_dims(q, k, True), *scales,
            torch.cuda.current_stream().cuda_stream), entry)
        return outs

    from torch.nn.attention import SDPBackend, sdpa_kernel
    try:  # SDPA's flash backend, where this build takes GQA there
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_fwd, lib_bwd = sdpa_times()
        lib_backend = "flash"
    except RuntimeError as e:
        lib_backend = f"default (flash refused: {str(e)[:120]})"
        try:
            lib_fwd, lib_bwd = sdpa_times()
        except RuntimeError as e2:
            lib_fwd = lib_bwd = f"not measured: {e2}"[:200]
    shape = "b=2, s=2048, h=32, kvh=8, hd=128, causal, bf16"
    rows = {}
    for name, call, plain, route, flops, nbytes, lib in (
        ("flash_fwd", lambda: A._cuda_flash_fwd(q, k, v, True),
         lambda: A._torch_flash_fwd(q, k, v, True), A._flash_fwd_route,
         4 * pairs * hd, 2 * n_q + 2 * n_kv + rows_f32, lib_fwd),
        ("flash_bwd_dq", lambda: A._cuda_flash_bwd_dq(*bwd),
         lambda: A._torch_flash_bwd_dq(*bwd), A._flash_bwd_dq_route,
         6 * pairs * hd, 3 * n_q + 2 * n_kv + 2 * rows_f32, lib_bwd),
        ("flash_bwd_dkv", lambda: A._cuda_flash_bwd_dkv(*bwd),
         lambda: A._torch_flash_bwd_dkv(*bwd), A._flash_bwd_dkv_route,
         8 * pairs * hd, 2 * n_q + 4 * n_kv + 2 * rows_f32, lib_bwd),
    ):
        row = {
            "shape": shape, "ms": time_ms(call, flush),
            "ms_with_host": time_ms(call, flush, shield=False),
            "plain_ms": time_ms(plain, flush),
            **bound(nbytes, flops, rates), "route": route(q),
            "wmma_kernel_ms": time_ms(functools.partial(wmma, name), flush),
        }
        row["tflops"] = flops / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if isinstance(lib, str):
            row.update(library_ms=None, library_note=lib)
        else:
            row.update(library_ms=lib, library_backend=lib_backend)
        if name != "flash_fwd":
            row["library_covers"] = "SDPA backward: the dQ + dK/dV pair"
        elif row["library_ms"] is not None:
            row["library_tflops"] = flops / lib / 1e9
        if name == "flash_bwd_dkv":
            row["pair_ms"] = rows["flash_bwd_dq"]["ms"] + row["ms"]
            if row["library_ms"] is not None:
                row["pair_over_library"] = row["pair_ms"] / lib
        rows[name] = row
    del q, k, v, do, out, lse, delta, qt, kt, vt
    return rows


# Profiler spans: the train step's (train.py) and those of the MoE layer
# and its block (models/mixtral.py). The profiler also lists each span's
# extent on the device timeline beside the kernels; that is no kernel.
TRAIN_SPANS = ("train_step/forward", "train_step/optimizer")
MOE_SPANS = ("moe/router", "moe/dispatch", "moe/experts", "moe/combine")
MIXTRAL_BLOCK_SPAN = "mixtral/block"
SPAN_NAMES = TRAIN_SPANS + MOE_SPANS + (MIXTRAL_BLOCK_SPAN,)


def kernel_split(events) -> dict:
    """Device ms of a profiled step's kernels, each attributed by walking
    up from the op that launched it. Phase: the enclosing
    ``train_step/*`` span (forward, optimizer), else the backward (the
    remat recompute included). MoE part: the nearest enclosing MoE span
    (forward, the recompute included), or for a kernel of a backward
    node the span of the forward op that made the node (matched by
    forward thread and sequence number), each as router, dispatch,
    experts or combine; the blocks' attention and norms and everything
    outside them are ``other``. ``walked_ms``, the sum, checks the walk
    against the profiler's kernel total."""
    def enclosing(ev):
        while ev is not None and ev.name not in MOE_SPANS:
            ev = ev.cpu_parent
        return ev.name if ev is not None else None

    span_of = {}
    for ev in events:
        if ev.sequence_nr >= 0 and "Backward" not in ev.name:
            span = enclosing(ev)
            if span:
                span_of[(ev.thread, ev.sequence_nr)] = span
    phase = dict.fromkeys(("forward", "optimizer", "backward_remainder"), 0.0)
    moe = collections.defaultdict(float)
    for ev in events:
        us = sum(k.duration for k in getattr(ev, "kernels", ())
                 if k.name not in SPAN_NAMES)
        if not us:
            continue
        part, where, node = None, "backward_remainder", ev
        while node is not None:
            if part is None:
                if node.name in MOE_SPANS:
                    part = f"{node.name[4:]}_forward_ms"
                elif node.name == MIXTRAL_BLOCK_SPAN:
                    part = "other"
                elif node.sequence_nr >= 0 and "Backward" in node.name:
                    span = span_of.get((node.fwd_thread, node.sequence_nr))
                    part = f"{span[4:]}_backward_ms" if span else "other"
            if node.name in TRAIN_SPANS:
                where = node.name[len("train_step/"):]
                break
            node = node.cpu_parent
        phase[where] += us / 1e3
        moe[part or "other"] += us / 1e3
    parts = {name[4:]: moe[f"{name[4:]}_forward_ms"]
             + moe[f"{name[4:]}_backward_ms"] for name in MOE_SPANS}
    return {
        "phase_device_ms": phase, "walked_ms": sum(phase.values()),
        "moe": {"device_ms": parts, "total_device_ms": sum(parts.values()),
                "by_direction": {k: v for k, v in sorted(moe.items())
                                 if k != "other"},
                "forward_ops_matched": len(span_of)},
    }


def profile_train_step(step, state, tokens) -> tuple:
    """One more train step under torch.profiler: device kernel time by
    kernel, the flash kernels' share, the step's phases and the device
    busy share of the host window. Only device-side events count (a CPU
    op such as the autograd.Function around a ctypes launch is charged
    its kernel's time too). The phases and a MoE model's split come
    from kernel_split; the backward runs on autograd's own thread,
    outside the train step's spans. Returns (state, report)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        float(loss)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels_ = []
    for ev in prof.key_averages():
        if (ev.key not in SPAN_NAMES
                and ev.device_type == torch.autograd.DeviceType.CUDA):
            kernels_.append((ev.self_device_time_total, ev.count, ev.key))
    if not kernels_:
        return state, {"device_busy_share": "not measured",
                       "reason": "profiler recorded no device time"}
    kernels_.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels_) / 1e3
    flash = {}
    for us, n, key in kernels_:
        for name in ("flash_fwd_sm90", "flash_fwd", "flash_bwd_dq_sm90",
                     "flash_bwd_dq", "flash_bwd_dkv_sm90", "flash_bwd_dkv"):
            if f"{name}_kernel" in key:
                flash[name] = {"device_ms": us / 1e3, "count": n}
    flash_ms = sum(v["device_ms"] for v in flash.values())
    split = kernel_split(prof.events())
    report = {
        "window_ms": window_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "kernel_launches": sum(k[1] for k in kernels_),
        "flash": flash, "flash_device_ms": flash_ms,
        "flash_share_of_device_time": flash_ms / device_ms,
        "phase_device_ms": split["phase_device_ms"],
        "walked_kernel_ms": split["walked_ms"],
        "top_kernels": [{"name": key[:90], "device_ms": us / 1e3, "count": n}
                        for us, n, key in kernels_[:12]],
    }
    if split["moe"]["forward_ops_matched"]:
        report["moe"] = {**split["moe"], "share_of_device_time":
                         split["moe"]["total_device_ms"] / device_ms}
    return state, report


def grad_step(T, cfg, params, tokens, routes=None) -> tuple:
    """(loss, {name: grad}) of one forward and backward from ``params``
    under ``cfg`` (the weights are not updated). With a ``routes`` list
    (a MoE model), each router call appends its top-k expert ids: the
    forward's first, one a layer, then the remat recompute's."""
    model = T.build_model(cfg)
    hook = None
    if routes is not None:
        hook = model.block.moe.router.register_forward_hook(
            lambda mod, args, out: routes.append(out[2]))
    try:
        params.zero_grad(set_to_none=True)
        loss = T.loss_fn(model, params, tokens)
        loss.backward()
    finally:
        if hook is not None:
            hook.remove()
    grads = {n: p.grad for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def leaf_cosines(a: dict, b: dict) -> dict:
    """Cosine of each gradient leaf pair, in float64 (a 1e-5 gap over
    525M elements is below what fp32 sums resolve)."""
    def cos(x, y):
        x, y = x.double().flatten(), y.double().flatten()
        return float(x @ y / (x.norm() * y.norm()))

    return {n: cos(a[n], b[n]) for n in a}


def mixtral_active_flops_per_token(cfg, seq: int) -> float:
    """Model FLOPs per trained token on the parameters a token uses:
    attention, the router, top_k of the experts and the lm_head at 6 a
    parameter, plus the causal attention term (as Llama's
    train_flops_per_token). Capacity padding and the dispatch and
    combine products are not counted."""
    c = cfg
    hd = c.head_dim
    per_layer = (2 * c.dim * c.n_heads * hd + 2 * c.dim * c.n_kv_heads * hd
                 + c.dim * c.n_experts + c.top_k * 3 * c.dim * c.ffn_dim)
    return (6.0 * (c.n_layers * per_layer + c.dim * c.vocab_size)
            + 6.0 * c.n_layers * c.dim * seq)


def route_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of (layer, token, slot) top-k expert ids that agree."""
    return float((a == b).float().mean())


def train_phase(T, kernels, cfg, init_params, flops_per_token, rates,
                label: str) -> dict:
    """The Trainer on ``cfg`` (bf16, remat "nothing"), 5 steps, then the
    compared steps (see the module docstring). A MoE config also reports
    its routing agreement between the compared arms."""
    L, b, s, steps = cfg.n_layers, TRAIN_BATCH, TRAIN_SEQ, 5
    moe = hasattr(T.build_model(cfg), "apply_with_aux")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = T.Trainer(cfg)
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    step = trainer.make_train_step()
    # Every forward, dQ and dK/dV on the wgmma route (bf16, hd 128).
    want = {"flash_fwd": 2 * L, "flash_fwd_sm90": 2 * L, "flash_bwd_dq": L,
            "flash_bwd_dq_sm90": L, "flash_bwd_dkv": L,
            "flash_bwd_dkv_sm90": L}
    losses, step_ms, per_step = [], [], []
    kernels.reset_launches()
    for _ in range(steps):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(float(loss))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES})
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, profile = profile_train_step(step, state, tokens)
    for i, d in enumerate(per_step):
        other = {k: v for k, v in d.items() if k not in want and v}
        if any(d[k] != v for k, v in want.items()) or other:
            raise AssertionError(f"{label} step {i}: launches {d}, want "
                                 f"{want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{label} losses {losses}: finite and falling")
    steady = statistics.median(step_ms[1:])
    tokens_per_step = b * s
    out = {
        "model": f"{label}, bf16, remat nothing, random weights",
        "batch": b, "seq": s,
        "losses": losses, "step_ms": step_ms, "steady_step_ms": steady,
        "trained_tok_s": tokens_per_step / (steady / 1e3),
        "mfu": flops_per_token(cfg, s) * tokens_per_step
        / (steady / 1e3) / rates[1],
        "flops_per_token": flops_per_token(cfg, s),
        "peak_memory_gb": peak_gb, "launches": launches,
        "launches_per_step": per_step[-1], "profile": profile,
        **{f"{name}_device_ms_per_step": profile.get("flash", {}).get(
            kernel, {}).get("device_ms", "not measured")
           for name, kernel in (("flash_fwd", "flash_fwd_sm90"),
                                ("flash_bwd_dq", "flash_bwd_dq_sm90"),
                                ("flash_bwd_dkv", "flash_bwd_dkv_sm90"))},
    }

    # One step from the initial weights (after 5 steps on one batch the
    # loss is near 0): kernels vs plain versions vs an fp32 reference
    # (the same weights upcast, reference attention).
    del state, trainer, step
    torch.cuda.empty_cache()
    routes = {arm: [] if moe else None for arm in ("kernels", "torch",
                                                   "fp32")}
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         trainable=True)
    loss_k, g_k = grad_step(T, cfg, params, tokens, routes["kernels"])
    loss_p, g_p = grad_step(
        T, dataclasses.replace(cfg, attention_impl="torch"), params, tokens,
        routes["torch"])
    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32,
                                  attention_impl="reference")
    params.float()
    loss_r, g_r = grad_step(T, ref_cfg, params, tokens, routes["fp32"])
    del params
    torch.cuda.empty_cache()
    cos_kr, cos_pr = leaf_cosines(g_k, g_r), leaf_cosines(g_p, g_r)
    cos_kp = leaf_cosines(g_k, g_p)
    ratios = {n: (1 - cos_kr[n]) / max(1 - cos_pr[n], TRAIN_GAP_FLOOR)
              for n in g_k}
    bf16 = {
        "loss_kernels": loss_k, "loss_torch": loss_p, "loss_fp32": loss_r,
        "worst_leaf_cosine_kernels_vs_fp32": min(cos_kr.values()),
        "worst_leaf_cosine_torch_vs_fp32": min(cos_pr.values()),
        "worst_leaf_cosine_kernels_vs_torch": min(cos_kp.values()),
        "worst_gap_ratio": max(ratios.values()),
        "worst_gap_ratio_leaf": max(ratios, key=ratios.get),
        "bar": BF16_GAP_RATIO,
    }
    if moe:
        ids = {arm: torch.stack(r[:L]) for arm, r in routes.items()}
        bf16["top_k_route_agreement"] = {
            "kernels_vs_torch": route_agreement(ids["kernels"], ids["torch"]),
            "kernels_vs_fp32": route_agreement(ids["kernels"], ids["fp32"]),
            "torch_vs_fp32": route_agreement(ids["torch"], ids["fp32"]),
        }
        del ids
    del g_k, g_p, g_r, routes
    if not (np.isfinite([loss_k, loss_p, loss_r]).all()
            and bf16["worst_gap_ratio"] <= BF16_GAP_RATIO):
        raise AssertionError(f"{label} bf16 train step, kernels vs plain: "
                             f"{bf16}")

    c32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32,
                              param_dtype=torch.float32)
    params = init_params(c32, torch.Generator(device="cuda").manual_seed(0),
                         trainable=True)
    loss_k, g_k = grad_step(T, c32, params, tokens)
    loss_p, g_p = grad_step(
        T, dataclasses.replace(c32, attention_impl="torch"), params, tokens)
    del params
    cos = leaf_cosines(g_k, g_p)
    del g_k, g_p
    torch.cuda.empty_cache()
    fp32 = {
        "layers": 2, "loss_kernels": loss_k, "loss_torch": loss_p,
        "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
        "worst_leaf_cosine": min(cos.values()),
        "worst_leaf": min(cos, key=cos.get),
        "bars": {"loss_rel": FP32_REL, "cosine": TRAIN_FP32_COSINE},
    }
    if not (fp32["loss_rel_diff"] <= FP32_REL
            and fp32["worst_leaf_cosine"] >= TRAIN_FP32_COSINE):
        raise AssertionError(f"{label} fp32 train step, kernels vs plain: "
                             f"{fp32}")
    out["step_check"] = {f"bf16_{L}_layers": bf16, "fp32_2_layers": fp32}
    return out


# --- sampling, the sampled engine and speculative decoding -----------------

# (temperature, top_k) cases of the sampling phase; k = 40 is the sampled
# engine's.
PICK_CASES = ((0.8, 40), (1.3, 8), (1.0, 0))
# Integer and float operations per drawn candidate in the fused pick:
# Threefry-2x32's 20 rounds of add, rotate and xor (two shifts and an
# or) plus six key injections, the bit work of the uniform, two logf
# (~10 operations each) and the add; counted at the CUDA-core fp32 rate.
PICK_OPS_PER_DRAW = 20 * 5 + 6 * 2 + 6 + 2 * 10 + 2


def ulps_over_scale(got, ref) -> float:
    """Largest |got - ref| in ulps of max(|ref|, 1): where Gumbel noise
    meets a score of magnitude ~1, the unit its error counts in."""
    ref64 = ref.double()
    scale = torch.from_numpy(np.spacing(
        np.maximum(ref.abs().cpu().numpy(), 1.0).astype(np.float32)))
    return float(((got.double() - ref64).abs().cpu() / scale).max())


def pick_keys(layout: str, rows: int, device) -> dict:
    """The sample_pick key arguments of one layout: the engine's rows
    layout (seed 11, serials and positions like a decode step's), or
    sample_generate's block layout (one key folded with the step)."""
    if layout == "block":
        return {"key": torch.tensor([0, 42], dtype=torch.int64,
                                    device=device), "fold": 7}
    return {"seed": torch.tensor(11, dtype=torch.int32, device=device),
            "serials": torch.arange(1, rows + 1, dtype=torch.int32,
                                    device=device),
            "positions": torch.arange(rows, dtype=torch.int32,
                                      device=device) * 37 + 300}


def to_cpu(kw: dict) -> dict:
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def sampling_phase(S, SP, G, kernels, rates) -> dict:
    """The fused pick (csrc/sample.cu) against its plain version at the
    engine's shape, [8, 128256] fp32, with seeded logits and a copy
    rounded through bf16 (equal values at the top of each row), for each
    (temperature, top_k) of PICK_CASES in both key layouts: the kernel
    and the plain version on the card draw the same tokens over the same
    candidates, and so does the plain version on the CPU. The plain
    Threefry bits and uniforms on the card equal the CPU's, their Gumbel
    values within 2 ulps of max(|g|, 1) (the logs may round apart);
    topk_exact on the card equals the CPU's. Then the pick's device time
    at the engine's case (rows layout, 0.8, 40) beside its bound, the
    plain pick and the greedy argmax it stands in for."""
    dev = torch.device("cuda")
    rows, vocab = 8, 128256
    gen = torch.Generator(device="cpu").manual_seed(12)
    fp32 = torch.randn(rows, vocab, generator=gen) * 4
    inputs = {"fp32": fp32.to(dev),
              "bf16_ties": fp32.to(torch.bfloat16).float().to(dev)}
    out = {"shape": [rows, vocab], "cases": {}}
    for name, x in inputs.items():
        top40 = G.topk_exact(x.cpu(), 40)[0]
        ties = int((top40[:, 1:] == top40[:, :-1]).sum())
        for t, k in PICK_CASES:
            for layout in ("rows", "block"):
                kw = pick_keys(layout, rows, dev)
                kernels.reset_launches()
                got = SP.sample_pick(x, t, k, impl="cuda", candidates=True,
                                     **kw)
                launches = kernels.LAUNCHES["sample_pick"]
                plain = SP.sample_pick(x, t, k, impl="torch",
                                       candidates=True, **kw)
                cpu = SP.sample_pick(x.cpu(), t, k, impl="torch",
                                     candidates=True, **to_cpu(kw))
                torch.cuda.synchronize()
                case = {
                    "launches": launches,
                    "tokens_vs_plain_identical": bool(torch.equal(
                        got[0], plain[0])),
                    "tokens_card_vs_cpu_identical": bool(torch.equal(
                        got[0].cpu(), cpu[0])),
                    "plain_card_vs_cpu_identical": bool(torch.equal(
                        plain[0].cpu(), cpu[0])),
                    "tokens": got[0].tolist(),
                }
                if k:
                    case.update(
                        candidates_vs_plain_identical=bool(
                            torch.equal(got[1], plain[1])
                            and torch.equal(got[2], plain[2])),
                        candidates_vs_cpu_identical=bool(
                            torch.equal(got[1].cpu(), cpu[1])
                            and torch.equal(got[2].cpu(), cpu[2])),
                        max_abs_err=float((got[1] - plain[1]).abs().max()),
                    )
                else:
                    case["max_abs_err"] = 0.0
                bad = [key for key, v in case.items()
                       if isinstance(v, bool) and not v]
                if bad or launches != 1:
                    raise AssertionError(
                        f"sample_pick {name} T={t} k={k} {layout}: {bad} "
                        f"{case}")
                out["cases"][f"{name}_t{t}_k{k}_{layout}"] = case
        out[f"{name}_equal_neighbours_in_top40"] = ties
    # The plain jax.random twins on the card and on the CPU.
    key = S.fold_in(S.fold_in(S.prng_key(5), 3), 17)
    bits = S.random_bits(key.to(dev), (rows, vocab))
    bits_cpu = S.random_bits(key, (rows, vocab))
    g_card = S.gumbel_from_bits(bits)
    g_cpu = S.gumbel_from_bits(bits_cpu)
    out["threefry_bits_identical"] = bool(torch.equal(bits.cpu(), bits_cpu))
    out["uniforms_identical"] = bool(torch.equal(
        S.uniform_from_bits(bits).cpu(), S.uniform_from_bits(bits_cpu)))
    out["gumbel_max_ulps_of_scale"] = ulps_over_scale(g_card.cpu(), g_cpu)
    out["gumbel_bit_identical_share"] = float(
        (g_card.cpu() == g_cpu).float().mean())
    topk = {}
    for name, x in inputs.items():
        v, i = G.topk_exact(x, 40)
        vc, ic = G.topk_exact(x.cpu(), 40)
        topk[name] = bool(torch.equal(v.cpu(), vc)
                          and torch.equal(i.cpu(), ic))
    out["topk_exact_card_vs_cpu_identical"] = topk
    if not (out["threefry_bits_identical"] and out["uniforms_identical"]
            and out["gumbel_max_ulps_of_scale"] <= 2.0
            and all(topk.values())):
        raise AssertionError(f"sampling twins card vs CPU: {out}")
    # Time at the engine's case.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    x = inputs["fp32"]
    kw = pick_keys("rows", rows, dev)
    timing = {}
    for t, k in PICK_CASES:
        call = functools.partial(SP.sample_pick, x, t, k, impl="cuda", **kw)
        draws = rows * (k or vocab)
        nbytes = x.numel() * 4 + rows * 4
        ops = draws * PICK_OPS_PER_DRAW + x.numel()
        t_bytes = nbytes / rates[0] * 1e3
        t_ops = ops / rates[2] * 1e3
        ms = time_ms(call, flush)
        timing[f"t{t}_k{k}"] = {
            "ms": ms, "ms_with_host": time_ms(call, flush, shield=False),
            "plain_ms": time_ms(functools.partial(
                SP.sample_pick, x, t, k, impl="torch", **kw), flush),
            "argmax_ms": time_ms(lambda: torch.argmax(x, dim=-1), flush),
            "library_ms": None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops,
        }
        timing[f"t{t}_k{k}"]["share_of_bound"] = (
            timing[f"t{t}_k{k}"]["bound_ms"] / ms)
    out["timing"] = timing
    out["library_note"] = ("no PyTorch call draws jax.random's bits; "
                           "argmax_ms is the greedy pick the sampled one "
                           "replaces on the path")
    del flush
    return out


def top2_gap(G, cfg, params, prompt, tokens) -> float:
    """The gap between the two largest logits after ``prompt`` plus
    ``tokens`` (one contiguous forward on the card)."""
    ctx = torch.as_tensor(np.concatenate([prompt, tokens])[None],
                          device="cuda")
    tree = G.unroll_params(G.as_tree(params, torch.device("cuda")))
    cache = G.init_cache(cfg, 1, ctx.shape[1])
    logits = G.forward_chunk(cfg, tree, cache, ctx)[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def identical_or_explain(G, cfg, params, trace, got, want, what) -> None:
    """Raise unless ``got`` and ``want`` hold the same tokens, naming the
    first differing position and the top-2 logit gap there."""
    where = first_difference(got, want)
    if where is None:
        return
    rid, pos = where
    prompt = next(p for r, p, _ in trace if r == rid)
    gap = top2_gap(G, cfg, params, prompt, want[rid].tokens[:pos])
    raise AssertionError(
        f"{what}: {rid} differs first at generated position {pos} "
        f"(top-2 logit gap there {gap:.3e}): {got[rid].tokens.tolist()} vs "
        f"{want[rid].tokens.tolist()}")


def pool_whole_and_zero(eng, what: str) -> None:
    alloc = eng.allocator
    if alloc.free_pages != alloc.num_pages - 1 or alloc.reserved_pages:
        raise AssertionError(f"{what}: allocator leaked")
    if not all(bool((layer[1:] == 0).all())
               for _, pool in eng.cache._pools() for layer in pool):
        raise AssertionError(f"{what}: freed pages not zero")


class ReplayDraft:
    """Proposes each request's completion from an earlier run: a draft
    source whose guesses are mostly right, so the verify pass accepts
    most of them."""

    def __init__(self, reqs, done):
        self.runs = [(np.asarray(r.prompt, np.int32), done[r.rid].tokens)
                     for r in reqs]

    def propose(self, history, k):
        for prompt, tokens in self.runs:
            if (len(history) >= len(prompt)
                    and np.array_equal(history[:len(prompt)], prompt)):
                at = len(history) - len(prompt)
                return np.asarray(tokens[at:at + k], np.int32)
        return np.zeros(0, np.int32)


def pair_report(G, cfg, params, trace, got, want) -> dict:
    """Token agreement of two runs of ``trace``, and where they first
    differ with the top-2 logit gap of ``want``'s context there."""
    where = first_difference(got, want)
    out = {"token_agreement": token_agreement(got, want),
           "first_difference": where, "top2_gap": None}
    if where is not None:
        rid, pos = where
        prompt = next(p for r, p, _ in trace if r == rid)
        out["top2_gap"] = top2_gap(G, cfg, params, prompt,
                                   want[rid].tokens[:pos])
    return out


def prefix_trace(vocab: int, n: int, prefix: int, suffix: tuple, new: int,
                 seed: int) -> list:
    """(rid, prompt, new) for ``n`` requests that share one seeded
    ``prefix``-token system prompt, each with its own suffix of
    suffix[0]..suffix[1] tokens."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, prefix).astype(np.int32)
    return [
        (f"p{i}", np.concatenate([system, rng.integers(
            1, vocab, int(rng.integers(suffix[0], suffix[1] + 1)))
            .astype(np.int32)]), new)
        for i in range(n)
    ]


def prefix_requests(E, trace, prefix_len: int) -> list:
    """The trace's requests: sharing prefix "sys" of ``prefix_len``
    tokens, or private when it is 0."""
    return [E.Request(rid=r, prompt=p, max_new_tokens=n,
                      prefix_id="sys" if prefix_len else None,
                      prefix_len=prefix_len)
            for r, p, n in trace]


def peak_pages(eng) -> int:
    alloc = eng.allocator
    return alloc.num_pages - 1 - alloc.min_free


def drain_drill(E, eng, gate, reqs, followers: int, after: int) -> tuple:
    """Submit ``reqs`` (one leader, then sharers of its prefix) to an
    engine behind the EventGate ``gate``; once ``followers`` sharers
    have attached and ``after`` more steps ran, revoke, take one step,
    restore and run to the end. Raises unless the drain emptied every
    slot, flushed the registry and left the pool whole and zero, every
    request completes once with its token count, the tokens emitted
    before the drain begin each completion, and sharing resumes
    (prefix_attached grows). Returns (completions, report)."""
    for r in reqs:
        eng.add_request(r)
    while eng.prefix_attached < followers:
        if not eng.busy:
            raise AssertionError("drain drill: the sharers never attached")
        eng.step()
    for _ in range(after):
        eng.step()
    if not any(s is not None for s in eng._slots):
        raise AssertionError("drain drill: nothing in flight at the revoke")
    pre = {s.req.rid: list(s.out) for s in eng._live()}
    attached = eng.prefix_attached
    gate.revoke()
    eng.step()
    if any(s is not None for s in eng._slots) or eng._prefix_registry:
        raise AssertionError("drain drill: slots or prefix pins survived")
    eng._flush_zero()  # the zeroing the next allocation would do first
    pool_whole_and_zero(eng, "drain drill, at the drain")
    gate.restore()
    done = eng.run()
    for r in reqs:
        got = done[r.rid].tokens
        if len(got) != r.max_new_tokens:
            raise AssertionError(f"drain drill: {r.rid} has {len(got)} "
                                 f"tokens, want {r.max_new_tokens}")
        if list(got[:len(pre.get(r.rid, []))]) != pre.get(r.rid, []):
            raise AssertionError(f"drain drill: {r.rid} changed its "
                                 f"pre-drain tokens")
    if eng.prefix_attached <= attached:
        raise AssertionError("drain drill: sharing did not resume")
    pool_whole_and_zero(eng, "drain drill, after the resume")
    return done, {"drained_in_flight": len(pre),
                  "tokens_before_drain": sum(map(len, pre.values())),
                  "prefix_attached_before": attached,
                  "prefix_attached_after": eng.prefix_attached}


def stitched(parts: dict) -> dict:
    """rid -> an object with ``tokens`` (as a Completion has), from rid
    -> a list of token arrays to join."""
    return {rid: types.SimpleNamespace(tokens=np.concatenate(
        [np.asarray(p, np.int32) for p in ps])) for rid, ps in parts.items()}


def settle(*engines) -> None:
    """Each engine's idle exit (the prefix registry's pins dropped, the
    deferred zeroing done), then its pool whole and zero."""
    for eng in engines:
        if eng.busy:
            raise AssertionError("settle: an engine still holds work")
        eng.run()
        pool_whole_and_zero(eng, "engine_migrate")


def handoff(E, cfg, params, ec, reqs) -> tuple:
    """The serving fabric's prefill→decode handoff without its Router: a
    source engine as a prefill-role replica and a fresh destination as a
    decode-role one, in Replica._loop's order — the destination grafts
    the waiting extents between steps, both step, and the source exports
    every decoding sequence. An import refused for capacity waits for a
    later round, as the Router's waiting room holds an extent. Returns
    (completions, (source, destination), one row per extent moved: its
    pages, bytes, serialize and graft ms)."""
    src, dst = E.Engine(cfg, params, ec), E.Engine(cfg, params, ec)
    for r in reqs:
        src.add_request(r)
    inbox, moves, emitted = collections.deque(), [], {}
    while src.busy or dst.busy or inbox:
        waiting = collections.deque()
        for sx, row in inbox:
            t0 = time.perf_counter()
            if waiting or not dst.import_sequence(sx):
                if not dst.busy:
                    raise AssertionError(
                        f"handoff: an empty destination refused {sx.req.rid}")
                waiting.append((sx, row))
                continue
            torch.cuda.synchronize()
            row["graft_ms"] = (time.perf_counter() - t0) * 1e3
        inbox = waiting
        if src.busy:
            src.step()
        if dst.busy:
            dst.step()
        for rid in src.decoding_rids():
            t0 = time.perf_counter()
            sx = src.export_sequence(rid)
            row = {"rid": rid, "kv_len": sx.kv_len,
                   "pages": sx.extent.n_pages, "bytes": sx.extent.nbytes,
                   "serialize_ms": (time.perf_counter() - t0) * 1e3}
            emitted[rid] = sx.emitted
            inbox.append((sx, row))
            moves.append(row)
    parts = {rid: [c.tokens] for rid, c in src.completed.items()}
    parts.update({rid: [emitted[rid], c.tokens]
                  for rid, c in dst.completed.items()})
    settle(src, dst)
    return stitched(parts), (src, dst), moves


def whole_batch(E, cfg, params, ec, reqs) -> dict:
    """Run ``reqs`` until the last prefill is done, export every decoding
    sequence at that one step boundary, import them in slot order into a
    fresh engine and finish there. Returns the stitched completions."""
    a = E.Engine(cfg, params, ec)
    for r in reqs:
        a.add_request(r)
    while a._queue or a._prefilling:
        a.step()
    b = E.Engine(cfg, params, ec)
    emitted = {}
    for rid in a.decoding_rids():
        sx = a.export_sequence(rid)
        if not b.import_sequence(sx):
            raise AssertionError(f"whole batch: {rid} refused")
        emitted[rid] = sx.emitted
    if not emitted:
        raise AssertionError("whole batch: nothing decoding at the boundary")
    a.run()
    parts = {rid: [c.tokens] for rid, c in a.completed.items()}
    parts.update({rid: [emitted[rid], c.tokens]
                  for rid, c in b.run().items()})
    settle(a, b)
    return stitched(parts)


def evacuate_arm(E, cfg, params, ec, reqs) -> tuple:
    """Evacuate an engine at the first step boundary where a sequence is
    decoding and resume the evacuees on a fresh engine as the Router's
    requeue does (queued and prefilling ones re-prefill too): a
    Request(prompt + emitted) with the sampling schedule pinned (the
    first run's admission serials). Returns (stitched completions,
    sequences evacuated, tokens they had emitted)."""
    a = E.Engine(cfg, params, ec)
    for r in reqs:
        a.add_request(r)
    while not a.decoding_rids():
        a.step()
    ev = a.evacuate()
    if not any(len(e.emitted) for e in ev):
        raise AssertionError("evacuate: no sequence mid-generation")
    serial = {r.rid: i + 1 for i, r in enumerate(reqs)}
    b = E.Engine(cfg, params, ec)
    resumed = b.run([E.Request(
        rid=e.req.rid, prompt=np.concatenate([e.req.prompt, e.emitted]),
        max_new_tokens=e.remaining, ttft_preobserved=e.t_first is not None,
        sample_seed=ec.sample_seed, sample_serial=serial[e.req.rid])
        for e in ev])
    parts = {rid: [c.tokens] for rid, c in a.completed.items()}
    parts.update({e.req.rid: [e.emitted, resumed[e.req.rid].tokens]
                  for e in ev})
    settle(a, b)
    return stitched(parts), len(ev), int(sum(len(e.emitted) for e in ev))


def pinned_copy_gbs(nbytes: int = 256 * 2**20, reps: int = 5) -> dict:
    """A plain copy of ``nbytes`` between pinned host memory and the
    card, each way: the median GB/s of ``reps`` copies (CUDA events)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for label, dst, src in (("host_to_device", dev, host),
                            ("device_to_host", host, dev)):
        dst.copy_(src)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        out[label] = nbytes / statistics.median(times) / 1e9
    del host, dev
    return out


def extent_report(moves: list, page_bytes: int) -> dict:
    """The handoff's extents: bytes as reckoned (``page_bytes`` a page,
    raises otherwise), and serialize/graft ms and GB/s for each and for
    the longest."""
    for row in moves:
        if row["bytes"] != row["pages"] * page_bytes:
            raise AssertionError(f"extent {row}: want {page_bytes} B a page")
        row["mib"] = row["bytes"] / 2**20
        for op in ("serialize", "graft"):
            row[f"{op}_gb_s"] = row["bytes"] / row[f"{op}_ms"] / 1e6
    longest = max(moves, key=lambda r: r["kv_len"])
    return {"page_mib": page_bytes / 2**20, "extents": moves,
            "longest": longest,
            "serialize_ms_median": statistics.median(
                r["serialize_ms"] for r in moves),
            "graft_ms_median": statistics.median(r["graft_ms"] for r in moves)}


def reprefill_ttft(E, cfg, params, ec, prompt) -> dict:
    """The fallback migration replaces: one request prefilling
    ``prompt`` (a migrated sequence's prompt + emitted) alone on a fresh
    engine, to its first token."""
    eng = E.Engine(cfg, params, ec)
    t0 = time.perf_counter()
    c = eng.run([E.Request(rid="reprefill", prompt=prompt,
                           max_new_tokens=1)])["reprefill"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    settle(eng)
    return {"context": len(prompt), "ttft_s": c.ttft_s, "wall_s": wall,
            "prefill_buckets": eng.prefill_buckets}


# engine_migrate's w8kv8 arms run at this depth (its bf16 arms at 32
# layers): at 32 layers they took 25.5-34.9 s of the phase, at 2 layers
# 1.8 s (an H100 80GB HBM3 at 700 W; the phase 41.5-57.7 s, then 19.7 s).
MIGRATE_W8_LAYERS = 2


def migrate_phase(E, G, kernels, cfg, params, ec, reqs, want, label,
                  page_bytes) -> dict:
    """engine_migrate's arms for one storage mode at 8B widths: the
    handoff (launches read around it), the whole batch and the
    evacuation, each against ``want`` (the unmigrated run)."""
    L = cfg.n_layers
    trace = [(r.rid, r.prompt, r.max_new_tokens) for r in reqs]
    kernels.reset_launches()
    t0 = time.perf_counter()
    done, (src, dst), moves = handoff(E, cfg, params, ec, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = src.decode_steps + dst.decode_steps
    ones = src.prefill_single_token_buckets + dst.prefill_single_token_buckets
    if ec.kv_quant == "int8":
        want_l = {"paged_decode_attention_int8": L * steps,
                  "paged_decode_attention": 0, "decode_mlp": 0}
        ok = launches["int8mm_gemv_sm90"] > 0
    else:
        want_l = {"paged_decode_attention": L * steps,
                  "decode_mlp_sm90": L * (steps + ones), "int8mm": 0}
        ok = True
    if not ok or any(launches[k] != v for k, v in want_l.items()):
        raise AssertionError(f"engine_migrate {label}: launches {launches}, "
                             f"want {want_l} ({steps} decode steps)")
    identical_or_explain(G, cfg, params, trace, done, want,
                         f"engine_migrate {label} handoff")
    t1 = time.perf_counter()
    identical_or_explain(G, cfg, params, trace,
                         whole_batch(E, cfg, params, ec, reqs), want,
                         f"engine_migrate {label} whole batch")
    batch_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    ev_done, n_ev, ev_tokens = evacuate_arm(E, cfg, params, ec, reqs)
    evac_s = time.perf_counter() - t1
    ext = extent_report(moves, page_bytes)
    longest = ext["longest"]
    prompt = next(np.concatenate([r.prompt, done[r.rid].tokens[
        :longest["kv_len"] + 1 - len(r.prompt)]])
        for r in reqs if r.rid == longest["rid"])
    return {
        "handoff": {"identical": True, "wall_s": wall, "moved": len(moves),
                    "decode_steps": {"source": src.decode_steps,
                                     "destination": dst.decode_steps},
                    "launches": launches},
        "whole_batch": {"identical": True, "wall_s": batch_s},
        "evacuate": {"evacuated": n_ev, "tokens_before": ev_tokens,
                     "wall_s": evac_s,
                     **pair_report(G, cfg, params, trace, ev_done, want)},
        **ext,
        "reprefill_longest": reprefill_ttft(E, cfg, params, ec, prompt),
    }


def tiny_migrate(E, cfg, params, trace, ec) -> dict:
    """The three arms at tiny fp32 on the card, each token-identical to
    the unmigrated run there."""
    reqs = [E.Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in trace]
    eng = E.Engine(cfg, params, ec)
    want = eng.run(reqs)
    pool_whole_and_zero(eng, "tiny migrate, unmigrated")
    arms = {"handoff": handoff(E, cfg, params, ec, reqs)[0],
            "whole_batch": whole_batch(E, cfg, params, ec, reqs),
            "evacuate": evacuate_arm(E, cfg, params, ec, reqs)[0]}
    for arm, got in arms.items():
        where = first_difference(got, want)
        if where is not None:
            raise AssertionError(f"tiny migrate {arm}: differs first at "
                                 f"{where}")
    return {arm: True for arm in arms}


def mid_generation(eng) -> bool:
    """A sequence of ``eng`` has emitted tokens and still owes some."""
    return any(s is not None and s.out and s.remaining > 0
               for s in eng._slots)


class StepWatch:
    """Wraps each replica engine's ``step``: every step's host seconds,
    and ``fault`` armed (``inject_fault``, once an arm) on the first
    replica whose step leaves a sequence mid-generation. The wrapper runs
    on the replica's own thread, so the fault lands between that step and
    the next, with the sequence in flight."""

    def __init__(self, reps, fault=None):
        self.fault, self.victim, self.t_inject = fault, None, None
        self.seconds = {rep.name: [] for rep in reps}
        self._lock = threading.Lock()
        self._reps = reps
        for rep in reps:
            rep.engine.step = functools.partial(self._step, rep,
                                                rep.engine.step)

    def _step(self, rep, step):
        t0 = time.perf_counter()
        busy = step()
        self.seconds[rep.name].append(time.perf_counter() - t0)
        if self.fault is not None and self.victim is None and (
                mid_generation(rep.engine)):
            with self._lock:
                if self.victim is None:
                    self.victim, self.t_inject = rep, time.monotonic()
                    rep.inject_fault(self.fault)
        return busy

    def release(self) -> None:
        for rep in self._reps:
            del rep.engine.step


def fabric_arm(E, SV, kernels, make_engine, reqs, roles, label, *,
               fault=None, stall_s: float, autoscale=False,
               inflight=FABRIC_INFLIGHT) -> tuple:
    """Serve ``reqs`` through the port's Router (one INTERACTIVE tenant)
    over one replica thread (``Replica.start``) a role in ``roles``, each
    engine from ``make_engine`` and warmed first (its first steps build
    the kernels and warm cuBLAS, which could outlast the stall
    watchdog). ``fault`` ("crash" or "stall") is armed on the first
    replica with a sequence mid-generation; ``autoscale`` scales down
    through the ClaimAutoscaler (a ClaimStore) once a sequence is
    mid-generation. Raises unless every request completes once with its
    token count; the Router's deaths equal the injected faults and no
    replica has another error (Replica._loop would turn a CUDA error
    into a quiet re-dispatch); a crash or stall is recovered with each
    sequence re-dispatched at most once (a stall detected within
    ``stall_s`` + FABRIC_STALL_MARGIN_S); the paged-decode and MLP
    launches are L a decode step summed over the replicas, as
    migrate_phase reckons them; every pool ends whole and zero.
    Returns (completions, report, launches)."""
    reps = []
    for i, role in enumerate(roles):
        eng = make_engine()
        n = eng.ec.prefill_chunk + 1  # a full chunk and a 1-token one
        eng.run([E.Request(rid="warm", prompt=np.arange(1, n + 1,
                                                        dtype=np.int32),
                           max_new_tokens=3)])
        eng.completed.clear()
        reps.append(SV.Replica(f"{role}{i}", eng, claim_name=f"claim-{i}",
                               role=role))
    cfg = reps[0].engine.config
    base = {rep.name: (rep.engine.decode_steps,
                       rep.engine.prefill_single_token_buckets,
                       rep.engine.decode_seconds) for rep in reps}
    router = SV.Router([SV.TenantSpec("t", SV.INTERACTIVE)], reps,
                       SV.RouterConfig(max_inflight_per_replica=inflight,
                                       stall_deadline_seconds=stall_s))
    claims = scaler = None
    if autoscale:
        claims = ClaimStore(device="cuda:0")
        for rep in reps:
            claims.create({"metadata": {"name": rep.claim_name}})
        # Any queued load is under the band: the first tick scales down.
        scaler = SV.ClaimAutoscaler(
            router, claims, make_claim=None, make_replica=None,
            config=SV.AutoscalerConfig(min_replicas=1,
                                       max_replicas=len(reps),
                                       target_tokens_per_replica=1e9))
    watch = StepWatch(reps, fault)
    kernels.reset_launches()
    for rep in reps:
        rep.start()
    t0 = time.monotonic()
    try:
        for r in reqs:
            if not router.submit("t", r):
                raise AssertionError(f"fabric {label}: {r.rid} rejected")
        while len(router.completions) < len(reqs) or router.busy:
            bad = [rep for rep in reps if rep.error is not None
                   and not isinstance(rep.error, SV.faults.ReplicaFault)]
            if bad:
                raise AssertionError(
                    f"fabric {label}: replica {bad[0].name} failed: "
                    f"{bad[0].error!r}") from bad[0].error
            if time.monotonic() - t0 > FABRIC_ARM_TIMEOUT_S:
                raise AssertionError(
                    f"fabric {label}: {len(router.completions)} of "
                    f"{len(reqs)} done after {FABRIC_ARM_TIMEOUT_S} s")
            router.poll()
            if scaler is not None and (scaler.events or any(
                    mid_generation(rep.engine) for rep in router.replicas)):
                scaler.tick()
            time.sleep(FABRIC_POLL_S)
        wall = time.monotonic() - t0
    finally:
        for rep in reps:
            rep.stop(timeout=30.0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    watch.release()
    injected = 0 if fault is None else 1
    if fault is not None and watch.victim is None:
        raise AssertionError(f"fabric {label}: no sequence mid-generation "
                             f"to inject {fault} on")
    errors = [(rep.name, repr(rep.error)) for rep in reps
              if rep.error is not None and not (
                  fault == "crash" and rep is watch.victim
                  and isinstance(rep.error, SV.faults.ReplicaFault))]
    dead = [(rep.name, rep.death_reason) for rep in reps if rep.dead]
    want_dead = ([] if fault is None
                 else [(watch.victim.name, fault)])
    if errors or router.deaths != injected or dead != want_dead:
        raise AssertionError(
            f"fabric {label}: errors {errors}, deaths {router.deaths} "
            f"{router.death_log}, want {injected} ({want_dead})")
    retries = [e.retries for e in router.journal.closed.values()]
    if (router.journal.entries or router.duplicates_dropped
            or max(retries) > 1 or sum(retries) != router.redispatched
            or (fault is not None) != (router.redispatched > 0)):
        raise AssertionError(
            f"fabric {label}: open {list(router.journal.entries)}, "
            f"duplicates {router.duplicates_dropped}, retries {retries}, "
            f"re-dispatched {router.redispatched}")
    for r in reqs:
        got = router.completions[r.rid].tokens
        if len(got) != r.max_new_tokens or not (
                0 <= got.min() and got.max() < cfg.vocab_size):
            raise AssertionError(f"fabric {label}: {r.rid} gave {got}")
    detect_s = None
    if fault == "stall":
        detect_s = router.death_log[0][2] - watch.t_inject
        if detect_s > stall_s + FABRIC_STALL_MARGIN_S:
            raise AssertionError(
                f"fabric {label}: stall detected after {detect_s:.2f} s "
                f"(deadline {stall_s} s + {FABRIC_STALL_MARGIN_S} s)")
    report = {"replicas": {}}
    steps = ones = 0
    for rep in reps:
        eng = rep.engine
        if eng.busy:  # a dead replica's engine still holds its sequences
            eng.evacuate()
        eng.run()
        pool_whole_and_zero(eng, f"fabric {label} {rep.name}")
        d_steps = eng.decode_steps - base[rep.name][0]
        steps += d_steps
        ones += eng.prefill_single_token_buckets - base[rep.name][1]
        secs = watch.seconds[rep.name]
        report["replicas"][rep.name] = {
            "role": rep.role, "decode_steps": d_steps,
            "decode_seconds": eng.decode_seconds - base[rep.name][2],
            "steps": len(secs), "step_wall_s": sum(secs),
            "longest_step_s": max(secs, default=0.0),
            "dead": rep.death_reason or None}
    attn = ("paged_decode_attention_int8" if reps[0].engine.ec.kv_quant
            == "int8" else "paged_decode_attention")
    want = {attn: cfg.n_layers * steps,
            "decode_mlp": cfg.n_layers * (steps + ones)}
    if cfg.dtype == torch.bfloat16:
        want["decode_mlp_sm90"] = want["decode_mlp"]
    if steps <= 0 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"fabric {label}: launches {launches}, want "
                             f"{want} ({steps} decode steps)")
    if "prefill" in roles and not router.kv_migrations.get("shipped"):
        raise AssertionError(f"fabric {label}: no extent shipped "
                             f"{router.kv_migrations}")
    if scaler is not None:
        down = [e for e in scaler.events if e[0] == "down-complete"]
        if (scaler.scaledowns != 1 or len(down) != 1
                or not down[0][3]["engine_empty_at_delete"]
                or claims.deleted != [down[0][1]]
                or len(router.replicas) != len(reps) - 1):
            raise AssertionError(f"fabric {label}: scale-down "
                                 f"{scaler.events}, deleted {claims.deleted}")
        report["scale_down"] = {"requeued": down[0][3]["requeued"],
                                "drain_s": down[0][3]["drain_s"],
                                "claim_deleted": claims.deleted[0]}
    done = dict(router.completions)
    ttft = [c.ttft_s for c in done.values()]
    decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
    report.update(
        wall_s=wall, decode_steps=steps, launches=launches,
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p99_s=float(np.percentile(ttft, 99)),
        decode_tokens=decode_tokens, decode_tok_s_over_wall=(
            decode_tokens / wall),
        longest_step_s=max(r["longest_step_s"]
                           for r in report["replicas"].values()),
        served_by={rid: c.replicas for rid, c in done.items()},
        deaths=[list(d[:2]) for d in router.death_log],
        redispatched=router.redispatched, stall_detect_s=detect_s,
        kv_migrations=dict(router.kv_migrations),
        kv_migrated_pages=router.kv_migrated_pages,
        migration_ms_median=(statistics.median(router.migration_seconds)
                             * 1e3 if router.migration_seconds else None))
    return done, report, launches


FABRIC_ARMS = (
    # label, roles, injected fault
    ("colocated", ("both", "both"), None),
    ("disaggregated", ("prefill", "decode"), None),
    ("crash", ("both", "both"), "crash"),
    ("stall", ("both", "both"), "stall"),
)


def fabric_phase(E, G, SV, kernels, cfg, params, ec, reqs, want_8b,
                 tiny, tparams, trace, tec, sampled) -> tuple:
    """The port's serving tier on the card: FABRIC_ARMS at 8B widths
    (``params``, one tree for every replica; the engine phase's
    FABRIC_REQUESTS requests with the shortest prompts, in its order, cut
    to FABRIC_NEW_TOKENS, each arm's tokens reported against
    ``want_8b``, the engine phase's completions, first difference and
    top-2 gap), then at tiny fp32, greedy and sampled,
    FABRIC_ARMS and a scale-down through the ClaimAutoscaler, each
    token-identical to one engine's run of the trace on the card.
    Returns (report, launches summed over the arms)."""
    launches = collections.Counter()
    stall_s = FABRIC_STALL_S
    short = {r.rid for r in sorted(reqs, key=lambda r: len(r.prompt))[
        :FABRIC_REQUESTS]}
    freqs = [E.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=min(
        r.max_new_tokens, FABRIC_NEW_TOKENS))
        for r in reqs if r.rid in short]
    ftrace = [(r.rid, r.prompt, r.max_new_tokens) for r in freqs]
    want = {r.rid: types.SimpleNamespace(
        tokens=want_8b[r.rid].tokens[:r.max_new_tokens]) for r in freqs}
    out = {"watchdog": {"stall_deadline_seconds": stall_s,
                        "tiny_stall_deadline_seconds": FABRIC_TINY_STALL_S,
                        "margin_s": FABRIC_STALL_MARGIN_S},
           "requests": len(freqs), "new_tokens": FABRIC_NEW_TOKENS,
           "inflight_per_replica": FABRIC_INFLIGHT}
    for label, roles, fault in FABRIC_ARMS:
        done, rep, arm_launches = fabric_arm(
            E, SV, kernels, lambda: E.Engine(cfg, params, ec), freqs, roles,
            label, fault=fault, stall_s=stall_s)
        launches.update(arm_launches)
        rep["vs_engine"] = pair_report(G, cfg, params, ftrace, done, want)
        out[label] = rep
    out["watchdog"]["longest_step_s"] = max(
        out[label]["longest_step_s"] for label, _, _ in FABRIC_ARMS)
    treqs = [E.Request(rid=r, prompt=p, max_new_tokens=n)
             for r, p, n in trace]
    out["tiny_fp32"] = {}
    for mode, kw in (("greedy", {}), ("sampled", sampled)):
        tec_m = dataclasses.replace(tec, **kw)
        eng = E.Engine(tiny, tparams, tec_m)
        tiny_want = eng.run(treqs)
        pool_whole_and_zero(eng, f"fabric tiny {mode}, one engine")
        row = {}
        for label, roles, fault, autoscale in (
                tuple(arm + (False,) for arm in FABRIC_ARMS)
                + (("scale_down", ("both", "both"), None, True),)):
            done, rep, arm_launches = fabric_arm(
                E, SV, kernels, lambda: E.Engine(tiny, tparams, tec_m),
                treqs, roles, f"tiny {mode} {label}", fault=fault,
                stall_s=FABRIC_TINY_STALL_S, autoscale=autoscale,
                inflight=tec.max_slots)
            launches.update(arm_launches)
            where = first_difference(done, tiny_want)
            if where is not None:
                raise AssertionError(f"fabric tiny {mode} {label}: differs "
                                     f"first at {where}")
            row[label] = {"identical": True, "wall_s": rep["wall_s"],
                          "redispatched": rep["redispatched"],
                          "kv_migrations": rep["kv_migrations"],
                          **({"scale_down": rep["scale_down"]}
                             if autoscale else {})}
        out["tiny_fp32"][mode] = row
    return out, dict(launches)


# --- 7g. the fabric benches: the port's own drills over its replicas --------

# The tiny drills' seeds: the benches' own defaults (FABRIC_SEED,
# FAULT_SEED, DISAGG_SEED).
BENCH_FABRIC_SEED, BENCH_FAULT_SEED, BENCH_DISAGG_SEED = (
    20260804, 20260807, 20260807)
BENCH_NODES, BENCH_SLOTS, BENCH_TIMEOUT_S = 8, 4, 120.0
BENCH_FAULT_REQUESTS = 36  # faultbench --smoke
# The 8B arms, cut from the smokes' sizes (fabricbench: 60 requests at
# 200 rps; disaggbench: 24 at 60 rps) to fit the phase's time.
BENCH_8B_HEADLINE = (12, 200.0)  # requests, aggregate rps
BENCH_8B_DISAGG = (8, 60.0)
# The 8B arms' stall watchdog: the fabric phase's, not the Router's
# default 5 s (on an H100 80GB HBM3 at 700 W a replica step of these
# arms took up to 2.41 s, and one of the fabric phase 5.43 s).
BENCH_8B_STALL_S = FABRIC_STALL_S


class BenchWatch:
    """Watches one call of a bench function (fabricbench, faultbench,
    disaggbench) from outside: every Engine the benches build (they
    construct them through their module's ``Engine``), with each step's
    host seconds; every Fabric; every replica started; every fault
    injected. On exit, raises unless no replica has an error but an
    injected ReplicaFault, the Routers' deaths equal the faults
    injected, and every engine's pool ends whole and zero."""

    def __init__(self, E, SV, modules, label: str):
        self.E, self.SV, self.modules, self.label = E, SV, modules, label
        self.engines, self.fabrics, self.replicas = [], [], []
        self.injected = 0
        self._saved = []

    def _patch(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        watch = self

        class Engine(self.E.Engine):
            def __init__(eng, *a, **kw):
                super().__init__(*a, **kw)
                eng.step_seconds = []
                watch.engines.append(eng)

            def step(eng):
                t0 = time.perf_counter()
                busy = super().step()
                eng.step_seconds.append(time.perf_counter() - t0)
                return busy

        def recorded(base):
            class Fabric(base):
                def __init__(fab, *a, **kw):
                    super().__init__(*a, **kw)
                    watch.fabrics.append(fab)
            return Fabric

        rep_cls = self.SV.router.Replica
        start, inject = rep_cls.start, rep_cls.inject_fault

        def start_recorded(rep):
            watch.replicas.append(rep)
            start(rep)

        def inject_counted(rep, kind):
            watch.injected += 1
            inject(rep, kind)

        for mod in self.modules:
            self._patch(mod, "Engine", Engine)
            for name in ("Fabric", "DisaggFabric"):
                if name in vars(mod):
                    self._patch(mod, name, recorded(getattr(mod, name)))
        self._patch(rep_cls, "start", start_recorded)
        self._patch(rep_cls, "inject_fault", inject_counted)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self._saved):
            setattr(obj, name, value)
        return False

    def counters(self) -> dict:
        """Decode steps and single-token prefill buckets over every
        engine built, the replicas' longest step, and the Routers'
        watchdog deadlines."""
        served = [rep.engine for rep in self.replicas]
        return {
            "engines": len(self.engines), "replicas": len(self.replicas),
            "decode_steps": sum(e.decode_steps for e in self.engines),
            "single_token_buckets": sum(e.prefill_single_token_buckets
                                        for e in self.engines),
            "longest_replica_step_s": max(
                (max(e.step_seconds, default=0.0) for e in served),
                default=0.0),
            "stall_deadline_seconds": sorted({
                f.router.config.stall_deadline_seconds
                for f in self.fabrics}),
        }

    def check(self) -> dict:
        what = f"fabric_bench {self.label}"
        errors = [(rep.name, repr(rep.error)) for rep in self.replicas
                  if rep.error is not None and not isinstance(
                      rep.error, self.SV.faults.ReplicaFault)]
        deaths = sum(f.router.deaths for f in self.fabrics)
        alive = [rep.name for rep in self.replicas
                 if rep._thread is not None and rep._thread.is_alive()]
        if errors or deaths != self.injected or alive:
            raise AssertionError(
                f"{what}: replica errors {errors}, deaths {deaths} "
                f"({[f.router.death_log for f in self.fabrics]}), "
                f"{self.injected} faults injected, threads alive {alive}")
        for i, eng in enumerate(self.engines):
            if eng.busy:  # a dead replica's engine still holds sequences
                eng.evacuate()
            eng.run()
            pool_whole_and_zero(eng, f"{what} engine {i}")
        return {"deaths": deaths, "faults_injected": self.injected}


def bench_launch_gate(kernels, cfg, label: str, counts: dict) -> dict:
    """The launches since the last reset against the reckoning: L
    paged-decode launches a decode step and L decode-MLP launches a
    decode step or single-token prefill bucket, summed over every engine
    the bench built (bf16: every MLP call on the tensor-core route)."""
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    L, steps = cfg.n_layers, counts["decode_steps"]
    want = {"paged_decode_attention": L * steps,
            "decode_mlp": L * (steps + counts["single_token_buckets"])}
    if cfg.dtype == torch.bfloat16:
        want["decode_mlp_sm90"] = want["decode_mlp"]
    if steps <= 0 or any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"fabric_bench {label}: launches {launches}, "
                             f"want {want} ({steps} decode steps)")
    return launches


def bench_arm(E, SV, kernels, modules, cfg, label, call) -> tuple:
    """Run ``call()`` (a bench function) under a BenchWatch with the
    launch counts set to 0 first; returns (its report, the arm's record,
    its launches, the watch)."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    with BenchWatch(E, SV, modules, label) as watch:
        report = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = watch.counters()
    launches = bench_launch_gate(kernels, cfg, label, counts)
    record = {"seconds": wall, **counts, **watch.check(),
              "launches": launches}
    return report, record, launches, watch


def repack_drill(E, SV, FB, cfg, params, reqs) -> dict:
    """One mid-generation migration through FabricRepackAdapter, called
    in the Repacker's order (tpu_dra/scheduler/repacker.py:723-813:
    begin_drain, drain_done, finish_drain, then rebind once the claim is
    committed; the ClaimStore's claim stands for the committed one), on
    a Fabric of two replicas; then begin_drain and abort on the other
    replica, which must keep serving. Returns the fabric's completions
    and the adapter's record."""
    ec = FB._engine_config(BENCH_SLOTS, max_prompt=10, max_out=40)
    FB.warm_jit(cfg, params, ec)
    fab = FB.Fabric(
        1, [SV.TenantSpec("gold", SV.INTERACTIVE)], cfg, params, ec,
        SV.RouterConfig(backlog_cap_tokens=1e9,
                        max_inflight_per_replica=BENCH_SLOTS),
        SV.AutoscalerConfig(min_replicas=2, max_replicas=2))
    adapter = SV.FabricRepackAdapter(fab.router, fab._make_replica)
    state = {"step": "drain", "requeued": None, "moved": None,
             "aborted": None}

    def mid(rep):
        return rep.inflight and mid_generation(rep.engine)

    def tick():  # the control thread, as the Repacker's tick runs
        if state["step"] == "drain":
            rep = next((r for r in fab.router.replicas if mid(r)), None)
            if rep is not None:
                state["moved"] = rep
                state["key"] = f"{FB.NS}/{rep.claim_name}"
                adapter.begin_drain(state["key"])
                state["step"] = "wait"
        elif state["step"] == "wait" and adapter.drain_done(state["key"]):
            state["requeued"] = adapter.finish_drain(state["key"])
            claim = fab.claims.try_get(state["moved"].claim_name, FB.NS)
            adapter.rebind(state["key"], claim)
            state["step"] = "abort"
        elif state["step"] == "abort":
            rep = next((r for r in fab.router.replicas
                        if r is not state["moved"] and not r.migrating
                        and r.claim_name != state["moved"].claim_name
                        and mid(r)), None)
            if rep is not None:
                key = f"{FB.NS}/{rep.claim_name}"
                adapter.begin_drain(key)
                adapter.abort(key)
                state["aborted"] = rep
                state["step"] = "done"

    try:
        fab.scale_to(2)
        trace = [(0.0, "gold", r, f"s{i}") for i, r in enumerate(reqs)]
        res = fab.drive(trace, timeout=BENCH_TIMEOUT_S, extra_tick=tick)
        kept = state["aborted"]
        if (state["step"] != "done" or not state["requeued"]
                or adapter.rebinds != 1 or adapter.aborts != 1
                or kept not in fab.router.live_replicas()
                or kept.quiesced or kept.migrating
                or state["moved"] in fab.router.replicas
                or res["submitted"] != len(reqs)
                or set(fab.router.completions) != {r.rid for r in reqs}
                or fab.router.duplicates_dropped):
            raise AssertionError(
                f"fabric_bench repack: {state}, rebinds {adapter.rebinds}, "
                f"aborts {adapter.aborts}, {res}, completed "
                f"{len(fab.router.completions)}")
        done = dict(fab.router.completions)
    finally:
        fab.stop()
    return done, {"requeued": state["requeued"], "rebinds": adapter.rebinds,
                  "aborts": adapter.aborts,
                  "moved_claim": state["moved"].claim_name,
                  "aborted_claim": state["aborted"].claim_name,
                  "wall_s": res["wall_s"]}


def fabric_bench_phase(E, G, SV, FB, FT, DB, kernels, cfg, params, tiny,
                       tparams) -> tuple:
    """The port's fabric benches on the card through their own functions,
    over the default ClaimStore, with no timing bypass set. At tiny fp32:
    fabricbench.run_fairness_pair (its gate: FB.fairness_holds) and
    run_autoscale_drill; faultbench.run_crash_drill greedy and sampled and
    run_crash_loop_drill; disaggbench.run_parity and run_kill_drill; one
    migration and one abort through FabricRepackAdapter (repack_drill).
    At 8B widths (``params``, one tree for every replica), bf16:
    fabricbench.run_headline on the smoke's tenant mix and
    disaggbench.run_measure, cut to BENCH_8B_HEADLINE and BENCH_8B_DISAGG,
    each with token agreement against one engine's run. Every arm runs
    under a BenchWatch and bench_launch_gate. Returns (report, launches
    summed over the arms)."""
    modules = (FB, FT, DB)
    launches = collections.Counter()
    out = {"tiny_fp32": {}, "llama3_8b_bf16": {}}

    def arm(group, label, model, call):
        report, record, arm_launches, watch = bench_arm(
            E, SV, kernels, modules, model, label, call)
        launches.update(arm_launches)
        out[group][label] = {"report": report, **record}
        return report, watch

    def repack_call():
        done, rec = repack_drill(E, SV, FB, t, tp, rreqs)
        held["repack"] = done
        return rec

    t, tp, n = tiny, tparams, BENCH_NODES
    fair, _ = arm("tiny_fp32", "fairness_pair", t, lambda: FB.run_fairness_pair(
        t, tp, n, 2, BENCH_FABRIC_SEED, BENCH_SLOTS, BENCH_TIMEOUT_S))
    out["tiny_fp32"]["fairness_pair"]["bound"] = {
        "quiet_p99_x": fair["quiet_p99_x"], "max_x": FB.FAIRNESS_MAX_X,
        "quiet_p99_ms": fair["quiet_p99_ms"],
        "floor_ms": FB.FAIRNESS_FLOOR_MS}
    if not FB.fairness_holds(fair):
        raise AssertionError(f"fabric_bench fairness: {fair}")
    arm("tiny_fp32", "autoscale", t, lambda: FB.run_autoscale_drill(
        t, tp, n, BENCH_FABRIC_SEED, BENCH_TIMEOUT_S))
    for label, seed, temp in (("crash_greedy", BENCH_FAULT_SEED, 0.0),
                              ("crash_sampled", BENCH_FAULT_SEED + 1, 0.8)):
        rep, _ = arm("tiny_fp32", label, t, lambda: FT.run_crash_drill(
            t, tp, n, BENCH_FAULT_REQUESTS, seed, BENCH_TIMEOUT_S,
            temperature=temp))
        out["tiny_fp32"][label]["bound"] = {
            "recovery_p99_ms": rep["recovery_p99_ms"],
            "recovery_bound_ms": 20000.0}
    arm("tiny_fp32", "crash_loop", t, lambda: FT.run_crash_loop_drill(
        t, tp, n, BENCH_FAULT_SEED, BENCH_TIMEOUT_S))
    arm("tiny_fp32", "disagg_parity", t, lambda: DB.run_parity(
        t, tp, n, BENCH_SLOTS, BENCH_DISAGG_SEED, BENCH_TIMEOUT_S))
    arm("tiny_fp32", "disagg_kill", t, lambda: DB.run_kill_drill(
        t, tp, n, BENCH_SLOTS, BENCH_DISAGG_SEED, BENCH_TIMEOUT_S))
    rng = np.random.default_rng(BENCH_FABRIC_SEED)
    rreqs = [E.Request(rid=f"mv-{i:02d}", prompt=rng.integers(
        1, t.vocab_size, 8).astype(np.int32), max_new_tokens=40)
        for i in range(8)]
    held = {}
    arm("tiny_fp32", "repack", t, repack_call)
    want = E.Engine(t, tp, FB._engine_config(BENCH_SLOTS, 10, 40)).run(
        [dataclasses.replace(r) for r in rreqs])
    where = first_difference(held["repack"], want)
    if where is not None:
        raise AssertionError(f"fabric_bench repack: differs first at {where}")
    out["tiny_fp32"]["repack"]["identical"] = True

    # Llama-3-8B widths, bf16: the headline and colocated vs disagg.
    mix = FB.smoke_mix(*BENCH_8B_HEADLINE)
    _, watch = arm("llama3_8b_bf16", "headline", cfg,
                   lambda: FB.run_headline(
                       cfg, params, n, 2, mix, BENCH_FABRIC_SEED, 1e5,
                       BENCH_SLOTS, BENCH_TIMEOUT_S,
                       stall_deadline_seconds=BENCH_8B_STALL_S))
    trace = FB.make_fabric_trace(BENCH_FABRIC_SEED, mix, cfg.vocab_size)
    got = dict(watch.fabrics[0].router.completions)
    max_p = max(max(tt.prompt_lens) for tt in mix)
    max_o = max(max(tt.output_lens) for tt in mix)
    ref = E.Engine(cfg, params, FB._engine_config(BENCH_SLOTS, max_p, max_o)
                   ).run([dataclasses.replace(r) for _, _, r, _ in trace])
    out["llama3_8b_bf16"]["headline"]["vs_engine"] = pair_report(
        G, cfg, params, [(r.rid, r.prompt, r.max_new_tokens)
                         for _, _, r, _ in trace], got, ref)
    nreq, rate = BENCH_8B_DISAGG
    meas, watch = arm("llama3_8b_bf16", "measure", cfg,
                      lambda: DB.run_measure(
                          cfg, params, n, 2, 1, nreq, rate, BENCH_SLOTS,
                          BENCH_DISAGG_SEED, BENCH_TIMEOUT_S,
                          stall_deadline_seconds=BENCH_8B_STALL_S))
    dtrace = DB.make_disagg_trace(
        BENCH_DISAGG_SEED, requests=nreq, rate_rps=rate,
        vocab=cfg.vocab_size, prompt_lens=[24, 32, 48],
        output_lens=[8, 12, 16])
    ref = E.Engine(cfg, params, FB._engine_config(BENCH_SLOTS, 48, 16)).run(
        [dataclasses.replace(r) for _, _, r, _ in dtrace])
    rows = [(r.rid, r.prompt, r.max_new_tokens) for _, _, r, _ in dtrace]
    for side, fab in zip(("colocated", "disagg"), watch.fabrics):
        out["llama3_8b_bf16"]["measure"][f"{side}_vs_engine"] = pair_report(
            G, cfg, params, rows, dict(fab.router.completions), ref)
    dis, col = meas["disagg"], meas["colocated"]
    out["llama3_8b_bf16"]["measure"].update(
        disagg_vs_colocated_ttft=dis["ttft_p99_ms"] / max(
            col["ttft_p99_ms"], 1e-9),
        disagg_vs_colocated_itl=dis["itl_p99_ms"] / max(
            col["itl_p99_ms"], 1e-9))
    out["llama3_8b_bf16"]["cuts"] = {
        "headline": {"requests": BENCH_8B_HEADLINE[0],
                     "rate_rps": BENCH_8B_HEADLINE[1],
                     "smoke_requests": 60},
        "measure": {"requests": nreq, "rate_rps": rate,
                    "smoke_requests": 24}}
    return out, dict(launches)


def copy_page_cost(P, cache) -> dict:
    """One copy-on-write fork (paged_kv.copy_page) on the engine's
    pools: its launches (the CUDA runtime's launch and copy calls) and
    device events from torch.profiler over 5 forks, and its time (CUDA
    events, mean of 20 back-to-back forks)."""
    from torch.profiler import ProfilerActivity, profile

    reps = 5
    P.copy_page(cache, 1, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            P.copy_page(cache, 1, 2)
        torch.cuda.synchronize()
    calls = device = 0
    for ev in prof.key_averages():
        if ev.key.startswith(("cudaLaunchKernel", "cudaMemcpyAsync")):
            calls += ev.count
        elif (getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0)) > 0
              and not ev.key.startswith(("cuda", "aten"))):
            device += ev.count
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        P.copy_page(cache, 1, 2)
    end.record()
    torch.cuda.synchronize()
    return {"launches_per_copy": calls / reps if calls else "not measured",
            "device_events_per_copy": device / reps,
            "ms_per_copy": start.elapsed_time(end) / 20,
            "pool_tensors": len(cache._pools()) * cache.n_layers}


def aliased_table_parity(A, P, Q, gen, int8: bool) -> dict:
    """The paged kernel over a block table in which all 8 slots alias
    the same 12 leading pages (a shared 192-token prefix), then over a
    table in which each slot has private copies of them (copy_page):
    the kernel reads the same bytes in the same order, so the outputs
    must be bit-identical; held against the plain version too."""
    b, page, shared, tail, width = 8, 16, 12, 5, 64
    num_pages = 1 + shared + b * (shared + tail)
    bf = torch.bfloat16
    kp = torch.randn(num_pages, page, 8, 128, generator=gen,
                     device="cuda").to(bf)
    vp = torch.randn(num_pages, page, 8, 128, generator=gen,
                     device="cuda").to(bf)
    if int8:
        kq, vq, sc = int8_pools(Q, kp, vp)
        cache = P.PagedKVCache(k=[kq], v=[vq], k_scale=[sc["k_scale"]],
                               v_scale=[sc["v_scale"]])
    else:
        sc = {}
        cache = P.PagedKVCache(k=[kp], v=[vp])
    q = torch.randn(b, 32, 128, generator=gen, device="cuda").to(bf)
    aliased = torch.zeros(b, width, dtype=torch.int32)
    private = aliased.clone()
    nxt = 1 + shared
    for s in range(b):
        aliased[s, :shared] = torch.arange(1, 1 + shared)
        for j in range(shared):
            P.copy_page(cache, 1 + j, nxt)
            private[s, j] = nxt
            nxt += 1
        aliased[s, shared:shared + tail] = private[s, shared:shared + tail] = (
            torch.arange(nxt, nxt + tail))
        nxt += tail
    lengths = [200 + 8 * s for s in range(b)]  # 200..256: 13-16 pages
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    aliased, private = aliased.cuda(), private.cuda()
    args = (q, cache.k[0], cache.v[0])
    one = A.paged_decode_attention(*args, aliased, lens, **sc, impl="cuda")
    two = A.paged_decode_attention(*args, private, lens, **sc, impl="cuda")
    plain = A.paged_decode_attention(*args, aliased, lens, **sc,
                                     impl="torch")
    torch.cuda.synchronize()
    name = "aliased table" + (" int8" if int8 else "")
    out = {"slots": b, "shared_pages": shared, "lengths": lengths,
           "bit_identical": bool(torch.equal(one, two)),
           "vs_plain": compare(f"{name} vs plain", one, plain)}
    if not out["bit_identical"]:
        raise AssertionError(f"{name}: aliased and private tables differ "
                             f"by {float((one - two).abs().max())}")
    return out


# The bench_serve phase: run_serve_bench at Llama-3-8B widths, SERVE_RUNS
# times, over SERVE_ENV (the JAX defaults otherwise: rate 1000 rps,
# prompts 16/64/128/256, outputs 8/32/96/192, page 16, chunk 8, T 0.8,
# top-k 40, spec_k 6, a prefix fleet of 8). 8 requests, not 16, and one
# run, not three: one 16-request run took 72 s on an H100 80GB HBM3 at
# 700 W, an 8-request run 50-96 s, and the second run made room for the
# fabric_bench phase (the spread of several runs is the first cell's to
# measure). The spec arm and its lookup baseline run a cut lookup trace:
# a verify pass is plain PyTorch, ~25K launches at the full trace's
# contexts.
SERVE_RUNS = 1
SERVE_ENV = {
    "BENCH_SERVE_REQUESTS": "8", "BENCH_SERVE_BATCH": "8",
    "BENCH_SPEC_REQUESTS": "4", "BENCH_SPEC_PROMPTS": "16,64",
    "BENCH_SPEC_OUTPUTS": "8,32",
}
# run_serve_bench's end-to-end keys, printed as median and spread.
SERVE_KEYS = (
    "serve_tok_s", "serve_sampled_tok_s", "serve_w8_tok_s", "serve_p50_ms",
    "serve_p99_ms", "serve_ttft_p50_ms", "serve_baseline_tok_s",
    "serve_spec_tok_s",
)
# The same entry point on the tiny fp32 model, where every token-identity
# assert inside the helpers holds: bench.py's drill sizes at a
# saturating rate (a deterministic schedule).
TINY_SERVE_ENV = {
    "BENCH_SERVE_REQUESTS": "8", "BENCH_SERVE_BATCH": "4",
    "BENCH_SERVE_RATE_RPS": "1e9", "BENCH_SERVE_PROMPTS": "6,10,16,24",
    "BENCH_SERVE_OUTPUTS": "4,8,12,20",
}
# Per arm of run_serve_bench at 8B bf16: the launch counters it must
# move, and those it must leave at 0 (every flash counter too).
ARM_LAUNCHES = {
    "baseline": (("decode_attention", "decode_mlp_sm90"),
                 ("paged_decode_attention", "int8mm")),
    "engine": (("paged_decode_attention", "decode_mlp_sm90"),
               ("int8mm", "decode_attention", "sample_pick")),
    "w8": (("paged_decode_attention", "int8mm_gemv_sm90", "int8mm_sm90"),
           ("decode_mlp", "int8mm_gemv")),
    "sampled": (("paged_decode_attention", "decode_mlp_sm90", "sample_pick"),
                ("int8mm",)),
    "lookup": (("paged_decode_attention", "decode_mlp_sm90"), ("int8mm",)),
    "spec": ((), ("int8mm",)),
    "prefix_fleet": (("paged_decode_attention", "decode_mlp_sm90"),
                     ("int8mm",)),
    "prefill_batched": (("paged_decode_attention", "decode_mlp_sm90"),
                        ("int8mm",)),
    "prefill_serial": (("paged_decode_attention", "decode_mlp_sm90"),
                       ("int8mm",)),
}


class ArmWatch:
    """run_serve_bench's ``on_arm``: for each arm, the launch counters it
    moved (the change since the previous arm), the host seconds since
    the previous arm, and, for an engine run, its decode tok/s; raises
    unless every request completed with its token count, the allocator
    ended whole and, with ``expect`` (ARM_LAUNCHES), the arm moved the
    counters it should and no other."""

    def __init__(self, kernels, expect=None):
        self.kernels, self.expect = kernels, expect
        self.prev = dict(kernels.LAUNCHES)
        self.t = time.perf_counter()
        self.arms = {}

    def __call__(self, name, trace, run):
        now, t = dict(self.kernels.LAUNCHES), time.perf_counter()
        delta = {k: now[k] - self.prev[k] for k in now}
        rec = {"seconds": t - self.t,
               "launches": {k: v for k, v in delta.items() if v}}
        self.prev, self.t = now, t
        if "engine" in run:
            eng, done = run["engine"], run["completions"]
            bad = [r.rid for r in trace
                   if len(done[r.rid].tokens) != r.max_new_tokens]
            alloc = eng.allocator
            if bad or alloc.free_pages != alloc.num_pages - 1 or (
                    alloc.reserved_pages):
                raise AssertionError(
                    f"bench_serve {name}: token counts off on {bad}, or "
                    f"the allocator leaked ({alloc.free_pages} free of "
                    f"{alloc.num_pages - 1})")
            rec.update(wall_seconds=run["wall_seconds"],
                       decode_seconds=run["decode_seconds"],
                       decode_tok_s=sum(len(c.tokens) - 1
                                        for c in done.values())
                       / max(run["decode_seconds"], 1e-9),
                       verify_passes=eng.verify_passes)
        if self.expect is not None:
            moved, idle = self.expect[name]
            idle += tuple(k for k in delta if k.startswith("flash"))
            off = {k: delta[k] for k in moved if delta[k] <= 0}
            off.update({k: delta[k] for k in idle if delta[k]})
            if off:
                raise AssertionError(f"bench_serve {name}: launches {off} "
                                     f"(must move {moved}, leave {idle})")
        self.arms[name] = rec


def spread(values: list) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "runs": values}


def bench_serve_phase(kernels, EB, DB, cfg, init_params, tiny,
                      tparams) -> tuple:
    """The serve and decode benches of the port (enginebench,
    decodebench) through their entry points: run_serve_bench on the tiny
    fp32 model with every identity assert; the decode-step breakdown at
    Llama-3-8B widths (batch 8, context 512, bf16) with host and device
    ms by part; run_serve_bench at those widths SERVE_RUNS times, each
    run with the launch counts set to 0 before it. Returns (report,
    the serve runs' launches summed)."""
    t0 = time.perf_counter()
    report = {}
    tiny_watch = ArmWatch(kernels)
    res = EB.run_serve_bench(tiny, tparams, TINY_SERVE_ENV, device="cuda",
                             exact=True, on_arm=tiny_watch)
    report["tiny_fp32"] = {
        "env": TINY_SERVE_ENV, "identity_asserts": "held",
        "spec_proposed": res["spec_proposed"],
        "spec_accepted": res["spec_accepted"],
        "prefix_pages_saved": res["prefix_pages_saved"],
        "seconds": time.perf_counter() - t0,
    }
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    kernels.reset_launches()
    bd = DB.measure_step_breakdown(cfg, params, batch=8, ctx_len=512,
                                   reps=10)
    bd["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    parts = [k for k in bd if k.endswith("_device_ms")]
    if len(parts) != 9 or min(bd[k] for k in parts) <= 0 or not (
            0 < bd["busy_share"] <= 1):
        raise AssertionError(f"bench_serve breakdown: {bd}")
    report["breakdown"] = bd
    runs, launches = [], collections.Counter()
    for i in range(SERVE_RUNS):
        kernels.reset_launches()
        watch = ArmWatch(kernels, ARM_LAUNCHES)
        t_run = time.perf_counter()
        res = EB.run_serve_bench(cfg, params, SERVE_ENV, device="cuda",
                                 exact=False, on_arm=watch)
        totals = dict(kernels.LAUNCHES)
        launches.update(totals)
        if not (res["prefill_batched_ttft_p50_ms"]
                < res["prefill_serial_ttft_p50_ms"]):
            raise AssertionError(
                f"bench_serve run {i}: batched prefill TTFT p50 "
                f"{res['prefill_batched_ttft_p50_ms']} ms not under serial "
                f"{res['prefill_serial_ttft_p50_ms']} ms")
        runs.append({"result": res, "arms": watch.arms})
        emit("bench_serve_run", run=i, seconds=time.perf_counter() - t_run,
             result=res, arms=watch.arms,
             launches={k: v for k, v in totals.items() if v})
    del params
    torch.cuda.empty_cache()
    summary = {key: spread([r["result"][key] for r in runs])
               for key in SERVE_KEYS}
    summary["decode_tok_s"] = spread(
        [r["arms"]["engine"]["decode_tok_s"] for r in runs])
    report.update(
        model="LLAMA3_8B widths, 32 layers, bf16, random weights",
        env=SERVE_ENV, runs=SERVE_RUNS, summary=summary,
        token_agreement={pair: [
            (r["result"][f"{pair}_token_agreement"],
             r["result"][f"{pair}_first_difference"]) for r in runs]
            for pair in ("spec", "prefix")},
        seconds=time.perf_counter() - t0)
    return report, dict(launches)


# --- 2b. the slice bootstrap and the collective smokes ----------------------

SLICE_TIMEOUT_S = 90  # each launch of the bootstrap phase's subprocesses
HBM_COPY_MB, HBM_COPY_REPS = 64.0, 10  # icibandwidth's CLI defaults


def rank_launcher():
    """tests/torch_ranks.py, the launcher the CPU tests start their
    ranks with (loaded by path: it is no package of the port)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_ranks", os.path.join(REPO, "tests", "torch_ranks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_workloads(R, argvs: list, envs: list,
                  timeout: float = SLICE_TIMEOUT_S) -> list:
    """``python -m <argv>`` once per (argv, env), all together, through
    torch_ranks.launch (``timeout`` for the launch, what outlives it
    killed, every process reaped); raises if any failed. Returns
    (stdout, stderr, seconds)."""
    results = R.launch([["-m", *argv] for argv in argvs], envs,
                       timeout=timeout)
    failed = [f"{' '.join(argv)}: rc {rc}\n{err[-3000:]}"
              for argv, (rc, _, err, _) in zip(argvs, results) if rc != 0]
    if failed:
        raise AssertionError("\n".join(failed))
    return [(out, err, seconds) for _, out, err, seconds in results]


def render_slice(root: str, n: int, port: int) -> list:
    """One config dir a host of an n-host slice, written as the slice
    daemon writes them (tpu_dra/computedomain/daemon/bootstrap.py
    render_bootstrap_env and write_bootstrap_files): bootstrap.env with
    daemon-0's DNS name as the coordinator, and peers.json, the only
    place that maps that name (to 127.0.0.1 here)."""
    names = [f"compute-domain-daemon-{i}" for i in range(n)]
    peers = [{"index": i, "nodeName": f"node-{i}", "ipAddress": "127.0.0.1",
              "dnsName": names[i], "status": "Ready"} for i in range(n)]
    dirs = []
    for i in range(n):
        env = {
            "TPU_WORKER_ID": str(i), "TPU_WORKER_HOSTNAMES": ",".join(names),
            "TPU_ACCELERATOR_TYPE": "", "TPU_TOPOLOGY": "",
            "JAX_COORDINATOR_ADDRESS": f"{names[0]}:{port}",
            "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(i),
        }
        d = os.path.join(root, f"cd-{i}")
        os.makedirs(d)
        with open(os.path.join(d, "bootstrap.env"), "w") as f:
            f.writelines(f"{k}={v}\n" for k, v in sorted(env.items()))
        with open(os.path.join(d, "peers.json"), "w") as f:
            json.dump(peers, f, indent=2)
        dirs.append(d)
    return dirs


@contextlib.contextmanager
def recorded(module, names: tuple):
    """Stand in for ``module``'s functions ``names`` while the body
    runs: each call is forwarded and a copy of its inputs kept, under
    its name, so a kernel can then be held against its plain version on
    exactly the inputs the path gave it."""
    def copy(a):
        return a.clone() if torch.is_tensor(a) else a

    calls = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def stand_in(name):
        def call(*args, **kw):
            calls[name].append(([copy(a) for a in args],
                                {k: copy(v) for k, v in kw.items()}))
            return saved[name](*args, **kw)
        return call

    for name in names:
        setattr(module, name, stand_in(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(module, name, saved[name])


def smoke_kernel_parity(A, DM, calls: dict) -> dict:
    """Each decode kernel against its plain version on every input the
    bf16 decode_smoke gave it (at the parity phase's bf16 bar); the MLP's
    inputs must take the tensor-core route."""
    out = {}
    for name, fn in (("decode_attention", A.decode_attention),
                     ("decode_mlp", DM.decode_mlp)):
        worst = {"max_abs_err": 0.0, "worst_err_over_limit": 0.0}
        for i, (args, kw) in enumerate(calls[name]):
            if name == "decode_mlp":
                route = DM._decode_mlp_route(args[0], mlp_weights(args[2]))
                if route != "sm90":
                    raise AssertionError(f"decode_smoke's MLP call {i}: "
                                         f"route {route}, want sm90")
            got = fn(*args, **{**kw, "impl": "cuda"})
            plain = fn(*args, **{**kw, "impl": "torch"})
            res = compare(f"decode_smoke {name} call {i} vs plain", got,
                          plain)
            for k in worst:
                worst[k] = max(worst[k], res[k])
        out[name] = {"calls": len(calls[name]), "shape": list(
            calls[name][0][0][0].shape), "rtol": BF16_RTOL, **worst}
    return out


def bootstrap_phase(kernels, BS, SM, IB, G, A, DM, rates) -> tuple:
    """matmul_smoke and decode_smoke on the card (decode_smoke's kernel
    launches counted, and each kernel held against its plain version on
    the inputs the smoke gave it), a world-1 NCCL group through
    bootstrap.rendezvous (initialize_from_env's path) running
    pmap_psum_smoke and measure_collectives, rendezvous_smoke as 2 gloo
    CPU ranks from rendered config dirs, and train --distributed with a
    1-process env. Returns (report, decode_smoke's launches)."""
    import tempfile

    R = rank_launcher()
    t_phase = time.perf_counter()
    out = {}
    out["matmul"] = SM.matmul_smoke(device="cuda")
    if not out["matmul"]["ok"]:
        raise AssertionError(f"matmul_smoke: {out['matmul']}")
    # The smoke's own model and dtype (SMOKE_LLAMA, bf16): the main path.
    # The timed call carries the recorder's input copies.
    kernels.reset_launches()
    with recorded(G, ("decode_attention", "decode_mlp")) as calls:
        decode = SM.decode_smoke(device="cuda")
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    steps = 2 * SM.SMOKE_LLAMA.n_layers * 15  # 2 calls x 15 decode steps
    if not (decode["ok"] and launches.get("decode_attention") == steps
            and launches.get("decode_mlp_sm90") == steps
            and all(len(c) == steps for c in calls.values())):
        raise AssertionError(f"decode_smoke: {decode}, launches {launches}")
    out["decode"] = {**decode, "launches": launches,
                     "vs_plain": smoke_kernel_parity(A, DM, calls),
                     "seconds": time.perf_counter() - t_phase}
    del calls
    # fp32: the kernels (decode.cu's fp32 build, decode_mlp.cu) against
    # the plain arm, the same call otherwise; tokens identical.
    fp32 = dataclasses.replace(SM.SMOKE_LLAMA, dtype=torch.float32,
                               param_dtype=torch.float32)
    arms, arm_launches = {}, {}
    for arm, cfg in (("kernels", fp32),
                     ("plain", dataclasses.replace(
                         fp32, decode_impl="torch", decode_mlp_impl="torch"))):
        kernels.reset_launches()
        report, arms[arm] = SM.decode_smoke(device="cuda", config=cfg,
                                            return_tokens=True)
        arm_launches[arm] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        out["decode"][f"fp32_{arm}_tok_s"] = report["decode_tok_s"]
    out["decode"]["fp32_launches"] = arm_launches
    if arm_launches != {"kernels": {"decode_attention": steps,
                                    "decode_mlp": steps}, "plain": {}}:
        raise AssertionError(f"decode_smoke fp32 launches: {arm_launches}")
    out["decode"]["fp32_tokens_identical"] = bool(
        torch.equal(arms["kernels"], arms["plain"]))
    if not out["decode"]["fp32_tokens_identical"]:
        raise AssertionError(f"decode_smoke fp32: kernels {arms['kernels']} "
                             f"vs plain {arms['plain']}")
    # A world-1 NCCL group. One card shows no fabric: NCCL puts no two
    # ranks on one GPU, so measure_collectives takes its hbm_copy probe.
    t0 = time.perf_counter()
    backend = BS.rendezvous(f"127.0.0.1:{R.free_port()}", 0, 1,
                            device="cuda", timeout_s=60)
    try:
        psum = SM.pmap_psum_smoke()
        bw = IB.measure_collectives(HBM_COPY_MB, HBM_COPY_REPS)
    finally:
        BS.shutdown()
    if backend != "nccl" or not psum["ok"] or psum["platform"] != "gpu":
        raise AssertionError(f"world-1 group: {backend} {psum}")
    gbps = bw["hbm_copy"]["gbps"]
    out["nccl_world1"] = {
        "backend": backend, "psum": psum, "collectives": bw,
        "hbm_copy_share_of_3_35_tb_s": gbps * 1e9 / rates[0],
        "seconds": time.perf_counter() - t0,
    }
    if not gbps > 0:
        raise AssertionError(f"hbm_copy: {bw}")
    with tempfile.TemporaryDirectory() as root:
        dirs = render_slice(root, 2, R.free_port())
        ranks = run_workloads(
            R, [["tpu_dra_torch.workloads.rendezvous_smoke", "--config-dir",
                 d, "--device", "cpu"] for d in dirs], [{}, {}])
    rdv = [json.loads(R.last_json(o)) for o, _, _ in ranks]
    if not (sorted(r["worker"] for r in rdv) == [0, 1]
            and all(r["psum"] == 3.0 and r["global_devices"] == 2
                    for r in rdv)
            and rdv[0]["loss"] == rdv[1]["loss"]):
        raise AssertionError(f"rendezvous_smoke: {rdv}")
    out["rendezvous_gloo"] = {"ranks": rdv, "seconds": ranks[-1][2]}
    (train_out, _, train_s), = run_workloads(
        R, [["tpu_dra_torch.workloads.train", "--distributed", "--model",
             "tiny", "--steps", "2"]],
        [{"JAX_NUM_PROCESSES": "1", "TPU_WORKER_ID": "0"}])
    if "'ok': True" not in train_out or "'device': 'cuda" not in train_out:
        raise AssertionError(f"train --distributed: {train_out}")
    out["train_distributed"] = {"stdout": train_out.strip()[-400:],
                                "seconds": train_s}
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


# --- engine_sharded: the (batch x model) decode mesh ------------------------

SHARDED_WORLD2_TIMEOUT_S = 150  # the two shardbench ranks' launch
SHARDED_FP32_COSINE = 0.9999998  # the 2-layer fp32 decode-step logit bar


@contextlib.contextmanager
def world1_nccl(BS):
    """A world-1 NCCL process group through bootstrap.rendezvous (the
    path initialize_from_env takes), as the bootstrap phase opens it."""
    R = rank_launcher()
    backend = BS.rendezvous(f"127.0.0.1:{R.free_port()}", 0, 1,
                            device="cuda", timeout_s=60)
    try:
        if backend != "nccl":
            raise AssertionError(f"world-1 group on {backend}")
        yield backend
    finally:
        BS.shutdown()


def sharded_world1_engine(E, BS, kernels, cfg, params, ec, reqs, want_done,
                          want_launches) -> tuple:
    """The engine phase's requests through ``EngineConfig(sharded=True)``
    inside a world-1 NCCL group: a (1, 1) mesh that keeps the config
    (the kernels), issues no collective, launches what the engine phase
    launched and gives its tokens. Returns (report, launches)."""
    t0 = time.perf_counter()
    with world1_nccl(BS):
        eng, done, launches, wall = serve(
            E, kernels, cfg, params, dataclasses.replace(ec, sharded=True),
            reqs)
    out = {
        "mesh": eng.mesh.shape, "config_kept": eng.config is cfg,
        "collectives": dict(eng.mesh.collectives),
        "decode_steps": eng.decode_steps,
        "launches_equal_engine_phase": launches == want_launches,
        "first_difference": first_difference(want_done, done),
        "wall_seconds": wall, "seconds": time.perf_counter() - t0,
    }
    if not (out["mesh"] == {"batch": 1, "model": 1} and out["config_kept"]
            and not out["collectives"] and out["launches_equal_engine_phase"]
            and out["first_difference"] is None):
        raise AssertionError(f"engine_sharded world 1: {out}, launches "
                             f"{launches} vs {want_launches}")
    return out, launches


def sharded_world1_generate(BS, G, MS, kernels, cfg, params, prompt, new,
                            want_tokens, want_launches) -> tuple:
    """``greedy_generate`` over ``shard_decode_params`` of a world-1
    NCCL group's (1, 1) mesh: the generate phase's tokens and launches,
    no collective. Returns (report, launches)."""
    t0 = time.perf_counter()
    with world1_nccl(BS):
        mesh = MS.build_decode_mesh(cfg)
        shard = MS.shard_decode_params(mesh, params)
        kernels.reset_launches()
        out = G.greedy_generate(cfg, shard, prompt, new)
        launches = dict(kernels.LAUNCHES)
    rep = {"mesh": mesh.shape, "collectives": dict(mesh.collectives),
           "tokens_identical": bool(torch.equal(out[:, prompt.shape[1]:],
                                                want_tokens)),
           "launches_equal_generate_phase": launches == want_launches,
           "seconds": time.perf_counter() - t0}
    if not (rep["mesh"] == {"batch": 1, "model": 1} and not rep["collectives"]
            and rep["tokens_identical"]
            and rep["launches_equal_generate_phase"]):
        raise AssertionError(f"generate sharded world 1: {rep}, launches "
                             f"{launches} vs {want_launches}")
    return rep, launches


#: The world-2 ranks' sharded engine arms (fp32 greedy and sampled, the
#: bf16 arm) whose decode kernel launches shardbench reckons.
SHARDED_ENGINE_ARMS = ("engine_greedy", "engine_sampled", "engine_bf16")


def sharded_world2_card(R) -> tuple:
    """shardbench as two ranks sharing the card over gloo (NCCL puts no
    two ranks on one GPU), from rendered config dirs, at Llama-3-8B
    widths cut to 2 layers in fp32: the world's (1, 2) mesh against the
    unsharded runs of the same config, greedy_generate and the engine
    (greedy and sampled), the kernels running on each rank's shard; the
    bf16 engine arm; the kernels' shards against the unsharded calls.
    gloo takes the CUDA tensors of the gathers; ``host_staged`` records
    whether a profiler trace of one gather shows it copying them through
    host memory (None: the trace saw no copy). Returns (report, the
    launches of both ranks' sharded runs, summed by counter)."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        dirs = render_slice(root, 2, R.free_port())
        ranks = run_workloads(R, [[
            "tpu_dra_torch.workloads.shardbench", "--config-dir", d,
            "--device", "cuda:0", "--backend", "gloo", "--model",
            "llama3-8b", "--layers", "2", "--fallback-cosine",
            str(SHARDED_FP32_COSINE)] for d in dirs], [{}, {}],
            timeout=SHARDED_WORLD2_TIMEOUT_S)
    rep = json.loads(R.last_json(ranks[0][0]))
    rep["rank_seconds"] = [sec for _, _, sec in ranks]
    identical = (rep.get("greedy_parity_1x2")
                 and rep.get("engine_parity_greedy") == 6
                 and rep.get("engine_parity_sampled") == 6)
    rep["tokens_identical"] = bool(identical)
    names = " ".join(rep.get("gather_copies", {}))
    rep["host_staged"] = ("DtoH" in names and "HtoD" in names) if names \
        else None
    if not (rep["ok"] and rep["ranks_agree"] and rep["backend"] == "gloo"
            and rep["device"] == "cuda:0"
            and rep["mesh_shapes"][1] == {"batch": 1, "model": 2}):
        raise AssertionError(f"engine_sharded world 2: {rep}")
    mig = rep["migrate"]
    if not (mig["imported"] and mig["lossless"] and mig["same_sequence"]
            and mig["tokens_identical"] and mig["export_gathers"] == 2):
        raise AssertionError(f"engine_sharded world 2 migration: {mig}")
    # Each rank's arms: the decode kernels at their reckoned counts and
    # no plain call on the card (shardbench exits nonzero otherwise);
    # the kernels' shards bit for bit the unsharded calls'.
    launches = collections.Counter()
    by_rank = rep["launches_by_rank"]
    for rank, runs in enumerate(by_rank):
        for arm, run in runs.items():
            launches.update(run["launches"])
            if run["plain_on_card"] or (arm in SHARDED_ENGINE_ARMS and not (
                    run.get("reckoned_launches")
                    and all(run["launches"].get(k) == v
                            for k, v in run["reckoned_launches"].items()))):
                raise AssertionError(f"engine_sharded world 2 rank {rank} "
                                     f"{arm}: {run}")
    if len(by_rank) != 2 or not all(set(SHARDED_ENGINE_ARMS) <= set(runs)
                                    for runs in by_rank):
        raise AssertionError(f"engine_sharded world 2 arms: {by_rank}")
    ks = rep["kernel_shard_check"]
    bf16 = rep["engine_bf16"]
    if not (all(ks["bit_identical"].values())
            and bf16["first_step_logit_cosine"] >= BF16_COSINE):
        raise AssertionError(f"engine_sharded world 2 kernels: {ks}, bf16 "
                             f"arm {bf16}")
    return rep, launches


# --- train_sharded: sharded Llama training on the one card --------------------

#: (label, --mesh, --attention) of the train_sharded runs, in order; the
#: last runs only while the phase is within TRAIN_SHARDED_BUDGET_S.
TRAIN_SHARDED_RUNS = (
    ("sp2_ring", "sp=2", "ring"),
    ("tp2", "tp=2", "auto"),
    ("fsdp2", "fsdp=2", "auto"),
    ("sp2_ulysses", "sp=2", "ulysses"),
)
TRAIN_SHARDED_LAYERS, TRAIN_SHARDED_STEPS = 2, 2
TRAIN_SHARDED_BUDGET_S = 150.0
TRAIN_SHARDED_TIMEOUT_S = 150  # each launch of two ranks
# Step-1 loss gaps to the fp32 reference (relative) under one bf16 ulp
# (2^-8) of a mean over the b·s tokens count as equal.
TRAIN_SHARDED_GAP_FLOOR = 2.0 ** -8 / math.sqrt(TRAIN_BATCH * TRAIN_SEQ)
FLASH_COUNTERS = ("flash_fwd", "flash_fwd_sm90", "flash_bwd_dq",
                  "flash_bwd_dq_sm90", "flash_bwd_dkv", "flash_bwd_dkv_sm90")


def reckoned_flash_launches(attention: str, rank: int, layers: int) -> dict:
    """A train step's flash launches on one rank of a two-rank mesh, all
    on the wgmma route (bf16, hd 128): a layer's attention runs forward
    twice (remat "nothing" recomputes the block) and backward once. The
    ring's rank i (its sp coordinate, the mesh having no other axis)
    runs i + 1 chunk pairs, its diagonal and i full chunks; every other
    run one attention a layer (a head shard, a batch row, or Ulysses'
    head group over the whole sequence)."""
    pairs = rank + 1 if attention == "ring" else 1
    fwd, bwd = 2 * layers * pairs, layers * pairs
    return {"flash_fwd": fwd, "flash_fwd_sm90": fwd, "flash_bwd_dq": bwd,
            "flash_bwd_dq_sm90": bwd, "flash_bwd_dkv": bwd,
            "flash_bwd_dkv_sm90": bwd}


def unsharded_reference(T, cfg, init_params, tokens, steps: int) -> dict:
    """What the two-rank runs of ``cfg`` are held to, computed here on
    the card and released before the ranks start: the unsharded
    Trainer's losses on the ranks' weights (seed 0 on the card) and
    tokens, and step 1's fp32 reference loss (the weights upcast,
    reference attention)."""
    torch.cuda.empty_cache()
    trainer = T.Trainer(cfg, T.MeshConfig())
    state = trainer.init_state()  # seed 0 on the card, as every rank's
    step = trainer.make_train_step()
    unsharded = []
    for _ in range(steps):
        state, loss = step(state, tokens)
        unsharded.append(float(loss))
    del trainer, state, step
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    params.float()
    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32,
                                  attention_impl="reference")
    with torch.no_grad():
        loss_ref = float(T.loss_fn(T.build_model(ref_cfg), params, tokens))
    del params
    torch.cuda.empty_cache()
    return {"unsharded_losses": unsharded, "fp32_reference_loss": loss_ref,
            "unsharded_gap": abs(unsharded[0] - loss_ref) / abs(loss_ref)}


def two_rank_train(R, model: str, mesh: str, attention: str, layers: int,
                   ref: dict, launches: collections.Counter,
                   timeout: float) -> dict:
    """``train --distributed`` as two gloo ranks on the card (b=2,
    s=2048, ref's steps) and its bars against ``ref``
    (unsharded_reference): losses equal on both ranks and finite, step
    1's gap ratio at most BF16_GAP_RATIO, every step's flash launches as
    reckoned; raises on any. Adds the ranks' launches to ``launches``."""
    steps = len(ref["unsharded_losses"])
    argv = ["tpu_dra_torch.workloads.train", "--distributed", "--device",
            "cuda:0", "--backend", "gloo", "--model", model, "--layers",
            str(layers), "--mesh", mesh, "--attention", attention, "--steps",
            str(steps), "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    coordinator = f"127.0.0.1:{R.free_port()}"
    t0 = time.perf_counter()
    ranks = run_workloads(R, [argv, argv],
                          [R.rank_env(r, 2, coordinator) for r in range(2)],
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    res = [ast.literal_eval(R.last_json(o)) for o, _, _ in ranks]
    losses = [r["losses"] for r in res]
    loss_ref, unsharded = ref["fp32_reference_loss"], ref["unsharded_losses"]
    gap = abs(losses[0][0] - loss_ref) / abs(loss_ref)
    ratio = gap / max(ref["unsharded_gap"], TRAIN_SHARDED_GAP_FLOOR)
    run = {
        "mesh": res[0]["mesh"], "attention": attention, "layers": layers,
        "losses_by_rank": losses, "gap_to_fp32": gap, "gap_ratio": ratio,
        "rel_diff_vs_unsharded": [abs(a - u) / abs(u) for a, u in zip(
            losses[0], unsharded)],
        "step_ms_by_rank": [r["step_ms"] for r in res],
        "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in res],
        "launches_by_rank": [r["launches_per_step"] for r in res],
        "reckoned_launches_by_rank": [reckoned_flash_launches(
            attention, r["rank"], layers) for r in res],
        "collectives_by_rank": [r["collectives"] for r in res],
        "seconds": seconds,
    }
    bad = []
    if losses[0] != losses[1] or not np.isfinite(losses).all():
        bad.append("losses differ across ranks or are not finite")
    for r, want in zip(res, run["reckoned_launches_by_rank"]):
        for i, got in enumerate(r["launches_per_step"]):
            if got != want:
                bad.append(f"rank {r['rank']} step {i}: launches {got}, "
                           f"want {want}")
            launches.update(got)
    if ratio > BF16_GAP_RATIO:
        bad.append(f"step-1 loss gap ratio {ratio} above {BF16_GAP_RATIO}")
    if bad:
        raise AssertionError(f"{model} --mesh {mesh} --attention "
                             f"{attention}: {bad}: {run}")
    return run


def ranks_tokens(cfg) -> torch.Tensor:
    """train --distributed's batch (np.random.default_rng(1)) on the
    card."""
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).cuda()


def within_budget(out: dict, t_phase: float, budget: float) -> bool:
    """Whether the phase, at its seconds so far, has room for one more
    run as long as its longest so far."""
    elapsed = time.perf_counter() - t_phase
    longest = max((r["seconds"] for r in out["runs"].values()
                   if "seconds" in r), default=0.0)
    return elapsed + longest <= budget


def train_sharded_phase(R, T, cfg, init_params) -> tuple:
    """The train_sharded phase (see the module docstring): returns its
    report and the flash launches of every rank of every run, summed."""
    t_phase = time.perf_counter()
    ref = unsharded_reference(T, cfg, init_params, ranks_tokens(cfg),
                              TRAIN_SHARDED_STEPS)
    out = {"model": "LLAMA3_8B widths cut to 2 layers, bf16, remat nothing, "
                    "random weights; two gloo ranks on the one card",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_SHARDED_STEPS, **ref,
           "gap_floor": TRAIN_SHARDED_GAP_FLOOR,
           "gap_ratio_bar": BF16_GAP_RATIO, "runs": {}}
    launches = collections.Counter()
    for label, mesh, attention in TRAIN_SHARDED_RUNS:
        if label == "sp2_ulysses" and not within_budget(
                out, t_phase, TRAIN_SHARDED_BUDGET_S):
            out["runs"][label] = {
                "skipped": f"the phase at {time.perf_counter() - t_phase:.1f}"
                           f" s of its {TRAIN_SHARDED_BUDGET_S} s budget"}
            continue
        out["runs"][label] = two_rank_train(
            R, "llama3-8b", mesh, attention, TRAIN_SHARDED_LAYERS, ref,
            launches, TRAIN_SHARDED_TIMEOUT_S)
    out["seconds"] = time.perf_counter() - t_phase
    return out, {k: launches[k] for k in FLASH_COUNTERS}


# --- train_moe_sharded: Mixtral on a training mesh on the one card -------------

#: (label, --mesh, --attention, --layers) of the train_moe_sharded runs,
#: in order; the last runs only while the phase is within
#: TRAIN_MOE_BUDGET_S.
TRAIN_MOE_RUNS = (
    ("ep2", "ep=2", "auto", 2),
    ("sp2_ring", "sp=2", "ring", 1),
)
TRAIN_MOE_BUDGET_S = 120.0


def train_moe_sharded_phase(R, T, M) -> tuple:
    """The train_moe_sharded phase (see the module docstring): returns
    its report and the flash launches of every rank of every run,
    summed."""
    t_phase = time.perf_counter()
    out = {"model": "MIXTRAL_8X7B widths, bf16, remat nothing, random "
                    "weights; two gloo ranks on the one card",
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_SHARDED_STEPS,
           "gap_floor": TRAIN_SHARDED_GAP_FLOOR,
           "gap_ratio_bar": BF16_GAP_RATIO, "runs": {}}
    launches = collections.Counter()
    for label, mesh, attention, layers in TRAIN_MOE_RUNS:
        if label == "sp2_ring" and not within_budget(out, t_phase,
                                                     TRAIN_MOE_BUDGET_S):
            out["runs"][label] = {
                "skipped": f"the phase at {time.perf_counter() - t_phase:.1f}"
                           f" s of its {TRAIN_MOE_BUDGET_S} s budget"}
            continue
        t0 = time.perf_counter()
        cfg = dataclasses.replace(M.MIXTRAL_8X7B, n_layers=layers)
        ref = unsharded_reference(T, cfg, M.init_params, ranks_tokens(cfg),
                                  TRAIN_SHARDED_STEPS)
        run = two_rank_train(R, "mixtral-8x7b", mesh, attention, layers,
                             ref, launches, TRAIN_SHARDED_TIMEOUT_S)
        out["runs"][label] = {**ref, **run, "launch_seconds": run["seconds"],
                              "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    return out, {k: launches[k] for k in FLASH_COUNTERS}


# --- train_pipeline: the pp relay on the one card ------------------------------

TRAIN_PIPELINE_LAYERS, TRAIN_PIPELINE_MICROBATCHES = 2, 2
# The first step warms the ranks up (cuBLAS, the kernels' first calls);
# both are held to the bars, the second is the one timed.
TRAIN_PIPELINE_STEPS = 2
TRAIN_PIPELINE_TIMEOUT_S = 120  # the launch of two ranks
# Each gradient leaf's cosine to the unpipelined gradient, on each rank
# (the CPU twin's bar, tests/test_torch_pipeline.py).
TRAIN_PIPELINE_COSINE = 0.999


def reckoned_pipeline_launches(layers: int, pp: int,
                               microbatches: int) -> dict:
    """A pipelined forward and backward's flash launches on one rank,
    all on the wgmma route (bf16, hd 128): every tick, the bubble ones
    included, runs the stage's layers forward once (no remat, as JAX's
    pipelined forward) and backward once."""
    n = (microbatches + pp - 1) * layers // pp
    return {k: n for k in FLASH_COUNTERS}


def train_pipeline_phase(R, T, cfg, init_params) -> tuple:
    """The train_pipeline phase (see the module docstring): returns its
    report and the flash launches of both ranks' steps, summed."""
    t_phase = time.perf_counter()
    ref = unsharded_reference(T, cfg, init_params, ranks_tokens(cfg), 1)
    argv = ["tpu_dra_torch.workloads.pipestep", "--device", "cuda:0",
            "--backend", "gloo", "--model", "llama3-8b", "--layers",
            str(cfg.n_layers), "--seq", str(TRAIN_SEQ), "--steps",
            str(TRAIN_PIPELINE_STEPS)]
    coordinator = f"127.0.0.1:{R.free_port()}"
    t0 = time.perf_counter()
    ranks = run_workloads(R, [argv, argv],
                          [R.rank_env(r, 2, coordinator) for r in range(2)],
                          timeout=TRAIN_PIPELINE_TIMEOUT_S)
    launch_s = time.perf_counter() - t0
    res = [json.loads(R.last_json(o)) for o, _, _ in ranks]
    loss_ref = ref["fp32_reference_loss"]
    gap = abs(res[0]["loss"] - loss_ref) / abs(loss_ref)
    ratio = gap / max(ref["unsharded_gap"], TRAIN_SHARDED_GAP_FLOOR)
    want = reckoned_pipeline_launches(cfg.n_layers, 2,
                                      TRAIN_PIPELINE_MICROBATCHES)
    out = {
        "model": f"LLAMA3_8B widths cut to {cfg.n_layers} layers, one a "
                 "stage, bf16, random weights; two gloo ranks on the one "
                 "card",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "pp": 2,
        "microbatches": TRAIN_PIPELINE_MICROBATCHES,
        "steps": TRAIN_PIPELINE_STEPS, **ref,
        "gap_floor": TRAIN_SHARDED_GAP_FLOOR,
        "gap_ratio_bar": BF16_GAP_RATIO,
        "losses_by_rank": [r["losses"] for r in res],
        "gap_to_fp32": gap, "gap_ratio": ratio,
        "unpipelined_loss_by_rank": [r["unpipelined_loss"] for r in res],
        "stage_layers_by_rank": [r["stage_layers"] for r in res],
        "layer_grads_nonzero_by_rank": [r["layer_grads_nonzero"]
                                        for r in res],
        "min_leaf_cosine_by_rank": [min(r["leaf_cosines"].values())
                                    for r in res],
        "leaf_cosines_by_rank": [r["leaf_cosines"] for r in res],
        "step_ms_by_rank": [r["step_ms"] for r in res],
        "peak_memory_gb_by_rank": [r["peak_memory_gb"] for r in res],
        "launches_by_rank": [r["launches_per_step"] for r in res],
        "reckoned_launches_per_step": want,
        "collectives_by_rank": [r["collectives"] for r in res],
        "ppermute_by_rank": [r["collectives"].get("ppermute:pp")
                             for r in res],
        "launch_seconds": launch_s,
    }
    bad = []
    losses = out["losses_by_rank"]
    if losses[0] != losses[1] or not np.isfinite(losses).all():
        bad.append("losses differ across ranks or are not finite")
    if ratio > BF16_GAP_RATIO:
        bad.append(f"loss gap ratio {ratio} above {BF16_GAP_RATIO}")
    for r, o in enumerate(res):
        if (o["batch"], o["microbatches"]) != (
                TRAIN_BATCH, TRAIN_PIPELINE_MICROBATCHES):
            bad.append(f"rank {r}: batch {o['batch']} in "
                       f"{o['microbatches']} microbatches")
        if o["stage_layers"] != [f"layer_{r}"] or not all(
                o["layer_grads_nonzero"].values()):
            bad.append(f"rank {r}: stage layers {o['stage_layers']}, "
                       f"nonzero {o['layer_grads_nonzero']}")
        # Every leaf's gradient is the unpipelined one's direction: a
        # relay backward that drops or misroutes a cotangent (the
        # input's sum over pp, an inverse hand-off) leaves a leaf zero
        # (cosine nan) or turned.
        low = {n: c for n, c in o["leaf_cosines"].items()
               if not c >= TRAIN_PIPELINE_COSINE}
        if low:
            bad.append(f"rank {r}: leaf cosines below "
                       f"{TRAIN_PIPELINE_COSINE}: {low}")
    replicated = [{n: c for n, c in o["leaf_cosines"].items()
                   if not n.startswith("layer_")} for o in res]
    if replicated[0] != replicated[1]:
        bad.append(f"embed/final_norm/lm_head cosines differ across ranks: "
                   f"{replicated}")
    launches = collections.Counter()
    for o in res:
        for i, got in enumerate(o["launches_per_step"]):
            if got != want:
                bad.append(f"rank {o['rank']} step {i}: launches {got}, "
                           f"want {want}")
            launches.update(got)
    if bad:
        raise AssertionError(f"train_pipeline: {bad}: {out}")
    out["seconds"] = time.perf_counter() - t_phase
    return out, {k: launches[k] for k in FLASH_COUNTERS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import tpu_dra_torch.serving as SV
    from tpu_dra_torch import kernels
    from tpu_dra_torch.serving import disaggbench as SDB
    from tpu_dra_torch.serving import fabricbench as SFB
    from tpu_dra_torch.serving import faultbench as SFT
    from tpu_dra_torch.workloads import bootstrap as BS
    from tpu_dra_torch.workloads import decodebench as DB
    from tpu_dra_torch.workloads import engine as E
    from tpu_dra_torch.workloads import enginebench as EB
    from tpu_dra_torch.workloads import generate as G
    from tpu_dra_torch.workloads import icibandwidth as IB
    from tpu_dra_torch.workloads import paged_kv as P
    from tpu_dra_torch.workloads import quantize as Q
    from tpu_dra_torch.workloads import sampling as S
    from tpu_dra_torch.workloads import smoke as SM
    from tpu_dra_torch.workloads import specdraft as SD
    from tpu_dra_torch.workloads import train as T
    from tpu_dra_torch.workloads.models import mixtral as M
    from tpu_dra_torch.workloads.models.llama import (
        LLAMA3_8B,
        TINY_LLAMA,
        init_params,
        num_params,
        train_flops_per_token,
    )
    from tpu_dra_torch.workloads.ops import attention as A
    from tpu_dra_torch.workloads.ops import decode_mlp as DM
    from tpu_dra_torch.workloads.ops import int8mm as I8
    from tpu_dra_torch.workloads.ops import sample as SP
    from tpu_dra_torch.workloads.parallel import mesh as MS

    t_start = time.perf_counter()
    # --- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    rates = peaks(kind)
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, mem_bytes_per_s=rates[0],
         bf16_flops_per_s=rates[1])

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = kernels.build()
    mlp_build = mlp_sm90_build(kernels, report)
    gemv_build = gemv_sm90_build(kernels, report)
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: v["seconds"] for k, v in report.items()},
         ptxas={src: {short_name(fn): [p["registers"], p["smem_bytes"],
                                       p["spill_stores"]]
                      for fn, p in kernels.ptxas_report(v["log"]).items()}
                for src, v in report.items()},
         ptxas_columns=["registers", "smem_bytes", "spill_store_bytes"],
         sm90=sm90_build(kernels, report),
         decode_body=decode_body_build(kernels, report),
         gemv_sm90=gemv_build,
         mlp_sm90=mlp_build)

    # --- 2b. the slice bootstrap and the collective smokes -------------------
    boot, boot_launches = bootstrap_phase(kernels, BS, SM, IB, G, A,
                                           DM, rates)
    emit("bootstrap", nvidia_smi=smi, **boot)

    # --- 3. parity at 8B widths ------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1234)
    parity = {}
    for label, lengths in (
        ("", [0, 1, 15, 16, 17, 255, 512, 1000]),
        ("split_boundaries", [63, 64, 65, 127, 128, 129, 1023, 1024]),
        ("long", [8192]),
    ):
        q, kp, vp, tables, lens = paged_inputs(gen, lengths)
        for name, (k_, v_, sc) in (
            ("paged_decode_attention", (kp, vp, {})),
            ("paged_decode_attention_int8", int8_pools(Q, kp, vp)),
        ):
            res = paged_parity(A, name, q, k_, v_, sc, tables, lens)
            if label:
                parity[name][label] = res
            else:
                parity[name] = res
        del q, kp, vp, tables, lens, k_, v_, sc
    # Prefix sharing: all slots alias the same pages, then read private
    # copies of them; bit-identical outputs.
    for name, int8 in (("paged_decode_attention", False),
                       ("paged_decode_attention_int8", True)):
        parity[name]["aliased_table"] = aliased_table_parity(A, P, Q, gen,
                                                             int8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in MLP_PARITY_ROWS:
        x, scale, tree = mlp_inputs(gen, b)
        route = DM._decode_mlp_route(x, mlp_weights(tree))
        if route != "sm90":
            raise AssertionError(f"decode_mlp b={b}: route {route}, want "
                                 f"sm90")
        n0 = kernels.LAUNCHES["decode_mlp_sm90"]
        got = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        launched = kernels.LAUNCHES["decode_mlp_sm90"] - n0
        plain = DM.decode_mlp(x, scale, tree, 1e-5, impl="torch")
        ref = DM.decode_mlp(x, scale, tree, 1e-5, impl="reference")
        again = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        torch.cuda.synchronize()
        blocks = DM.row_blocks(b, "sm90")
        if launched != len(blocks):
            raise AssertionError(f"decode_mlp b={b}: {launched} launches, "
                                 f"want one a block of {blocks}")
        plans = [mlp_plan_dict(DM.mlp_sm90_plan(hi - lo, 4096, 14336, sms))
                 for lo, hi in blocks]
        parity[f"decode_mlp_b{b}"] = {
            "route": route, "launches": launched,
            **({"plan": plans[0]} if len(plans) == 1 else
               {"row_blocks": blocks, "plans": plans}),
            "vs_plain": compare(f"mlp b={b} vs plain", got, plain),
            "vs_reference": compare(f"mlp b={b} vs reference", got, ref),
            "rerun_bit_identical": bool(torch.equal(got, again)),
        }
        if not parity[f"decode_mlp_b{b}"]["rerun_bit_identical"]:
            raise AssertionError("decode_mlp reruns must give identical bits")
        del x, scale, tree, got, plain, ref, again
    # decode_mlp.cu, which serves the simt route (fp32), launched
    # directly (not counted) at fp32 B = 8 and at bf16 B = 32 (the
    # batches it served in bf16 before the tensor-core kernel took
    # 17-64 rows), and at fp32 B = 128 through the wrapper (two blocks
    # of 64 rows on the simt route).
    for label, b, dtype, want in (
            ("fp32_b8", 8, torch.float32, "simt"),
            ("bf16_b32", 32, torch.bfloat16, "sm90"),
            ("fp32_b128", 128, torch.float32, "simt")):
        x, scale, tree = mlp_inputs(gen, b)
        x, scale = x.to(dtype), scale.to(dtype)
        tree = {k: {"kernel": v["kernel"].to(dtype)} for k, v in tree.items()}
        ws = mlp_weights(tree)
        route = DM._decode_mlp_route(x, ws)
        if b <= DM.ROW_BLOCKS["simt"]:
            old = DM._simt_decode_mlp(x, scale, *ws, 1e-5)
            old_again = DM._simt_decode_mlp(x, scale, *ws, 1e-5)
        else:
            old = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
            old_again = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        plain = DM.decode_mlp(x, scale, tree, 1e-5, impl="torch")
        ref = DM.decode_mlp(x, scale, tree, 1e-5, impl="reference")
        torch.cuda.synchronize()
        name = f"decode_mlp_simt_{label}"
        parity[name] = {"route": route,
                        "rerun_bit_identical": bool(torch.equal(
                            old, old_again))}
        if dtype == torch.float32:
            parity[name]["vs_plain"] = compare_fp32(name, old, plain)
        else:
            parity[name]["vs_plain"] = compare(f"{name} vs plain", old,
                                               plain)
            parity[name]["vs_reference"] = compare(f"{name} vs reference",
                                                   old, ref)
        if route != want or not parity[name]["rerun_bit_identical"]:
            raise AssertionError(f"{name}: route {route}, want {want}: "
                                 f"{parity[name]}")
        del old, old_again, plain, ref
    del x, scale, tree, ws
    for m, k, n in INT8MM_PARITY:
        x, w_q, w_s = int8mm_inputs(Q, gen, m, k, n, zero_col=n // 3)
        got = I8.int8_matmul(x, w_q, w_s, impl="cuda")
        plain = I8.int8_matmul(x, w_q, w_s, impl="torch")
        ref = I8.int8_matmul(x, w_q, w_s, impl="reference")
        again = I8.int8_matmul(x, w_q, w_s, impl="cuda")
        torch.cuda.synchronize()
        name = f"int8mm_m{m}_k{k}_n{n}"
        parity[name] = {
            "route": I8._int8mm_route(x, w_q),
            "vs_plain": compare(f"{name} vs plain", got, plain),
            "vs_reference": compare(f"{name} vs reference", got, ref),
            "zero_column_exact_zero": bool(torch.all(got[:, n // 3] == 0)),
            "rerun_bit_identical": bool(torch.equal(got, again)),
        }
        if parity[name]["route"] == "gemv_sm90":
            parity[name]["plan"] = I8.gemv_sm90_plan(
                m, k, n, torch.cuda.get_device_properties(0)
                .multi_processor_count)._asdict()
            if parity[name]["plan"]["planes"] != gemv_planes_of(m):
                raise AssertionError(f"{name}: plan {parity[name]['plan']}")
        if parity[name]["route"] == "gemv_sm90" and m > 16:
            # The wgmma tile, which served these rows before the GEMV's
            # wgmma body, on the same inputs.
            tile = int8mm_tile(kernels, I8, x, w_q, w_s)
            tile_again = int8mm_tile(kernels, I8, x, w_q, w_s)
            torch.cuda.synchronize()
            parity[name]["sm90_tile"] = {
                "vs_plain": compare(f"{name} sm90 tile vs plain", tile,
                                    plain),
                "vs_reference": compare(f"{name} sm90 tile vs reference",
                                        tile, ref),
                "zero_column_exact_zero": bool(torch.all(
                    tile[:, n // 3] == 0)),
                "rerun_bit_identical": bool(torch.equal(tile, tile_again)),
            }
            if not (parity[name]["sm90_tile"]["zero_column_exact_zero"]
                    and parity[name]["sm90_tile"]["rerun_bit_identical"]):
                raise AssertionError(
                    f"{name} sm90 tile: {parity[name]['sm90_tile']}")
            del tile, tile_again
        elif parity[name]["route"] == "gemv_sm90":
            # int8mm.cu's GEMV on the same inputs.
            old = int8mm_gemv(kernels, I8, x, w_q, w_s)
            old_again = int8mm_gemv(kernels, I8, x, w_q, w_s)
            torch.cuda.synchronize()
            parity[name]["old_gemv"] = {
                "vs_plain": compare(f"{name} old gemv vs plain", old, plain),
                "vs_reference": compare(f"{name} old gemv vs reference",
                                        old, ref),
                "zero_column_exact_zero": bool(torch.all(
                    old[:, n // 3] == 0)),
                "rerun_bit_identical": bool(torch.equal(old, old_again)),
            }
            if not (parity[name]["old_gemv"]["zero_column_exact_zero"]
                    and parity[name]["old_gemv"]["rerun_bit_identical"]):
                raise AssertionError(
                    f"{name} old gemv: {parity[name]['old_gemv']}")
            del old, old_again
        if parity[name]["route"] == "sm90":
            parity[name]["tile_rows"] = I8._sm90_rows(m, n, x.device)
            # int8mm.cu's WMMA tile on the same inputs.
            wmma = int8mm_wmma(kernels, I8, x, w_q, w_s)
            wmma_again = int8mm_wmma(kernels, I8, x, w_q, w_s)
            torch.cuda.synchronize()
            parity[name]["wmma"] = {
                "vs_plain": compare(f"{name} wmma vs plain", wmma, plain),
                "vs_reference": compare(f"{name} wmma vs reference", wmma,
                                        ref),
                "zero_column_exact_zero": bool(torch.all(
                    wmma[:, n // 3] == 0)),
                "rerun_bit_identical": bool(torch.equal(wmma, wmma_again)),
            }
            if not (parity[name]["wmma"]["zero_column_exact_zero"]
                    and parity[name]["wmma"]["rerun_bit_identical"]):
                raise AssertionError(f"{name} wmma: {parity[name]['wmma']}")
            del wmma, wmma_again
        if n in (14336, 4096) and m in (1, 8, 1024):
            parity[name]["fp32_vs_plain"] = compare_fp32(
                name, I8.int8_matmul(x.float(), w_q, w_s, impl="cuda"),
                I8.int8_matmul(x.float(), w_q, w_s, impl="torch"))
        if not (parity[name]["zero_column_exact_zero"]
                and parity[name]["rerun_bit_identical"]
                and parity[name]["route"] == int8mm_route_of(m)):
            raise AssertionError(f"{name}: {parity[name]}")
        del x, w_q, w_s, got, plain, ref, again
    for int8 in (False, True):
        name = "decode_attention_int8" if int8 else "decode_attention"
        parity[name] = {}
        for b, max_seq, lengths in (
            (8, 1024, (1, 63, 64, 65, 129, 255, 256, 257, 1000)),
            (1, 8192, (8191, 8192)),
        ):
            q, k_, v_, sc = contiguous_inputs(Q, gen, b=b, max_seq=max_seq,
                                              int8=int8)
            for length in lengths:
                key = f"length_{length}" + ("_b1" if b == 1 else "")
                parity[name][key] = contiguous_parity(
                    A, f"{name} b={b} L={length}", q, k_, v_, sc, length)
            zero = A.decode_attention(q, k_, v_, 0, **sc, impl="cuda")
            if not bool(torch.all(zero == 0)):
                raise AssertionError(f"{name}: length 0 must give exact "
                                     f"zeros")
            del q, k_, v_, sc
    parity["decode_grid"] = grid_parity(A, Q, gen)
    parity.update(flash_parity(A, gen))
    emit("parity", **parity)

    # --- 4. kernel times -----------------------------------------------------
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timing = {}
    for label, lengths in (("", [512] * 8), ("_long", [8192])):
        q, kp, vp, tables, lens = paged_inputs(gen, lengths)
        pools = [("paged_decode_attention", kp, vp, {})]
        if not label:
            pools.append(("paged_decode_attention_int8",
                          *int8_pools(Q, kp, vp)))
        for name, k_, v_, sc in pools:
            timing[name + label] = paged_timing(
                A, q, k_, v_, sc, tables, lens, lengths, rates, flush)
        del q, kp, vp, tables, lens, pools, k_, v_, sc
    # Past Llama-3-8B's shape: Llama-3.2-3B's heads (n_rep 3 in a group of
    # 4) and head dim 256 (the tensor-core body on warp pairs).
    for label, kvh, n_rep, hd in (("_3b", 8, 3, 128), ("_hd256", 8, 2, 256)):
        lengths = [512] * 8
        q, kp, vp, tables, lens = paged_inputs(gen, lengths, kvh=kvh,
                                               n_rep=n_rep, hd=hd)
        timing["paged_decode_attention" + label] = paged_timing(
            A, q, kp, vp, {}, tables, lens, lengths, rates, flush)
        del q, kp, vp, tables, lens
    for b in MLP_TIMING_ROWS:
        timing["decode_mlp" if b == 8 else f"decode_mlp_b{b}"] = mlp_timing(
            DM, gen, b, sms, rates, flush)
    timing.update(mlp_halves(DM, gen, rates, flush))
    # The tensor-core GEMV at every decode shape (M = 8 slots): gate and
    # up, the lm_head, wq and wo, wk and wv, down; int8mm.cu's GEMV, the
    # kernel it replaced on this route, on the same inputs.
    for label, m, k, n in (("int8mm", 8, 4096, 14336),
                           ("int8mm_lm_head", 8, 4096, 128256),
                           ("int8mm_decode_wq", 8, 4096, 4096),
                           ("int8mm_decode_wk", 8, 4096, 1024),
                           ("int8mm_decode_down", 8, 14336, 4096)):
        x, w_q, w_s = int8mm_inputs(Q, gen, m, k, n)
        route = I8._int8mm_route(x, w_q)
        if route != "gemv_sm90":
            raise AssertionError(f"{label}: route {route}, want gemv_sm90")
        nbytes = k * n + n * 4 + m * k * 2 + m * n * 2
        call = functools.partial(I8.int8_matmul, x, w_q, w_s, impl="cuda")
        ms = time_ms(call, flush)
        host_ms = time_ms(call, flush, shield=False)
        old_ms = time_ms(functools.partial(int8mm_gemv, kernels, I8, x, w_q,
                                           w_s), flush)
        plain_ms = time_ms(
            lambda: I8.int8_matmul(x, w_q, w_s, impl="torch"), flush)
        # Yardstick only: no PyTorch call takes int8 weights with
        # per-column scales; a bf16 matmul on a copy dequantized ahead.
        w_bf = (w_q.float() * w_s).to(torch.bfloat16)
        dense_ms = yardstick_ms(lambda: x @ w_bf, flush)
        timing[label] = {
            "shape": f"M={m}, K={k}, N={n}, bf16 x, int8 W",
            "route": route,
            "plan": I8.gemv_sm90_plan(m, k, n, sms)._asdict(),
            "ms": ms, "ms_with_host": host_ms, "old_gemv_ms": old_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "dequantized_bf16_matmul_ms": dense_ms,
            **bound(nbytes, 2 * m * k * n, rates),
        }
        row = timing[label]
        row["share_of_bound"] = row["bound_ms"] / ms
        row["old_over_kernel"] = old_ms / ms
        if isinstance(dense_ms, float):
            row["dequantized_over_kernel"] = dense_ms / ms
        del x, w_q, w_s, w_bf
    timing.update(int8mm_prefill_timing(kernels, I8, Q, gen, rates, flush))
    timing.update(int8mm_wide_timing(kernels, I8, Q, gen, sms, rates, flush))
    for label, int8, b, max_seq, length, n_rep, hd in (
        ("decode_attention", False, 8, 1024, 512, 4, 128),
        ("decode_attention_int8", True, 8, 1024, 512, 4, 128),
        ("decode_attention_long", False, 1, 8192, 8192, 4, 128),
        ("decode_attention_hd256", False, 8, 1024, 512, 2, 256),
    ):
        q, k_, v_, sc = contiguous_inputs(Q, gen, b=b, max_seq=max_seq,
                                          n_rep=n_rep, hd=hd, int8=int8)
        timing[label] = contiguous_timing(A, q, k_, v_, sc, length, rates,
                                          flush)
        del q, k_, v_, sc
    timing.update(flash_timing(A, kernels, gen, rates, flush))
    del flush
    emit("timing", iters=TIMING_ITERS, **timing)

    # --- 4b. the fused pick against its plain version -------------------------
    sampling = sampling_phase(S, SP, G, kernels, rates)
    emit("sampling", **sampling)

    # --- 5. small model: the card vs the CPU -----------------------------------
    tiny = dataclasses.replace(
        TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32,
    )
    tparams = init_params(tiny, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    trace = [
        (f"t{i}", rng.integers(1, tiny.vocab_size,
                               rng.integers(3, 30)).astype(np.int32),
         int(rng.integers(4, 12)))
        for i in range(5)
    ]
    tiny_out = {}
    for label, quant in (("bf_config", {}),
                         ("w8kv8", {"kv_quant": "int8",
                                    "weight_quant": "int8"})):
        tec = E.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                             scan_chunk=3, prefill_chunk=8, **quant)
        outs = {
            dev: E.Engine(tiny, tparams, tec, device=dev).run([
                E.Request(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n in trace
            ])
            for dev in ("cuda", "cpu")
        }
        tiny_out[f"engine_{label}_token_agreement"] = float(np.mean([
            np.mean(outs["cuda"][r].tokens == outs["cpu"][r].tokens)
            for r, _, _ in trace
        ]))
    prompt = rng.integers(1, tiny.vocab_size, (3, 20)).astype(np.int32)
    for kvq in ("none", "int8"):
        for wq in ("none", "int8"):
            outs = [
                G.greedy_generate(tiny, tparams, prompt, 10, kv_quant=kvq,
                                  weight_quant=wq, device=dev).numpy()
                for dev in ("cuda", "cpu")
            ]
            tiny_out[f"generate_kv_{kvq}_w_{wq}_identical"] = bool(
                np.array_equal(*outs))
    twin = dataclasses.replace(tiny, dim=256,  # tests/test_torch_train.py
                               ffn_dim=512)
    twin_tokens = np.random.default_rng(8).integers(
        0, twin.vocab_size, (2, 64)).astype(np.int32)
    twin_losses = {}
    for dev in ("cuda", "cpu"):
        tr = T.Trainer(twin, device=dev)
        st = tr.init_state(torch.Generator().manual_seed(0))
        step = tr.make_train_step()
        twin_losses[dev] = []
        for _ in range(3):
            st, loss = step(st, twin_tokens)
            twin_losses[dev].append(float(loss))
    tiny_out["train_losses"] = twin_losses
    tiny_out["train_loss_rel_diff"] = float(np.max(
        np.abs(np.subtract(twin_losses["cuda"], twin_losses["cpu"]))
        / np.abs(twin_losses["cpu"])))
    # Prefix sharing (a 14-token prefix: a frozen boundary page) and a
    # drain of the same trace: shared against private and drained
    # against undrained on the card, shared on the card against the CPU.
    ptrace = prefix_trace(tiny.vocab_size, 5, 20, (2, 8), 8, seed=6)
    pec = E.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                         scan_chunk=3, prefill_chunk=8)
    pruns = {}
    for label, dev, plen in (("shared", "cuda", 14), ("private", "cuda", 0),
                             ("shared_cpu", "cpu", 14)):
        e = E.Engine(tiny, tparams, pec, device=dev)
        pruns[label] = e.run(prefix_requests(E, ptrace, plen))
        pool_whole_and_zero(e, f"tiny prefix {label}")
        if plen and not (e.prefix_attached >= 2 and e.cow_copies >= 2):
            raise AssertionError(f"tiny prefix {label}: attached "
                                 f"{e.prefix_attached}, forks {e.cow_copies}")
    gate = E.EventGate()
    pruns["drained"], drill = drain_drill(
        E, E.Engine(tiny, tparams, pec, gate=gate, device="cuda"), gate,
        prefix_requests(E, ptrace, 14), followers=2, after=1)
    pairs = {"shared_vs_private": ("shared", "private"),
             "drained_vs_undrained": ("drained", "shared"),
             "card_vs_cpu": ("shared", "shared_cpu")}
    tiny_out["prefix"] = {
        key: pair_report(G, tiny, tparams, ptrace, pruns[a], pruns[b])
        for key, (a, b) in pairs.items()}
    tiny_out["prefix"]["drain"] = drill
    emit("tiny", requests=len(trace), **tiny_out)
    low = {k: v["token_agreement"] for k, v in tiny_out["prefix"].items()
           if k in pairs and v["token_agreement"] < 0.97}
    if low:
        raise AssertionError(f"tiny prefix agreement under 0.97: {low}")
    if tiny_out["train_loss_rel_diff"] > FP32_REL:
        raise AssertionError(f"tiny train card vs CPU: {twin_losses}")
    if tiny_out["engine_bf_config_token_agreement"] < 0.97:
        raise AssertionError(f"tiny engine card vs CPU: {tiny_out}")
    if tiny_out["engine_w8kv8_token_agreement"] != 1.0 or not all(
        v for k, v in tiny_out.items() if k.endswith("_identical")
    ):
        raise AssertionError(f"tiny int8 / generate card vs CPU: {tiny_out}")

    # --- 6. engine at Llama-3-8B widths, bf16 --------------------------------
    cfg = LLAMA3_8B
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ec = E.EngineConfig(page_size=16, max_slots=8, max_pages_per_seq=64,
                        scan_chunk=8, prefill_chunk=128)
    rng = np.random.default_rng(0)
    reqs = [
        E.Request(
            rid=f"q{i}",
            prompt=rng.integers(1, cfg.vocab_size,
                                int(rng.integers(64, 513))).astype(np.int32),
            max_new_tokens=int(rng.integers(32, 65)),
        )
        for i in range(8)
    ]
    eng, done, launches, wall = serve(E, kernels, cfg, params, ec, reqs)
    greedy_done = dict(done)  # the profile below adds its own requests
    # engine_sharded (a): the same engine with sharded=True, world 1.
    sharded = {}
    sharded["engine_world1"], sharded_launches = sharded_world1_engine(
        E, BS, kernels, cfg, params, ec, reqs, greedy_done, launches)
    del params
    steps = eng.decode_steps
    want_attn = L * steps
    want_mlp = L * (steps + eng.prefill_single_token_buckets)
    if not (launches["paged_decode_attention"] == want_attn > 0
            and launches["decode_mlp"] == launches["decode_mlp_sm90"]
            == want_mlp > 0
            and launches["int8mm"] == launches["int8mm_sm90"]
            == launches["int8mm_gemv_sm90"] == launches["int8mm_gemv"] == 0
            and launches["paged_decode_attention_int8"] == 0):
        raise AssertionError(
            f"launches {launches} != {L} per layer per decode step "
            f"({steps} steps)"
        )
    engine_launches = launches
    summary = serve_summary(eng, done, launches, wall)

    profile = profile_decode(E, eng, [
        np.resize(r.prompt, 128) for r in reqs
    ])
    emit("profile", **profile)
    # The MLP of every steady decode step: the tensor-core kernel's two
    # passes, one launch each a layer, and none of decode_mlp.cu's.
    hold_window_launches("profile", profile,
                         {"decode_mlp": L, "decode_mlp_sm90": L})
    if "mlp_kernels" in profile:
        per_step = {k: v["launches_per_step"]
                    for k, v in profile["mlp_kernels"].items()}
        sm90 = sum(v for k, v in per_step.items() if MLP_SM90_KERNEL in k)
        if (round(sm90) != 2 * L
                or abs(profile["mlp_launches_per_step"] - sm90) > 1e-6):
            raise AssertionError(
                f"profile: decode MLP kernels a step {per_step}, want "
                f"{2 * L} {MLP_SM90_KERNEL} launches and nothing else")

    step_prompts = [r.prompt for r in reqs]
    steps_cmp = {"bf16": step_logits(E, I8, cfg, eng, step_prompts,
                                     STEP_VARIANTS)}
    del eng
    torch.cuda.empty_cache()
    # The same step at fp32 (the variants differ only in summation
    # order), and in bf16 with the depth cut to 2 layers (the rounding
    # noise of 2 layers, not amplified through 32).
    for name, c in (
        ("fp32", dataclasses.replace(
            cfg, dtype=torch.float32, param_dtype=torch.float32)),
        ("bf16_2_layers", dataclasses.replace(cfg, n_layers=2)),
    ):
        e = E.Engine(c, init_params(
            c, torch.Generator(device="cuda").manual_seed(0)), ec)
        steps_cmp[name] = step_logits(E, I8, c, e, step_prompts,
                                      STEP_VARIANTS)
        del e
        torch.cuda.empty_cache()
    emit(
        "engine", model="LLAMA3_8B widths, 32 layers, bf16, random weights",
        params=num_params(cfg), init_seconds=init_s, **summary,
        launches_per_decode_step={
            k: v / steps for k, v in launches.items()},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    emit("decode_step", **steps_cmp, gates=step_gates(steps_cmp))

    # --- 6b. decode_shapes: the decode kernels past Llama-3-8B's shape ----
    from tpu_dra_torch.workloads import shardbench as SB

    t_shapes = time.perf_counter()
    shapes, shapes_launches = llama32_3b_arm(E, G, I8, DM, kernels,
                                             init_params, cfg, ec, reqs)
    shapes["grid"], grid_launches = shape_grid_engines(
        E, SB, A, kernels, init_params, cfg)
    shapes_launches = collections.Counter(shapes_launches)
    shapes_launches.update(grid_launches)
    emit("decode_shapes", nvidia_smi=smi,
         seconds=time.perf_counter() - t_shapes, **shapes)

    # --- 7. engine at Llama-3-8B widths, int8 weights and KV ---------------
    torch.cuda.reset_peak_memory_stats()
    w8 = dataclasses.replace(ec, weight_quant="int8", kv_quant="int8")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    with RouteLog(I8) as w8_routes:
        eng, done, launches, wall = serve(E, kernels, cfg, params, w8, reqs)
    del params  # the engine holds the quantized tree only
    torch.cuda.empty_cache()
    steps = eng.decode_steps
    mm_per_pass = INT8MM_PER_LAYER * L + 1
    # Every launch with M > 128 (the prefill projections) on the wgmma
    # tile, every other (decode steps, the prefill lm_head over one row
    # a slot) on the tensor-core GEMV; int8mm.cu's GEMV never.
    routes = w8_routes.check("engine w8kv8")
    if not (launches["int8mm"] == mm_per_pass * (steps + eng.prefill_buckets)
            and launches["int8mm_sm90"] == routes["launches_by_route"].get(
                "sm90", 0) > 0
            and launches["int8mm_gemv_sm90"]
            == routes["launches_by_route"].get("gemv_sm90", 0) > 0
            and launches["int8mm_gemv"] == 0
            and launches["int8mm_sm90"] + launches["int8mm_gemv_sm90"]
            == launches["int8mm"]
            and launches["paged_decode_attention_int8"] == L * steps > 0
            and launches["paged_decode_attention"] == 0
            and launches["decode_mlp"] == launches["decode_mlp_sm90"] == 0):
        raise AssertionError(
            f"w8kv8 launches {launches}: want {mm_per_pass} int8mm per "
            f"forward pass ({steps} decode steps, {eng.prefill_buckets} "
            f"prefill buckets), the M > {GEMV_SM90_MAX_ROWS} ones on "
            f"int8mm_sm90 and the "
            f"rest on int8mm_gemv_sm90 {routes}, "
            f"{L} int8 paged per step, no fused MLP"
        )
    pools_zero = all(
        bool((layer[1:] == 0).all())
        for _, pool in eng.cache._pools() for layer in pool
    )
    if not (eng.cache.quantized and pools_zero):
        raise AssertionError("w8kv8: freed pages (values, scales) not zero")
    w8_launches = launches
    w8_summary = serve_summary(eng, done, launches, wall)
    w8_summary["int8mm_routes"] = routes
    w8_summary["launches_per_decode_step"] = {
        "int8mm": (launches["int8mm"] - mm_per_pass * eng.prefill_buckets)
        / steps,
        "paged_decode_attention_int8":
            launches["paged_decode_attention_int8"] / steps,
        "decode_mlp": launches["decode_mlp"] / steps,
    }
    w8_profile = profile_decode(E, eng, [
        np.resize(r.prompt, 128) for r in reqs
    ])
    emit("profile_w8kv8", **w8_profile)
    # One launch a GEMV call: the steady decode steps run the
    # tensor-core GEMV only, 225 a step, and no second kernel.
    hold_window_launches("profile_w8kv8", w8_profile,
                         {"int8mm": mm_per_pass,
                          "int8mm_gemv_sm90": mm_per_pass})
    if "int8mm_kernels" in w8_profile:
        gemv = [k for k in w8_profile["int8mm_kernels"]
                if GEMV_SM90_KERNEL in k]
        per_step = sum(w8_profile["int8mm_kernels"][k]["launches_per_step"]
                       for k in gemv)
        if (round(per_step) != mm_per_pass
                or abs(w8_profile["int8mm_launches_per_step"] - per_step)
                > 1e-6):
            raise AssertionError(
                f"profile_w8kv8: int8mm kernels a step "
                f"{w8_profile['int8mm_kernels']}, want {mm_per_pass} "
                f"{GEMV_SM90_KERNEL} launches and nothing else")
    # TTFT's first breakdown: one bucket of 8 rows x a 128-token chunk.
    emit("profile_prefill_w8kv8", **profile_prefill(E, I8, eng, [
        np.resize(r.prompt, 256) for r in reqs
    ]))
    w8_cmp = {"bf16": step_logits(E, I8, cfg, eng, step_prompts,
                                  W8_STEP_VARIANTS)}
    del eng
    torch.cuda.empty_cache()
    for name, c in (
        ("fp32", dataclasses.replace(
            cfg, dtype=torch.float32, param_dtype=torch.float32)),
        ("bf16_2_layers", dataclasses.replace(cfg, n_layers=2)),
    ):
        e = E.Engine(c, init_params(
            c, torch.Generator(device="cuda").manual_seed(0)), w8)
        torch.cuda.empty_cache()
        w8_cmp[name] = step_logits(E, I8, c, e, step_prompts,
                                   W8_STEP_VARIANTS)
        del e
        torch.cuda.empty_cache()
    emit("engine_w8kv8",
         model="LLAMA3_8B widths, 32 layers, bf16 activations, int8 "
               "weights and KV, random weights",
         **w8_summary,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("decode_step_w8kv8", **w8_cmp, gates=step_gates(w8_cmp))

    # --- 7b. the sampled engine ------------------------------------------------
    sampled = {"temperature": 0.8, "top_k": 40, "sample_seed": 11}
    sec = dataclasses.replace(ec, **sampled)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng, s_done, launches, wall = serve(E, kernels, cfg, params, sec, reqs)
    s_done = dict(s_done)  # the profile below adds its own requests
    steps = eng.decode_steps
    want = {"paged_decode_attention": L * steps,
            "decode_mlp": L * (steps + eng.prefill_single_token_buckets),
            "decode_mlp_sm90": L * (steps + eng.prefill_single_token_buckets),
            "sample_pick": steps + len(reqs), "int8mm": 0}
    if steps <= 0 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"engine_sampled: launches {launches}, want "
                             f"{want}")
    sampled_launches = launches
    s_summary = serve_summary(eng, s_done, launches, wall)
    s_profile = profile_decode(E, eng, [np.resize(r.prompt, 128)
                                        for r in reqs])
    del eng
    torch.cuda.empty_cache()
    _, s_oracle, _, _ = serve(
        E, kernels, cfg, params,
        dataclasses.replace(sec, fused=False, contiguous=True), reqs)
    del params
    torch.cuda.empty_cache()
    if first_difference(s_done, s_oracle) is not None:
        raise AssertionError(
            f"engine_sampled: fused vs unfused contiguous differ at "
            f"{first_difference(s_done, s_oracle)}")
    extra = None
    if "kernel_launches_per_step" in s_profile and (
            "kernel_launches_per_step" in profile):
        extra = (s_profile["kernel_launches_per_step"]
                 - profile["kernel_launches_per_step"])
        if extra > 16:
            raise AssertionError(
                f"engine_sampled: {extra} more launches a decode step than "
                f"greedy (bar 16)")
    tsec = E.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                          scan_chunk=3, prefill_chunk=8, **sampled)
    tiny_sampled = {
        dev: E.Engine(tiny, tparams, tsec, device=dev).run([
            E.Request(rid=r, prompt=p, max_new_tokens=n)
            for r, p, n in trace])
        for dev in ("cuda", "cpu")
    }
    identical_or_explain(G, tiny, tparams, trace, tiny_sampled["cuda"],
                         tiny_sampled["cpu"], "tiny sampled card vs CPU")
    emit("engine_sampled",
         model="LLAMA3_8B widths, 32 layers, bf16, random weights",
         sampling=sampled, **s_summary,
         fused_vs_unfused_contiguous_identical=True,
         tiny_fp32_card_vs_cpu_identical=True,
         greedy={"decode_tok_s": summary["decode_tok_s"],
                 "ttft_p50_s": summary["ttft_p50_s"],
                 "kernel_launches_per_step":
                     profile.get("kernel_launches_per_step"),
                 "device_ms_per_step": profile.get("device_ms_per_step")},
         launches_per_decode_step=s_profile.get("kernel_launches_per_step"),
         extra_launches_per_step_vs_greedy=extra,
         profile={k: s_profile.get(k) for k in (
             "device_ms_per_step", "step_ms", "device_busy_share",
             "kernel_launches_per_step", "decode_steps", "top_kernels")},
         sample_pick_launches=launches["sample_pick"])

    # --- 7c. speculative decoding ----------------------------------------------
    spec_out = {}
    rng_spec = np.random.default_rng(3)
    lookup = []
    for i in range(4):
        motif = rng_spec.integers(1, tiny.vocab_size, 5).astype(np.int32)
        lookup.append((f"lk{i}", np.tile(motif, 4)[:18], 16))
    spec_ec = dict(page_size=4, max_slots=3, max_pages_per_seq=16,
                   scan_chunk=3, prefill_chunk=8)
    for label, kw in (("greedy", {}), ("sampled", sampled),
                      ("w8kv8_greedy", {"kv_quant": "int8",
                                        "weight_quant": "int8"}),
                      ("w8kv8_sampled", {"kv_quant": "int8",
                                         "weight_quant": "int8",
                                         **sampled})):
        runs = {}
        for name, extra_kw in (("spec", {"spec_k": 4}),
                               ("oracle", {"fused": False,
                                           "contiguous": True})):
            e = E.Engine(tiny, tparams,
                         E.EngineConfig(**spec_ec, **kw, **extra_kw),
                         device="cuda")
            runs[name] = (e, e.run([
                E.Request(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n in lookup]))
        e = runs["spec"][0]
        identical_or_explain(G, tiny, tparams, lookup, runs["spec"][1],
                             runs["oracle"][1], f"tiny spec {label}")
        pool_whole_and_zero(e, f"tiny spec {label}")
        spec_out[f"tiny_{label}"] = {
            "identical_to_oracle": True, "proposed": e.spec_proposed,
            "accepted": e.spec_accepted, "verify_passes": e.verify_passes}
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    spec8 = dataclasses.replace(ec, spec_k=4)
    # The engine phase's first SPEC8_REQUESTS requests cut to
    # SPEC8_NEW_TOKENS new tokens: the greedy run's tokens start theirs.
    spec_reqs = [dataclasses.replace(r, max_new_tokens=min(
        r.max_new_tokens, SPEC8_NEW_TOKENS)) for r in reqs[:SPEC8_REQUESTS]]
    spec_want = {r.rid: types.SimpleNamespace(
        tokens=greedy_done[r.rid].tokens[:r.max_new_tokens])
        for r in spec_reqs}
    for label, draft in (("ngram", SD.NgramDraft(spec8.spec_lookup_order)),
                         ("replay", ReplayDraft(spec_reqs, greedy_done))):
        e = E.Engine(cfg, params, spec8, draft_source=draft)
        kernels.reset_launches()
        t0 = time.perf_counter()
        d = e.run(spec_reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pool_whole_and_zero(e, f"8B spec {label}")
        tokens = sum(len(c.tokens) - 1 for c in d.values())
        spec_out[label] = {
            "requests": len(spec_reqs), "new_tokens": SPEC8_NEW_TOKENS,
            "proposed": e.spec_proposed, "accepted": e.spec_accepted,
            "acceptance": e.spec_accepted / max(e.spec_proposed, 1),
            "verify_passes": e.verify_passes,
            "decode_tok_s": tokens / e.decode_seconds,
            "non_spec_decode_tok_s": summary["decode_tok_s"],
            "wall_seconds": wall,
            "token_agreement_with_non_spec": token_agreement(d, spec_want),
            "launches": dict(kernels.LAUNCHES),
        }
        if not all(len(d[r.rid].tokens) == r.max_new_tokens
                   for r in spec_reqs):
            raise AssertionError(f"8B spec {label}: token counts")
        del e
        torch.cuda.empty_cache()
    # int8 weights and KV: the verify pass's matmuls (M = 8 slots x 5
    # positions = 40) take the GEMV's wgmma body (8 planes).
    w8spec = dataclasses.replace(w8, spec_k=4)
    e = E.Engine(cfg, params, w8spec)
    del params
    torch.cuda.empty_cache()
    kernels.reset_launches()
    with RouteLog(I8) as spec_routes:
        d = e.run(spec_reqs)
    torch.cuda.synchronize()
    pool_whole_and_zero(e, "8B spec w8kv8")
    launches = dict(kernels.LAUNCHES)
    routes = spec_routes.check("8B spec w8kv8")
    # Prefill buckets have power-of-two row and chunk counts, so M = 40
    # is the verify pass alone: every matmul of every pass on the GEMV.
    verify_m = w8spec.max_slots * (w8spec.spec_k + 1)
    verify_gemv = sum(1 for m, r in spec_routes.calls
                      if m == verify_m and r == "gemv_sm90")
    if not (e.verify_passes > 0
            and verify_gemv == mm_per_pass * e.verify_passes
            and launches["int8mm_gemv_sm90"] >= verify_gemv
            and launches["int8mm_gemv"] == 0
            and launches["paged_decode_attention_int8"] == 0
            and launches["decode_mlp"] == 0):
        raise AssertionError(
            f"8B spec w8kv8: launches {launches}, {verify_gemv} "
            f"int8mm_gemv_sm90 launches at M = {verify_m}, want "
            f"{mm_per_pass} a verify pass ({e.verify_passes} passes)")
    spec_out["w8kv8_ngram"] = {
        "proposed": e.spec_proposed, "accepted": e.spec_accepted,
        "verify_passes": e.verify_passes, "launches": launches,
        "int8mm_routes": routes,
        "verify_int8mm_gemv_sm90_launches": verify_gemv,
        "decode_tok_s": sum(len(c.tokens) - 1 for c in d.values())
        / e.decode_seconds,
        "non_spec_decode_tok_s": w8_summary["decode_tok_s"],
    }
    del e
    torch.cuda.empty_cache()
    emit("engine_spec", model="LLAMA3_8B widths, 32 layers, spec_k 4, "
                              "random weights", **spec_out)

    # --- 7d. prefix sharing, the drain and metrics export ------------------
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    ptrace = prefix_trace(cfg.vocab_size, 8, PREFIX_LEN, (16, 64), 32,
                          seed=4)
    followers = len(ptrace) - 1
    n_full, partial = divmod(PREFIX_LEN, ec.page_size)
    # After the forks each follower shares the 12 full pages; the high-
    # water mark also counts the frozen boundary page, which all
    # followers attach in one tick before any of them forks it.
    live_saved = followers * n_full
    saved_hw = live_saved + (followers - 1 if partial else 0)
    pruns, psum, precs = {}, {}, {}
    for label, plen in (("shared", PREFIX_LEN), ("private", 0)):
        precs[label] = MetricsRecorder()
        e, d, launches, wall = serve(E, kernels, cfg, params, ec,
                                     prefix_requests(E, ptrace, plen),
                                     metrics=precs[label])
        pool_whole_and_zero(e, f"engine_prefix {label}")
        steps = e.decode_steps
        want = {"paged_decode_attention": L * steps,
                "decode_mlp_sm90": L * (steps
                                        + e.prefill_single_token_buckets)}
        if steps <= 0 or any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"engine_prefix {label}: launches "
                                 f"{launches}, want {want}")
        pruns[label] = d
        psum[label] = {
            **serve_summary(e, d, launches, wall),
            "peak_pages": peak_pages(e),
            "prefill_tokens": precs[label].counters.get(
                "engine_prefill_tokens_total"),
            "prefix_attached": e.prefix_attached,
            "cow_copies": e.cow_copies,
            "prefix_saved_hw": e.prefix_saved_hw,
            "max_prefix_shared_pages_gauge": precs[label].gauge_max.get(
                "engine_prefix_shared_pages"),
        }
        if label == "shared":
            cow = copy_page_cost(P, e.cache)
            pool_whole_and_zero(e, "engine_prefix after the copy timing")
        del e
        torch.cuda.empty_cache()
    sh, rec = psum["shared"], precs["shared"]
    shared_tokens = sum(len(c.tokens) for c in pruns["shared"].values())
    checks = {
        "prefix_attached": (sh["prefix_attached"], followers),
        "cow_copies": (sh["cow_copies"], followers),
        "prefix_saved_hw": (sh["prefix_saved_hw"], saved_hw),
        "max_prefix_shared_pages_gauge": (
            sh["max_prefix_shared_pages_gauge"], live_saved),
        "private_prefix_attached": (psum["private"]["prefix_attached"], 0),
        "engine_prefix_attached_total": (
            rec.counters.get("engine_prefix_attached_total"),
            sh["prefix_attached"]),
        "engine_cow_copies_total": (
            rec.counters.get("engine_cow_copies_total"), sh["cow_copies"]),
        "engine_tokens_total": (rec.counters.get("engine_tokens_total"),
                                shared_tokens),
        "engine_completed_total": (rec.counters.get("engine_completed_total"),
                                   len(pruns["shared"])),
        "ttft_observations": (len(rec.observed["engine_ttft_seconds"]),
                              len(ptrace)),
    }
    peak_saved = psum["private"]["peak_pages"] - sh["peak_pages"]
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad or peak_saved < live_saved - 1:
        raise AssertionError(f"engine_prefix: (got, want) {bad}, peak pages "
                             f"saved {peak_saved} < {live_saved - 1}")
    gate, drec = E.EventGate(), MetricsRecorder()
    e = E.Engine(cfg, params, ec, gate=gate, metrics=drec)
    drained, drill = drain_drill(E, e, gate,
                                 prefix_requests(E, ptrace, PREFIX_LEN),
                                 followers, after=2)
    drill["backpressure_drains_total"] = drec.counters.get(
        "engine_backpressure_drains_total")
    drill["completed_total"] = drec.counters.get("engine_completed_total")
    # t_first survives the drain: a resumed request observes no TTFT.
    drill["ttft_observations"] = len(drec.observed["engine_ttft_seconds"])
    if (drill["backpressure_drains_total"] != 1
            or drill["completed_total"] != len(ptrace)
            or drill["ttft_observations"] != len(ptrace)):
        raise AssertionError(f"engine_prefix drain: {drill}")
    del e
    torch.cuda.empty_cache()
    emit("engine_prefix",
         model="LLAMA3_8B widths, 32 layers, bf16, random weights",
         trace={"requests": len(ptrace), "prefix_len": PREFIX_LEN,
                "suffix_tokens": [len(p) - PREFIX_LEN for _, p, _ in ptrace],
                "new_tokens": 32},
         reckoned={"live_saved_pages": live_saved,
                   "prefix_saved_hw": saved_hw,
                   "peak_pages_saved_at_least": live_saved - 1},
         **psum, peak_pages_saved=peak_saved, checks=checks,
         cow_copy=cow, cow_launches=(
             sh["cow_copies"] * cow["launches_per_copy"]
             if isinstance(cow["launches_per_copy"], float) else None),
         shared_vs_private=pair_report(G, cfg, params, ptrace,
                                       pruns["shared"], pruns["private"]),
         drain={**drill, "vs_undrained": pair_report(
             G, cfg, params, ptrace, drained, pruns["shared"])})
    del params
    torch.cuda.empty_cache()

    # --- 7e. evacuation and live KV migration -----------------------------
    t_migrate = time.perf_counter()
    migrate = {"pinned_copy_gb_s": pinned_copy_gbs()}
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    # Bytes a page: K and V (and in int8 their f32 scales) of every layer.
    kv_row = cfg.n_kv_heads * cfg.head_dim
    page_bf16 = 2 * L * ec.page_size * kv_row * 2
    migrate["bf16"] = migrate_phase(E, G, kernels, cfg, params, ec, reqs,
                                    greedy_done, "bf16", page_bf16)
    del params
    torch.cuda.empty_cache()
    # The w8kv8 arms at MIGRATE_W8_LAYERS layers (ROADMAP Order 7's cut:
    # their gates scale with L), against one engine's unmigrated run of
    # the same requests at that depth. One int8 tree for every w8kv8
    # engine: an engine leaves a tree that is already quantized as it is.
    c_w8 = dataclasses.replace(cfg, n_layers=MIGRATE_W8_LAYERS)
    params = Q.quantize_params(G.unroll_params(G.as_tree(init_params(
        c_w8, torch.Generator(device="cuda").manual_seed(0)))))
    _, w8_want, _, _ = serve(E, kernels, c_w8, params, w8, reqs)
    page_w8 = (2 * MIGRATE_W8_LAYERS * ec.page_size
               * (kv_row + 4 * cfg.n_kv_heads))
    migrate["w8kv8"] = migrate_phase(E, G, kernels, c_w8, params, w8, reqs,
                                     w8_want, "w8kv8", page_w8)
    migrate["w8kv8"]["layers"] = MIGRATE_W8_LAYERS
    del params
    torch.cuda.empty_cache()
    tec = E.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                         scan_chunk=3, prefill_chunk=8)
    migrate["tiny_fp32"] = {
        label: tiny_migrate(E, tiny, tparams, trace,
                            dataclasses.replace(tec, **kw))
        for label, kw in (("greedy", {}), ("sampled", sampled))}
    emit("engine_migrate",
         model="LLAMA3_8B widths, random weights (bf16 32 layers, w8kv8 "
               f"{MIGRATE_W8_LAYERS}); tiny fp32",
         nvidia_smi=smi, seconds=time.perf_counter() - t_migrate, **migrate)

    # --- 7f. the serving tier: the port's Router over replica threads --------
    t_fabric = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    fabric, fabric_launches = fabric_phase(
        E, G, SV, kernels, cfg, params, ec, reqs, greedy_done, tiny, tparams,
        trace, tec, sampled)
    del params
    torch.cuda.empty_cache()
    emit("fabric", nvidia_smi=smi,
         model="LLAMA3_8B widths, 32 layers, bf16, random weights; tiny fp32",
         seconds=time.perf_counter() - t_fabric, launches=fabric_launches,
         engine={"decode_tok_s": summary["decode_tok_s"],
                 "decode_tok_s_over_wall": (summary["decode_tokens"]
                                            / summary["wall_seconds"]),
                 "ttft_p50_s": summary["ttft_p50_s"]},
         **fabric)

    # --- 7g. the fabric benches: the port's drills over its replicas --------
    t_bench = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    fbench, fbench_launches = fabric_bench_phase(
        E, G, SV, SFB, SFT, SDB, kernels, cfg, params, tiny, tparams)
    del params
    torch.cuda.empty_cache()
    emit("fabric_bench", nvidia_smi=smi,
         model="tiny fp32 (the drills); LLAMA3_8B widths, 32 layers, bf16, "
               "random weights (the headline and colocated vs disagg)",
         claim_layer="tpu_dra_torch.serving.claims.ClaimStore",
         seconds=time.perf_counter() - t_bench, launches=fbench_launches,
         **fbench)

    # --- 8. greedy_generate at Llama-3-8B widths -----------------------------
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    b, s, new = 8, 256, 32
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(1, cfg.vocab_size, (b, s))
        .astype(np.int32))
    gen_out, gen_launches, tokens = {}, {}, {}
    for label, quant in (("bf16", "none"), ("w8kv8", "int8")):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RouteLog(I8) as gen_routes:
            out = G.greedy_generate(cfg, params, prompt, new, kv_quant=quant,
                                    weight_quant=quant)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        gen_launches[label] = launches
        steps = new - 1
        want = {"decode_attention": L * steps}
        # The prefill (b x s = 2048 rows, the lm_head over every
        # position) on the wgmma tile, every decode step on the
        # tensor-core GEMV.
        if quant == "none":
            want.update(decode_mlp=L * steps, decode_mlp_sm90=L * steps,
                        int8mm=0, int8mm_sm90=0, int8mm_gemv_sm90=0,
                        int8mm_gemv=0)
        else:
            want.update(decode_mlp=0, decode_mlp_sm90=0,
                        int8mm=mm_per_pass * new,
                        int8mm_sm90=mm_per_pass,
                        int8mm_gemv_sm90=mm_per_pass * steps, int8mm_gemv=0)
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"generate {label}: launches {launches}, "
                                 f"want {want}")
        if not (out.shape == (b, s + new)
                and torch.equal(out[:, :s], prompt)
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size):
            raise AssertionError(f"generate {label}: bad output {out.shape}")
        tokens[label] = out[:, s:]
        if label == "bf16":
            # engine_sharded (a): over shard_decode_params, world 1.
            sharded["generate_world1"], gen_sharded_launches = (
                sharded_world1_generate(BS, G, MS, kernels, cfg, params,
                                        prompt, new, tokens[label],
                                        launches))
        gen_out[label] = {
            "wall_seconds": wall, "tok_s": b * new / wall,
            "launches": launches,
            "int8mm_routes": gen_routes.check(f"generate {label}"),
            "launches_per_decode_step": {
                "decode_attention": launches["decode_attention"] / steps,
                "decode_mlp": launches["decode_mlp"] / steps,
                "decode_mlp_sm90": launches["decode_mlp_sm90"] / steps,
                "int8mm": (launches["int8mm"] - (mm_per_pass if quant
                                                 == "int8" else 0)) / steps,
            },
        }
    emit("generate", model="LLAMA3_8B widths, 32 layers, random weights",
         batch=b, prompt=s, new_tokens=new, **gen_out,
         w8kv8_vs_bf16_token_agreement=float(
             (tokens["bf16"] == tokens["w8kv8"]).float().mean()))

    # --- 8c. wide decode batches: 128 rows, a 128- and a 32-slot engine --
    t0 = time.perf_counter()
    wide_gen, wide_gen_launches = generate_wide(G, DM, kernels, cfg, params)
    emit("generate_wide", nvidia_smi=smi,
         model="LLAMA3_8B widths, 32 layers, bf16, random weights",
         seconds=time.perf_counter() - t0, **wide_gen)
    t0 = time.perf_counter()
    w128, w128_launches, w128_step, w128_ec, w128_prompts = engine_wide128(
        E, I8, DM, kernels, cfg, params)
    w128_cmp = {"bf16": w128_step}
    c = dataclasses.replace(cfg, n_layers=2)
    e = E.Engine(c, init_params(c, torch.Generator(device="cuda")
                                .manual_seed(0)), w128_ec)
    w128_cmp["bf16_2_layers"] = step_logits(
        E, I8, c, e, w128_prompts, STEP_VARIANTS,
        new_tokens=2 * w128_ec.scan_chunk + 2)
    del e
    torch.cuda.empty_cache()
    emit("engine_wide128", nvidia_smi=smi,
         model="LLAMA3_8B widths, 32 layers, bf16, random weights",
         seconds=time.perf_counter() - t0, **w128)
    emit("decode_step_wide128", **w128_cmp, gates=step_gates(w128_cmp))
    t0 = time.perf_counter()
    wide, wide_launches, wide_step, wide_ec, wide_prompts = engine_wide(
        E, I8, kernels, cfg, params)
    # engine_wide_w8kv8's int8 tree, quantized once from these weights
    # (an engine leaves a tree that is already quantized as it is).
    t_quant = time.perf_counter()
    qparams = Q.quantize_params(G.unroll_params(G.as_tree(params)))
    t_quant = time.perf_counter() - t_quant
    del params
    torch.cuda.empty_cache()
    wide_cmp = {"bf16": wide_step}
    for name, c in (
        ("fp32", dataclasses.replace(
            cfg, dtype=torch.float32, param_dtype=torch.float32)),
        ("bf16_2_layers", dataclasses.replace(cfg, n_layers=2)),
    ):
        e = E.Engine(c, init_params(
            c, torch.Generator(device="cuda").manual_seed(0)), wide_ec)
        wide_cmp[name] = step_logits(E, I8, c, e, wide_prompts,
                                     STEP_VARIANTS)
        del e
        torch.cuda.empty_cache()
    emit("engine_wide", nvidia_smi=smi,
         model="LLAMA3_8B widths, 32 layers, bf16, random weights",
         seconds=time.perf_counter() - t0 - t_quant, **wide)
    emit("decode_step_wide", **wide_cmp, gates=step_gates(wide_cmp))

    # --- 8d. the 32- and 128-slot engines with int8 weights and KV ---------
    t0 = time.perf_counter()
    wide8, wide8_launches, wide8_step = engine_wide_w8kv8(
        E, I8, kernels, cfg, qparams, wide_ec, wide_requests(E, cfg))
    torch.cuda.empty_cache()
    wide8_cmp = {"bf16": wide8_step}
    c = dataclasses.replace(cfg, n_layers=2)
    e = E.Engine(c, init_params(c, torch.Generator(device="cuda")
                                .manual_seed(0)),
                 dataclasses.replace(wide_ec, weight_quant="int8",
                                     kv_quant="int8"))
    wide8_cmp["bf16_2_layers"] = step_logits(E, I8, c, e, wide_prompts,
                                             W8_STEP_VARIANTS)
    del e
    torch.cuda.empty_cache()
    emit("engine_wide_w8kv8", nvidia_smi=smi,
         model="LLAMA3_8B widths, 32 layers, bf16 activations, int8 "
               "weights and KV, random weights",
         seconds=time.perf_counter() - t0 + t_quant,
         quantize_seconds=t_quant, **wide8)
    emit("decode_step_wide_w8kv8", **wide8_cmp,
         gates=step_gates(wide8_cmp))
    t0 = time.perf_counter()
    w128_8, w128_8_launches, w128_8_step = engine_wide_w8kv8(
        E, I8, kernels, cfg, qparams, w128_ec, wide128_requests(E, cfg),
        "engine_wide128_w8kv8")
    del qparams
    torch.cuda.empty_cache()
    w128_8_cmp = {"bf16": w128_8_step}
    c = dataclasses.replace(cfg, n_layers=2)
    e = E.Engine(c, init_params(c, torch.Generator(device="cuda")
                                .manual_seed(0)),
                 dataclasses.replace(w128_ec, weight_quant="int8",
                                     kv_quant="int8"))
    w128_8_cmp["bf16_2_layers"] = step_logits(
        E, I8, c, e, w128_prompts, W8_STEP_VARIANTS,
        new_tokens=2 * w128_ec.scan_chunk + 2)
    del e
    torch.cuda.empty_cache()
    emit("engine_wide128_w8kv8", nvidia_smi=smi,
         model="LLAMA3_8B widths, 32 layers, bf16 activations, int8 "
               "weights and KV, random weights",
         seconds=time.perf_counter() - t0, **w128_8)
    emit("decode_step_wide128_w8kv8", **w128_8_cmp,
         gates=step_gates(w128_8_cmp))

    # --- 8a. sharded decode: world 1 above, world 2 on the one card --------
    t0 = time.perf_counter()
    sharded["world2_gloo"], w2_launches = sharded_world2_card(rank_launcher())
    sharded["world2_seconds"] = time.perf_counter() - t0
    w2 = sharded["world2_gloo"]
    if not w2["tokens_identical"]:
        # The stated fallback, for greedy_generate only (shardbench holds
        # the engine's tokens exact): its 2-layer fp32 logit bar, recorded.
        cos = [v for k, v in w2.items() if k.startswith("greedy_logit_cos")]
        if not cos or min(cos) < SHARDED_FP32_COSINE:
            raise AssertionError(f"engine_sharded world 2: tokens differ "
                                 f"and logit cosines {cos}: {w2}")
    emit("engine_sharded", nvidia_smi=smi,
         model="world 1: LLAMA3_8B widths, 32 layers, bf16 (the engine and "
               "generate phases' runs); world 2: LLAMA3_8B widths cut to 2 "
               "layers, fp32, two gloo ranks on the one card",
         **sharded)

    # --- 8b. the serve and decode benches -----------------------------------
    bench, bench_launches = bench_serve_phase(kernels, EB, DB, cfg,
                                              init_params, tiny, tparams)
    emit("bench_serve", nvidia_smi=smi, **bench)

    # --- 9. training at Llama-3-8B widths, 4 layers ------------------------
    train = train_phase(T, kernels, dataclasses.replace(LLAMA3_8B, n_layers=4),
                        init_params, train_flops_per_token, rates,
                        "LLAMA3_8B widths cut to 4 layers")
    emit("train", **train)

    # --- 9b. Mixtral training at Mixtral-8x7B widths, 2 layers ---------------
    mixtral = train_phase(T, kernels,
                          dataclasses.replace(M.MIXTRAL_8X7B, n_layers=2),
                          M.init_params, mixtral_active_flops_per_token,
                          rates, "MIXTRAL_8X7B widths cut to 2 layers")
    emit("train_mixtral", **mixtral)

    # --- 9c. sharded Llama training: two gloo ranks on the card ------------
    sharded_train, sharded_train_launches = train_sharded_phase(
        rank_launcher(), T,
        dataclasses.replace(LLAMA3_8B, n_layers=TRAIN_SHARDED_LAYERS),
        init_params)
    emit("train_sharded", nvidia_smi=smi, **sharded_train)

    # --- 9d. Mixtral on a training mesh: two gloo ranks on the card ---------
    moe_train, moe_train_launches = train_moe_sharded_phase(
        rank_launcher(), T, M)
    emit("train_moe_sharded", nvidia_smi=smi, **moe_train)

    # --- 9e. the pipeline relay over pp: two gloo ranks on the card --------
    pipe_train, pipe_train_launches = train_pipeline_phase(
        rank_launcher(), T,
        dataclasses.replace(LLAMA3_8B, n_layers=TRAIN_PIPELINE_LAYERS),
        init_params)
    emit("train_pipeline", nvidia_smi=smi, **pipe_train)

    # --- kernel list and result ----------------------------------------------
    rows = []
    for name, source, replaces, par, t, n_launch in (
        ("paged_decode_attention", "tpu_dra_torch/csrc/paged_decode.cu",
         "tpu_dra/workloads/ops/attention.py:1128",
         parity["paged_decode_attention"], timing["paged_decode_attention"],
         engine_launches["paged_decode_attention"]
         + sharded_launches["paged_decode_attention"]
         + w2_launches["paged_decode_attention"]
         + fabric_launches.get("paged_decode_attention", 0)
         + fbench_launches.get("paged_decode_attention", 0)
         + bench_launches.get("paged_decode_attention", 0)
         + shapes_launches["paged_decode_attention"]
         + wide_launches["paged_decode_attention"]
         + w128_launches["paged_decode_attention"]),
        ("decode_mlp", "tpu_dra_torch/csrc/decode_mlp_sm90.cu",
         "tpu_dra/workloads/ops/decode_mlp.py:102", parity["decode_mlp_b8"],
         timing["decode_mlp"], engine_launches["decode_mlp_sm90"]
         + sharded_launches["decode_mlp_sm90"]
         + gen_sharded_launches["decode_mlp_sm90"]
         + fabric_launches.get("decode_mlp_sm90", 0)
         + fbench_launches.get("decode_mlp_sm90", 0)
         + bench_launches.get("decode_mlp_sm90", 0)
         + boot_launches["decode_mlp_sm90"]
         + wide_launches["decode_mlp_sm90"]
         + wide_gen_launches["decode_mlp_sm90"]
         + w128_launches["decode_mlp_sm90"]
         + shapes_launches["decode_mlp_sm90"]),
        # The int8 matmul's two routes on the path: the tensor-core GEMV
        # for M <= 128 (decode) and the wgmma tile for M > 128 (prefill).
        ("int8mm_gemv_sm90", "tpu_dra_torch/csrc/int8mm_gemv_sm90.cu",
         "tpu_dra/workloads/ops/int8mm.py:47",
         parity["int8mm_m8_k4096_n14336"], timing["int8mm"],
         w8_launches["int8mm_gemv_sm90"]
         + wide8_launches["int8mm_gemv_sm90"]
         + w128_8_launches["int8mm_gemv_sm90"]
         + bench_launches.get("int8mm_gemv_sm90", 0)),
        ("int8mm_sm90", "tpu_dra_torch/csrc/int8mm_sm90.cu",
         "tpu_dra/workloads/ops/int8mm.py:47",
         parity["int8mm_m1024_k4096_n14336"], timing["int8mm_prefill"],
         w8_launches["int8mm_sm90"] + wide8_launches["int8mm_sm90"]
         + w128_8_launches["int8mm_sm90"]
         + bench_launches.get("int8mm_sm90", 0)),
        ("decode_attention", "tpu_dra_torch/csrc/decode.cu",
         "tpu_dra/workloads/ops/attention.py:803",
         parity["decode_attention"]["length_1000"],
         timing["decode_attention"],
         sum(v["decode_attention"] for v in gen_launches.values())
         + gen_sharded_launches["decode_attention"]
         + w2_launches["decode_attention"]
         + bench_launches.get("decode_attention", 0)
         + boot_launches["decode_attention"]
         + shapes_launches["decode_attention"]),
        ("paged_decode_attention_int8", "tpu_dra_torch/csrc/paged_decode.cu",
         "tpu_dra/workloads/ops/attention.py:1128",
         parity["paged_decode_attention_int8"],
         timing["paged_decode_attention_int8"],
         w8_launches["paged_decode_attention_int8"]
         + wide8_launches["paged_decode_attention_int8"]
         + w128_8_launches["paged_decode_attention_int8"]
         + bench_launches.get("paged_decode_attention_int8", 0)
         + shapes_launches["paged_decode_attention_int8"]),
    ) + tuple(
        # The fused MLP's halves on a model shard: the world-2 ranks'.
        (name, f"tpu_dra_torch/csrc/{source}",
         "tpu_dra/workloads/ops/decode_mlp.py:102", timing[name]["parity"],
         timing[name], w2_launches[name])
        for name, source in (
            ("decode_mlp_gate_up", "decode_mlp.cu"),
            ("decode_mlp_down", "decode_mlp.cu"),
            ("decode_mlp_sm90_gate_up", "decode_mlp_sm90.cu"),
            ("decode_mlp_sm90_down", "decode_mlp_sm90.cu"))
    ) + tuple(
        (name, f"tpu_dra_torch/csrc/{source}",
         f"tpu_dra/workloads/ops/attention.py:{line}",
         {"vs_plain": parity["flash_s2048_causal_bf16"][f"{out}_vs_plain"]},
         timing[name],
         train["launches"][counter] + mixtral["launches"][counter]
         + bench_launches.get(counter, 0)
         + sharded_train_launches[counter] + moe_train_launches[counter]
         + pipe_train_launches[counter])
        for name, source, counter, line, out in (
            ("flash_fwd", "flash_fwd_sm90.cu", "flash_fwd_sm90", 92, "out"),
            ("flash_bwd_dq", "flash_bwd_dq_sm90.cu", "flash_bwd_dq_sm90",
             178, "dq"),
            ("flash_bwd_dkv", "flash_bwd_sm90.cu", "flash_bwd_dkv_sm90",
             239, "dk"))
    ):
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": par["vs_plain"]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ms_with_host": t["ms_with_host"],
            "parity": par,
        })
        if name == "int8mm_gemv_sm90":
            rows[-1]["replaced_kernel_ms"] = t["old_gemv_ms"]
            rows[-1]["instantiations"] = gemv_build
            # The wgmma body at a w8 engine's 17-128 decode rows, beside
            # the tile it replaced there.
            rows[-1]["wide_rows"] = {
                label: {f: timing[label][f] for f in (
                    "shape", "plan", "ms", "ms_with_host", "sm90_tile_ms",
                    "plain_ms", "dequantized_bf16_matmul_ms", "bound_ms",
                    "bound_by", "share_of_bound")}
                for label, *_ in INT8MM_WIDE_TIMING}
            rows[-1]["wide_parity"] = {
                f"int8mm_m{m}_k{k}_n{n}": parity[f"int8mm_m{m}_k{k}_n{n}"]
                for m, k, n in INT8MM_PARITY if 16 < m <= GEMV_SM90_MAX_ROWS}
            rows[-1]["launches_at_wide_rows"] = {
                "engine_wide_w8kv8": wide8_launches["int8mm_gemv_sm90"],
                "engine_wide128_w8kv8": w128_8_launches["int8mm_gemv_sm90"]}
        if name == "decode_mlp":
            rows[-1].update(
                counter="decode_mlp_sm90",
                replaced_kernel_ms=t["replaced_kernel_ms"],
                library_note=t["library_note"],
                instantiations=mlp_build,
                wide_batches={
                    f"b{b}": {k: timing[f"decode_mlp_b{b}"][k] for k in (
                        "ms", "ms_with_host", "replaced_kernel_ms",
                        "plain_ms", "library_ms", "bound_ms", "bound_by",
                        "share_of_bound", "passes")}
                    for b in MLP_TIMING_ROWS if b != 8},
                launches_at_wide_batches={
                    "engine_wide": wide_launches["decode_mlp_sm90"],
                    "engine_wide128": w128_launches["decode_mlp_sm90"],
                    "generate_wide": wide_gen_launches["decode_mlp_sm90"]})
        if "library_note" in t and name.startswith("decode_mlp_"):
            rows[-1]["library_note"] = t["library_note"]
        if name in ("paged_decode_attention", "decode_attention"):
            rows[-1]["new_shapes"] = {
                k: {f: timing[k][f] for f in (
                    "shape", "ms", "ms_with_host", "plain_ms", "bound_ms",
                    "bound_by", "share_of_bound")} | {
                    "sdpa_ms": timing[k].get(
                        "sdpa_contiguous_ms", timing[k]["library_ms"])}
                for k in (name + "_3b", name + "_hd256") if k in timing}
            rows[-1]["grid_parity"] = {
                k: parity["decode_grid"][k] for k in (
                    "checks", "worst_fp32", "worst_bf16_over_limit")}
        if name.startswith("int8mm"):
            rows[-1]["serves"] = {
                "int8mm_gemv_sm90": "gemv_sm90: bf16 M <= 128 (decode "
                                    "steps of up to 128 slots, the spec "
                                    "verify pass, the engine prefill's "
                                    "lm_head)",
                "int8mm_sm90": "sm90: bf16 M > 128 (prefill projections, "
                               "the generate lm_head)",
            }[name]
    pick = sampling["timing"]["t0.8_k40"]
    pick_cases = sampling["cases"]
    rows.append({
        "name": "sample_pick", "route": "cuda",
        "source": "tpu_dra_torch/csrc/sample.cu",
        "replaces": "tpu_dra/workloads/generate.py:559",
        "launches": sampled_launches["sample_pick"]
        + bench_launches.get("sample_pick", 0)
        + fabric_launches.get("sample_pick", 0)
        + fbench_launches.get("sample_pick", 0),
        "max_abs_err": max(c["max_abs_err"] for c in pick_cases.values()),
        "ms": pick["ms"], "plain_ms": pick["plain_ms"],
        "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"],
        "library_ms": None, "ms_with_host": pick["ms_with_host"],
        "argmax_ms": pick["argmax_ms"],
        "parity": {"cases": len(pick_cases), "tokens_identical": all(
            c["tokens_vs_plain_identical"] for c in pick_cases.values())},
        "note": "no Pallas kernel: the JAX sampler is an XLA fusion; "
                "replaces names the function it computes",
    })
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
