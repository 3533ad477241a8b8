#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root (it puts ``src`` on ``sys.path`` itself):

    python3 chip_smoke.py

1. Builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
   and prints nvcc's register/spill report and the count of ``HGMMA``
   (wgmma) instructions in each library's SASS (``cuobjdump -sass``).
2. Main path, at the paper's real suite sizes: synthetic MPAHA suites
   (the 64-core paper suite on hp_bl260c; 4 apps of 240-280 tasks on a
   256-core cluster of multicores), mapped with AMTHA
   (``get_scheduler("engine")``), then evaluated on the card with
   ``simulate_suite(backend="cuda")`` at jitter 0 and at jitter 0.01 with
   16 draws per app. The kernels' launch counts are zeroed just before
   and read just after.
3. Checks: every result against the float64 NumPy backend at rtol 1e-5
   (one float32 rounding per relaxation step); T_exec == T_est at jitter
   0 (the analytic simulator reproduces the schedule); the kernel equal
   to its plain PyTorch version with ``torch.equal`` on the same device
   tensors at every main-path shape, and the sweeps each row ran equal to
   the plain stop's (``fixpoint_sweeps_torch``); a non-zero launch count.
4. Numbers: per shape, the kernel's time from CUDA events, the plain
   version's, the bound (from the inputs alone: read once, or one
   topological pass of operations) and what bounds it, the launch plan
   (cluster size k, staged or L2 variant) and the sweeps the rows ran
   before their fixpoint (max, median) against ``n_steps``; a host-side
   breakdown of ``simulate_batch``.
5. Online path, at 256 cores (``cluster_of_multicores(n_blades=32)``):
   64 bursty arrivals at rho=0.9 admitted by
   ``make_policy("batched", k=16, scorer="kernel", device="cuda")``
   (the hand-written ``sched_score`` kernel), validated and evaluated
   with contention; then a random fault script (one core failure, one
   slowdown, one link degrade, all in 0.2-0.4 of the makespan) detected
   at half the makespan and recovered by ``recover_from_script`` with
   the GA refinement, whose fitness runs ``sim_relax_pop`` on the card
   at merged-cluster shapes. Both kernels' counts are zeroed just before
   and read just after. Checks: placements equal to the same admission
   with ``device="cpu"`` (the plain version), exactly; ``sched_score``
   (the fused kernel: the matrix and each row's minimum in one launch)
   equal to its plain version under ``torch.equal``, the matrix and the
   minima, at every shape the path launched, at a ragged stress shape
   (scalar loads; the path's C = 256 takes 16-byte loads) and with
   +-inf, and with NaN propagated at the same places; ``sim_relax_pop``
   equal to its plain version at the GA's shapes; the GA's first
   population's fitness on the card within rtol 1e-5 of float64; both
   kernels launched; the GA-refined makespan at most that of the greedy
   re-map it starts from (losing a core may lengthen the plan, the GA
   must not); ``validate()`` after admission and after recovery.
   Numbers: kernel/plain/bound ms and launches (``sched_score``'s device
   ms from a CUDA graph over input copies past the L2, beside an empty
   kernel's on its grid, the launch floor), ``kernel_scores``' host ms
   per batch after ``drain_matrix`` (replayed on each batch's frozen
   inputs), admission/evaluate/recovery wall seconds with a host
   breakdown of their layers, the recovery report.
6. Serving path: gemma2-2b at full width and depth in bf16, weights from
   ``init_params`` with a CUDA generator seeded 0 and every norm scale
   redrawn N(0, 0.1) from it. Run A: ``generate`` at B=4, prompt 512, 32
   new tokens; run B: B=1, prompt 4608 (past the 4096 window, so the
   local layers' ring caches wrap), 16 new tokens; run C:
   ``ContinuousBatcher(n_slots=4, max_seq=1024)`` over 8 requests with
   prompts of 37-700 tokens and 4-12 new tokens each. The three serving
   kernels' counts are zeroed before each run and read after it. Checks:
   the counts equal what the path implies (rmsnorm 4 per layer + 1 per
   forward, flash_attention one per layer per prefill, flash_decode one
   per layer per decode step); each kernel within tolerance of its plain
   version (``close_to_plain``) at every shape the path launched and a
   ragged stress shape; run A teacher-forced, the kernel path's logits
   within 5e-2 of the largest logit of the same model on the card with
   the three entry points swapped for their plain versions, at the
   prefill and every decode step; run C's requests equal to
   ``generate`` of each alone, token for token. Numbers: per run prefill
   ms, decode ms per step, tokens/s; per kernel at its largest path
   shape the kernel's, plain version's and library call's ms and the
   bound, ``flash_attention`` (the bf16 tensor-core kernel) also with
   TFLOP/s against the bound's operation count; ``rmsnorm`` against
   ``F.rms_norm`` at every prefill width and ``flash_decode`` (and, with
   no softcap, ``scaled_dot_product_attention``) at its largest path
   shape, device ms from a CUDA graph over input copies past the L2,
   back-to-back ms beside them; ``flash_decode`` also bitwise equal
   across two launches at every path shape; side rows without softcap
   against ``scaled_dot_product_attention``;
   where one decode step's time goes (host parts, the profiler's device
   time and top kernels).
7. SSM and hybrid serving: mamba2-780m (48 layers, d 1536, 48 heads of
   64, state 128, chunk 256) and zamba2-7b (81 Mamba-2 layers in 13 groups
   of 6 plus 3, a shared attention block on 7168 wide at the head of each
   group with a rank-128 LoRA per group) at full width and depth in bf16,
   weights from ``init_params`` with a CUDA generator seeded 0, the norm
   scales redrawn N(0, 0.1), Mamba-2's A in -[1, 16] and dt log-uniform
   in [1e-3, 1e-1] (the reference's init makes every chunk's decay
   underflow, which would hide the state carried across chunks) and the
   LoRA ``b_*`` redrawn non-zero. mamba2 run A: ``generate``, B=4, prompt
   512, 32 new tokens; run B: B=1, prompt 4000 (15 chunks and a ragged
   160), 16 new tokens; run C: the batcher over run C's 8 ragged
   requests. zamba2 run D: ``generate``, B=2, prompt 700, 16 new tokens.
   The four serving kernels' counts are zeroed before each run and read
   after it. Checks: exact counts (rmsnorm 2 per Mamba layer, 2 per
   shared-block use and 1 final per forward; ssd_scan one per Mamba layer
   per prefill; flash_attention and flash_decode one per group per
   prefill and per decode step); each kernel within ``close_to_plain`` of
   its plain version at every path shape (prompts under one chunk and
   ragged ones among them) and a stress shape; run A's teacher-forced
   logits against the plain path, in float32 within 1e-4 of the largest
   logit and in bf16 no further from the float32 logits than 2x the
   plain path is, a gate that must fail the kernel path with a planted
   fault in ``ssd_scan`` (the carry between chunks dropped); run C equal
   to ``generate`` alone. Numbers: per run prefill ms, decode ms per
   step, tokens/s; ssd_scan's kernel, plain and bound ms and its error
   over the 2-ulp gate's bound at every path shape, and the device ms of
   each of its passes at the largest; ``rmsnorm`` at every prefill width
   (1536, 3072, 3584, 7168) against ``F.rms_norm``; ``flash_attention``
   at zamba2's (2, 700, 32, 224) against causal
   ``scaled_dot_product_attention``, which computes the same function
   there (no softcap, no window); the bf16 gate's reading with each
   planted fault; a decode step's profile per model.
8. Dense path, on the four shapes of phase 2: ``lint_batch`` ->
   ``dense_lags`` -> ``ops.sim_relax(n_steps=depth)`` (the hand-written
   ``sim_step`` kernels: the lags compacted on the card, then
   ``sim_relax_pop`` stopped at each row's fixpoint), its counts (calls
   and variants) zeroed just before and read just after. Checks: the
   compact variant gave every shape and ``ops.sim_relax_pop``'s count
   did not move; ``torch.equal`` to ``sim_relax_torch`` at every shape,
   within rtol 1e-5 of the float64 ``relax_batch_np`` and of phase 2's
   sparse results; the compaction equal to ``compact_lags_torch`` and
   each row's sweeps equal to ``fixpoint_sweeps_torch``'s on the compact
   form; the dense variant alone equal to the plain version;
   ``ops.sim_step`` equal to its plain version at ragged stress shapes
   (S = 37 and 1000) with -inf, and with NaN at the same places;
   ``ops.sim_relax`` at S = 256 and 257 on a clean scenario (compact),
   NaN lags and an +inf duration (dense) and ends that overflow
   (compact, redone dense), equal to the plain version with NaN at the
   same places and both variant counts moved. Numbers: the call's ms,
   the compaction's and the stopped relaxation's, the dense variant's,
   one sweep's, the plain ms, P+1, the sweeps (max, median), the call
   bound (inputs once) and the streaming bound (every sweep), host ms of
   ``dense_lags``.
9. Device GA: ``ga_search`` with ``GAParams(device=True)`` at the
   defaults (pop 32, 24 generations, refine 3 x 48) on the largest app
   of the 64-core suite and on a 240-280-task app on 256 cores, twice
   each with seed 0, ``sim_relax_pop``'s count zeroed before each run.
   Checks: the same winner and fitness; launches = 1 + generations +
   the refine rounds run; the final population's kernel fitness equal
   to the scan's under ``torch.equal``; the winner's fitness within
   rtol 1e-5 of its float64 append-only decode; ``ga_schedule`` with
   the device GA valid and never worse than ``engine``. Numbers: search
   wall seconds, ms per generation, the host GA's seconds at the same
   budget, ``sim_relax_pop``'s kernel, plain and bound ms, plan and
   sweeps run against ``n_steps = S`` at the GA's shapes (the kernels
   line reports the larger of the two).
10. Verify: ``simulate_suite(..., verify=True)`` on the 64-core suites
   (the kernel) and ``get_scheduler("engine", verify=True)``; a result
   with one finish time moved before its predecessor's must raise
   ``VerifyError``.
11. Analysis: the port's lint (``repro_torch.analysis.lint``) over its
   package, tests, this script and ``tools/``, and its tracecheck
   (``repro_torch.analysis.tracecheck``, ``--quick``) on the card over
   the manifest; any finding fails, each entry must launch its kernel
   once per call (``TRACE_LAUNCHES``) and the admission scorer must read
   back exactly once per call.
12. The paper's evaluation: its 8-core suite (20 apps of 15-25 tasks,
   seed 0) on ``dell_poweredge_1950`` and its 64-core suite (8 apps,
   seed 100) on ``hp_bl260c``, mapped by ``get_scheduler("engine")``
   (T_est = makespan). T_exec from the contention-aware event simulator
   (jitter 0.01), ``simulate_suite(backend="cuda")`` (``sim_relax_pop``,
   count zeroed before and read after) and the threaded executor
   (``execute_threaded``, one thread per core, ``time_scale`` 1e-3,
   wall-clock). Checks: every threaded T_exec >= T_est, T_exec ==
   wall_seconds / time_scale, ``dif_rel`` exactly Eq. 4, the batched
   result within rtol 1e-5 of float64, the kernel launched. Numbers: per
   source n, mean, max and min %Dif_rel beside the paper's band (4 % at
   8 cores, 6 % at 64), printed and not gated (the threaded T_exec is
   wall-clock on a shared host); the executor's wall seconds per suite.
13. MoE and MLA serving in bf16, weights from ``init_params`` with a CUDA
   generator seeded 0 and every norm scale (``kv_norm`` too) redrawn
   N(0, 0.1); one model on the card at a time, its peak memory printed.
   deepseek-v2-lite-16b whole (27 layers, d 2048, 16 heads, MLA L 512 /
   nope 128 / rope 64 / v 128, layer 0 dense, 26 MoE layers of 64
   experts top-6 of 1408 plus 2 shared): run A ``generate`` B=4, 512 +
   32; run B B=1, 4096 + 16; run C the batcher over phase 6's requests
   (latent caches padded at each join). qwen3-moe-235b-a22b at full
   width (d 4096, 64/4 heads of 128, qk-norm, 128 experts top-8 of 1536)
   cut from 94 to 8 layers: run A. Checks: exact counts (rmsnorm 2 per
   layer, +1 per MLA layer, +2 per qk-norm layer, +1 per forward;
   flash_attention one per layer per prefill; flash_decode one per
   layer per decode step for qwen3 and none for deepseek, whose absorbed
   MLA decode is plain PyTorch); each kernel within ``close_to_plain``
   at every shape the path launched (MLA's D 192 against Dv 128, qwen3's
   16 q heads per kv head); deepseek run A teacher-forced against the
   plain path with each MoE layer's routes recorded on both (the share
   of (token, layer) routes that differ printed: a rounding difference
   moves a token to other experts, and that token moves every later
   one through attention), and the plain path run again on the kernel
   path's routes, its logits within 5e-2 of the largest at every
   position; the same in float32 on deepseek cut to 4 layers within
   1e-4; run C equal to ``generate`` alone. Numbers:
   per run prefill ms, decode ms per step, tokens/s; ``flash_attention``
   at the runs' prefill shapes beside causal
   ``scaled_dot_product_attention``; ``flash_decode`` at qwen3's shape
   beside it; ``rmsnorm`` at every prefill width; a decode step's
   profile per model beside the bound of reading every weight once.
14. The patch and frame frontends in bf16 at full size, weights as in
   phase 13. paligemma-3b (18 layers, d 2048, 8/1 heads of 256, vocab
   257,216, 256 patches): ``generate`` at B=2 with 256 seeded patches
   and 512 prompt tokens, 16 new tokens; hubert-xlarge (48 layers, d
   1280, 16 heads of 80, bidirectional, gelu, vocab 504): one encoder
   forward of B=2 x 1,000 frames. Checks: exact counts (rmsnorm 2 per
   layer + 1 per forward, flash_attention one per layer per prefill or
   forward, flash_decode one per layer per decode step); a prefill
   launch carrying the prefix of 256; paligemma's teacher-forced logits
   and hubert's logits within 5e-2 of the plain path's largest; both cut
   to 4 layers in float32 within 1e-4; each kernel within
   ``close_to_plain`` at every path shape; ``flash_attention`` with the
   prefix at (1, 768, 8/1, 256, prefix 256) and bidirectional at
   hubert's (2, 1000, 16, 80), each with its lse, held to the plain
   version and timed beside ``scaled_dot_product_attention``.
15. Training on one card. gemma2-2b at full width and depth in bf16
   (remat full, AdamW at its defaults): ``Trainer`` to its checkpoint
   at step 2 on B=2 x 1,024 tokens from ``TokenPipeline``, then step 3
   by ``make_train_step``; a fresh state restored from the checkpoint
   and stepped once must give step 3's loss and every parameter bit for
   bit (one checkpoint is 26 GB: the run writes one, not two). One
   ``make_train_step`` (after a warm-up step, two timed) of paligemma-3b
   (B=1, 256 patches + 768 tokens), hubert-xlarge (B=2 x 1,000 frames)
   and mamba2-780m (B=2 x 1,024: four chunks of 256) at full size, and
   of zamba2-7b at full width cut in depth to the most layers of the
   form 6 k + 3 whose training state (16 bytes a parameter) and 8 GB of
   activations stay under 70 GB (``zamba_cut``, which prints the
   reckoning; 39 of 81 layers), B=2 x 1,024, no checkpoint; then the
   MoE family: deepseek-v2-lite-16b at full width cut to the dense layer
   and the most MoE layers that fit the same reckoning
   (``deepseek_cut``: 6 of 27 layers), B=2 x 1,024, no checkpoint (its
   state would be about 48 GB on disk), the last timed step's routes
   recorded and, after the timing, each MoE layer's routed tokens per
   expert placed on one H100 node of 8 GPUs (``h100_node(1, 8)``) by
   AMTHA (``place_experts``) and by round robin (``place_from_routes``:
   8 experts a device and a permutation, checked; the largest and mean
   device load printed, which is lower not gated). The float32
   gradient gate of each model at full width cut to 2 layers (zamba2 to
   7: one group of 6 with its shared block and a tail layer; deepseek
   the dense layer and one MoE layer): loss (and deepseek's Switch aux
   loss) within 1e-5 and every parameter's gradient within 1e-4 of its
   largest against the same step with every kernel, forward and
   backward, swapped for its plain version, deepseek's plain path
   replaying the kernel path's routes call by call
   (``recorded_routes(forced=...)``: the forward's and the remat
   recomputation's). Checks: exact counts (under
   remat each block's norms, attention and scan run forward twice and
   backward once: a Mamba layer two norms and one scan, zamba2's shared
   block two norms and one attention at head dim 224, an MLA layer three
   norms with ``kv_norm``);
   ``flash_attention_bwd``, ``rmsnorm_bwd`` and ``ssd_scan_bwd`` within
   ``close_to_plain`` at every shape the phase launched (deepseek's
   (2, 1024, 16, 192/128) attention and its norms at 2,048 and 512, and
   MLA's 192 / 128 at (1, 1024, 16)), the forward kernels too (dw of a float32
   ``rmsnorm_bwd``, a sum over every row, within 1e-5 of its largest x
   max(1, sqrt(rows) / 10)). Numbers: step ms, tokens/s and peak memory
   per model, each model's step profile (device busy ms, kernels per
   step, idle share, the kernels with the most device time, from two
   unsynchronised steps and one profiled; deepseek's from one and one,
   with the expert products' device ms and share); ``flash_attention`` at deepseek's training shape from a CUDA
   graph beside SDPA; each
   backward kernel's graph-timed ms, plain ms, bound and library ms
   (autograd backward of ``scaled_dot_product_attention`` without a
   softcap, of ``F.rms_norm``; none computes an SSD scan's backward),
   for the bf16 ``flash_attention_bwd`` its launch plan (``bwd_plan``:
   the dK/dV split and its partials), for ``rmsnorm_bwd`` its plan and
   share of the bound at each width, for ``ssd_scan_bwd`` each
   gradient's error over the gate's bound (``tools/kernel_probe.py``
   splits its time by pass).
16. AMTHA's placements executed on a mesh: a one-rank NCCL process
   group (``HashStore``, world size 1), destroyed at the end of the
   phase. deepseek-v2-lite-16b whole in bf16 under a (1, 1) ``("data",
   "model")`` mesh, its experts kept by ``shard_experts`` (ep = 1: all
   64): run A's prompt through ``generate`` for 8 tokens with the
   capacity raised to E / k x 1.01 of the even share, so no copy drops
   (the prefill by ``moe_a2a``'s sort-based dispatch and all-to-alls,
   the decode by ``moe_local_decode``); the same prompt and tokens
   teacher-forced through the dense dispatch on the mesh run's routes
   (``recorded_routes(forced=...)``), within 5e-2 of the largest logit;
   7 decode steps from one cache by the local and the dense dispatch, bit
   for bit; run A's prefill at the config's capacity 1.25, the share of
   routed copies dropped per MoE layer printed; one MoE layer's forward
   and backward at B = 2 x 1,024 through ``a2a`` and through the dense
   dispatch in turns (a2a, dense, dense, a2a; 5 CUDA-event readings
   each), with the layer's expert loads and dropped share. gemma2-2b
   whole in bf16 through ``make_pipelined_forward`` on a one-rank
   ``("pod",)`` mesh, one stage (13 repeat units), 4 microbatches of 1 x
   1,024: the logits and the gradient of mean(logits^2) against the
   per-microbatch ``forward`` (logits bit for bit; every gradient bit for
   bit but the tied embedding's, whose bf16 contributions sum in another
   order, within 2^-6 of its largest), the pipeline's ms a microbatch.
   Checks: exact counts (deepseek rmsnorm 3 a layer + 1 a forward,
   flash_attention one a layer a prefill, no flash_decode; the pipeline
   rmsnorm 4 a layer + 1 a microbatch, flash_attention one a layer a
   microbatch, each backward once); each kernel within
   ``close_to_plain`` at every shape the phase launched. The kernels
   line adds the phase's counts to ``rmsnorm``, ``flash_attention``,
   ``rmsnorm_bwd`` and ``flash_attention_bwd``.
17. Tensor-parallel and FSDP training (ROADMAP A13b2, A13b3). Both
   attention kernels on query chunks at their offsets (``q_offset``,
   Sk != Sq) against the whole K/V, bf16: gemma2-2b's training
   attention (2, 1024, 8/4, 256, softcap 50), gemma3-4b's windowed
   layer (1, 4096, 8/4, 256, window 1024, where the window bites),
   paligemma-3b's prefix (1, 1024, 8/1, 256, prefix 256) and
   hubert-xlarge's bidirectional (2, 1000, 16/16, 80), each cut into 4
   chunks. Checks: each chunk's output, lse, dq, dk
   and dv within ``close_to_plain`` of the plain versions; its output,
   lse and dq within the gate of the whole-sequence kernel's rows (bit
   equality printed); the chunks' dk and dv summed within the sum of the
   gates of the whole-sequence kernel's. Numbers: the last chunk's
   forward and backward ms from a CUDA graph over input copies past the
   L2, plain ms, the bound of its pairs, and
   ``scaled_dot_product_attention`` with the equivalent boolean mask
   (null under the softcap). Then gemma2-2b whole in bf16, one
   ``make_train_step`` at B = 2 x 1,024 on one device and one with int8
   compression, then the same weights on a one-rank NCCL (1, 1)
   ``("data", "model")`` mesh through ``mesh_axes_for`` (FSDP on, ROADMAP
   A13b3), ``make_ctx``, ``launch.train.sharded_train_state`` (the
   moments at their ZeRO-1 specs) and the sharded step, without and with int8:
   each layer's weights gathered by a one-rank all-gather inside its
   remat region and their gradients reduce-scattered; the loss, the
   grad norm and every updated parameter bit for bit the matching
   one-device step's, the counts exact. The kernels line adds the
   phase's counts and the offset rows to ``flash_attention`` and
   ``flash_attention_bwd``.
18. Tensor parallelism of the SSM, MLA and MoE families and decode over
   a cache cut into slot ranges (ROADMAP A13b4), one card.
   ``flash_decode`` with ``return_lse`` over M = 4 and 8 slot ranges of
   a bf16 cache (each range's local count of valid slots, -1 where it
   has none), as a model axis of M holds a cache whose kv heads do not
   divide M: glm4-9b's heads (4, 4096, 32/2, 128), paligemma-3b's one
   kv head of 256, gemma2-2b's local ring (window 4096) past its window,
   and a row whose every range but the first is empty. Checks: each
   range's float32 partial within ``close_to_plain`` of the plain
   version's, its lse within ``LSE_REL``, an empty range's out 0 and
   lse -inf; the ranges merged in float32 in rank order
   (``merge_ranges``) and rounded once within ``close_to_plain`` (2 bf16
   ulps) of the whole cache's kernel and plain version. Numbers at the
   first range: the lse variant's ms from a CUDA graph over copies past
   the L2, the plain version's, the bound, the whole cache's default
   call beside it (no library call returns the lse: null). Then
   mamba2-780m whole in bf16, one ``make_train_step`` at B = 2 x 1,024
   on one device and one through ``shard_params`` on a one-rank NCCL
   (1, 1) mesh, bit for bit (at M = 1 the Mamba layers run the
   one-device code), the counts exact; deepseek-v2-lite-16b whole in
   bf16 through ``shard_params`` on the mesh, run A's prompt through
   ``generate`` (``a2a`` prefill with nothing dropped, ``local`` decode,
   MLA's decode over its latent in one slot range, merged: new code at
   M = 1), counts exact, its teacher-forced logits within ``LOGIT_REL``
   of the one-device forward's on the same routes. The kernels line
   adds the phase's counts to ``rmsnorm``, ``flash_attention``,
   ``rmsnorm_bwd``, ``ssd_scan`` and ``ssd_scan_bwd``, and the slot-range
   rows to ``flash_decode``.
19. AMTHA places the port's own model stack (``autoplace_phase``):
   gemma2-2b's pipeline placed by the GA on ``h100_node(1, 8)`` (its
   fitness by ``sim_relax_pop``: the launches join that kernel's row);
   one gemma2-2b repeat unit at full width in bf16 on 1 x 1,024 tokens,
   the cost model's predicted ms (analytic and counted sources, at the
   datasheet rates) beside the measured median of CUDA events and
   %Dif_rel (Eq. 4), not gated; deepseek-v2-lite-16b whole, its experts
   placed from routes recorded on the card and permuted, its logits on
   the same routes within ``LOGIT_REL`` of the unpermuted model's (bf16
   sums in another order), and in float32 at 4 layers within
   ``PERMUTE_F32_REL``;
   one ``dryrun`` cell on the 16 x 16 mesh with its host seconds; the
   three abstract trace-check entries of phase 11 clean. The kernels
   line adds the unit's and deepseek's counts to ``rmsnorm`` and
   ``flash_attention``, each kernel held to its plain version at the
   shapes they gave it.

Exits non-zero, printing no result, on any failure, when no CUDA device
is present, or when run outside a checkout. The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
L2_BYTES = 50 * 2 ** 20             # H100 SXM L2 cache
FP32_OPS_PER_S = 67e12              # H100 SXM float32 rate outside tensor cores
RTOL_F32 = 1e-5                     # the reference's float32 tolerance
JITTER, DRAWS = 0.01, 16
ONLINE_BLADES, ONLINE_APPS, ONLINE_K = 32, 64, 16   # 256 cores
MEAN_APP_WORK_S = 550               # benchmarks/online_bench.py: rho units


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back calls, from
    CUDA events, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def graph_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls captured in
    one CUDA graph and replayed, from CUDA events: the kernels' own time
    without the host's dispatch between them, which a back-to-back
    ``cuda_ms`` of a short kernel measures instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def sdpa(q, k, v, mask, causal, scale):
    """``scaled_dot_product_attention`` on the (B, S, H, D) layout: one
    library call, timed beside the kernels and used nowhere in the port.
    GQA natively where this PyTorch has ``enable_gqa``, else K/V
    repeated."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(attn_mask=mask, is_causal=causal and mask is None, scale=scale)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                             **kw)
    except TypeError:
        g = q.shape[2] // k.shape[2]
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, dim=1),
            vt.repeat_interleave(g, dim=1), **kw)
    return out.transpose(1, 2)


def snapshot(x):
    """A copy of one recorded argument that later work cannot change."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return np.array(x)
    return x


class Spy:
    """Stands in for ``module.name`` while the main path runs and keeps
    the first arguments of each distinct ``key(args)`` (with the values
    of the keyword arguments named in ``kw_names``): a snapshot of each,
    or what ``take(args, kwargs)`` keeps of them, taken before the call;
    every call goes on to the real function, whose own counts are
    untouched."""

    def __init__(self, module, name, key, kw_names=(), take=None):
        self.module, self.name, self.key = module, name, key
        self.kw_names, self.take = kw_names, take
        self.fn = getattr(module, name)
        self.calls = {}

    @property
    def launches(self):
        """The real entry point's count: it counts through its module
        name, which is this spy while the spy stands in."""
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    @property
    def tensors(self):
        """The real entry point's count of tensors it updated, where it
        keeps one (``adamw_update``)."""
        return self.fn.tensors

    @tensors.setter
    def tensors(self, n):
        self.fn.tensors = n

    def __call__(self, *args, **kwargs):
        k = self.key(args)
        if self.kw_names:
            k = (k, tuple(kwargs.get(n) for n in self.kw_names))
        if k not in self.calls:
            self.calls[k] = self.take(args, kwargs) if self.take else (
                [snapshot(a) for a in args],
                {n: snapshot(v) for n, v in kwargs.items()})
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Timed:
    """Adds up the host wall seconds of every call to ``owner.name``
    while it stands in, and keeps ``keep(*args, **kwargs)`` of each call
    where given. The stand-in is a plain function, so a method put on a
    class still binds."""

    def __init__(self, owner, name, keep=None):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.seconds, self.calls = 0.0, 0
        self.keep, self.kept = keep, []

    def __enter__(self):
        fn = self.fn

        def timed(*args, **kwargs):
            if self.keep is not None:
                self.kept.append(self.keep(*args, **kwargs))
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def shapes(args):
    return tuple(tuple(a.shape) for a in args)


def placements(sch):
    return {sid: (p.core, p.start, p.end)
            for sid, p in sch.placements.items()}


def same_scores(got, want) -> bool:
    """Equal under ``torch.equal`` where the score is a number, NaN at
    the same places (only a NaN's payload may differ)."""
    import torch
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def score_row(args):
    """``sched_score`` at one path shape: the fused kernel's (matrix and
    row minima, the path's launch) device ms from a CUDA graph of calls
    that take turns over copies of the inputs holding three times the L2,
    so each reads them from device memory as the bound counts it; the
    same for an empty kernel on the kernel's grid (the launch floor); the
    plain version's device ms from a graph of 200 calls (its inputs warm
    in the L2); the back-to-back ms of the kernel's wrapper (ctypes and
    two allocations, what the path pays per launch); the bound and what
    bounds it (inputs once, the matrix and the minima written once; a
    max, an add and a compare per element)."""
    from repro_torch.kernels.sched_score import (empty_cuda,
                                                 sched_score_cuda,
                                                 sched_score_torch)
    drain, f, r = args
    a, c = drain.shape
    n_bytes = 4 * (2 * a * c + a + c + a)
    b_ms, b_by = bound(n_bytes, 3 * a * c, FP32_OPS_PER_S)
    per_call = 4 * (a * c + a + c)
    n = -(-3 * L2_BYTES // per_call)
    copies = [args] + [[x.clone() for x in args] for _ in range(n - 1)]
    turn = itertools.count()

    def kernel():
        return sched_score_cuda(*copies[next(turn) % n], row_min=True)

    def plain():
        return sched_score_torch(*copies[next(turn) % n], row_min=True)

    row = dict(
        name=f"online({a}, {c})", A=a, C=c, ms=graph_ms(kernel, n),
        floor_ms=graph_ms(lambda: empty_cuda(a, drain.device), n),
        plain_ms=graph_ms(plain, 200), bound_ms=b_ms, bound_by=b_by,
        eager_ms=cuda_ms(lambda: sched_score_cuda(*args, row_min=True), 200),
        copies=n, bytes=n_bytes)
    del copies
    return row


class FrozenEngine:
    """What ``BatchedPolicy.kernel_scores`` reads of an ``OnlineAMTHA``
    (its machine and the cluster's frontiers), frozen at one batch so the
    call can be replayed after the admission has moved on."""

    def __init__(self, eng):
        self.machine = eng.machine
        self.state = self
        self._frontiers = list(eng.state.frontiers())

    def frontiers(self):
        return self._frontiers


def kernel_scores_host_ms(calls, reps=200):
    """Host ms per batch of ``kernel_scores`` after ``drain_matrix``: for
    each recorded ``(policy, batch, frozen engine, now)``, the median of
    ``reps`` calls with the batch's drain matrix computed beforehand (the
    policies module's ``drain_matrix`` stands in with it) and the
    frontiers frozen (a list read, where the live engine computes them).
    Each call ends in its read-back, so its time is the host's wait for
    the card too. Returns the per-batch values."""
    import statistics

    from repro_torch.online import policies

    real = policies.drain_matrix
    out = []
    try:
        for policy, batch, eng, now in calls:
            drain = real([a.graph for a in batch], eng.machine)
            policies.drain_matrix = lambda graphs, machine, d=drain: d
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                policy.kernel_scores(batch, eng, now)
                times.append((time.perf_counter() - t0) * 1e3)
            out.append(statistics.median(times))
    finally:
        policies.drain_matrix = real
    return out


def sim_row(name, args, steps, ops, sim_relax_pop_cuda, sim_relax_pop_torch):
    """Kernel vs plain on the same device tensors, times and bound, the
    launch plan (cluster size k, variant) and the sweeps the rows ran
    against ``n_steps``."""
    import torch

    from repro_torch.kernels.sim_step import (fixpoint_sweeps_torch,
                                              pop_plan)
    got = ops.sim_relax_pop(*args, n_steps=steps)
    want = sim_relax_pop_torch(*args, n_steps=steps)
    _, sweeps = sim_relax_pop_cuda(*args, n_steps=steps, with_sweeps=True)
    stopped, want_sweeps = fixpoint_sweeps_torch(*args, n_steps=steps)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name}: kernel != plain version, max abs err "
             f"{(got - want).abs().max().item():.3e}")
    if not torch.equal(stopped, want):
        fail(f"{name}: the plain stop at the fixpoint != {steps} sweeps")
    if not torch.equal(sweeps, want_sweeps):
        fail(f"{name}: the kernel's sweeps (max {int(sweeps.max())}) != "
             f"the plain stop's (max {int(want_sweeps.max())})")
    b, s, p1 = args[0].shape
    plan = pop_plan(b, s, p1)
    ms = cuda_ms(lambda: sim_relax_pop_cuda(*args, n_steps=steps), 20)
    plain_ms = cuda_ms(lambda: sim_relax_pop_torch(*args, n_steps=steps), 5)
    n_bytes = sum(x.numel() * x.element_size() for x in args) + b * s * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    # from the inputs alone: one pass in topological order (the scan
    # population_ends) gives the result, 3 operations per (b, s, p)
    t_ops = b * s * p1 * 3 / FP32_OPS_PER_S * 1e3
    return dict(name=name, B=b, S=s, P1=p1, depth=steps,
                sweeps_max=int(sweeps.max()),
                sweeps_median=float(sweeps.float().median()),
                k=plan.k, variant=plan.variant,
                shared_bytes=plan.shared_bytes,
                max_abs_err=(got - want).abs().max().item(), ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes)


# -- 6. serving the dense family: gemma2-2b on rmsnorm, flash_attention,
#       flash_decode; 7. the SSM and hybrid families: mamba2-780m and
#       zamba2-7b on ssd_scan and the same three ---------------------------

SERVE_ARCH = "gemma2-2b"
RUN_A = dict(batch=4, prompt=512, gen=32)
RUN_B = dict(batch=1, prompt=4608, gen=16)     # past the 4096 window
RUN_C = dict(n_slots=4, max_seq=1024, n_requests=8, prompt=(37, 700),
             max_new=(4, 12))
SSM_RUN_A = dict(batch=4, prompt=512, gen=32)  # two whole chunks of 256
SSM_RUN_B = dict(batch=1, prompt=4000, gen=16)  # 15 chunks + a ragged 160
SSM_RUN_D = dict(batch=2, prompt=700, gen=16)  # zamba2-7b
SCAN_RUNS = {(4, 512, 48, 64): "mamba2_A", (1, 4000, 48, 64): "mamba2_B",
             (2, 700, 112, 64): "zamba2_D"}   # ssd_scan's bf16 x by run
BF16_OPS_PER_S = 989e12             # H100 SXM dense bf16 tensor-core rate
NORM_STD = 0.1                      # norm scales redrawn N(0, 0.1)
LOGIT_REL = 5e-2                    # teacher-forced logits: check_teacher_forced
F32_LOGIT_REL = 1e-4                # and in float32: check_teacher_forced_f32
BF16_ERR_RATIO = 2.0                # bf16 kernel vs plain path error ratio
GATED_FAULTS = ("dropped carry",)   # planted faults the bf16 gate must fail
SERVE_KERNELS = ("rmsnorm", "flash_attention", "flash_decode")
SSM_KERNELS = SERVE_KERNELS + ("ssd_scan",)


def close_to_plain(got, want):
    """(ok, max abs err). float32: rtol 1e-5 with an absolute floor of
    1e-5 x max|want| (sums in another order; outputs that cancel near
    zero). bfloat16: at most 2 bfloat16 ulps of max(|want|, max|want| /
    256): both versions compute in float32 and round once."""
    g, w = got.double(), want.double()
    err = (g - w).abs()
    ok = got.shape == want.shape and got.dtype == want.dtype \
        and bool((err <= plain_bound(want)).all())
    return ok, float(err.max()) if err.numel() else 0.0


def plain_bound(want):
    """``close_to_plain``'s bound on each element's error."""
    import torch
    w = want.double()
    amax = float(w.abs().max()) if w.numel() else 0.0
    if want.dtype == torch.float32:
        return 1e-5 * w.abs() + 1e-5 * amax
    mag = torch.clamp(w.abs(), min=max(amax / 256, 2.0 ** -126))
    return 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)


def gate_ratio(got, want):
    """The largest error over ``close_to_plain``'s bound (<= 1 passes)."""
    if not want.numel():
        return 0.0
    err = (got.double() - want.double()).abs()
    return float((err / plain_bound(want)).max())


def visible_pairs(s, causal, window, prefix=0):
    """(query, key) pairs the attention mask lets through; ``prefix``
    (causal, no window) adds the keys past each query inside the
    prefix."""
    if causal and prefix:
        p = min(prefix, s)
        return s * (s + 1) // 2 + p * (p - 1) // 2
    if not causal:
        return s * s if window is None else \
            sum(min(s, i + window) for i in range(s))
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attn_cost(q, k, v, *, causal, window, prefix_len=None):
    b, s, hq, d = q.shape
    hkv, dv = k.shape[2], v.shape[-1]
    n_bytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                  + b * s * hq * dv)
    pairs = [visible_pairs(s, causal, window, p) for p in
             (prefix_len.tolist() if prefix_len is not None else [0] * b)]
    flops = 2 * hq * sum(pairs) * (d + dv)
    return n_bytes, flops


def decode_cost(q, kc, vc, pos, *, ring):
    b, hq, d = q.shape
    t, hkv, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
    lim = [min(int(p) + 1, t) if ring else int(p) + 1 for p in pos.tolist()]
    n_bytes = q.element_size() * (q.numel() + sum(lim) * hkv * (d + dv)
                                  + b * hq * dv) + 4 * b
    flops = 2 * hq * sum(lim) * (d + dv)
    return n_bytes, flops


def ssd_cost(x, dt, A, B, C, chunk):
    """Bytes (each input read once, y and the final state written once)
    and the operations the function needs: per chunk of L real
    positions, per batch row and head, C B^T and M x over the L (L + 1)
    / 2 causal (query, key) pairs, 2 L (L + 1) / 2 (N + P), and the
    state's two products, 4 L N P."""
    b, s, h, p = x.shape
    n = B.shape[3]
    n_bytes = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C)) \
        + x.element_size() * (x.numel() + b * h * p * n)
    per_head = sum(ln * (ln + 1) * (n + p) + 4 * ln * n * p
                   for ln in (min(chunk, s - c0) for c0 in range(0, s, chunk)))
    return n_bytes, per_head * b * h


def bound(n_bytes, flops, ops_per_s):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


class ModeTimer:
    """Stands in for ``serve_loop.forward`` and adds up the host wall
    seconds of each call by mode, synchronising the card after it so
    that a call's time is its own."""

    def __init__(self, module):
        self.module, self.fn = module, module.forward
        self.seconds, self.calls = {}, {}

    def __call__(self, params, batch, cfg, ctx):
        import torch
        t0 = time.perf_counter()
        out = self.fn(params, batch, cfg, ctx)
        torch.cuda.synchronize()
        self.seconds[ctx.mode] = self.seconds.get(ctx.mode, 0.0) \
            + time.perf_counter() - t0
        self.calls[ctx.mode] = self.calls.get(ctx.mode, 0) + 1
        return out

    def __enter__(self):
        self.module.forward = self
        return self

    def __exit__(self, *exc):
        self.module.forward = self.fn


@contextlib.contextmanager
def swapped(ops, **fns):
    """Entry points of ``ops`` replaced by ``fns`` (same arguments) for
    the span of the block (the package itself has no such switch)."""
    saved = {k: getattr(ops, k) for k in fns}
    for k, fn in fns.items():
        setattr(ops, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def plain_serving_kernels(ops):
    """The entry points of the serving and training paths, forward and
    backward, replaced by their plain PyTorch versions: the same model on
    the card without the kernels."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_torch, flash_attention_torch)
    from repro_torch.kernels.flash_decode import flash_decode_torch
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_torch, rmsnorm_torch
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_torch,
                                              ssd_scan_torch)
    return swapped(ops, rmsnorm=rmsnorm_torch,
                   flash_attention=flash_attention_torch,
                   flash_decode=flash_decode_torch, ssd_scan=ssd_scan_torch,
                   rmsnorm_bwd=rmsnorm_bwd_torch,
                   flash_attention_bwd=flash_attention_bwd_torch,
                   ssd_scan_bwd=ssd_scan_bwd_torch)


def scan_without_carry(x, dt, A, B, C, chunk):
    """A planted fault: the kernel run on each chunk alone, from a zero
    state, so the state carried from chunk to chunk is dropped."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        part = [t[:, c0:c0 + chunk].contiguous() for t in (x, dt, B, C)]
        y, state = ssd_scan_cuda(part[0], part[1], A, part[2], part[3],
                                 chunk)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def scan_rounded_apart(x, dt, A, B, C, chunk):
    """A planted fault: the chunked form's bf16 roundings (M and the
    decay weights cast to x's type before their products, the diagonal
    and off-diagonal parts of y rounded apart), as the reference's
    ``ssd_chunked`` rounds."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk)


def redraw(params, gen, dev):
    """Redraw, from ``gen``, what the reference's init leaves degenerate:
    every norm scale N(0, 0.1); Mamba-2's A in -[1, 16] (``A_log`` = log
    U[1, 16]) and dt log-uniform in [1e-3, 1e-1] (``dt_bias`` =
    softplus^-1 dt), as arXiv:2405.21060 initialises them, so the state
    carried across chunks does not underflow; the shared block's LoRA
    ``b_*`` N(0, 1)/sqrt(r), so the per-slot LoRA adds something. ``D``
    stays 1."""
    import math
    import torch
    lo, hi = math.log(1e-3), math.log(1e-1)
    with torch.no_grad():
        for name, p in params.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "A_log":
                u = torch.rand(p.shape, generator=gen, device=dev)
                p.copy_(torch.log(1.0 + 15.0 * u))
            elif leaf == "dt_bias":
                u = torch.rand(p.shape, generator=gen, device=dev)
                dt = torch.exp(lo + (hi - lo) * u)
                p.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif leaf.startswith("b_"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        / math.sqrt(p.shape[0]))
            elif p.dim() == 1 and leaf != "D":      # every norm scale
                p.copy_(torch.randn(p.shape, generator=gen, device=dev)
                        * NORM_STD)


def ragged_requests(vocab, seed=0):
    """RUN_C's requests: prompts of 37-700 tokens (both ends included),
    4-12 new tokens each."""
    import numpy as np
    from repro_torch.runtime import Request
    rng = np.random.default_rng(seed)
    lo, hi = RUN_C["prompt"]
    lens = [lo, hi] + rng.integers(lo, hi + 1,
                                   RUN_C["n_requests"] - 2).tolist()
    news = rng.integers(RUN_C["max_new"][0], RUN_C["max_new"][1] + 1,
                        RUN_C["n_requests"]).tolist()
    return [Request(rid=i, prompt=rng.integers(0, vocab, n), max_new=m)
            for i, (n, m) in enumerate(zip(lens, news))]


def drive(label, name, run, cfg, params, spies, want, *, prompt=None,
          reqs=None, extra=None):
    """One run through the entry points a user calls, every spied
    kernel's count zeroed just before it and read just after: ``generate``
    of ``prompt`` (with the batch entries ``extra``, a VLM's patches), or
    a ``ContinuousBatcher`` over ``reqs``. Fails unless the counts equal
    ``want(prefills, decode_steps)``. Returns the run's record and its
    counts."""
    import torch

    from repro_torch.models import ShardCtx
    from repro_torch.runtime import ContinuousBatcher, generate, serve_loop
    for s in spies.values():
        s.launches = 0
    with ModeTimer(serve_loop) as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if reqs is not None:
            batcher = ContinuousBatcher(cfg, params, n_slots=run["n_slots"],
                                        max_seq=run["max_seq"])
            for r in reqs:
                batcher.submit(r)
            ticks = batcher.run()
            out = None
            n_tok = sum(len(r.out) for r in reqs)
        else:
            out = generate(cfg, ShardCtx(), params,
                           {"tokens": prompt, **(extra or {})}, run["gen"])
            n_tok = run["batch"] * run["gen"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: s.launches for k, s in spies.items()}
    n_pre = timer.calls.get("prefill", 0)
    n_dec = timer.calls.get("decode", 0)
    rec = dict(out=out, wall_s=wall, tokens=n_tok, prefills=n_pre,
               decode_steps=n_dec,
               prefill_ms=timer.seconds.get("prefill", 0.0) * 1e3 / n_pre,
               decode_ms_per_step=timer.seconds.get("decode", 0.0) * 1e3
               / max(n_dec, 1), tokens_per_s=n_tok / wall)
    if reqs is not None:
        rec["ticks"] = ticks
    print(f"{label} run {name}: " + json.dumps(
        {k: v for k, v in rec.items() if k != "out"})
        + f" launches {launches}")
    if launches != want(n_pre, n_dec):
        fail(f"{label} run {name}: launches {launches} != "
             f"{want(n_pre, n_dec)} implied by {n_pre} prefills and {n_dec} "
             f"decode steps")
    if reqs is None:
        if out.shape != (run["batch"], run["gen"]) or \
                not ((0 <= out) & (out < cfg.vocab)).all():
            fail(f"{label} run {name}: tokens of shape {tuple(out.shape)} "
                 f"or outside the vocabulary")
        if n_dec != run["gen"] - 1:
            fail(f"{label} run {name}: {n_dec} decode steps for "
                 f"{run['gen']} tokens")
    else:
        for r in reqs:
            if not r.done or len(r.out) != r.max_new:
                fail(f"{label} run {name}: request {r.rid} gave "
                     f"{len(r.out)} of {r.max_new} tokens")
    return rec, launches


def check_against_plain(label, spies, plain, stress, ops):
    """Each spied kernel against its plain version on the same device
    tensors, at every shape the path launched and a stress shape; fails
    outside ``close_to_plain``. Returns the largest error per kernel."""
    import torch
    max_err = {}
    for name, spy in spies.items():
        cases = [(f"path{k}", a, kw) for k, (a, kw) in spy.calls.items()]
        cases.append(("stress", *stress[name]()))
        max_err[name] = 0.0
        for case, args, kw in cases:
            got = getattr(ops, name)(*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            if name == "flash_decode" and not torch.equal(
                    getattr(ops, name)(*args, **kw), got):
                fail(f"{label} {name} {case}: two launches differ")
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                ok, err = close_to_plain(g, w)
                if not ok:
                    fail(f"{label} {name} {case}: kernel not within "
                         f"tolerance of the plain version (max abs err "
                         f"{err:.3e})")
                max_err[name] = max(max_err[name], err)
        print(f"{label} {name}: {len(cases)} shapes within tolerance of the "
              f"plain version, max abs err {max_err[name]:.3e}"
              + (", bitwise equal across launches"
                 if name == "flash_decode" else ""))
    return max_err


def teacher_forced(cfg, params, prompt, toks, extra=None, ctx=None):
    """(B, n, V) float32 logits of the prefill of ``prompt`` (with the
    batch entries ``extra``: a VLM's patches, which come first) and of
    every decode step fed ``toks`` (the run's own tokens), under ``ctx``
    (one device when not given)."""
    import torch

    from repro_torch.models import ShardCtx
    from repro_torch.runtime import make_prefill, make_serve_step, \
        pad_cache_to
    ctx = ctx or ShardCtx()
    prefill, step = make_prefill(cfg, ctx), make_serve_step(cfg, ctx)
    b, s = prompt.shape
    if extra and "patches" in extra:
        s += cfg.n_patches
    # a model kept by shard_params serves from caches at cache_spec
    part = getattr(params, "partitioner", None) \
        if ctx.mesh is not None else None
    max_seq = s + toks.shape[1]
    if part is not None:
        max_seq = -(-max_seq // part.model_n) * part.model_n
    logits, cache = prefill(params, {"tokens": prompt, **(extra or {})})
    cache = pad_cache_to(cfg, cache, b, max_seq, part)
    out = [logits.float()]
    for i in range(toks.shape[1] - 1):
        _, logits, cache = step(params, cache, toks[:, i:i + 1], s + i)
        out.append(logits.float())
    return torch.stack(out, dim=1)


def kernel_and_plain_logits(label, cfg, params, prompt, toks, ops, *,
                            greedy=True, extra=None):
    """``teacher_forced`` logits of the kernel path and of the same model
    on the card with the entry points swapped for their plain versions.
    Fails on non-finite kernel-path logits, and where ``greedy``, when
    re-running the kernel path does not give the run's own tokens."""
    import torch
    kern = teacher_forced(cfg, params, prompt, toks, extra)
    if not torch.isfinite(kern).all():
        fail(f"{label} run A: non-finite logits on the kernel path")
    if greedy and not torch.equal(kern.argmax(-1), toks):
        fail(f"{label} run A: re-running the kernel path gave other greedy "
             f"tokens")
    with plain_serving_kernels(ops):
        plain = teacher_forced(cfg, params, prompt, toks, extra)
    return kern, plain


def check_teacher_forced(label, cfg, params, prompt, toks, ops, extra=None):
    """The run's tokens fed back: the kernel path's logits at the prefill
    and every decode step against the plain path's."""
    kern, ref_logits = kernel_and_plain_logits(label, cfg, params, prompt,
                                               toks, ops, extra=extra)
    d_logit = float((kern - ref_logits).abs().max())
    scale = float(ref_logits.abs().max())
    top1 = float((kern.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    print(f"{label} run A teacher-forced: max |dlogit| {d_logit:.4e} over "
          f"{kern.shape[1]} positions x {kern.shape[0]} rows, bound "
          f"{LOGIT_REL} x max|logit| {scale:.4f} = {LOGIT_REL * scale:.4e}; "
          f"top-1 agreement {top1:.4f}")
    # bound: the tolerance the CPU tests hold the bf16 model to against
    # the reference (tests/test_torch_models.py), 5e-2 of the largest logit
    if not d_logit <= LOGIT_REL * scale:
        fail(f"{label} run A: kernel path logits off the plain versions' by "
             f"{d_logit:.4e} > {LOGIT_REL * scale:.4e}")


def check_teacher_forced_f32(label, cfg, params, prompt, toks, ops):
    """Run A's tokens fed back through four versions of the same model on
    the card: kernel and plain path, each in bf16 and with the weights
    cast to float32. Two gates. In float32 the kernel path is within
    ``F32_LOGIT_REL`` of the plain path's largest logit (the CPU tests'
    float32 tolerance against the reference: the kernels differ from
    their plain versions only in the order of float32 sums). In bf16 the
    kernel path is no further from the float32 logits than the plain path
    is, within ``BF16_ERR_RATIO`` (both round every activation to bf16 at
    the same places; a random 48-layer model amplifies those roundings,
    so their logits differ by several per cent of the largest one and a
    fixed bound on that difference would measure the model, not the
    kernels). The bf16 gate's power is read on every run: the kernel path
    with ``ssd_scan`` swapped for each planted fault must fail it."""
    import copy

    import torch
    kern, plain = kernel_and_plain_logits(label, cfg, params, prompt, toks,
                                          ops)
    cfg32 = cfg.replace(dtype="float32")
    params32 = copy.deepcopy(params).float()
    kern32, plain32 = kernel_and_plain_logits(label, cfg32, params32, prompt,
                                              toks, ops, greedy=False)
    del params32
    scale = float(plain32.abs().max())
    d32 = float((kern32 - plain32).abs().max())
    err_kern = float((kern - plain32).abs().max())
    err_plain = float((plain - plain32).abs().max())
    top1 = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"{label} run A teacher-forced over {kern.shape[1]} positions x "
          f"{kern.shape[0]} rows: float32 kernel vs plain max |dlogit| "
          f"{d32:.4e}, bound {F32_LOGIT_REL} x max|logit| {scale:.4f} = "
          f"{F32_LOGIT_REL * scale:.4e}; bf16 kernel vs plain max |dlogit| "
          f"{float((kern - plain).abs().max()):.4e}, top-1 agreement "
          f"{top1:.4f}; off the float32 logits: bf16 kernel path "
          f"{err_kern:.4e}, bf16 plain path {err_plain:.4e}, ratio "
          f"{err_kern / err_plain:.4f} (bound {BF16_ERR_RATIO})")
    if not d32 <= F32_LOGIT_REL * scale:
        fail(f"{label} run A: float32 kernel path logits off the plain "
             f"versions' by {d32:.4e} > {F32_LOGIT_REL * scale:.4e}")
    if not err_kern <= BF16_ERR_RATIO * err_plain:
        fail(f"{label} run A: bf16 kernel path {err_kern:.4e} off the "
             f"float32 logits, more than {BF16_ERR_RATIO} x the plain "
             f"path's {err_plain:.4e}")
    for name, fault in (("dropped carry", scan_without_carry),
                        ("rounded apart", scan_rounded_apart)):
        with swapped(ops, ssd_scan=fault):
            err = float((teacher_forced(cfg, params, prompt, toks)
                         - plain32).abs().max())
        print(f"{label} run A bf16 gate, planted fault '{name}' in "
              f"ssd_scan: {err:.4e} off the float32 logits, ratio "
              f"{err / err_plain:.4f} (sound {err_kern / err_plain:.4f}, "
              f"bound {BF16_ERR_RATIO})")
        if name in GATED_FAULTS and err <= BF16_ERR_RATIO * err_plain:
            fail(f"{label} run A: the bf16 gate passes the planted fault "
                 f"'{name}' ({err:.4e} <= {BF16_ERR_RATIO} x {err_plain:.4e})")


def check_batched_equals_alone(label, cfg, params, reqs, dev):
    """Run C determinism: each request alone through ``generate``."""
    import torch

    from repro_torch.models import ShardCtx
    from repro_torch.runtime import generate
    for r in reqs:
        alone = generate(cfg, ShardCtx(), params,
                         {"tokens": torch.as_tensor(r.prompt, device=dev)
                          .long()[None]}, len(r.out),
                         max_seq=RUN_C["max_seq"])
        if alone[0].tolist() != r.out:
            fail(f"{label} run C: request {r.rid} (prompt {len(r.prompt)}) "
                 f"decoded differently batched than alone")
    print(f"{label} run C: {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}, max_new "
          f"{[r.max_new for r in reqs]}) equal to generate alone, token for "
          f"token")


def profile_step(step, breakdown, unsynced=5, profiled=3, experts=None):
    """``unsynced`` calls of ``step()`` back to back (host ms per step),
    then ``torch.profiler`` over ``profiled``: device busy ms, kernels
    and idle share per step, and the ten kernels with the most device
    time. With ``experts`` (a MoE model's E), also the device ms a step
    and share of the batched matrix products with E in front, forward and
    backward: the dense dispatch's expert products, which a sparse
    dispatch would cut. Adds them to ``breakdown``."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(unsynced):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / unsynced
    breakdown["step_ms_unsynced"] = step_ms
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=experts is not None) as prof:
            for _ in range(profiled):
                step()
            torch.cuda.synchronize()
        # only the device's own events: a CPU op carries its kernels'
        # device time too (the rule of the profiler's own table footer)
        evts = [e for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", ""))
                and not getattr(e, "is_user_annotation", False)]

        def dev_time(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
        dev_us = sum(dev_time(e) for e in evts)
        n_kern = sum(e.count for e in evts)
        n = profiled
        breakdown["top_device_time_per_step"] = [
            dict(name=e.key[:80], calls=e.count / n,
                 ms=dev_time(e) / 1e3 / n)
            for e in sorted(evts, key=dev_time, reverse=True)[:10]]
        breakdown["device_busy_ms_per_step"] = dev_us / 1e3 / n \
            if dev_us else "not measured"
        breakdown["device_kernels_per_step"] = n_kern / n if n_kern \
            else "not measured"
        if dev_us:
            breakdown["device_idle_share"] = 1.0 - dev_us / 1e3 / n / step_ms
        if experts is not None and dev_us:
            # an aten::bmm carries its kernels' device time; the expert
            # products are the ones with an (E, ., .) operand
            ex_us = sum(
                getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0))
                for e in prof.key_averages(group_by_input_shape=True)
                if e.key == "aten::bmm" and any(
                    len(sh) == 3 and sh[0] == experts
                    for sh in (e.input_shapes or [])))
            breakdown["expert_bmm_ms_per_step"] = ex_us / 1e3 / n
            breakdown["expert_bmm_share"] = ex_us / dev_us
    except Exception as e:          # the profiler is untried on this machine
        breakdown["device_busy_ms_per_step"] = f"not measured ({e!r})"
    return breakdown


def decode_breakdown(label, cfg, params, prompt, gen_len, extra=None):
    """``profile_step`` of one decode step after the prefill of
    ``prompt`` (cache padded for ``gen_len`` tokens), with ``extra``
    (e.g. a bound) beside it, printed."""
    from repro_torch.models import ShardCtx
    from repro_torch.runtime import (make_prefill, make_serve_step,
                                     pad_cache_to)
    ctx = ShardCtx()
    prefill, step = make_prefill(cfg, ctx), make_serve_step(cfg, ctx)
    logits, cache = prefill(params, {"tokens": prompt})
    b, s = prompt.shape
    cache = pad_cache_to(cfg, cache, b, s + gen_len)
    tok = logits.argmax(-1)[:, None]
    out = profile_step(lambda: step(params, cache, tok, s), {})
    out.update(extra or {})
    print(f"{label} decode step breakdown (host ms) " + json.dumps(out))
    return out


def spy_keys():
    """How each serving entry point's calls are told apart by the spies:
    (key of the positional arguments, keyword arguments in the key)."""
    def key_norm(args):
        return (tuple(args[0].shape), args[0].dtype, args[1].dtype)

    def key_scan(args):
        return (shapes(args[:5]), args[0].dtype, args[5:])
    return {"rmsnorm": (key_norm, ("zero_centered",)),
            "flash_attention": (shapes, ("window", "softcap")),
            "flash_decode": (shapes, ("ring", "softcap")),
            "ssd_scan": (key_scan, ())}


def stress_cases(gen, dev):
    """A ragged stress input per kernel, off every path shape."""
    import torch

    def stress_norm():
        x = torch.randn((37, 1001), generator=gen, device=dev).bfloat16()
        w = torch.randn((1001,), generator=gen, device=dev).bfloat16() * 0.1
        return [x, w], {"zero_centered": True}

    def stress_attn():
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((2, 1000, 8, 256), (2, 1000, 4, 256),
                                 (2, 1000, 4, 256)))
        return [q, k, v], {"window": 300, "softcap": 50.0,
                           "scale": 256 ** -0.5}

    def stress_decode():
        q = torch.randn((3, 8, 256), generator=gen, device=dev).bfloat16()
        kc, vc = (torch.randn((3, 1001, 4, 256), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        pos = torch.tensor([5, 1000, 3000], dtype=torch.int32, device=dev)
        return [q, kc, vc, pos], {"softcap": 50.0, "ring": True}

    def stress_scan():
        # P, N and chunk off the kernel's tile grid, three groups, a
        # ragged last chunk; A and dt as Mamba-2 initialises them
        b, s, h, p, g, n, chunk = 3, 300, 6, 40, 3, 100, 96
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        u = torch.rand((b, s, h), generator=gen, device=dev)
        dt = torch.exp(-6.9078 + 4.6052 * u)
        A = -(1.0 + 15.0 * torch.rand((h,), generator=gen, device=dev))
        B, C = (torch.randn((b, s, g, n), generator=gen, device=dev)
                for _ in range(2))
        return [x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), chunk], {}

    return {"rmsnorm": stress_norm, "flash_attention": stress_attn,
            "flash_decode": stress_decode, "ssd_scan": stress_scan}


def plain_versions():
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.flash_decode import flash_decode_torch
    from repro_torch.kernels.rmsnorm import rmsnorm_torch
    from repro_torch.kernels.ssd_scan import ssd_scan_torch
    return {"rmsnorm": rmsnorm_torch, "flash_attention": flash_attention_torch,
            "flash_decode": flash_decode_torch, "ssd_scan": ssd_scan_torch}


def norm_row(x, w, nkw):
    """``rmsnorm`` at one shape: the kernel's, the plain version's and
    ``F.rms_norm``'s device ms from a CUDA graph of 50 calls (a short
    kernel's back-to-back time is the host's dispatch), their
    back-to-back ms beside them (``*_eager_ms``), the bound and what
    bounds it. Successive calls take turns over copies of ``x`` that
    together hold three times the L2 cache, so each call reads its input
    from device memory, as the bound counts it."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_torch
    n_bytes = x.numel() * 2 * x.element_size() + w.numel() * w.element_size()
    b_ms, b_by = bound(n_bytes, 4 * x.numel(), FP32_OPS_PER_S)
    copies = [x] + [x.clone() for _ in range(-(-3 * L2_BYTES // n_bytes))]
    turn = itertools.count()

    def x_():
        return copies[next(turn) % len(copies)]

    def kernel():
        return rmsnorm_cuda(x_(), w, **nkw)

    def plain():
        return rmsnorm_torch(x_(), w, **nkw)

    def library():
        return F.rms_norm(x_(), (x.shape[-1],), w, nkw.get("eps", 1e-6))
    return dict(
        shape=str(tuple(x.shape)), ms=graph_ms(kernel, 50),
        plain_ms=graph_ms(plain, 50), bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(library, 50), eager_ms=cuda_ms(kernel, 50),
        library_eager_ms=cuda_ms(library, 50), bytes=n_bytes)


def norm_rows_by_width(label, spy):
    """``norm_row`` at every prefill width the path launched (the call
    with the most rows per width), printed; returns the rows by width."""
    widest = {}
    for (args, kw) in spy.calls.values():
        x = args[0]
        if x.dim() >= 3 and x.shape[1] > 1 and (
                x.shape[-1] not in widest
                or x.numel() > widest[x.shape[-1]][0][0].numel()):
            widest[x.shape[-1]] = (args, kw)
    rows = {}
    for d in sorted(widest):
        (x, w), kw = widest[d]
        rows[d] = norm_row(x, w, kw)
        print(f"{label} rmsnorm at prefill width {d} "
              f"(vs F.rms_norm, device ms from a CUDA graph) "
              + json.dumps(rows[d]))
    return rows


def attention_row(q, k, v, akw, library=None):
    """``flash_attention`` at one shape: the kernel's ms, the plain
    version's, the library call's where given, TFLOP/s against the
    bound's operation count, the bound and what bounds it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_torch)
    n_bytes, flops = attn_cost(q, k, v, causal=akw.get("causal", True),
                               window=akw.get("window"),
                               prefix_len=akw.get("prefix_len"))
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **akw), 20)
    pre = akw.get("prefix_len")
    return dict(
        shape=str(tuple(q.shape)) + f" window={akw.get('window')} "
              f"softcap={akw.get('softcap')} causal={akw.get('causal', True)}"
              + ("" if pre is None else f" prefix={pre.tolist()}"),
        ms=ms, tflops=flops / ms / 1e9,
        plain_ms=cuda_ms(lambda: flash_attention_torch(q, k, v, **akw), 3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=None if library is None else cuda_ms(library, 20),
        bytes=n_bytes, flops=flops, args=((q, k, v), akw))


def decode_row(q, kc, vc, pos, dkw):
    """``flash_decode`` at one shape: the kernel's, the plain version's
    and (without a softcap, where it computes the same function)
    ``scaled_dot_product_attention``'s device ms from a CUDA graph of
    calls that take turns over copies of the cache holding three times
    the L2, so each reads the cache from device memory as the path's
    layers do; the kernel's and the library's back-to-back ms on one
    cache beside them (``*_eager_ms``, the path's launch cost and an L2
    that is warm); the bound and what bounds it."""
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_torch,
                                                  valid_slots)
    ring = dkw.get("ring", False)
    n_bytes, flops = decode_cost(q, kc, vc, pos, ring=ring)
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    cache = kc.numel() * kc.element_size() + vc.numel() * vc.element_size()
    copies = [(kc, vc)] + [(kc.clone(), vc.clone())
                           for _ in range(-(-3 * L2_BYTES // cache))]
    turn = itertools.count()
    mask = valid_slots(pos, kc.shape[1], ring)[:, None, None, :]

    def kernel():
        k, v = copies[next(turn) % len(copies)]
        return flash_decode_cuda(q, k, v, pos, **dkw)

    def plain():
        k, v = copies[next(turn) % len(copies)]
        return flash_decode_torch(q, k, v, pos, **dkw)

    def library(k=kc, v=vc):
        return sdpa(q[:, None], k, v, mask, False, dkw.get("scale"))[:, 0]

    def library_turns():
        return library(*copies[next(turn) % len(copies)])
    plain_lib = dkw.get("softcap") is None

    def ten_calls():
        for _ in range(10):
            kernel()
    # the device ms of each of the kernel's launches (split, combine)
    by_kernel = {}
    for e in profile_step(ten_calls, {}).get("top_device_time_per_step", []):
        name = re.search(r"decode_\w+_kernel", e["name"])
        if name:
            by_kernel[name.group(0)] = e["ms"] / 10
    return dict(
        shape=f"q {tuple(q.shape)} cache {tuple(kc.shape)} ring={ring} "
              f"softcap={dkw.get('softcap')} pos={pos.tolist()}",
        ms=graph_ms(kernel, 50), plain_ms=graph_ms(plain, 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(library_turns, 50) if plain_lib else None,
        eager_ms=cuda_ms(lambda: flash_decode_cuda(q, kc, vc, pos, **dkw),
                         50),
        library_eager_ms=cuda_ms(library, 50) if plain_lib else None,
        device_ms_by_kernel=by_kernel or "not measured",
        copies=len(copies), bytes=n_bytes, flops=flops,
        args=((q, kc, vc, pos), dkw))


def serving_kernel_rows(label, spies):
    """Per serving kernel at its largest path shape: the kernel's, the
    plain version's and (where one exists) the library call's ms from
    CUDA events, the bound and what bounds it; ``rmsnorm`` at every
    prefill width, printed."""
    rows = {"rmsnorm": max(norm_rows_by_width(label, spies["rmsnorm"])
                           .values(), key=lambda row: row["bytes"])}

    def attn_key(kv):
        (q, k, v), kw = kv[1]
        return attn_cost(q, k, v, causal=kw.get("causal", True),
                         window=kw.get("window"))[1]
    _, ((q, k, v), akw) = max(spies["flash_attention"].calls.items(),
                              key=attn_key)
    # no library call softcaps; without a softcap and a window, causal
    # scaled_dot_product_attention computes the same function
    library = None
    if akw.get("softcap") is None and akw.get("window") is None:
        def library():
            return sdpa(q, k, v, None, akw.get("causal", True),
                        akw.get("scale"))
    rows["flash_attention"] = attention_row(q, k, v, akw, library)

    def dec_key(kv):
        (q, kc, vc, pos), kw = kv[1]
        return decode_cost(q, kc, vc, pos, ring=kw.get("ring", False))[0]
    _, ((dq, dkc, dvc, dpos), dkw) = max(spies["flash_decode"].calls.items(),
                                         key=dec_key)
    rows["flash_decode"] = decode_row(dq, dkc, dvc, dpos, dkw)
    return rows


def print_rows(label, rows):
    for name, row in rows.items():
        print(f"{label} {name} " + json.dumps(
            {k: v for k, v in row.items() if k != "args"}))


def serve_phase(dev):
    """Serve gemma2-2b at full width and depth in bf16 (runs A, B, C),
    check it and time it; returns the three kernels' JSON entries."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     visible)
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  valid_slots)
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.models.layers import embed_tokens, softcap
    from repro_torch.models.model import _head
    from repro_torch.runtime import (generate, make_prefill, make_serve_step,
                                     pad_cache_to)

    # the plain versions' einsums and the model's matmuls in full float32
    # where they take float32 (the plain attention's scores), never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ARCHS[SERVE_ARCH]
    n_layers = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    redraw(params, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve: {cfg.name} {n_layers} layers d={cfg.d_model} "
          f"params={n_params} ({n_params * 2 / 1e9:.2f} GB bf16) "
          f"init_s={time.perf_counter() - t0:.1f}")
    ctx = ShardCtx()

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    # warm-up (cuBLAS handles, kernel libraries loaded): not counted
    generate(cfg, ctx, params, {"tokens": tokens(1, 16)}, 2)
    torch.cuda.synchronize()

    prompt_a = tokens(RUN_A["batch"], RUN_A["prompt"])
    prompt_b = tokens(RUN_B["batch"], RUN_B["prompt"])
    reqs = ragged_requests(cfg.vocab)

    def want(n_pre, n_dec):
        return {"rmsnorm": (n_pre + n_dec) * (4 * n_layers + 1),
                "flash_attention": n_pre * n_layers,
                "flash_decode": n_dec * n_layers}

    runs, launches = {}, {}
    keys = spy_keys()
    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in SERVE_KERNELS}
        for name, run, prompt, rq in (("A", RUN_A, prompt_a, None),
                                      ("B", RUN_B, prompt_b, None),
                                      ("C", RUN_C, None, reqs)):
            runs[name], launches[name] = drive(
                "serve", name, run, cfg, params, spies, want, prompt=prompt,
                reqs=rq)

    stress = stress_cases(gen, dev)
    max_err = check_against_plain("serve", spies, plain_versions(), stress,
                                  ops)
    check_teacher_forced("serve", cfg, params, prompt_a, runs["A"]["out"],
                         ops)
    check_batched_equals_alone("serve", cfg, params, reqs, dev)

    # -- per kernel at its largest path shape --------------------------------
    rows = serving_kernel_rows("serve", spies)
    print_rows("serve", rows)

    # side rows: no softcap, against scaled_dot_product_attention (which
    # cannot softcap), the window passed as an explicit mask
    (q, k, v), akw = rows["flash_attention"]["args"]
    side = []
    for label, win in (("global", None), ("local", cfg.window)):
        s = q.shape[1]
        scale = akw.get("scale")
        mask = None if win is None else \
            visible(s, causal=True, window=win, device=dev)
        got = flash_attention_cuda(q, k, v, window=win, scale=scale)
        lib = sdpa(q, k, v, mask, True, scale)
        row = attention_row(q, k, v, dict(window=win, scale=scale),
                            lambda: sdpa(q, k, v, mask, True, scale))
        side.append(dict(
            kernel="flash_attention", softcap=None, layer=label,
            max_abs_diff=float((got.float() - lib.float()).abs().max()),
            **{k_: v_ for k_, v_ in row.items() if k_ != "args"}))
    (dq, dkc, dvc, dpos), dkw = rows["flash_decode"]["args"]
    dmask = valid_slots(dpos, dkc.shape[1], dkw["ring"])[:, None, None, :]
    nkw = dict(ring=dkw["ring"], scale=dkw.get("scale"))
    got = flash_decode_cuda(dq, dkc, dvc, dpos, **nkw)
    lib = sdpa(dq[:, None], dkc, dvc, dmask, False, nkw["scale"])[:, 0]
    row = decode_row(dq, dkc, dvc, dpos, nkw)
    side.append(dict(
        kernel="flash_decode", softcap=None,
        max_abs_diff=float((got.float() - lib.float()).abs().max()),
        **{k_: v_ for k_, v_ in row.items() if k_ != "args"}))
    for row in side:
        print("side row (no softcap) vs scaled_dot_product_attention "
              + json.dumps(row))

    # -- where one decode step's time goes (run A's shape) -------------------
    prefill = make_prefill(cfg, ctx)
    logits, cache = prefill(params, {"tokens": prompt_a})
    b, s = prompt_a.shape
    cache = pad_cache_to(cfg, cache, b, s + RUN_A["gen"])
    tok = logits.argmax(-1)[:, None]
    parts = {"embed": [], "layers": [], "head": [], "argmax": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = embed_tokens(tok, params.embed, cfg.embed_scale_by_dim)
        torch.cuda.synchronize()
        parts["embed"].append(time.perf_counter() - t)
        t = time.perf_counter()
        for i, layer in enumerate(params.layers):
            x, _, _ = layer(x, cfg=cfg, mode="decode", positions=s,
                            cache=cache[i])
        torch.cuda.synchronize()
        parts["layers"].append(time.perf_counter() - t)
        t = time.perf_counter()
        lg = softcap(_head(params, x, cfg)[:, 0], cfg.logit_softcap)
        torch.cuda.synchronize()
        parts["head"].append(time.perf_counter() - t)
        t = time.perf_counter()
        lg.argmax(-1)[:, None]
        torch.cuda.synchronize()
        parts["argmax"].append(time.perf_counter() - t)
    step = make_serve_step(cfg, ctx)
    breakdown = {k: float(np.median(v)) * 1e3 for k, v in parts.items()}
    profile_step(lambda: step(params, cache, tok, s), breakdown)
    print("decode step breakdown (run A shape, host ms, synchronised per "
          "part) " + json.dumps(breakdown))

    return [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu",
        replaces={"rmsnorm": "src/repro/kernels/rmsnorm.py:29",
                  "flash_attention": "src/repro/kernels/flash_attention.py:86",
                  "flash_decode": "src/repro/kernels/flash_decode.py:70"}[name],
        launches=sum(launches[r][name] for r in launches),
        launches_by_path={f"serve_{r}": launches[r][name] for r in launches},
        max_abs_err=max_err[name], ms=rows[name]["ms"],
        plain_ms=rows[name]["plain_ms"], bound_ms=rows[name]["bound_ms"],
        bound_by=rows[name]["bound_by"], library_ms=rows[name]["library_ms"],
        shape=rows[name]["shape"]) for name in SERVE_KERNELS]


def ssm_phase(dev):
    """Serve mamba2-780m (runs A, B, C) and zamba2-7b (run D) at full
    width and depth in bf16, check them and time them. Returns the
    ``ssd_scan`` JSON entry and, per serving kernel, its counts by run
    and its largest error against the plain version here."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_torch
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = ShardCtx()
    runs, launches, breakdowns = {}, {}, {}
    keys = spy_keys()

    def load(arch):
        cfg = ARCHS[arch]
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, dev)
        redraw(params, gen, dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"ssm: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
              f"heads={cfg.ssm_heads}x{cfg.ssm_headdim} "
              f"state={cfg.ssm_state} chunk={cfg.ssm_chunk} "
              f"params={n_params} ({n_params * 2 / 1e9:.2f} GB bf16) "
              f"init_s={time.perf_counter() - t0:.1f}")
        generate(cfg, ctx, params, {"tokens": torch.randint(
            0, cfg.vocab, (1, 16), generator=gen, device=dev)}, 2)  # warm-up
        torch.cuda.synchronize()
        return cfg, gen, params

    def want_of(cfg):
        n_rep = cfg.repeat_structure()[1] if cfg.shared_attn_every else 0
        n = cfg.n_layers

        def want(n_pre, n_dec):
            return {"rmsnorm": (n_pre + n_dec) * (2 * n + 2 * n_rep + 1),
                    "flash_attention": n_pre * n_rep,
                    "flash_decode": n_dec * n_rep,
                    "ssd_scan": n_pre * n}
        return want

    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in SSM_KERNELS}

        # -- mamba2-780m: runs A, B, C ---------------------------------------
        cfg, gen, params = load("mamba2-780m")
        prompt_a = torch.randint(0, cfg.vocab, (SSM_RUN_A["batch"],
                                                SSM_RUN_A["prompt"]),
                                 generator=gen, device=dev)
        prompt_b = torch.randint(0, cfg.vocab, (SSM_RUN_B["batch"],
                                                SSM_RUN_B["prompt"]),
                                 generator=gen, device=dev)
        reqs = ragged_requests(cfg.vocab)
        for name, run, prompt, rq in (("A", SSM_RUN_A, prompt_a, None),
                                      ("B", SSM_RUN_B, prompt_b, None),
                                      ("C", RUN_C, None, reqs)):
            runs[name], launches[name] = drive(
                "mamba2", name, run, cfg, params, spies, want_of(cfg),
                prompt=prompt, reqs=rq)
        check_teacher_forced_f32("mamba2", cfg, params, prompt_a,
                                 runs["A"]["out"], ops)
        check_batched_equals_alone("mamba2", cfg, params, reqs, dev)
        breakdowns["mamba2_A"] = decode_breakdown(
            "mamba2 run A shape", cfg, params, prompt_a, SSM_RUN_A["gen"])
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # -- zamba2-7b: run D ------------------------------------------------
        cfg, gen, params = load("zamba2-7b")
        prompt_d = torch.randint(0, cfg.vocab, (SSM_RUN_D["batch"],
                                                SSM_RUN_D["prompt"]),
                                 generator=gen, device=dev)
        runs["D"], launches["D"] = drive(
            "zamba2", "D", SSM_RUN_D, cfg, params, spies, want_of(cfg),
            prompt=prompt_d)
        breakdowns["zamba2_D"] = decode_breakdown(
            "zamba2 run D shape", cfg, params, prompt_d, SSM_RUN_D["gen"])
        print(f"zamba2 peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params
        gc.collect()
        torch.cuda.empty_cache()

    max_err = check_against_plain("ssm", spies, plain_versions(),
                                  stress_cases(gen, dev), ops)
    rows = serving_kernel_rows("ssm", {k: spies[k] for k in SERVE_KERNELS})
    print_rows("ssm", rows)
    # zamba2's shared block has no softcap and no window: causal
    # scaled_dot_product_attention computes the same function
    (q, k, v), akw = rows["flash_attention"]["args"]
    if rows["flash_attention"]["library_ms"] is not None:
        got = flash_attention_cuda(q, k, v, **akw)
        lib = sdpa(q, k, v, None, akw.get("causal", True), akw.get("scale"))
        print("ssm side row (no softcap, no window) vs "
              "scaled_dot_product_attention " + json.dumps(dict(
                  kernel="flash_attention", shape=str(tuple(q.shape)),
                  ms=rows["flash_attention"]["ms"],
                  library_ms=rows["flash_attention"]["library_ms"],
                  max_abs_diff=float((got.float() - lib.float()).abs()
                                     .max()))))

    # ssd_scan at every path shape of the generate runs (A, B, D) and of
    # run C's prompts: kernel and plain ms, bound
    scan_rows = []
    by_flops = sorted(spies["ssd_scan"].calls.values(),
                      key=lambda call: -ssd_cost(*call[0])[1])
    for args, _ in by_flops:
        x, dt, A, B, C, chunk = args
        n_bytes, flops = ssd_cost(x, dt, A, B, C, chunk)
        b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
        got, want = ssd_scan_cuda(*args), ssd_scan_torch(*args)
        scan_rows.append(dict(
            run=(SCAN_RUNS.get(tuple(x.shape), "other")
                 if x.dtype == torch.bfloat16 else "float32 check"),
            shape=f"x {tuple(x.shape)} B {tuple(B.shape)} chunk {chunk}",
            gate_ratio_y=gate_ratio(got[0], want[0]),
            gate_ratio_state=gate_ratio(got[1], want[1]),
            ms=cuda_ms(lambda: ssd_scan_cuda(x, dt, A, B, C, chunk), 10),
            plain_ms=cuda_ms(lambda: ssd_scan_torch(x, dt, A, B, C, chunk),
                             3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=n_bytes,
            flops=flops))
        print("ssd_scan " + json.dumps(scan_rows[-1]))
    top = scan_rows[0]
    # where the largest call's time goes: device ms per launch of each
    # pass (the profiler's total over the launches it saw)
    x, dt, A, B, C, chunk = by_flops[0][0]
    passes = profile_step(lambda: ssd_scan_cuda(x, dt, A, B, C, chunk),
                          {}).get("top_device_time_per_step", [])
    top["passes_ms"] = {e["name"]: e["ms"] / e["calls"] for e in passes}
    print(f"ssd_scan passes at {top['shape']} "
          + json.dumps(top["passes_ms"]))
    label = {"A": "mamba2_A", "B": "mamba2_B", "C": "mamba2_C",
             "D": "zamba2_D"}
    by_run = {k: {label[r]: launches[r][k] for r in launches}
              for k in SSM_KERNELS}
    ssd_entry = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:74",
        launches=sum(by_run["ssd_scan"].values()),
        launches_by_path=by_run["ssd_scan"],
        max_abs_err=max_err["ssd_scan"], ms=top["ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by=top["bound_by"], library_ms=None, shape=top["shape"])
    return ssd_entry, by_run, max_err


# -- 8. dense sim_step relaxation; 9. the device-resident GA; 10. the
#       verifier ----------------------------------------------------------

DEVICE_GA_APPS = ("64core", "256core")


def dense_bounds(b, s, depth):
    """(call bound ms, streaming bound ms, by): inputs read once and the
    output written once over the memory rate, against two adds and a max
    per (b, s, j) over the float32 rate; the streaming bound re-reads the
    lags, the ends, the durations and the floors every sweep."""
    n_bytes = 2 * b * s * s * 4 + 2 * b * s * 4 + b * s * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * b * s * s / FP32_OPS_PER_S * 1e3
    per_sweep = (2 * b * s * s * 4 + 4 * b * s * 4) / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), depth * per_sweep,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes)


def dense_args(batch, dur, dev):
    """``dense_lags`` of a lowered batch, with its host ms, and the dense
    kernel's inputs on the card (float32, contiguous)."""
    import numpy as np
    import torch

    from repro_torch.core.lowering import dense_lags
    t0 = time.perf_counter()
    lat, volbw = dense_lags(batch)
    host_ms = (time.perf_counter() - t0) * 1e3
    args = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            for x in (lat, volbw, dur, batch.release)]
    return args, host_ms


def dense_phase(dev, runs):
    """The reference's dense path on the four offline shapes:
    ``lint_batch`` -> ``dense_lags`` -> ``ops.sim_relax(n_steps=depth)``,
    each shape's result held to its plain version (``torch.equal``), to
    the float64 ``relax_batch_np`` and to the sparse ``simulate_batch``
    of phase 2 (rtol 1e-5); ``ops.sim_step`` against its plain version at
    ragged stress shapes with -inf and NaN."""
    import numpy as np
    import torch

    from repro_torch.analysis import lint_batch
    from repro_torch.core import batch_scenarios, lower_scenario
    from repro_torch.core.sim_engine import _jitter_durations, relax_batch_np
    from repro_torch.kernels import ops
    from repro_torch.kernels.sim_step import (_dense_relax_cuda,
                                              compact_lags_cuda,
                                              compact_lags_torch,
                                              fixpoint_sweeps_torch, pop_plan,
                                              sim_relax_cuda,
                                              sim_relax_pop_cuda,
                                              sim_relax_torch, sim_step_cuda,
                                              sim_step_torch)

    shapes = []
    for r in runs:
        batch = batch_scenarios([lower_scenario(g, r["machine"], sc)
                                 for g, sc in zip(r["graphs"],
                                                  r["schedules"])])
        lint_batch(batch)
        dur = _jitter_durations(batch, r["jitter"], r["seeds"])
        shapes.append((r, batch, dur))
    ops.sim_relax.launches = ops.sim_step.launches = 0
    ops.sim_relax.variants = {"compact": 0, "dense": 0}
    ops.sim_relax_pop.launches = 0
    outs = []
    for r, batch, dur in shapes:
        args, host_ms = dense_args(batch, dur, dev)
        outs.append((args, host_ms,
                     ops.sim_relax(*args, n_steps=batch.depth)))
    torch.cuda.synchronize()
    launches = ops.sim_relax.launches + ops.sim_step.launches
    variants = dict(ops.sim_relax.variants)
    print(f"dense path launches: sim_relax {ops.sim_relax.launches} "
          f"(variants {variants}), sim_step {ops.sim_step.launches}, "
          f"ops.sim_relax_pop {ops.sim_relax_pop.launches}")
    if launches == 0:
        fail("kernel sim_step was never launched on the dense path")
    if variants != {"compact": len(shapes), "dense": 0}:
        fail(f"sim_relax: the compact variant did not give every shape "
             f"({variants})")
    if ops.sim_relax_pop.launches:
        fail("sim_relax moved ops.sim_relax_pop's count")

    rows, err = [], 0.0
    for (r, batch, dur), (args, host_ms, got) in zip(shapes, outs):
        name, depth = r["name"], batch.depth
        want = sim_relax_torch(*args, n_steps=depth)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"sim_step {name}: kernel != plain version, max abs err "
                 f"{(got - want).abs().max().item():.3e}")
        end = got.cpu().numpy().astype(np.float64)
        for ref_name, ref in (("relax_batch_np", relax_batch_np(batch, dur)),
                              ("sparse simulate_batch",
                               r["res"].subtask_end)):
            if not np.allclose(end, ref, rtol=RTOL_F32, atol=0.0):
                rel = np.abs(end - ref) / np.maximum(np.abs(ref), 1e-30)
                fail(f"sim_step {name}: dense vs {ref_name} rel err "
                     f"{rel.max():.3e} > {RTOL_F32}")
        b, s = batch.n_scenarios, batch.max_subtasks
        # the compaction and the stopped relaxation, each against its
        # plain version: the same form, the same sweeps per row
        _, info = sim_relax_cuda(*args, n_steps=depth, with_info=True)
        comp = compact_lags_cuda(*args)
        want_comp = compact_lags_torch(*args)
        if not all(torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(comp, want_comp)):
            fail(f"sim_step {name}: compact_lags kernel != plain version")
        _, want_sweeps = fixpoint_sweeps_torch(*want_comp[:3], *args[2:],
                                               n_steps=depth)
        if not (bool(info.compact.all())
                and torch.equal(info.sweeps, want_sweeps.cpu())):
            fail(f"sim_step {name}: compact variant's sweeps (max "
                 f"{int(info.sweeps.max())}) != the plain stop's (max "
                 f"{int(want_sweeps.max())}) or a scenario went dense")
        del want_comp
        bound, stream, by, n_bytes = dense_bounds(b, s, depth)
        ms = cuda_ms(lambda: sim_relax_cuda(*args, n_steps=depth), 5)
        compact_ms = cuda_ms(lambda: compact_lags_cuda(*args), 5)
        relax_ms = cuda_ms(lambda: sim_relax_pop_cuda(
            *comp[:3], *args[2:], n_steps=depth, with_sweeps=True,
            with_overflow=True), 10)
        dense_out = torch.empty((b, s), device=dev)
        dense_ms = cuda_ms(lambda: _dense_relax_cuda(
            *args, depth, None, dense_out), 2)
        if not torch.equal(dense_out, want):
            fail(f"sim_step {name}: dense variant != plain version")
        end0 = torch.zeros((b, s), device=dev)
        sweep_ms = cuda_ms(lambda: sim_step_cuda(end0, *args), 20)
        plain_ms = cuda_ms(lambda: sim_relax_torch(*args, n_steps=depth), 2)
        plan = pop_plan(*comp.pred.shape)
        rows.append(dict(name=name, B=b, S=s, depth=depth, ms=ms,
                         variant="compact", P1=info.p1,
                         sweeps_max=int(info.sweeps.max()),
                         sweeps_median=float(info.sweeps.float().median()),
                         relax_plan=f"k {plan.k} {plan.variant}",
                         compact_ms=compact_ms, relax_ms=relax_ms,
                         dense_variant_ms=dense_ms,
                         sweep_ms=sweep_ms, plain_ms=plain_ms,
                         bound_ms=bound, streaming_bound_ms=stream,
                         bound_by=by, bytes=n_bytes,
                         dense_lags_host_ms=host_ms,
                         max_abs_err=(got - want).abs().max().item()))
        err = max(err, rows[-1]["max_abs_err"])
        print("sim_step " + json.dumps(rows[-1]))
        del args, got, want, comp, dense_out
        torch.cuda.empty_cache()

    # ops.sim_step against its plain version: ragged S, -inf and NaN
    rng = np.random.default_rng(1)
    for b, s in ((3, 37), (4, 1000)):
        x = [rng.uniform(0.0, 50.0, (b, s)),
             np.where(rng.random((b, s, s)) < 0.05,
                      rng.uniform(0.0, 1e-4, (b, s, s)), -np.inf),
             None, rng.uniform(0.1, 5.0, (b, s)),
             rng.uniform(0.0, 20.0, (b, s))]
        x[2] = np.where(np.isfinite(x[1]), rng.uniform(0.0, 2.0, (b, s, s)),
                        -np.inf)
        x = [a.astype(np.float32) for a in x]
        args = [torch.from_numpy(a).to(dev) for a in x]
        got, want = ops.sim_step(*args), sim_step_torch(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"sim_step stress ({b}, {s}): kernel != plain version")
        x[1][rng.random((b, s, s)) < 1e-3] = np.nan
        x[0][0, 5] = np.inf             # inf + -inf: NaN where no edge
        x[3][1, :3] = np.nan
        args = [torch.from_numpy(a).to(dev) for a in x]
        got, want = ops.sim_step(*args), sim_step_torch(*args)
        torch.cuda.synchronize()
        if not torch.isnan(want).any() or not same_scores(got, want):
            fail(f"sim_step nan ({b}, {s}): kernel != plain version")
    print("sim_step stress (3, 37), (4, 1000) with -inf and NaN: equal")

    # ops.sim_relax: a clean scenario (compact), NaN lags and an +inf
    # duration (dense from the start), ends that overflow (compact,
    # flagged, redone dense); 16-byte and 4-byte dense rows
    for b, s in ((4, 256), (4, 257)):
        lat = np.where(rng.random((b, s, s)) < 0.05,
                       rng.uniform(0.0, 1e-4, (b, s, s)), -np.inf)
        volbw = np.where(lat > -np.inf, rng.uniform(0.0, 2.0, (b, s, s)),
                         -np.inf)
        dur = rng.uniform(0.1, 5.0, (b, s))
        rel = rng.uniform(0.0, 20.0, (b, s))
        lat[1][tuple(np.argwhere(lat[1] > -np.inf)[0])] = np.nan
        dur[2, 3] = np.inf
        dur[3] = 2e37
        args = [torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in (lat, volbw, dur, rel)]
        before = dict(ops.sim_relax.variants)
        got = ops.sim_relax(*args, n_steps=60)
        want = sim_relax_torch(*args, n_steps=60)
        _, info = sim_relax_cuda(*args, n_steps=60, with_info=True)
        torch.cuda.synchronize()
        if ops.sim_relax.variants != {k: v + 1 for k, v in before.items()}:
            fail(f"sim_relax stress ({b}, {s}): variant counts "
                 f"{ops.sim_relax.variants} from {before}")
        if (info.compact.tolist() != [True, False, False, False]
                or info.redone.tolist() != [False, False, False, True]):
            fail(f"sim_relax stress ({b}, {s}): variants {info}")
        if not torch.isnan(want[3]).any() or not same_scores(got, want):
            fail(f"sim_relax stress ({b}, {s}): kernel != plain version")
    print("sim_relax stress (4, 256), (4, 257) with NaN, +inf and overflow: "
          "equal; compact and dense variants both ran")
    main_row = max(rows, key=lambda x: x["bytes"])
    return dict(
        name="sim_step", route="cuda",
        source="src/repro_torch/kernels/csrc/sim_step.cu",
        replaces="src/repro/kernels/sim_step.py:107", launches=launches,
        launches_by_path={"dense": launches}, max_abs_err=err,
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, shape=main_row["name"],
        variants=variants, compact_ms=main_row["compact_ms"],
        relax_ms=main_row["relax_ms"], sweeps_max=main_row["sweeps_max"],
        sweep_ms=main_row["sweep_ms"],
        streaming_bound_ms=main_row["streaming_bound_ms"])


def device_ga_apps():
    from repro_torch.core import (SynthParams, cluster_of_multicores,
                                  generate_app, hp_bl260c,
                                  paper_suite_64core)
    big64 = max(paper_suite_64core(n_apps=10, seed=100),
                key=lambda g: g.n_subtasks)
    return [("64core", hp_bl260c(), big64),
            ("256core", cluster_of_multicores(32),
             generate_app(SynthParams(n_tasks=(240, 280)), seed=300))]


def replay_device_ga(graph, machine, par, dev, seed=0):
    """``ga_search_device``'s loop run by hand from the search's public
    pieces (``device_inputs``, ``generation_step``,
    ``hill_climb_device``), so that the final population and the refine
    rounds actually run can be read. Returns ``(inp, vec, val, pop, fit,
    rounds)``; the phase holds ``(vec, val)`` to ``ga_search``'s."""
    import numpy as np
    import torch

    from repro_torch.search import device, hill_climb_device

    n_tasks, n_cores = len(graph.tasks), machine.n_cores
    inp = device.device_inputs(graph, machine, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pop = torch.randint(0, max(n_cores, 1), (par.pop_size, n_tasks),
                        generator=gen, device=dev, dtype=torch.int32)
    fit = device.population_fitness_device(inp, pop, method="kernel")
    step = device.generation_step(par, n_tasks=n_tasks, n_cores=n_cores,
                                  method="kernel")
    for _ in range(par.generations):
        pop, fit = step(inp, gen, pop, fit)
    best = int(torch.argmin(fit))
    rounds = [0]

    def counted(inp_, genes):
        rounds[0] += 1
        return device.population_fitness_device(inp_, genes,
                                                method="kernel")

    vec, val = hill_climb_device(
        counted, inp, pop[best].cpu().numpy().astype(np.int32),
        float(fit[best]), generator=gen, rounds=par.refine_rounds,
        moves=par.refine_moves, n_cores=n_cores)
    return inp, vec, val, pop, fit, rounds[0]


def device_ga_phase(dev):
    """``ga_search`` with ``GAParams(device=True)`` at the defaults on
    the card: determinism, kernel fitness == scan fitness on the final
    population, the winner's fitness against the float64 append-only
    decode, ``ga_schedule(device=True) <= engine``, and the
    ``sim_relax_pop`` launch count per search."""
    import numpy as np
    import torch

    from repro_torch.core import (get_scheduler, lower_population,
                                  simulate_batch, validate)
    from repro_torch.kernels import ops
    from repro_torch.kernels.sim_step import (sim_relax_pop_cuda,
                                              sim_relax_pop_torch)
    from repro_torch.search import GAParams, decode, ga_schedule, ga_search
    from repro_torch.search import device

    par = GAParams(device=True)
    rows, pop_rows, total = [], [], 0
    for name, machine, graph in device_ga_apps():
        runs = []
        for _ in range(2):
            ops.sim_relax_pop.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vec, val = ga_search(graph, machine, seed=0, params=par)
            torch.cuda.synchronize()
            runs.append((vec, val, time.perf_counter() - t0,
                         ops.sim_relax_pop.launches))
        (v1, f1, wall1, n1), (v2, f2, wall2, n2) = runs
        if not (np.array_equal(v1, v2) and f1 == f2):
            fail(f"device GA {name}: two runs with seed 0 differ "
                 f"({f1!r} vs {f2!r})")
        inp, rv, rf, pop, fit, rounds = replay_device_ga(graph, machine,
                                                         par, dev)
        if not (np.array_equal(rv, v1) and rf == f1):
            fail(f"device GA {name}: the loop replayed by hand ends at "
                 f"{rf!r}, the search at {f1!r}")
        if not 0 <= rounds <= par.refine_rounds:
            fail(f"device GA {name}: {rounds} refine rounds, not within "
                 f"0..{par.refine_rounds}")
        for n in (n1, n2):
            if n != 1 + par.generations + rounds:
                fail(f"device GA {name}: {n} sim_relax_pop launches, not "
                     f"1 + {par.generations} + {rounds} refine rounds")
        total += n1 + n2
        kern = device.population_fitness_device(inp, pop, method="kernel")
        scan = device.population_fitness_device(inp, pop, method="scan")
        torch.cuda.synchronize()
        if not (torch.equal(kern, scan) and torch.equal(kern, fit)):
            fail(f"device GA {name}: kernel fitness != scan fitness on the "
                 f"final population")
        sch = decode(graph, machine, v1, gap_fill=False)
        f64 = simulate_batch(lower_population(graph, machine, [sch]),
                             backend="numpy").t_exec[0]
        if not abs(f1 - f64) <= RTOL_F32 * abs(f64):
            fail(f"device GA {name}: winner fitness {f1!r} vs float64 "
                 f"append-only decode {f64!r}")
        eng = get_scheduler("engine")(graph, machine)
        ga_sch = ga_schedule(graph, machine, seed=0, params=par)
        validate(ga_sch, graph, machine, require_task_coherence=True)
        if ga_sch.makespan() > eng.makespan() + 1e-9:
            fail(f"device GA {name}: ga_schedule {ga_sch.makespan()!r} > "
                 f"engine {eng.makespan()!r}")
        # one generation in isolation, and the host GA for comparison
        step = device.generation_step(par, n_tasks=len(graph.tasks),
                                      n_cores=machine.n_cores,
                                      method="kernel")
        gen = torch.Generator(device=dev).manual_seed(1)
        gpop, gfit = step(inp, gen, pop, fit)      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            gpop, gfit = step(inp, gen, gpop, gfit)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3 / 10
        t0 = time.perf_counter()
        _, host_val = ga_search(graph, machine, seed=0,
                                params=GAParams(backend="cuda"))
        host_s = time.perf_counter() - t0
        rows.append(dict(name=name, S=graph.n_subtasks,
                         tasks=len(graph.tasks), cores=machine.n_cores,
                         fitness=f1, fitness_f64_appendonly=f64,
                         refine_rounds=rounds, launches=[n1, n2],
                         search_s=[wall1, wall2], ms_per_generation=gen_ms,
                         host_ga_s=host_s, host_ga_fitness=host_val,
                         ga_schedule=ga_sch.makespan(),
                         engine=eng.makespan()))
        print("device ga " + json.dumps(rows[-1]))
        args = [x.contiguous() for x in
                device.population_gather_inputs(inp, pop)]
        pop_rows.append(sim_row(f"device-ga-{name}{shapes(args[:1])[0]}",
                                args, inp.n_subtasks, ops,
                                sim_relax_pop_cuda, sim_relax_pop_torch))
        print("sim_relax_pop " + json.dumps(pop_rows[-1]))
    return total, pop_rows


def verify_phase(dev, runs):
    """``verify=True`` on the 64core suites (the kernel) and on the
    engine scheduler; a result with one finish time moved before its
    predecessor's must raise ``VerifyError``."""
    import dataclasses

    import numpy as np

    from repro_torch.analysis import VerifyError, verify_batch_result
    from repro_torch.core import (batch_scenarios, get_scheduler,
                                  lower_scenario, simulate_batch,
                                  simulate_suite)
    from repro_torch.kernels import ops

    ops.sim_relax_pop.launches = 0
    for r in runs:
        if r["name"].startswith("64core"):
            simulate_suite(r["graphs"], r["machine"], r["schedules"],
                           jitter=r["jitter"], seeds=r["seeds"],
                           backend="cuda", device=dev, verify=True)
    launches = ops.sim_relax_pop.launches
    if launches == 0:
        fail("verify: the 64core suites never launched sim_relax_pop")
    r = runs[0]
    sch = get_scheduler("engine", verify=True)(r["graphs"][0], r["machine"])
    batch = batch_scenarios([lower_scenario(r["graphs"][0], r["machine"],
                                            sch)])
    res = simulate_batch(batch, backend="cuda", device=dev, verify=True)
    s = batch.max_subtasks
    i = int(np.argmax(batch.pred[0, :, 0] < s))      # first with a pred
    q = int(batch.pred[0, i, 0])
    end = np.array(res.subtask_end)
    end[0, i] = end[0, q] - 1.0                      # before its pred ends
    bad = dataclasses.replace(res, subtask_end=end)
    try:
        verify_batch_result(batch, bad, rtol=RTOL_F32)
    except VerifyError as err:
        print(f"verify: corrupted result rejected ({sorted(err.kinds)})")
    else:
        fail("verify: a finish time moved before its predecessor's passed")
    print(f"verify: 64core suites and the engine schedule proven on the "
          f"card ({launches} sim_relax_pop launches)")
    return launches


#: each tracecheck entry's kernel launches per call on the card
TRACE_LAUNCHES = {"search.generation_step": {"sim_relax_pop": 1},
                  "sim.relax_pop": {"sim_relax_pop": 1},
                  "kernels.sched_score": {"sched_score": 1},
                  "online.admission_score": {"sched_score": 1},
                  "kernels.flash_attention": {"flash_attention": 1},
                  # abstract: fake CPU tensors, nothing launches
                  "runtime.pipelined_forward": {},
                  "autoplace.unit[gemma-2b]": {},
                  "autoplace.unit[gemma2-2b]": {}}


def analysis_phase(dev):
    """The port's lint over its tree and its tracecheck (``--quick``) on
    the card over the manifest; any finding fails. Each entry must launch
    its kernel once per call (the abstract model-stack entries, on fake
    CPU tensors, none), and the admission scorer must read back exactly
    once per call. Returns the reports."""
    from repro_torch.analysis import lint, tracecheck
    bad = lint.lint_paths(lint.default_paths())
    print(f"lint: {len(bad)} finding(s) over the port's tree")
    if bad:
        fail("lint: " + "; ".join(str(v) for v in bad))
    t0 = time.perf_counter()
    reports = tracecheck.run_tracecheck(quick=True, device=dev)
    for r in reports:
        print("tracecheck " + json.dumps(r.row()))
    print(f"tracecheck: {len(reports)} entries on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    bad = [str(v) for r in reports for v in r.violations]
    if bad:
        fail("tracecheck: " + "; ".join(bad))
    by = {r.entry: r for r in reports}
    if set(by) != set(TRACE_LAUNCHES):
        fail(f"tracecheck ran {sorted(by)}, not {sorted(TRACE_LAUNCHES)}")
    for name, want in TRACE_LAUNCHES.items():
        if by[name].launches != want:
            fail(f"tracecheck {name}: launches {by[name].launches}, "
                 f"expected {want}")
    syncs = by["online.admission_score"].host_syncs
    if len(syncs) != 1:
        fail(f"admission scorer: {len(syncs)} host read-backs per call "
             f"({syncs}), expected exactly 1")
    return reports


# -- 12. the paper's evaluation: T_est, and T_exec from the event
#        simulator, the batched simulator on the card and the threaded
#        executor; 13. MoE and MLA serving --------------------------------

PAPER_SUITES = (("8core", 20, 0, 4.0), ("64core", 8, 100, 6.0))  # band %
EXEC_SCALE = 1e-3                   # model seconds -> wall seconds


def dif_row(name, difs, band):
    """n, mean, max and min %Dif_rel of one source beside the paper's
    band (|%Dif| below it), as ``benchmarks/paper_tables.py`` reports."""
    import numpy as np
    d = np.asarray(difs, dtype=float)
    return dict(source=name, n=int(d.size), mean=float(d.mean()),
                max=float(d.max()), min=float(d.min()), band=band,
                within_band=bool((np.abs(d) < band).all()))


def paper_phase(dev):
    """The paper's 8-core suite (20 apps of 15-25 tasks, seed 0) on
    ``dell_poweredge_1950`` and its 64-core suite (8 apps, seed 100) on
    ``hp_bl260c``, mapped by ``get_scheduler("engine")`` (T_est = the
    makespan). T_exec from three sources: the contention-aware event
    simulator (jitter 0.01, seed i), ``simulate_suite(backend="cuda")``
    (``sim_relax_pop``, jitter 0.01) and ``execute_threaded`` at
    ``time_scale`` 1e-3, wall-clock. Checks: each threaded T_exec >=
    T_est, its T_exec == wall_seconds / time_scale, ``dif_rel`` exactly
    Eq. 4; the batched result within rtol 1e-5 of the float64 backend;
    ``sim_relax_pop`` launched. The band is printed, not gated: the
    threaded T_exec is wall-clock on a shared host. Returns the kernel's
    launches."""
    import numpy as np

    from repro_torch.core import (dell_poweredge_1950, execute_threaded,
                                  get_scheduler, hp_bl260c,
                                  paper_suite_8core, paper_suite_64core,
                                  simulate, simulate_suite)
    from repro_torch.kernels import ops

    mapper = get_scheduler("engine")
    launches = 0
    for name, n_apps, seed, band in PAPER_SUITES:
        machine, graphs = (
            (dell_poweredge_1950(), paper_suite_8core(n_apps, seed=seed))
            if name == "8core" else
            (hp_bl260c(), paper_suite_64core(n_apps, seed=seed)))
        t0 = time.perf_counter()
        schedules = [mapper(g, machine) for g in graphs]
        map_s = time.perf_counter() - t0
        t_est = [s.makespan() for s in schedules]
        seeds = list(range(len(graphs)))
        event = [simulate(g, machine, s, contention=True, jitter=JITTER,
                          seed=i).dif_rel(t_est[i])
                 for i, (g, s) in enumerate(zip(graphs, schedules))]
        ops.sim_relax_pop.launches = 0
        batched = simulate_suite(graphs, machine, schedules, jitter=JITTER,
                                 seeds=seeds, backend="cuda", device=dev)
        launches += ops.sim_relax_pop.launches
        if ops.sim_relax_pop.launches == 0:
            fail(f"paper {name}: simulate_suite never launched "
                 f"sim_relax_pop")
        f64 = simulate_suite(graphs, machine, schedules, jitter=JITTER,
                             seeds=seeds, backend="numpy")
        if not np.allclose(batched.subtask_end, f64.subtask_end,
                           rtol=RTOL_F32, atol=0.0):
            fail(f"paper {name}: batched T_exec off the float64 backend "
                 f"beyond rtol {RTOL_F32}")
        t0 = time.perf_counter()
        threaded = [execute_threaded(g, machine, s, time_scale=EXEC_SCALE)
                    for g, s in zip(graphs, schedules)]
        exec_s = time.perf_counter() - t0
        for i, (r, est) in enumerate(zip(threaded, t_est)):
            if not r.t_exec >= est:
                fail(f"paper {name} app {i}: threaded T_exec {r.t_exec!r} "
                     f"below T_est {est!r}")
            if r.t_exec != r.wall_seconds / EXEC_SCALE:
                fail(f"paper {name} app {i}: T_exec {r.t_exec!r} is not "
                     f"wall_seconds {r.wall_seconds!r} / {EXEC_SCALE}")
            if r.dif_rel(est) != (r.t_exec - est) / r.t_exec * 100.0:
                fail(f"paper {name} app {i}: dif_rel is not Eq. 4")
        rows = [dif_row("event", event, band),
                dif_row("batched_cuda", batched.dif_rel(), band),
                dif_row("threaded", [r.dif_rel(e) for r, e in
                                     zip(threaded, t_est)], band)]
        for row in rows:
            print(f"paper {name} %Dif_rel " + json.dumps(row))
        print(f"paper {name}: machine={machine.name!r} apps={len(graphs)} "
              f"subtasks={sum(g.n_subtasks for g in graphs)} "
              f"map_s={map_s:.3f} executor_wall_s={exec_s:.3f} (sum of "
              f"T_exec x time_scale "
              f"{sum(r.wall_seconds for r in threaded):.3f}) "
              f"sim_relax_pop launches {ops.sim_relax_pop.launches}")
    return launches


MOE_RUN_B = dict(batch=1, prompt=4096, gen=16)   # runs A and C: gemma2's
QWEN3_LAYERS = 8                    # of 94: about 42 GB in bf16, one card


@contextlib.contextmanager
def recorded_routes(forced=None):
    """Every ``router_topk`` call's ids (T, k), in call order, while the
    block runs. With ``forced`` (a list of ids from another run of the
    same calls) call i takes the experts ``forced[i]`` instead of its own
    top-k, weighted as ``router_topk`` weights its own
    (``moe.route_weights`` of its routing softmax)."""
    from repro_torch.models import moe
    calls = []
    real = moe.router_topk

    def router_topk(x, w_router, top_k):
        if forced is None:
            out = real(x, w_router, top_k)
        else:
            ids = forced[len(calls)]
            w, aux = moe.route_weights(moe.router_probs(x, w_router), ids)
            out = (w, ids, aux)
        calls.append(out[1])
        return out
    moe.router_topk = router_topk
    try:
        yield calls
    finally:
        moe.router_topk = real


def routes_by_position(calls, n_moe, b, s, n):
    """``recorded_routes`` of a ``teacher_forced`` run (one prefill of
    (B, S) tokens, then n - 1 decode steps) as (B, S + n - 1, layers, k)
    sorted ids: token position by MoE layer."""
    import torch
    if len(calls) != n_moe * n:
        fail(f"router called {len(calls)} times, expected {n_moe} layers "
             f"x {n} forwards")
    pre = torch.stack([c.reshape(b, s, -1) for c in calls[:n_moe]], dim=2)
    dec = [torch.stack([c.reshape(b, 1, -1) for c in
                        calls[n_moe * (i + 1):n_moe * (i + 2)]], dim=2)
           for i in range(n - 1)]
    return torch.cat([pre] + dec, dim=1).sort(dim=-1).values


def check_teacher_forced_routed(label, cfg, params, prompt, toks, ops, rel,
                                greedy=True):
    """``teacher_forced`` logits of the kernel path against the plain
    path (the three entry points swapped for their plain versions), with
    each MoE layer's chosen experts recorded on both.

    Routing is discrete: a rounding difference can send a token to other
    experts, and a token sent elsewhere changes every later token through
    attention. So the plain path runs twice. On its own routes it gives
    the share of (token, layer) routes that differ (overall and by
    layer), the share of positions held (the logits' position and every
    token before it routed alike on every layer) and the largest logit
    difference at a held position: printed. On the kernel path's routes
    (``recorded_routes(forced=...)``: the same experts, the plain path's
    own router weights at them) every position is routed alike by
    construction, and the gate holds the logits within ``rel`` of the
    largest logit at every position: the kernels against their plain
    versions through the whole MoE model."""
    import torch
    n_moe = sum(k.startswith("moe") for k in cfg.layer_kinds())
    b, s = prompt.shape
    n = toks.shape[1]
    with recorded_routes() as rk:
        kern = teacher_forced(cfg, params, prompt, toks)
    if not torch.isfinite(kern).all():
        fail(f"{label}: non-finite logits on the kernel path")
    if greedy and not torch.equal(kern.argmax(-1), toks):
        fail(f"{label}: re-running the kernel path gave other greedy tokens")
    with plain_serving_kernels(ops), recorded_routes() as rp:
        plain = teacher_forced(cfg, params, prompt, toks)
    with plain_serving_kernels(ops), recorded_routes(forced=rk) as rf:
        forced = teacher_forced(cfg, params, prompt, toks)
    route_k = routes_by_position(rk, n_moe, b, s, n)
    if not torch.equal(routes_by_position(rf, n_moe, b, s, n), route_k):
        fail(f"{label}: the forced plain run did not take the kernel "
             f"path's routes")
    differ = (route_k != routes_by_position(rp, n_moe, b, s, n)).any(-1)
    # logits position 0 is the prompt's last token's, i the i-th fed
    # token's; each depends on every token up to its own
    moved = differ.any(-1).cumsum(1) > 0             # (B, S + n - 1)
    same = ~moved[:, s - 1:]                         # (B, n)
    d = (kern - plain).abs().amax(-1)                # (B, n)
    scale = float(plain.abs().max())
    d_forced = float((kern - forced).abs().max())
    out = dict(positions=int(same.numel()), routes=int(differ.numel()),
               route_differ_share=float(differ.float().mean()),
               route_differ_share_by_layer=[
                   round(float(x), 5) for x in differ.float().mean((0, 1))],
               held=float(same.float().mean()),
               max_dlogit_held=float(d[same].max()) if same.any() else None,
               max_dlogit_own_routes=float(d.max()),
               max_dlogit_forced_routes=d_forced, bound=rel * scale,
               max_logit=scale,
               top1_forced=float((kern.argmax(-1) == forced.argmax(-1))
                                 .float().mean()))
    print(f"{label} teacher-forced ({cfg.dtype}) " + json.dumps(out))
    if not d_forced <= rel * scale:
        fail(f"{label}: kernel path logits off the plain path's on the "
             f"same routes by {d_forced:.4e} > {rel * scale:.4e}")
    return out


def weight_read_bound(params):
    """What one decode step must read at least: every weight but the
    embedding table (only its B rows are gathered), and of them the
    routed experts, in bytes and in ms at the memory rate."""
    every = sum(p.numel() * p.element_size()
                for name, p in params.named_parameters() if name != "embed")
    experts = sum(p.numel() * p.element_size()
                  for name, p in params.named_parameters()
                  if ".moe.w" in name)
    return dict(weight_bytes=every, expert_bytes=experts,
                bound_ms=every / HBM_BYTES_PER_S * 1e3,
                expert_bound_ms=experts / HBM_BYTES_PER_S * 1e3)


def moe_phase(dev):
    """Serve deepseek-v2-lite-16b whole (runs A, B, C) and
    qwen3-moe-235b-a22b at full width cut to 8 layers (run A) in bf16,
    check them and time them. Returns, per serving kernel, its counts by
    run and its largest error against the plain version here."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import decode_plan
    from repro_torch.models import ShardCtx, init_params
    from repro_torch.runtime import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = ShardCtx()
    keys = spy_keys()
    launches = {}

    def load(cfg, dtype="bfloat16"):
        cfg = cfg.replace(dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = init_params(cfg, gen, dev)
        redraw(params, gen, dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        size = sum(p.numel() * p.element_size() for p in params.parameters())
        print(f"moe: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
              f"heads={cfg.n_heads}/{cfg.n_kv_heads} experts="
              f"{cfg.n_experts} top-{cfg.top_k} of {cfg.d_ff_expert} "
              f"shared={cfg.n_shared_experts} kv_lora={cfg.kv_lora_rank} "
              f"{cfg.dtype} params={n_params} ({size / 1e9:.2f} GB) "
              f"init_s={time.perf_counter() - t0:.1f}")
        generate(cfg, ctx, params, {"tokens": torch.randint(
            0, cfg.vocab, (1, 16), generator=gen, device=dev)}, 2)  # warm-up
        torch.cuda.synchronize()
        return cfg, gen, params

    def want_of(cfg):
        norms = 2 + bool(cfg.kv_lora_rank) + 2 * cfg.qk_norm
        n = cfg.n_layers

        def want(n_pre, n_dec):
            return {"rmsnorm": (n_pre + n_dec) * (norms * n + 1),
                    "flash_attention": n_pre * n,
                    "flash_decode": 0 if cfg.kv_lora_rank else n_dec * n}
        return want

    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in SERVE_KERNELS}

        # -- deepseek-v2-lite-16b, whole: runs A, B, C -----------------------
        cfg, gen, params = load(ARCHS["deepseek-v2-lite-16b"])
        prompt_a = torch.randint(0, cfg.vocab, (RUN_A["batch"],
                                                RUN_A["prompt"]),
                                 generator=gen, device=dev)
        prompt_b = torch.randint(0, cfg.vocab, (MOE_RUN_B["batch"],
                                                MOE_RUN_B["prompt"]),
                                 generator=gen, device=dev)
        reqs = ragged_requests(cfg.vocab)
        runs = {}
        for name, run, prompt, rq in (("A", RUN_A, prompt_a, None),
                                      ("B", MOE_RUN_B, prompt_b, None),
                                      ("C", RUN_C, None, reqs)):
            runs[name], launches[f"deepseek_{name}"] = drive(
                "deepseek", name, run, cfg, params, spies, want_of(cfg),
                prompt=prompt, reqs=rq)
        if any(launches[f"deepseek_{r}"]["flash_decode"] for r in runs):
            fail("deepseek: the MLA decode launched flash_decode")
        check_teacher_forced_routed("deepseek run A", cfg, params, prompt_a,
                                    runs["A"]["out"], ops, LOGIT_REL)
        check_batched_equals_alone("deepseek", cfg, params, reqs, dev)
        decode_breakdown("deepseek run A shape", cfg, params, prompt_a,
                         RUN_A["gen"], weight_read_bound(params))
        del params
        freed("deepseek")

        # float32, cut to 4 layers (the dense layer and 3 MoE)
        print("reduced: deepseek float32 check n_layers 27 -> 4 (the dense "
              "layer and 3 MoE layers)")
        cfg4, _, params = load(cfg.replace(n_layers=4), dtype="float32")
        check_teacher_forced_routed(
            "deepseek float32 4 layers run A", cfg4, params, prompt_a,
            runs["A"]["out"], ops, F32_LOGIT_REL, greedy=False)
        del params
        freed("deepseek float32")

        # -- qwen3-moe-235b-a22b at full width, cut in depth: run A ----------
        full = ARCHS["qwen3-moe-235b-a22b"]
        print(f"reduced: n_layers {full.n_layers} -> {QWEN3_LAYERS} (one "
              f"80 GB card)")
        cfg, gen, params = load(full.replace(n_layers=QWEN3_LAYERS))
        prompt_q = torch.randint(0, cfg.vocab, (RUN_A["batch"],
                                                RUN_A["prompt"]),
                                 generator=gen, device=dev)
        _, launches["qwen3_A"] = drive("qwen3", "A", RUN_A, cfg, params,
                                       spies, want_of(cfg), prompt=prompt_q)
        decode_breakdown("qwen3 run A shape", cfg, params, prompt_q,
                         RUN_A["gen"], weight_read_bound(params))
        del params
        freed("qwen3")

    max_err = check_against_plain("moe", spies, plain_versions(),
                                  stress_cases(gen, dev), ops)
    norm_rows_by_width("moe", spies["rmsnorm"])
    # flash_attention at each prefill shape of runs A and B (MLA's D 192
    # against Dv 128; qwen3's GQA 64/4 of 128) beside causal
    # scaled_dot_product_attention, which accepts Dv != D
    prefills = {(r["batch"], r["prompt"]) for r in (RUN_A, MOE_RUN_B)}
    for (q, k, v), akw in spies["flash_attention"].calls.values():
        if q.dtype == torch.bfloat16 and tuple(q.shape[:2]) in prefills:
            def library(q=q, k=k, v=v, scale=akw.get("scale")):
                return sdpa(q, k, v, None, True, scale)
            row = attention_row(q, k, v, akw, library)
            print("moe flash_attention " + json.dumps(
                {k_: v_ for k_, v_ in row.items() if k_ != "args"}))
    for (q, kc, vc, pos), dkw in spies["flash_decode"].calls.values():
        if q.shape[0] == RUN_A["batch"] and q.dtype == torch.bfloat16:
            plan = decode_plan(q.shape[0], kc.shape[1], kc.shape[2],
                               q.shape[2], dv=vc.shape[-1],
                               g=q.shape[1] // kc.shape[2])
            row = decode_row(q, kc, vc, pos, dkw)
            row["plan"] = plan._asdict()
            print("moe flash_decode " + json.dumps(
                {k_: v_ for k_, v_ in row.items() if k_ != "args"}))
            break
    by_run = {k: {r: launches[r][k] for r in launches}
              for k in SERVE_KERNELS}
    return by_run, max_err


# -- 14. the patch and frame frontends: paligemma-3b served, hubert-xlarge
#        encoded; 15. training on one card -----------------------------------

VLM_RUN = dict(batch=2, prompt=512, gen=16)     # after 256 patches
ENC_RUN = dict(batch=2, frames=1000)
PREFIX_ROW = (1, 768, 8, 1, 256, 256)           # b, s, hq, hkv, d, prefix
TRAIN_ARCH = "gemma2-2b"
TRAIN_RUN = dict(batch=2, seq=1024, steps=3, ckpt_at=2)
# a training cell's step profile: unsynchronised steps, profiled steps
# (deepseek's step, the longest: one and one)
TRAIN_PROFILE = (2, 1)
VLM_TRAIN = dict(batch=1, seq=1024)             # 256 patches + 768 tokens
ENC_TRAIN = dict(batch=2, seq=1000)
SSM_TRAIN = dict(batch=2, seq=1024)             # 4 chunks of 256
GRAD_LAYERS = 2                                 # the float32 gradient gate
GRAD_LAYERS_BY_ARCH = {"zamba2-7b": 7}          # a group of 6 + a tail layer
GRAD_LOSS_REL = 1e-5                            # |dloss| / |loss|
GRAD_REL = 1e-4                                 # per parameter, of max|g|
MLA_BWD_ROW = (1, 1024, 16, 192, 128)           # b, s, h, d, dv
MOE_TRAIN_ARCH = "deepseek-v2-lite-16b"
MOE_TRAIN = dict(batch=2, seq=1024)             # as the other cells
EP_GPUS = 8                                     # of one H100 node
TRAIN_BYTES_PER_PARAM = 16      # bf16 parameter and gradient, AdamW's
                                # float32 copy of the gradients, m and v
TRAIN_PEAK_GB = 70.0            # what the cut zamba2-7b and deepseek are
                                # sized to
TRAIN_ACT_GB = 8.0              # kept for activations and workspaces
TRAIN_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                 "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
                 "grad_sumsq", "adamw_update")
ADAMW_KEEP_NUMEL = 1 << 22      # the list kernels' check keeps every
                                # tensor up to this size and the largest
ADAMW_KEEP_LARGEST = 1 << 27    # up to this size (the card's tests take
                                # deepseek's 369 M-element leaf)


def freed(label):
    """Print the peak device memory since the last reset once the
    model's last reference is gone, and give the memory back."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label} peak device memory {peak:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    return peak


def load_model(label, cfg, dev, seed=0):
    """``init_params`` from a CUDA generator seeded ``seed``, every norm
    scale redrawn N(0, 0.1); prints the model's size."""
    import torch

    from repro_torch.models import init_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dev)
    redraw(params, gen, dev)
    torch.cuda.synchronize()
    size = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"{label}: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} "
          f"{cfg.family} {cfg.frontend} causal={cfg.causal} {cfg.dtype} "
          f"params={sum(p.numel() for p in params.parameters())} "
          f"({size / 1e9:.2f} GB) init_s={time.perf_counter() - t0:.1f}")
    return gen, params


def encode(cfg, params, frames):
    """The encoder's forward (``Model.forward`` in train mode: logits
    for every frame) under ``torch.inference_mode()``, float32 logits."""
    import torch

    from repro_torch.models import ShardCtx
    with torch.inference_mode():
        logits, _ = params({"frames": frames}, ShardCtx(mode="train"))
    return logits.float()


def prefix_rows(gen, dev, enc_args, ops):
    """``flash_attention`` with the prefix-LM mask at paligemma's
    (1, 768, 8/1, 256, prefix 256) and bidirectional at hubert's path
    shape, bf16: each held to its plain version (and its lse) and timed
    beside ``scaled_dot_product_attention`` (a boolean mask for the
    prefix)."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_torch,
                                                     visible)
    b, s, hq, hkv, d, p = PREFIX_ROW
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    pre = torch.full((b,), p, dtype=torch.int32, device=dev)
    mask = visible(s, causal=True, window=None, prefix_len=pre,
                   device=dev)[:, None]
    cases = [("prefix", (q, k, v), dict(prefix_len=pre, scale=d ** -0.5),
              lambda: sdpa(q, k, v, mask, False, d ** -0.5))]
    (eq, ek, ev), ekw = enc_args
    cases.append(("bidirectional", (eq, ek, ev), ekw,
                  lambda: sdpa(eq, ek, ev, None, False, ekw.get("scale"))))
    rows = {}
    for name, args, akw, library in cases:
        got, lse = ops.flash_attention(*args, return_lse=True, **akw)
        want, want_lse = flash_attention_torch(*args, return_lse=True, **akw)
        torch.cuda.synchronize()
        ok, err = close_to_plain(got, want)
        lse_err = float((lse - want_lse).abs().max())
        if not ok or not lse_err <= 1e-5 * max(1.0, float(want_lse.abs()
                                                          .max())):
            fail(f"frontends flash_attention {name}: off the plain version "
                 f"(max abs err {err:.3e}, lse {lse_err:.3e})")
        rows[name] = attention_row(*args, akw, library)
        rows[name].update(max_abs_err=err, lse_max_abs_err=lse_err)
        print(f"frontends flash_attention {name} " + json.dumps(
            {k_: v_ for k_, v_ in rows[name].items() if k_ != "args"}))
    return rows


def frontend_phase(dev):
    """Serve paligemma-3b (``generate`` with 256 patches) and encode with
    hubert-xlarge at full size in bf16, check them against the plain
    path and time them; returns the serving kernels' counts by run and
    their largest errors here."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import ShardCtx
    from repro_torch.runtime import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keys = spy_keys()
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in SERVE_KERNELS}

        # -- paligemma-3b: generate with patches ------------------------
        cfg = ARCHS["paligemma-3b"]
        gen, params = load_model("frontends", cfg, dev)
        n = cfg.n_layers
        prompt = torch.randint(0, cfg.vocab, (VLM_RUN["batch"],
                                              VLM_RUN["prompt"]),
                               generator=gen, device=dev)
        extra = {"patches": torch.randn(
            (VLM_RUN["batch"], cfg.n_patches, cfg.d_model), generator=gen,
            device=dev)}
        generate(cfg, ShardCtx(), params, {"tokens": prompt[:1, :16],
                                           "patches": extra["patches"][:1]},
                 2)                                    # warm-up
        torch.cuda.synchronize()

        def want(n_pre, n_dec):
            return {"rmsnorm": (n_pre + n_dec) * (2 * n + 1),
                    "flash_attention": n_pre * n,
                    "flash_decode": n_dec * n}
        rec, launches["paligemma_A"] = drive(
            "paligemma", "A", VLM_RUN, cfg, params, spies, want,
            prompt=prompt, extra=extra)
        pre_calls = [kw.get("prefix_len") for (_, kw) in
                     spies["flash_attention"].calls.values()]
        if not any(p is not None and bool((p == cfg.n_patches).all())
                   for p in pre_calls):
            fail("paligemma: no flash_attention launch carried the prefix "
                 f"of {cfg.n_patches} patches")
        check_teacher_forced("paligemma", cfg, params, prompt, rec["out"],
                             ops, extra=extra)
        del params
        freed("paligemma")

        print(f"reduced: paligemma float32 check n_layers {n} -> 4")
        cfg4 = cfg.replace(n_layers=4, dtype="float32")
        _, params = load_model("frontends", cfg4, dev)
        kern, plain = kernel_and_plain_logits(
            "paligemma float32 4 layers", cfg4, params, prompt, rec["out"],
            ops, greedy=False, extra=extra)
        d32, scale = float((kern - plain).abs().max()), \
            float(plain.abs().max())
        print(f"paligemma float32 4 layers teacher-forced: max |dlogit| "
              f"{d32:.4e}, bound {F32_LOGIT_REL} x max|logit| {scale:.4f}")
        if not d32 <= F32_LOGIT_REL * scale:
            fail(f"paligemma float32: kernel path off the plain path by "
                 f"{d32:.4e}")
        del params, kern, plain
        freed("paligemma float32")

        # -- hubert-xlarge: one encoder forward ---------------------------
        cfg = ARCHS["hubert-xlarge"]
        gen, params = load_model("frontends", cfg, dev)
        n = cfg.n_layers
        frames = torch.randn((ENC_RUN["batch"], ENC_RUN["frames"],
                              cfg.d_model), generator=gen, device=dev)
        encode(cfg, params, frames[:, :16])            # warm-up
        for sp in spies.values():
            sp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = encode(cfg, params, frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["hubert_encode"] = {k: sp.launches
                                     for k, sp in spies.items()}
        want_enc = {"rmsnorm": 2 * n + 1, "flash_attention": n,
                    "flash_decode": 0}
        print(f"hubert encode: B={ENC_RUN['batch']} frames="
              f"{ENC_RUN['frames']} wall_ms={wall * 1e3:.2f} frames_per_s="
              f"{ENC_RUN['batch'] * ENC_RUN['frames'] / wall:.1f} launches "
              f"{launches['hubert_encode']}")
        if launches["hubert_encode"] != want_enc:
            fail(f"hubert: launches {launches['hubert_encode']} != "
                 f"{want_enc}")
        if logits.shape != (ENC_RUN["batch"], ENC_RUN["frames"], cfg.vocab) \
                or not torch.isfinite(logits).all():
            fail(f"hubert: logits of shape {tuple(logits.shape)} or not "
                 f"finite")
        with plain_serving_kernels(ops):
            plain = encode(cfg, params, frames)
        d_logit, scale = float((logits - plain).abs().max()), \
            float(plain.abs().max())
        top1 = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
        print(f"hubert encode vs plain path: max |dlogit| {d_logit:.4e}, "
              f"bound {LOGIT_REL} x max|logit| {scale:.4f} = "
              f"{LOGIT_REL * scale:.4e}; top-1 agreement {top1:.4f}")
        if not d_logit <= LOGIT_REL * scale:
            fail(f"hubert: kernel path logits off the plain path's by "
                 f"{d_logit:.4e}")
        enc_call = next((a, kw) for (a, kw) in
                        spies["flash_attention"].calls.values()
                        if a[0].shape[1] == ENC_RUN["frames"])
        del params, logits, plain
        freed("hubert")

        print(f"reduced: hubert float32 check n_layers {n} -> 4")
        _, params = load_model("frontends", cfg.replace(
            n_layers=4, dtype="float32"), dev)
        kern = encode(cfg.replace(n_layers=4, dtype="float32"), params,
                      frames)
        with plain_serving_kernels(ops):
            plain = encode(cfg.replace(n_layers=4, dtype="float32"), params,
                           frames)
        d32, scale = float((kern - plain).abs().max()), \
            float(plain.abs().max())
        print(f"hubert float32 4 layers: max |dlogit| {d32:.4e}, bound "
              f"{F32_LOGIT_REL} x max|logit| {scale:.4f}")
        if not d32 <= F32_LOGIT_REL * scale:
            fail(f"hubert float32: kernel path off the plain path by "
                 f"{d32:.4e}")
        del params, kern, plain
        freed("hubert float32")

    max_err = check_against_plain("frontends", spies, plain_versions(),
                                  stress_cases(gen, dev), ops)
    rows = prefix_rows(gen, dev, ((enc_call[0][0], enc_call[0][1],
                                   enc_call[0][2]), enc_call[1]), ops)
    by_run = {k: {r: launches[r][k] for r in launches}
              for k in SERVE_KERNELS}
    return by_run, max_err, rows


def bwd_cost(q, k, v, *, causal=True, window=None, prefix_len=None, **_):
    """Bytes (q, k, v, out, dout and lse read once; dq, dk, dv written
    once) and the operations the backward needs: per visible (query,
    key) pair and q head the recomputed score (2 D), dP and dV (2 Dv
    each), dQ and dK (2 D each)."""
    b, s, hq, d = q.shape
    dv = v.shape[-1]
    el = q.element_size()
    n_bytes = el * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                    + 2 * b * s * hq * dv) + 4 * b * hq * s
    pairs = [visible_pairs(s, causal, window, p) for p in
             (prefix_len.tolist() if prefix_len is not None else [0] * b)]
    return n_bytes, 2 * hq * sum(pairs) * (3 * d + 2 * dv)


def turns(*tensors):
    """Copies of ``tensors`` that together hold three times the L2, and
    a function giving the next set in turn."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    copies = [tensors] + [tuple(t.clone() for t in tensors)
                          for _ in range(-(-3 * L2_BYTES // size))]
    turn = itertools.count()
    return lambda: copies[next(turn) % len(copies)]


def attention_bwd_row(args, kw, library=True):
    """``flash_attention_bwd`` at one shape: the kernel's and the plain
    version's device ms from a CUDA graph over input copies past 3x the
    L2, the library's (autograd backward of
    ``scaled_dot_product_attention``, back to back on a graph kept for
    it, without a softcap only), the bound and what bounds it; in bf16
    the launch plan (``bwd_plan``) where the timed tree has one."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_torch, visible)
    q, k, v, out, dout, lse = args
    n_bytes, flops = bwd_cost(q, k, v, **kw)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    b_ms, b_by = bound(n_bytes, flops, rate)
    nxt = turns(q, k, v, out, dout, lse)
    akw = {k_: kw[k_] for k_ in ("causal", "scale", "window", "softcap",
                                 "prefix_len") if k_ in kw}
    ms = graph_ms(lambda: flash_attention_bwd_cuda(*nxt(), **akw), 10)
    plain_ms = graph_ms(lambda: flash_attention_bwd_torch(*nxt(), **akw), 2)
    lib_ms = None
    if library and akw.get("softcap") is None:
        pre = akw.get("prefix_len")
        s = q.shape[1]
        mask = None
        if pre is not None or akw.get("window") is not None:
            mask = visible(s, causal=akw.get("causal", True),
                           window=akw.get("window"), prefix_len=pre,
                           device=q.device)
            mask = mask[:, None] if mask.dim() == 3 else mask
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lout = sdpa(*leaves, mask, akw.get("causal", True) and mask is None,
                    akw.get("scale"))
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            lout, leaves, dout, retain_graph=True), 10)
    pre = akw.get("prefix_len")
    plan = getattr(fa, "bwd_plan", None)
    return dict(shape=f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                      f"{tuple(v.shape)} {str(q.dtype)[6:]} causal="
                      f"{akw.get('causal', True)} window={akw.get('window')} "
                      f"softcap={akw.get('softcap')}"
                      + ("" if pre is None else f" prefix={pre.tolist()}"),
                ms=ms, tflops=flops / ms / 1e9, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                bytes=n_bytes, flops=flops,
                plan=None if plan is None or q.dtype != torch.bfloat16
                else plan(*q.shape[:3], k.shape[2], q.shape[-1],
                          v.shape[-1])._asdict())


def attention_fwd_row(args, kw):
    """``flash_attention`` at one training shape, as
    ``attention_bwd_row``: the kernel's and the plain version's device ms
    from a CUDA graph over input copies past 3x the L2, causal
    ``scaled_dot_product_attention`` (which takes Dv != D) back to back,
    the bound and what bounds it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_torch)
    q, k, v = args
    akw = {k_: kw[k_] for k_ in ("causal", "scale", "window", "softcap",
                                 "prefix_len", "return_lse") if k_ in kw}
    n_bytes, flops = attn_cost(q, k, v, causal=akw.get("causal", True),
                               window=akw.get("window"),
                               prefix_len=akw.get("prefix_len"))
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    nxt = turns(q, k, v)
    ms = graph_ms(lambda: flash_attention_cuda(*nxt(), **akw), 10)
    plain_ms = graph_ms(lambda: flash_attention_torch(*nxt(), **akw), 2)
    lib_ms = None
    if akw.get("softcap") is None and akw.get("window") is None and \
            akw.get("prefix_len") is None and akw.get("causal", True):
        lib_ms = cuda_ms(lambda: sdpa(q, k, v, None, True, akw.get("scale")),
                         10)
    return dict(shape=f"q {tuple(q.shape)} k {tuple(k.shape)} v "
                      f"{tuple(v.shape)} {str(q.dtype)[6:]} causal="
                      f"{akw.get('causal', True)} lse="
                      f"{akw.get('return_lse', False)}",
                ms=ms, tflops=flops / ms / 1e9, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                bytes=n_bytes, flops=flops)


def norm_bwd_row(x, w, dy, kw):
    """``rmsnorm_bwd`` at one shape: kernel and plain device ms from a
    CUDA graph over input copies past 3x the L2, the library's (autograd
    backward of ``F.rms_norm``, back to back), the bound (x and dy read,
    dx written, w read and dw written once) and what bounds it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, \
        rmsnorm_bwd_torch
    n_bytes = 3 * x.numel() * x.element_size() \
        + 2 * w.numel() * w.element_size()
    b_ms, b_by = bound(n_bytes, 10 * x.numel(), FP32_OPS_PER_S)
    nxt = turns(x, dy)
    def kernel():
        x_, dy_ = nxt()
        return rmsnorm_bwd_cuda(x_, w, dy_, **kw)
    ms = graph_ms(kernel, 20)
    plain_ms = graph_ms(lambda: rmsnorm_bwd_torch(x, w, dy, **kw), 5)
    lx = x.detach().clone().requires_grad_(True)
    lw = (1.0 + w if kw.get("zero_centered", True) else w).detach().clone() \
        .requires_grad_(True)
    lout = F.rms_norm(lx, (x.shape[-1],), lw, kw.get("eps", 1e-6))
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lout, (lx, lw), dy,
                                                 retain_graph=True), 20)
    return dict(shape=f"{tuple(x.shape)} {str(x.dtype)[6:]} w "
                      f"{str(w.dtype)[6:]}", ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                bytes=n_bytes, bound_share=b_ms / ms,
                plan=norm_bwd_plan(x, w))


def norm_bwd_plan(x, w):
    """The tree's launch plan of ``rmsnorm_bwd`` (threads per row, row
    blocks), where its library gives one."""
    from repro_torch.kernels import rmsnorm
    plan = getattr(rmsnorm, "bwd_plan", None)
    if plan is None:
        return None
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    threads, blocks = plan(rows, d, x.dtype, w.dtype)
    return dict(threads_per_row=threads, blocks=blocks)


def ssd_bwd_cost(x, dt, A, B, C, dy, dfinal, chunk):
    """Bytes (x, dt, A, B, C, dy and dfinal read once; dx, ddt, dA, dB,
    dC written once) and the operations the backward needs: per chunk of
    L real positions and batch row, over the L (L + 1) / 2 causal (query,
    key) pairs, once per group C B^T and dB's and dC's products (N each,
    as the reference builds C B^T once per group and its dB and dC take
    the heads' summed dCB: 2 pairs 3 N) and per head dy x^T and M^T dy (P
    each: 2 pairs 2 P); and per head the states' five products of L N P
    (the recomputed state, the state gradient, and their parts of dx, dB
    and dC): 10 L N P."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    ins = (x, dt, A, B, C, dy) + (() if dfinal is None else (dfinal,))
    n_bytes = sum(t.numel() * t.element_size() for t in ins) \
        + sum(t.numel() * t.element_size() for t in ins[:5])
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    per_group = sum(ln * (ln + 1) * 3 * n for ln in lens)
    per_head = sum(ln * (ln + 1) * 2 * p + 10 * ln * n * p for ln in lens)
    return n_bytes, b * (g * per_group + h * per_head)


def ssd_bwd_row(args):
    """``ssd_scan_bwd`` at one shape: the kernels' and the plain
    version's device ms from a CUDA graph over input copies past 3x the
    L2, the bound and what bounds it, the largest error over the gate's
    bound (``gate_ratio``) of each gradient; no library call computes
    the function (library_ms null)."""
    import torch

    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_torch)
    x, dt, A, B, C, dy, dfinal, chunk = args
    n_bytes, flops = ssd_bwd_cost(*args)
    rate = BF16_OPS_PER_S if x.dtype == torch.bfloat16 else FP32_OPS_PER_S
    b_ms, b_by = bound(n_bytes, flops, rate)
    got = ssd_scan_bwd_cuda(*args)
    want = ssd_scan_bwd_torch(*args)
    ratios = {k: gate_ratio(g, w) for k, g, w in
              zip(("dx", "ddt", "dA", "dB", "dC"), got, want)}
    nxt = turns(x, dt, B, C, dy)

    def kernel():
        x_, dt_, B_, C_, dy_ = nxt()
        return ssd_scan_bwd_cuda(x_, dt_, A, B_, C_, dy_, dfinal, chunk)
    ms = graph_ms(kernel, 5)
    plain_ms = graph_ms(lambda: ssd_scan_bwd_torch(*args), 1)
    return dict(shape=f"x {tuple(x.shape)} B {tuple(B.shape)} chunk {chunk} "
                      f"{str(x.dtype)[6:]} dfinal={dfinal is not None}",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bytes=n_bytes, flops=flops,
                gate_ratios=ratios)


def spy_train_keys():
    def key_norm(args):
        return (tuple(args[0].shape), args[0].dtype, args[1].dtype)

    def key_attn(args):
        return shapes(args[:3]) + (str(args[0].dtype),)
    def key_scan(args):
        return shapes(args[:5]) + (str(args[0].dtype), args[6] is None,
                                   args[-1])
    def key_lists(args):
        return tuple((tuple(x.shape), str(x.dtype)) for xs in args
                     for x in xs)
    attn_kw = ("causal", "window", "softcap", "return_lse")
    return {"rmsnorm": (key_norm, ("zero_centered",)),
            "rmsnorm_bwd": (key_norm, ("zero_centered",)),
            "flash_attention": (key_attn, attn_kw),
            "flash_attention_bwd": (key_attn, attn_kw[:3]),
            "ssd_scan": (lambda a: shapes(a[:5]) + (str(a[0].dtype), a[5]),
                         ()),
            "ssd_scan_bwd": (key_scan, ()),
            "grad_sumsq": (key_lists, (), keep_lists),
            "adamw_update": (key_lists, (), keep_lists)}


def keep_lists(args, kwargs):
    """What the spy of a multi-tensor kernel (``grad_sumsq``,
    ``adamw_update``) keeps of one call: a copy of the i-th tensor of
    every list for each tensor of at most ``ADAMW_KEEP_NUMEL`` elements
    and the largest of at most ``ADAMW_KEEP_LARGEST``, the keyword
    arguments (the scalars on the card, the constants) and, under
    ``"index"``, which tensors these were. A copy of every list would not
    fit beside the training state."""
    first = args[0]
    largest = max((i for i, x in enumerate(first)
                   if x.numel() <= ADAMW_KEEP_LARGEST),
                  key=lambda i: first[i].numel(), default=None)
    index = [i for i, x in enumerate(first)
             if i == largest or x.numel() <= ADAMW_KEEP_NUMEL]
    return ([[snapshot(xs[i]) for i in index] for xs in args],
            dict({n: snapshot(v) for n, v in kwargs.items()}, index=index))


def train_counts(cfg, steps, remat=True):
    """The launches ``steps`` training steps of ``cfg`` make: each block
    (a layer, or zamba2's shared block at the head of a repeat group)
    runs its norms, attention and scan forward twice under remat (the
    forward and its recomputation in the backward) and backward once; a
    Mamba layer has two norms and one scan, the shared block two norms
    and one attention; an attention layer (dense or MoE) two, two more
    with post-block norms or qk-norm (one call each for q and k), and
    MLA's ``kv_norm`` on the latent; the final norm runs outside the
    recomputed blocks."""
    from repro_torch.models import block_plan
    kinds = cfg.layer_kinds()
    norms = attn = scans = 0
    for what, i in block_plan(cfg):
        if what == "shared":
            norms, attn = norms + 2, attn + 1
        elif kinds[i] == "ssm":
            norms, scans = norms + 2, scans + 1
        else:
            norms += 2 + 2 * cfg.post_block_norms + 2 * cfg.qk_norm \
                + bool(cfg.kv_lora_rank)
            attn += 1
    fwd = 2 if remat else 1
    return {"rmsnorm": steps * (fwd * norms + 1),
            "rmsnorm_bwd": steps * (norms + 1),
            "flash_attention": steps * fwd * attn,
            "flash_attention_bwd": steps * attn,
            "ssd_scan": steps * fwd * scans,
            "ssd_scan_bwd": steps * scans}


def depth_cut(dev, arch, probe_layers, step, params_of):
    """``arch`` at full width cut in depth for training on one card: the
    most layers n (``probe_layers``, then every ``step``-th count up to
    the whole depth) whose state, ``TRAIN_BYTES_PER_PARAM`` a parameter,
    and ``TRAIN_ACT_GB`` of activations stay under ``TRAIN_PEAK_GB``.
    ``params_of(probe)`` reads the counts off a ``probe_layers``-layer
    instance on the card and returns ``(params, what)``: ``params(n)``,
    the parameters of n layers, and ``what``, the counts it was built
    from. Prints the reckoning."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    full = ARCHS[arch]
    gen = torch.Generator(device=dev).manual_seed(0)
    probe = init_params(full.replace(n_layers=probe_layers), gen, dev)
    params, what = params_of(probe)
    del probe
    torch.cuda.empty_cache()

    def gb(n):
        return params(n) * TRAIN_BYTES_PER_PARAM / 1e9 + TRAIN_ACT_GB
    n = max(n for n in range(probe_layers, full.n_layers + 1, step)
            if gb(n) <= TRAIN_PEAK_GB)
    print(f"train {arch} cut: {n} of {full.n_layers} layers, {params(n)} "
          f"parameters of {params(full.n_layers)} ({what}); "
          f"{TRAIN_BYTES_PER_PARAM} bytes a parameter + {TRAIN_ACT_GB} GB "
          f"of activations: {gb(n):.1f} GB of {TRAIN_PEAK_GB} "
          f"({n + step} layers: {gb(n + step):.1f} GB; whole: "
          f"{params(full.n_layers) * TRAIN_BYTES_PER_PARAM / 1e9:.1f} GB)")
    return full.replace(n_layers=n)


def count_params(module):
    return sum(p.numel() for p in module.parameters())


def zamba_cut(dev):
    """zamba2-7b cut to 6 k + 3 layers (whole repeat groups, the tail
    kept), read off a 9-layer instance (one group and the tail): its
    total, one Mamba layer's and one LoRA slot's."""
    def params_of(probe):
        total9, layer = count_params(probe), count_params(probe.layers[0])
        lora = count_params(probe.shared.lora[0])

        def params(n):              # n = 6 k + 3: k groups, k LoRA slots
            return total9 + (n - 9) * layer + ((n - 3) // 6 - 1) * lora
        return params, (f"groups of 6 + 3; one Mamba layer {layer}, one "
                        f"LoRA slot {lora}")
    return depth_cut(dev, "zamba2-7b", 9, 6, params_of)


def deepseek_cut(dev):
    """deepseek-v2-lite-16b cut to its dense prologue layer and the most
    MoE layers, read off a 2-layer instance (the dense layer and one MoE
    layer): its total and each layer's."""
    def params_of(probe):
        total2 = count_params(probe)
        dense, moe = (count_params(layer) for layer in probe.layers)

        def params(n):              # the dense layer and n - 1 MoE layers
            return total2 + (n - 2) * moe
        return params, (f"the dense layer and MoE layers; embedding and "
                        f"head {total2 - dense - moe}, the dense layer "
                        f"{dense}, one MoE layer {moe}")
    return depth_cut(dev, MOE_TRAIN_ARCH, 2, 1, params_of)


def place_from_routes(cfg, calls):
    """AMTHA's expert placement (``place_experts`` on ``EP_GPUS`` GPUs of
    one H100 node, ``ep_machine``: ``h100_node(1, EP_GPUS)``) and round
    robin from one training step's routes (``recorded_routes``:
    the forward's calls, then the recomputation's under remat), one MoE
    layer at a time: each expert's load is its routed tokens times the
    forward's three products (6 D F FLOPs a token). Reads the routes back
    once. Fails unless every device holds E / 8 experts and each
    ``permutation`` is a permutation; prints the largest and the mean
    device load (tokens) of each placement. Which is lower is not gated:
    a capacity-bound greedy is not always below round robin."""
    import torch

    from repro_torch.core import place_experts, round_robin_placement
    from repro_torch.core.placement import ep_machine
    n_moe = sum(k.startswith("moe") for k in cfg.layer_kinds())
    if len(calls) != 2 * n_moe:
        fail(f"placement: {len(calls)} router calls, expected {n_moe} MoE "
             f"layers x 2 (forward and recomputation)")
    e = cfg.n_experts
    counts = torch.stack([torch.bincount(c.reshape(-1), minlength=e)
                          for c in calls[:n_moe]]).cpu().tolist()
    node = ep_machine(EP_GPUS)
    n_dev, flops = node.n_cores, 6 * cfg.d_model * cfg.d_ff_expert
    rows = []
    for layer, cnt in enumerate(counts):
        loads = [c * flops for c in cnt]
        t0 = time.perf_counter()
        amtha = place_experts(loads, n_dev)
        map_ms = (time.perf_counter() - t0) * 1e3
        rr = round_robin_placement(loads, n_dev)
        row = dict(moe_layer=layer, tokens=sum(cnt),
                   expert_tokens_max=max(cnt), expert_tokens_min=min(cnt),
                   map_ms=map_ms)
        for name, pl in (("amtha", amtha), ("round_robin", rr)):
            per = [pl.expert_to_device.count(d) for d in range(n_dev)]
            if per != [e // n_dev] * n_dev or \
                    sorted(pl.permutation) != list(range(e)):
                fail(f"placement {name} layer {layer}: experts per device "
                     f"{per}, permutation {pl.permutation[:8]}...")
            dev = [x / flops for x in pl.device_loads(loads, n_dev)]
            row.update({f"{name}_device_tokens_max": max(dev),
                        f"{name}_device_tokens_mean": sum(dev) / n_dev,
                        f"{name}_t_est_ms": pl.t_est * 1e3})
        print(f"placement {cfg.name} on {node.name}: " + json.dumps(row))
        rows.append(row)
    return rows


def grad_gate(label, cfg, dev, batch_of, ops):
    """Loss and every parameter's gradient of one float32 step at full
    width, ``GRAD_LAYERS`` layers, kernel path against the same step with
    every kernel (forward and backward) swapped for its plain version.
    With MoE layers both paths take the kernel path's routes: its
    ``router_topk`` ids are recorded call by call (the forward's, then
    the recomputation's under remat) and the plain path replays them
    (``recorded_routes(forced=...)``), so a near tie in the top-k cannot
    send a token elsewhere; the Switch aux loss (weight 0.01 in the loss)
    is held as the loss is, the router's gradient with the rest."""
    import torch

    from repro_torch.models import ShardCtx
    from repro_torch.runtime.train_loop import make_loss_fn
    layers = GRAD_LAYERS_BY_ARCH.get(cfg.name, GRAD_LAYERS)
    cfg = cfg.replace(n_layers=layers, dtype="float32")
    _, params = load_model(f"{label} gradient gate", cfg, dev, seed=3)
    params.requires_grad_(True)
    batch = batch_of(cfg)
    moe = cfg.family == "moe"
    out, routes = {}, {}
    for path in ("kernel", "plain"):
        params.zero_grad(set_to_none=True)
        ctx = plain_serving_kernels(ops) if path == "plain" \
            else contextlib.nullcontext()
        forced = routes.get("kernel") if path == "plain" else None
        rec = recorded_routes(forced) if moe else contextlib.nullcontext([])
        with ctx, rec as calls:
            total, (loss, aux) = make_loss_fn(cfg, ShardCtx())(params, batch)
            total.backward()
        routes[path] = calls
        out[path] = (loss.item(), aux.item(), {k: p.grad for k, p in
                                               params.named_parameters()})
    if moe:
        n_moe = sum(k.startswith("moe") for k in cfg.layer_kinds())
        if len(routes["kernel"]) != 2 * n_moe or not all(
                torch.equal(a, b) for a, b in zip(routes["kernel"],
                                                  routes["plain"])):
            fail(f"{label} gradient gate: the plain path did not replay the "
                 f"kernel path's {len(routes['kernel'])} router calls")
        (_, ak, _), (_, ap, _) = out["kernel"], out["plain"]
        print(f"{label} gradient gate: aux loss kernel {ak!r} plain {ap!r} "
              f"over {len(routes['kernel'])} router calls ({n_moe} MoE "
              f"layers, forward and recomputation) on one set of routes")
        if not abs(ak - ap) <= GRAD_LOSS_REL * abs(ap):
            fail(f"{label} gradient gate: aux loss {ak!r} vs plain {ap!r}")
    (lk, _, gk), (lp, _, gp) = out["kernel"], out["plain"]
    worst = max(((float((gk[k] - gp[k]).abs().max())
                  / max(float(gp[k].abs().max()), 1e-30), k) for k in gp))
    print(f"{label} gradient gate (float32, {layers} layers, full "
          f"width): loss kernel {lk!r} plain {lp!r} rel "
          f"{abs(lk - lp) / abs(lp):.3e} (bound {GRAD_LOSS_REL}); worst "
          f"gradient {worst[1]} max|dg| / max|g| {worst[0]:.3e} (bound "
          f"{GRAD_REL}) over {len(gp)} parameters")
    if not abs(lk - lp) <= GRAD_LOSS_REL * abs(lp):
        fail(f"{label} gradient gate: loss {lk!r} vs plain {lp!r}")
    if not worst[0] <= GRAD_REL:
        fail(f"{label} gradient gate: gradient of {worst[1]} off the plain "
             f"path's by {worst[0]:.3e} of its largest")
    del params, out, gk, gp
    freed(f"{label} gradient gate")


def hold_adamw(label, spies, state, n_steps, tensors):
    """AdamW's multi-tensor kernels in one training run of ``n_steps``
    counted steps: ``adamw_update`` took every parameter once a step
    (``tensors``, its count over those steps); each spied call held to
    its plain version on what ``keep_lists`` kept of it (the update bit
    for bit on p, m and v given the call's scalars; the sums of squares
    within rtol 1e-6 and the same bits in two calls); then both timed at
    the run's whole lists, the state's parameters and moments with a copy
    of the parameters as the gradients (``cuda_ms``: the kernels, the
    plain versions, and the library's calls where one computes the
    function: ``torch._foreach_norm`` in float32; ``torch._fused_adamw_``,
    whose error is kept where it refuses the lists), against the bound:
    the update's bytes (22 a bf16 parameter, 28 a float32 one) and the
    gradients read once more for the sums. The timing writes the state,
    which the run has done with. Clears the two spies' calls; returns
    ({name: (max abs err, max rel err)}, {name: row})."""
    import torch

    from repro_torch.kernels import adamw

    def bits(x):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    # the real entry points: the spies stand in for them while this runs
    grad_sumsq, adamw_update = (spies[k].fn for k in ("grad_sumsq",
                                                      "adamw_update"))
    named = dict(state["params"].named_parameters())
    if tensors != n_steps * len(named):
        fail(f"train {label}: adamw_update took {tensors} tensors in "
             f"{n_steps} steps of {len(named)} parameters")
    if not (spies["grad_sumsq"].calls and spies["adamw_update"].calls):
        fail(f"train {label}: no grad_sumsq or adamw_update call was spied")
    errs, kept = {}, {}
    for args, kw in spies["grad_sumsq"].calls.values():
        kept["grad_sumsq"] = len(kw.pop("index"))
        first, second = grad_sumsq(*args), grad_sumsq(*args)
        want = adamw.grad_sumsq_torch(*args)
        torch.cuda.synchronize()
        err = (first.double() - want.double()).abs()
        rel = float((err / want.double().abs().clamp_min(1e-300)).max())
        if not torch.equal(bits(first), bits(second)) or not rel <= 1e-6:
            fail(f"train {label} grad_sumsq: rel err {rel:.3e} to the plain "
                 f"version, bits repeat {torch.equal(first, second)}")
        worst = errs.get("grad_sumsq", (0.0, 0.0))
        errs["grad_sumsq"] = (max(worst[0], float(err.max())),
                              max(worst[1], rel))
    for args, kw in spies["adamw_update"].calls.values():
        kept["adamw_update"] = len(kw.pop("index"))
        kern = [[x.clone() for x in xs] for xs in args]
        adamw_update(*kern, **kw)
        adamw.adamw_update_torch(*args, **kw)          # the kept copy
        torch.cuda.synchronize()
        for what, i in (("p", 0), ("m", 2), ("v", 3)):
            for j, (a, b) in enumerate(zip(kern[i], args[i])):
                if not torch.equal(bits(a), bits(b)):
                    fail(f"train {label} adamw_update: {what} of kept tensor "
                         f"{j} {tuple(a.shape)} not the plain version's bit "
                         f"for bit")
        errs["adamw_update"] = (0.0, 0.0)
        scalars = kw
        del kern
    for sp in (spies["grad_sumsq"], spies["adamw_update"]):
        sp.calls.clear()
    args = None
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        params = [p.detach() for p in named.values()]
        grads = [p.clone() for p in params]
        lists = (params, grads, [state["opt"]["m"][k] for k in named],
                 [state["opt"]["v"][k] for k in named])
        n_par = sum(p.numel() for p in params)
        sq_bytes = sum(g.numel() * g.element_size() for g in grads)
        up_bytes = sum(p.numel() * (2 * p.element_size() + g.element_size()
                                    + 16) for p, g in zip(params, grads))
        notes = {}
        calls = {
            "grad_sumsq": (lambda: grad_sumsq(grads),
                           lambda: adamw.grad_sumsq_torch(grads),
                           lambda: torch._foreach_norm(
                               grads, 2, dtype=torch.float32), sq_bytes),
            "adamw_update": (
                lambda: adamw_update(*lists, **scalars),
                lambda: adamw.adamw_update_torch(*lists, **scalars),
                lambda: torch._fused_adamw_(
                    *lists, [], [torch.ones((), device=params[0].device)
                                 for _ in params],
                    lr=1e-4, beta1=scalars["b1"], beta2=scalars["b2"],
                    weight_decay=scalars["weight_decay"],
                    eps=scalars["eps"], amsgrad=False, maximize=False),
                up_bytes)}
        rows = {}
        for name, (kernel, plain, library, n_bytes) in calls.items():
            try:
                lib_ms = cuda_ms(library, 3)
            except (RuntimeError, TypeError) as e:
                lib_ms, notes[name] = None, str(e).strip().splitlines()[0]
            b_ms, b_by = bound(n_bytes, 0, FP32_OPS_PER_S)
            rows[name] = dict(
                shape=f"{label}: {len(params)} tensors, {n_par} parameters",
                tensors=len(params), parameters=n_par,
                kept_tensors=kept.get(name), ms=cuda_ms(kernel, 3),
                plain_ms=cuda_ms(plain, 1), bound_ms=b_ms, bound_by=b_by,
                bytes=n_bytes, library_ms=lib_ms,
                **({"library_error": notes[name][:200]} if name in notes
                   else {}))
            rows[name]["bound_share"] = b_ms / rows[name]["ms"]
            print(f"train {label} {name} " + json.dumps(rows[name]))
        del params, grads, lists
    return errs, rows


def train_phase(dev):
    """Train gemma2-2b at full width and depth in bf16 for three steps
    through ``Trainer`` (checkpoint at step 2 and at the end), resume
    step 3 from the checkpoint into a fresh state and hold it to the
    uninterrupted run bit for bit; two timed ``make_train_step`` calls of
    paligemma-3b, hubert-xlarge and mamba2-780m at full size and of
    zamba2-7b and deepseek-v2-lite-16b cut in depth (deepseek's routes
    then placed by AMTHA on one H100 node); the float32 gradient gate of
    each; the backward kernels held to their plain versions at every
    shape the phase launched and timed. Returns the kernels' JSON entries
    (the three backward kernels), the forward kernels' counts by run and
    largest errors, and the forward ``flash_attention`` rows at MLA's
    training shape."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_bwd_torch
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_torch
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_torch,
                                              ssd_scan_torch)
    from repro_torch.models import ShardCtx
    from repro_torch.optim import OptConfig
    from repro_torch.runtime.train_loop import (Trainer, init_train_state,
                                                make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    opt = OptConfig()               # the defaults: 100 warmup steps
    keys = spy_train_keys()
    launches, steps, adamw_tensors = {}, {}, {}
    adamw_errs = {"grad_sumsq": [], "adamw_update": []}
    adamw_rows = {"grad_sumsq": [], "adamw_update": []}
    torch.cuda.reset_peak_memory_stats()

    def counts(cfg, n):
        """The launches of ``n`` steps: the model's kernels, and AdamW's
        two calls a step."""
        return dict(train_counts(cfg, n), grad_sumsq=n, adamw_update=n)

    def adamw_run(label, key, state, n):
        errs, rows = hold_adamw(label, spies, state, n, adamw_tensors[key])
        for name in adamw_rows:
            adamw_errs[name].append(errs[name])
            adamw_rows[name].append(rows[name])

    def step_record(label, cfg, run, times, want, got):
        b, s = run["batch"], run["seq"]
        ms = float(np.median(times)) * 1e3
        rec = dict(step_ms=ms, step_ms_all=[t * 1e3 for t in times],
                   tokens_per_s=b * s / ms * 1e3, batch=b, seq=s,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"train {label}: " + json.dumps(rec) + f" launches {got}")
        if got != want:
            fail(f"train {label}: launches {got} != {want}")
        steps[label] = rec

    with contextlib.ExitStack() as stack:
        spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                 for k in TRAIN_KERNELS}

        # -- gemma2-2b: Trainer to step 2 (its checkpoint), then step 3 -----
        # One checkpoint of the state is 26 GB (bf16 parameters, float32
        # moments); to write one and not two, the Trainer runs to the
        # checkpoint at step 2 (its end) and step 3 is one
        # ``make_train_step`` call, uninterrupted and again from the
        # restored state.
        cfg = ARCHS[TRAIN_ARCH]
        print(f"train: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
              f"{cfg.dtype} remat={cfg.remat} B={TRAIN_RUN['batch']} "
              f"S={TRAIN_RUN['seq']}")
        gen = torch.Generator(device=dev).manual_seed(0)
        state = init_train_state(cfg, opt, gen, dev)
        redraw(state["params"], gen, dev)
        pcfg = PipelineConfig(batch=TRAIN_RUN["batch"],
                              seq_len=TRAIN_RUN["seq"], seed=0)
        pipe = TokenPipeline(cfg, pcfg, device=dev)
        at = TRAIN_RUN["ckpt_at"]
        trainer = Trainer(cfg, opt, ShardCtx(), str(ckpt_dir),
                          ckpt_every=at)
        step_fn = make_train_step(cfg, opt, ShardCtx())
        for sp in spies.values():
            sp.launches = 0
        spies["adamw_update"].tensors = 0
        t0 = time.perf_counter()
        state, history, _ = trainer.run(state, pipe, at, log_every=1)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pipe.make_batch(at))
        losses = [h["loss"] for h in history] + [float(metrics["loss"])]
        last = time.perf_counter() - t0
        launches["train_gemma2"] = {k: sp.launches for k, sp in spies.items()}
        adamw_tensors["train_gemma2"] = spies["adamw_update"].tensors
        # the Trainer's own step times (each ends in the loss's read-back)
        # and step 3's; the first step also builds cuBLAS plans and grows
        # the allocator
        step_record("gemma2-2b", cfg, TRAIN_RUN,
                    [h["sec_per_step"] for h in history[1:]] + [last],
                    counts(cfg, TRAIN_RUN["steps"]),
                    launches["train_gemma2"])
        print(f"train gemma2-2b: Trainer wall_s={wall:.2f} ({at} steps and "
              f"the checkpoint at step {at}, written on a thread, waited "
              f"for); losses {losses}")
        if len(losses) != 3 or not all(np.isfinite(losses)):
            fail(f"train gemma2-2b: losses {losses}")
        mgr = CheckpointManager(str(ckpt_dir))
        if mgr.list_steps() != [at]:
            fail(f"train gemma2-2b: committed checkpoints {mgr.list_steps()}")
        final = {k: p.detach().to("cpu", copy=True) for k, p in
                 state["params"].named_parameters()}
        profile_step(lambda: step_fn(state, pipe.make_batch(at + 1)),
                     steps["gemma2-2b"], *TRAIN_PROFILE)
        print("train gemma2-2b step profile " + json.dumps(
            steps["gemma2-2b"]))
        adamw_run("gemma2-2b", "train_gemma2", state, TRAIN_RUN["steps"])
        del state, trainer, step_fn
        gc.collect()
        torch.cuda.empty_cache()

        # -- resume: a fresh state restored from step 2, then step 3 ------
        t0 = time.perf_counter()
        fresh = init_train_state(cfg, opt, torch.Generator(
            device=dev).manual_seed(1), dev)
        fresh = mgr.restore(fresh, at)
        restore_s = time.perf_counter() - t0
        fresh, metrics = make_train_step(cfg, opt, ShardCtx())(
            fresh, pipe.make_batch(at))
        same_loss = float(metrics["loss"]) == losses[2]
        diff = [k for k, p in fresh["params"].named_parameters()
                if not torch.equal(p.detach().cpu(), final[k])]
        print(f"train gemma2-2b resume: restore_s={restore_s:.2f} step-3 "
              f"loss {float(metrics['loss'])!r} vs {losses[2]!r}; "
              f"{len(final) - len(diff)} of {len(final)} parameters equal "
              f"bit for bit")
        if not same_loss or diff:
            fail(f"train gemma2-2b: resumed step 3 differs (loss equal "
                 f"{same_loss}, parameters differing {diff[:5]})")
        del fresh, final, metrics
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        freed("train gemma2-2b")

        # -- paligemma-3b, hubert-xlarge, mamba2-780m whole, zamba2-7b and
        #    deepseek-v2-lite-16b at full width cut in depth: a warm-up
        #    step and two timed; deepseek's last timed step's routes then
        #    placed by AMTHA onto one H100 node ----------------------------
        cuts = {"zamba2-7b": zamba_cut, MOE_TRAIN_ARCH: deepseek_cut}
        for label, name, run in (("paligemma-3b", "paligemma-3b", VLM_TRAIN),
                                 ("hubert-xlarge", "hubert-xlarge",
                                  ENC_TRAIN),
                                 ("mamba2-780m", "mamba2-780m", SSM_TRAIN),
                                 ("zamba2-7b", "zamba2-7b", SSM_TRAIN),
                                 (MOE_TRAIN_ARCH, MOE_TRAIN_ARCH,
                                  MOE_TRAIN)):
            cfg = cuts[name](dev) if name in cuts else ARCHS[name]
            moe = cfg.family == "moe"
            print(f"train: {cfg.name} {cfg.n_layers} layers "
                  f"d={cfg.d_model} {cfg.dtype} remat={cfg.remat} "
                  f"B={run['batch']} S={run['seq']}")
            gen = torch.Generator(device=dev).manual_seed(0)
            state = init_train_state(cfg, opt, gen, dev)
            redraw(state["params"], gen, dev)
            pipe = TokenPipeline(cfg, PipelineConfig(
                batch=run["batch"], seq_len=run["seq"]), device=dev)
            step_fn = make_train_step(cfg, opt, ShardCtx())
            state, _ = step_fn(state, pipe.make_batch(0))   # warm-up
            for sp in spies.values():
                sp.launches = 0
            spies["adamw_update"].tensors = 0
            times = []
            for i in (1, 2):
                # the last timed step's routes, kept on the card and read
                # back after the timing
                rec = recorded_routes() if moe and i == 2 \
                    else contextlib.nullcontext([])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with rec as routes:
                    state, metrics = step_fn(state, pipe.make_batch(i))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if not np.isfinite(float(metrics["loss"])):
                fail(f"train {label}: loss {float(metrics['loss'])}")
            key = f"train_{name.split('-')[0]}"
            launches[key] = {k: sp.launches for k, sp in spies.items()}
            adamw_tensors[key] = spies["adamw_update"].tensors
            step_record(label, cfg, run, times, counts(cfg, 2),
                        launches[key])
            if moe:
                steps[label]["placement"] = place_from_routes(cfg, routes)
                del routes
            profile_step(lambda: step_fn(state, pipe.make_batch(3)),
                         steps[label], *((1, 1) if moe else TRAIN_PROFILE),
                         experts=cfg.n_experts if moe else None)
            print(f"train {label} step profile " + json.dumps(
                {k: v for k, v in steps[label].items() if k != "placement"}))
            adamw_run(label, key, state, 2)
            del state, step_fn, metrics
            freed(f"train {label}")

        # -- the float32 gradient gate at full width, 2 layers -------------
        def lm_batch(c, b=TRAIN_RUN["batch"], s=TRAIN_RUN["seq"]):
            return TokenPipeline(c, PipelineConfig(batch=b, seq_len=s),
                                 device=dev).make_batch(0)
        grad_gate("gemma2-2b", ARCHS["gemma2-2b"], dev, lm_batch, ops)
        grad_gate("paligemma-3b", ARCHS["paligemma-3b"], dev,
                  lambda c: lm_batch(c, VLM_TRAIN["batch"], VLM_TRAIN["seq"]),
                  ops)
        grad_gate("hubert-xlarge", ARCHS["hubert-xlarge"], dev,
                  lambda c: lm_batch(c, ENC_TRAIN["batch"],
                                     ENC_TRAIN["seq"]), ops)
        for name in ("mamba2-780m", "zamba2-7b"):
            grad_gate(name, ARCHS[name], dev, lambda c: lm_batch(
                c, SSM_TRAIN["batch"], SSM_TRAIN["seq"]), ops)
        grad_gate(MOE_TRAIN_ARCH, ARCHS[MOE_TRAIN_ARCH], dev, lambda c:
                  lm_batch(c, MOE_TRAIN["batch"], MOE_TRAIN["seq"]), ops)

    # -- the backward kernels against their plain versions, timed --------
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, h, d, dv = MLA_BWD_ROW
    mla = [torch.randn(shape, generator=gen, device=dev).bfloat16()
           for shape in ((b, s, h, d), (b, s, h, d), (b, s, h, dv))]
    mla_out, mla_lse = ops.flash_attention(*mla, scale=d ** -0.5,
                                           return_lse=True)
    mla_dout = torch.randn((b, s, h, dv), generator=gen, device=dev) \
        .bfloat16()
    bwd_cases = [(f"path{k}", a, kw) for k, (a, kw) in
                 spies["flash_attention_bwd"].calls.items()]
    bwd_cases.append(("mla", [*mla, mla_out, mla_dout, mla_lse],
                      dict(scale=d ** -0.5)))
    errs = {"flash_attention_bwd": 0.0, "rmsnorm_bwd": 0.0}
    rows = {"flash_attention_bwd": [], "rmsnorm_bwd": []}
    for case, args, kw in bwd_cases:
        got = ops.flash_attention_bwd(*args, **kw)
        want = flash_attention_bwd_torch(*args, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            ok, err = close_to_plain(g, w)
            if not ok:
                fail(f"flash_attention_bwd {case}: kernel off the plain "
                     f"version (max abs err {err:.3e})")
            errs["flash_attention_bwd"] = max(
                errs["flash_attention_bwd"], err)
        if args[0].dtype == torch.bfloat16:
            rows["flash_attention_bwd"].append(attention_bwd_row(args, kw))
            print("flash_attention_bwd " + json.dumps(
                rows["flash_attention_bwd"][-1]))
    errs["ssd_scan_bwd"] = 0.0
    rows["ssd_scan_bwd"] = []
    for case, (args, kw) in spies["ssd_scan_bwd"].calls.items():
        got = ops.ssd_scan_bwd(*args, **kw)
        want = ssd_scan_bwd_torch(*args, **kw)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("dx", "ddt", "dA", "dB", "dC")):
            ok, err = close_to_plain(g, w)
            if not ok:
                fail(f"ssd_scan_bwd {case} {what}: kernel off the plain "
                     f"version (max abs err {err:.3e}, "
                     f"{gate_ratio(g, w):.2f} of the gate)")
            errs["ssd_scan_bwd"] = max(errs["ssd_scan_bwd"], err)
        rows["ssd_scan_bwd"].append(ssd_bwd_row(args))
        print("ssd_scan_bwd " + json.dumps(rows["ssd_scan_bwd"][-1]))
        gc.collect()
        torch.cuda.empty_cache()
    for case, (args, kw) in spies["rmsnorm_bwd"].calls.items():
        got = ops.rmsnorm_bwd(*args, **kw)
        want = rmsnorm_bwd_torch(*args, **kw)
        torch.cuda.synchronize()
        rows_n = args[0].numel() // args[0].shape[-1]
        for g, w, what in zip(got, want, ("dx", "dw")):
            if what == "dw" and w.dtype == torch.float32:
                # dw sums every row: float32 sums in another order
                err = float((g - w).abs().max())
                ok = err <= 1e-5 * float(w.abs().max()) * max(
                    1.0, rows_n ** 0.5 / 10)
            else:
                ok, err = close_to_plain(g, w)
            if not ok:
                fail(f"rmsnorm_bwd {case} {what}: kernel off the plain "
                     f"version (max abs err {err:.3e})")
            errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], err)
        if args[0].dtype == torch.bfloat16 and args[0].dim() == 3:
            rows["rmsnorm_bwd"].append(norm_bwd_row(*args, kw))
            print("rmsnorm_bwd " + json.dumps(rows["rmsnorm_bwd"][-1]))
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.rmsnorm import rmsnorm_torch
    # the forward at MLA's training shape (D 192, Dv 128), timed
    fwd_rows = {"flash_attention": []}
    for (q, k, v), akw in spies["flash_attention"].calls.values():
        if q.dtype == torch.bfloat16 and q.shape[-1] != v.shape[-1]:
            fwd_rows["flash_attention"].append(attention_fwd_row((q, k, v),
                                                                 akw))
            print("train flash_attention " + json.dumps(
                fwd_rows["flash_attention"][-1]))
    errs.update(hold_to_plain(
        "train", {k: spies[k] for k in ("flash_attention", "rmsnorm",
                                        "ssd_scan")},
        {"flash_attention": flash_attention_torch, "rmsnorm": rmsnorm_torch,
         "ssd_scan": ssd_scan_torch}))
    print(f"training kernels within tolerance of their plain versions at "
          f"{len(bwd_cases)} flash_attention_bwd, "
          f"{len(spies['rmsnorm_bwd'].calls)} rmsnorm_bwd and "
          f"{len(spies['ssd_scan_bwd'].calls)} ssd_scan_bwd shapes: max abs "
          f"err {errs}")
    print("train steps " + json.dumps(steps))

    sources = {"flash_attention_bwd": "flash_attention_bwd.cu",
               "rmsnorm_bwd": "rmsnorm.cu", "ssd_scan_bwd": "ssd_scan.cu"}
    replaces = {
        "flash_attention_bwd": "_flash_bwd, src/repro/models/layers.py:352",
        "rmsnorm_bwd": "rms_norm by autodiff, src/repro/models/layers.py:26",
        "ssd_scan_bwd": "ssd_chunked by autodiff, src/repro/models/ssm.py:29"
                        " (the Pallas ssd_scan, src/repro/kernels/"
                        "ssd_scan.py:74, has no VJP)"}
    entries = []
    for name in ("flash_attention_bwd", "rmsnorm_bwd", "ssd_scan_bwd"):
        bf16_rows = [r for r in rows[name] if "bfloat16" in r["shape"]] \
            or rows[name]
        main = max(bf16_rows, key=lambda r: r["bytes"]) \
            if name == "rmsnorm_bwd" else \
            max(bf16_rows, key=lambda r: r["flops"])
        entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{sources[name]}",
            replaces="none: the reference differentiates " + replaces[name],
            launches=sum(launches[r][name] for r in launches),
            launches_by_path={r: launches[r][name] for r in launches},
            max_abs_err=errs[name], ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"],
            rows=rows[name]))
    # AdamW's two multi-tensor kernels: the row of the run with the most
    # parameters is the entry's
    for name, replaces in (
            ("grad_sumsq", "global_norm's sums of squares in plain jnp, "
                           "src/repro/optim/adamw.py:57"),
            ("adamw_update", "apply_updates in plain jnp, "
                             "src/repro/optim/adamw.py:71")):
        main = max(adamw_rows[name], key=lambda r: r["parameters"])
        entries.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/adamw.cu",
            replaces="none: the reference runs " + replaces,
            launches=sum(launches[r][name] for r in launches),
            launches_by_path={r: launches[r][name] for r in launches},
            tensors_by_path=dict(adamw_tensors),
            max_abs_err=max(e[0] for e in adamw_errs[name]),
            max_rel_err=max(e[1] for e in adamw_errs[name]),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"],
            rows=adamw_rows[name]))
    print(f"AdamW kernels held to their plain versions in "
          f"{len(adamw_rows['adamw_update'])} training runs (the update bit "
          f"for bit, the sums of squares within rtol 1e-6): tensors a run "
          f"{adamw_tensors}")
    fwd = {k: {r: launches[r][k] for r in launches}
           for k in ("rmsnorm", "flash_attention", "ssd_scan")}
    return entries, fwd, {k: errs[k] for k in fwd}, fwd_rows


# -- 16. AMTHA's placements executed on a mesh: the expert-parallel MoE
#        dispatches and the GPipe pipeline on a one-rank NCCL group -------

MESH_GEN = 8                        # deepseek run A's prompt, then 7 steps
MOE_LAYER_RUN = dict(batch=2, seq=1024)   # one MoE layer, as phase 15
MOE_LAYER_REPS = 5
PIPE_RUN = dict(n_micro=4, bm=1, seq=1024)
PIPE_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                "flash_attention_bwd")
TIED_GRAD_REL = 2.0 ** -6           # four bf16 ulps at the largest value


@contextlib.contextmanager
def recorded_drops():
    """Each ``moe._dispatch_indices`` call's share of routed copies past
    their expert's capacity, in call order (one a MoE layer a forward),
    while the block runs."""
    from repro_torch.models import moe
    shares, real = [], moe._dispatch_indices

    def dispatch(ids, top_k, n_experts, capacity):
        out = real(ids, top_k, n_experts, capacity)
        shares.append(1.0 - out[3].float().mean())
        return out
    moe._dispatch_indices = dispatch
    try:
        yield shares
    finally:
        moe._dispatch_indices = real


def hold_to_plain(label, spies, plains):
    """Each spied kernel at every shape it was called with, against its
    plain version (``close_to_plain``); returns the largest errors."""
    import torch

    from repro_torch.kernels import ops
    errs = {}
    for name, spy in spies.items():
        errs[name] = 0.0
        for case, (args, kw) in spy.calls.items():
            got = getattr(ops, name)(*args, **kw)
            want = plains[name](*args, **kw)
            torch.cuda.synchronize()
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                if g is None:
                    continue
                ok, err = close_to_plain(g, w)
                if not ok:
                    fail(f"{label} {name} {case}: kernel off the plain "
                         f"version (max abs err {err:.3e})")
                errs[name] = max(errs[name], err)
    print(f"{label}: kernels within tolerance of their plain versions at "
          f"{ {k: len(s.calls) for k, s in spies.items()} } shapes, max "
          f"abs err {errs}")
    return errs


def moe_layer_times(cfg, layer, ctx, dev):
    """One MoE layer's forward plus backward at ``MOE_LAYER_RUN`` in
    bf16, through the ``a2a`` dispatch (under ``ctx``, at the config's
    capacity) and the dense one, in turns (a2a, dense, dense, a2a), each
    ``MOE_LAYER_REPS`` readings of ``cuda_ms(step, 1)`` (CUDA events,
    after two warm-up calls), with the routes of the a2a call
    (``recorded_routes``) and its dropped share."""
    import torch

    from repro_torch.models.moe import moe_ffn
    p = layer.moe
    gen = torch.Generator(device=dev).manual_seed(16)
    shape = (MOE_LAYER_RUN["batch"], MOE_LAYER_RUN["seq"], cfg.d_model)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    c = torch.randn(shape, generator=gen, device=dev)
    x.requires_grad_(True)
    for w in (p.router, p.wi, p.wo):
        w.requires_grad_(True)

    def step(c_ctx):
        y, aux = moe_ffn(x, p, cfg, c_ctx)
        ((y.float() * c).sum() + aux).backward()
        x.grad = None
        for w in (p.router, p.wi, p.wo):
            w.grad = None
    with recorded_routes() as routes, recorded_drops() as drops:
        step(ctx)
    ms = {"a2a": [], "dense": []}
    for name in ("a2a", "dense", "dense", "a2a"):
        ms[name] += [cuda_ms(lambda: step(ctx if name == "a2a" else None), 1)
                     for _ in range(MOE_LAYER_REPS)]
    for w in (p.router, p.wi, p.wo):
        w.requires_grad_(False)
    t = shape[0] * shape[1]
    cap = max(1, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    load = torch.bincount(routes[0].reshape(-1), minlength=cfg.n_experts)
    return dict(shape=list(shape), dtype="bfloat16",
                a2a_ms=sorted(ms["a2a"]), dense_ms=sorted(ms["dense"]),
                a2a_ms_median=float(sorted(ms["a2a"])[len(ms["a2a"]) // 2]),
                dense_ms_median=float(
                    sorted(ms["dense"])[len(ms["dense"]) // 2]),
                capacity=cap, copy_slots=cfg.n_experts * cap,
                dense_products=cfg.n_experts * t,
                expert_load_max=int(load.max()),
                expert_load_min=int(load.min()),
                dropped_share=float(drops[0]))


def mesh_phase(dev):
    """AMTHA's placements executed on a one-rank NCCL group (a
    ``HashStore``, world size 1), destroyed at the end. (a)
    deepseek-v2-lite-16b whole in bf16 under a (1, 1) ``("data",
    "model")`` mesh, its experts kept by ``shard_experts``: run A's
    prompt through ``generate`` with the capacity raised so no copy
    drops (prefill by ``moe_a2a``, decode by ``moe_local_decode``), exact
    counts; its teacher-forced logits against the dense dispatch on the
    same routes within ``LOGIT_REL``; decode steps from one cache by
    both dispatches, bit for bit; the copies dropped at the config's
    capacity, per MoE layer; one MoE layer's forward and backward timed
    through both. (b) gemma2-2b whole in bf16 through
    ``make_pipelined_forward`` on a one-rank ``("pod",)`` mesh, one
    stage: the logits and the gradients of mean(logits²) against the
    per-microbatch ``forward`` bit for bit, exact counts. Returns the
    four kernels' counts by run and their largest errors."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_torch, flash_attention_torch)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_torch, rmsnorm_torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, forward
    from repro_torch.runtime import generate
    from repro_torch.runtime.pipeline import make_pipelined_forward
    from repro_torch.sharding import MeshAxes, Partitioner, shard_experts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plains = {"rmsnorm": rmsnorm_torch,
              "flash_attention": flash_attention_torch,
              "rmsnorm_bwd": rmsnorm_bwd_torch,
              "flash_attention_bwd": flash_attention_bwd_torch}
    keys = spy_train_keys()
    launches, errs = {}, {k: 0.0 for k in PIPE_KERNELS}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        # -- (a) deepseek-v2-lite-16b, experts over a (1, 1) mesh --------
        full = ARCHS["deepseek-v2-lite-16b"].replace(dtype="bfloat16")
        torch.cuda.reset_peak_memory_stats()
        gen, params = load_model("mesh", full, dev)
        mesh = make_mesh((1, 1), ("data", "model"))
        shard_experts(params, Partitioner(mesh, MeshAxes()))
        ctx = ShardCtx(mesh=mesh, dp_axes=("data",), model_axis="model")
        # capacity E / k x 1.01 of the even share: every expert can take
        # every token once, so no copy drops
        nodrop = full.replace(capacity_factor=full.n_experts / full.top_k
                              * 1.01)
        prompt = torch.randint(0, full.vocab, (RUN_A["batch"],
                                               RUN_A["prompt"]),
                               generator=gen, device=dev)
        with contextlib.ExitStack() as stack:
            spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                     for k in ("rmsnorm", "flash_attention")}
            for sp in spies.values():
                sp.launches = 0
            decode_n = ops.flash_decode.launches
            with recorded_drops() as drops:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = generate(nodrop, ctx, params, {"tokens": prompt},
                                MESH_GEN)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches["mesh_deepseek_A"] = {k: sp.launches
                                           for k, sp in spies.items()}
            n_moe = sum(k.startswith("moe") for k in full.layer_kinds())
            norms = 2 + bool(full.kv_lora_rank)
            want = {"rmsnorm": MESH_GEN * (norms * full.n_layers + 1),
                    "flash_attention": full.n_layers}
            print(f"mesh deepseek run A (a2a prefill, local decode, "
                  f"{MESH_GEN} tokens): wall_s {wall:.3f} launches "
                  f"{launches['mesh_deepseek_A']} copies dropped "
                  f"{max(float(d) for d in drops):.3g}")
            if launches["mesh_deepseek_A"] != want or \
                    ops.flash_decode.launches != decode_n:
                fail(f"mesh deepseek run A: launches "
                     f"{launches['mesh_deepseek_A']} != {want}, "
                     f"flash_decode moved")
            if len(drops) != n_moe or max(float(d) for d in drops) != 0.0:
                fail(f"mesh deepseek run A: {len(drops)} a2a dispatches "
                     f"for {n_moe} MoE layers, or copies dropped at "
                     f"capacity {nodrop.capacity_factor:.3f}")
            if toks.shape != (RUN_A["batch"], MESH_GEN):
                fail(f"mesh deepseek run A: tokens {tuple(toks.shape)}")
            errs.update(hold_to_plain("mesh deepseek", spies, plains))

        # the a2a prefill and the local decode against the dense dispatch
        # on the same routes: the plain ctx replays the mesh run's routes
        with recorded_routes() as rk:
            kern = teacher_forced(nodrop, params, prompt, toks, ctx=ctx)
        with recorded_routes(forced=rk):
            dense = teacher_forced(nodrop, params, prompt, toks)
        scale = float(dense.abs().max())
        d_logit = float((kern - dense).abs().max())
        print(f"mesh deepseek a2a/local vs dense on the same routes: max "
              f"|dlogit| {d_logit:.4e}, bound {LOGIT_REL} x {scale:.4f}, "
              f"top-1 agreement "
              f"{float((kern.argmax(-1) == dense.argmax(-1)).float().mean()):.4f}")
        if not torch.isfinite(kern).all() or not d_logit <= LOGIT_REL * scale:
            fail(f"mesh deepseek: a2a prefill off the dense dispatch's by "
                 f"{d_logit:.4e} > {LOGIT_REL * scale:.4e}")

        # decode from one cache: at ep = 1 the local dispatch runs the
        # dense dispatch's products over every expert
        from repro_torch.runtime import make_prefill, make_serve_step, \
            pad_cache_to
        plain_ctx = ShardCtx()
        _, cache = make_prefill(nodrop, plain_ctx)(params,
                                                   {"tokens": prompt})
        cache = pad_cache_to(nodrop, cache, RUN_A["batch"],
                             RUN_A["prompt"] + MESH_GEN)
        twin = [{k: v.clone() for k, v in c.items()} for c in cache]
        local_step = make_serve_step(nodrop, ctx)
        dense_step = make_serve_step(nodrop, plain_ctx)
        same = True
        for i in range(MESH_GEN - 1):
            tok = toks[:, i:i + 1]
            _, lg_local, cache = local_step(params, cache, tok,
                                            RUN_A["prompt"] + i)
            _, lg_dense, twin = dense_step(params, twin, tok,
                                           RUN_A["prompt"] + i)
            same = same and torch.equal(lg_local, lg_dense)
        print(f"mesh deepseek local decode vs dense decode, "
              f"{MESH_GEN - 1} steps from one cache: bit for bit {same}")
        if not same:
            fail("mesh deepseek: the local decode at ep = 1 differs from "
                 "the dense decode")
        del cache, twin

        # the config's capacity (1.25): copies dropped per MoE layer
        with torch.inference_mode(), recorded_drops() as drops:
            forward(params, {"tokens": prompt}, full,
                    ctx.with_mode("prefill"))
        t = RUN_A["batch"] * RUN_A["prompt"]
        cap = int(t * full.top_k / full.n_experts * full.capacity_factor)
        shares = [round(float(d), 5) for d in drops]
        print(f"mesh deepseek run A prefill at capacity "
              f"{full.capacity_factor} ({cap} copies an expert of "
              f"{t * full.top_k}): dropped share by MoE layer "
              + json.dumps(shares))
        mesh_layer = moe_layer_times(full, params.layers[1], ctx, dev)
        print("mesh deepseek one MoE layer forward+backward "
              + json.dumps(mesh_layer))
        del params
        freed("mesh deepseek")

        # -- (b) gemma2-2b through the pipeline, one stage ----------------
        cfg = ARCHS["gemma2-2b"].replace(dtype="bfloat16")
        gen, params = load_model("mesh", cfg, dev)
        for w in params.parameters():
            w.requires_grad_(True)
        pods = make_mesh((1,), ("pod",))
        fwd = make_pipelined_forward(cfg, pods, 1)
        tokens = torch.randint(0, cfg.vocab, (PIPE_RUN["n_micro"],
                                              PIPE_RUN["bm"],
                                              PIPE_RUN["seq"]),
                               generator=gen, device=dev)

        def pipelined():
            logits = fwd(params, tokens)
            logits.float().square().mean().backward()
            return logits.detach()
        pipelined()                                  # warm-up
        params.zero_grad(set_to_none=True)
        with contextlib.ExitStack() as stack:
            spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                     for k in PIPE_KERNELS}
            for sp in spies.values():
                sp.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_pp = pipelined()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches["mesh_gemma2_pipeline"] = {k: sp.launches
                                                for k, sp in spies.items()}
            want = train_counts(cfg, PIPE_RUN["n_micro"], remat=False)
            want = {k: want[k] for k in PIPE_KERNELS}
            print(f"mesh gemma2 pipeline (1 stage, {PIPE_RUN}): fwd+bwd "
                  f"{wall * 1e3:.2f} ms, "
                  f"{wall * 1e3 / PIPE_RUN['n_micro']:.2f} ms a microbatch, "
                  f"launches {launches['mesh_gemma2_pipeline']}")
            if launches["mesh_gemma2_pipeline"] != want:
                fail(f"mesh gemma2 pipeline: launches "
                     f"{launches['mesh_gemma2_pipeline']} != {want}")
            pipe_errs = hold_to_plain("mesh gemma2 pipeline", spies, plains)
            errs = {k: max(errs.get(k, 0.0), pipe_errs.get(k, 0.0))
                    for k in PIPE_KERNELS}
        grads_pp = {k: w.grad.clone() for k, w in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        seq = torch.stack([forward(params, {"tokens": tokens[i]}, cfg,
                                   ShardCtx(mode="train"))[0]
                           for i in range(PIPE_RUN["n_micro"])])
        seq.float().square().mean().backward()
        d_logit = float((logits_pp.float() - seq.detach().float()).abs()
                        .max())
        g_diff = {k: float((grads_pp[k].float() - w.grad.float()).abs()
                           .max()) for k, w in params.named_parameters()}
        g_max = {k: float(w.grad.float().abs().max())
                 for k, w in params.named_parameters()}
        moved = sorted(k for k, v in g_diff.items() if v != 0.0)
        print(f"mesh gemma2 pipeline vs per-microbatch forward: logits bit "
              f"for bit {torch.equal(logits_pp, seq.detach())} (max "
              f"|d| {d_logit:.3e}); gradients bit for bit "
              f"{len(g_diff) - len(moved)} of {len(g_diff)}; the others, "
              f"max |d| / max |g|: "
              + json.dumps({k: g_diff[k] / g_max[k] for k in moved}))
        if not torch.equal(logits_pp, seq.detach()):
            fail("mesh gemma2 pipeline: logits differ from the "
                 "per-microbatch forward")
        # the tied embedding's gradient sums bf16 contributions (each
        # microbatch's gather and head) in another order: the sequential
        # backward takes them microbatch by microbatch, the pipeline's all
        # heads before the pipeline and then all gathers
        tied = {"embed"} if cfg.tie_embeddings else set()
        if set(moved) - tied or any(g_diff[k] > TIED_GRAD_REL * g_max[k]
                                    for k in moved):
            fail(f"mesh gemma2 pipeline: gradients {moved} differ from the "
                 f"per-microbatch forward's (only the tied embedding may, "
                 f"within {TIED_GRAD_REL} of its largest)")
        print("mesh phase " + json.dumps(dict(
            moe_layer=mesh_layer, dropped_share_by_layer=shares,
            pipeline_ms=wall * 1e3,
            pipeline_ms_per_microbatch=wall * 1e3 / PIPE_RUN["n_micro"],
            grads_bit_equal=len(g_diff) - len(moved), grads=len(g_diff),
            grads_moved={k: g_diff[k] / g_max[k] for k in moved})))
        del params, grads_pp, seq, logits_pp
        freed("mesh gemma2")
    finally:
        dist.destroy_process_group()
    by_run = {k: {r: launches[r].get(k, 0) for r in launches}
              for k in PIPE_KERNELS}
    return by_run, errs


# phase 17: offset attention kernels and the sharded train step
OFFSET_CHUNKS = 4
OFFSET_CASES = {   # b, s, hq, hkv, d, causal, window, softcap, prefix
    "gemma2-2b": (2, 1024, 8, 4, 256, True, None, 50.0, None),
    "gemma3-4b windowed": (1, 4096, 8, 4, 256, True, 1024, None, None),
    "paligemma-3b prefix": (1, 1024, 8, 1, 256, True, None, None, 256),
    "hubert-xlarge bidirectional": (2, 1000, 16, 16, 80, False, None, None,
                                    None),
}
TP_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_bwd",
              "flash_attention_bwd")


def chunk_pairs(off, n, sk, causal, window, prefix=0):
    """Visible (query, key) pairs of query rows at positions off .. off +
    n - 1 against sk keys, under the kernels' mask."""
    total = 0
    for p in range(off, off + n):
        hi = min(sk, max(p + 1, prefix)) if causal else sk
        lo = max(0, p - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def offset_rows(dev):
    """Both attention kernels on query chunks at their offsets against
    the whole K/V, at the four training shapes of ``OFFSET_CASES``, cut
    into ``OFFSET_CHUNKS`` chunks. Each chunk's output and lse (forward)
    and dq, dk, dv (backward) within ``close_to_plain`` of the plain
    versions on the same chunk; its output, lse and dq against the
    whole-sequence kernel's rows (within the gate, bit equality
    reported); the chunks' dk and dv summed in float32 against the
    whole-sequence kernel's, within the sum of the five tensors' gates
    (each within its gate of the exact value; the ratio to the whole
    one's own gate is reported). The last chunk timed from a CUDA graph
    over input copies past the L2: both kernels, the plain versions,
    the bound of its own pairs, and ``scaled_dot_product_attention``
    with the equivalent boolean mask (forward, and its autograd
    backward; null with a softcap). Calls the launchers, so no count
    moves. Returns (rows, largest errors)."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_torch,
        flash_attention_cuda, flash_attention_torch, visible)
    gen = torch.Generator(device=dev).manual_seed(17)
    rows, errs = [], {"flash_attention": 0.0, "flash_attention_bwd": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev) \
            .to(torch.bfloat16)
    for name, (b, s, hq, hkv, d, causal, window, cap, pre) in \
            OFFSET_CASES.items():
        q, k, v, dout = randn(b, s, hq, d), randn(b, s, hkv, d), \
            randn(b, s, hkv, d), randn(b, s, hq, d)
        prefix = None if pre is None else torch.full(
            (b,), pre, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, scale=d ** -0.5, window=window,
                  softcap=cap, prefix_len=prefix)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
        n = s // OFFSET_CHUNKS
        sum_k = torch.zeros(dk.shape, dtype=torch.float32, device=dev)
        sum_v = torch.zeros(dv.shape, dtype=torch.float32, device=dev)
        gate_k, gate_v = plain_bound(dk), plain_bound(dv)
        bit = {"out": True, "lse": True, "dq": True}
        for c in range(OFFSET_CHUNKS):
            off, rs = c * n, slice(c * n, (c + 1) * n)
            qc, doc = q[:, rs].contiguous(), dout[:, rs].contiguous()
            ckw = dict(kw, q_offset=off)
            oc, lc = flash_attention_cuda(qc, k, v, return_lse=True, **ckw)
            po, pl = flash_attention_torch(qc, k, v, return_lse=True, **ckw)
            g = flash_attention_bwd_cuda(qc, k, v, oc, doc, lc, **ckw)
            pg = flash_attention_bwd_torch(qc, k, v, oc, doc, lc, **ckw)
            torch.cuda.synchronize()
            for what, got, want, kern in (
                    ("out", oc, po, "flash_attention"),
                    ("lse", lc, pl, "flash_attention"),
                    ("dq", g[0], pg[0], "flash_attention_bwd"),
                    ("dk", g[1], pg[1], "flash_attention_bwd"),
                    ("dv", g[2], pg[2], "flash_attention_bwd")):
                ok, err = close_to_plain(got, want)
                if not ok:
                    fail(f"offset {name} chunk @{off} {what}: kernel off "
                         f"the plain version (max abs err {err:.3e})")
                errs[kern] = max(errs[kern], err)
            for what, got, want in (("out", oc, out[:, rs]),
                                    ("lse", lc, lse[:, :, rs]),
                                    ("dq", g[0], dq[:, rs])):
                ok, err = close_to_plain(got, want.contiguous())
                if not ok:
                    fail(f"offset {name} chunk @{off} {what}: off the "
                         f"whole sequence's rows (max abs err {err:.3e})")
                bit[what] = bit[what] and torch.equal(got, want)
            sum_k += g[1].float()
            sum_v += g[2].float()
            gate_k += plain_bound(g[1])
            gate_v += plain_bound(g[2])
        sums = {}
        for what, got, want, gate in (("dk", sum_k, dk, gate_k),
                                      ("dv", sum_v, dv, gate_v)):
            err = (got.double() - want.double()).abs()
            if not bool((err <= gate).all()):
                fail(f"offset {name}: the chunks' {what} summed off the "
                     f"whole sequence's by {float(err.max()):.3e}, past "
                     f"the sum of the gates")
            sums[what] = dict(max_abs_err=float(err.max()),
                              over_sum_of_gates=float((err / gate).max()),
                              over_whole_gate=gate_ratio(got, want))
        # the last chunk timed: kernels, plain versions, bound, library
        off, rs = (OFFSET_CHUNKS - 1) * n, slice((OFFSET_CHUNKS - 1) * n,
                                                 OFFSET_CHUNKS * n)
        qc, doc = q[:, rs].contiguous(), dout[:, rs].contiguous()
        ckw = dict(kw, q_offset=off)
        oc, lc = flash_attention_cuda(qc, k, v, return_lse=True, **ckw)
        pairs = b * chunk_pairs(off, n, s, causal, window, pre or 0)
        el = q.element_size()
        f_bytes = el * (qc.numel() + k.numel() + v.numel() + oc.numel()) \
            + 4 * lc.numel()
        b_bytes = el * (3 * qc.numel() + 2 * k.numel() + 2 * v.numel()
                        + oc.numel()) + 4 * lc.numel()
        f_ms, f_by = bound(f_bytes, 2 * hq * pairs * 2 * d, BF16_OPS_PER_S)
        bw_ms, bw_by = bound(b_bytes, 2 * hq * pairs * 5 * d,
                             BF16_OPS_PER_S)
        nxt = turns(qc, k, v)
        fwd = graph_ms(lambda: flash_attention_cuda(
            *nxt(), return_lse=True, **ckw), 10)
        fwd_plain = graph_ms(lambda: flash_attention_torch(
            *nxt(), return_lse=True, **ckw), 2)
        nxb = turns(qc, k, v, oc, doc, lc)
        bwd = graph_ms(lambda: flash_attention_bwd_cuda(*nxb(), **ckw), 10)
        bwd_plain = graph_ms(lambda: flash_attention_bwd_torch(*nxb(),
                                                               **ckw), 2)
        lib_f = lib_b = None
        if cap is None:
            mask = visible(n, causal=causal, window=window, prefix_len=prefix,
                           device=dev, sk=s, q_offset=off)
            mask = mask[:, None] if mask.dim() == 3 else mask
            lib_f = graph_ms(lambda: sdpa(qc, k, v, mask, False,
                                          kw["scale"]), 10)
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (qc, k, v)]
            lout = sdpa(*leaves, mask, False, kw["scale"])
            lib_b = cuda_ms(lambda: torch.autograd.grad(
                lout, leaves, doc, retain_graph=True), 10)
        rows.append(dict(
            name=name, chunk=f"q ({b}, {n}, {hq}, {d}) at q_offset {off} "
                             f"against k/v ({b}, {s}, {hkv}, {d})",
            causal=causal, window=window, softcap=cap, prefix=pre,
            bit_equal_to_whole=bit, summed_dk_dv=sums,
            fwd_ms=fwd, fwd_plain_ms=fwd_plain, fwd_bound_ms=f_ms,
            fwd_bound_by=f_by, fwd_library_ms=lib_f,
            bwd_ms=bwd, bwd_plain_ms=bwd_plain, bwd_bound_ms=bw_ms,
            bwd_bound_by=bw_by, bwd_library_ms=lib_b))
        print("offset attention " + json.dumps(rows[-1]))
        del q, k, v, dout, out, lse, dq, dk, dv, sum_k, sum_v
    return rows, errs


def tp_phase(dev):
    """Tensor-parallel execution (ROADMAP A13b2) and FSDP with ZeRO-1
    (A13b3) on one card. (a) ``offset_rows``: both attention kernels on
    query chunks at their offsets. (b) gemma2-2b whole in bf16, one
    ``make_train_step`` on one device from seed 0, and one with int8
    compression; then the same weights on a one-rank NCCL (1, 1)
    ``("data", "model")`` mesh through ``mesh_axes_for`` (FSDP on: 5.2
    GB of weights over one model rank), ``make_ctx`` and
    ``launch.train.sharded_train_state`` (every matrix cut by its whole
    spec, the moments made at their ZeRO-1 specs), one sharded step
    (``param_specs``, ``moment_specs``) and one with int8, counts zeroed
    just before each and read just after: the loss, the grad norm and
    every updated parameter against the matching one-device step's bit
    for bit (at one rank every collective, the layers' all-gathers and
    their gradients' reduce-scatters too, is a copy, and the sums run in
    the one-device order), the launches exact. One state is resident at
    a time. Returns (the kernels' counts by run, their largest errors,
    the offset rows)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_torch, flash_attention_torch)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_torch, rmsnorm_torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import make_ctx, mesh_axes_for
    from repro_torch.launch.train import sharded_train_state
    from repro_torch.models import ShardCtx
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime.train_loop import make_train_step
    from repro_torch.sharding import Partitioner

    t_phase = time.perf_counter()
    rows, errs = offset_rows(dev)
    cfg = ARCHS["gemma2-2b"].replace(dtype="bfloat16")
    opts = {"": OptConfig(), " int8": OptConfig(compression="int8")}
    batch = TokenPipeline(cfg, PipelineConfig(
        batch=TRAIN_RUN["batch"], seq_len=TRAIN_RUN["seq"], seed=0),
        device=dev).make_batch(0)

    def one_step(ctx, opt, part=None):
        _, params = load_model("tp", cfg, dev)
        if part is not None:
            state, specs = sharded_train_state(params, opt, part)
        else:
            params.requires_grad_(True)
            state = {"params": params, "opt": init_opt_state(params, opt)}
            specs = (None, None)
        step = make_train_step(cfg, opt, ctx, 1, *specs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        return state, metrics, (time.perf_counter() - t0) * 1e3

    hosts, wants, one_ms = {}, {}, {}
    for tag, opt in opts.items():
        state, want, one_ms[tag] = one_step(ShardCtx(mode="train"), opt)
        hosts[tag] = {k: p.detach().to("cpu") for k, p in
                      state["params"].named_parameters()}
        wants[tag] = {k: float(v) for k, v in want.items()}
        del state
        freed(f"tp one device{tag}")
    launches = {}
    keys = spy_train_keys()
    plains = {"rmsnorm": rmsnorm_torch,
              "flash_attention": flash_attention_torch,
              "rmsnorm_bwd": rmsnorm_bwd_torch,
              "flash_attention_bwd": flash_attention_bwd_torch}
    counts = train_counts(cfg, 1)
    counts = {k: counts[k] for k in TP_KERNELS}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        axes = mesh_axes_for(cfg, mesh)
        if not axes.fsdp:
            fail(f"tp gemma2 mesh: mesh_axes_for gave {axes}, not FSDP")
        part = Partitioner(mesh, axes)
        ctx = make_ctx(cfg, ShapeConfig("train", TRAIN_RUN["seq"],
                                        TRAIN_RUN["batch"], "train"),
                       mesh, axes)
        got, mesh_ms = {}, {}
        with contextlib.ExitStack() as stack:
            spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                     for k in TP_KERNELS}
            for tag, opt in opts.items():
                run = f"tp_gemma2_mesh{tag.replace(' ', '_')}_step"
                for sp in spies.values():
                    sp.launches = 0
                state, metrics, mesh_ms[tag] = one_step(ctx, opt, part)
                launches[run] = {k: sp.launches for k, sp in spies.items()}
                if launches[run] != counts:
                    fail(f"{run}: launches {launches[run]} != {counts}")
                fsdp = len(state["params"].fsdp_dims)
                got[tag] = {k: float(v) for k, v in metrics.items()}
                same = [k for k, p in state["params"].named_parameters()
                        if torch.equal(p.detach().cpu(), hosts[tag][k])]
                n = len(hosts[tag])
                want = wants[tag]
                print(f"tp gemma2-2b one{tag} step on the (1, 1) mesh "
                      f"(fsdp={axes.fsdp}: {fsdp} of {n} parameters "
                      f"gathered, moments at ZeRO-1 specs, attn_mode="
                      f"{ctx.attn_mode}) vs one device: loss "
                      f"{got[tag]['loss']!r} / {want['loss']!r}, grad_norm "
                      f"{got[tag]['grad_norm']!r} / {want['grad_norm']!r}, "
                      f"parameters bit for bit {len(same)} of {n}; step ms "
                      f"{mesh_ms[tag]:.2f} / {one_ms[tag]:.2f} (first "
                      f"steps, not timings)")
                if got[tag]["loss"] != want["loss"] or \
                        got[tag]["grad_norm"] != want["grad_norm"] or \
                        len(same) != n or not fsdp:
                    fail(f"{run}: not the one-device step bit for bit "
                         f"({n - len(same)} parameters differ, {fsdp} "
                         f"gathered)")
                del state, hosts[tag]
                freed(f"tp gemma2 mesh{tag}")
            step_errs = hold_to_plain("tp gemma2 mesh steps", spies, plains)
    finally:
        dist.destroy_process_group()
    for k in errs:
        errs[k] = max(errs[k], step_errs.get(k, 0.0))
    for k in ("rmsnorm", "rmsnorm_bwd"):
        errs[k] = step_errs.get(k, 0.0)
    print("tp phase " + json.dumps(dict(
        seconds=time.perf_counter() - t_phase, loss=got[""]["loss"],
        grad_norm=got[""]["grad_norm"], int8_loss=got[" int8"]["loss"],
        int8_grad_norm=got[" int8"]["grad_norm"],
        mesh_first_step_ms=mesh_ms[""], one_device_first_step_ms=one_ms[""],
        mesh_int8_first_step_ms=mesh_ms[" int8"],
        one_device_int8_first_step_ms=one_ms[" int8"], launches=launches)))
    by_run = {k: {r: launches[r].get(k, 0) for r in launches}
              for k in TP_KERNELS}
    return by_run, errs, rows

# ---------------------------------------------------------------------------
# phase 18: tensor parallelism of every family, decode over slot ranges
# ---------------------------------------------------------------------------

SLOT_CASES = {      # b, t, hq, hkv, d, ring, softcap, pos
    "glm4-9b": (4, 4096, 32, 2, 128, False, None, (4095, 3000, 1500, 200)),
    "paligemma-3b": (2, 2048, 8, 1, 256, False, None, (2047, 1000)),
    "gemma2-2b local ring": (2, 4096, 8, 4, 256, True, 50.0, (5000, 4700)),
    "empty ranges": (1, 1024, 8, 4, 256, False, None, (60,)),
}
SLOT_SPLITS = (4, 8)                # model ranks a cache's slots split over
LSE_REL = 1e-5                      # a range's lse against the plain one's
TP_FAMILY_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_bwd",
                     "ssd_scan", "ssd_scan_bwd")
TP_DECODE_GEN = 4                   # deepseek: run A's prompt, 3 steps


def range_timing(q, kc, vc, pos, dkw, lse):
    """Device ms of ``flash_decode`` (with ``return_lse`` where ``lse``)
    from a CUDA graph of calls taking turns over copies of the cache
    holding three times the L2, and of its plain version; the bound of
    the bytes the call moves (its valid slots, q, and a float32 out and
    lse with ``lse``, else out in q's type) and of its operations."""
    from repro_torch.kernels.flash_decode import (flash_decode_cuda,
                                                  flash_decode_torch)
    n_bytes, flops = decode_cost(q, kc, vc, pos, ring=dkw.get("ring", False))
    if lse:
        b, hq = q.shape[:2]
        n_bytes += (4 - q.element_size()) * b * hq * vc.shape[-1] + 4 * b * hq
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    cache = kc.numel() * kc.element_size() + vc.numel() * vc.element_size()
    copies = [(kc, vc)] + [(kc.clone(), vc.clone())
                           for _ in range(-(-3 * L2_BYTES // cache))]
    turn = itertools.count()

    def kernel():
        k, v = copies[next(turn) % len(copies)]
        return flash_decode_cuda(q, k, v, pos, return_lse=lse, **dkw)

    def plain():
        k, v = copies[next(turn) % len(copies)]
        return flash_decode_torch(q, k, v, pos, return_lse=lse, **dkw)
    return dict(ms=graph_ms(kernel, 50), plain_ms=graph_ms(plain, 10),
                bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, flops=flops)


def slot_range_rows(dev):
    """``flash_decode`` over a cache cut into M = 4 and 8 slot ranges, as
    a model axis of M ranks holds it where the kv heads do not divide M
    (``Partitioner.cache_spec``): each range with ``return_lse`` and its
    local count of valid slots (-1: none), against its plain version
    (the float32 partial by ``close_to_plain``, the lse within
    ``LSE_REL``, a range with no valid slot 0 and -inf), then the ranges
    merged (``merge_ranges``, float32, rank order) and rounded once,
    against the whole cache's kernel and its plain version by
    ``close_to_plain`` (2 bf16 ulps). Shapes: glm4-9b's decode heads,
    paligemma-3b's one kv head of 256, gemma2-2b's local ring past its
    window, a row whose every range but the first is empty. Numbers at
    the first (fullest) range: the lse variant's ms, its plain version's,
    its bound; the whole cache's default call beside it. Returns (the
    rows, the comparison launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (flash_decode_torch,
                                                  merge_ranges)
    rows, launches = [], 0
    for i, (name, (b, t, hq, hkv, d, ring, cap, pos)) in enumerate(
            SLOT_CASES.items()):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        q, kc, vc = (torch.randn(shape, generator=gen, device=dev)
                     .to(torch.bfloat16) for shape in
                     ((b, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        whole = ops.flash_decode(q, kc, vc, p, ring=ring, softcap=cap)
        plain = flash_decode_torch(q, kc, vc, p, ring=ring, softcap=cap)
        limit = torch.clamp(p + 1, max=t) if ring else p + 1
        for m in SLOT_SPLITS:
            tl = t // m
            parts, first, empty, err = [], None, 0, 0.0
            for r in range(m):
                sl = slice(r * tl, (r + 1) * tl)
                loc = (torch.clamp(limit - r * tl, 0, tl) - 1).to(torch.int32)
                args = (q, kc[:, sl].contiguous(), vc[:, sl].contiguous(),
                        loc)
                out, lse = ops.flash_decode(*args, softcap=cap,
                                            return_lse=True)
                launches += 1
                p_out, p_lse = flash_decode_torch(*args, softcap=cap,
                                                  return_lse=True)
                torch.cuda.synchronize()
                ok, e = close_to_plain(out, p_out)
                finite = torch.isfinite(p_lse)
                empty += int((~finite).sum())
                lse_ok = torch.equal(torch.isfinite(lse), finite) and (
                    not finite.any() or float(
                        (lse[finite] - p_lse[finite]).abs().max())
                    <= LSE_REL * max(1.0, float(p_lse[finite].abs().max())))
                zero = bool(finite.all()) or \
                    float(out[~finite].abs().max()) == 0.0
                if not (ok and lse_ok and zero):
                    fail(f"slot ranges {name} M={m} range {r}: off the "
                         f"plain version (out err {e:.3e}, lse ok {lse_ok}, "
                         f"empty rows zero {zero})")
                err = max(err, e)
                parts.append((out, lse))
                first = first or args
            merged = merge_ranges(*zip(*parts))[0].to(q.dtype)
            ok_p, err_p = close_to_plain(merged, plain)
            ok_w, err_w = close_to_plain(merged, whole)
            if not (ok_p and ok_w):
                fail(f"slot ranges {name} M={m}: merged off the whole cache "
                     f"(plain {gate_ratio(merged, plain):.2f}, kernel "
                     f"{gate_ratio(merged, whole):.2f} of the gate)")
            row = dict(name=f"{name} M={m}", shape=(
                f"q {tuple(q.shape)} cache {tuple(kc.shape)} in {m} ranges "
                f"of {tl} ring={ring} softcap={cap} pos={list(pos)}"),
                empty_range_rows=empty, max_abs_err=max(err, err_p),
                gate_vs_plain=gate_ratio(merged, plain),
                gate_vs_whole_kernel=gate_ratio(merged, whole),
                bit_equal_to_whole_kernel=bool(torch.equal(merged, whole)),
                **range_timing(*first, dict(softcap=cap), lse=True),
                library_ms=None)
            row["whole_ms"] = range_timing(
                q, kc, vc, p, dict(softcap=cap, ring=ring), lse=False)["ms"]
            rows.append(row)
            print("slot ranges " + json.dumps(row))
    return rows, launches


def tp_families_phase(dev):
    """Tensor parallelism of the SSM, MLA and MoE families (ROADMAP
    A13b4) on one card. (a) ``slot_range_rows``. (b) mamba2-780m whole in
    bf16: one ``make_train_step`` at B = 2 x 1,024 on one device, then the
    same weights kept by ``shard_params`` (``sharded_train_state``) on a
    one-rank NCCL (1, 1) mesh and one sharded step, counts zeroed just
    before and read just after: at one model rank every Mamba layer runs
    the one-device code (its heads whole), so the loss, the grad norm
    and every new parameter are bit for bit the one-device step's. (c)
    deepseek-v2-lite-16b whole in bf16 kept by ``shard_params`` on the
    (1, 1) mesh, capacity raised so nothing drops: run A's prompt through
    ``generate`` (the ``a2a`` prefill, the ``local`` decode, MLA's
    absorbed decode over its latent cut into one slot range and merged:
    new code at M = 1), counts zeroed just before and read just after;
    its teacher-forced logits against the one-device forward on the same
    routes (``recorded_routes``) within ``LOGIT_REL`` of the largest.
    Returns (the kernels' counts by run, their largest errors, the slot
    range rows, the comparison launches of (a))."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_torch
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_torch, rmsnorm_torch
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_torch,
                                              ssd_scan_torch)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import make_ctx, mesh_axes_for
    from repro_torch.launch.train import sharded_train_state
    from repro_torch.models import ShardCtx
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime import generate
    from repro_torch.runtime.train_loop import make_train_step
    from repro_torch.sharding import MeshAxes, Partitioner, shard_params

    t_phase = time.perf_counter()
    rows, cmp_launches = slot_range_rows(dev)
    keys = spy_train_keys()
    plains = {"rmsnorm": rmsnorm_torch, "flash_attention":
              flash_attention_torch, "rmsnorm_bwd": rmsnorm_bwd_torch,
              "ssd_scan": ssd_scan_torch, "ssd_scan_bwd": ssd_scan_bwd_torch}
    launches, errs = {}, {k: 0.0 for k in TP_FAMILY_KERNELS}
    cfg = ARCHS["mamba2-780m"].replace(dtype="bfloat16")
    opt = OptConfig()
    batch = TokenPipeline(cfg, PipelineConfig(
        batch=SSM_TRAIN["batch"], seq_len=SSM_TRAIN["seq"], seed=0),
        device=dev).make_batch(0)
    _, params = load_model("tp mamba2", cfg, dev)
    params.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(params, opt)}
    state, want = make_train_step(cfg, opt, ShardCtx(mode="train"), 1)(
        state, batch)
    host = {k: p.detach().to("cpu") for k, p in
            state["params"].named_parameters()}
    want = {k: float(v) for k, v in want.items()}
    del state, params
    freed("tp mamba2 one device")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        axes = mesh_axes_for(cfg, mesh)
        ctx = make_ctx(cfg, ShapeConfig("train", SSM_TRAIN["seq"],
                                        SSM_TRAIN["batch"], "train"),
                       mesh, axes)
        _, params = load_model("tp mamba2", cfg, dev)
        state, specs = sharded_train_state(params, opt, Partitioner(mesh,
                                                                    axes))
        step = make_train_step(cfg, opt, ctx, 1, *specs)
        counts = train_counts(cfg, 1)
        with contextlib.ExitStack() as stack:
            spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                     for k in ("rmsnorm", "rmsnorm_bwd", "ssd_scan",
                               "ssd_scan_bwd")}
            for sp in spies.values():
                sp.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, got = step(state, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            run = "tp_mamba2_mesh_step"
            launches[run] = {k: sp.launches for k, sp in spies.items()}
            if launches[run] != {k: counts[k] for k in spies}:
                fail(f"{run}: launches {launches[run]} != {counts}")
            got = {k: float(v) for k, v in got.items()}
            same = [k for k, p in state["params"].named_parameters()
                    if torch.equal(p.detach().cpu(), host[k])]
            print(f"tp mamba2-780m one step on the (1, 1) mesh "
                  f"(shard_params, fsdp={axes.fsdp}) vs one device: loss "
                  f"{got['loss']!r} / {want['loss']!r}, grad_norm "
                  f"{got['grad_norm']!r} / {want['grad_norm']!r}, "
                  f"parameters bit for bit {len(same)} of {len(host)}; "
                  f"step ms {step_ms:.2f} (a first step, not a timing)")
            if got["loss"] != want["loss"] or \
                    got["grad_norm"] != want["grad_norm"] or \
                    len(same) != len(host):
                fail(f"{run}: not the one-device step bit for bit")
            del state, params, host
            errs.update(hold_to_plain("tp mamba2 mesh step", spies, plains))
        freed("tp mamba2 mesh")

        full = ARCHS["deepseek-v2-lite-16b"].replace(dtype="bfloat16")
        nodrop = full.replace(capacity_factor=full.n_experts / full.top_k
                              * 1.01)
        gen, params = load_model("tp deepseek", nodrop, dev)
        shard_params(params, Partitioner(mesh, MeshAxes()))
        ctx = ShardCtx(mesh=mesh, dp_axes=("data",), model_axis="model")
        prompt = torch.randint(0, full.vocab, (RUN_A["batch"],
                                               RUN_A["prompt"]),
                               generator=gen, device=dev)
        norms = 2 + bool(full.kv_lora_rank)
        want_n = {"rmsnorm": TP_DECODE_GEN * (norms * full.n_layers + 1),
                  "flash_attention": full.n_layers}
        with contextlib.ExitStack() as stack:
            spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                     for k in ("rmsnorm", "flash_attention")}
            for sp in spies.values():
                sp.launches = 0
            decode_n = ops.flash_decode.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = generate(nodrop, ctx, params, {"tokens": prompt},
                            TP_DECODE_GEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = "tp_deepseek_mesh_A"
            launches[run] = {k: sp.launches for k, sp in spies.items()}
            print(f"tp deepseek-v2-lite-16b run A on the (1, 1) mesh "
                  f"(shard_params: a2a prefill, local decode, MLA over one "
                  f"slot range, {TP_DECODE_GEN} tokens): wall_s {wall:.3f} "
                  f"launches {launches[run]}")
            if launches[run] != want_n or \
                    ops.flash_decode.launches != decode_n or \
                    toks.shape != (RUN_A["batch"], TP_DECODE_GEN):
                fail(f"{run}: launches {launches[run]} != {want_n}, "
                     f"flash_decode moved, or tokens {tuple(toks.shape)}")
            errs.update({k: max(errs[k], v) for k, v in hold_to_plain(
                "tp deepseek", spies, plains).items()})
        with recorded_routes() as rk:
            kern = teacher_forced(nodrop, params, prompt, toks, ctx=ctx)
        with recorded_routes(forced=rk):
            one = teacher_forced(nodrop, params, prompt, toks)
        scale = float(one.abs().max())
        d_pre = float((kern[:, 0] - one[:, 0]).abs().max())
        d_dec = float((kern[:, 1:] - one[:, 1:]).abs().max())
        print(f"tp deepseek mesh vs one device on the same routes: max "
              f"|dlogit| prefill {d_pre:.4e}, decode {d_dec:.4e}, bound "
              f"{LOGIT_REL} x {scale:.4f}; top-1 agreement "
              f"{float((kern.argmax(-1) == one.argmax(-1)).float().mean()):.4f}")
        if not torch.isfinite(kern).all() or \
                not max(d_pre, d_dec) <= LOGIT_REL * scale:
            fail(f"tp deepseek: mesh logits off one device's by "
                 f"{max(d_pre, d_dec):.4e} > {LOGIT_REL * scale:.4e}")
        del params, kern, one
        freed("tp deepseek")
    finally:
        dist.destroy_process_group()
    print("tp families phase " + json.dumps(dict(
        seconds=time.perf_counter() - t_phase, mamba2_loss=got["loss"],
        mamba2_grad_norm=got["grad_norm"], deepseek_dlogit_prefill=d_pre,
        deepseek_dlogit_decode=d_dec, slot_range_launches=cmp_launches,
        launches=launches)))
    by_run = {k: {r: launches[r].get(k, 0) for r in launches}
              for k in TP_FAMILY_KERNELS}
    return by_run, errs, rows, cmp_launches


# ---------------------------------------------------------------------------
# phase 19: AMTHA places the port's own model stack
# ---------------------------------------------------------------------------

AUTOPLACE_KERNELS = ("rmsnorm", "flash_attention")
UNIT_ARCH, UNIT_SEQ, UNIT_REPS = "gemma2-2b", 1024, 20
PERMUTE_ARCH, PERMUTE_ROWS = "deepseek-v2-lite-16b", dict(batch=2, seq=256)
PERMUTE_F32_LAYERS = 4              # the dense layer and 3 MoE layers
PERMUTE_F32_REL = 1e-4              # float32: sums in another order
DRYRUN_CELL = ("gemma2-2b", "decode_32k")
ABSTRACT_ENTRIES = ("runtime.pipelined_forward", "autoplace.unit[gemma-2b]",
                    "autoplace.unit[gemma2-2b]")


def autoplace_phase(dev, trace_reports):
    """AMTHA places the port's own model stack (ROADMAP A13e-A13h) on one
    card. (a) ``autoplace.place`` of gemma2-2b on ``h100_node(1, 8)`` by
    the GA (its fitness on the card: ``sim_relax_pop``), the plan's
    report. (b) One gemma2-2b repeat unit (a local/global pair) at full
    width in bf16 on 1 x 1,024 tokens, forward only: the cost model's
    predicted time (``exec_times`` of ``unit_costs`` under both sources
    at the H100's datasheet rates) against the measured one (CUDA events,
    the median of ``UNIT_REPS`` calls after a warm-up), and %Dif_rel =
    (measured - predicted) / measured, the paper's Eq. 4, for each
    source: reported, not gated; where the measured time goes
    (``profile_step``: device busy ms, kernels and idle share a call);
    the unit's launches counted (zeroed just before one call, read just
    after) and its kernels held to their plain versions at the shapes it
    gave them. (c) deepseek-v2-lite-16b
    whole in bf16: one forward of ``PERMUTE_ROWS`` tokens with its routes
    recorded, every expert's routed load placed by ``place_moe_experts``
    on ``h100_node(1, 8)``, the permutation applied with
    ``permute_expert_params``; the permuted model's forward on the same
    routes (each expert id mapped to its new position) against the
    unpermuted logits: bit for bit or not (printed), within
    ``LOGIT_REL`` of the largest logit (gated: the dense dispatch's
    combine and the router's softmax sum the experts in index order,
    which the permutation changes, and bf16 rounding carries that
    through 27 layers); then the same at full width in float32 cut to
    ``PERMUTE_F32_LAYERS`` layers, within ``PERMUTE_F32_REL``; launches
    counted and kernels held to their plain versions as in (b). (d) ``dryrun`` of
    one cell on the 16 x 16 mesh (a fake world of 256 on the host), its
    record and host seconds. (e) The three abstract trace-check entries
    of phase 11's run on the card: clean, FLOPs and bytes within their
    bounds, nothing launched. Returns (the kernels' counts by run, their
    largest errors, the GA's ``sim_relax_pop`` launches)."""
    import torch

    from repro_torch import autoplace
    from repro_torch.autoplace.costs import unit_call
    from repro_torch.configs import ARCHS
    from repro_torch.core.machine import h100_node
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import ShardCtx, forward
    from repro_torch.models.model import DTYPES
    from repro_torch.sharding.partition import permute_expert_params

    t_phase = time.perf_counter()
    keys, plains = spy_keys(), plain_versions()
    stress = stress_cases(torch.Generator(device=dev).manual_seed(19), dev)
    launches, errs = {}, {k: 0.0 for k in AUTOPLACE_KERNELS}

    def counted(run, fn):
        for k in AUTOPLACE_KERNELS:
            getattr(ops, k).launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches[run] = {k: getattr(ops, k).launches
                         for k in AUTOPLACE_KERNELS}
        return out

    # (a) the GA places gemma2-2b's pipeline on one H100 node
    ops.sim_relax_pop.launches = 0
    t0 = time.perf_counter()
    plan = autoplace.place(UNIT_ARCH, scheduler="ga", machine=h100_node(1, 8))
    ga_s = time.perf_counter() - t0
    ga_launches = ops.sim_relax_pop.launches
    report = plan.report()
    print("autoplace plan " + json.dumps(dict(report, host_s=ga_s,
                                              sim_relax_pop=ga_launches)))
    if plan.t_autoplaced > plan.t_heuristic or ga_launches == 0:
        fail(f"autoplace: plan {report}, GA launches {ga_launches}")

    # (b) one repeat unit: the cost model against the card
    cfg = ARCHS[UNIT_ARCH]
    _, _, unit, _ = cfg.repeat_structure()
    gen = torch.Generator(device=dev).manual_seed(0)
    fn, layers = unit_call(cfg, unit, gen, dev)
    with torch.no_grad():
        for layer in layers:
            redraw(layer, gen, dev)
        x = torch.randn((1, UNIT_SEQ, cfg.d_model), generator=gen,
                        device=dev).to(DTYPES[cfg.dtype])
        for _ in range(3):
            fn(layers, x)
        with contextlib.ExitStack() as stack:
            spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                     for k in AUTOPLACE_KERNELS}
            y = counted("autoplace_unit", lambda: fn(layers, x))
        norms = 2 + 2 * cfg.post_block_norms + 2 * cfg.qk_norm
        want = {"rmsnorm": norms * len(unit), "flash_attention": len(unit)}
        if launches["autoplace_unit"] != want:
            fail(f"autoplace unit launches {launches['autoplace_unit']}, "
                 f"expected {want}")
        if not torch.isfinite(y).all() or y.shape != x.shape:
            fail(f"autoplace unit: output {tuple(y.shape)} not finite")
        for k, e in check_against_plain("autoplace unit", spies, plains,
                                        stress, ops).items():
            errs[k] = max(errs[k], e)
        times = []
        for _ in range(UNIT_REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(layers, x)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        where = profile_step(lambda: fn(layers, x), {})
    measured = sorted(times)[len(times) // 2]
    node = h100_node(1, 1)
    unit_row = dict(arch=UNIT_ARCH, unit=unit, tokens=UNIT_SEQ,
                    measured_ms=measured, measured_min_ms=min(times),
                    measured_max_ms=max(times), reps=UNIT_REPS,
                    launches=launches["autoplace_unit"], profile=where)
    for source in ("analytic", "counted"):
        c = autoplace.unit_costs(cfg, seq=UNIT_SEQ, source=source)
        pred = autoplace.exec_times(c.flops, c.hbm_bytes, node)[0] * 1e3
        unit_row[source] = dict(
            flops=c.flops, hbm_bytes=c.hbm_bytes, predicted_ms=pred,
            dif_rel_pct=100.0 * (measured - pred) / measured)
    print("autoplace unit " + json.dumps(unit_row))
    del layers, x, y, spies
    freed("autoplace unit")

    # (c) expert placement from routes on the card, applied to the weights
    def permuted(run, cfg, rel):
        label = run.replace("_", " ")
        gen, params = load_model(label, cfg, dev)
        tokens = torch.randint(0, cfg.vocab, (PERMUTE_ROWS["batch"],
                                              PERMUTE_ROWS["seq"]),
                               generator=gen, device=dev)
        ctx = ShardCtx(mode="train")
        with torch.no_grad(), contextlib.ExitStack() as stack:
            spies = {k: stack.enter_context(Spy(ops, k, *keys[k]))
                     for k in AUTOPLACE_KERNELS}
            with recorded_routes() as routes:
                before = counted(run, lambda: forward(
                    params, {"tokens": tokens}, cfg, ctx)[0])
            loads = torch.bincount(torch.cat([r.reshape(-1)
                                              for r in routes]),
                                   minlength=cfg.n_experts).cpu().tolist()
            t0 = time.perf_counter()
            eplan = autoplace.place_moe_experts(
                cfg, [float(v) for v in loads], n_devices=EP_GPUS)
            place_s = time.perf_counter() - t0
            permute_expert_params(params, eplan.permutation)
            new_at = torch.empty(cfg.n_experts, dtype=torch.long,
                                 device=dev)
            new_at[torch.tensor(eplan.permutation, device=dev)] = \
                torch.arange(cfg.n_experts, device=dev)
            with recorded_routes(forced=[new_at[r] for r in routes]):
                after = forward(params, {"tokens": tokens}, cfg, ctx)[0]
            torch.cuda.synchronize()
            for k, e in check_against_plain(label, spies, plains, stress,
                                            ops).items():
                errs[k] = max(errs[k], e)
        scale = float(before.float().abs().max())
        d = float((after.float() - before.float()).abs().max())
        row = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype,
                   tokens=list(tokens.shape), expert_tokens_max=max(loads),
                   expert_tokens_min=min(loads), place_s=place_s,
                   t_autoplaced=eplan.t_autoplaced,
                   t_roundrobin=eplan.t_roundrobin, gain_pct=eplan.gain_pct,
                   identity=eplan.permutation == list(range(cfg.n_experts)),
                   bit_for_bit=bool(torch.equal(after, before)),
                   max_dlogit=d, bound=rel * scale, max_logit=scale,
                   launches=launches[run])
        print("autoplace experts " + json.dumps(row))
        if not torch.isfinite(after).all() or not d <= rel * scale:
            fail(f"{label}: permuted logits off by {d:.4e} > "
                 f"{rel * scale:.4e}")
        if sorted(eplan.permutation) != list(range(cfg.n_experts)) or \
                not all(launches[run].values()):
            fail(f"{label}: {row}")
        del params, before, after, spies
        freed(label)
        return row

    full = ARCHS[PERMUTE_ARCH]
    perm_rows = [permuted("autoplace_deepseek", full, LOGIT_REL),
                 permuted("autoplace_deepseek_f32", full.replace(
                     dtype="float32", n_layers=PERMUTE_F32_LAYERS),
                     PERMUTE_F32_REL)]

    # (d) one dry-run cell on the 16 x 16 mesh, on the host
    t0 = time.perf_counter()
    rec = dryrun.run_cell(*DRYRUN_CELL, multi_pod=False, out_dir=None)
    dry_s = time.perf_counter() - t0
    dry_row = dict(cell=list(DRYRUN_CELL), mesh=rec["mesh"], host_s=dry_s,
                   roofline_seconds=rec["roofline_seconds"],
                   dominant=rec["dominant"],
                   flops_per_device=rec["flops_per_device"],
                   bytes_per_device=rec["bytes_per_device"],
                   collective_by_axis=rec["collective_by_axis"],
                   memory_analysis=rec["memory_analysis"])
    print("autoplace dryrun " + json.dumps(dry_row))
    if not rec["flops_per_device"] > 0 or rec["n_chips"] != 256:
        fail(f"dryrun: {dry_row}")

    # (e) the abstract trace-check entries of phase 11's run
    by = {r.entry: r for r in trace_reports}
    trace_rows = {}
    for name in ABSTRACT_ENTRIES:
        r = by.get(name)
        if r is None or not r.ok or not r.abstract or r.launches:
            fail(f"tracecheck {name}: {r and r.row()}")
        trace_rows[name] = {k: r.cost[k] for k in
                            ("flops_ratio", "flops_bounds", "bytes_ratio",
                             "bytes_bounds")}
    print("autoplace phase " + json.dumps(dict(
        seconds=time.perf_counter() - t_phase, plan=report, unit=unit_row,
        experts=perm_rows, dryrun_host_s=dry_s, tracecheck=trace_rows,
        launches=launches, ga_sim_relax_pop=ga_launches)))
    by_run = {k: {r: launches[r][k] for r in launches}
              for k in AUTOPLACE_KERNELS}
    return by_run, errs, ga_launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this script measures the port on a GPU)")
    import numpy as np

    from repro_torch.core import (SynthParams, batch_scenarios,
                                  cluster_of_multicores, generate_app,
                                  get_scheduler, hp_bl260c, lower_scenario,
                                  paper_suite_64core, simulate_suite)
    from repro_torch.core import lowering, sim_engine
    from repro_torch.core.sim_engine import (_jitter_durations,
                                             _pop_gather_inputs,
                                             simulate_batch)
    from repro_torch.faults import random_script
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.sched_score import (sched_score_torch,
                                                 vector_path)
    from repro_torch.kernels.sim_step import (sim_relax_pop_cuda,
                                              sim_relax_pop_torch)
    from repro_torch.online import (ArrivalParams, BatchedPolicy,
                                    OnlineAMTHA, RecoveryParams, evaluate,
                                    generate_workload, make_policy,
                                    recover_from_script)
    from repro_torch.search import GAParams, ga, local

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {len(built)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    for k in built.values():
        for line in k.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.name}: {line.strip()}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(k.path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        print(f"  {k.name}: {sass.count('HGMMA')} HGMMA instructions in "
              f"the SASS (cuobjdump -sass)")

    # -- 2. main path ---------------------------------------------------
    suites = [
        ("64core", hp_bl260c(), paper_suite_64core(n_apps=10, seed=100)),
        ("256core", cluster_of_multicores(32),
         [generate_app(SynthParams(n_tasks=(240, 280)), seed=300 + i)
          for i in range(4)]),
    ]
    counters = {"sim_relax_pop": ops.sim_relax_pop,
                "sched_score": ops.sched_score}
    for fn in counters.values():
        fn.launches = 0
    mapper = get_scheduler("engine")
    runs = []
    for name, machine, graphs in suites:
        t0 = time.perf_counter()
        schedules = [mapper(g, machine) for g in graphs]
        map_s = time.perf_counter() - t0
        for tag, jitter, draws in (("plain", 0.0, 1),
                                   ("jitter", JITTER, DRAWS)):
            gs, ss = graphs * draws, schedules * draws
            seeds = list(range(len(gs)))
            t0 = time.perf_counter()
            res = simulate_suite(gs, machine, ss, jitter=jitter, seeds=seeds,
                                 backend="cuda", device=dev)
            runs.append(dict(name=f"{name}-{tag}", machine=machine,
                             graphs=gs, schedules=ss, jitter=jitter,
                             seeds=seeds, res=res, map_s=map_s,
                             suite_s=time.perf_counter() - t0))
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"offline path launches: {launches}")
    if launches["sim_relax_pop"] == 0:
        fail("kernel sim_relax_pop was never launched on the offline path")

    # -- 3. checks ------------------------------------------------------
    for r in runs:
        res = r["res"]
        ref = simulate_suite(r["graphs"], r["machine"], r["schedules"],
                             jitter=r["jitter"], seeds=r["seeds"],
                             backend="numpy")
        if res.subtask_end.shape != ref.subtask_end.shape:
            fail(f"{r['name']}: shape {res.subtask_end.shape} != "
                 f"{ref.subtask_end.shape}")
        if not np.isfinite(res.subtask_end).all():
            fail(f"{r['name']}: non-finite finish times")
        err = np.abs(res.subtask_end - ref.subtask_end) \
            / np.maximum(np.abs(ref.subtask_end), 1e-30)
        if not np.allclose(res.subtask_end, ref.subtask_end, rtol=RTOL_F32,
                           atol=0.0):
            fail(f"{r['name']}: cuda vs float64 rel err {err.max():.3e} "
                 f"> {RTOL_F32}")
        dif = res.dif_rel()
        if r["jitter"] == 0.0 and np.abs(dif).max() > 100 * RTOL_F32:
            fail(f"{r['name']}: T_exec != T_est without jitter "
                 f"(max |dif_rel| {np.abs(dif).max():.3e}%)")
        b, s = res.subtask_end.shape
        print(f"{r['name']}: machine={r['machine'].name!r} B={b} S={s} "
              f"dif_rel mean={dif.mean():.4f}% max={dif.max():.4f}% "
              f"rel_err_vs_f64={err.max():.3e} map_s={r['map_s']:.3f} "
              f"simulate_suite_s={r['suite_s']:.3f}")

    # -- 4. kernel vs plain, timings, bound, host breakdown -------------
    kernel_rows, breakdowns = [], []
    for r in runs:
        scen = [lower_scenario(g, r["machine"], sc)
                for g, sc in zip(r["graphs"], r["schedules"])]
        batch = batch_scenarios(scen)
        dur = _jitter_durations(batch, r["jitter"], r["seeds"])
        pred, lat, volbw = _pop_gather_inputs(batch)
        args = [torch.from_numpy(x).to(dev) for x in
                (pred, lat, volbw, dur.astype(np.float32),
                 batch.release.astype(np.float32))]
        steps, s = batch.depth, batch.max_subtasks
        row = sim_row(r["name"], args, steps, ops, sim_relax_pop_cuda,
                      sim_relax_pop_torch)
        kernel_rows.append(row)
        print("sim_relax_pop " + json.dumps(row))

        # host-side breakdown of one simulate_batch call on a fresh batch
        times = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate_batch(batch_scenarios(scen), jitter=r["jitter"],
                       seeds=r["seeds"], backend="cuda", device=dev)
        torch.cuda.synchronize()
        times["simulate_batch_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        fresh = batch_scenarios(scen)
        times["batch_scenarios_s"] = time.perf_counter() - t
        t = time.perf_counter()
        dur = _jitter_durations(fresh, r["jitter"], r["seeds"])
        times["jitter_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host = _pop_gather_inputs(fresh)
        times["gather_inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        host = host + (dur.astype(np.float32),
                       fresh.release.astype(np.float32))
        times["cast_s"] = time.perf_counter() - t
        t = time.perf_counter()
        dargs = [torch.from_numpy(x).to(dev) for x in host]
        torch.cuda.synchronize()
        times["upload_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ops.check_gather_bounds("pred", dargs[0], s)
        times["bounds_check_s"] = time.perf_counter() - t
        t = time.perf_counter()
        end = sim_relax_pop_cuda(*dargs, n_steps=steps)
        torch.cuda.synchronize()
        times["kernel_s"] = time.perf_counter() - t
        t = time.perf_counter()
        np.where(fresh.valid, end.cpu().numpy().astype(np.float64), 0.0)
        times["download_mask_s"] = time.perf_counter() - t
        breakdowns.append(dict(name=r["name"], **times))
        print("breakdown " + json.dumps(breakdowns[-1]))

    # -- 5. online admission + fault recovery at 256 cores --------------
    machine = cluster_of_multicores(n_blades=ONLINE_BLADES)
    n_cores = machine.n_cores
    workload = generate_workload(
        ArrivalParams(rate=0.9 * n_cores / MEAN_APP_WORK_S,
                      process="bursty"), n_apps=ONLINE_APPS, seed=3)
    n_sub = sum(a.graph.n_subtasks for a in workload)
    ga_params = GAParams(pop_size=16, generations=10, refine_rounds=2,
                         refine_moves=32, backend="cuda")
    wall = {}
    for fn in counters.values():
        fn.launches = 0
    # host wall seconds of the phase's layers (see PERF.md section 5)
    timers = {"admit": (OnlineAMTHA, "admit"),
              "kernel_scores": (BatchedPolicy, "kernel_scores"),
              "ga_decode": (ga, "decode_population"),
              "hill_decode": (local, "decode_population"),
              "lower_population": (lowering, "lower_population"),
              "relax_upload_kernel_download": (sim_engine, "_relax_pop"),
              "simulate_batch_ga": (ga, "batch_fitness"),
              "simulate_batch_hill": (local, "batch_fitness")}
    with contextlib.ExitStack() as stack:
        timed = {k: stack.enter_context(Timed(*v))
                 for k, v in timers.items()}
        score_calls = stack.enter_context(Timed(
            BatchedPolicy, "order_batch",
            keep=lambda pol, batch, eng, now: (pol, list(batch),
                                               FrozenEngine(eng), now)))
        score_spy = stack.enter_context(Spy(ops, "sched_score", shapes))
        relax_spy = stack.enter_context(Spy(ops, "sim_relax_pop", shapes))
        fit_spy = stack.enter_context(
            Spy(ga, "population_fitness", lambda args: "first"))
        t0 = time.perf_counter()
        state = make_policy("batched", k=ONLINE_K, scorer="kernel",
                            device=dev).run(machine, workload)
        torch.cuda.synchronize()
        wall["admission_s"] = time.perf_counter() - t0
        state.validate()
        admitted = placements(state.schedule)
        t0 = time.perf_counter()
        healthy = evaluate(state, contention=True)
        wall["evaluate_s"] = time.perf_counter() - t0
        makespan = state.schedule.makespan()
        script = random_script(n_cores, seed=5, horizon=makespan, n_fail=1,
                               n_slow=1, n_degrade=1, protect=(0,),
                               t_window=(0.2, 0.4))
        engine = OnlineAMTHA(machine)
        engine.state = state
        refined = []                # refine_ga's (greedy, refined) makespans
        refine_ga = engine.refine_ga

        def recorded_refine(**kw):
            t = time.perf_counter()
            refined.append(refine_ga(**kw))
            wall["recovery_ga_s"] = time.perf_counter() - t
            return refined[-1]
        engine.refine_ga = recorded_refine
        t0 = time.perf_counter()
        report = recover_from_script(
            engine, script, 0.5 * makespan,
            RecoveryParams(ga_refine=True, ga_params=ga_params))
        torch.cuda.synchronize()
        wall["recovery_s"] = time.perf_counter() - t0
        engine.state.validate()
        t0 = time.perf_counter()
        faulty = evaluate(engine.state, faults=script)
        wall["evaluate_faults_s"] = time.perf_counter() - t0
    online_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"online path launches: {online_launches}")
    print("online breakdown " + json.dumps(
        {k: dict(s=t.seconds, calls=t.calls) for k, t in timed.items()}))
    for k, n in online_launches.items():
        if n == 0:
            fail(f"kernel {k} was never launched on the online path")
    print(f"online: cores={n_cores} apps={len(workload)} subtasks={n_sub} "
          f"makespan={makespan!r} " + json.dumps(wall))
    print("online metrics " + json.dumps(healthy.row()))
    print("online metrics under faults " + json.dumps(faulty.row()))
    rep = {k: v for k, v in vars(report).items() if k != "notes"}
    rep["notes"] = report.notes
    print("recovery report " + json.dumps(rep))
    for name, met in (("healthy", healthy), ("faults", faulty)):
        if met.n_apps != len(workload) or not np.isfinite(met.span):
            fail(f"online metrics ({name}) malformed: {met.row()}")
    # losing a core may lengthen the plan; the GA pass must not
    if len(refined) != 1:
        fail(f"recovery ran the GA refinement {len(refined)} times, not once")
    greedy_ms, refined_ms = refined[0]
    print(f"recovery makespans: before faults {report.old_makespan!r}, "
          f"greedy re-map {greedy_ms!r}, after GA {refined_ms!r}")
    if not refined_ms <= greedy_ms or report.new_makespan != refined_ms:
        fail(f"GA-refined makespan {refined_ms!r} exceeds the recovered "
             f"{greedy_ms!r}")
    if report.n_rolled_back == 0:
        fail("the fault script rolled nothing back: recovery not exercised")

    # the same admission on the plain version gives the same timeline
    plain_state = make_policy("batched", k=ONLINE_K, scorer="kernel",
                              device="cpu").run(machine, workload)
    if placements(plain_state.schedule) != admitted:
        fail("kernel-scored admission on the card places differently from "
             "the plain version")
    print(f"admission: {len(admitted)} placements equal to device='cpu'")

    # sched_score against its plain version: the path's shapes, a ragged
    # stress shape, +-inf, and NaN propagated at the same places
    rng = np.random.default_rng(0)

    def score_args(a, c, special):
        d = rng.uniform(0.0, 500.0, (a, c)).astype(np.float32)
        f = rng.uniform(0.0, 1e3, c).astype(np.float32)
        r = rng.uniform(0.0, 1e3, a).astype(np.float32)
        if special:                 # +-inf that sum to no NaN
            f[rng.random(c) < 0.1] = np.inf
            r[rng.random(a) < 0.1] = -np.inf
            d[rng.random((a, c)) < 0.02] = np.inf
        if special == "nan":        # NaN in, and inf + -inf
            f[rng.random(c) < 0.05] = np.nan
            d[rng.random((a, c)) < 0.02] = np.nan
            d[rng.random((a, c)) < 0.02] = -np.inf
        return [torch.from_numpy(x).to(dev) for x in (d, f, r)]

    cases = [(f"path{k}", args) for k, (args, _) in score_spy.calls.items()]
    cases += [("stress(1000, 777)", score_args(1000, 777, False)),
              ("inf(1000, 777)", score_args(1000, 777, True)),
              ("nan(1000, 777)", score_args(1000, 777, "nan"))]
    score_err = 0.0
    for name, args in cases:
        got = ops.sched_score(*args)
        fused, mins = ops.sched_score(*args, row_min=True)
        want, want_min = sched_score_torch(*args, row_min=True)
        torch.cuda.synchronize()
        if not (same_scores(got, want) and same_scores(fused, want)):
            fail(f"sched_score {name}: kernel != plain version")
        if not same_scores(mins, want_min):
            fail(f"sched_score {name}: row minima != the plain version's")
        vec = vector_path(args[0], args[1], fused)
        if vec != (args[0].shape[1] % 4 == 0):
            fail(f"sched_score {name}: 16-byte path {vec} at C="
                 f"{args[0].shape[1]}")
        if name.startswith("nan"):
            if not torch.isnan(want_min).any():
                fail("sched_score: the NaN stress has no NaN minimum")
            continue
        score_err = max(score_err, (got - want).abs().max().item(),
                        (mins - want_min).abs().max().item())
    score_rows = []
    for (dshape, _, _), (args, _) in score_spy.calls.items():
        score_rows.append(score_row(args))
        print("sched_score " + json.dumps(score_rows[-1]))
    # admission's host time per batch (4 batches of 16 apps), replayed on
    # the frozen inputs of each batch
    calls = [c for c in score_calls.kept if c[0].scorer == "kernel"]
    host_ms = kernel_scores_host_ms(calls)
    print("kernel_scores host ms per batch after drain_matrix "
          + json.dumps(host_ms))
    for row in score_rows:
        row["kernel_scores_host_ms"] = host_ms

    # sim_relax_pop at the GA's merged-cluster shapes
    for (pshape, *_), (args, kwargs) in relax_spy.calls.items():
        b, s, p1 = pshape
        row = sim_row(f"ga({b}, {s}, {p1})", args, kwargs["n_steps"], ops,
                      sim_relax_pop_cuda, sim_relax_pop_torch)
        kernel_rows.append(row)
        print("sim_relax_pop " + json.dumps(row))

    # the GA's first population: card fitness vs float64
    (graph, mach, pop), kw = fit_spy.calls["first"]
    kw = {k: v for k, v in kw.items() if k != "backend"}
    f_card = ga.population_fitness(graph, mach, pop, backend="cuda", **kw)
    f_f64 = ga.population_fitness(graph, mach, pop, backend="numpy", **kw)
    fit_err = float(np.max(np.abs(f_card - f_f64) / np.abs(f_f64)))
    if not np.allclose(f_card, f_f64, rtol=RTOL_F32, atol=0.0):
        fail(f"GA fitness on the card vs float64: rel err {fit_err:.3e}")
    print(f"ga first population: B={len(pop)} subtasks={graph.n_subtasks} "
          f"fitness rel err vs f64 {fit_err:.3e}")

    dense_entry = dense_phase(dev, runs)
    gc.collect()
    torch.cuda.empty_cache()
    ga_launches, ga_rows = device_ga_phase(dev)
    kernel_rows.extend(ga_rows)
    verify_launches = verify_phase(dev, runs)

    serve_rows = serve_phase(dev)
    gc.collect()                    # gemma2's weights go before the next
    torch.cuda.empty_cache()
    ssd_entry, ssm_launches, ssm_err = ssm_phase(dev)
    for row in serve_rows:
        name = row["name"]
        row["launches"] += sum(ssm_launches[name].values())
        row["launches_by_path"].update(ssm_launches[name])
        row["max_abs_err"] = max(row["max_abs_err"], ssm_err[name])

    trace_reports = analysis_phase(dev)
    paper_launches = paper_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches, moe_err = moe_phase(dev)
    for row in serve_rows:
        name = row["name"]
        row["launches"] += sum(moe_launches[name].values())
        row["launches_by_path"].update(moe_launches[name])
        row["max_abs_err"] = max(row["max_abs_err"], moe_err[name])
    gc.collect()
    torch.cuda.empty_cache()
    fe_launches, fe_err, fe_rows = frontend_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_entries, train_fwd, train_err, train_rows = train_phase(dev)
    ssd_entry["launches"] += sum(train_fwd["ssd_scan"].values())
    ssd_entry["launches_by_path"].update(train_fwd["ssd_scan"])
    ssd_entry["max_abs_err"] = max(ssd_entry["max_abs_err"],
                                   train_err["ssd_scan"])
    for row in serve_rows:
        name = row["name"]
        row["launches"] += sum(fe_launches[name].values())
        row["launches_by_path"].update(fe_launches[name])
        row["max_abs_err"] = max(row["max_abs_err"], fe_err[name])
        if name in train_fwd:
            row["launches"] += sum(train_fwd[name].values())
            row["launches_by_path"].update(train_fwd[name])
            row["max_abs_err"] = max(row["max_abs_err"], train_err[name])
        if name == "flash_attention":
            row["prefix_row"], row["bidirectional_row"] = (
                {k: v for k, v in fe_rows[r].items() if k != "args"}
                for r in ("prefix", "bidirectional"))
            row["mla_train_rows"] = train_rows["flash_attention"]
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, mesh_err = mesh_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches, tp_err, tp_rows = tp_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    fam_launches, fam_err, slot_rows, slot_launches = tp_families_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    auto_launches, auto_err, auto_ga = autoplace_phase(dev, trace_reports)
    for row in serve_rows + train_entries + [ssd_entry]:
        name = row["name"]
        if name == "flash_decode":
            row["slot_range_rows"] = slot_rows
            row["slot_range_comparison_launches"] = slot_launches
            row["max_abs_err"] = max(row["max_abs_err"], max(
                r["max_abs_err"] for r in slot_rows))
        for by_run, err in ((mesh_launches, mesh_err), (tp_launches, tp_err),
                            (fam_launches, fam_err),
                            (auto_launches, auto_err)):
            if name in by_run:
                row["launches"] += sum(by_run[name].values())
                row["launches_by_path"].update(by_run[name])
                row["max_abs_err"] = max(row["max_abs_err"], err[name])
        if name in ("flash_attention", "flash_attention_bwd"):
            pre = "fwd" if name == "flash_attention" else "bwd"
            row["offset_rows"] = [dict(
                name=r["name"], chunk=r["chunk"],
                bit_equal_to_whole=r["bit_equal_to_whole"],
                ms=r[f"{pre}_ms"], plain_ms=r[f"{pre}_plain_ms"],
                bound_ms=r[f"{pre}_bound_ms"], bound_by=r[f"{pre}_bound_by"],
                library_ms=r[f"{pre}_library_ms"],
                **({"summed_dk_dv": r["summed_dk_dv"]} if pre == "bwd"
                   else {})) for r in tp_rows]

    # the device GA's largest shape: where the path spends its launches
    main_row = max((r for r in kernel_rows
                    if r["name"].startswith("device-ga")),
                   key=lambda x: x["bytes"])
    main_score = max(score_rows, key=lambda x: x["bytes"])
    print(json.dumps({"kernels": [dict(
        name="sim_relax_pop", route="cuda",
        source="src/repro_torch/kernels/csrc/sim_relax_pop.cu",
        replaces="src/repro/kernels/sim_step.py:184",
        launches=launches["sim_relax_pop"]
        + online_launches["sim_relax_pop"] + ga_launches + verify_launches
        + paper_launches + auto_ga,
        launches_by_path={"offline": launches["sim_relax_pop"],
                          "online": online_launches["sim_relax_pop"],
                          "device_ga": ga_launches,
                          "verify": verify_launches,
                          "paper": paper_launches,
                          "autoplace_ga": auto_ga},
        max_abs_err=max(x["max_abs_err"] for x in kernel_rows),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None, shape=main_row["name"], k=main_row["k"],
        variant=main_row["variant"], sweeps_max=main_row["sweeps_max"],
        sweeps_median=main_row["sweeps_median"],
        n_steps=main_row["depth"]), dict(
        name="sched_score", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_score.cu",
        replaces="src/repro/kernels/sched_score.py:47",
        launches=online_launches["sched_score"],
        launches_by_path={"offline": launches["sched_score"],
                          "online": online_launches["sched_score"]},
        max_abs_err=score_err, ms=main_score["ms"],
        plain_ms=main_score["plain_ms"], bound_ms=main_score["bound_ms"],
        bound_by=main_score["bound_by"], library_ms=None,
        shape=main_score["name"], floor_ms=main_score["floor_ms"],
        eager_ms=main_score["eager_ms"],
        kernel_scores_host_ms=main_score["kernel_scores_host_ms"]),
        dense_entry] + serve_rows
        + [ssd_entry] + train_entries}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
