#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (src/repro_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any mismatch:

  1. device: the card's name and count, and nvidia-smi's name/power limit;
  2. build: the kernels from src/repro_torch/kernels/csrc with nvcc for
     sm_90a, printing ptxas's registers and spills;
  3. kernels: every kernel in every variant against its plain PyTorch
     version on the card, at ragged shapes (and #1 at the tree engine's
     narrow leaf widths D 1, 3, 80, 5121) and at the main path's shape
     (n = 8 agents, D = 156,519,168: the tiny LM's flat buffer), with the
     kernel, plain-version and library times (CUDA events) at full shape,
     each library call's output first held to the plain version's (the
     same tolerance; a call that computes another function is struck and
     its library_ms reported as null), and the mixes' times beside one
     copy of the same bytes (copy_ms: the card's stream rate);
     then the batched kernels #5–#8 of the sweep lattice the same way, at
     ragged (R, n, D) and at R = 2, n = 8, D = 156,519,168, and each run's
     slice against the single-run kernel on that slice (to 0.0); then
     (3d) #1 and #5 at the sharded engine's own-block shapes (a strided
     block of W: #1 at n_local 4, 2 and 1, #5 at R 2 and n_local 4 and 2,
     D = 156,519,168), timed beside their bounds; (3e) #1 at the 2-D
     engine's column blocks (the whole (8, 8) W on x (8, D/2), and a
     strided (4, 4) block of it on x (4, D/2), at phase 4h's D/2 =
     29,590,656 and the full depth's 78,259,584), likewise; (3f) #1 and
     #2 at the tensor-parallel tree's leaf blocks of phase 4i's (p1):
     Qwen1.5-4B's embed.table block (2, 194,478,080) and a norm's (2,
     2,560), likewise; then the compressed-gossip kernels #9, #11, #13, #14 at the ragged shapes and
     at full shape, y within 1e-5·max|y| and the residual r (#9, #11) and
     the int8 payload q (#13) equal to the plain version's (0.0); then the
     batched EF kernels #10/#12 of the compressed lattice at ragged
     lattices (R = 1 and 3, n not a multiple of 8, D ≡ 1, 2, 3 mod 4, a
     misaligned buffer) and at R = 2, n = 8, D = 156,519,168, y within
     1e-5·max|y|, r exact, and each run's slice equal to #9/#11 on it;
     then every mix kernel #1-#14 on float64 buffers (the reference's
     kernels load and store f64 and mix in f32; so do these) at n = 8
     (D ≡ 0 and 3 mod 4) and n = 13, y within 1e-5·max|y|, m', r and q
     exact, run slices equal to the single-run kernels;
     then (3c) every mix kernel #1-#14 in every variant on bfloat16
     buffers (W, η, the momentum, noise and scales f32) at n = 8 (D ≡ 0
     and 3 mod 4, and at a base one element past an 8-byte boundary),
     n = 13 and lattices of R = 1 and 3, y within 2^-7·max|y| of the
     plain version (2^-6 for the EF kernels #9-#12, which round the mix
     before the correction), m' within 1e-5·max|m'|, r and q exact, run
     slices equal to the single-run kernels (0.0); then at full shape
     (n = 8, D = 156,519,168; R = 2 for the batched ones), timed against
     the bf16 bound, the plain version and one copy of the same bytes;
     then the model zoo's prefill kernels #15 flash attention, #16 the
     SSD scan and #17 the RG-LRU scan at edge shapes (S off the tiles, W
     not a multiple of 4, hd 64/128/256, windows 0, 64 and off the key
     tile, GQA and MQA, f32 and bf16)
     and at their models' shapes (#15 at the tiny LM's B 2, S 1024, H 12,
     KV 6, hd 64, f32, RecurrentGemma-9B's B 1, S 4096, H 16, KV 1,
     hd 256, window 2048, bf16, Qwen1.5-4B's B 1, S 4096, H 20, KV 20,
     hd 128, bf16, Gemma3-12B's B 1, S 4096, H 16, KV 8, hd 256, bf16 at
     window 1024 (its local layers) and 0 (its global ones),
     Nemotron-4-15B's B 1, S 4096, H 48, KV 8, hd 128, bf16, causal,
     Qwen2-VL-2B's B 1, S 4096, H 12, KV 2, hd 128, bf16, causal and
     SeamlessM4T-Large-v2's decoder self-attention, B 1, S 4096, H 16,
     KV 16, hd 64, bf16, causal; #16
     at Mamba2-2.7B's B 1, S 4096, H 80,
     P 64, N 128, bf16; #17 at RecurrentGemma-9B's B 1, S 4096, W 4096),
     within 1e-5·max|y| in f32 and 1e-2·max|y| in bf16, #17's h_last
     equal to h[:, -1] and h to the plain version's (0.0); timed at the
     models' shapes beside the plain version and, for #15,
     F.scaled_dot_product_attention, #16's three passes profiled; #15's P
     check: on inputs whose windows cancel, a one-product bf16 P errs past
     1e-2·max|y| and the kernel (P_hi·V + P_lo·V) must not; and #16's
     accuracy check: at A = -77..-80 (f32, S 512) the kernel within
     1e-6·max|y| of an f64 recurrence on the card, the cum-difference
     chunked form (models/ssm.py:ssd_chunked) at least 10× further off;
  4. training: the full-size tiny LM, 8 agents, ring2, H = 5, K = 2,
     batch 2, seq 128, 5 steps (TRAIN_STEPS), on paths (a) --gossip-impl
     pallas,
     (b) sparse, (c) pallas --fuse-update-mix --optimizer momentum,
     (d) sparse --fuse-update-mix; each must keep its loss finite and
     launch its kernel once per step (line 4 rematerialises each of the
     12 layers in its backward, Model.grad_fn's default); then (a) again
     with dense gossip from the same seed must end on the same flat
     buffer, and (c) again with remat off (every activation kept) within
     1e-5·max|x| of (c), both peaks and step times recorded.  Then the
     R = 2 sweep lattice on paths (e) --sweep-axis h (H = 5, 10) pallas,
     (f) --sweep-axis topology er0.5 sparse, (g) --sweep-axis seed pallas
     --fuse-update-mix --optimizer momentum, (h) --sweep-axis topology
     geo0.5 --p-fail 0.1 sparse --fuse-update-mix, each launching its
     batched kernel once per lattice step, and (e) again with dense
     gossip, which must end on the same lattice buffer.  Then compressed
     gossip with error feedback (--gossip-compress) on the flat trainer:
     (i) int8 pallas, launching #14; (j) int8 pallas --fuse-update-mix
     --optimizer momentum, #9; (k) int8 sparse --fuse-update-mix, #11;
     (l) identity pallas, #1, which must end on path (a)'s flat buffer
     (difference 0.0) with an all-zero residual; (m) topk:0.1 pallas
     --fuse-update-mix, #9.  Then the compressed R = 2 lattice at full
     width and --layers 6 (9 lattice buffers at 12 layers would not fit
     in 80 GB): (n) --sweep-axis seed int8 pallas --fuse-update-mix
     --optimizer momentum, #10; (o) --sweep-axis topology er0.5 int8
     sparse --fuse-update-mix, #12; (p) --sweep-axis h topk:0.1 pallas,
     #5; (q) --sweep-axis h identity pallas, #5, which must end on its
     uncompressed twin's lattice buffer (path (e) at the same depth, run
     too) with difference 0.0 and an all-zero residual.  Each path runs
     one untimed warm-up round first, so its step time is that of warm
     steps, and its peak must equal the warm-up's within PEAK_RTOL.  Then fig4's float64 setting (20 agents, geographic graph of
     radius 0.5, D = 25, x of scale 2^20, W^t in f64) through the flat
     engine, 10 steps each: (f64-a) pallas, #1; (f64-b) sparse, #2;
     (f64-c) pallas --fuse-update-mix, #3; (f64-d) sparse
     --fuse-update-mix, #4; each launching its kernel once per step and
     agreeing with the same round on the CPU to 1e-5·max|x|;
     then (4c) the tree engine, adamw and the zoo configs through the
     trainer, each with a warm-up round and its peak against the
     warm-up's: (r) --per-step --gossip-impl pallas, the tree engine by
     default, launching #1 once per leaf (12 a step) and ending within
     1e-5·max|x| of path (a)'s buffer (the flat and tree paths draw
     their tokens apart from the engine's draws, so per-step and fused
     runs of one seed see the same data); (s) --state-layout tree sparse
     momentum, no kernel (the reference's tree 'sparse' is a plain
     gather); (t) --state-layout tree pallas int8, #1 × 12 a step and a
     nonzero residual; (u) --optimizer adamw pallas --fuse-update-mix
     (flat), #1 once a step and #3 never; (v) Mamba2-2.7B at its
     published widths with 8 of its 64 layers, 4 agents, batch 1, flat
     pallas, #1 once a step; (w) recurrentgemma-9b --smoke --per-step
     pallas, #1 × 26 a step; (D1) DeepSeek-V2-Lite at its published
     widths with 3 of its 27 layers (the dense first layer, then two MoE
     layers as one scanned group), 2 agents, batch 1, flat pallas, #1
     once a step, its loss carrying the MoE aux term (agent 0's loss
     less its cross entropy is 1e-3·aux); then through the engine API
     (core/feddec.make_feddec_step on the tree, 2 agents, batch 1, S 512,
     ring, H 2, K 2, --gossip-impl pallas: #1 once per leaf a step),
     launch/specs.concrete_batch batches: (D2) Qwen2-VL-2B with its
     256 stub patches and (n, 3, B, S) M-RoPE positions and (D3)
     SeamlessM4T-Large-v2 with 512 stub encoder frames, each at full
     width and depth, an untimed step then a timed one: finite losses,
     parameters moved, step time and peak;
     then (4d) the delta parameterization (--delta) on the flat trainer,
     each path with its warm-up round: (x) --delta full pallas, #1 once a
     step, ending on path (a)'s buffer (difference 0.0) with an all-zero
     residual; (y) --delta topk:1048576 pallas --fuse-update-mix
     --optimizer momentum, #9 once a step, a nonzero residual, and its
     final u = flat + residual through the top-k codec on the card equal
     to the same call on the CPU element for element; (z) --delta
     lowrank:8 sparse --fuse-update-mix at --d-model 256 --layers 2 (D
     18,744,576 as (768, 24,407)), #11 once a step, within
     LOWRANK_PATH_TOL = 1e-4·max|x| of its own run with dense gossip,
     unfused, and its losses within 1e-5 relative (its final deltas'
     spectra at the cut and a repeat of the path are printed); then one
     lowrank:8 encode+decode of one full-width row (12,336 × 12,688),
     timed, its ‖u − s‖² equal to ‖u − b‖² − Σσ² within 1e-3 relative;
     then (4e) the population engine (--n-total), each path launching
     #2 (the cohort mix) once a step and no other kernel: (P1) n_total =
     cohort = 8 at full width, one round, its rows equal to the flat
     engine's with --gossip-impl sparse on the same weights, batches and
     draws, bit for bit; (P2) population_loop at full width, n_total 16,
     cohorts of 8, 10 steps at H 5, overlapped and synchronous (one run
     each; rows and losses equal bit for bit), --ckpt-dir's store
     restored bit for bit, then a
     round of --sampling stale --staleness 0.5 --n-clusters 2, with ms a
     round, drains, h2d/d2h and gather/scatter times and peaks; (P3) the
     reference benchmark's scale rows (linreg D 25, cohort 256, H 10,
     ring2, 5 rounds) at n_total 1e4 and 1e6, µs a round, their peak
     device bytes within 1% of each other and the stores equal to
     population_cost_model's; and the card's pinned and pageable h2d
     rates beside the model's nominal 16 GB/s.  The stores (10 GB each in
     P2) go to build/population, whose free space is printed first;
     then (4g) the agent-sharded engine (core/sharded.py) in a world of
     one rank over NCCL: train_loop(mesh_agents=1) on path (a)'s run
     under dense, pallas (#1 once a step on the (8, 8) own block) and int8
     pallas (#1 on the decoded s), and path (e)'s R = 2 lattice under
     pallas (#5 once a step), each held to its phase-4 twin's end state
     ((a), (a), (i), (e)) within 1e-5·max|x| (int8: 99% of it, every
     element within one int8 step), with its step time and peak;
     then (4h) the 2-D ('agents', 'model') engine: gloo worlds of 2 and
     4 ranks, every rank on this one card (the kernels built before they
     start), each rank running train_loop(mesh_agents=A, mesh_model=M)
     on path (a)'s run at full width, 1 layer (D 59,181,312), 2 steps and
     H 2, after a one-step warm-up: (t1) A 1 x M 2 pallas (#1 once a step a rank),
     (t2) the same under int8 (#1 once a step a rank; the scales' maximum
     over 'model'), (t3) A 2 x M 2 dense (no kernel), held to the end
     states of path (a)'s and (i)'s runs at that depth on one device as
     phase 4g holds its paths, each rank's state exactly n/A · D/M · 4
     bytes, with the step times (gloo's collectives, staged through the
     host) and the per-rank peaks;
     then (4i) the tensor-parallel tree engine (core/sharded.py
     make_sharded_tree_step, sharding/tp.py): gloo worlds of 2 and 4
     ranks on this one card, the zoo configs at their published widths
     with f32 compute, every leaf a rank's param_pspecs block, 5 steps at
     H 5 ((p2): 2 at H 2), batch 2 × S 128: (p1) Qwen1.5-4B at 8 of 40
     layers, (A, M) =
     (1, 2), 2 agents, pallas (#1 once per leaf block a step a rank);
     (p2) Qwen1.5-4B at 1 layer, (2, 2), 4 agents, dense (no kernel);
     (p3) Gemma3-12B at the 6 layers that hold its first global one,
     (1, 2), 2 agents, pallas; (p4) DeepSeek-V2-Lite at 3 of 27 layers
     (its dense first layer, then two MoE layers), (1, 2), 2 agents,
     pallas: MLA on the rank's 8 heads, the MoE on its 32 of 64 experts;
     each world hands its ranks' end blocks to
     this process, which then runs the path's one-device tree twin: the
     blocks within 1e-5·max|x| of the twin's, each rank's state exactly
     Σ (n/A)·numel/M_leaf · 4 bytes, the step times beside the twin's
     and the per-rank peaks (the permute gossip, point to point, is held
     on the CPU only: gloo's batch_isend_irecv refuses CUDA tensors);
     then (4f) the bf16 configs' training, each with its warm-up round,
     both with the reference's replicated agent layout (4 agents and 1,
     whatever --agents says): (M1) Mistral-Large-123B at its published
     widths with 1 of 88 layers, 4 agents, batch 1, S 512, --gossip-impl
     pallas --fuse-update-mix, #3 once a step on its bf16 (4,
     2,189,451,264) buffer; (M2) DeepSeek-V3-671B at its published
     widths with its 3 dense layers (MLA with q_lora_rank 1,536), 1
     agent, unfused, #1 once a step on its bf16 (1, 3,603,802,112)
     buffer; after each, its kernel on a random
     buffer of the path's shape against the plain version, block by
     block, y within one bf16 ulp in at most 1e-3 of its elements;
     then (4b) line 4 as the engines run it, one torch.func.vmap of
     Model.grad_fn over every agent row, at full width against the
     per-row torch.autograd.grad loop: path (c)'s 8 agents and first
     batch, then the R = 2 lattice's 16 rows; g within 1e-5·max|g|, the
     losses within 1e-5·max|loss|, both timed with their peaks;
  5. profile: path (c) once more under torch.profiler, for the device
     time per step by kernel group against the unprofiled step time; the
     set-up's device work is measured apart and taken out; then path
     (c) with remat off the same way: its step must issue fewer than
     OPS_PER_STEP_MAX device ops (one batched pass of line 4 over the 8
     agents; the per-row loop issued 18,579), and the rematerialised
     step fewer than REMAT_OPS_PER_STEP_MAX and fewer than
     REMAT_OPS_RATIO_MAX times as many (one more forward of the groups);
  6. models: the prefill (Model.logits) of the tiny LM (B 2, S 1024,
     f32), RecurrentGemma-9B, Mamba2-2.7B, Qwen1.5-4B, Gemma3-12B,
     Nemotron-4-15B, DeepSeek-V2-Lite, Qwen2-VL-2B (its first 256
     positions a 16 × 16 grid of stub patch embeddings, M-RoPE ids
     (0, row, col) there and the text's from 16 on in all three
     components), SeamlessM4T-Large-v2 (4096 stub encoder frames) and
     the configs with bf16 weights at a cut depth, Mistral-Large-123B at
     4 of 88 layers and DeepSeek-V3-671B at 4 of 61 (its 3 dense layers
     and one MoE layer of 256 experts, top-8) (B 1, S 4096, bf16) at full
     width (and depth, but those two) from random weights (each init's
     peak within its weights' bytes plus one block; with bf16 weights,
     plus the largest leaf's f32 draw, the block only where a scanned
     unit has two groups), impl='xla' then impl='pallas' on
     the same weights, each after an untimed warm-up forward: the pallas
     forward launches #15 12 times (tiny LM), #15 12 and #17 26 times
     (RecurrentGemma-9B), #16 64 times (Mamba2-2.7B), #15 40 times at
     head_dim 128 (Qwen1.5-4B), 48 times at head_dim 256 (Gemma3-12B), 32
     times at head_dim 128 (Nemotron-4-15B), 28 times at head_dim 128
     (Qwen2-VL-2B), 24 times at head_dim 64 (SeamlessM4T-Large-v2's
     decoder self-attention; its encoder and cross-attention have none),
     4 times at head_dim 128 (Mistral-Large-123B, H 96, KV 8) or nothing
     (DeepSeek-V2-Lite, DeepSeek-V3: MLA and MoE have no kernel) and
     nothing else, the logits are finite
     and agree to 1e-4·max|logit| (f32), to bf16_model_bound of the
     model's reference gap (bf16) or exactly (no kernel); each bf16 model
     but Nemotron-4-15B again with f32 compute on the same weights, to
     1e-4·max|logit|; then Mamba2-2.7B's bf16 gap at S 1024, 2048 and
     4096 (token prefixes) for weight seeds 0, 1 and 2, each within
     bf16_model_bound.  RecurrentGemma-9B peaks near 45 GB in bf16 and
     near 46 GB with f32 compute;
  6b. serving (launch/serve.py) at full width and depth from random
     weights, greedy, prompt 16 + 16 new tokens: (S1) Qwen1.5-4B at B 4,
     (S2) RecurrentGemma-9B, (S3) Mamba2-2.7B and (S5) DeepSeek-V2-Lite
     at B 1, (S6) Qwen2-VL-2B at B 4 (text only, as the reference
     decodes), (S7) SeamlessM4T-Large-v2 at B 1 (attending
     Model.encode of 4096 stub frames), and at phase 6's cut depth (S8)
     Mistral-Large-123B at B 4 and (S9) DeepSeek-V3-671B at B 1, each
     generate timed after an untimed one (ms a decode step,
     host clock, synchronized; peak), launching no kernel; each sequence
     teacher-forced through Model.decode_step, its logits against the
     xla prefill of the same tokens (phase 6's bounds; for the MoE models
     recorded only, and held instead on a twin config with f32 compute
     and capacity factor E/k, where no copy drops, to 1e-4·max|logit|)
     and generate's tokens the argmax of them exactly; (S4)
     generate_personalized at the tiny LM, B 8, request i served by agent i of path (a)'s final
     buffer (base = the mean row, deltas = rows − base), equal token for
     token to one generate per request on base + delta_i, both timed;
     then checkpointing: where zstandard imports, path (a) with
     --ckpt-dir, its checkpoint equal to the run's state bit for bit and
     serving agent 0 from it (--ckpt) equal to serving the state; where
     it does not, --ckpt-dir must fail before the first step with the
     reference's message, and the round trip is recorded as waiting for
     zstandard;
  7. paper: the paper's §4 experiments through their drivers
     (repro_torch.experiments): fig4 at the paper's settings (80 runs of
     20 agents, d = 25, T = 5000, float64, the draws from seed 42) on the
     card and on the CPU with the same host-made draws, the card's per-run
     finals within PAPER_REL_TOL of the CPU's and no kernel #1-#17
     launched (its mix is one f64 torch.bmm), its eight claims C1-C3 with
     the wall time and lattice steps per second; its steady step time
     over PAPER_TIMED_STEPS steps and, under torch.profiler, its device
     ops, device time and busy share a step; then theory_check (B1, B2),
     fig2 (F1, F2), table1 (T1-T3) and ablation_server (S1), each timed;
  8. dryrun: the dry run (launch/steps.py) against the card for path
     (c)'s step (#3), the same step at S 1,024 with remat on and with
     remat off (#3; there the activations set the peak: the
     rematerialised peak must lie below the other), (M2)'s (#1),
     Qwen1.5-4B's full-width prefill
     (impl='pallas', #15 × 40) and its chunked prefill at B 1, S 32,768
     (impl='xla', chunks of 512 queries, no kernel): each traced on the
     host on meta tensors
     (Lowerable.lower) and then run once on the card under the same
     tally (launch/trace_analysis.py), the FLOPs and op counts equal, the
     fake trace's kernel ops equal to the wrappers' launch counts, and the
     predicted peak above the arguments within DRYRUN_PEAK_RTOL (±10%) of
     max_memory_allocated above the bytes allocated before the call; then
     each program's trace_step breakdown beside the dry run's roofline at
     the H100's figures; then phase 4i's (p1) step, rank 0 of its 1 x 2
     world traced on meta tensors in a fake world against rank 0's
     tallied step in the card's gloo world: FLOPs, ops and launches
     equal, the peak within ±10% (every training program here
     rematerialises its scanned groups, Model.grad_fn's default); then
     Qwen1.5-4B's chunked prefill at S 4,096 against the one block
     (attn_chunked_prefill off): logits within 1e-4·max|logit|.

Kernel times are the median over 5 repeats of the mean of 10 calls
(CUDA events).  ``python3 chip_smoke.py --mix-timing DIR`` runs only the
ELL kernels #2, #4, #6 and #8 at full shape, checked and timed (median of
9 repeats) from the package under DIR/src, and prints one JSON line: run
it on two trees in one call to compare them on one card.  ``python3
chip_smoke.py --gap-table DIR`` prints Mamba2-2.7B's gap table of the
package under DIR/src (its #16) as one JSON line, and ``python3
chip_smoke.py --step-profile DIR`` path (c) alone (its warm step time and
phase 5's profile) from the package under DIR/src, and ``python3
chip_smoke.py --svd-timing DIR`` the low-rank codec's torch.linalg.svd at
path (z)'s and one full-width row's shapes under each cuSOLVER driver.

It prints the command's total time, one JSON line with every kernel's
launches, errors and times, the nvidia-smi line, and as the last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a card, or
outside a checkout (no src/repro_torch next to it), it exits non-zero
without a result.  The full record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
N_AGENTS, D_FULL, R_FULL = 8, 156_519_168, 2
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12          # f32 outside the tensor cores
TOL = 1e-5                      # × max|y|: f32, other summation order
# D ≡ 1, 3 (mod 4): the scalar accesses; (8, 1_000_004) the 16-byte ones,
# a ragged last tile
RAGGED = [(5, 1_000_003), (1, 777), (13, 3001), (37, 1031), (256, 10_007),
          (8, 1_000_004)]
RAGGED_LATTICE = [(1, 5, 1_000_003), (3, 1, 777), (2, 13, 3001),
                  (3, 37, 1031), (2, 256, 10_007), (2, 8, 1_000_004)]
# #10/#12: R = 1 and 3, n not a multiple of 8, D ≡ 3, 1, 2, 3, 1 (mod 4)
RAGGED_EF_LATTICE = [(1, 5, 1_000_003), (3, 13, 3001), (3, 6, 1002),
                     (1, 37, 1031), (3, 8, 777)]
# the depth of the compressed lattice paths (n)-(q) and their twin
LATTICE_EF_LAYERS = 6
UPDATES = ["sgd", "momentum", "nesterov"]
VARIANTS = {"gossip_mix": ["gossip"], "gossip_mix_sparse": ["gossip"],
            "update_mix": UPDATES, "update_mix_sparse": UPDATES}
# the batched kernels (#5-#8) and the single-run kernel each one extends
BATCHED = {"gossip_mix_batched": "gossip_mix",
           "gossip_mix_sparse_batched": "gossip_mix_sparse",
           "update_mix_batched": "update_mix",
           "update_mix_sparse_batched": "update_mix_sparse"}
REPLACES = {
    "gossip_mix": "src/repro/kernels/gossip_mix.py:48",
    "gossip_mix_sparse": "src/repro/kernels/gossip_mix.py:147",
    "update_mix": "src/repro/kernels/update_mix.py:105",
    "update_mix_sparse": "src/repro/kernels/update_mix.py:220",
    "gossip_mix_batched": "src/repro/kernels/gossip_mix.py:93",
    "gossip_mix_sparse_batched": "src/repro/kernels/gossip_mix.py:194",
    "update_mix_batched": "src/repro/kernels/update_mix.py:157",
    "update_mix_sparse_batched": "src/repro/kernels/update_mix.py:279",
}
# the compressed-gossip kernels (#9, #11, #13, #14), one variant each
COMPRESSED = {"ef_mix": "ef", "ef_mix_sparse": "ef", "quant_mix": "int8",
              "dequant_mix": "int8"}
REPLACES.update({
    "ef_mix": "src/repro/kernels/update_mix.py:330",
    "ef_mix_sparse": "src/repro/kernels/update_mix.py:397",
    "quant_mix": "src/repro/kernels/compress_mix.py:61",
    "dequant_mix": "src/repro/kernels/compress_mix.py:101",
})
# the batched EF kernels (#10, #12) and the single-run kernel each extends
BATCHED_EF = {"ef_mix_batched": "ef_mix",
              "ef_mix_sparse_batched": "ef_mix_sparse"}
REPLACES.update({
    "ef_mix_batched": "src/repro/kernels/update_mix.py:365",
    "ef_mix_sparse_batched": "src/repro/kernels/update_mix.py:429",
})
SOURCES = {k: "src/repro_torch/kernels/csrc/"
           + ("compress_mix.cu" if k in COMPRESSED or k in BATCHED_EF
              else f"{k.split('_mix')[0]}_mix.cu") for k in REPLACES}
# the model zoo's prefill kernels (#15-#17), each at its models' shapes
ZOO = ("flash_attention", "ssd_scan", "rglru_scan")
REPLACES.update({
    "flash_attention": "src/repro/kernels/flash_attention.py:88",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:76",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:60",
})
SOURCES.update({k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in ZOO})
# edge shapes: S off the tiles, W not a multiple of 4, hd 64/128/256,
# window 0 and 64, f32 and bf16.  (B, S, H, KV, hd, window, dtype)
FLASH_EDGE = [(1, 77, 4, 2, 64, 0, "float32"),
              (2, 130, 4, 1, 128, 64, "float32"),
              (1, 200, 2, 2, 256, 64, "bfloat16"),
              (1, 97, 6, 3, 64, 64, "bfloat16"),
              (1, 33, 2, 1, 128, 0, "bfloat16"),
              (2, 65, 2, 2, 256, 0, "float32"),
              # the tensor-core kernel's edges: hd 128 (scale 1/sqrt(128),
              # no power of two), S off every tile, windows off the 64-key
              # tile, KV > 1 with H / KV > 1, unpaired heads (H / KV odd)
              (1, 300, 8, 2, 128, 100, "bfloat16"),
              (2, 131, 4, 4, 64, 0, "bfloat16"),
              (1, 515, 12, 3, 256, 0, "bfloat16"),
              (1, 1000, 16, 1, 256, 333, "bfloat16")]
# (B, S, H, P, N, dtype): P off the 16-row blocks and the 64-row tile
# (17, 20, 80, 128), N = 8 ... 256 (24, 136 off the 16- and 64-column
# tiles), S below the 64-token chunk, S = 1 and S off the chunk, B 2
SSD_EDGE = [(1, 100, 3, 20, 16, "float32"), (2, 77, 4, 64, 128, "bfloat16"),
            (1, 50, 2, 17, 8, "float32"), (1, 300, 5, 64, 256, "bfloat16"),
            (1, 1, 2, 64, 128, "bfloat16"), (1, 1, 1, 20, 8, "float32"),
            (1, 40, 3, 64, 64, "bfloat16"), (2, 130, 2, 17, 8, "bfloat16"),
            (1, 300, 5, 64, 256, "float32"), (2, 200, 3, 128, 24, "bfloat16"),
            (1, 129, 2, 80, 136, "float32"), (2, 257, 4, 20, 256, "bfloat16")]
# (B, S, W, dtype): W = 1, 33, 4097 and rows that are not 16-byte multiples
# (the producer's plain-load path), W % 4 == 0 / % 8 == 0 (bulk copies),
# S = 1 and off the 32-token slot, B 3
RGLRU_EDGE = [(2, 77, 301, "float32"), (1, 33, 4097, "bfloat16"),
              (3, 5, 2, "float32"), (1, 1000, 1023, "bfloat16"),
              (1, 50, 1, "float32"), (3, 1, 33, "bfloat16"),
              (1, 40, 4097, "float32"), (3, 70, 4096, "float32"),
              (2, 300, 512, "bfloat16"), (1, 1, 1, "bfloat16")]
# the models' own shapes, named by the model whose prefill gives them
ZOO_FULL = {
    "flash_attention": {"tiny": (2, 1024, 12, 6, 64, 0, "float32"),
                        "recurrentgemma-9b": (1, 4096, 16, 1, 256, 2048,
                                              "bfloat16"),
                        "qwen1.5-4b": (1, 4096, 20, 20, 128, 0,
                                       "bfloat16"),
                        "gemma3-12b-local": (1, 4096, 16, 8, 256, 1024,
                                             "bfloat16"),
                        "gemma3-12b-global": (1, 4096, 16, 8, 256, 0,
                                              "bfloat16"),
                        "nemotron-4-15b": (1, 4096, 48, 8, 128, 0,
                                           "bfloat16"),
                        "qwen2-vl-2b": (1, 4096, 12, 2, 128, 0,
                                        "bfloat16"),
                        "seamless-m4t-large-v2": (1, 4096, 16, 16, 64, 0,
                                                  "bfloat16"),
                        "mistral-large-123b": (1, 4096, 96, 8, 128, 0,
                                               "bfloat16")},
    "ssd_scan": {"mamba2-2.7b": (1, 4096, 80, 64, 128, "bfloat16")},
    "rglru_scan": {"recurrentgemma-9b": (1, 4096, 4096, "float32")},
}
ZOO_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # × max|y|
BF16_FLOP_PER_S = 989e12        # H100 SXM tensor cores, dense
# model phase: (name, batch, seq) and the launches each forward must make
ZOO_MODELS = [("tiny", 2, 1024), ("recurrentgemma-9b", 1, 4096),
              ("mamba2-2.7b", 1, 4096), ("qwen1.5-4b", 1, 4096),
              ("gemma3-12b", 1, 4096), ("nemotron-4-15b", 1, 4096),
              ("deepseek-v2-lite-16b", 1, 4096), ("qwen2-vl-2b", 1, 4096),
              ("seamless-m4t-large-v2", 1, 4096),
              ("mistral-large-123b", 1, 4096), ("deepseek-v3-671b", 1, 4096)]
# the models whose depth phases 6 and 6b cut to fit the card (bf16
# weights): Mistral-Large-123B at 4 of 88 layers (6,341,885,952
# parameters, 12.68 GB), DeepSeek-V3-671B at 4 of 61 (its 3 dense layers
# and one MoE layer of 256 experts: 15,111,086,080 parameters, 30.2 GB)
MODEL_LAYERS = {"mistral-large-123b": 4, "deepseek-v3-671b": 4}
# DeepSeek-V2-Lite's MLA and MoE have no kernel: its two impls are one
# computation, held equal; SeamlessM4T's encoder (unmasked) and
# cross-attention take the plain path under either impl
ZOO_LAUNCHES = {"tiny": {"flash_attention": 12},
                "recurrentgemma-9b": {"flash_attention": 12,
                                      "rglru_scan": 26},
                "mamba2-2.7b": {"ssd_scan": 64},
                "qwen1.5-4b": {"flash_attention": 40},
                "gemma3-12b": {"flash_attention": 48},
                "nemotron-4-15b": {"flash_attention": 32},
                "deepseek-v2-lite-16b": {},
                "qwen2-vl-2b": {"flash_attention": 28},
                "seamless-m4t-large-v2": {"flash_attention": 24},
                "mistral-large-123b": {"flash_attention": 4},
                "deepseek-v3-671b": {}}
# the multimodal inputs of phases 6 and 6b: Qwen2-VL-2B's patch prefix
# is a VISION_GRID × VISION_GRID grid; SeamlessM4T's encoder memory is
# ENC_FRAMES frames (its config's fixed 4096-frame memory)
VISION_GRID = 16
ENC_FRAMES = 4096
# the bf16 models with a kernel on their path run again with f32 compute
# on the same weights, but Nemotron-4-15B: its 62.5 GB of f32 weights leave no room for two f32
# (S, 256,000) logits and the f32 attention of 48 heads
F32_TWIN_SKIP = ("nemotron-4-15b",)
# init_peak_check's allowance a leaf: the caching allocator rounds a large
# tensor up to its block, at most 1 MiB more (2 MiB: a margin)
INIT_ROUNDING = 2 << 20
MODEL_TOL_F32 = 1e-4            # × max|logit|, the f32 tiny LM
# training path -> (gossip impl, fuse, optimizer, the kernel it launches)
PATHS = {
    "a": ("pallas", False, "sgd", "gossip_mix"),
    "b": ("sparse", False, "sgd", "gossip_mix_sparse"),
    "c": ("pallas", True, "momentum", "update_mix"),
    "d": ("sparse", True, "sgd", "update_mix_sparse"),
}
# sweep-lattice path (R = 2) -> (axis, graph, p_fail, gossip impl, fuse,
# optimizer, the kernel it launches)
SWEEP_PATHS = {
    "e": ("h", "ring2", 0.0, "pallas", False, "sgd", "gossip_mix_batched"),
    "f": ("topology", "er0.5", 0.0, "sparse", False, "sgd",
          "gossip_mix_sparse_batched"),
    "g": ("seed", "ring2", 0.0, "pallas", True, "momentum",
          "update_mix_batched"),
    "h": ("topology", "geo0.5", 0.1, "sparse", True, "sgd",
          "update_mix_sparse_batched"),
}
# compressed flat path -> (gossip impl, fuse, optimizer, codec, the kernel
# it launches)
COMPRESS_PATHS = {
    "i": ("pallas", False, "sgd", "int8", "dequant_mix"),
    "j": ("pallas", True, "momentum", "int8", "ef_mix"),
    "k": ("sparse", True, "sgd", "int8", "ef_mix_sparse"),
    "l": ("pallas", False, "sgd", "identity", "gossip_mix"),
    "m": ("pallas", True, "sgd", "topk:0.1", "ef_mix"),
}
# compressed lattice path (R = 2, LATTICE_EF_LAYERS) -> (axis, graph, gossip
# impl, fuse, optimizer, codec, the kernel it launches)
COMPRESS_SWEEP_PATHS = {
    "n": ("seed", "ring2", "pallas", True, "momentum", "int8",
          "ef_mix_batched"),
    "o": ("topology", "er0.5", "sparse", True, "sgd", "int8",
          "ef_mix_sparse_batched"),
    "p": ("h", "ring2", "pallas", False, "sgd", "topk:0.1",
          "gossip_mix_batched"),
    "q": ("h", "ring2", "pallas", False, "sgd", "identity",
          "gossip_mix_batched"),
}
# phase 4c, the tree engine, adamw and the zoo configs through the trainer:
# path -> (gossip impl, fuse, optimizer, the kernel it launches, its
# launches a step, train_path's options).  The tree engine mixes leaf by
# leaf: the tiny LM has 12 leaves, RecurrentGemma-9B's smoke config 26.
TREE_PATHS = {
    "r": ("pallas", False, "sgd", "gossip_mix", 12, dict(fused=False)),
    "s": ("sparse", False, "momentum", "gossip_mix_sparse", 12,
          dict(layout="tree")),
    "t": ("pallas", False, "sgd", "gossip_mix", 12,
          dict(layout="tree", compress="int8")),
    "u": ("pallas", True, "adamw", "gossip_mix", 1, {}),
    "v": ("pallas", False, "sgd", "gossip_mix", 1,
          dict(arch="mamba2-2.7b", layers=8, agents=4, batch=1)),
    "w": ("pallas", False, "sgd", "gossip_mix", 26,
          dict(arch="recurrentgemma-9b", smoke=True, fused=False)),
    "D1": ("pallas", False, "sgd", "gossip_mix", 1,
           dict(arch="deepseek-v2-lite-16b", layers=3, agents=2, batch=1)),
}
# phase 4c's engine-API paths: (D2) and (D3) -> the model; the agents and
# each agent's sequence length (past Qwen2-VL's 256 patch positions,
# whose targets take no loss)
ENGINE_STEPS = {"D2": "qwen2-vl-2b", "D3": "seamless-m4t-large-v2"}
ENGINE_AGENTS, ENGINE_SEQ = 2, 512
# phase 4d, the delta parameterization (--delta) on the flat trainer: path
# -> (gossip impl, fuse, optimizer, delta spec, the kernel it launches once
# a step, train_path's options).  (z) is cut to d_model 256 and 2 layers
# (D 18,744,576, factor_dims (768, 24,407)): an SVD of 8 full-width
# (12,336 × 12,688) rows a step is no trainer path.
DELTA_PATHS = {
    "x": ("pallas", False, "sgd", "full", "gossip_mix", {}),
    "y": ("pallas", True, "momentum", "topk:1048576", "ef_mix", {}),
    "z": ("sparse", True, "sgd", "lowrank:8", "ef_mix_sparse",
          dict(d_model=256, layers=2)),
}
# path (z) against its dense rerun, × max|x|.  Not TOL: the rank-8 cut of
# these deltas falls inside a flat spectrum (σ_1/σ_12 ≈ 1.15 on the CPU's
# run), so the two mixes' one-ulp differences pick other near-equal
# directions; the card's first run ended 1.2e-5·max|x| apart (1.498e-6 at
# max|x| 0.125), with the losses held to TOL beside it.
LOWRANK_PATH_TOL = 1e-4
# the full-width low-rank cost: one lowrank:8 encode+decode of one tiny-LM
# row; ‖u − s‖² must equal ‖u − b‖² − Σ_{i≤8} σ_i² within LOWRANK_RTOL.
# Its delta: a rank-8 part scaled by LOWRANK_SCALE (singular values near
# 1,300, six times the unit noise's largest, near 223, so that the codec
# must find it) plus unit noise.  An f32 SVD's σ_i err by about
# d1·eps·σ_1 (≈ 1), which keeps the identity's error near 1e-4.
LOWRANK_RANK = 8
LOWRANK_SCALE = 0.1
LOWRANK_RTOL = 1e-3
# #1 and #2 at the widths of narrow tree leaves (D_leaf 1, 3, 80: the
# SSM's a_log/dt_bias/d_skip at Mamba2-2.7B's 80 heads) and a ragged wide
# one
TREE_LEAF_SHAPES = [(8, 1), (8, 3), (8, 80), (8, 5121)]
# path (v)'s flat buffer: Mamba2-2.7B at 8 of its 64 layers, 4 agents,
# 2.3e9 elements (past 2^31), held against the plain #1 in phase 3
MAMBA2_FLAT = (4, 579_168_640)
# the variant each bf16 kernel runs on its training path, where it differs
# from PATH_VARIANT's ((M1) runs #3 in sgd)
BF16_PATH_VARIANT = {"update_mix": "sgd"}
# the variant each kernel runs on its training path (timed in the line)
PATH_VARIANT = {"gossip_mix": "gossip", "gossip_mix_sparse": "gossip",
                "update_mix": "momentum", "update_mix_sparse": "sgd",
                "gossip_mix_batched": "gossip",
                "gossip_mix_sparse_batched": "gossip",
                "update_mix_batched": "momentum",
                "update_mix_sparse_batched": "sgd", **COMPRESSED,
                **{k: "ef" for k in BATCHED_EF}}
STEPS = 10
# the training paths' steps and server period (phases 4, 4c, 4d, 4g, the
# profile and the checkpoint), the server at the last step: 5, so that
# the script keeps within its time with every step recomputing a forward
TRAIN_STEPS = 5
DEVICE = "cuda"
# path (c)'s device ops per step: line 4 is one batched pass whose op
# count does not grow with the agents (the per-row loop issued 18,579)
OPS_PER_STEP_MAX = 4000
# path (c)'s device ops a step with remat (the default) over the same
# step with remat off: the recompute adds one forward of the groups, a
# third of a forward and backward (1.27 on an H100); a per-row loop
# would multiply them by the 8 agents
REMAT_OPS_RATIO_MAX = 1.5
# path (c)'s device ops a step with remat: 4,343 to 4,366 on an H100
REMAT_OPS_PER_STEP_MAX = 4700
# a path's peak against its warm-up's (the same run): cuBLAS's first
# workspaces are all that may differ
PEAK_RTOL = 0.01
# The bf16 full-model check (model phase): the reference's own gap between
# its pallas and xla paths, |Δlogit| / max|logit|, at a bf16-compute
# smoke config, the larger over RecurrentGemma-9B (0.00592: its attention
# keeps P in f32 on one path, bf16 on the other) and Mamba2-2.7B (0.0),
# measured by tests/test_torch_zoo.py; see bf16_model_bound.
BF16_REF_GAP = 0.006
# Qwen1.5-4B's, measured the same way (tests/test_torch_decode.py): 0.0078
# to 0.0105 over 4 weight seeds, zero and random QKV biases and 2 token
# draws, one or two bf16 steps of its largest logit
BF16_REF_GAP_QWEN = 0.011
# Nemotron-4-15B's, measured the same way (tests/test_torch_zoo.py): 0.0083
# to 0.0108 over 3 weight seeds and 2 token draws.  Gemma3-12B's, 0.0051 to
# 0.0056, is within BF16_REF_GAP; DeepSeek-V2-Lite's two paths are one
# computation (no kernel), held equal.
BF16_REF_GAP_NEMOTRON = 0.011
# Qwen2-VL-2B's (with its patch prefix and three distinct M-RoPE
# components) and SeamlessM4T-Large-v2's (the decoder's self-attention:
# its encoder and cross-attention are one computation on both paths),
# measured the same way (tests/test_torch_zoo.py): 0.0080 to 0.0107 and
# 0.0058 to 0.0093 over 3 weight seeds and 2 draws of the inputs
BF16_REF_GAP_QWEN2_VL = 0.011
BF16_REF_GAP_SEAMLESS = 0.010
# Mistral-Large-123B's, measured the same way (tests/test_torch_zoo.py):
# 0.0082 to 0.0095 over 3 weight seeds and 2 token draws
BF16_REF_GAP_MISTRAL = 0.010
BF16_REF_GAPS = {"qwen1.5-4b": BF16_REF_GAP_QWEN,
                 "nemotron-4-15b": BF16_REF_GAP_NEMOTRON,
                 "qwen2-vl-2b": BF16_REF_GAP_QWEN2_VL,
                 "seamless-m4t-large-v2": BF16_REF_GAP_SEAMLESS,
                 "mistral-large-123b": BF16_REF_GAP_MISTRAL}


def bf16_model_bound(layers: int, smoke_layers: int,
                     ref_gap: float = BF16_REF_GAP) -> float:
    """The bound on |pallas − xla| / max|logit| of a bf16 full model: the
    reference's smoke-config gap, grown as a random walk over the depth
    (√(layers / smoke_layers): each layer adds its own rounding
    differences) and doubled for the port's other summation orders."""
    return 2 * ref_gap * math.sqrt(layers / smoke_layers)


def model_tol(torch, name: str, cfg) -> tuple[float, str]:
    """(the bound on |Δlogit| / max|logit| of the full config ``cfg`` of
    model ``name``, its rule): MODEL_TOL_F32 at f32 compute, else
    bf16_model_bound of the model's reference gap."""
    if cfg.compute_dtype == torch.float32:
        return MODEL_TOL_F32, "f32"
    gap = BF16_REF_GAPS.get(name, BF16_REF_GAP)
    smoke_layers = cfg.smoke().num_layers
    return bf16_model_bound(cfg.num_layers, smoke_layers, gap), (
        f"bf16: 2·{gap}·√({cfg.num_layers}/{smoke_layers})")


class Failure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def ring_adjacency(n: int):
    """The ring2 graph the trainer builds for n agents (none below 3)."""
    import numpy as np
    from repro_torch.core import topology
    if n < 3:
        return np.zeros((n, n), dtype=bool)
    return topology.ring_graph(n, k=min(2, (n - 1) // 2)).adjacency


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_inputs(torch, n: int, d: int, seed: int):
    from repro_torch.kernels import ops
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=gen)
    g = torch.randn(n, d, device=dev, generator=gen)
    m = torch.randn(n, d, device=dev, generator=gen)
    w = torch.rand(n, n, device=dev, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    nbr, mask = (torch.as_tensor(a, device=dev)
                 for a in ops.ell_table(ring_adjacency(n)))
    wv, wd = ops.ell_weights(w, nbr, mask)
    eta = torch.tensor([0.05], device=dev)
    return dict(x=x, g=g, m=m, w=w, nbr=nbr, wv=wv, wd=wd, eta=eta)


def calls(kernel: str, variant: str, t: dict):
    """(kernel call, plain call, library call or None) on inputs ``t``."""
    import torch
    from repro_torch.kernels import ops, ref
    beta = None if variant in ("gossip", "sgd") else 0.9
    kw = {"beta": beta, "nesterov": variant == "nesterov"}
    m = None if beta is None else t["m"]
    x, g, w, eta = t["x"], t["g"], t["w"], t["eta"]
    ell = (t["nbr"], t["wv"], t["wd"])
    if kernel == "gossip_mix":
        return (lambda: ops.gossip_mix(w, x), lambda: ref.gossip_mix(w, x),
                lambda: torch.mm(w, x))
    if kernel == "gossip_mix_sparse":
        csr = w.mul(torch.as_tensor(ring_adjacency(w.shape[0]),
                                    device=w.device)
                    | torch.eye(w.shape[0], dtype=torch.bool,
                                device=w.device)).to_sparse_csr()
        return (lambda: ops.gossip_mix_sparse(*ell, x),
                lambda: ref.gossip_mix_sparse(*ell, x),
                lambda: torch.sparse.mm(csr, x))
    if kernel == "update_mix":
        return (lambda: ops.update_mix(w, x, g, eta, m, **kw),
                lambda: ref.update_mix(w, x, g, eta, m, **kw), None)
    return (lambda: ops.update_mix_sparse(*ell, x, g, eta, m, **kw),
            lambda: ref.update_mix_sparse(*ell, x, g, eta, m, **kw), None)


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def max_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) over the outputs; one temporary."""
    err = max(torch.sub(a, b).abs_().max().item()
              for a, b in zip(as_tuple(got), as_tuple(want)))
    scale = max(b.abs().max().item() for b in as_tuple(want))
    return err, scale


def time_ms(torch, fn, iters: int = 10, warmup: int = 2,
            repeats: int = 5) -> float:
    """The median over ``repeats`` of the mean time of ``iters`` calls
    (CUDA events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return sorted(means)[len(means) // 2]


def bound(kernel: str, variant: str, n: int, d: int, max_deg: int,
          r: int = 1, itemsize: int = 4):
    """(bound_ms, bound_by): each input read once, each output written
    once, against the card's memory rate and its f32 rate; r runs each
    with its own W (or ELL tables) and η; x, g and y of ``itemsize``
    bytes an element (m and m' f32 whatever it is)."""
    elems = r * n * d
    arrays = {"gossip": 2, "sgd": 3, "momentum": 3, "nesterov": 3}[variant]
    momentum = 8 if variant in ("momentum", "nesterov") else 0
    table = 4 * n * n if "sparse" not in kernel else 8 * n * max_deg + 4 * n
    nbytes = ((itemsize * arrays + momentum) * elems + r * table
              + (4 * r if variant != "gossip" else 0))
    mix = 2 * n if "sparse" not in kernel else 2 * max_deg + 1
    update = {"gossip": 0, "sgd": 2, "momentum": 4, "nesterov": 6}[variant]
    flops = elems * (mix + update)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops,
                                                          "operations")


def yardstick(torch, out, want, tol: float) -> dict:
    """The library call's output against the plain version's on the same
    inputs, checked before the call is timed: a yardstick that computes
    another function is struck (its library_ms reported as null)."""
    err, scale = max_err(torch, out, want)
    return {"max_abs_err": err, "scale": scale, "tol": tol,
            "same_function": bool(err <= tol * scale)}


def library_note(check_row) -> str:
    """The log's note beside library_ms."""
    if check_row is None:
        return ""
    verdict = "same function" if check_row["same_function"] else "STRUCK"
    return (f" [yardstick {verdict}: err {check_row['max_abs_err']:.3e} vs "
            f"{check_row['tol']}·{check_row['scale']:.3e}]")


def stream_ms(torch, x) -> float:
    """The card's stream rate over a mix's bytes: one copy of x into a
    buffer of its shape reads and writes what #1, #2, #5 and #6 must (a
    yardstick of the memory system, not the mix's function)."""
    out = torch.empty_like(x)
    ms = time_ms(torch, lambda: out.copy_(x))
    del out
    torch.cuda.empty_cache()
    return ms


def copy_note(copy_ms, ms) -> str:
    return "" if copy_ms is None else \
        f"  copy_ms {copy_ms:.4f} (the kernel at {100 * copy_ms / ms:.1f}% " \
        f"of the copy's rate)"


def kernel_phase(torch) -> dict:
    from repro_torch.kernels import ops
    results = {k: {"max_abs_err": 0.0, "variants": {}} for k in VARIANTS}
    for n, d in RAGGED:
        t = make_inputs(torch, n, d, seed=n * 131 + d)
        for kernel, variants in VARIANTS.items():
            for variant in variants:
                run, plain, _ = calls(kernel, variant, t)
                got = run()
                torch.cuda.synchronize()
                err, scale = max_err(torch, got, plain())
                check(err <= TOL * scale,
                      f"{kernel}[{variant}] n={n} D={d}: max_abs_err "
                      f"{err:.3e} > {TOL}·{scale:.3e}")
                results[kernel]["max_abs_err"] = max(
                    results[kernel]["max_abs_err"], err)
        log(f"[kernels] ragged n={n} D={d}: all variants within "
            f"{TOL}·max|y|")
        del t
    for n, d in TREE_LEAF_SHAPES:
        t = make_inputs(torch, n, d, seed=n * 131 + d)
        for kernel in ("gossip_mix", "gossip_mix_sparse"):
            run, plain, _ = calls(kernel, "gossip", t)
            got = run()
            torch.cuda.synchronize()
            err, scale = max_err(torch, got, plain())
            check(err <= TOL * scale,
                  f"{kernel} tree leaf n={n} D={d}: max_abs_err {err:.3e} "
                  f"> {TOL}·{scale:.3e}")
            results[kernel]["max_abs_err"] = max(
                results[kernel]["max_abs_err"], err)
            log(f"[kernels] {kernel} tree leaf n={n} D={d}: err {err:.3e} "
                f"(max|y| {scale:.3e})")
        del t
    torch.cuda.empty_cache()
    big = mamba2_flat_check(torch)
    results["gossip_mix"]["mamba2_flat"] = big
    results["gossip_mix"]["max_abs_err"] = max(
        results["gossip_mix"]["max_abs_err"], big["max_abs_err"])

    t = make_inputs(torch, N_AGENTS, D_FULL, seed=1)
    max_deg = t["nbr"].shape[1]
    for kernel, variants in VARIANTS.items():
        for variant in variants:
            run, plain, library = calls(kernel, variant, t)
            got = run()
            torch.cuda.synchronize()
            want = plain()
            err, scale = max_err(torch, got, want)
            del got
            check(err <= TOL * scale,
                  f"{kernel}[{variant}] n={N_AGENTS} D={D_FULL}: "
                  f"max_abs_err {err:.3e} > {TOL}·{scale:.3e}")
            lib_check = None if library is None \
                else yardstick(torch, library(), want, TOL)
            del want
            torch.cuda.empty_cache()
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain, iters=3, warmup=1, repeats=1)
            # the yardstick is timed here only, never called by the port
            library_ms = None if library is None \
                or not lib_check["same_function"] else time_ms(torch, library)
            copy_ms = stream_ms(torch, t["x"]) if variant == "gossip" \
                else None
            bound_ms, bound_by = bound(kernel, variant, N_AGENTS, D_FULL,
                                       max_deg)
            torch.cuda.empty_cache()
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "library_check": lib_check,
                   "copy_ms": copy_ms, "share_of_bound": bound_ms / ms}
            results[kernel]["variants"][variant] = row
            results[kernel]["max_abs_err"] = max(
                results[kernel]["max_abs_err"], err)
            log(f"[kernels] {kernel}[{variant}] n={N_AGENTS} D={D_FULL}: "
                f"err {err:.3e}  ms {ms:.4f}  bound_ms {bound_ms:.4f} "
                f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound)  "
                f"plain_ms {plain_ms:.4f}  library_ms "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f}'}"
                f"{library_note(lib_check)}{copy_note(copy_ms, ms)}  "
                f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del t
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return results


def mamba2_flat_check(torch) -> dict:
    """#1 on path (v)'s (4, 579,168,640) buffer against its plain version,
    within TOL·max|y|: four 9.3 GB buffers at most."""
    from repro_torch.kernels import ops, ref
    n, d = MAMBA2_FLAT
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(n * 131 + d)
    x = torch.randn(n, d, device=DEVICE, generator=gen)
    w = torch.rand(n, n, device=DEVICE, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    got = ops.gossip_mix(w, x)
    want = ref.gossip_mix(w, x)
    del x
    torch.cuda.synchronize()
    err = got.sub_(want).abs_().max().item()
    scale = want.abs().max().item()
    del got, want
    torch.cuda.empty_cache()
    check(err <= TOL * scale,
          f"gossip_mix n={n} D={d}: max_abs_err {err:.3e} > "
          f"{TOL}·{scale:.3e}")
    log(f"[kernels] gossip_mix n={n} D={d} (path (v)'s buffer): err "
        f"{err:.3e} (max|y| {scale:.3e})")
    return {"shape": [n, d], "max_abs_err": err, "scale": scale}


def lattice_graphs(r: int, n: int) -> list:
    """Per-run topologies of a ragged lattice: rings of alternating degree
    (their ELL tables padded to the lattice's max degree), the last run
    edgeless (a FedAvg member's W = I)."""
    import numpy as np
    from repro_torch.core import topology
    graphs = [topology.ring_graph(n, k=1 + i % 2) if n >= 5
              else topology.Graph(ring_adjacency(n)) for i in range(r)]
    if r > 1:
        graphs[-1] = topology.Graph(np.zeros((n, n), dtype=bool))
    return graphs


def make_lattice_inputs(torch, r: int, n: int, d: int, seed: int, graphs):
    from repro_torch.core import gossip
    from repro_torch.kernels import ops
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x, g, m = (torch.randn(r, n, d, device=dev, generator=gen)
               for _ in range(3))
    w = torch.rand(r, n, n, device=dev, generator=gen)
    w = w / w.sum(dim=-1, keepdim=True)
    nbr, mask, max_deg = gossip.stacked_ell_tables(graphs)
    nbr, mask = (torch.as_tensor(a, device=dev) for a in (nbr, mask))
    wv, wd = ops.ell_weights(w, nbr, mask)
    eta = 0.05 * torch.arange(1, r + 1, device=dev, dtype=torch.float32)
    return dict(x=x, g=g, m=m, w=w, nbr=nbr, wv=wv, wd=wd, eta=eta,
                graphs=graphs, max_deg=max_deg)


def batched_calls(kernel: str, variant: str, t: dict):
    """(kernel call, plain call on a slice of the runs, library call or
    None, single-run kernel call on run i) on lattice inputs ``t``."""
    import torch
    from repro_torch.kernels import ops, ref
    beta = None if variant in ("gossip", "sgd") else 0.9
    kw = {"beta": beta, "nesterov": variant == "nesterov"}
    x, g, m, w, eta = (t[k] for k in ("x", "g", "m", "w", "eta"))
    m = None if beta is None else m
    tab = (t["nbr"], t["wv"], t["wd"])

    def own_table(i):  # run i's unpadded ELL table, live weights
        return ops.EllTables(*ops.ell_table(
            t["graphs"][i].adjacency)).weights(w[i], x[i])

    def upd(i):  # run i's (x, g, eta, m) for a single-run kernel
        return (x[i], g[i], eta[i:i + 1], None if m is None else m[i])

    def sl_args(sl):
        return (x[sl], g[sl], eta[sl], None if m is None else m[sl])

    if kernel == "gossip_mix_batched":
        return (lambda: ops.gossip_mix_batched(w, x),
                lambda sl: ref.gossip_mix_batched(w[sl], x[sl]),
                lambda: torch.bmm(w, x),
                lambda i: ops.gossip_mix(w[i], x[i]))
    if kernel == "gossip_mix_sparse_batched":
        r, n = x.shape[:2]
        eye = torch.eye(n, dtype=torch.bool, device=w.device)
        support = [torch.as_tensor(gr.adjacency, device=w.device) | eye
                   for gr in t["graphs"]]
        csr = torch.block_diag(*[w[i] * support[i]
                                 for i in range(r)]).to_sparse_csr()
        return (lambda: ops.gossip_mix_sparse_batched(*tab, x),
                lambda sl: ref.gossip_mix_sparse_batched(
                    *(a[sl] for a in tab), x[sl]),
                lambda: torch.sparse.mm(csr, x.view(r * n, -1)),
                lambda i: ops.gossip_mix_sparse(*own_table(i), x[i]))
    if kernel == "update_mix_batched":
        return (lambda: ops.update_mix_batched(w, x, g, eta, m, **kw),
                lambda sl: ref.update_mix_batched(w[sl], *sl_args(sl), **kw),
                None,
                lambda i: ops.update_mix(w[i], *upd(i), **kw))
    return (lambda: ops.update_mix_sparse_batched(*tab, x, g, eta, m, **kw),
            lambda sl: ref.update_mix_sparse_batched(
                *(a[sl] for a in tab), *sl_args(sl), **kw),
            None,
            lambda i: ops.update_mix_sparse(*own_table(i), *upd(i), **kw))


def check_lattice(torch, kernel: str, variant: str, t: dict, where: str):
    """The batched kernel against its plain version run by run (a
    lattice-sized plain call would not fit beside the kernel's outputs at
    full shape), and each run's slice against the single-run kernel on
    that slice, to 0.0.  Returns the largest error."""
    run, plain, _, single = batched_calls(kernel, variant, t)
    got = run()
    torch.cuda.synchronize()
    err = 0.0
    for i in range(t["x"].shape[0]):
        want = plain(slice(i, i + 1))
        e, scale = max_err(torch, tuple(a[i:i + 1] for a in as_tuple(got)),
                           want)
        del want
        check(e <= TOL * scale,
              f"{kernel}[{variant}] {where} run {i}: max_abs_err {e:.3e} > "
              f"{TOL}·{scale:.3e}")
        err = max(err, e)
        one = single(i)
        diff = max(torch.sub(a[i], b).abs_().max().item()
                   for a, b in zip(as_tuple(got), as_tuple(one)))
        del one
        check(diff == 0.0,
              f"{kernel}[{variant}] {where} run {i}: slice differs from "
              f"{BATCHED[kernel]} by {diff:.3e}")
    return err


def batched_kernel_phase(torch) -> dict:
    from repro_torch.core import topology
    from repro_torch.kernels import ops
    results = {k: {"max_abs_err": 0.0, "variants": {}} for k in BATCHED}
    for r, n, d in RAGGED_LATTICE:
        t = make_lattice_inputs(torch, r, n, d, seed=r * 977 + n * 131 + d,
                                graphs=lattice_graphs(r, n))
        for kernel, single in BATCHED.items():
            for variant in VARIANTS[single]:
                err = check_lattice(torch, kernel, variant, t,
                                    f"R={r} n={n} D={d}")
                results[kernel]["max_abs_err"] = max(
                    results[kernel]["max_abs_err"], err)
        log(f"[kernels] ragged R={r} n={n} D={d}: all batched variants "
            f"within {TOL}·max|y|, run slices equal to the single-run "
            f"kernels")
        del t
    torch.cuda.empty_cache()

    # path (f)'s lattice: er0.5 drawn with seeds 0 and 1 (max degree 5)
    graphs = [topology.erdos_renyi_graph(N_AGENTS, 0.5, seed=i)
              for i in range(R_FULL)]
    t = make_lattice_inputs(torch, R_FULL, N_AGENTS, D_FULL, seed=2,
                            graphs=graphs)
    where = f"R={R_FULL} n={N_AGENTS} D={D_FULL}"
    for kernel, single in BATCHED.items():
        for variant in VARIANTS[single]:
            torch.cuda.reset_peak_memory_stats()
            err = check_lattice(torch, kernel, variant, t, where)
            torch.cuda.empty_cache()
            run, plain, library, _ = batched_calls(kernel, variant, t)
            lib_check = None
            if library is not None:  # run by run, as check_lattice
                out = library().view(t["x"].shape)
                rows = [yardstick(torch, out[i:i + 1],
                                  plain(slice(i, i + 1)), TOL)
                        for i in range(R_FULL)]
                del out
                lib_check = max(rows, key=lambda c: c["max_abs_err"]
                                / max(c["scale"], 1e-30))
                lib_check["same_function"] = all(c["same_function"]
                                                 for c in rows)
                torch.cuda.empty_cache()
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, lambda: plain(slice(None)), iters=2,
                               warmup=1, repeats=1)
            copy_ms = stream_ms(torch, t["x"]) if variant == "gossip" \
                else None
            # the yardstick is timed here only, never called by the port
            library_ms = None if library is None \
                or not lib_check["same_function"] else time_ms(torch, library)
            bound_ms, bound_by = bound(kernel, variant, N_AGENTS, D_FULL,
                                       t["max_deg"], r=R_FULL)
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
            results[kernel]["variants"][variant] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "library_check": lib_check,
                "copy_ms": copy_ms, "share_of_bound": bound_ms / ms,
                "peak_bytes": peak}
            results[kernel]["max_abs_err"] = max(
                results[kernel]["max_abs_err"], err)
            log(f"[kernels] {kernel}[{variant}] {where}: err {err:.3e}, "
                f"run slices equal to {BATCHED[kernel]}  ms {ms:.4f}  "
                f"bound_ms {bound_ms:.4f} ({bound_by}, "
                f"{100 * bound_ms / ms:.1f}% of bound)  plain_ms "
                f"{plain_ms:.4f}  library_ms "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f}'}"
                f"{library_note(lib_check)}{copy_note(copy_ms, ms)}  peak "
                f"{peak / 1e9:.2f} GB")
    del t
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return results


# ---------------------------------------------------------------------------
# Phase 3d: kernels #1 and #5 at the sharded engine's own-block shapes
# ---------------------------------------------------------------------------

# core/sharded.py mixes each rank's own block W[rows, rows] @ x_blk through
# #1 (#5 on a lattice): at the CLI's 8 agents and full width, n_local 4, 2
# and 1 for 2, 4 and 8 ranks, R 2 on the lattice
SHARD_BLOCKS = {"gossip_mix": (4, 2, 1), "gossip_mix_batched": (4, 2)}
# the 2-D engine's column blocks (phase 3e): #1 on (n_local, D/2) x, at
# one agent shard (the whole W) and at two (a strided block of W), at
# phase 4h's depth and at full depth
COLUMN_BLOCKS = (8, 4)


def shard_block_phase(torch) -> dict:
    """#1 and #5 on shard 1's own block of a random row-stochastic (8, 8)
    W (an (R, 8, 8) one for #5): the strided view W[..., lo:lo+nl,
    lo:lo+nl], at D_FULL, against the plain version (TOL·max|y|), timed
    beside the bound and the library product (torch.mm / torch.bmm, each
    checked before it is timed).  The rows are variants of the kernels'
    rows ('shard n_local=...')."""
    from repro_torch.kernels import ops, ref
    dev = torch.device(DEVICE)
    out = {k: {"max_abs_err": 0.0, "variants": {}} for k in SHARD_BLOCKS}
    for kernel, sizes in SHARD_BLOCKS.items():
        r = 1 if kernel == "gossip_mix" else R_FULL
        fn, plain_fn = getattr(ops, kernel), getattr(ref, kernel)
        lib_fn = torch.mm if r == 1 else torch.bmm
        for nl in sizes:
            gen = torch.Generator(device=dev)
            gen.manual_seed(nl * 7 + r)
            w = torch.rand((r, N_AGENTS, N_AGENTS), device=dev,
                           generator=gen)
            w = w / w.sum(dim=-1, keepdim=True)
            lo = nl
            blk = w[0, lo:lo + nl, lo:lo + nl] if r == 1 \
                else w[:, lo:lo + nl, lo:lo + nl]
            check(nl == 1 or not blk.is_contiguous(),
                  f"{kernel} shard n_local={nl}: the block is not a strided "
                  f"view")
            x = torch.randn(((r,) if r > 1 else ()) + (nl, D_FULL),
                            device=dev, generator=gen)

            def run():
                return fn(blk, x)

            def plain():
                return plain_fn(blk, x)

            def library():
                return lib_fn(blk, x)

            got = run()
            torch.cuda.synchronize()
            want = plain()
            err, scale = max_err(torch, got, want)
            del got
            where = f"{kernel} shard n_local={nl} R={r} D={D_FULL}"
            check(err <= TOL * scale, f"{where}: max_abs_err {err:.3e} > "
                                      f"{TOL}·{scale:.3e}")
            lib_check = yardstick(torch, library(), want, TOL)
            del want
            torch.cuda.empty_cache()
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain, iters=3, warmup=1, repeats=1)
            # the yardstick is timed here only, never called by the port
            library_ms = time_ms(torch, library) \
                if lib_check["same_function"] else None
            bound_ms, bound_by = bound(kernel, "gossip", nl, D_FULL, 0, r=r)
            out[kernel]["variants"][f"shard n_local={nl}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "library_check": lib_check,
                "share_of_bound": bound_ms / ms, "shape": list(x.shape)}
            out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"], err)
            log(f"[kernels] {where} (a strided W block): err {err:.3e}  ms "
                f"{ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by}, "
                f"{100 * bound_ms / ms:.1f}% of bound)  plain_ms "
                f"{plain_ms:.4f}  library_ms "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f}'}"
                f"{library_note(lib_check)}")
            del x, w, blk
            torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return out


def column_block_phase(torch) -> dict:
    """#1 at the 2-D engine's shapes (phase 3e): x a rank's (n_local,
    D / 2) column block, at phase 4h's depth (D = path_d(MESH2D_LAYERS),
    the blocks paths (t1) and (t2) launch #1 on) and at full depth
    (D_FULL), W the whole (8, 8) W at n_local 8 (one agent shard) or agent
    shard 1's strided (4, 4) block of it at n_local 4, against the plain
    version (TOL·max|y|), timed beside the bound and torch.mm (checked
    before it is timed).  Variants of #1's row ('column block n_local=...
    D/M=...')."""
    from repro_torch.kernels import ops, ref
    dev = torch.device(DEVICE)
    out = {"max_abs_err": 0.0, "variants": {}}
    for d, nl in ((d, nl) for d in (path_d(MESH2D_LAYERS) // 2, D_FULL // 2)
                  for nl in COLUMN_BLOCKS):
        gen = torch.Generator(device=dev)
        gen.manual_seed(nl * 11 + d % 7 + 2)
        w = torch.rand((N_AGENTS, N_AGENTS), device=dev, generator=gen)
        w = w / w.sum(dim=-1, keepdim=True)
        lo = 0 if nl == N_AGENTS else nl
        blk = w[lo:lo + nl, lo:lo + nl]
        check(nl == N_AGENTS or not blk.is_contiguous(),
              f"gossip_mix column block n_local={nl}: not a strided view")
        x = torch.randn((nl, d), device=dev, generator=gen)

        def run():
            return ops.gossip_mix(blk, x)

        def plain():
            return ref.gossip_mix(blk, x)

        def library():
            return torch.mm(blk, x)

        got = run()
        torch.cuda.synchronize()
        want = plain()
        err, scale = max_err(torch, got, want)
        del got
        where = f"gossip_mix column block n_local={nl} D/M={d}"
        check(err <= TOL * scale, f"{where}: max_abs_err {err:.3e} > "
                                  f"{TOL}·{scale:.3e}")
        lib_check = yardstick(torch, library(), want, TOL)
        del want
        torch.cuda.empty_cache()
        ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=3, warmup=1, repeats=1)
        # the yardstick is timed here only, never called by the port
        library_ms = time_ms(torch, library) \
            if lib_check["same_function"] else None
        bound_ms, bound_by = bound("gossip_mix", "gossip", nl, d, 0)
        out["variants"][f"column block n_local={nl} D/M={d}"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_check": lib_check,
            "share_of_bound": bound_ms / ms, "shape": list(x.shape),
            "w_strided": not blk.is_contiguous()}
        out["max_abs_err"] = max(out["max_abs_err"], err)
        what = "a strided W block" if nl < N_AGENTS else "the whole W"
        log(f"[kernels] {where} ({what}): "
            f"err {err:.3e}  ms {ms:.4f}  bound_ms {bound_ms:.4f} "
            f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound)  plain_ms "
            f"{plain_ms:.4f}  library_ms "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f}'}"
            f"{library_note(lib_check)}")
        del x, w, blk
        torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return out


# (p1)'s leaf blocks on the tensor-parallel tree engine (phase 3f): #1 (and
# #2, which the tree's 'sparse' launches at one agent shard) on Qwen1.5-4B's
# largest and smallest leaf blocks at (A, M) = (1, 2) with 2 agents: the
# vocabulary block of embed.table, (2, 151,936 / 2 · 2,560), and a norm's
# replicated scale, (2, 2,560)
TP_LEAF_BLOCKS = {"embed.table": 151_936 // 2 * 2_560, "norm": 2_560}


def tp_leaf_phase(torch) -> dict:
    """#1 and #2 at TP_LEAF_BLOCKS with a random row-stochastic (2, 2) W
    (the ring of 2's ELL table for #2), against the plain version
    (TOL·max|y|), timed beside the bound and, for #1, torch.mm (checked
    before it is timed).  Variants of #1's and #2's rows ('tp leaf ...')."""
    from repro_torch.kernels import ops, ref
    dev = torch.device(DEVICE)
    n = 2
    out = {k: {"max_abs_err": 0.0, "variants": {}}
           for k in ("gossip_mix", "gossip_mix_sparse")}
    nbr, mask = (torch.as_tensor(a, device=dev) for a in ops.ell_table(
        [[False, True], [True, False]]))
    for leaf, d in TP_LEAF_BLOCKS.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(d % 101 + 5)
        w = torch.rand((n, n), device=dev, generator=gen)
        w = w / w.sum(dim=-1, keepdim=True)
        wv, wd = ops.ell_weights(w, nbr, mask)
        x = torch.randn((n, d), device=dev, generator=gen)
        for kernel in out:
            if kernel == "gossip_mix":
                run, plain = (lambda: ops.gossip_mix(w, x),
                              lambda: ref.gossip_mix(w, x))
                library = lambda: torch.mm(w, x)   # noqa: E731
            else:
                run, plain = (lambda: ops.gossip_mix_sparse(nbr, wv, wd, x),
                              lambda: ref.gossip_mix_sparse(nbr, wv, wd, x))
                library = None
            got = run()
            torch.cuda.synchronize()
            want = plain()
            err, scale = max_err(torch, got, want)
            del got
            where = f"{kernel} tp leaf {leaf} (n {n}, D {d:,})"
            check(err <= TOL * scale, f"{where}: max_abs_err {err:.3e} > "
                                      f"{TOL}·{scale:.3e}")
            lib_check = None if library is None \
                else yardstick(torch, library(), want, TOL)
            del want
            ms = time_ms(torch, run)
            plain_ms = time_ms(torch, plain, iters=3, warmup=1, repeats=1)
            # the yardstick is timed here only, never called by the port
            library_ms = time_ms(torch, library) \
                if lib_check is not None and lib_check["same_function"] \
                else None
            bound_ms, bound_by = bound(kernel, "gossip", n, d, 1)
            out[kernel]["variants"][f"tp leaf {leaf}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "library_check": lib_check,
                "share_of_bound": bound_ms / ms, "shape": [n, d]}
            out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"],
                                             err)
            log(f"[kernels] {where}: err {err:.3e}  ms {ms:.4f}  bound_ms "
                f"{bound_ms:.4f} ({bound_by}, {100 * bound_ms / ms:.1f}% of "
                f"bound)  plain_ms {plain_ms:.4f}  library_ms "
                f"{'n/a' if library_ms is None else f'{library_ms:.4f}'}"
                f"{library_note(lib_check)}")
        del x, w, wv, wd
        torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return out


def make_compress_inputs(torch, n: int, d: int, seed: int):
    """p, s, u, noise (n, D), W, the ring's ELL tables and the int8
    payload (q, scale) of u; u's first row larger (rows of other
    scales)."""
    from repro_torch.core import compress
    from repro_torch.kernels import ops
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p, s, u = (torch.randn(n, d, device=dev, generator=gen)
               for _ in range(3))
    u[0].mul_(40.0)
    noise = torch.rand(n, d, device=dev, generator=gen)
    w = torch.rand(n, n, device=dev, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    nbr, mask = (torch.as_tensor(a, device=dev)
                 for a in ops.ell_table(ring_adjacency(n)))
    wv, wd = ops.ell_weights(w, nbr, mask)
    payload = compress.parse_compress("int8").encode(noise, u)
    return dict(p=p, s=s, u=u, noise=noise, w=w, nbr=nbr, wv=wv, wd=wd,
                q=payload["q"], scale=payload["scale"])


def compress_calls(kernel: str, t: dict):
    """(kernel call, plain call) of #9, #11, #13 or #14 on inputs ``t``."""
    from repro_torch.kernels import ops, ref
    if kernel == "ef_mix":
        args = (t["w"], t["p"], t["s"], t["u"])
    elif kernel == "ef_mix_sparse":
        args = (t["nbr"], t["wv"], t["wd"], t["p"], t["s"], t["u"])
    elif kernel == "quant_mix":
        args = (t["w"], t["u"], t["noise"], t["p"], t["scale"])
    else:
        args = (t["w"], t["q"], t["scale"], t["p"])
    return (lambda: getattr(ops, kernel)(*args),
            lambda: getattr(ref, kernel)(*args))


def compress_bound(kernel: str, n: int, d: int, max_deg: int, r: int = 1,
                   itemsize: int = 4):
    """(bound_ms, bound_by): each input read once, each output written
    once (f32: #9-#12: p, s, u in, y, r out, 20 B per element; #13: u,
    noise, p in, y and q at 1 B out, 17 B; #14: q at 1 B and p in, y out,
    9 B; p, s, u, y and r of ``itemsize`` bytes, the noise f32), against
    the card's memory rate and its f32 rate; r runs (#10/#12) each with
    its own W or ELL tables."""
    kernel = BATCHED_EF.get(kernel, kernel)
    elems = r * n * d
    per_elem = {"ef_mix": 5 * itemsize, "ef_mix_sparse": 5 * itemsize,
                "quant_mix": 3 * itemsize + 5,
                "dequant_mix": 2 * itemsize + 1}[kernel]
    table = 8 * n * max_deg + 4 * n if kernel == "ef_mix_sparse" \
        else 4 * n * n
    scales = 4 * n if kernel in ("quant_mix", "dequant_mix") else 0
    nbytes = per_elem * elems + r * (table + scales)
    # the mix, the correction (3) and the source of s: r = u − s (1),
    # q·scale (1), or a division, an add, a floor, a clip (2) and q·scale
    mix = 2 * max_deg + 1 if kernel == "ef_mix_sparse" else 2 * n
    source = {"ef_mix": 1, "ef_mix_sparse": 1, "quant_mix": 6,
              "dequant_mix": 1}[kernel]
    flops = elems * (mix + 3 + source)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops,
                                                          "operations")


def check_compress(torch, kernel: str, t: dict, where: str) -> float:
    """The kernel against its plain version: y within TOL·max|y|, the
    residual r (#9, #11) and the int8 q (#13) exact.  Returns y's
    error."""
    run, plain = compress_calls(kernel, t)
    got = as_tuple(run())
    torch.cuda.synchronize()
    want = as_tuple(plain())
    err = torch.sub(got[0], want[0]).abs_().max().item()
    scale = want[0].abs().max().item()
    check(err <= TOL * scale,
          f"{kernel} {where}: y max_abs_err {err:.3e} > {TOL}·{scale:.3e}")
    for a, b in zip(got[1:], want[1:]):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{kernel} {where}: {a.dtype} output differs from the plain "
              f"version's")
    return err


def compress_kernel_phase(torch) -> dict:
    from repro_torch.kernels import ops
    results = {k: {"max_abs_err": 0.0, "variants": {}} for k in COMPRESSED}
    for n, d in RAGGED:
        t = make_compress_inputs(torch, n, d, seed=n * 6007 + d)
        for kernel in COMPRESSED:
            err = check_compress(torch, kernel, t, f"n={n} D={d}")
            results[kernel]["max_abs_err"] = max(
                results[kernel]["max_abs_err"], err)
        log(f"[kernels] ragged n={n} D={d}: #9/#11/#13/#14 y within "
            f"{TOL}·max|y|, r and q exact")
        del t
    torch.cuda.empty_cache()

    t = make_compress_inputs(torch, N_AGENTS, D_FULL, seed=3)
    max_deg = t["nbr"].shape[1]
    where = f"n={N_AGENTS} D={D_FULL}"
    for kernel, variant in COMPRESSED.items():
        torch.cuda.reset_peak_memory_stats()
        err = check_compress(torch, kernel, t, where)
        torch.cuda.empty_cache()
        run, plain = compress_calls(kernel, t)
        ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain, iters=3, warmup=1, repeats=1)
        bound_ms, bound_by = compress_bound(kernel, N_AGENTS, D_FULL,
                                            max_deg)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        results[kernel]["variants"][variant] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "share_of_bound": bound_ms / ms, "peak_bytes": peak}
        results[kernel]["max_abs_err"] = max(
            results[kernel]["max_abs_err"], err)
        log(f"[kernels] {kernel}[{variant}] {where}: y err {err:.3e}, "
            f"exact outputs equal  ms {ms:.4f}  bound_ms {bound_ms:.4f} "
            f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound)  plain_ms "
            f"{plain_ms:.4f}  library_ms n/a (no single call)  peak "
            f"{peak / 1e9:.2f} GB")
    del t
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return results


def make_ef_lattice_inputs(torch, r: int, n: int, d: int, seed: int,
                           graphs):
    """p, s, u (R, n, D) with each run's first row of u larger (rows of
    other int8 scales), per-run W and the lattice's stacked ELL tables."""
    from repro_torch.core import gossip
    from repro_torch.kernels import ops
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p, s, u = (torch.randn(r, n, d, device=dev, generator=gen)
               for _ in range(3))
    u[:, 0].mul_(40.0)
    w = torch.rand(r, n, n, device=dev, generator=gen)
    w = w / w.sum(dim=-1, keepdim=True)
    nbr, mask, max_deg = gossip.stacked_ell_tables(graphs)
    nbr, mask = (torch.as_tensor(a, device=dev) for a in (nbr, mask))
    wv, wd = ops.ell_weights(w, nbr, mask)
    return dict(p=p, s=s, u=u, w=w, nbr=nbr, wv=wv, wd=wd, graphs=graphs,
                max_deg=max_deg)


def batched_ef_calls(kernel: str, t: dict):
    """(kernel call, plain call on a slice of the runs, single-run kernel
    call on run i) of #10 or #12 on lattice inputs ``t``."""
    from repro_torch.kernels import ops, ref
    p, s, u, w = (t[k] for k in ("p", "s", "u", "w"))
    tab = (t["nbr"], t["wv"], t["wd"])
    if kernel == "ef_mix_batched":
        return (lambda: ops.ef_mix_batched(w, p, s, u),
                lambda sl: ref.ef_mix_batched(w[sl], p[sl], s[sl], u[sl]),
                lambda i: ops.ef_mix(w[i], p[i], s[i], u[i]))

    def own_table(i):  # run i's unpadded ELL table, live weights
        return ops.EllTables(*ops.ell_table(
            t["graphs"][i].adjacency)).weights(w[i], p[i])

    return (lambda: ops.ef_mix_sparse_batched(*tab, p, s, u),
            lambda sl: ref.ef_mix_sparse_batched(
                *(a[sl] for a in tab), p[sl], s[sl], u[sl]),
            lambda i: ops.ef_mix_sparse(*own_table(i), p[i], s[i], u[i]))


def check_ef_lattice(torch, kernel: str, t: dict, where: str) -> float:
    """#10/#12 against the plain version run by run (y within
    TOL·max|y|, the residual r exact), and each run's slice against
    #9/#11 on that slice, to 0.0.  Returns y's largest error."""
    run, plain, single = batched_ef_calls(kernel, t)
    y, r = run()
    torch.cuda.synchronize()
    err = 0.0
    for i in range(t["p"].shape[0]):
        want_y, want_r = plain(slice(i, i + 1))
        e = torch.sub(y[i:i + 1], want_y).abs_().max().item()
        scale = want_y.abs().max().item()
        exact = torch.equal(r[i:i + 1], want_r)
        del want_y, want_r
        check(e <= TOL * scale,
              f"{kernel} {where} run {i}: y max_abs_err {e:.3e} > "
              f"{TOL}·{scale:.3e}")
        check(exact, f"{kernel} {where} run {i}: the residual differs from "
                     f"the plain version's")
        err = max(err, e)
        one = single(i)
        diff = max(torch.sub(a[i], b).abs_().max().item()
                   for a, b in zip((y, r), one))
        del one
        check(diff == 0.0,
              f"{kernel} {where} run {i}: slice differs from "
              f"{BATCHED_EF[kernel]} by {diff:.3e}")
    return err


def batched_ef_kernel_phase(torch) -> dict:
    from repro_torch.core import topology
    from repro_torch.kernels import ops
    results = {k: {"max_abs_err": 0.0, "variants": {}} for k in BATCHED_EF}

    def ragged(t, where):
        for kernel in BATCHED_EF:
            err = check_ef_lattice(torch, kernel, t, where)
            results[kernel]["max_abs_err"] = max(
                results[kernel]["max_abs_err"], err)
        log(f"[kernels] ragged {where}: #10/#12 y within {TOL}·max|y|, r "
            f"exact, run slices equal to #9/#11")

    for r, n, d in RAGGED_EF_LATTICE:
        ragged(make_ef_lattice_inputs(torch, r, n, d,
                                      seed=r * 7001 + n * 131 + d,
                                      graphs=lattice_graphs(r, n)),
               f"R={r} n={n} D={d}")
    # contiguous lattices 4 bytes past a 16-byte boundary, D % 4 == 0: the
    # kernels take the masked scalar accesses
    t = make_ef_lattice_inputs(torch, 2, N_AGENTS, 65536, seed=5,
                               graphs=lattice_graphs(2, N_AGENTS))
    for key in ("p", "s", "u"):
        buf = torch.empty(t[key].numel() + 1, device=t[key].device)
        t[key] = buf[1:].view_as(t[key]).copy_(t[key])
        check(t[key].data_ptr() % 16 == 4, "misaligned buffer expected")
    ragged(t, f"R=2 n={N_AGENTS} D=65536 misaligned")
    del t
    torch.cuda.empty_cache()

    # path (o)'s lattice: er0.5 drawn with seeds 0 and 1 (one table padded)
    graphs = [topology.erdos_renyi_graph(N_AGENTS, 0.5, seed=i)
              for i in range(R_FULL)]
    t = make_ef_lattice_inputs(torch, R_FULL, N_AGENTS, D_FULL, seed=4,
                               graphs=graphs)
    where = f"R={R_FULL} n={N_AGENTS} D={D_FULL}"
    for kernel in BATCHED_EF:
        torch.cuda.reset_peak_memory_stats()
        err = check_ef_lattice(torch, kernel, t, where)
        torch.cuda.empty_cache()
        run, plain, _ = batched_ef_calls(kernel, t)
        ms = time_ms(torch, run)
        plain_ms = time_ms(torch, lambda: plain(slice(None)), iters=2,
                           warmup=1, repeats=1)
        bound_ms, bound_by = compress_bound(kernel, N_AGENTS, D_FULL,
                                            t["max_deg"], r=R_FULL)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        results[kernel]["variants"]["ef"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "share_of_bound": bound_ms / ms, "peak_bytes": peak}
        results[kernel]["max_abs_err"] = max(
            results[kernel]["max_abs_err"], err)
        log(f"[kernels] {kernel}[ef] {where}: y err {err:.3e}, r exact, run "
            f"slices equal to {BATCHED_EF[kernel]}  ms {ms:.4f}  bound_ms "
            f"{bound_ms:.4f} ({bound_by}, {100 * bound_ms / ms:.1f}% of "
            f"bound)  plain_ms {plain_ms:.4f}  library_ms n/a (no single "
            f"call)  peak {peak / 1e9:.2f} GB")
    del t
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return results


# ---------------------------------------------------------------------------
# Phase 3a: the mix kernels (#1-#14) on float64 buffers
# ---------------------------------------------------------------------------

# n = 8 on D % 4 == 0 and a ragged D (the small path), n = 13 (the general)
F64_SHAPES = [(8, 1_000_004), (8, 1_000_003), (13, 3001)]
F64_BUFFERS = ("x", "g", "p", "s", "u", "w")


def to_f64(t: dict) -> dict:
    """The buffers (x, g, p, s, u) and W in f64; the momentum, η, noise,
    int8 scales and ELL weights stay f32, as the kernels take them."""
    return {k: v.double() if k in F64_BUFFERS else v for k, v in t.items()}


def f64_kernel_phase(torch) -> dict:
    """Every mix kernel on f64 buffers against its plain version: y in f64
    within TOL·max|y| (the mix sums in f32, as the reference's kernels
    do), m', the residual and the int8 payload exactly, each batched run's
    slice equal to the single-run kernel.  Returns each kernel's largest
    error."""
    from repro_torch.kernels import ops
    errs = {k: 0.0 for k in REPLACES if k not in ZOO}
    for n, d in F64_SHAPES:
        where = f"f64 n={n} D={d}"
        t = to_f64(make_inputs(torch, n, d, seed=n * 131 + d))
        for kernel, variants in VARIANTS.items():
            for variant in variants:
                run, plain, _ = calls(kernel, variant, t)
                got = run()
                torch.cuda.synchronize()
                check(as_tuple(got)[0].dtype == torch.float64,
                      f"{kernel}[{variant}] {where}: y is not f64")
                err, scale = max_err(torch, got, plain())
                check(err <= TOL * scale,
                      f"{kernel}[{variant}] {where}: max_abs_err {err:.3e} "
                      f"> {TOL}·{scale:.3e}")
                errs[kernel] = max(errs[kernel], err)
        t = to_f64(make_compress_inputs(torch, n, d, seed=n * 6007 + d))
        for kernel in COMPRESSED:
            errs[kernel] = max(errs[kernel],
                               check_compress(torch, kernel, t, where))
        graphs = lattice_graphs(2, n)
        t = to_f64(make_lattice_inputs(torch, 2, n, d, seed=n + d,
                                       graphs=graphs))
        for kernel, single in BATCHED.items():
            for variant in VARIANTS[single]:
                errs[kernel] = max(errs[kernel], check_lattice(
                    torch, kernel, variant, t, where))
        t = to_f64(make_ef_lattice_inputs(torch, 2, n, d, seed=n + d,
                                          graphs=graphs))
        for kernel in BATCHED_EF:
            errs[kernel] = max(errs[kernel],
                               check_ef_lattice(torch, kernel, t, where))
        del t
        log(f"[kernels] f64 n={n} D={d}: #1-#14 within {TOL}·max|y|, m', r "
            f"and q exact, run slices equal to the single-run kernels")
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return errs


# ---------------------------------------------------------------------------
# Phase 3c: the mix kernels (#1-#14) on bfloat16 buffers
# ---------------------------------------------------------------------------

# n = 8 on D % 4 == 0 (8-byte accesses of four bf16) and D ≡ 3 (mod 4), and
# n = 13 (the general path); the same at a base one element past an 8-byte
# boundary (the masked scalar accesses)
BF16_SHAPES = [(8, 1_000_004, False), (8, 1_000_003, False),
               (13, 3001, False), (8, 1_000_004, True)]
# the lattices: R = 1 and 3, the small path (ragged D) and the general one
BF16_LATTICES = [(1, 8, 1_000_003), (3, 8, 4098), (3, 13, 3001)]
BF16_BUFFERS = ("x", "g", "p", "s", "u")
# × max|y|: kernel and plain version sum in f32 in other orders, which
# moves a bf16 rounding of y by one ulp, 2^-7·max|y| at the top; the EF
# kernels (#9-#12) round the mix to bf16 before the correction, so two
# roundings may move; m' (f32) within TOL, r and q exact
BF16_Y_TOL = 2.0 ** -7
BF16_EF_TOL = 2.0 ** -6
# the share of y's elements that may differ at all: the two sums straddle
# a bf16 rounding boundary only rarely, where a kernel that rounds at
# another point than the plain version (x − η·g in bf16 before the mix)
# moves about 40% of them, each within the bound above
BF16_Y_SHARE = 1e-3


def to_bf16(torch, t: dict, misaligned: bool = False) -> dict:
    """The buffers (x, g, p, s, u) in bf16 (each one element past an
    8-byte boundary when ``misaligned``); W, the momentum, η, noise, ELL
    weights and int8 scales stay f32, as the kernels take them; the int8
    scales are those of the bf16 u."""
    out = dict(t)
    for k in BF16_BUFFERS:
        if k not in t:
            continue
        v = t[k].to(torch.bfloat16)
        if misaligned:
            buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
            v = buf[1:].view_as(v).copy_(v)
            check(v.data_ptr() % 8 == 2, "misaligned bf16 buffer expected")
        out[k] = v
    if "scale" in t and "u" in t:
        out["scale"] = out["u"].float().abs().amax(-1) / 127.0
    return out


def bf16_tol(kernel: str) -> float:
    return BF16_EF_TOL if kernel.startswith("ef_mix") else BF16_Y_TOL


def check_bf16(torch, got, want, kernel: str,
               what: str) -> tuple[float, float]:
    """A bf16 kernel's outputs against its plain version's: y in bf16
    within bf16_tol·max|y| and differing in at most BF16_Y_SHARE of its
    elements, m' (f32) within TOL·max|m'|, the residual and the int8
    payload exact.  Returns y's error and the share of y that differs."""
    got, want = as_tuple(got), as_tuple(want)
    check(got[0].dtype == torch.bfloat16, f"{what}: y is {got[0].dtype}")
    tol = bf16_tol(kernel)
    err = torch.sub(got[0].float(), want[0].float()).abs_().max().item()
    scale = want[0].float().abs().max().item()
    check(err <= tol * scale,
          f"{what}: y max_abs_err {err:.3e} > {tol}·{scale:.3e}")
    share = got[0].ne(want[0]).sum().item() / max(want[0].numel(), 1)
    check(share <= BF16_Y_SHARE,
          f"{what}: {share:.3e} of y differs from the plain version "
          f"(at most {BF16_Y_SHARE})")
    for a, b in zip(got[1:], want[1:]):
        check(a.dtype == b.dtype, f"{what}: {a.dtype} against {b.dtype}")
        if a.dtype == torch.float32:
            e = torch.sub(a, b).abs_().max().item()
            check(e <= TOL * b.abs().max().item(),
                  f"{what}: m' max_abs_err {e:.3e}")
        else:
            check(torch.equal(a, b), f"{what}: {a.dtype} output differs "
                                     f"from the plain version's")
    return err, share


def bf16_single_calls(kernel: str, variant: str, t: dict):
    """(kernel call, plain call) of a single-run kernel #1-#4, #9, #11,
    #13 or #14 on bf16 inputs ``t``."""
    if kernel in COMPRESSED:
        return compress_calls(kernel, t)
    return calls(kernel, variant, t)[:2]


def bf16_lattice_calls(kernel: str, variant: str, t: dict):
    """(kernel call, plain call on a slice of the runs, single-run kernel
    call on run i) of #5-#8, #10 or #12."""
    if kernel in BATCHED_EF:
        return batched_ef_calls(kernel, t)
    run, plain, _, single = batched_calls(kernel, variant, t)
    return run, plain, single


def check_bf16_lattice(torch, kernel: str, variant: str, t: dict,
                       where: str) -> tuple[float, float]:
    """A batched bf16 kernel against its plain version run by run, and each
    run's slice against the single-run kernel on that slice, to 0.0.
    Returns check_bf16's largest error and share over the runs."""
    run, plain, single = bf16_lattice_calls(kernel, variant, t)
    got = run()
    torch.cuda.synchronize()
    err = share = 0.0
    for i in range(as_tuple(got)[0].shape[0]):
        want = plain(slice(i, i + 1))
        e, sh = check_bf16(
            torch, tuple(a[i:i + 1] for a in as_tuple(got)), want, kernel,
            f"bf16 {kernel}[{variant}] {where} run {i}")
        err, share = max(err, e), max(share, sh)
        del want
        one = single(i)
        diff = max(torch.sub(a[i].float(), b.float()).abs_().max().item()
                   for a, b in zip(as_tuple(got), as_tuple(one)))
        del one
        check(diff == 0.0,
              f"bf16 {kernel}[{variant}] {where} run {i}: slice differs "
              f"from the single-run kernel by {diff:.3e}")
    return err, share


BF16_LATTICE_KERNELS = {**{k: VARIANTS[v] for k, v in BATCHED.items()},
                        **{k: ["ef"] for k in BATCHED_EF}}
BF16_SINGLE_KERNELS = {**VARIANTS, **{k: [v] for k, v in COMPRESSED.items()}}


def bf16_kernel_phase(torch) -> dict:
    """Every mix kernel #1-#14 in every variant on bf16 buffers: at the
    ragged shapes against its plain version (check_bf16), the batched ones
    run by run with each run's slice equal to the single-run kernel; then
    at full shape (n 8, D_FULL; R_FULL runs for the batched ones), timed
    against the bf16 bound, the plain version and, for the mixes, one
    copy of the same bytes.  No library call computes a bf16 buffer's mix
    with f32 W (torch.mm takes one dtype): library_ms is null."""
    from repro_torch.core import topology
    from repro_torch.kernels import ops
    results = {k: {"max_abs_err": 0.0, "y_share_differing": 0.0,
                   "variants": {}}
               for k in (*BF16_SINGLE_KERNELS, *BF16_LATTICE_KERNELS)}

    def note(kernel, err_share):
        row = results[kernel]
        row["max_abs_err"] = max(row["max_abs_err"], err_share[0])
        row["y_share_differing"] = max(row["y_share_differing"],
                                       err_share[1])
        return err_share

    for n, d, misaligned in BF16_SHAPES:
        where = f"n={n} D={d}{' misaligned' if misaligned else ''}"
        for inputs in (make_inputs, make_compress_inputs):
            t = to_bf16(torch, inputs(torch, n, d, seed=n * 131 + d),
                        misaligned)
            for kernel, variants in BF16_SINGLE_KERNELS.items():
                if (kernel in COMPRESSED) != (inputs is make_compress_inputs):
                    continue
                for variant in variants:
                    run, plain = bf16_single_calls(kernel, variant, t)
                    got = run()
                    torch.cuda.synchronize()
                    note(kernel, check_bf16(torch, got, plain(), kernel,
                                            f"bf16 {kernel}[{variant}] "
                                            f"{where}"))
                    del got
            del t
        log(f"[kernels] bf16 {where}: #1-#4, #9, #11, #13, #14 y within "
            f"{BF16_Y_TOL}·max|y| (EF {BF16_EF_TOL}) and differing in at "
            f"most {BF16_Y_SHARE} of its elements, m' within {TOL}, r and q "
            f"exact")
    for r, n, d in BF16_LATTICES:
        where = f"R={r} n={n} D={d}"
        graphs = lattice_graphs(r, n)
        for inputs in (make_lattice_inputs, make_ef_lattice_inputs):
            t = to_bf16(torch, inputs(torch, r, n, d, seed=r * 977 + n + d,
                                      graphs=graphs))
            for kernel, variants in BF16_LATTICE_KERNELS.items():
                if (kernel in BATCHED_EF) != (
                        inputs is make_ef_lattice_inputs):
                    continue
                for variant in variants:
                    note(kernel, check_bf16_lattice(torch, kernel, variant,
                                                    t, where))
            del t
        log(f"[kernels] bf16 {where}: #5-#8, #10, #12 within their bf16 "
            f"bounds, run slices equal to the single-run kernels")
    torch.cuda.empty_cache()

    def timed(kernel, variant, run, plain_all, where, r, max_deg, x,
              share):
        ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain_all, iters=2, warmup=1, repeats=1)
        copy_ms = stream_ms(torch, x) if variant == "gossip" else None
        if kernel in COMPRESSED or kernel in BATCHED_EF:
            bound_ms, bound_by = compress_bound(kernel, N_AGENTS, D_FULL,
                                                max_deg, r=r, itemsize=2)
        else:
            bound_ms, bound_by = bound(kernel, variant, N_AGENTS, D_FULL,
                                       max_deg, r=r, itemsize=2)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        row = {"max_abs_err": results[kernel]["max_abs_err"], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None, "copy_ms": copy_ms,
               "share_of_bound": bound_ms / ms, "peak_bytes": peak,
               "y_share_differing": share}
        results[kernel]["variants"][variant] = row
        log(f"[kernels] bf16 {kernel}[{variant}] {where}: err "
            f"{row['max_abs_err']:.3e} (y differs in {share:.3e} of its "
            f"elements)  ms {ms:.4f}  bound_ms {bound_ms:.4f} "
            f"({bound_by}, {100 * bound_ms / ms:.1f}% of bound)  plain_ms "
            f"{plain_ms:.4f}  library_ms n/a (no single call takes f32 W "
            f"and a bf16 buffer){copy_note(copy_ms, ms)}  peak "
            f"{peak / 1e9:.2f} GB")

    where = f"n={N_AGENTS} D={D_FULL}"
    for inputs in (make_inputs, make_compress_inputs):
        t = to_bf16(torch, inputs(torch, N_AGENTS, D_FULL, seed=7))
        max_deg = t["nbr"].shape[1]
        for kernel, variants in BF16_SINGLE_KERNELS.items():
            if (kernel in COMPRESSED) != (inputs is make_compress_inputs):
                continue
            for variant in variants:
                torch.cuda.reset_peak_memory_stats()
                run, plain = bf16_single_calls(kernel, variant, t)
                got = run()
                torch.cuda.synchronize()
                _, share = note(kernel, check_bf16(
                    torch, got, plain(), kernel,
                    f"bf16 {kernel}[{variant}] {where}"))
                del got
                torch.cuda.empty_cache()
                timed(kernel, variant, run, plain, where, 1, max_deg,
                      t.get("x"), share)
        del t
        torch.cuda.empty_cache()

    graphs = [topology.erdos_renyi_graph(N_AGENTS, 0.5, seed=i)
              for i in range(R_FULL)]
    where = f"R={R_FULL} n={N_AGENTS} D={D_FULL}"
    for inputs in (make_lattice_inputs, make_ef_lattice_inputs):
        t = to_bf16(torch, inputs(torch, R_FULL, N_AGENTS, D_FULL, seed=8,
                                  graphs=graphs))
        for kernel, variants in BF16_LATTICE_KERNELS.items():
            if (kernel in BATCHED_EF) != (inputs is make_ef_lattice_inputs):
                continue
            for variant in variants:
                torch.cuda.reset_peak_memory_stats()
                _, share = note(kernel, check_bf16_lattice(
                    torch, kernel, variant, t, where))
                torch.cuda.empty_cache()
                run, plain, _ = bf16_lattice_calls(kernel, variant, t)
                timed(kernel, variant, run, lambda: plain(slice(None)),
                      where, R_FULL, t["max_deg"], t.get("x"), share)
        del t
        torch.cuda.empty_cache()
    ops.reset_launch_counts()
    return results


# fig4's float64 setting (benchmarks/fig4_convergence.py): 20 agents on a
# geographic graph of radius 0.5, D = 25, x of scale 2^20
F64_AGENTS, F64_D, F64_SCALE = 20, 25, 2.0 ** 20
F64_PATHS = {"f64-a": ("pallas", False, "gossip_mix"),
             "f64-b": ("sparse", False, "gossip_mix_sparse"),
             "f64-c": ("pallas", True, "update_mix"),
             "f64-d": ("sparse", True, "update_mix_sparse")}


def f64_path_phase(torch) -> dict:
    """The flat engine on fig4's float64 buffer, W^t in f64: gossip_impl
    pallas and sparse, unfused and fused, STEPS steps of a quadratic loss
    with the server off (its draws would differ between the devices).  Each path
    launches its kernel once per step (counts set to 0 just before it),
    keeps its buffer f64 and finite, and agrees with the same round on the
    CPU (the kernels' plain versions) to TOL·max|x|."""
    import numpy as np
    from repro_torch.core import draws as draws_lib, engine
    from repro_torch.core import flat as flat_lib, topology
    from repro_torch.core.feddec import FedDecConfig
    from repro_torch.core.mixing import MixingDistribution
    from repro_torch.kernels import ops
    rng = np.random.default_rng(0)
    flat0 = rng.standard_normal((F64_AGENTS, F64_D)) * F64_SCALE
    targets = rng.standard_normal((STEPS, F64_AGENTS, F64_D)) * F64_SCALE
    spec = flat_lib.make_flat_spec(
        {"w": torch.zeros(F64_D, dtype=torch.float64)})

    grad_fn = engine.value_and_grad(lambda params, batch: 0.5 * torch.sum(
        torch.square(params["w"] - batch["t"])))

    out = {}
    for name, (impl, fused, kernel) in F64_PATHS.items():
        cfg = FedDecConfig(mixing=MixingDistribution(
            topology.geographic_graph(F64_AGENTS, 0.5, seed=1),
            dtype=torch.float64), gossip_impl=impl, server_enabled=False)
        flats = {}
        for dev in ("cpu", DEVICE):
            eta = torch.tensor([0.05], dtype=torch.float64, device=dev)
            round_fn = flat_lib.make_flat_feddec_round(
                cfg, spec, grad_fn, lambda t, eta=eta: eta, device=dev,
                fuse_update_mix=fused)
            state = flat_lib.flat_state_from_numpy(flat0, 1, device=dev)
            ops.reset_launch_counts()
            state, _ = round_fn(state, {"t": torch.as_tensor(targets,
                                                             device=dev)},
                                draws_lib.Draws(0, dev))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            flats[dev] = state.flat.cpu()
        launched = {k: v for k, v in counts.items() if v}
        check(launched == {kernel: STEPS},
              f"{name}: launched {launched}, expected {{{kernel!r}: "
              f"{STEPS}}}")
        got, want = flats[DEVICE], flats["cpu"]
        check(got.dtype == torch.float64 and bool(torch.isfinite(got).all()),
              f"{name}: the buffer is {got.dtype} or not finite")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(err <= TOL * scale, f"{name}: max|Δx| {err:.3e} > "
                                  f"{TOL}·{scale:.3e} against the CPU run")
        out[name] = {"impl": impl, "fused": fused, "kernel": kernel,
                     "launches": launched[kernel], "max_abs_err": err,
                     "scale": scale}
        log(f"[f64] path {name} ({impl}{' fused' if fused else ''}, n "
            f"{F64_AGENTS}, D {F64_D}, f64): launched {launched}; max|Δx| "
            f"{err:.3e} against the CPU run (max|x| {scale:.3e})")
    ops.reset_launch_counts()
    return out


# ---------------------------------------------------------------------------
# Phase 3b: the model zoo's prefill kernels (#15-#17)
# ---------------------------------------------------------------------------


def zoo_inputs(torch, kernel: str, shape: tuple, seed: int) -> tuple:
    """Inputs of #15, #16 or #17 at ``shape``, from a seeded generator:
    attention q/k/v ~ N(0, 1); the SSD's Δ = softplus(N(0, 1) − 4.6) and
    A = −(1..H) (the Mamba2 block's ranges); the RG-LRU's a ∈ [0, 1)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = getattr(torch, shape[-1])

    def randn(*size):
        return torch.randn(*size, device=dev, generator=gen)

    if kernel == "flash_attention":
        b, s, h, kv, hd, _, _ = shape
        return (randn(b, s, h, hd).to(dtype), randn(b, s, kv, hd).to(dtype),
                randn(b, s, kv, hd).to(dtype))
    if kernel == "ssd_scan":
        b, s, h, p, n, _ = shape
        dt = torch.nn.functional.softplus(randn(b, s, h) - 4.6)
        a = -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
        return (randn(b, s, h, p).to(dtype), dt, a, randn(b, s, n).to(dtype),
                randn(b, s, n).to(dtype))
    b, s, w, _ = shape
    return (torch.rand(b, s, w, device=dev, generator=gen).to(dtype),
            randn(b, s, w).to(dtype))


def zoo_calls(torch, kernel: str, shape: tuple, args: tuple):
    """(kernel call, plain call, library call or None) on ``args``."""
    from repro_torch.kernels import ops, ref
    if kernel == "flash_attention":
        window = shape[5]
        q, k, v = args
        return (lambda: ops.flash_attention(q, k, v, window=window),
                lambda: ref.flash_attention_ref(q, k, v, window=window),
                sdpa_call(torch, q, k, v, window))
    if kernel == "ssd_scan":
        return (lambda: ops.ssd_scan(*args), lambda: ref.ssd_scan_ref(*args),
                None)
    return (lambda: ops.rglru_scan(*args),
            lambda: ref.rglru_scan_ref(*args), None)


def sdpa_call(torch, q, k, v, window: int):
    """The yardstick of #15, never called by the port: one
    F.scaled_dot_product_attention on the same q/k/v ((B, H, S, hd) views,
    K/V heads repeated for the groups beforehand), causal, with the window
    as a boolean mask."""
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1)
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] > pos[:, None] - window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def zoo_bound(kernel: str, shape: tuple):
    """(bound_ms, bound_by): each input read once and each output written
    once at 3.35 TB/s, or the operations at the inputs' dtype's peak (bf16
    tensor cores 989 TFLOP/s, f32 67 TFLOP/s), whichever is larger.
    #15 counts 4·hd flop per visible (query, key) pair and head; #16 the
    Pallas kernel's chunked products at L = 256 (C·Bᵀ once per chunk, the
    masked decay product, the state readout and update per head); #17
    2 flop per element."""
    dtype = shape[-1]
    size = 4 if dtype == "float32" else 2
    rate = F32_FLOP_PER_S if dtype == "float32" else BF16_FLOP_PER_S
    if kernel == "flash_attention":
        b, s, h, kv, hd, window, _ = shape
        pairs = sum(min(i + 1, window) if window > 0 else i + 1
                    for i in range(s))
        flops = 4 * hd * pairs * h * b
        nbytes = size * b * s * hd * (2 * h + 2 * kv)
    elif kernel == "ssd_scan":
        b, s, h, p, n, _ = shape
        chunk = 256
        nc = -(-s // chunk)
        flops = b * nc * (2 * chunk * chunk * n + h * (
            chunk * (chunk + 1) * p + 4 * chunk * n * p))
        nbytes = size * b * s * (2 * h * p + 2 * n) + 4 * (b * s * h + h)
    else:
        b, s, w, _ = shape
        flops = 2 * b * s * w
        rate = F32_FLOP_PER_S
        nbytes = (2 * size + 4) * b * s * w + 4 * b * w
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops,
                                                          "operations")


def check_zoo(torch, kernel: str, shape: tuple, seed: int) -> dict:
    """The kernel against its plain version on the same inputs: y within
    ZOO_TOL[dtype]·max|y|; #17's h_last equal to h[:, −1] exactly."""
    args = zoo_inputs(torch, kernel, shape, seed)
    run, plain, _ = zoo_calls(torch, kernel, shape, args)
    with torch.inference_mode():
        got = as_tuple(run())
        torch.cuda.synchronize()
        want = as_tuple(plain())
    err = torch.sub(got[0].float(), want[0].float()).abs_().max().item()
    scale = want[0].float().abs().max().item()
    tol = ZOO_TOL[shape[-1]]
    check(got[0].dtype == want[0].dtype and got[0].shape == want[0].shape,
          f"{kernel} {shape}: output {got[0].dtype} {tuple(got[0].shape)}")
    check(math.isfinite(err) and err <= tol * scale,
          f"{kernel} {shape}: max_abs_err {err:.3e} > {tol}·{scale:.3e}")
    out = {"max_abs_err": err, "scale": scale}
    if kernel == "rglru_scan":
        check(torch.equal(got[1], got[0][:, -1]),
              f"rglru_scan {shape}: h_last differs from h[:, -1]")
        out["h_equal_to_plain"] = bool(torch.equal(got[0], want[0]))
        check(out["h_equal_to_plain"],
              f"rglru_scan {shape}: h differs from the plain version's "
              f"(the recurrence is rounded alike: expected bit for bit)")
    return out


# #15's P check: RecurrentGemma-9B's heads (H 16, KV 1, hd 256), S 1024,
# a window of 256
SPLIT_P = (1024, 16, 1, 256, 256)


def split_p_check(torch) -> dict:
    """#15's bf16 kernel forms P·V as P_hi·V + P_lo·V.  On inputs whose
    windows cancel (v alternating ±64 from key to key, scores of std
    0.01), y is small beside the terms p·v, and a one-product bf16 P (what
    SDPA and the xla path compute) errs more than ZOO_TOL·max|y| on the
    rows with a full window; the kernel must stay within it there."""
    from repro_torch.kernels import ops, ref
    s, h, kv, hd, window = SPLIT_P
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    q = (torch.randn(1, s, h, hd, device=DEVICE, generator=gen)
         * 0.1).bfloat16()
    k = (torch.randn(1, s, kv, hd, device=DEVICE, generator=gen)
         * 0.1).bfloat16()
    sign = torch.where(torch.rand(1, 1, kv, hd, device=DEVICE,
                                  generator=gen) < 0.5, -1.0, 1.0)
    alt = (-1.0) ** torch.arange(s, device=DEVICE, dtype=torch.float32)
    v = (64.0 * alt[None, :, None, None] * sign).bfloat16()
    rows = slice(window - 1, None)
    with torch.inference_mode():
        want = ref.flash_attention_ref(q, k, v, window=window).float()
        tol = ZOO_TOL["bfloat16"] * want[:, rows].abs().max().item()
        # the one-product variant, the row sums of the f32 P
        qg = q.reshape(1, s, kv, h // kv, hd).float() * hd ** -0.5
        sc = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
        pos = torch.arange(s, device=DEVICE)
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
        p = torch.exp(sc.masked_fill_(~mask, -1e30)
                      - sc.amax(-1, keepdim=True))
        one = torch.einsum("bkgst,btkh->bskgh", p.bfloat16().float(),
                           v.float())
        one = (one / p.sum(-1)[..., None].permute(0, 3, 1, 2, 4)).reshape(
            1, s, h, hd).bfloat16().float()
        del sc, p
        one_err = (one - want)[:, rows].abs().max().item()
        got = ops.flash_attention(q, k, v, window=window).float()
        torch.cuda.synchronize()
    err = (got - want)[:, rows].abs().max().item()
    check(one_err > tol, f"flash_attention P check: the inputs do not tell "
                         f"a bf16 P apart ({one_err:.3e} <= {tol:.3e})")
    check(err <= tol, f"flash_attention P check: max_abs_err {err:.3e} > "
                      f"{tol:.3e} (P is not kept to f32 accuracy)")
    log(f"[kernels] flash_attention P check {SPLIT_P}: kernel err "
        f"{err:.3e}, one-product bf16 P err {one_err:.3e}, limit "
        f"{tol:.3e} ({ZOO_TOL['bfloat16']}·max|y| on the full-window rows)")
    return {"shape": list(SPLIT_P), "max_abs_err": err,
            "bf16_p_err": one_err, "tol": tol}


# #16's accuracy check: the inputs of tests/test_torch_zoo.py::
# test_ssd_recurrence_is_more_accurate_than_the_chunked_form, Mamba2's
# largest heads (A = -77 ... -80)
SSD_ACCURACY = (1, 512, 4, 64, 128)
SSD_ACCURACY_TOL = 1e-6         # × max|y| against the f64 recurrence


def ssd_accuracy_inputs(torch):
    """x, Δ, A, B, C (f32, on the card) from numpy's generator, seed 11,
    drawn as the CPU test draws them: Δ = softplus(N(0, 1) − 4.6)."""
    import numpy as np
    b, s, h, p, n = SSD_ACCURACY
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 4.6)).astype(
        np.float32)
    bb = rng.standard_normal((b, s, n), dtype=np.float32)
    cc = rng.standard_normal((b, s, n), dtype=np.float32)
    a = -np.arange(77, 77 + h, dtype=np.float32)
    return [torch.from_numpy(v).to(DEVICE) for v in (x, dt, a, bb, cc)]


def ssd_accuracy_check(torch) -> dict:
    """#16's f32 route against an f64 recurrence on the card, where Δ·A is
    large: the kernel within SSD_ACCURACY_TOL·max|y|, and the chunked form
    with decays exp(cum_i − cum_j) (models/ssm.py:ssd_chunked, chunk 256)
    at least 10× further off on the same inputs (so that the check tells
    the two apart)."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    args = ssd_accuracy_inputs(torch)
    x, dt, a, b, c = (t.double() for t in args)
    with torch.inference_mode():
        state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], b.shape[-1],
                            dtype=torch.float64, device=DEVICE)
        exact = torch.empty(x.shape, dtype=torch.float64, device=DEVICE)
        for t in range(x.shape[1]):
            state.mul_(torch.exp(dt[:, t] * a)[:, :, None, None]).add_(
                (x[:, t] * dt[:, t, :, None])[..., None]
                * b[:, t][:, None, None, :])
            exact[:, t] = torch.einsum("bhpn,bn->bhp", state, c[:, t])
        got = ops.ssd_scan(*args)
        torch.cuda.synchronize()
        chunked = ssm.ssd_chunked(*args, chunk=256)[0]
    scale = exact.abs().max().item()
    err = (got.double() - exact).abs().max().item()
    chunk_err = (chunked.double() - exact).abs().max().item()
    check(err <= SSD_ACCURACY_TOL * scale,
          f"ssd_scan accuracy check: max_abs_err {err:.3e} > "
          f"{SSD_ACCURACY_TOL}·{scale:.3e} against the f64 recurrence")
    check(chunk_err >= 10 * err,
          f"ssd_scan accuracy check: the cum-difference form errs "
          f"{chunk_err:.3e}, not 10× the kernel's {err:.3e}")
    log(f"[kernels] ssd_scan accuracy check {SSD_ACCURACY}, A = -77..-80, "
        f"f32, against an f64 recurrence: kernel err {err / scale:.3e}·"
        f"max|y|, cum-difference chunked form {chunk_err / scale:.3e}·"
        f"max|y| (limit {SSD_ACCURACY_TOL}·max|y|, the other form ≥ 10×)")
    return {"shape": list(SSD_ACCURACY), "max_abs_err": err,
            "chunked_err": chunk_err, "scale": scale,
            "tol": SSD_ACCURACY_TOL}


def kernel_pass_ms(torch, fn, calls: int = 10) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, by the
    kernel's name (torch.profiler; #16's wrapper runs three passes)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us > 0:
            name = re.search(r"(\w+)(<|\()", e.key)
            out[name.group(1) if name else e.key[:60]] = us / calls / 1e3
    return out


def zoo_kernel_phase(torch) -> dict:
    from repro_torch.kernels import ops
    results = {k: {"max_abs_err": 0.0, "variants": {}} for k in ZOO}
    results["flash_attention"]["split_p"] = split_p_check(torch)
    results["ssd_scan"]["accuracy"] = ssd_accuracy_check(torch)
    edges = {"flash_attention": FLASH_EDGE, "ssd_scan": SSD_EDGE,
             "rglru_scan": RGLRU_EDGE}
    for kernel, shapes in edges.items():
        for i, shape in enumerate(shapes):
            row = check_zoo(torch, kernel, shape, seed=101 + i)
            results[kernel]["max_abs_err"] = max(
                results[kernel]["max_abs_err"], row["max_abs_err"])
        log(f"[kernels] {kernel} at {len(shapes)} edge shapes: within "
            f"{ZOO_TOL}·max|y|" + (", h_last == h[:, -1]"
                                   if kernel == "rglru_scan" else ""))
    torch.cuda.empty_cache()

    for kernel, by_model in ZOO_FULL.items():
        for model, shape in by_model.items():
            torch.cuda.reset_peak_memory_stats()
            row = check_zoo(torch, kernel, shape, seed=7)
            args = zoo_inputs(torch, kernel, shape, seed=7)
            run, plain, library = zoo_calls(torch, kernel, shape, args)
            with torch.inference_mode():
                lib_check = None
                if library is not None:  # SDPA's (B, H, S, hd) output
                    lib_check = yardstick(torch,
                                          library().transpose(1, 2).float(),
                                          plain().float(),
                                          ZOO_TOL[shape[-1]])
                    torch.cuda.empty_cache()
                ms = time_ms(torch, run)
                plain_ms = time_ms(torch, plain, iters=2, warmup=1, repeats=1)
                # the yardstick is timed here only, never called by the port
                library_ms = None if library is None \
                    or not lib_check["same_function"] \
                    else time_ms(torch, library)
            if kernel == "ssd_scan":  # the three passes of one launch
                with torch.inference_mode():
                    row["passes_ms"] = kernel_pass_ms(torch, run)
                log(f"[kernels] ssd_scan {model} passes (torch.profiler, "
                    f"ms per call): " + ", ".join(
                        f"{k} {v:.4f}" for k, v in row["passes_ms"].items()))
            bound_ms, bound_by = zoo_bound(kernel, shape)
            peak = torch.cuda.max_memory_allocated()
            del args, run, plain, library
            torch.cuda.empty_cache()
            row.update({"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "library_check": lib_check,
                        "share_of_bound": bound_ms / ms, "peak_bytes": peak})
            results[kernel]["variants"][model] = row
            results[kernel]["max_abs_err"] = max(
                results[kernel]["max_abs_err"], row["max_abs_err"])
            lib = ("n/a (no single call)" if lib_check is None
                   else "struck" if library_ms is None
                   else f"{library_ms:.4f} (sdpa)") + library_note(lib_check)
            log(f"[kernels] {kernel} {model} {shape}: err "
                f"{row['max_abs_err']:.3e} (max|y| {row['scale']:.3e})  ms "
                f"{ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by}, "
                f"{100 * bound_ms / ms:.1f}% of bound)  plain_ms "
                f"{plain_ms:.4f}  library_ms {lib}  peak "
                f"{peak / 1e9:.2f} GB")
    ops.reset_launch_counts()
    return results


# ---------------------------------------------------------------------------
# Phase 4: training on the port's main path
# ---------------------------------------------------------------------------


def split_draws(seed: int):
    """The flat and tree paths' draws: the engine's from ``seed``, the
    tokens from a second generator, so that a round's batches are the
    same whether its steps draw them one by one (--per-step) or H at a
    time (the fused round), and a per-step run can be held to a fused
    one."""
    from repro_torch.core.draws import Draws

    class SplitDraws(Draws):
        def __init__(self):
            super().__init__(seed, DEVICE)
            self.data_draws = Draws(seed + 1, DEVICE)

        def tokens(self, data, per_agent_batch, steps):
            return self.data_draws.tokens(data, per_agent_batch, steps)

    return SplitDraws()


def path_config(arch: str, layers: int, smoke: bool, d_model: int = 768):
    """The trainer's model: the tiny LM at ``layers`` (and ``d_model``),
    or a zoo config at its published widths with its depth cut to
    ``layers`` (its smoke variant with ``smoke``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    if arch == "tiny":
        return train.tiny_lm_config(d_model=d_model, layers=layers)
    cfg = get_config(arch)
    return cfg.smoke() if smoke else dataclasses.replace(cfg,
                                                         num_layers=layers)


def path_d(layers: int) -> int:
    """D of the tiny LM at full width and ``layers``."""
    from repro_torch.models import build_model
    model = build_model(path_config("tiny", layers, False))
    return model.param_count(model.init_shapes())


def train_path(torch, impl: str, fuse: bool, optimizer: str,
               steps: int = TRAIN_STEPS, *, graph: str = "ring2",
               p_fail: float = 0.0, sweep_axis: str | None = None,
               compress: str = "none", layers: int = 12,
               arch: str = "tiny", smoke: bool = False,
               agents: int = N_AGENTS, batch: int = 2, fused: bool = True,
               layout: str | None = None, delta: str = "none",
               d_model: int = 768, ckpt_dir: str | None = None,
               seq: int = 128, mesh_agents: int | None = None,
               mesh_model: int | None = None, h: int = TRAIN_STEPS,
               remat: bool = True):
    """One run of the trainer; with ``sweep_axis`` the R_FULL-run lattice,
    whose whole (R, n, D) state it returns (else the FedState); ``compress``
    is the gossip codec (--gossip-compress), ``delta`` the delta
    parameterization (--delta), ``layers`` and ``d_model`` the depth and
    width (--layers, --d-model), ``arch``/``smoke`` the model (--arch,
    --smoke), ``fused`` False the one-step executor (--per-step) and
    ``layout`` the state layout (--state-layout; None: the trainer's
    default), ``ckpt_dir`` the checkpoint directory (--ckpt-dir), ``seq``
    each agent's sequence length (--seq), ``mesh_agents`` the sharded
    engine's ranks (--mesh-agents; the caller holds the process group),
    ``mesh_model`` the 2-D mesh's model ranks (--mesh-model), ``h``
    the server period (--h) and ``remat`` False line 4 without the
    groups' rematerialisation (train_loop's option; the CLI has none)."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.launch import train
    # what earlier phases left to the garbage collector goes first, so
    # that the peak is this run's own
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    timing: dict = {}
    sweep = dict(draws=split_draws(0)) if sweep_axis is None else dict(
        sweep_runs=R_FULL, sweep_axis=sweep_axis, keep_lattice=True)
    state, losses = train.train_loop(
        path_config(arch, layers, smoke, d_model),
        FedConfig(n_agents=agents, h=h, k=2, graph=graph, p_fail=p_fail,
                  gossip_impl=impl, gossip_compress=compress, delta=delta),
        steps=steps, per_agent_batch=batch, seq_len=seq, optimizer=optimizer,
        fuse_update_mix=fuse, fused=fused, state_layout=layout, seed=0,
        device=DEVICE, timing=timing, ckpt_dir=ckpt_dir,
        mesh_agents=mesh_agents, mesh_model=mesh_model, remat=remat,
        **sweep)
    torch.cuda.synchronize()
    return state, losses, timing, torch.cuda.max_memory_allocated()


def flat_of(torch, state, residual: bool = False):
    """A run's final (rows, D) buffer (its EF residual with ``residual``):
    a lattice's own; for a FedState, the flat engine's buffer that its
    leaves view (no copy), else its leaves side by side in FlatSpec order
    (a new buffer)."""
    from repro_torch.core import flat as flat_lib
    from repro_torch.tree import leaves
    if hasattr(state, "flat"):
        return state.residual if residual else state.flat
    tree = state.residual if residual else state.params
    spec = flat_lib.make_flat_spec_from_stacked(tree)
    first = leaves(tree)[0]
    base, rows = first._base, first.shape[0]
    if base is not None and base.is_contiguous() \
            and base.numel() == rows * spec.d \
            and base.data_ptr() == first.data_ptr():
        return base.view(rows, spec.d)
    return spec.flatten(tree)


def warm_up(torch, impl: str, fuse: bool, optimizer: str, **kw) -> int:
    """One untimed round of the path, so that the timed run's steps do
    not pay the allocator's growth, cuBLAS's first calls or the kernel's
    first launch; returns its peak.  Its launches are not counted: the
    caller resets the counters after it."""
    return train_path(torch, impl, fuse, optimizer, **kw)[3]


def dense_rerun(torch, name: str, final, tol: float = TOL, **kw) -> dict:
    """Path ``name`` again with the plain dense mix: the same seed must end
    on the same flat (or lattice) buffer, within ``tol``·max|x| (f32
    noise: TOL)."""
    from repro_torch.kernels import ops
    warm_up(torch, "dense", False, "sgd", **kw)
    ops.reset_launch_counts()
    state, losses, timing, peak = train_path(torch, "dense", False, "sgd",
                                             **kw)
    check(sum(ops.launch_counts().values()) == 0,
          "dense gossip launched a kernel")
    err = (flat_of(torch, state) - final).abs().max().item()
    scale = final.abs().max().item()
    check(err <= tol * scale,
          f"path ({name}) kernel vs dense final buffers differ: {err:.3e} > "
          f"{tol}·{scale:.3e}")
    out = {"impl": "dense", "losses": losses,
           "step_ms": 1e3 * timing["loop_s"] / TRAIN_STEPS,
           "peak_bytes": peak,
           "max_abs_diff": err, "scale": scale, "tol": tol}
    log(f"[train] path ({name}) with dense gossip: step "
        f"{out['step_ms']:.1f} ms, peak {peak / 1e9:.2f} GB, final buffer "
        f"within {err:.3e} of the kernel run (limit {tol}·{scale:.3e})")
    return out


def run_path(torch, name: str, impl: str, fuse: bool, opt: str,
             kernel: str | None, per_step: int = 1, **kw):
    """A warm-up round, then the timed run with the launch counters set
    to 0 just before it and read just after: its kernel must launch
    ``per_step`` times a step (the tree engine: once per leaf) and no
    other kernel at all (none at all when ``kernel`` is None), and its
    peak must be the warm-up's within PEAK_RTOL."""
    from repro_torch.kernels import ops
    warm_peak = warm_up(torch, impl, fuse, opt, **kw)
    ops.reset_launch_counts()
    state, losses, timing, peak = train_path(torch, impl, fuse, opt, **kw)
    counts = ops.launch_counts()
    # the same run twice: its peak must not depend on thread timing
    check(abs(peak - warm_peak) <= PEAK_RTOL * peak,
          f"path ({name}): peak {peak / 1e9:.2f} GB, its warm-up's "
          f"{warm_peak / 1e9:.2f} GB")
    check(all(math.isfinite(v) for v in losses),
          f"path ({name}): non-finite loss {losses}")
    launches = 0 if kernel is None else counts[kernel]
    check(launches == (0 if kernel is None else TRAIN_STEPS * per_step),
          f"path ({name}): {kernel} launched {launches} times in "
          f"{TRAIN_STEPS} steps ({per_step} a step expected)")
    check(sum(counts.values()) == launches,
          f"path ({name}): other kernels launched: {counts}")
    step_ms = 1e3 * timing["loop_s"] / TRAIN_STEPS
    out = {"impl": impl, "fuse_update_mix": fuse, "optimizer": opt,
           "kernel": kernel, "launches": launches,
           "launches_per_step": launches / TRAIN_STEPS, "losses": losses,
           "step_ms": step_ms, "setup_s": timing["setup_s"],
           "peak_bytes": peak, "warm_up_peak_bytes": warm_peak, **kw}
    log(f"[train] path ({name}) gossip={impl} fuse={fuse} opt={opt}"
        + "".join(f" {k}={v}" for k, v in kw.items())
        + f": loss {losses[0]:.4f} → {losses[-1]:.4f}, {kernel} launches "
        f"{launches} ({launches / TRAIN_STEPS:g} a step), step "
        f"{step_ms:.1f} ms "
        f"(host clock, synchronized), setup {timing['setup_s']:.1f} s, "
        f"peak {peak / 1e9:.2f} GB (warm-up {warm_peak / 1e9:.2f} GB)")
    return state, out


def training_phase(torch) -> tuple:
    """Phase 4's paths; returns their rows, path (a)'s final buffer and
    the finals that phase 4g holds its paths to (on the host)."""
    out, finals = {}, {}
    for name, (impl, fuse, opt, kernel) in PATHS.items():
        state, out[name] = run_path(torch, name, impl, fuse, opt, kernel)
        if name == "a":
            # compared right away, so no path's peak holds this buffer;
            # kept on the host for path (l)
            final = flat_of(torch, state)
            out["a_dense"] = dense_rerun(torch, "a", final)
            a_final = final.cpu()
            del final
        if name == "c":
            final = flat_of(torch, state).cpu()
            del state
            torch.cuda.empty_cache()
            out["c_remat_off"] = remat_off_rerun(torch, final, out["c"])
            del final
            continue
        del state
        torch.cuda.empty_cache()
    for name, (axis, graph, p_fail, impl, fuse, opt, kernel) in \
            SWEEP_PATHS.items():
        kw = dict(graph=graph, p_fail=p_fail, sweep_axis=axis)
        state, out[name] = run_path(torch, name, impl, fuse, opt, kernel,
                                    **kw)
        if name == "e":
            out["e_dense"] = dense_rerun(torch, "e", state.flat, **kw)
            finals["e"] = state.flat.cpu()   # phase 4g's twin
        del state
        torch.cuda.empty_cache()
    for name, (impl, fuse, opt, codec, kernel) in COMPRESS_PATHS.items():
        state, out[name] = run_path(torch, name, impl, fuse, opt, kernel,
                                    compress=codec)
        check_residual(torch, name, state, out[name],
                       *(("a", a_final) if name == "l" else ()))
        if name == "i":   # phase 4g's twin
            finals["i"] = flat_of(torch, state).cpu()
            finals["i_residual_max"] = out[name]["residual_max_abs"]
        del state
        torch.cuda.empty_cache()
    for name, (axis, graph, impl, fuse, opt, codec, kernel) in \
            COMPRESS_SWEEP_PATHS.items():
        kw = dict(graph=graph, sweep_axis=axis, layers=LATTICE_EF_LAYERS)
        twin = ()
        if codec == "identity":
            # the uncompressed twin: path (e) at this depth, kept on the
            # host so that no path's peak holds it
            state, out[f"{name}_twin"] = run_path(
                torch, f"{name} twin", impl, fuse, opt, kernel, **kw)
            twin = (f"{name}_twin", state.flat.cpu())
            del state
            torch.cuda.empty_cache()
        state, out[name] = run_path(torch, name, impl, fuse, opt, kernel,
                                    compress=codec, **kw)
        check_residual(torch, name, state, out[name], *twin)
        del state
        torch.cuda.empty_cache()
    finals["a"] = a_final
    return out, a_final, finals


def remat_off_rerun(torch, final, remat_on: dict) -> dict:
    """Path (c) again with line 4 keeping every activation (remat off):
    the same seed must end on the same flat buffer within TOL·max|x|;
    both runs' peaks and step times are recorded."""
    impl, fuse, opt, kernel = PATHS["c"]
    state, out = run_path(torch, "c remat off", impl, fuse, opt, kernel,
                          remat=False)
    got = flat_of(torch, state)
    err = (got - final.to(got.device)).abs().max().item()
    scale = final.abs().max().item()
    del state, got
    torch.cuda.empty_cache()
    check(err <= TOL * scale,
          f"path (c) with remat off ends {err:.3e} from remat on > "
          f"{TOL}·{scale:.3e}")
    out.update(max_abs_diff=err, scale=scale, tol=TOL,
               remat_on_step_ms=remat_on["step_ms"],
               remat_on_peak_bytes=remat_on["peak_bytes"])
    log(f"[train] path (c) remat on / off: step {remat_on['step_ms']:.1f} / "
        f"{out['step_ms']:.1f} ms, peak {remat_on['peak_bytes'] / 1e9:.2f} / "
        f"{out['peak_bytes'] / 1e9:.2f} GB, end buffers {err:.3e} apart "
        f"(limit {TOL}·{scale:.3e})")
    return out


def check_residual(torch, name: str, state, out: dict, twin: str = "",
                   twin_final=None) -> None:
    """A lossy codec's run leaves a finite, nonzero residual; a lossless
    one (identity, the full delta) ends on its uncompressed twin's buffer
    ``twin_final`` (difference 0.0) with an all-zero residual."""
    res_max = flat_of(torch, state, residual=True).abs().max().item()
    out["residual_max_abs"] = res_max
    check(math.isfinite(res_max), f"path ({name}): non-finite residual")
    if twin_final is None:
        check(res_max > 0.0, f"path ({name}): the lossy codec left no "
                             f"residual")
        return
    final = flat_of(torch, state)
    diff = (final - twin_final.to(final.device)).abs().max().item()
    del final
    out[f"max_abs_diff_to_{twin}"] = diff
    check(diff == 0.0 and res_max == 0.0,
          f"path ({name}): lossless codec ends {diff:.3e} from path "
          f"({twin}), residual max {res_max:.3e} (both must be 0)")
    log(f"[train] path ({name}) ends on path ({twin})'s buffer (difference "
        f"{diff}), residual all zero")


# ---------------------------------------------------------------------------
# Phase 4g: the agent-sharded engine (core/sharded.py) on the card
# ---------------------------------------------------------------------------

# path -> (gossip impl, codec, sweep axis, the kernel it launches once a
# step, the phase-4 path whose end state it must equal): the CLI's default
# run (the tiny LM at full width, 8 agents, ring2, H 5, K 2, 5 steps)
# through train_loop(mesh_agents=1) in a world of one rank over NCCL.
# One shard mixes with no collective; the server's and the loss's
# all-reduce are skipped as well (core/sharded.py).
SHARDED_PATHS = {
    "s1": ("dense", "none", None, None, "a"),
    "s2": ("pallas", "none", None, "gossip_mix", "a"),
    "s3": ("pallas", "int8", None, "gossip_mix", "i"),
    "s4": ("pallas", "none", "h", "gossip_mix_batched", "e"),
}


def twin_check(torch, final, twin, codec: str, residual_max: float) -> dict:
    """A sharded path's end state (gathered whole) against its twin's (a
    CPU tensor, read in column blocks): within TOL·max|x|, and for the
    lossy int8 codec as tests/test_torch_sharded.py holds it (99% of the
    elements within TOL·max|x|, every one within one int8 step
    2·(max|x| + max|e|)/127, ``residual_max`` the twin's max|e|: two
    mixes summed in other orders may round a borderline element of u to
    either side)."""
    cols = 1 << 24

    def blocks():
        for lo in range(0, twin.shape[-1], cols):
            ref = twin[..., lo:lo + cols].to(final.device)
            yield ref, torch.sub(final[..., lo:lo + cols], ref).abs_()

    diff = scale = 0.0
    for ref, err in blocks():
        scale = max(scale, ref.abs().max().item())
        diff = max(diff, err.max().item())
    row = {"max_abs_diff": diff, "scale": scale, "tol": TOL,
           "ok": diff <= TOL * scale}
    if codec == "int8":
        # the share beyond TOL·max|x| needs the whole scale: a second pass
        share = sum(err.gt(TOL * scale).sum().item()
                    for _, err in blocks()) / twin.numel()
        step = 2.0 * (scale + residual_max) / 127.0
        row.update(share_beyond_tol=share, int8_step=step,
                   ok=share <= 0.01 and diff <= step)
    return row


def sharded_phase(torch, finals: dict) -> dict:
    """Each path of SHARDED_PATHS through run_path (a warm-up, then the
    timed run with the counters set to 0 just before it: its kernel once a
    step, nothing else) in a world of one rank over NCCL (a private
    FileStore under build/), its end state held to its flat twin's
    (``finals``, kept on the host by training_phase) by twin_check."""
    import os

    import torch.distributed as dist
    store = ROOT / "build" / f"sharded_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    if store.exists():
        store.unlink()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    out = {}
    try:
        for name, (impl, codec, axis, kernel, twin) in \
                SHARDED_PATHS.items():
            kw = dict(compress=codec, mesh_agents=1)
            if axis is not None:
                kw.update(sweep_axis=axis)
            state, out[name] = run_path(torch, name, impl, False, "sgd",
                                        kernel, **kw)
            final = flat_of(torch, state)
            row = twin_check(torch, final, finals[twin], codec,
                             finals.get("i_residual_max", 0.0))
            diff, scale = row["max_abs_diff"], row["scale"]
            note = (f", {row['share_beyond_tol']:.3e} of it beyond "
                    f"{TOL}·max|x|" if codec == "int8" else "")
            check(row.pop("ok"), f"path ({name}) ends {diff:.3e} from path "
                  f"({twin}) (max|x| {scale:.3e}; {row})")
            out[name].update(row, twin=twin)
            log(f"[sharded] path ({name}) gossip={impl} compress={codec}"
                + (f" sweep={axis}" if axis else "")
                + f" on one NCCL rank: step {out[name]['step_ms']:.1f} ms, "
                f"peak {out[name]['peak_bytes'] / 1e9:.2f} GB, ends "
                f"{diff:.3e} from path ({twin}) (max|x| {scale:.3e}{note})")
            del state, final
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4h: the 2-D ('agents', 'model') engine (core/sharded.py) on the card
# ---------------------------------------------------------------------------

# path -> (gossip impl, codec, A, M, the kernel each rank launches once a
# step, the twin whose end state it must equal): the CLI's default run
# (the tiny LM at full width, 8 agents, ring2, K 2) at MESH2D_LAYERS,
# MESH2D_STEPS steps and H = MESH2D_STEPS (the server fires at the last
# step) through train_loop(mesh_agents=A, mesh_model=M), every
# rank of a gloo world on this one card (NCCL refuses two ranks on one
# device; gloo's collectives take CUDA tensors and stage them through
# the host, its point-to-point ops do not, so the halo paths here have
# one agent shard).  The twins are path (a)'s and path (i)'s runs at the
# same depth on one device, made by the phase.
MESH2D_PATHS = {
    "t1": ("pallas", "none", 1, 2, "gossip_mix", "a"),
    "t2": ("pallas", "int8", 1, 2, "gossip_mix", "i"),
    "t3": ("dense", "none", 2, 2, None, "a"),
}
# the cuts: gloo moves each rank's line-4 gather through host memory at
# about 1 GB/s (on an H100 host: 4.9 s a step at 12 layers, where the
# 4-rank world's host staging passed the machine's 96 GiB; 1.8-3.0 s at
# 1 layer, D 59,181,312, the embedding and head at full width, with some
# 10 s to start a world's ranks and 15-20 s for its first step; PERF.md),
# so the phase runs 1 layer and 2 steps (5 until phase 4i came beside
# it, then 3 until remat made every training path recompute a forward)
MESH2D_LAYERS = 1
MESH2D_STEPS = 2
# the untimed warm-up before a world's first timed run: one step
MESH2D_WARM_STEPS = 1


def _mesh2d_rank(rank: int, world: int, store: str, names: list,
                 twins: dict, out_dir: str, t_spawn: float) -> None:
    """One rank of a phase-4h world: init gloo on this card, a warm-up
    step of the first path (each step moves gigabytes through the host,
    so the first step's one-time costs are small beside it), then each
    path of ``names``: the timed run with the counters set to 0 just
    before it and read just after, and on rank 0 the gathered end state
    against its twin (a file of ``twins``).  ``times`` records the
    host-clock seconds from the parent's spawn (``t_spawn``, wall clock)
    to this rank's start, its group and kernels, and each stage."""
    t_start = time.time()
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops
    times = {"spawn_to_start_s": t_start - t_spawn}
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {"times": times}
    try:
        build.load()     # built by the parent: loaded, not compiled
        times["ready_s"] = time.time() - t_start
        for i, name in enumerate(names):
            t0 = time.time()
            impl, codec, a, m, kernel, twin = MESH2D_PATHS[name]
            kw = dict(compress=codec, mesh_agents=a, mesh_model=m,
                      layers=MESH2D_LAYERS, h=MESH2D_STEPS)
            warm = None if i else train_path(
                torch, impl, False, "sgd", steps=MESH2D_WARM_STEPS, **kw)[3]
            t1 = time.time()
            ops.reset_launch_counts()
            state, losses, timing, peak = train_path(
                torch, impl, False, "sgd", steps=MESH2D_STEPS, **kw)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            t2 = time.time()
            row = {"losses": losses, "counts": counts,
                   "step_ms": 1e3 * timing["loop_s"] / MESH2D_STEPS,
                   "setup_s": timing["setup_s"], "peak_bytes": peak,
                   "warm_up_peak_bytes": warm,
                   "block_bytes": timing["block_bytes"]}
            if rank == 0:
                final = flat_of(torch, state)
                ref = torch.load(twins[twin], mmap=True)
                row["twin"] = twin
                row.update(twin_check(torch, final, ref, codec,
                                      twins.get("i_residual_max", 0.0)))
                del final, ref
            del state
            gc.collect()
            torch.cuda.empty_cache()
            out[name] = row
            dist.barrier()
            times[name] = {"warm_up_s": t1 - t0, "run_s": t2 - t1,
                           "check_s": time.time() - t2}
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def mesh2d_phase(torch) -> dict:
    """MESH2D_PATHS in gloo worlds of A·M ranks on this card (phase 4h):
    first the twins, path (a)'s and (i)'s runs at MESH2D_LAYERS on one
    device, written under build/ for the ranks to read; then one world a
    mesh shape, every path of that shape in it.  Each path: every rank's
    losses finite, its kernel once a step and nothing else, its state
    blocks exactly n/A · D/M · 4 bytes, its end state within TOL·max|x|
    of its twin's (int8 as phase 4g)."""
    import os

    import torch.multiprocessing as mp
    work = ROOT / "build" / f"mesh2d_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    twins, out = {}, {}
    for twin, codec in (("a", "none"), ("i", "int8")):
        state, losses, timing, peak = train_path(
            torch, "pallas", False, "sgd", MESH2D_STEPS, compress=codec,
            layers=MESH2D_LAYERS, h=MESH2D_STEPS)
        if codec == "int8":
            twins["i_residual_max"] = flat_of(torch, state, residual=True
                                              ).abs().max().item()
        twins[twin] = str(work / f"twin_{twin}.pt")
        torch.save(flat_of(torch, state).cpu(), twins[twin])
        out[f"twin_{twin}"] = {"step_ms": 1e3 * timing["loop_s"]
                               / MESH2D_STEPS,
                               "peak_bytes": peak, "losses": losses}
        del state
        torch.cuda.empty_cache()
    d = path_d(MESH2D_LAYERS)
    shapes: dict = {}
    for name, p in MESH2D_PATHS.items():
        shapes.setdefault((p[2], p[3]), []).append(name)
    try:
        for (a, m), names in shapes.items():
            world = a * m
            run_dir = work / f"{a}x{m}"
            run_dir.mkdir(exist_ok=True)
            t0 = time.perf_counter()
            mp.start_processes(
                _mesh2d_rank, args=(world, str(run_dir / "store"), names,
                                    twins, str(run_dir), time.time()),
                nprocs=world, start_method="spawn", join=True)
            wall = time.perf_counter() - t0
            ranks = [json.loads((run_dir / f"rank{r}.json").read_text())
                     for r in range(world)]
            for name in names:
                impl, codec, _, _, kernel, twin = MESH2D_PATHS[name]
                rows = [r[name] for r in ranks]
                block = N_AGENTS // a * (d // m) * 4
                n_blocks = 2 if codec != "none" else 1
                for r, row in enumerate(rows):
                    check(all(math.isfinite(v) for v in row["losses"]),
                          f"path ({name}) rank {r}: non-finite loss")
                    want = {kernel: MESH2D_STEPS} if kernel else {}
                    check(row["counts"] == want,
                          f"path ({name}) rank {r}: launches "
                          f"{row['counts']}, want {want}")
                    check(row["block_bytes"] == [block] * n_blocks,
                          f"path ({name}) rank {r}: state blocks "
                          f"{row['block_bytes']} bytes, want "
                          f"{n_blocks} of n/A·D/M·4 = {block}")
                head = rows[0]
                check(head["ok"], f"path ({name}) ends "
                      f"{head['max_abs_diff']:.3e} from path ({twin}) "
                      f"(max|x| {head['scale']:.3e}; {head})")
                out[name] = {
                    "impl": impl, "codec": codec, "mesh": [a, m],
                    "layers": MESH2D_LAYERS, "d": d,
                    "steps": MESH2D_STEPS, "kernel": kernel,
                    "launches": [r["counts"].get(kernel, 0) if kernel else 0
                                 for r in rows],
                    "step_ms": max(r["step_ms"] for r in rows),
                    "step_ms_by_rank": [r["step_ms"] for r in rows],
                    "setup_s_by_rank": [r["setup_s"] for r in rows],
                    "peak_bytes_by_rank": [r["peak_bytes"] for r in rows],
                    "block_bytes": block, "losses": head["losses"],
                    "world_wall_s": wall, "rank0_times": ranks[0]["times"],
                    **{k: head[k] for k in ("twin", "max_abs_diff", "scale",
                                            "tol", "share_beyond_tol",
                                            "int8_step") if k in head}}
                note = (f", {head['share_beyond_tol']:.3e} of it beyond "
                        f"{TOL}·max|x|" if codec == "int8" else "")
                log(f"[mesh2d] path ({name}) gossip={impl} compress={codec} "
                    f"layers={MESH2D_LAYERS} (D {d:,}) steps="
                    f"{MESH2D_STEPS} on a {a} x {m} gloo "
                    f"world on one card: step "
                    f"{out[name]['step_ms']:.1f} ms (host-staged gloo "
                    f"collectives), {kernel or 'no kernel'} launches "
                    f"{out[name]['launches']} a rank, state "
                    f"{block / 1e9:.3f} GB a rank, peaks "
                    + "/".join(f"{b / 1e9:.2f}"
                               for b in out[name]["peak_bytes_by_rank"])
                    + f" GB, ends {head['max_abs_diff']:.3e} from path "
                    f"({twin}) (max|x| {head['scale']:.3e}{note}); world "
                    f"{wall:.1f} s (rank 0: started "
                    f"{ranks[0]['times']['spawn_to_start_s']:.1f} s after "
                    f"the spawn, ready {ranks[0]['times']['ready_s']:.1f} s "
                    f"later; this path's warm-up, run, check "
                    + ", ".join(f"{v:.1f}" for v in
                                ranks[0]["times"][name].values())
                    + " s)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4i: the tensor-parallel tree engine (core/sharded.py
# make_sharded_tree_step) on the card
# ---------------------------------------------------------------------------

# path -> (arch, A, M, agents, layers, gossip impl): the zoo config at its
# published widths with its depth cut to ``layers`` and f32 compute (so
# that the twin check is at TOL; the tensor-parallel sums run in another
# order than the one-device products), the tree engine's leaves placed by
# sharding.param_pspecs over an (A, M) ('agents', 'model') mesh, every rank
# of a gloo world on this one card (NCCL refuses two ranks on one device;
# gloo's collectives take CUDA tensors and stage them through the host,
# its point-to-point ops do not: the permute gossip is held on the CPU by
# tests/test_torch_tensor_parallel.py).  (p1): #1 once per leaf block a
# step on each rank; (p3): Gemma3-12B at the 6 layers that hold its first
# global one (global_every 6), #1 likewise; (p2): dense gossip over two
# agent shards (the own-block partials reduce-scattered through gloo), at
# one layer, where each step moves the embedding's and the head's
# (4, 194,478,080) partials through the host; (p4): DeepSeek-V2-Lite at
# its dense first layer and two MoE layers (as path (D1)), MLA on the
# rank's heads and the MoE on its 32 of the 64 experts, #1 once per leaf
# block a step.
TP_PATHS = {
    "p1": ("qwen1.5-4b", 1, 2, 2, 8, "pallas"),
    "p2": ("qwen1.5-4b", 2, 2, 4, 1, "dense"),
    "p3": ("gemma3-12b", 1, 2, 2, 6, "pallas"),
    "p4": ("deepseek-v2-lite-16b", 1, 2, 2, 3, "pallas"),
}
# TP_STEPS at H TP_STEPS (the server fires at the last), batch 2 × S 128
# a step as phase 4c's paths, η 1e-3; the first step is untimed.  A world
# and its twin do not fit on the card together ((p3): 59 GB of ranks
# beside the twin's 58 GB), so the world runs first and hands its end
# blocks to the parent, then the twin runs
TP_STEPS, TP_BATCH, TP_SEQ, TP_LR = 5, 2, 128, 1e-3
TP_INIT_SEED, TP_SEED = 30, 31
# (p2) at 2 steps, H 2, for the script's time: each of its steps moves
# 3.46 GB a rank through gloo's host staging (9-20 s a step)
TP_STEPS_BY_PATH = {"p2": 2}


def tp_steps(name: str) -> int:
    return TP_STEPS_BY_PATH.get(name, TP_STEPS)


def tp_config(arch: str, layers: int):
    import dataclasses

    import torch
    return dataclasses.replace(path_config(arch, layers, False),
                               compute_dtype=torch.float32)


def tp_fed(name: str):
    """(the model's config, FedDecConfig) of a TP path: ring2, H = the
    steps, K 2."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.launch import train
    arch, _, _, n, layers, impl = TP_PATHS[name]
    cfg = tp_config(arch, layers)
    fed = FedConfig(n_agents=n, h=tp_steps(name), k=2, graph="ring2",
                    gossip_impl=impl)
    return cfg, train.build_fed_setup(cfg, train.fed_axes(fed), fed)[0]


def tp_batches(torch, name: str, rows: slice, device) -> list:
    """The TP_STEPS batches of a path (tokens from a CPU generator,
    uniform in the vocabulary), ``rows`` of the agents, on ``device``."""
    arch, _, _, n, layers, _ = TP_PATHS[name]
    vocab = tp_config(arch, layers).vocab_size
    gen = torch.Generator().manual_seed(TP_SEED + 1)
    tokens = torch.randint(0, vocab, (tp_steps(name), n, TP_BATCH, TP_SEQ),
                           generator=gen)[:, rows]
    positions = torch.arange(TP_SEQ).expand(tokens.shape)
    return [{"tokens": tokens[t].to(device),
             "positions": positions[t].contiguous().to(device)}
            for t in range(tp_steps(name))]


def tp_program(torch, name: str, device, mesh) -> dict:
    """A TP path's program on this rank of ``mesh``: the config adapted
    to the mesh (launch/steps.adapt_for_mesh), the leaves' specs, this
    rank's coordinates and blocks of every agent's start (one agent's
    init cut to its blocks, then repeated over the rank's agents; shapes
    only on meta), and make_sharded_tree_step's step, draws and
    batches."""
    from repro_torch import sharding as shd
    from repro_torch.core import feddec, sharded
    from repro_torch.core.draws import Draws, ShapeDraws
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.sharding import tp
    from repro_torch.tree import build_tree
    _, a, m, n, _, _ = TP_PATHS[name]
    cfg, fcfg = tp_fed(name)
    axes = tp.mesh_axes(mesh)
    tcfg = steps.adapt_for_mesh(cfg, axes)
    model = build_model(tcfg)
    nl = n // a
    coords = {"agents": (int(mesh.get_local_rank("agents")), a),
              "model": (int(mesh.get_local_rank("model")), m)}
    specs = shd.param_pspecs(tcfg, feddec.init_state(
        model.init_shapes(), n).params, axes)
    meta = torch.device(device).type == "meta"
    draws = ShapeDraws("meta") if meta else Draws(TP_SEED, device)
    params = model.init_shapes() if meta \
        else model.init(Draws(TP_INIT_SEED, device))
    blocks = {}
    for path, spec in _sorted_specs(specs):
        leaf = _pop_leaf(params, path)
        blk = tp.block_at(leaf[None], (None,) + tuple(spec[1:]), coords)
        blocks[path] = blk.expand((nl,) + tuple(blk.shape[1:])).clone()
        del leaf, blk
    state = feddec.FedState(params=build_tree(list(blocks), list(
        blocks.values())), step=1)
    del blocks
    eta = torch.full((1,), TP_LR, device=device)
    step = sharded.make_sharded_tree_step(
        fcfg, model.grad_fn(), lambda t: eta, mesh, device=device,
        param_specs=specs)
    rows = slice(coords["agents"][0] * nl, (coords["agents"][0] + 1) * nl)
    batches = [{k: torch.empty((nl, TP_BATCH, TP_SEQ), dtype=torch.long,
                               device="meta") for k in ("tokens",
                                                        "positions")}] \
        if meta else tp_batches(torch, name, rows, device)
    return {"step": step, "state": state, "draws": draws,
            "batches": batches, "specs": specs, "coords": coords,
            "n_local": nl, "cfg": tcfg}


def _sorted_specs(specs) -> list:
    from repro_torch.tree import sorted_leaves
    return list(sorted_leaves(specs))


def _pop_leaf(tree: dict, path: tuple):
    """The leaf at ``path``, removed from ``tree`` (so that its storage
    goes once its block is cut)."""
    node = tree
    for key in path[:-1]:
        node = node[key]
    return node.pop(path[-1])


def tp_expected_bytes(prog: dict) -> int:
    """Σ over leaves of (n/A)·numel/M_leaf f32 elements × 4 bytes."""
    from repro_torch.core import feddec
    from repro_torch.models import build_model
    from repro_torch.sharding import tp
    from repro_torch.tree import leaves
    sizes = {k: s for k, (_, s) in prog["coords"].items()}
    shapes = leaves(feddec.init_state(build_model(prog["cfg"]).init_shapes(),
                                      prog["n_local"] * sizes["agents"]
                                      ).params)
    return 4 * sum(tp.block_numel(tuple(s.shape), sp, sizes)
                   for s, (_, sp) in zip(shapes, _sorted_specs(
                       prog["specs"])))


def tp_twin(torch, name: str) -> tuple:
    """The one-device twin of a TP path: core/feddec.make_feddec_step on
    this card with the same config (not adapted: one device), start,
    draws and batches, TP_STEPS steps.  Returns (its row, its end state:
    the leaves on the card by their '/'-joined paths)."""
    from repro_torch.core import feddec
    from repro_torch.core.draws import Draws
    from repro_torch.models import build_model
    from repro_torch.tree import sorted_leaves
    n = TP_PATHS[name][3]
    cfg, fcfg = tp_fed(name)
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = feddec.init_state(model.init(Draws(TP_INIT_SEED, DEVICE)), n)
    eta = torch.full((1,), TP_LR, device=DEVICE)
    step = feddec.make_feddec_step(fcfg, model.grad_fn(), lambda t: eta,
                                   device=DEVICE)
    draws = Draws(TP_SEED, DEVICE)
    losses, times = [], []
    for batch in tp_batches(torch, name, slice(None), DEVICE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch, draws)
        losses.append(met["loss"].item())
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    final = {"/".join(p): leaf for p, leaf in sorted_leaves(state.params)}
    return {"losses": losses, "peak_bytes": peak,
            "step_ms": 1e3 * sum(times[1:]) / (tp_steps(name) - 1)}, final


def _tp_rank(rank: int, world: int, store: str, names: list, handoff,
             dones: dict, out_dir: str, t_spawn: float) -> None:
    """One rank of a phase-4i world: init gloo on this card, then each
    path of ``names`` (one mesh shape): its program (tp_program),
    TP_STEPS steps with the counters set to 0 just before the first and
    read after the last (the first step untimed), the rank's state bytes;
    then it hands its end blocks to the parent (CUDA IPC through
    ``handoff``) and waits for the path's ``dones`` event, the parent's
    copy of them; (p1) then takes one more step under
    trace_analysis.tally (phase 8 reads rank 0's)."""
    t_start = time.time()
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.launch.trace_analysis import tally
    from repro_torch.tree import sorted_leaves
    times = {"spawn_to_start_s": t_start - t_spawn}
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {}
    try:
        build.load()     # built by the parent: loaded, not compiled
        _, a, m, *_ = TP_PATHS[names[0]]
        mesh = make_fed_mesh(a, m, device=DEVICE)
        times["ready_s"] = time.time() - t_start
        for name in names:
            out[name] = _tp_rank_path(torch, name, mesh, rank, handoff,
                                      dones[name], ops, tally,
                                      sorted_leaves)
    finally:
        dist.destroy_process_group()
    out["times"] = times
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def _tp_rank_path(torch, name, mesh, rank, handoff, done, ops, tally,
                  sorted_leaves) -> dict:
    """One path of a phase-4i rank (see _tp_rank): its row."""
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prog = tp_program(torch, name, DEVICE, mesh)
    blocks = [leaf for _, leaf in sorted_leaves(prog["state"].params)]
    row = {"block_bytes": sum(b.untyped_storage().nbytes() for b in blocks),
           "elem_bytes": sum(b.numel() * b.element_size() for b in blocks),
           "expected_bytes": tp_expected_bytes(prog),
           "n_leaves": len(blocks)}
    del blocks
    state, step, draws = prog["state"], prog["step"], prog["draws"]
    t1 = time.time()
    ops.reset_launch_counts()
    losses, step_s = [], []
    for batch in prog["batches"]:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, met = step(state, batch, draws)
        losses.append(met["loss"].item())
        step_s.append(time.perf_counter() - ts)
    row.update(losses=losses,
               counts={k: v for k, v in ops.launch_counts().items() if v},
               step_ms=1e3 * sum(step_s[1:]) / (tp_steps(name) - 1),
               first_step_ms=1e3 * step_s[0],
               peak_bytes=torch.cuda.max_memory_allocated())
    t2 = time.time()
    del prog["state"]
    gc.collect()
    torch.cuda.empty_cache()
    # CUDA IPC takes no tensor of an expandable segment where the OS
    # kernel lacks pidfd_open (the H100 host's does): the handed blocks
    # are copies made in ordinary segments
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    handoff.put((name, rank, {"/".join(p): leaf.clone() for p, leaf in
                              sorted_leaves(state.params)}))
    done.wait()
    # the parent has dropped the copies: free them here too, so that
    # (p1)'s tallied step below starts from this rank's own bytes
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    t3 = time.time()
    if name == "p1":
        # phase 8's record: one more step under the tally, from the state
        # the steps left (the server does not fire at it)
        batch = prog["batches"][0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res, costs = tally(step, state, batch, draws)
        torch.cuda.synchronize()
        row["tally"] = {
            "ops": costs.ops, "flops": costs.flops,
            "traffic_bytes": costs.traffic_bytes,
            "launches": {k: v for k, v in ops.launch_counts().items() if v},
            "tally_launches": costs.launches,
            "collective_counts": costs.collective_counts,
            "peak_above_args": torch.cuda.max_memory_allocated() - base}
        del res
    del state, prog, step
    gc.collect()
    torch.cuda.empty_cache()
    row["times"] = {"setup_s": t1 - t0, "run_s": t2 - t1,
                    "handoff_s": t3 - t2}
    return row


def tp_handoff(torch, pc, handoff, name: str, world: int) -> dict:
    """Every rank's end blocks of path ``name`` (CUDA IPC), copied to
    host memory as they arrive: {rank: {leaf path: tensor}}.  A rank
    that fails raises here (``pc.join`` between waits)."""
    import queue
    got: dict = {}
    while len(got) < world:
        try:
            path, rank, blocks = handoff.get(timeout=5)
        except queue.Empty:
            pc.join(timeout=0)
            continue
        check(path == name, f"[tp] rank {rank} handed path ({path}) while "
                            f"({name}) was due")
        got[rank] = {k: v.cpu() for k, v in blocks.items()}
        del blocks
    return got


def tp_twin_check(torch, name: str, final: dict, blocks: dict) -> tuple:
    """(max |rank block − the twin's block|, max |twin|) over every rank
    and leaf: each rank's blocks (host memory) against its blocks cut
    from the twin's end state (on the card) by the leaves' specs."""
    from repro_torch import sharding as shd
    from repro_torch.core import feddec
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.sharding import tp
    _, a, m, n, _, _ = TP_PATHS[name]
    cfg, _ = tp_fed(name)
    axes = shd.MeshAxes(("agents",), "model", {"agents": a, "model": m})
    tcfg = steps.adapt_for_mesh(cfg, axes)
    specs = dict(_sorted_specs(shd.param_pspecs(tcfg, feddec.init_state(
        build_model(tcfg).init_shapes(), n).params, axes)))
    err = scale = 0.0
    for rank, mine in blocks.items():
        coords = {"agents": (rank // m, a), "model": (rank % m, m)}
        for key, blk in mine.items():
            want = tp.block_at(final[key], specs[tuple(key.split("/"))],
                               coords)
            err = max(err, (blk.to(want.device) - want).abs().max().item())
            scale = max(scale, want.abs().max().item())
            del want
    return err, scale


def tp_path_rows(torch, name: str, ranks: list, blocks: dict,
                 wall: float) -> dict:
    """A TP path's twin (tp_twin) against the ranks' handed blocks and
    its checks, log line and rows ({name: row, name_twin: the twin's})."""
    arch, a, m, n, layers, impl = TP_PATHS[name]
    steps = tp_steps(name)
    t0 = time.perf_counter()
    twin, final = tp_twin(torch, name)
    err, scale = tp_twin_check(torch, name, final, blocks)
    del final, blocks
    gc.collect()
    torch.cuda.empty_cache()
    twin["wall_s"] = time.perf_counter() - t0
    rows = [r[name] for r in ranks]
    kernel = "gossip_mix" if impl == "pallas" else None
    head = rows[0]
    for r, row in enumerate(rows):
        check(all(math.isfinite(v) for v in row["losses"])
              and row["losses"] == head["losses"],
              f"path ({name}) rank {r}: losses {row['losses']}, rank 0's "
              f"{head['losses']}")
        want = {kernel: steps * row["n_leaves"]} if kernel else {}
        check(row["counts"] == want, f"path ({name}) rank {r}: launches "
                                     f"{row['counts']}, want {want}")
        check(row["block_bytes"] == row["elem_bytes"]
              == row["expected_bytes"],
              f"path ({name}) rank {r}: state {row['block_bytes']} B in "
              f"storages, {row['elem_bytes']} B of elements, want Σ "
              f"(n/A)·numel/M_leaf·4 = {row['expected_bytes']}")
    check(err <= TOL * scale, f"path ({name}) ends {err:.3e} from its twin "
                              f"> {TOL}·{scale:.3e}")
    out = {
        "arch": arch, "mesh": [a, m], "agents": n, "layers": layers,
        "impl": impl, "kernel": kernel, "steps": steps,
        "batch": TP_BATCH, "seq": TP_SEQ,
        "launches": [r["counts"].get(kernel, 0) if kernel else 0
                     for r in rows],
        "leaves": head["n_leaves"],
        "step_ms": max(r["step_ms"] for r in rows),
        "step_ms_by_rank": [r["step_ms"] for r in rows],
        "first_step_ms_by_rank": [r["first_step_ms"] for r in rows],
        "peak_bytes_by_rank": [r["peak_bytes"] for r in rows],
        "state_bytes_by_rank": [r["block_bytes"] for r in rows],
        "losses": head["losses"], "max_abs_diff": err, "scale": scale,
        "tol": TOL, "twin": twin, "world_wall_s": wall,
        "rank0_times": {**ranks[0]["times"], **head["times"]}}
    if "tally" in head:
        out["tally"] = head["tally"]
    log(f"[tp] path ({name}) {arch} at published widths, {layers} "
        f"layer{'s' if layers > 1 else ''}, f32 compute, {n} agents on a "
        f"{a} x {m} gloo world on one card, gossip={impl}, {steps} "
        f"steps: step {out['step_ms']:.1f} ms (host clock, steps 2-"
        f"{steps}; the twin {twin['step_ms']:.1f} ms), "
        f"{kernel or 'no kernel'} launches {out['launches']} a rank "
        f"({head['n_leaves']} leaves × {steps} steps), state "
        + "/".join(f"{b / 1e9:.3f}" for b in out["state_bytes_by_rank"])
        + " GB a rank (exactly its blocks), peaks "
        + "/".join(f"{b / 1e9:.2f}" for b in out["peak_bytes_by_rank"])
        + f" GB (the twin {twin['peak_bytes'] / 1e9:.2f} GB), ends "
        f"{err:.3e} from its twin (max|x| {scale:.3e}); its world "
        f"{wall:.1f} s (rank 0: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["rank0_times"].items())
        + f" s), twin and check {twin['wall_s']:.1f} s")
    return {name: out, f"{name}_twin": twin}


def tp_phase(torch) -> dict:
    """TP_PATHS (phase 4i), a gloo world of A·M ranks on this card a mesh
    shape, every path of that shape in it, first: the world hands each
    path's end blocks to this process (kept in host memory); then each
    path's one-device twin (tp_twin) on the card the world has left.
    Each path: every rank's losses finite and equal, #1 once per leaf
    block a step under 'pallas' and no kernel under 'dense', its state
    exactly its blocks' bytes (Σ (n/A)·numel/M_leaf · 4), its end blocks
    within TOL·max|x| of the twin's."""
    import os

    import torch.multiprocessing as mp
    work = ROOT / "build" / f"tp_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    shapes: dict = {}
    for name, p in TP_PATHS.items():
        shapes.setdefault((p[1], p[2]), []).append(name)
    env = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    # the ranks' allocators map what they use: four ranks' caches beside
    # each other on one card left 6 GB a rank reserved and unused
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    ctx = mp.get_context("spawn")
    try:
        for (a, m), names in shapes.items():
            world = a * m
            run_dir = work / f"{a}x{m}"
            run_dir.mkdir(exist_ok=True)
            handoff = ctx.Queue()
            dones = {name: ctx.Event() for name in names}
            t0 = time.perf_counter()
            pc = mp.start_processes(
                _tp_rank, args=(world, str(run_dir / "store"), names,
                                handoff, dones, str(run_dir), time.time()),
                nprocs=world, start_method="spawn", join=False)
            blocks = {}
            try:
                for name in names:
                    blocks[name] = tp_handoff(torch, pc, handoff, name, world)
                    dones[name].set()
            finally:
                for done in dones.values():
                    done.set()
            while not pc.join():
                pass
            wall = time.perf_counter() - t0
            torch.cuda.ipc_collect()
            ranks = [json.loads((run_dir / f"rank{r}.json").read_text())
                     for r in range(world)]
            for name in names:
                out.update(tp_path_rows(torch, name, ranks,
                                        blocks.pop(name), wall))
    finally:
        if env is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = env
        shutil.rmtree(work, ignore_errors=True)
    log("[tp] make_permute_gossip(leaf_specs=...) is held on the CPU only "
        "(tests/test_torch_tensor_parallel.py against the reference's): "
        "it is point-to-point, gloo's batch_isend_irecv refuses CUDA "
        "tensors, and NCCL refuses two ranks on this one card")
    return out


# ---------------------------------------------------------------------------
# Phase 4f: the bf16 configs' training paths (bf16 flat buffers)
# ---------------------------------------------------------------------------

# path -> (gossip impl, fuse, optimizer, the kernel it launches once a
# step, train_path's options).  Both configs have the reference's
# replicated agent layout: the trainer trains fed_n_agents_replicated of
# them whatever --agents says (sharding.n_agents_for), 4 for Mistral and 1
# for DeepSeek-V3, and ``agents`` below says so.  (M1) Mistral-Large-123B
# at its published widths with 1 of its 88 layers (2,189,451,264
# parameters, a 4.38 GB bf16 row; 4 rows at 2 layers would need about
# 80 GB by the 2-row peaks of 42.92 GB at 2 layers and 59.53 GB at 3),
# fused sgd, #3 in bf16; (M2) DeepSeek-V3-671B with its 3 leading dense
# layers (3,603,802,112 parameters; an MoE layer is 23.0 GB of bf16
# weights a row), one row, #1 in bf16.  Batch 1, S 512.
BF16_PATHS = {
    "M1": ("pallas", True, "sgd", "update_mix",
           dict(arch="mistral-large-123b", layers=1, agents=4, batch=1,
                seq=512)),
    "M2": ("pallas", False, "sgd", "gossip_mix",
           dict(arch="deepseek-v3-671b", layers=3, agents=1, batch=1,
                seq=512)),
}
# bf16_flat_check's column block: the plain version's f32 temporaries of
# 2 × 2^27 columns (1.1 GB each) beside the three bf16 buffers
BF16_FLAT_COLS = 1 << 27


def bf16_path_phase(torch) -> dict:
    """(M1) and (M2) through run_path: finite losses, the kernel once a
    step and nothing else, and a bf16 flat buffer (so the launches were
    the kernel's bf16 variant); then that kernel on a buffer of the path's
    own shape against its plain version (bf16_flat_check)."""
    out = {}
    for name, (impl, fuse, opt, kernel, kw) in BF16_PATHS.items():
        state, out[name] = run_path(torch, name, impl, fuse, opt, kernel,
                                    **kw)
        flat = flat_of(torch, state)
        check(flat.dtype == torch.bfloat16,
              f"path ({name}): the flat buffer is {flat.dtype}, not bf16")
        shape = tuple(flat.shape)
        out[name].update(buffer_dtype=str(flat.dtype),
                         buffer_shape=list(shape))
        log(f"[train] path ({name}): {shape[0]} × {shape[1]:,} "
            f"{flat.dtype} buffer")
        del state, flat
        torch.cuda.empty_cache()
        out[name]["flat_check"] = bf16_flat_check(torch, kernel, *shape)
    return out


def bf16_flat_check(torch, kernel: str, n: int, d: int) -> dict:
    """#3 (sgd) or #1 on a random bf16 (n, d) buffer, d past 2^31 columns
    as on (M1) and (M2), against its plain version in column blocks of
    BF16_FLAT_COLS (the mix is column by column, so a block's plain
    version is that block of the whole one's), each held by check_bf16.
    The comparison's launch is not a path's: run_path resets the counts
    before a path."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(n * 131 + d)
    x = torch.randn(n, d, device=DEVICE, generator=gen, dtype=torch.bfloat16)
    w = torch.rand(n, n, device=DEVICE, generator=gen)
    w = w / w.sum(dim=1, keepdim=True)
    if kernel == "update_mix":
        g = torch.randn(n, d, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        eta = torch.tensor([0.05], device=DEVICE)
        got = ops.update_mix(w, x, g, eta)

        def plain(sl):
            return ref.update_mix(w, x[:, sl], g[:, sl], eta)
    else:
        got = ops.gossip_mix(w, x)

        def plain(sl):
            return ref.gossip_mix(w, x[:, sl])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    err = differing = 0.0
    for lo in range(0, d, BF16_FLAT_COLS):
        sl = slice(lo, lo + BF16_FLAT_COLS)
        e, share = check_bf16(torch, got[:, sl], plain(sl), kernel,
                              f"bf16 {kernel} n={n} D={d} columns {lo}:")
        err = max(err, e)
        differing += share * got[:, sl].numel()
    share = differing / got.numel()
    check(share <= BF16_Y_SHARE,
          f"bf16 {kernel} n={n} D={d}: {share:.3e} of y differs")
    del x, got
    torch.cuda.empty_cache()
    log(f"[train] bf16 {kernel} n={n} D={d:,} (a bf16 path's buffer) "
        f"against its plain version in {BF16_FLAT_COLS}-column blocks: "
        f"err {err:.3e}, y differs in {share:.3e} of its elements "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"shape": [n, d], "max_abs_err": err, "y_share_differing": share}


# ---------------------------------------------------------------------------
# Phase 4c: the tree engine, adamw and the zoo configs
# ---------------------------------------------------------------------------


def tree_phase(torch, a_final) -> dict:
    """Paths (r)-(w) (TREE_PATHS), each through run_path; (r), the
    per-step default (the tree engine), must end within TOL·max|x| of path
    (a)'s flat buffer ``a_final`` (the same seed and draws), (t)'s int8
    leaves a nonzero residual, and (v) and (w) end within TOL·max|x| of
    their own run with the plain dense mix.  Then (D2) and (D3) through
    the engine API (engine_step)."""
    out = {}
    for name, (impl, fuse, opt, kernel, per_step, kw) in TREE_PATHS.items():
        state, out[name] = run_path(torch, name, impl, fuse, opt, kernel,
                                    per_step=per_step, **kw)
        check(type(state).__name__ == "FedState",
              f"path ({name}): train_loop returned a "
              f"{type(state).__name__}, not a FedState")
        if name == "r":
            final = flat_of(torch, state)
            err = (final - a_final.to(final.device)).abs().max().item()
            scale = a_final.abs().max().item()
            del final
            out[name].update(max_abs_diff_to_a=err, scale=scale)
            check(err <= TOL * scale,
                  f"path (r) (tree, per-step) ends {err:.3e} from path "
                  f"(a) (flat, fused) > {TOL}·{scale:.3e}")
            log(f"[train] path (r) ends {err!r} from path (a)'s buffer "
                f"(limit {TOL}·{scale:.3e})")
        if name == "t":
            check_residual(torch, name, state, out[name])
        if name == "D1":
            out[name]["aux"] = moe_aux_check(torch, state, kw)
        if name in ("v", "w"):
            final = flat_of(torch, state)
            if name == "v":
                check(tuple(final.shape) == MAMBA2_FLAT,
                      f"path (v): buffer {tuple(final.shape)}, phase 3 "
                      f"checked #1 at {MAMBA2_FLAT}")
            out[f"{name}_dense"] = dense_rerun(torch, name, final, **kw)
            del final
        del state
        torch.cuda.empty_cache()
    for seed, (name, arch) in enumerate(ENGINE_STEPS.items()):
        out[name] = engine_step(torch, name, arch, seed)
    return out


def engine_step(torch, name: str, arch: str, seed: int) -> dict:
    """(D2)/(D3): ``arch`` at full width and depth through the engine
    API, as the reference trains it (tests/test_arch_smoke.py:63-86):
    core/feddec.make_feddec_step on the tree, ENGINE_AGENTS agents on a
    ring, H 2, K 2 (the server fires at the first step), gossip on #1,
    each step's batch a launch/specs.concrete_batch of batch 1 and
    ENGINE_SEQ tokens (and as many encoder frames).  An untimed step,
    then the timed one with the launch counters set to 0 just before it:
    #1 once per leaf a step and no other kernel, finite losses, more than
    half of agent 0's leaves moved from the init, the step's time and
    peak."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import feddec
    from repro_torch.core.draws import Draws
    from repro_torch.kernels import ops
    from repro_torch.launch import specs, train
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(arch)
    model = build_model(cfg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    draws = Draws(seed, DEVICE)
    params = model.init(draws)
    state = feddec.init_state(params, ENGINE_AGENTS)
    start = tree_map(lambda x: x.cpu(), params)     # agent 0's start
    n_leaves = len(leaves(params))
    del params
    fed = FedConfig(n_agents=ENGINE_AGENTS, h=2, k=2, graph="ring2",
                    gossip_impl="pallas")
    fcfg, _ = train.build_fed_setup(cfg, train.fed_axes(fed), fed)
    eta = torch.full((1,), 1e-3, device=DEVICE)
    step = feddec.make_feddec_step(fcfg, model.grad_fn(), lambda t: eta,
                                   device=DEVICE)

    def batch():
        return specs.concrete_batch(cfg, ENGINE_AGENTS, 1, ENGINE_SEQ, draws)

    first = batch()
    check(set(first) == set(specs.batch_schema(cfg, ENGINE_AGENTS, 1,
                                                ENGINE_SEQ)),
          f"({name}): batch keys {sorted(first)}")
    state, met = step(state, first, draws)
    losses = [met["loss"].item()]
    del first
    nxt = batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, met = step(state, nxt, draws)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses.append(met["loss"].item())
    check(all(math.isfinite(v) for v in losses),
          f"({name}): non-finite loss {losses}")
    check(counts["gossip_mix"] == n_leaves
          and sum(counts.values()) == n_leaves,
          f"({name}): launched {counts}, expected gossip_mix × {n_leaves}")
    new = leaves(state.params)
    finite = all(bool(torch.isfinite(x).all()) for x in new)
    moved = sum(not torch.allclose(a, b[0].cpu())
                for a, b in zip(leaves(start), new))
    check(finite and moved > n_leaves // 2,
          f"({name}): finite {finite}, {moved} of {n_leaves} leaves moved")
    row = {"arch": arch, "agents": ENGINE_AGENTS, "batch": 1,
           "seq": ENGINE_SEQ, "params": cfg.num_params(), "layers":
           cfg.num_layers, "kernel": "gossip_mix", "launches": n_leaves,
           "launches_per_step": n_leaves, "losses": losses,
           "step_ms": step_ms, "peak_bytes": peak, "leaves_moved": moved,
           "leaves": n_leaves, "inputs": sorted(nxt)}
    log(f"[train] path ({name}) {arch} at full width and depth through "
        f"make_feddec_step: {ENGINE_AGENTS} agents, batch 1, S "
        f"{ENGINE_SEQ}, inputs {row['inputs']}: loss {losses[0]:.4f} → "
        f"{losses[1]:.4f}, gossip_mix launches {n_leaves} (one per leaf), "
        f"{moved} of {n_leaves} leaves moved; step {step_ms:.1f} ms (host "
        f"clock, synchronized, after an untimed step), peak "
        f"{peak / 1e9:.2f} GB")
    del state, start, nxt, met, step
    torch.cuda.empty_cache()
    return row


def moe_aux_check(torch, state, kw: dict) -> dict:
    """Path (D1)'s loss carries the MoE aux term: on agent 0's final
    weights and one (1, 128) token draw, Model.loss less the same loss
    with router_aux_weight 0 is router_aux_weight · aux, aux > 0 (the two
    cross entropies are one computation)."""
    import dataclasses
    from repro_torch.models import build_model, transformer
    from repro_torch.tree import tree_map
    cfg = path_config(kw["arch"], kw["layers"], False)
    params = tree_map(lambda x: x[0], state.params)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 128),
                                     generator=gen, device=DEVICE),
             "positions": torch.arange(128, device=DEVICE)[None]}
    no_aux = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0))
    with torch.inference_mode():
        loss = build_model(cfg).loss(params, batch).item()
        ce = build_model(no_aux).loss(params, batch).item()
        aux = transformer.forward(params, batch, cfg)[1].item()
    w = cfg.moe.router_aux_weight
    check(math.isfinite(loss) and aux > 0
          and abs(loss - ce - w * aux) <= 1e-2 * w * aux,
          f"path (D1): loss {loss!r} − cross entropy {ce!r} is not "
          f"{w}·aux {aux!r}")
    log(f"[train] path (D1) agent 0: loss {loss:.6f} = cross entropy "
        f"{ce:.6f} + {w}·aux {aux:.6f}")
    return {"loss": loss, "cross_entropy": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Phase 4d: the delta parameterization (--delta)
# ---------------------------------------------------------------------------


def initial_row(torch, **kw) -> "torch.Tensor":
    """The trainer's initial row z^1 for train_path's options ``kw`` (the
    base row of its delta): a 0-step run of the same seed and draws,
    whose buffer holds z^1 in every row."""
    state = train_path(torch, "dense", False, "sgd", steps=0, **kw)[0]
    row = flat_of(torch, state)[0].clone()
    del state
    return row


def delta_codec_check(torch, name: str, u, spec_str: str, base) -> dict:
    """Path ``name``'s final u through its delta codec (base row ``base``)
    on the card and on the CPU: the decoded rows must be equal element
    for element.  u is freed on the card before the CPU's call."""
    from repro_torch.core import delta as delta_lib
    d = u.shape[1]
    codec = delta_lib.make_delta_codec(spec_str, base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = codec.decode(codec.encode(None, u), u.dtype, d)
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    s_card, u_cpu = s.cpu(), u.cpu()
    del s, u
    cpu_codec = delta_lib.make_delta_codec(spec_str, base.cpu())
    t0 = time.perf_counter()
    s_cpu = cpu_codec.decode(cpu_codec.encode(None, u_cpu), u_cpu.dtype, d)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    differ = int((s_card != s_cpu).sum())
    moved = int((s_card != base.cpu()[None]).sum())
    check(differ == 0,
          f"path ({name}): the {spec_str} codec on the card differs from "
          f"the CPU's in {differ} elements")
    out = {"codec": spec_str, "elements": s_cpu.numel(), "differ": differ,
           "kept_nonzero": moved, "card_ms": card_ms, "cpu_ms": cpu_ms}
    log(f"[delta] path ({name}) final u through {spec_str} on the card and "
        f"the CPU: {differ} of {s_cpu.numel():,} elements differ, "
        f"{moved:,} off the base; card {card_ms:.1f} ms (host clock), CPU "
        f"{cpu_ms:.1f} ms")
    return out


def lowrank_cost(torch) -> dict:
    """One lowrank:8 encode+decode of one full-width tiny-LM row (D_FULL,
    the (12,336, 12,688) reshape) on the card, timed (host clock,
    synchronized) after a small SVD has set the solver up, on a delta of
    rank 8 (LOWRANK_SCALE) plus unit noise; ‖u − s‖²_F must equal
    ‖u − b‖²_F − Σ_{i≤8} σ_i² (σ_i: the norms of the payload's U·Σ
    columns) within LOWRANK_RTOL."""
    from repro_torch.core import delta as delta_lib
    d1, d2 = delta_lib.factor_dims(D_FULL)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(21)
    b = torch.randn(D_FULL, device=DEVICE, generator=gen)
    u = torch.randn(d1, LOWRANK_RANK, device=DEVICE, generator=gen) @ \
        torch.randn(LOWRANK_RANK, d2, device=DEVICE, generator=gen)
    u = u.view(1, -1).mul_(LOWRANK_SCALE).add_(b).add_(
        torch.randn(D_FULL, device=DEVICE, generator=gen))
    codec = delta_lib.make_delta_codec(f"lowrank:{LOWRANK_RANK}", b)
    torch.linalg.svd(torch.randn(1, 64, 96, device=DEVICE),
                     full_matrices=False)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = codec.encode(None, u)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s = codec.decode(payload, u.dtype, D_FULL)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    err2 = torch.sub(u, s).double().square().sum().item()
    dev2 = torch.sub(u, b).double().square().sum().item()
    sig2 = payload["u"].double().square().sum().item()
    rel = abs(err2 - (dev2 - sig2)) / err2
    check(rel <= LOWRANK_RTOL,
          f"[delta] lowrank:{LOWRANK_RANK} at D={D_FULL}: ‖u − s‖² "
          f"{err2:.6e} against ‖u − b‖² − Σσ² {dev2 - sig2:.6e} "
          f"(relative {rel:.3e} > {LOWRANK_RTOL})")
    out = {"d": D_FULL, "dims": [d1, d2], "rank": LOWRANK_RANK,
           "encode_ms": 1e3 * (t1 - t0), "decode_ms": 1e3 * (t2 - t1),
           "peak_bytes": peak, "err2": err2, "dev2": dev2, "sig2": sig2,
           "rel_err": rel}
    log(f"[delta] lowrank:{LOWRANK_RANK} encode+decode of one row, D="
        f"{D_FULL:,} as ({d1:,} × {d2:,}): encode (SVD) "
        f"{out['encode_ms']:.1f} ms, decode {out['decode_ms']:.1f} ms "
        f"(host clock, synchronized), peak {peak / 1e9:.2f} GB; ‖u − s‖² "
        f"{err2:.6e} = ‖u − b‖² − Σσ² {dev2 - sig2:.6e} (relative "
        f"{rel:.3e}, limit {LOWRANK_RTOL})")
    return out


def lowrank_spread(torch, name, impl, fuse, opt, delta, final, residual,
                   kw) -> dict:
    """What makes a low-rank path's trajectory sensitive: the spectra of
    its final deltas u − b at the truncation (σ_1, σ_R, σ_{R+1} per
    agent) and the path run once more (is it deterministic?)."""
    from repro_torch.core import delta as delta_lib
    spec = delta_lib.parse_delta(delta)
    d1, d2 = delta_lib.factor_dims(final.shape[1])
    base = initial_row(torch, **kw)
    sig = torch.linalg.svdvals(torch.add(final, residual).sub_(base).view(
        final.shape[0], d1, d2))[:, :spec.rank + 1].cpu()
    del base
    gaps = (sig[:, spec.rank - 1] - sig[:, spec.rank]) \
        / sig[:, spec.rank - 1]
    worst = int(gaps.argmin())
    gap = gaps[worst].item()
    again = flat_of(torch, train_path(torch, impl, fuse, opt, delta=delta,
                                      **kw)[0])
    repeat = (again - final).abs().max().item()
    del again
    out = {"d": final.shape[1], "dims": [d1, d2],
           "sigma_1": sig[:, 0].tolist(),
           "sigma_r": sig[:, spec.rank - 1].tolist(),
           "sigma_r1": sig[:, spec.rank].tolist(),
           "min_rel_gap": gap, "repeat_max_abs_diff": repeat}
    log(f"[delta] path ({name}): D={final.shape[1]:,} as ({d1:,} × "
        f"{d2:,}); the final deltas' smallest relative gap at the cut is "
        f"agent {worst}'s, {gap:.3e} (σ_1 {sig[worst, 0].item():.4e}, "
        f"σ_{spec.rank} {sig[worst, spec.rank - 1].item():.4e}, "
        f"σ_{spec.rank + 1} {sig[worst, spec.rank].item():.4e}); the path "
        f"again ends {repeat!r} from itself")
    return out


def delta_phase(torch, a_final) -> dict:
    """Paths (x)-(z) (DELTA_PATHS), each through run_path: (x), the full
    delta, must end on path (a)'s buffer ``a_final`` (difference 0.0)
    with an all-zero residual; (y) and (z) leave a nonzero residual;
    (y)'s final u = flat + residual through its top-k codec on the card
    must equal the CPU's element for element; (z) must end within
    LOWRANK_PATH_TOL·max|x| of its own run with the plain dense mix,
    unfused, with losses within TOL relative.  Then the full-width
    low-rank cost (lowrank_cost)."""
    from repro_torch.core import delta as delta_lib
    out = {}
    for name, (impl, fuse, opt, delta, kernel, kw) in DELTA_PATHS.items():
        state, out[name] = run_path(torch, name, impl, fuse, opt, kernel,
                                    delta=delta, **kw)
        lossless = delta_lib.parse_delta(delta).is_lossless
        check_residual(torch, name, state, out[name],
                       *(("a", a_final) if lossless else ()))
        if name == "y":
            u = flat_of(torch, state) + flat_of(torch, state, residual=True)
            del state
            out["y_codec"] = delta_codec_check(torch, name, u, delta,
                                               initial_row(torch, **kw))
            del u
        elif name == "z":
            final = flat_of(torch, state)
            residual = flat_of(torch, state, residual=True)
            del state
            out[name].update(lowrank_spread(
                torch, name, impl, fuse, opt, delta, final, residual, kw))
            del residual
            out["z_dense"] = dense_rerun(torch, name, final,
                                         tol=LOWRANK_PATH_TOL, delta=delta,
                                         **kw)
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(
                out["z_dense"]["losses"], out[name]["losses"]))
            out["z_dense"]["loss_rel_diff"] = loss_err
            check(loss_err <= TOL,
                  f"path (z) kernel vs dense losses differ: {loss_err:.3e} "
                  f"relative > {TOL}")
            log(f"[delta] path (z) with dense gossip: losses within "
                f"{loss_err:.3e} relative (limit {TOL})")
            del final
        else:
            del state
        torch.cuda.empty_cache()
    out["lowrank_full_width"] = lowrank_cost(torch)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 4e: the population engine (--n-total)
# ---------------------------------------------------------------------------

# P2: the CLI's population mode at full width (the store: n_total rows of
# D_FULL f32, 626 MB each)
POP_N_TOTAL, POP_COHORT, POP_STEPS = 16, 8, 10
# P1's and P2's server period: P1 one round, P2 two
POP_H = 5
# P3: the reference benchmark's scale row (benchmarks/bench_population.py:
# 62-63, 102-130): linreg D 25, cohort 256, H 10, ring2, 5 rounds
POP_SCALE = dict(cohort=256, d=25, h=10, ring_k=2, m_rows=10, rounds=5)
POP_SCALE_N = (10**4, 10**6)
# P3's two peaks against each other: the engine's device memory has no
# n_total term
POP_PEAK_RTOL = 0.01
POP_DIR = ROOT / "build" / "population"


def pop_disk(need: int, what: str) -> None:
    """Print the free space where the stores go and fail the phase (with
    this message) when ``need`` bytes do not fit."""
    import shutil
    POP_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(POP_DIR).free
    log(f"[population] {what}: needs {need / 1e9:.2f} GB on {POP_DIR}, "
        f"{free / 1e9:.2f} GB free")
    check(free >= need, f"[population] {what}: {need / 1e9:.2f} GB do not "
                        f"fit in the {free / 1e9:.2f} GB free on {POP_DIR}")


def drop_store(store) -> None:
    """Delete a memmap store's file (its space is freed when the last
    reference to the store goes)."""
    import os
    if store.path is not None and os.path.exists(store.path):
        os.remove(store.path)


def rows_equal(a, b) -> bool:
    """Two (n, D) memmaps equal bit for bit, compared a row at a time."""
    import numpy as np
    return a.shape == b.shape and all(
        np.array_equal(a[i].view(np.uint32), b[i].view(np.uint32))
        for i in range(a.shape[0]))


def h2d_bandwidth(torch) -> dict:
    """The card's host→device copy rate, 1 GiB from pageable and from
    pinned memory (host clock around a synchronized copy, best of 3)."""
    out = {}
    n = 1 << 28                                     # 1 GiB of f32
    dev = torch.empty(n, device=DEVICE)
    for name, pin in (("pageable", False), ("pinned", True)):
        host = torch.ones(n, pin_memory=pin)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev.copy_(host, non_blocking=pin)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[f"h2d_{name}_bytes_per_s"] = 4 * n / min(times[1:])
        del host
    del dev
    torch.cuda.empty_cache()
    return out


def pop_anchor(torch) -> dict:
    """P1: the population engine at n_total = cohort = 8 (uniform, ring2,
    H = POP_H, K = 2) against the flat engine with gossip_impl='sparse' (path
    (b)'s configuration) on the same weights, batches and draws, one
    round each at full width: the final rows equal bit for bit, and each
    run launches #2 once a step and no other kernel."""
    import numpy as np
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import flat as flat_lib, population as pop
    from repro_torch.core.draws import Draws
    from repro_torch.data.federated_lm import make_federated_lm
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    model = build_model(train.tiny_lm_config())
    draws = Draws(0, DEVICE)
    data = make_federated_lm(model.cfg.vocab_size, N_AGENTS, 128, draws)
    params0 = model.init(draws)
    spec = flat_lib.make_flat_spec(params0)
    tokens = draws.tokens(data, 2, POP_H)
    batches = {"tokens": tokens,
               "positions": torch.arange(128, device=DEVICE).expand(
                   tokens.shape)}
    eta = torch.full((1,), 3e-3, device=DEVICE)
    fed = FedConfig(n_agents=N_AGENTS, h=POP_H, k=2, graph="ring2",
                    gossip_impl="sparse")
    fcfg, n = train.build_fed_setup(model.cfg, train.fed_axes(fed), fed)
    round_fn = flat_lib.make_flat_feddec_round(
        fcfg, spec, model.grad_fn(), lambda t: eta, device=DEVICE)
    state = flat_lib.init_flat_state(spec, params0, n)
    gc.collect()
    ops.reset_launch_counts()
    state, _ = round_fn(state, batches, Draws(5, DEVICE))
    torch.cuda.synchronize()
    flat_counts = ops.launch_counts()
    want = state.flat.cpu().numpy()
    del state, round_fn
    torch.cuda.empty_cache()
    pop_disk(N_AGENTS * spec.d * 4, "P1 store")
    graph = train.population_graph("ring2", N_AGENTS)
    eng = pop.PopulationEngine(
        pop.PopulationSpec(N_AGENTS, N_AGENTS, max_degree=graph.max_degree),
        spec, model.grad_fn(), lambda t: eta, graph, h=POP_H, k=2,
        device=DEVICE, row_init=spec.ravel(params0),
        store_path=str(POP_DIR / "p1.rows"))
    del params0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(1, lambda r, ids: batches, Draws(5, DEVICE))
    round_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    got = eng.store.rows
    equal = rows_equal(got, want)
    diff = float(np.abs(got - want).max()) if not equal else 0.0
    drop_store(eng.store)
    del eng, batches, want
    torch.cuda.empty_cache()
    for name, c in (("flat engine (sparse)", flat_counts),
                    ("population engine", counts)):
        check(c["gossip_mix_sparse"] == POP_H
              and sum(c.values()) == POP_H,
              f"[population] P1 {name}: launches {c} (#2 {POP_H} times "
              f"expected, nothing else)")
    check(equal, f"[population] P1: the population engine's rows end "
                 f"{diff:.3e} from the flat sparse engine's (0 expected)")
    log(f"[population] P1 n_total = cohort = {N_AGENTS}, D={spec.d:,}: rows "
        f"equal to the flat sparse engine's bit for bit; #2 launched "
        f"{counts['gossip_mix_sparse']} times in {POP_H} steps; round "
        f"{1e3 * round_s:.1f} ms (host clock, synchronized, first round)")
    return {"launches": counts["gossip_mix_sparse"], "equal": equal,
            "round_ms": 1e3 * round_s, "d": spec.d}


def pop_cli_run(torch, tag: str, **kw) -> tuple:
    """One population_loop at full width (the CLI's default model,
    POP_N_TOTAL agents, cohorts of POP_COHORT, ring2, H = POP_H, K = 2,
    batch 2, seq 128); returns (store, losses, timing, peak bytes,
    launches of #2), the #2 count read right after the run."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    steps = kw.pop("steps", POP_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timing: dict = {}
    ops.reset_launch_counts()
    store, losses = train.population_loop(
        train.tiny_lm_config(), FedConfig(h=POP_H, k=2, graph="ring2"),
        n_total=POP_N_TOTAL, cohort_size=POP_COHORT, steps=steps,
        per_agent_batch=2, seq_len=128, device=DEVICE, timing=timing,
        store_path=str(POP_DIR / f"{tag}.rows"), **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["gossip_mix_sparse"] == steps
          and sum(counts.values()) == steps,
          f"[population] P2 {tag}: launches {counts} (#2 {steps} times "
          f"expected, nothing else)")
    check(all(math.isfinite(v) for v in losses),
          f"[population] P2 {tag}: non-finite loss {losses}")
    return store, losses, timing, torch.cuda.max_memory_allocated(), \
        counts["gossip_mix_sparse"]


# P2's runs, one a schedule (two each, in turns, until phase 4i's time
# came beside it): their rows are compared
POP_ORDER = (("overlap", True), ("sync", False))


def pop_cli(torch) -> dict:
    """P2: population_loop at full width, overlapped and synchronous in
    turns (POP_ORDER): the two runs' rows equal bit for bit, every
    run's losses equal; --ckpt-dir saving the first run's store
    (PopulationStore.restore returns the same rows); then a round of
    --sampling stale --staleness 0.5 --n-clusters 2."""
    import shutil
    import numpy as np
    from repro_torch.core.population import PopulationStore
    from repro_torch.launch import analysis
    store_bytes = POP_N_TOTAL * D_FULL * 4
    model = analysis.population_cost_model(
        n_total=POP_N_TOTAL, cohort_size=POP_COHORT, d=D_FULL,
        max_degree=4, h=POP_H)
    pop_disk(3 * store_bytes, "P2 stores and checkpoint")
    ckpt = POP_DIR / "ckpt"
    out = {"n_total": POP_N_TOTAL, "cohort": POP_COHORT, "d": D_FULL,
           "store_bytes": store_bytes, "cost_model": model, "runs": []}
    first = None
    for i, (tag, overlap) in enumerate(POP_ORDER):
        store, losses, timing, peak, launches = pop_cli_run(
            torch, f"{tag}{i}", overlap=overlap,
            ckpt_dir=str(ckpt) if i == 0 else None)
        rounds = timing["rounds"]
        run = {"overlap": overlap, "losses": losses, "launches": launches,
               "peak_bytes": peak, "round_ms": 1e3 * timing["loop_s"] / rounds,
               **timing}
        out["runs"].append(run)
        check(store.nbytes == model["host_store_bytes"],
              f"[population] P2: store {store.nbytes} B, the cost model's "
              f"{model['host_store_bytes']:.0f}")
        check(losses == out["runs"][0]["losses"],
              f"[population] P2 run {i} ({tag}): losses differ from run 0's")
        log(f"[population] P2 run {i} {tag}: {POP_STEPS} steps in {rounds} "
            f"rounds, {run['round_ms']:.1f} ms a round (host clock, "
            f"synchronized), {timing['drains']} drains, loss "
            f"{losses[0]:.4f} → {losses[-1]:.4f}, store "
            f"{store.nbytes / 1e9:.2f} GB host-side, peak "
            f"{peak / 1e9:.2f} GB; a round's h2d "
            + ", ".join(f"{ms:.1f}" for ms in timing["h2d_ms"])
            + " ms and d2h " + ", ".join(f"{ms:.1f}"
                                         for ms in timing["d2h_ms"])
            + " ms (copy stream, CUDA events); host ms: "
            + "; ".join(f"{name} " + ", ".join(
                f"{1e3 * s:.0f}" for s in timing[f"{name}_s"])
                for name in ("launch", "wait", "prepare", "gather",
                             "scatter")))
        if i == 0:
            back = PopulationStore.restore(
                str(ckpt), writable_path=str(POP_DIR / "restored.rows"))
            same = rows_equal(back.rows, store.rows) and \
                (back.last_round == store.last_round).all()
            drop_store(back)
            del back
            shutil.rmtree(ckpt)
            check(same, "[population] P2: the restored store differs from "
                        "the saved one")
            out["ckpt_roundtrip_equal"] = True
            log("[population] P2 --ckpt-dir: PopulationStore.restore "
                "returns the saved rows and counters bit for bit")
            first = store
            continue
        if i == 1:
            equal = rows_equal(first.rows, store.rows)
            drop_store(first)
            first = None
            check(equal, "[population] P2: the overlapped and the "
                         "synchronous schedule end on different rows")
            out["overlap_equals_sync"] = True
        drop_store(store)
        del store
    ms = {tag: float(np.mean([r["round_ms"] for r in out["runs"]
                              if r["overlap"] == (tag == "overlap")]))
          for tag in ("overlap", "sync")}
    out["round_ms"] = ms
    out["overlap_speedup"] = ms["sync"] / ms["overlap"]
    log(f"[population] P2: overlapped and synchronous rows and losses equal "
        f"bit for bit; a round {ms['overlap']:.1f} ms overlapped, "
        f"{ms['sync']:.1f} ms synchronous (one run each; "
        f"{out['overlap_speedup']:.3f}×)")
    store, losses, timing, peak, launches = pop_cli_run(
        torch, "stale", steps=POP_H, sampling="stale", staleness=0.5,
        n_clusters=2)
    drop_store(store)
    out["stale"] = {"losses": losses, "launches": launches,
                    "peak_bytes": peak,
                    "round_ms": 1e3 * timing["loop_s"] / timing["rounds"]}
    log(f"[population] P2 stale, staleness 0.5, 2 clusters: loss "
        f"{losses[0]:.4f} → {losses[-1]:.4f}, #2 launched {launches} "
        f"times, a round {out['stale']['round_ms']:.1f} ms, peak "
        f"{peak / 1e9:.2f} GB")
    return out


def pop_scale_engine(torch, n_total: int):
    """P3's engine: linreg D 25 (the grad written out, repro_torch.data.
    linreg), cohorts of 256 over a ring2 population of ``n_total``, its
    minibatches drawn on the card from a fixed (256, 10, 25) dataset;
    returns (engine, batch_fn)."""
    import numpy as np
    from repro_torch.core import flat as flat_lib, population as pop
    from repro_torch.core import topology
    from repro_torch.data import linreg
    s = POP_SCALE
    c, d = s["cohort"], s["d"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    x = torch.randn(c, s["m_rows"], d, device=DEVICE, generator=gen) * 0.25
    y = torch.randn(c, s["m_rows"], device=DEVICE, generator=gen)
    eta = torch.full((1,), 1e-3, device=DEVICE)

    def batch_fn(round_idx, ids):
        idx = torch.randint(0, s["m_rows"], (s["h"], c, 1), device=DEVICE,
                            generator=gen)
        return {"x": torch.take_along_dim(x[None], idx[..., None], dim=2),
                "y": torch.take_along_dim(y[None], idx, dim=2)}

    eng = pop.PopulationEngine(
        pop.PopulationSpec(n_total, c, max_degree=2 * s["ring_k"]),
        flat_lib.make_flat_spec({"z": torch.zeros(d)}),
        linreg.make_grad_fn(s["m_rows"]), lambda t: eta,
        topology.ring_graph_csr(n_total, s["ring_k"]), h=s["h"], k=2,
        device=DEVICE, row_init=np.zeros(d, np.float32),
        store_path=str(POP_DIR / f"p3_{n_total}.rows"))
    return eng, batch_fn


def pop_scale_rounds(torch, eng, batch_fn, draws, overlap: bool) -> tuple:
    """POP_SCALE's rounds of ``eng``: (metrics, µs a round on the host
    clock, synchronized, peak bytes, peak bytes above what was allocated
    before, launch counts)."""
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mets = eng.run(POP_SCALE["rounds"], batch_fn, draws, overlap=overlap)
    torch.cuda.synchronize()
    us = 1e6 * (time.perf_counter() - t0) / POP_SCALE["rounds"]
    peak = torch.cuda.max_memory_allocated()
    return mets, us, peak, peak - base, ops.launch_counts()


def pop_scale(torch) -> dict:
    """P3: the reference benchmark's scale rows at n_total 1e4 and 1e6,
    each after one warm-up round: µs a round (host clock, synchronized),
    #2 launched H times a round, the peak device bytes (equal within
    POP_PEAK_RTOL across n_total: no n_total term; also printed above
    what was allocated before, such as cuBLAS's workspace), the host
    store equal to population_cost_model's host_store_bytes; then the
    largest population's rounds again with the synchronous schedule."""
    from repro_torch.core.draws import Draws
    from repro_torch.launch import analysis
    s = POP_SCALE
    out = {}
    for n_total in POP_SCALE_N:
        model = analysis.population_cost_model(
            n_total=n_total, cohort_size=s["cohort"], d=s["d"],
            max_degree=2 * s["ring_k"], h=s["h"])
        pop_disk(int(model["host_store_bytes"]), f"P3 store n_total "
                                                 f"{n_total:,}")
        eng, batch_fn = pop_scale_engine(torch, n_total)
        draws = Draws(0, DEVICE)
        eng.run(1, batch_fn, draws)                    # warm-up
        mets, us, peak, own, counts = pop_scale_rounds(torch, eng, batch_fn,
                                                       draws, True)
        want = s["rounds"] * s["h"]
        check(counts["gossip_mix_sparse"] == want
              and sum(counts.values()) == want,
              f"[population] P3 n_total {n_total}: launches {counts} (#2 "
              f"{want} times expected, nothing else)")
        check(eng.store.nbytes == model["host_store_bytes"],
              f"[population] P3 n_total {n_total}: store "
              f"{eng.store.nbytes} B, the cost model's "
              f"{model['host_store_bytes']:.0f}")
        check(bool(math.isfinite(float(mets["loss"].max()))),
              f"[population] P3 n_total {n_total}: non-finite loss")
        out[str(n_total)] = {
            "us_per_round": us, "launches": counts["gossip_mix_sparse"],
            "peak_device_bytes": peak, "peak_above_base_bytes": own,
            "drains": int(mets["drains"]),
            "host_store_bytes": eng.store.nbytes, **eng.stats,
            "cost_model": model}
        log(f"[population] P3 n_total {n_total:,}, cohort {s['cohort']}, "
            f"D {s['d']}: {us:.1f} µs a round (host clock, synchronized, "
            f"{s['rounds']} rounds; dispatch "
            f"{1e6 * sum(eng.stats['launch_s']) / s['rounds']:.1f} µs), "
            f"#2 {counts['gossip_mix_sparse']} launches, {mets['drains']} "
            f"drains, peak device {peak:,} B ({own:,} B above the "
            f"allocations before it; the model's "
            f"{model['peak_device_bytes']:,.0f}), store "
            f"{eng.store.nbytes:,} B = the model's")
        if n_total == POP_SCALE_N[-1]:
            _, us_sync, *_ = pop_scale_rounds(torch, eng, batch_fn, draws,
                                              False)
            out[str(n_total)]["us_per_round_sync"] = us_sync
            log(f"[population] P3 n_total {n_total:,} synchronous: "
                f"{us_sync:.1f} µs a round, against {us:.1f} overlapped")
        drop_store(eng.store)
        del eng
    peaks = [out[str(n)]["peak_device_bytes"] for n in POP_SCALE_N]
    check(abs(peaks[1] - peaks[0]) <= POP_PEAK_RTOL * peaks[0],
          f"[population] P3: peak device bytes {peaks} differ by more than "
          f"{POP_PEAK_RTOL:.0%} across n_total")
    return out


def population_launches(population: dict) -> dict:
    """#2's launches on each population path (phase 4e)."""
    p2 = population["P2"]
    return {"P1": population["P1"]["launches"],
            **{f"P2 run {i} " + ("overlap" if r["overlap"] else "sync"):
               r["launches"] for i, r in enumerate(p2["runs"])},
            "P2 stale": p2["stale"]["launches"],
            **{f"P3 n_total {n}": row["launches"]
               for n, row in population["P3"].items()}}


def population_phase(torch) -> dict:
    """Phase 4e: P1 (the flat-sparse anchor), P2 (the CLI at full width:
    overlap ≡ sync, the checkpoint), P3 (the scale rows), and the card's
    h2d rates beside the cost model's nominal H2D_BW."""
    from repro_torch.launch import analysis
    bw = h2d_bandwidth(torch)
    log(f"[population] h2d 1 GiB: pinned "
        f"{bw['h2d_pinned_bytes_per_s'] / 1e9:.2f} GB/s, pageable "
        f"{bw['h2d_pageable_bytes_per_s'] / 1e9:.2f} GB/s (host clock, "
        f"synchronized, best of 3), beside the cost model's nominal "
        f"{analysis.H2D_BW / 1e9:.0f} GB/s")
    out = {"bandwidth": bw, "h2d_bw_nominal": analysis.H2D_BW}
    out["P1"] = pop_anchor(torch)
    out["P2"] = pop_cli(torch)
    out["P3"] = pop_scale(torch)
    return out


# ---------------------------------------------------------------------------
# Phase 4b: line 4 as one batched pass, at full width
# ---------------------------------------------------------------------------


def per_row_grads(torch, spec, loss_fn, flat, batch):
    """The yardstick: one torch.autograd.grad per agent row from Python,
    the loop the engines ran before their one batched call."""
    from repro_torch.tree import build_tree
    g_flat = torch.empty_like(flat)
    losses = []
    for i in range(flat.shape[0]):
        leaves = [v.detach().requires_grad_() for v in spec.views(flat[i])]
        params = build_tree(spec.paths, leaves)
        with torch.enable_grad():
            loss = loss_fn(params, {k: v[i] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
        for view, gr in zip(spec.views(g_flat[i]), grads):
            view.copy_(gr)
        losses.append(loss.detach())
    return torch.stack(losses), g_flat


def host_ms(torch, fn, repeats: int = 3) -> float:
    """Median host-clock time of ``fn`` ending in a device sync, after
    one untimed call."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def grad_phase(torch) -> dict:
    """Line 4 of the full-width tiny LM as the engines run it, one
    torch.func.vmap of Model.grad_fn over every agent row, against the
    per-row loop: path (c)'s 8 agents and first batch, each row's weights
    perturbed (so that a row mixed up with another shows), then the
    R_FULL = 2 lattice's 16 rows (run 1 on path (c)'s second batch).  g
    within TOL·max|g|, losses within TOL·max|loss|; both timed (host
    clock, synchronized) with their peaks.  No kernel launches here."""
    from repro_torch.core import flat as flat_lib, sweep
    from repro_torch.core.draws import Draws
    from repro_torch.data.federated_lm import make_federated_lm
    from repro_torch.launch import train
    from repro_torch.models import build_model
    model = build_model(train.tiny_lm_config())
    draws = Draws(0, DEVICE)
    data = make_federated_lm(model.cfg.vocab_size, N_AGENTS, 128, draws)
    params = model.init(draws)
    spec = flat_lib.make_flat_spec(params)
    tokens = draws.tokens(data, 2, 2)                    # (2, n, B, S)
    positions = torch.arange(128, device=DEVICE).expand(tokens.shape[1:])
    row = spec.ravel(params)
    del params
    grad_fn = model.grad_fn()
    out = {}
    for name, lead in (("flat", (N_AGENTS,)), ("lattice", (R_FULL,
                                                          N_AGENTS))):
        flat = row + 1e-3 * draws.normal(lead + (spec.d,))
        toks = tokens[0] if len(lead) == 1 else tokens
        batch = {"tokens": toks, "positions": positions.expand(toks.shape)}
        rows = math.prod(lead)
        rows_batch = {k: v.reshape((rows,) + v.shape[len(lead):])
                      for k, v in batch.items()}

        def batched():
            if len(lead) == 1:
                return flat_lib.grads_of(spec, grad_fn, flat, batch)
            return sweep.grads_of_lattice(spec, grad_fn, flat, batch)

        def loop():
            return per_row_grads(torch, spec, model.loss,
                                 flat.view(rows, spec.d), rows_batch)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, g = batched()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        losses, g = losses.reshape(rows), g.view(rows, spec.d)
        want_l, want_g = loop()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(g).all()) and g.shape == want_g.shape,
              f"[grad] {name}: the batched gradient is not finite or "
              f"{tuple(g.shape)}")
        err = (g - want_g).abs().max().item()
        scale = want_g.abs().max().item()
        loss_err = (losses - want_l).abs().max().item()
        loss_scale = want_l.abs().max().item()
        del g, want_g, losses, want_l
        check(err <= TOL * scale, f"[grad] {name}: max|Δg| {err:.3e} > "
                                  f"{TOL}·{scale:.3e} against the loop")
        check(loss_err <= TOL * loss_scale,
              f"[grad] {name}: max|Δloss| {loss_err:.3e} > "
              f"{TOL}·{loss_scale:.3e}")
        torch.cuda.empty_cache()
        batched_ms = host_ms(torch, batched)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loop_ms = host_ms(torch, loop)
        loop_peak = torch.cuda.max_memory_allocated()
        out[name] = {"rows": rows, "d": spec.d, "max_abs_err": err,
                     "scale": scale, "loss_max_abs_err": loss_err,
                     "batched_ms": batched_ms, "loop_ms": loop_ms,
                     "batched_peak_bytes": peak,
                     "loop_peak_bytes": loop_peak}
        log(f"[grad] {name}: {rows} rows × D {spec.d:,}, one vmapped call "
            f"vs the per-row loop: max|Δg| {err:.3e} (limit "
            f"{TOL}·{scale:.3e}), max|Δloss| {loss_err:.3e}; batched "
            f"{batched_ms:.1f} ms, loop {loop_ms:.1f} ms (host clock, "
            f"synchronized, median of 3); peaks {peak / 1e9:.2f} / "
            f"{loop_peak / 1e9:.2f} GB")
        del flat
    return out


# ---------------------------------------------------------------------------
# Phase 5: where a training step's time goes
# ---------------------------------------------------------------------------


def profile_phase(torch, step_ms: float, remat: bool = True) -> dict:
    """Path (c) once more under torch.profiler, through
    launch/profile.py's trace_step: device time per step by kernel group
    and the top kernels.  A run of 0 steps traces the set-up alone
    (weights, data, the flat buffer); its device work is taken out of
    the 10-step run's, so only the steps' work is counted.  The busy
    share is that device time over path (c)'s unprofiled warm step time,
    since the profiler slows the host.  ``remat`` False profiles path (c)
    with every activation kept.  Launches here do not count for the main
    path."""
    from repro_torch.launch.profile import trace_step
    impl, fuse, opt, _ = PATHS["c"]
    (ROOT / "build").mkdir(exist_ok=True)
    out = trace_step(lambda steps: train_path(torch, impl, fuse, opt,
                                              steps=steps, remat=remat),
                     TRAIN_STEPS, step_ms, trace_dir=ROOT / "build")
    if not out["traced"]:
        log("[profile] the profiler traced no device time: not measured")
        return out
    out["path"] = "c" if remat else "c remat off"
    groups = out["groups_ms_per_step"]
    device_ms = out["device_ms_per_step"]
    log(f"[profile] path ({out['path']}), steps only (set-up: "
        f"{out['setup_ops']} device "
        f"ops, {out['setup_device_ms']:.1f} ms, taken out): "
        f"{out['launches_per_step']:.0f} device ops/step, device "
        f"{device_ms:.1f} ms of a {step_ms:.1f} ms step "
        f"({100 * device_ms / step_ms:.1f}% busy); by group (ms/step): "
        + ", ".join(f"{g} {ms:.2f}" for g, ms in
                    sorted(groups.items(), key=lambda kv: -kv[1])))
    return out


# ---------------------------------------------------------------------------
# Phase 6: the model zoo's prefill, kernels #15-#17 on their main path
# ---------------------------------------------------------------------------


def logit_gap(torch, got, want) -> tuple[float, float]:
    """(max |got − want|, max |want|) in f32, a slice of S at a time so
    that no (B, S, V) f32 copy of the bf16 logits is made."""
    err = scale = 0.0
    for i in range(0, want.shape[1], 256):
        a = got[:, i:i + 256].to(torch.float32, copy=True)
        b = want[:, i:i + 256].to(torch.float32, copy=True)
        err = max(err, a.sub_(b).abs_().max().item())
        scale = max(scale, b.abs_().max().item())
    return err, scale


def model_forward(torch, model, params, batch, impl: str, warm: bool):
    """The forward with the launch counters set to 0 just before it and
    read just after, after one untimed forward (allocator, cuBLAS and the
    kernels warm) when ``warm``.  Returns (logits, ms, counts, peak
    bytes)."""
    from repro_torch.kernels import ops
    with torch.inference_mode():
        if warm:
            model.logits(params, batch, impl=impl)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = model.logits(params, batch, impl=impl)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = ops.launch_counts()
    return logits, ms, counts, torch.cuda.max_memory_allocated()


def compare_paths(torch, name: str, model, params, batch, warm: bool = True):
    """impl='xla' then impl='pallas' on the same weights and tokens: the
    xla forward launches no kernel, the pallas one #15-#17 as the layer
    plan says and nothing else; both logits finite and (B, S, V) in the
    compute dtype.  Returns the record, with max|Δlogit| / max|logit|."""
    cfg = model.cfg
    xla, xla_ms, xla_counts, xla_peak = model_forward(
        torch, model, params, batch, "xla", warm)
    check(sum(xla_counts.values()) == 0,
          f"{name}: impl='xla' launched kernels {xla_counts}")
    pallas, ms, counts, peak = model_forward(torch, model, params, batch,
                                             "pallas", warm)
    want = ZOO_LAUNCHES[name]
    launched = {k: v for k, v in counts.items() if v}
    check(launched == want,
          f"{name}: impl='pallas' launched {launched}, expected {want}")
    shape = tuple(batch["tokens"].shape) + (cfg.vocab_size,)
    for impl, lg in (("xla", xla), ("pallas", pallas)):
        check(tuple(lg.shape) == shape and lg.dtype == cfg.compute_dtype,
              f"{name} {impl}: logits {lg.dtype} {tuple(lg.shape)}")
        check(bool(torch.isfinite(lg).all()),
              f"{name} {impl}: non-finite logits")
    err, scale = logit_gap(torch, pallas, xla)
    return {"compute_dtype": str(cfg.compute_dtype), "launches": launched,
            "rel_gap": err / scale, "max_abs_logit": scale, "xla_ms": xla_ms,
            "pallas_ms": ms, "xla_peak_bytes": xla_peak,
            "pallas_peak_bytes": peak}


# Mamba2-2.7B's bf16 gap over the sequence and the seed (model phase)
GAP_SEQS = (1024, 2048, 4096)
GAP_SEEDS = (0, 1, 2)


def mamba2_gap_table(torch) -> list:
    """Mamba2-2.7B's |pallas − xla| / max|logit| at S 1024, 2048 and 4096
    (prefixes of one token draw) on weights and tokens from seeds 0, 1 and
    2, each held to bf16_model_bound (B 1, untimed)."""
    from repro_torch.configs import get_config
    from repro_torch.core.draws import Draws
    from repro_torch.models import build_model
    cfg = get_config("mamba2-2.7b")
    model = build_model(cfg)
    tol = bf16_model_bound(cfg.num_layers, cfg.smoke().num_layers)
    rows = []
    for seed in GAP_SEEDS:
        draws = Draws(seed, DEVICE)
        params = model.init(draws)
        tokens = torch.randint(0, cfg.vocab_size, (1, max(GAP_SEQS)),
                               generator=draws.generator, device=DEVICE)
        for seq in GAP_SEQS:
            batch = {"tokens": tokens[:, :seq],
                     "positions": torch.arange(seq, device=DEVICE)[None]}
            with torch.inference_mode():
                xla = model.logits(params, batch, impl="xla")
                pallas = model.logits(params, batch, impl="pallas")
            err, scale = logit_gap(torch, pallas, xla)
            del xla, pallas
            gap = err / scale
            check(math.isfinite(gap) and gap <= tol,
                  f"mamba2-2.7b seed {seed} S {seq}: max|Δlogit|/max|logit| "
                  f"{gap:.4e} > {tol:.4e}")
            rows.append({"seed": seed, "seq": seq, "rel_gap": gap,
                         "bound": tol})
            log(f"[models] mamba2-2.7b gap, seed {seed}, S {seq}: "
                f"max|Δlogit|/max|logit| {gap:.4e} (bound {tol:.4e})")
        del params, draws, tokens
        torch.cuda.empty_cache()
    return rows


def stub_frames(cfg, batch: int, draws):
    """ENC_FRAMES stub encoder frames (B, T, d), N(0, 1)·0.02 in the
    compute dtype (launch/specs.concrete_batch's embeddings)."""
    return (draws.normal((batch, ENC_FRAMES, cfg.d_model)) * 0.02).to(
        cfg.compute_dtype)


def multimodal_inputs(torch, cfg, batch: dict, draws) -> dict:
    """``batch`` with the model's other inputs: a vision config's stub
    patch embeddings (N(0, 1)·0.02, compute dtype) in the first
    VISION_GRID² positions, and Qwen2-VL's M-RoPE ids: patch (r, c) at
    (0, r, c), the text after the patches from VISION_GRID on in all
    three components (positions stay 0 .. S-1); an encoder-decoder
    config's stub_frames."""
    out = dict(batch)
    b, s = batch["tokens"].shape
    if cfg.rope_kind == "mrope":
        p = VISION_GRID ** 2 if cfg.frontend == "vision" else 0
        idx = torch.arange(s, device=DEVICE)
        text = idx - p + (VISION_GRID if p else 0)
        patch = idx < p
        ids = torch.stack([torch.where(patch, 0, text),
                           torch.where(patch, idx // VISION_GRID, text),
                           torch.where(patch, idx % VISION_GRID, text)])
        out["mrope_positions"] = ids[:, None].expand(3, b, s).contiguous()
    if cfg.frontend == "vision":
        check(cfg.frontend_positions == VISION_GRID ** 2,
              f"{cfg.name}: {cfg.frontend_positions} patch positions")
        out["frontend_embeds"] = (draws.normal(
            (b, cfg.frontend_positions, cfg.d_model)) * 0.02).to(
            cfg.compute_dtype)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = stub_frames(cfg, b, draws)
    return out


def init_peak_check(torch, name: str, params: dict, peak: int) -> dict:
    """Model.init's peak above what was allocated before it must not pass
    the weights' bytes plus one block (the largest: a prefix or suffix
    layer, or one group's slice of a scanned unit's layer), plus
    INIT_ROUNDING for each leaf of the weights and of that block: the
    caching allocator may hand a tensor a block up to 1 MiB larger than
    it asked for.  A model with bf16 weights draws each leaf in f32 and
    casts it: its peak is held to the weights plus the largest leaf's f32
    draw, plus one group's slice only where a scanned unit has two groups
    or more (a single group is its block, viewed; transformer._init_group),
    with the same rounding."""
    from repro_torch.tree import leaves

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in leaves(tree))

    stack = params["stack"]
    blocks = [(nbytes(v), len(leaves(v))) for k, v in stack.items()
              if k != "scan"]
    groups = [(nbytes(sub) // leaves(sub)[0].shape[0], len(leaves(sub)),
               leaves(sub)[0].shape[0])
              for sub in stack.get("scan", {}).values()]
    blocks += [(b, n) for b, n, _ in groups]
    total = nbytes(params)
    block, block_leaves = max(blocks)
    limit = total + block + INIT_ROUNDING * (len(leaves(params))
                                             + block_leaves)
    # a leaf as drawn: a scanned leaf one group's slice at a time
    drawn = [x.numel() // x.shape[0] for sub in stack.get("scan",
                                                           {}).values()
             for x in leaves(sub) if x.dtype == torch.bfloat16]
    scanned = {id(x) for sub in stack.get("scan", {}).values()
               for x in leaves(sub)}
    drawn += [x.numel() for x in leaves(params)
              if x.dtype == torch.bfloat16 and id(x) not in scanned]
    draw = 4 * max(drawn, default=0)
    if draw:
        block, block_leaves = max([(b, n) for b, n, g in groups if g > 1],
                                  default=(0, 0))
        limit = total + draw + block + INIT_ROUNDING * (
            len(leaves(params)) + block_leaves + 1)
    check(peak <= limit,
          f"{name}: init peaked {peak / 1e9:.3f} GB above its base, past "
          f"its weights' {total / 1e9:.3f} GB + one block's "
          f"{block / 1e9:.3f} GB + one f32 draw's {draw / 1e9:.3f} GB "
          f"(limit {limit / 1e9:.3f} GB)")
    log(f"[models] {name} init: peak {peak / 1e9:.3f} GB for "
        f"{total / 1e9:.3f} GB of weights (the largest block "
        f"{block / 1e9:.3f} GB, the largest f32 draw {draw / 1e9:.3f} GB; "
        f"limit {limit / 1e9:.3f} GB)")
    return {"peak_bytes": peak, "weight_bytes": total, "block_bytes": block,
            "draw_bytes": draw, "limit_bytes": limit}


def model_config(name: str):
    """The config of ``name`` at the depth phases 6 and 6b run it
    (MODEL_LAYERS, else its own)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if name in MODEL_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=MODEL_LAYERS[name])
    return cfg


def model_phase(torch) -> dict:
    """Each model at full width and depth from random weights (one
    torch.Generator on the card), compared on its two paths under
    inference_mode (compare_paths): the f32 tiny LM to
    MODEL_TOL_F32·max|logit|, the bf16 models to bf16_model_bound, a
    model with no kernel on its path (DeepSeek-V2-Lite) exactly.  A bf16
    model with a kernel on its path, but those of F32_TWIN_SKIP, is
    compared once more with f32 compute on the same weights and tokens
    (untimed): there the two paths must agree to MODEL_TOL_F32, which
    bf16's rounding differences, grown over the depth, hide.  A model
    without a kernel gets no twin: its two sides would be the same code.  Each init's peak is held to its weights' bytes
    plus one block (init_peak_check)."""
    import dataclasses
    from repro_torch.core.draws import Draws
    from repro_torch.models import build_model
    out = {}
    for seed, (name, bsz, seq) in enumerate(ZOO_MODELS):
        cfg = model_config(name)
        model = build_model(cfg)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        draws = Draws(seed, DEVICE)
        params = model.init(draws)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init = init_peak_check(torch, name, params,
                               torch.cuda.max_memory_allocated() - base)
        tokens = torch.randint(0, cfg.vocab_size, (bsz, seq),
                               generator=draws.generator, device=DEVICE)
        positions = torch.arange(seq, device=DEVICE).expand(bsz, seq)
        batch = multimodal_inputs(torch, cfg, {"tokens": tokens,
                                               "positions": positions},
                                  draws)
        row = compare_paths(torch, name, model, params, batch)
        tol, rule = model_tol(torch, name, cfg)
        if not ZOO_LAUNCHES[name]:
            tol, rule = 0.0, "exact: no kernel on the path"
        check(row["rel_gap"] <= tol,
              f"{name}: max|Δlogit|/max|logit| {row['rel_gap']:.4e} > "
              f"{tol:.4e} ({rule})")
        row.update({"batch": bsz, "seq": seq, "init_s": init_s,
                    "params": model.param_count(params), "bound": tol,
                    "bound_rule": rule, "init": init})
        log(f"[models] {name} ({row['params']:,} params, B {bsz}, S {seq}, "
            f"{cfg.compute_dtype}): max|Δlogit|/max|logit| "
            f"{row['rel_gap']:.3e} (bound {tol:.3e}, {rule}); launches "
            f"{row['launches']}; forward xla {row['xla_ms']:.1f} ms, "
            f"pallas {row['pallas_ms']:.1f} ms (host clock, synchronized); "
            f"peak xla {row['xla_peak_bytes'] / 1e9:.2f} GB, pallas "
            f"{row['pallas_peak_bytes'] / 1e9:.2f} GB; init {init_s:.1f} s")
        if cfg.compute_dtype != torch.float32 and ZOO_LAUNCHES[name] \
                and name not in F32_TWIN_SKIP:
            f32 = build_model(dataclasses.replace(
                cfg, compute_dtype=torch.float32))
            twin = compare_paths(torch, name, f32, params, batch,
                                 warm=False)
            check(twin["rel_gap"] <= MODEL_TOL_F32,
                  f"{name} with f32 compute: max|Δlogit|/max|logit| "
                  f"{twin['rel_gap']:.4e} > {MODEL_TOL_F32}")
            row["f32_compute"] = twin
            log(f"[models] {name} with f32 compute, same weights: "
                f"max|Δlogit|/max|logit| {twin['rel_gap']:.3e} (limit "
                f"{MODEL_TOL_F32}); launches {twin['launches']}; peak "
                f"{twin['pallas_peak_bytes'] / 1e9:.2f} GB")
        out[name] = row
        del params, batch, tokens, draws
        torch.cuda.empty_cache()
    out["mamba2-2.7b"]["gap_table"] = mamba2_gap_table(torch)
    return out


# ---------------------------------------------------------------------------
# Phase 6b: serving (launch/serve.py) and checkpointing (--ckpt-dir)
# ---------------------------------------------------------------------------

# (S1)-(S3): (model, batch) at full width and depth, the serving CLI's
# prompt and new tokens; (S4): the personalized batch of path (a)'s agents
SERVE_MODELS = [("qwen1.5-4b", 4), ("recurrentgemma-9b", 1),
                ("mamba2-2.7b", 1), ("deepseek-v2-lite-16b", 1),
                ("qwen2-vl-2b", 4), ("seamless-m4t-large-v2", 1),
                ("mistral-large-123b", 4), ("deepseek-v3-671b", 1)]
SERVE_PROMPT, SERVE_NEW = 16, 16


def teacher_forced(torch, model, params, seqs, enc_out=None):
    """(B, S, V) logits of Model.decode_step over every token of ``seqs``
    from empty caches: the steps ``generate`` takes on the same tokens
    (an M-RoPE model's three components at the token's position, an
    encoder-decoder model attending ``enc_out``)."""
    b, s = seqs.shape
    caches = model.init_caches(b, s, dtype=torch.float32, device=DEVICE)
    outs = []
    with torch.inference_mode():
        for t in range(s):
            batch = {"tokens": seqs[:, t:t + 1],
                     "positions": torch.full((b, 1), t, device=DEVICE)}
            if model.cfg.rope_kind == "mrope":
                batch["mrope_positions"] = torch.full((3, b, 1), t,
                                                      device=DEVICE)
            logits, caches = model.decode_step(params, batch, caches,
                                               enc_out=enc_out)
            outs.append(logits[:, 0])
    return torch.stack(outs, dim=1)


def timed_generate(torch, fn):
    """(the result of ``fn()``, its host-clock seconds, its peak bytes),
    after one untimed call of ``fn`` (allocator and cuBLAS warm)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def check_served(torch, name: str, seqs, prompt, vocab: int) -> None:
    b, s = prompt.shape
    check(tuple(seqs.shape) == (b, s + SERVE_NEW),
          f"[serve] {name}: sequences {tuple(seqs.shape)}")
    check(torch.equal(seqs[:, :s], prompt),
          f"[serve] {name}: the prompt is not the sequences' prefix")
    check(bool(((seqs >= 0) & (seqs < vocab)).all()),
          f"[serve] {name}: a token outside the vocabulary")


def serve_model(torch, name: str, batch: int, seed: int) -> dict:
    """generate at full width (greedy, SERVE_PROMPT + SERVE_NEW), timed
    after an untimed call; then each sequence teacher-forced through
    decode_step: its logits against the xla prefill of the same tokens
    (model_tol; an MoE model's recorded, and held on moe_decode_twin),
    and generate's tokens the argmax of them exactly."""
    from repro_torch.core.draws import Draws
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = model_config(name)
    model = build_model(cfg)
    gc.collect()
    t0 = time.perf_counter()
    draws = Draws(seed, DEVICE)
    params = model.init(draws)
    prompt = torch.randint(0, cfg.vocab_size, (batch, SERVE_PROMPT),
                           generator=draws.generator, device=DEVICE)
    enc_out = frames = None
    if cfg.is_encoder_decoder:
        frames = stub_frames(cfg, batch, draws)
        with torch.inference_mode():
            enc_out = model.encode(params, {"enc_embeds": frames})
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    seqs, secs, peak = timed_generate(torch, lambda: serve.generate(
        model, params, prompt, max_new_tokens=SERVE_NEW, enc_out=enc_out))
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    check(not launched, f"[serve] {name}: decode launched {launched}")
    check_served(torch, name, seqs, prompt, cfg.vocab_size)
    steps = SERVE_PROMPT + SERVE_NEW
    dec = teacher_forced(torch, model, params, seqs, enc_out)
    check(bool(torch.isfinite(dec).all()),
          f"[serve] {name}: non-finite decode logits")
    picked = dec[:, SERVE_PROMPT - 1:steps - 1].argmax(dim=-1)
    check(torch.equal(picked, seqs[:, SERVE_PROMPT:]),
          f"[serve] {name}: generate's tokens are not the argmax of the "
          f"teacher-forced decode logits")
    # the same computation as the decode: text only, every M-RoPE
    # component the position; the decode's encoder memory from the same
    # frames (Model.encode is the prefill's own encoder pass)
    prefill_batch = {"tokens": seqs, "positions": torch.arange(
        steps, device=DEVICE).expand(batch, steps)}
    if cfg.rope_kind == "mrope":
        prefill_batch["mrope_positions"] = prefill_batch["positions"][
            None].expand(3, batch, steps)
    if frames is not None:
        prefill_batch["enc_embeds"] = frames
    with torch.inference_mode():
        full = model.logits(params, prefill_batch, impl="xla")
    err, scale = logit_gap(torch, dec, full)
    tol, rule = model_tol(torch, name, cfg)
    twin = None
    if cfg.moe is None:
        check(math.isfinite(err) and err <= tol * scale,
              f"[serve] {name}: decode vs prefill max|Δlogit|/max|logit| "
              f"{err / scale:.4e} > {tol:.4e} ({rule})")
    else:
        # recorded, not held: the prefill's capacity drops tokens and the
        # router flips experts on bf16-sized differences
        tol, rule = None, "not held (MoE): see the drop-free f32 twin"
        twin = moe_decode_twin(torch, name, cfg, params, seqs,
                               prefill_batch)
    row = {"batch": batch, "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW,
           "params": model.param_count(params),
           "compute_dtype": str(cfg.compute_dtype), "generate_s": secs,
           "ms_per_step": 1e3 * secs / steps,
           "new_tokens_per_s": batch * SERVE_NEW / secs, "peak_bytes": peak,
           "rel_gap_decode_vs_prefill": err / scale, "bound": tol,
           "bound_rule": rule, "init_s": init_s, "f32_drop_free": twin}
    log(f"[serve] ({name}) {row['params']:,} params, B {batch}, prompt "
        f"{SERVE_PROMPT} + {SERVE_NEW} new, {cfg.compute_dtype}: generate "
        f"{secs:.2f} s, {row['ms_per_step']:.2f} ms a decode step (host "
        f"clock, synchronized; B tokens a step), "
        f"{row['new_tokens_per_s']:.1f} new tok/s, peak {peak / 1e9:.2f} "
        f"GB; decode vs prefill max|Δlogit|/max|logit| {err / scale:.3e} "
        f"(bound {'none' if tol is None else f'{tol:.3e}'}, {rule}); "
        f"tokens = argmax of the decode logits")
    del params, dec, full, draws, enc_out, frames
    torch.cuda.empty_cache()
    return row


def moe_decode_twin(torch, name: str, cfg, params, seqs,
                    prefill_batch) -> dict:
    """An MoE model's decode against its prefill, on a twin of its config
    with f32 compute and capacity_factor = num_experts / top_k (C = N:
    no copy drops in the prefill) and the same weights: the
    teacher-forced decode_step logits within MODEL_TOL_F32·max|logit| of
    the xla prefill."""
    import dataclasses
    from repro_torch.models import build_model
    twin = build_model(dataclasses.replace(
        cfg, compute_dtype=torch.float32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)))
    dec = teacher_forced(torch, twin, params, seqs)
    with torch.inference_mode():
        full = twin.logits(params, prefill_batch, impl="xla")
    err, scale = logit_gap(torch, dec, full)
    check(math.isfinite(err) and err <= MODEL_TOL_F32 * scale,
          f"[serve] {name} f32, drop-free: decode vs prefill "
          f"max|Δlogit|/max|logit| {err / scale:.4e} > {MODEL_TOL_F32}")
    log(f"[serve] ({name}) f32 compute, capacity factor "
        f"{cfg.moe.num_experts}/{cfg.moe.top_k} (no drops): decode vs "
        f"prefill max|Δlogit|/max|logit| {err / scale:.3e} (limit "
        f"{MODEL_TOL_F32})")
    del dec, full
    return {"rel_gap_decode_vs_prefill": err / scale,
            "bound": MODEL_TOL_F32}


def personalized_phase(torch, a_final) -> dict:
    """(S4): generate_personalized at the tiny LM, one request per agent
    of path (a)'s final buffer: base = the mean row, deltas = rows − base,
    against one generate per request on base + delta_i, token for token."""
    from repro_torch.core import flat as flat_lib
    from repro_torch.core.draws import Draws
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model
    model = build_model(train.tiny_lm_config())
    draws = Draws(11, DEVICE)
    spec = flat_lib.make_flat_spec(model.init(draws))
    rows = a_final.to(DEVICE)
    base = rows.mean(dim=0)
    deltas = rows - base
    del rows
    b = deltas.shape[0]
    prompt = torch.randint(0, model.cfg.vocab_size, (b, SERVE_PROMPT),
                           generator=draws.generator, device=DEVICE)
    seqs, secs, peak = timed_generate(torch, lambda: serve.generate_personalized(
        model, spec, base, deltas, prompt, max_new_tokens=SERVE_NEW))
    check_served(torch, "personalized", seqs, prompt, model.cfg.vocab_size)
    t0 = time.perf_counter()
    for i in range(b):
        naive = serve.generate(model, spec.unravel(base + deltas[i]),
                               prompt[i:i + 1], max_new_tokens=SERVE_NEW)
        check(torch.equal(naive, seqs[i:i + 1]),
              f"[serve] (S4) request {i}: the batched tokens differ from "
              f"its own generate's")
    torch.cuda.synchronize()
    naive_s = time.perf_counter() - t0
    steps = SERVE_PROMPT + SERVE_NEW
    row = {"batch": b, "d": spec.d, "generate_personalized_s": secs,
           "ms_per_step": 1e3 * secs / steps, "naive_loop_s": naive_s,
           "naive_ms_per_step": 1e3 * naive_s / steps, "peak_bytes": peak,
           "equal_to_naive": True}
    log(f"[serve] (S4) personalized tiny LM ({spec.d:,} params), B {b} "
        f"agents of path (a): {secs:.2f} s, {row['ms_per_step']:.2f} ms a "
        f"decode step (host clock, synchronized), peak {peak / 1e9:.2f} "
        f"GB; the naive loop ({b} generate calls) {naive_s:.2f} s; tokens "
        f"equal to the naive loop's")
    del base, deltas
    torch.cuda.empty_cache()
    return row


def checkpoint_phase(torch) -> dict:
    """--ckpt-dir on path (a).  Without zstandard the trainer must fail
    before its first step with the reference's message, launching
    nothing and writing nothing.  With it, the checkpoint must load back
    equal to the run's state bit for bit, and serving agent 0 from it
    (launch/serve.py --ckpt) must decode what the in-memory agent 0
    decodes."""
    import shutil
    from repro_torch.kernels import ops
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        import zstandard  # noqa: F401
    except ImportError as err:
        probe = f"{type(err).__name__}: {err}"
        ops.reset_launch_counts()
        try:
            train_path(torch, "pallas", False, "sgd", ckpt_dir=str(ckpt_dir))
        except ModuleNotFoundError as err2:
            message = str(err2)
        else:
            raise Failure("--ckpt-dir trained without zstandard")
        check("zstandard" in message and message.startswith(
            "checkpointing needs"), f"[ckpt] unexpected message: {message}")
        check(sum(ops.launch_counts().values()) == 0
              and not ckpt_dir.exists(),
              "[ckpt] --ckpt-dir failed after the first step")
        log(f"[ckpt] zstandard does not import on this machine ({probe}): "
            f"--ckpt-dir fails before the first step with the reference's "
            f"message ({message!r}); the checkpoint round trip waits for "
            f"zstandard on this machine")
        return {"zstandard": False, "probe": probe, "message": message,
                "round_trip": "waits for zstandard on this machine"}
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import serve, train
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    state, _, timing, _ = train_path(torch, "pallas", False, "sgd",
                                     ckpt_dir=str(ckpt_dir))
    tree = load_checkpoint(str(ckpt_dir))
    check(int(tree["step"]) == state.step == TRAIN_STEPS + 1,
          f"[ckpt] step {int(tree['step'])}, state {state.step}")
    for got, want in zip(leaves(tree["params"]), leaves(state.params)):
        check(torch.equal(got.to(DEVICE), want),
              "[ckpt] a loaded leaf differs from the run's state")
    model = build_model(train.tiny_lm_config())
    prompt = torch.arange(2 * SERVE_PROMPT, device=DEVICE).view(2, -1)
    served = serve.generate(model, serve.load_agent_params(
        str(ckpt_dir), 0, DEVICE), prompt, max_new_tokens=8)
    in_memory = serve.generate(model, tree_map(lambda x: x[0],
                                               state.params),
                               prompt, max_new_tokens=8)
    check(torch.equal(served, in_memory),
          "[ckpt] serving the checkpoint differs from serving the state")
    size = sum(p.stat().st_size for p in ckpt_dir.iterdir())
    log(f"[ckpt] path (a) --ckpt-dir: {size / 1e9:.2f} GB on disk, loads "
        f"back bit for bit (step {int(tree['step'])}); serving agent 0 "
        f"from it decodes what the state decodes")
    del state, tree
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"zstandard": True, "bytes": size, "round_trip": "bit for bit",
            "loop_s": timing["loop_s"]}


def serve_phase(torch, a_final) -> dict:
    """(S1)-(S3), (S4) and the checkpoint phase, each with its wall
    time."""
    runs = [(name, lambda n=name, b=batch, seed=seed: serve_model(
        torch, n, b, seed)) for seed, (name, batch) in enumerate(SERVE_MODELS)]
    runs += [("personalized", lambda: personalized_phase(torch, a_final)),
             ("checkpoint", lambda: checkpoint_phase(torch))]
    out = {}
    for name, run in runs:
        t0 = time.perf_counter()
        out[name] = run()
        out[name]["phase_s"] = time.perf_counter() - t0
        log(f"[serve] {name}: {out[name]['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the paper's §4 experiments (repro_torch.experiments)
# ---------------------------------------------------------------------------

# fig4's finals on the card against the same lattice on the CPU, relative
PAPER_REL_TOL = 1e-9
# fig4's steady lattice steps: timed (host clock), and profiled as the
# difference of a long and a short run (set-up taken out)
PAPER_TIMED_STEPS = 1000
PAPER_PROFILE_STEPS = (20, 220)


def _fig4_lattice(torch, steps: int):
    """``steps`` steps of fig4's full lattice (R 80) on the card, with the
    port's own draws; returns the host seconds (synchronized)."""
    from repro_torch.core.draws import RoundDraws
    from repro_torch.experiments import common, fig4_convergence as fig4
    problem, _, plan, lr_fn, seed_ids = fig4.make_setup()
    draws = RoundDraws(fig4.SEED, seed_ids, plan.h, steps, n=fig4.N,
                       k=fig4.K, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    common.run_lattice(problem, plan, lr_fn, draws, steps, DEVICE)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _fig4_profile(torch, step_ms: float) -> dict:
    """fig4's lattice under torch.profiler (device activity only): device
    ops and device ms per step from the difference of two runs, and the
    busy share against the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile
    runs = {}
    for steps in PAPER_PROFILE_STEPS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _fig4_lattice(torch, steps)
        trace = ROOT / "build" / "chip_smoke_paper_trace.json"
        trace.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        trace.unlink()
        runs[steps] = (len(events), sum(e["dur"] for e in events) / 1e3)
    (short, (n0, ms0)), (long, (n1, ms1)) = sorted(runs.items())
    if n1 == 0:
        log("[paper] the profiler traced no device time: not measured")
        return {"traced": False}
    ops = (n1 - n0) / (long - short)
    device_ms = (ms1 - ms0) / (long - short)
    return {"traced": True, "steps": [short, long],
            "device_ops_per_step": ops, "device_ms_per_step": device_ms,
            "step_ms_unprofiled": step_ms,
            "device_busy_share": device_ms / step_ms}


def paper_phase(torch) -> dict:
    """The paper's §4 experiments through their drivers' entry points:
    fig4 at the paper's settings (R 80, n 20, d 25, T 5000, f64, seed 42)
    on the card and again on the CPU with the same host-made draws (finals
    within PAPER_REL_TOL, no kernel of #1-#17 launched: its mix is one f64
    torch.bmm), its eight claims; its steady step time and profile; then
    theory_check (B1, B2), fig2 (F1, F2), table1 (T1-T3) and
    ablation_server (S1), each timed.  Any failed check fails the run."""
    import numpy as np
    from repro_torch.experiments import ablation_server, fig2_alpha
    from repro_torch.experiments import fig4_convergence as fig4
    from repro_torch.experiments import table1_lambda2, theory_check
    from repro_torch.kernels import ops
    out = {}

    def claims(name, lines, need):
        for line in lines:
            log(f"[paper] {name} {line}")
        passed = [line for line in lines[:need] if ": PASS" in line]
        check(len(passed) == need, f"[paper] {name}: {len(passed)}/{need} "
                                   f"checks passed")
        return lines

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, finals, last = fig4.run_experiment(device=DEVICE)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    check(not launched, f"[paper] fig4 launched {launched}; its mix is a "
                        f"plain f64 product")
    t0 = time.perf_counter()
    _, _, cpu_last = fig4.run_experiment(device="cpu")
    cpu_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(last - cpu_last) / np.abs(cpu_last)))
    check(rel <= PAPER_REL_TOL, f"[paper] fig4: the card's finals differ "
                                f"from the CPU's by {rel:.3e} relative "
                                f"(limit {PAPER_REL_TOL})")
    lines = claims("fig4", fig4.validate(finals), 8)
    log(f"[paper] fig4 (R 80, n 20, d 25, T {fig4.T}, f64, seed "
        f"{fig4.SEED}): 8/8 claims; card {card_s:.2f} s "
        f"({fig4.T / card_s:.1f} lattice steps/s, set-up included), CPU "
        f"twin {cpu_s:.2f} s; per-run finals max rel |card − CPU| "
        f"{rel:.3e} (limit {PAPER_REL_TOL})")
    _fig4_lattice(torch, 50)                            # warm
    step_ms = 1e3 * _fig4_lattice(torch, PAPER_TIMED_STEPS) / \
        PAPER_TIMED_STEPS
    profile = _fig4_profile(torch, step_ms)
    log(f"[paper] fig4 lattice step {step_ms:.4f} ms (host clock over "
        f"{PAPER_TIMED_STEPS} steps, synchronized)"
        + (f"; {profile['device_ops_per_step']:.1f} device ops and "
           f"{profile['device_ms_per_step']:.4f} device ms a step "
           f"({100 * profile['device_busy_share']:.1f}% busy)"
           if profile["traced"] else ""))
    out["fig4"] = {"wall_s": card_s, "cpu_wall_s": cpu_s,
                   "steps_per_s": fig4.T / card_s, "max_rel_err": rel,
                   "finals": {"/".join(map(str, k)): v
                              for k, v in finals.items()},
                   "claims": lines, "step_ms": step_ms, "profile": profile}

    t0 = time.perf_counter()
    sub, bound, inp = theory_check.run_experiment(device=DEVICE)
    wall = time.perf_counter() - t0
    lines = claims("theory_check", theory_check.validate(sub, bound, inp),
                   2)
    out["theory_check"] = {"wall_s": wall, "claims": lines,
                           "max_ratio": float((sub / bound).max())}
    t0 = time.perf_counter()
    lines = claims("fig2", fig2_alpha.validate(
        fig2_alpha.empirical_contractions(device=DEVICE)), 2)
    out["fig2"] = {"wall_s": time.perf_counter() - t0, "claims": lines}
    t0 = time.perf_counter()
    _, table = table1_lambda2.run_experiment()
    lines = claims("table1", table1_lambda2.validate(table), 3)
    out["table1"] = {"wall_s": time.perf_counter() - t0, "claims": lines}
    t0 = time.perf_counter()
    rows = ablation_server.run_experiment(device=DEVICE)
    lines = claims("ablation_server", ablation_server.validate(rows), 1)
    out["ablation_server"] = {"wall_s": time.perf_counter() - t0,
                              "claims": lines, "rows": rows}
    for name in ("theory_check", "fig2", "table1", "ablation_server"):
        log(f"[paper] {name}: {out[name]['wall_s']:.2f} s")
    ops.reset_launch_counts()
    return out


# The ELL kernels timed by --mix-timing: the main path's (#2 gossip, #4
# sgd and momentum) and the lattice's (#6, #8)
MIX_TIMING = {"gossip_mix_sparse": ["gossip"],
              "update_mix_sparse": ["sgd", "momentum"],
              "gossip_mix_sparse_batched": ["gossip"],
              "update_mix_sparse_batched": ["sgd", "momentum"]}


def mix_timing(torch) -> dict:
    """The ELL kernels at the main path's shape (n = 8, D = 156,519,168;
    R = 2 for the lattice's), timed as the median of 9 repeats beside one
    copy of x, the single-run ones checked against their plain versions
    first (a lattice-sized check would not fit beside the inputs): the
    --mix-timing mode, which compares two trees of the package on one
    card (run each tree's package in turn, in one call)."""
    out = {}
    t = make_inputs(torch, N_AGENTS, D_FULL, seed=1)
    for kernel in ("gossip_mix_sparse", "update_mix_sparse"):
        for variant in MIX_TIMING[kernel]:
            run, plain, _ = calls(kernel, variant, t)
            got = run()
            torch.cuda.synchronize()
            err, scale = max_err(torch, got, plain())
            del got
            check(err <= TOL * scale, f"{kernel}[{variant}]: max_abs_err "
                                      f"{err:.3e} > {TOL}·{scale:.3e}")
            torch.cuda.empty_cache()
            out[f"{kernel}[{variant}]"] = time_ms(torch, run, repeats=9)
    out["copy"] = stream_ms(torch, t["x"])
    del t
    torch.cuda.empty_cache()
    t = make_lattice_inputs(torch, R_FULL, N_AGENTS, D_FULL, seed=2,
                            graphs=lattice_graphs(R_FULL, N_AGENTS))
    for kernel in ("gossip_mix_sparse_batched", "update_mix_sparse_batched"):
        for variant in MIX_TIMING[kernel]:
            run = batched_calls(kernel, variant, t)[0]
            out[f"{kernel}[{variant}]"] = time_ms(torch, run, repeats=9)
    del t
    torch.cuda.empty_cache()
    return out


# the low-rank codec's SVDs: path (z)'s batch and one full-width row
SVD_SHAPES = [(8, 768, 24_407), (1, 12_336, 12_688)]
SVD_DRIVERS = [None, "gesvd", "gesvdj"]


def svd_timing(torch) -> dict:
    """torch.linalg.svd (full_matrices=False, f32), the low-rank codec's
    call, at SVD_SHAPES under each cuSOLVER driver (None: PyTorch's
    choice, which the codec takes), one timed call each (host clock,
    synchronized) after a small SVD has set the solver up, on a rank-8
    matrix plus unit noise: the --svd-timing mode."""
    torch.linalg.svd(torch.randn(1, 64, 96, device=DEVICE),
                     full_matrices=False)
    out = {}
    gen = torch.Generator(device=DEVICE)
    for shape in SVD_SHAPES:
        gen.manual_seed(0)
        r, d1, d2 = shape
        m = torch.randn(r, d1, LOWRANK_RANK, device=DEVICE, generator=gen) \
            @ torch.randn(r, LOWRANK_RANK, d2, device=DEVICE, generator=gen)
        m.add_(torch.randn(shape, device=DEVICE, generator=gen))
        for driver in SVD_DRIVERS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sig = torch.linalg.svd(m, full_matrices=False, driver=driver)[1]
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            key = f"{r}x{d1}x{d2}/{driver or 'default'}"
            out[key] = {"ms": ms, "sigma": sig[0, :LOWRANK_RANK + 1].tolist()}
            log(f"[svd] {key}: {ms:.1f} ms, σ_1..σ_9 "
                f"{[round(v, 4) for v in out[key]['sigma']]}")
            del sig
        del m
    return out


# ---------------------------------------------------------------------------
# Phase 8: the dry run (launch/steps.py, launch/dryrun.py) against the card
# ---------------------------------------------------------------------------

# program -> (the kernel its path launches, its launches a call): path
# (c)'s step (the tiny LM's flat trainer at full width, 8 agents, batch 2,
# S 128, pallas, fused momentum: #3) and that step at S 1,024 with remat on
# and off (REMAT_PROGRAMS), (M2)'s (DeepSeek-V3-671B at its 3
# dense layers, one agent, batch 1, S 512, bf16 weights, pallas: #1) and
# Qwen1.5-4B's full-width prefill (B 1, S 4096, bf16 weights,
# impl='pallas': #15 once a layer) and its chunked prefill at S 32,768
# (B 1, impl='xla': chunks of 512 queries, no kernel)
DRYRUN_PROGRAMS = {"c": ("update_mix", 1), "c S1024": ("update_mix", 1),
                   "c S1024 remat off": ("update_mix", 1),
                   "M2": ("gossip_mix", 1),
                   "qwen1.5-4b prefill": ("flash_attention", 40),
                   "qwen1.5-4b prefill 32k": (None, 0)}
# the peak above the arguments, predicted on the host against measured
DRYRUN_PEAK_RTOL = 0.10
# path (c)'s programs -> (S, remat): at S 1,024 line 4's activations set
# the peak (the trace: 15.5 GB above the arguments rematerialised, 51.6 GB
# kept), at S 128 its gradient rows do (15.0 GB both ways)
REMAT_PROGRAMS = {"c": (128, True), "c S1024": (1024, True),
                  "c S1024 remat off": (1024, False)}
# trace_step's steps (calls) a program: three; none of the 32k prefill,
# whose one call takes ~19 s on the card (its breakdown: PERF.md), nor of
# the S 1,024 pair, run for their peaks
DRYRUN_STEPS = 3
DRYRUN_CALLS = {"qwen1.5-4b prefill 32k": 0, "c S1024": 0,
                "c S1024 remat off": 0}
# the chunked prefill's logits against the one block's: Qwen1.5-4B at
# full depth, B 1, S 4096 (8 chunks), impl='xla', × max|logit|
CHUNK_CHECK_SEQ, CHUNK_CHECK_TOL = 4096, 1e-4


def dryrun_lowerable(name: str) -> tuple:
    """(Lowerable, config, ShapeConfig) of a phase-8 program, built as
    the dry run builds its records."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import steps, train
    from repro_torch.sharding import MeshAxes
    if name.startswith("qwen1.5-4b prefill"):
        cfg = get_config("qwen1.5-4b")
        shape = ShapeConfig("prefill_32k", 32768, 1, "prefill") \
            if name.endswith("32k") else \
            ShapeConfig("prefill_4k", 4096, 1, "prefill")
        axes = MeshAxes(("data",), "model", {"data": 1, "model": 1})
        return (steps.build_prefill_lowerable(
            cfg, shape, axes, impl="xla" if name.endswith("32k")
            else "pallas"), cfg, shape)
    remat = True
    impl, fuse, opt, _ = PATHS["c"] if name in REMAT_PROGRAMS \
        else BF16_PATHS[name][:4]
    if name in REMAT_PROGRAMS:
        seq, remat = REMAT_PROGRAMS[name]
        cfg, agents, batch = train.tiny_lm_config(), N_AGENTS, 2
    else:
        kw = BF16_PATHS[name][4]
        cfg = dataclasses.replace(get_config(kw["arch"]),
                                  num_layers=kw["layers"])
        agents, batch, seq = kw["agents"], kw["batch"], kw["seq"]
    axes = MeshAxes(("data",), "model", {"data": agents, "model": 1})
    shape = ShapeConfig(f"path_{name}", seq, agents * batch, "train")
    fed = FedConfig(n_agents=agents, h=10, k=2, gossip_impl=impl)
    return (steps.build_train_lowerable(
        cfg, shape, axes, fed=fed, state_layout="flat",
        fuse_update_mix=fuse, optimizer=opt, microbatches=1, remat=remat),
        cfg, shape)


def dryrun_program(torch, name: str) -> dict:
    """One program traced on the host (meta tensors) and then run once on
    the card under the same tally: the FLOPs and op counts must be equal,
    the fake trace's kernel ops equal to the wrappers' launch counts of
    the card's run, and the predicted peak above the arguments within
    DRYRUN_PEAK_RTOL of max_memory_allocated above the bytes allocated
    before the call.  Then trace_step's breakdown of DRYRUN_STEPS calls
    beside the dry run's roofline at the card's figures."""
    from repro_torch.kernels import ops
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch.profile import trace_step
    from repro_torch.launch.trace_analysis import tally
    kernel, count = DRYRUN_PROGRAMS[name]
    low, cfg, shape = dryrun_lowerable(name)
    lowered = low.lower()
    fake = lowered.costs
    device = torch.device(DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    fn = low.make_fn(device)
    args = low.make_args(device, 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, real = tally(fn, *args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    del out, args
    predicted = fake.temp_bytes
    gap = (predicted - measured) / measured
    report = analysis.roofline_terms(
        name=name, chips=low.world, per_device_flops=fake.flops,
        per_device_bytes=fake.traffic_bytes,
        collective_bytes=fake.collective_bytes,
        model_flops=dryrun._model_flops(cfg, shape),
        compute_dtype=cfg.compute_dtype)
    gc.collect()
    torch.cuda.empty_cache()

    def run(calls: int) -> None:
        call_args = low.make_args(device, 0)
        for _ in range(calls):
            fn(*call_args)
        torch.cuda.synchronize()

    calls = DRYRUN_CALLS.get(name, DRYRUN_STEPS)
    breakdown = trace_step(run, calls, trace_dir=ROOT / "build") \
        if calls else {"traced": False}
    gc.collect()
    torch.cuda.empty_cache()
    bound_ms = 1e3 * max(report.compute_s, report.memory_s)
    out = {"kernel": kernel, "trace_s": lowered.trace_s,
           "fake": {"ops": fake.ops, "flops": fake.flops,
                    "traffic_bytes": fake.traffic_bytes,
                    "launches": fake.launches, **fake.memory()},
           "card": {"ops": real.ops, "flops": real.flops,
                    "traffic_bytes": real.traffic_bytes,
                    "launches": launches, "tally_launches": real.launches,
                    "peak_above_args": measured},
           "peak_gap": gap, "roofline": report.row(),
           "roofline_bound_ms": bound_ms, "trace_step": breakdown}
    dev_ms = breakdown.get("device_ms_per_step", 0.0)
    card_s = "" if dev_ms else " (not profiled here)"
    log(f"[dryrun] {name}: host trace {lowered.trace_s:.1f} s, {fake.ops} "
        f"ops, {fake.flops:.4e} FLOPs, {fake.traffic_bytes / 1e9:.2f} GB "
        f"moved, launches {fake.launches}; the card: {real.ops} ops, "
        f"{real.flops:.4e} FLOPs, launches {launches}; peak above the "
        f"arguments predicted {predicted / 1e9:.3f} GB, measured "
        f"{measured / 1e9:.3f} GB ({100 * gap:+.2f}%); roofline (H100 SXM, "
        f"700 W, {str(cfg.compute_dtype).removeprefix('torch.')}): compute "
        f"{report.compute_s * 1e3:.3f} ms, memory {report.memory_s * 1e3:.3f}"
        f" ms → {report.dominant}; device {dev_ms:.3f} ms a call{card_s} "
        f"({100 * bound_ms / dev_ms if dev_ms else 0.0:.1f}% of it the "
        f"bound); by group (ms a call): "
        + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(
            breakdown.get("groups_ms_per_step", {}).items(),
            key=lambda kv: -kv[1])))
    top = breakdown.get("top_ms_per_step", [])[:3]
    if top:
        log(f"[dryrun] {name}: top kernels (ms, launches a call): "
            + "; ".join(f"{n[:60]} {ms:.3f} ×{c:.0f}" for n, ms, c in top))
    check(real.ops == fake.ops and real.flops == fake.flops,
          f"[dryrun] {name}: the fake trace's {fake.ops} ops and "
          f"{fake.flops:.6e} FLOPs differ from the card's {real.ops} and "
          f"{real.flops:.6e}")
    check(fake.launches == launches == real.launches,
          f"[dryrun] {name}: the fake trace's kernel ops {fake.launches} "
          f"differ from the card's launches {launches} (tally "
          f"{real.launches})")
    got = launches.get(kernel, 0) if kernel else sum(launches.values())
    check(got == count,
          f"[dryrun] {name}: {kernel or 'a kernel'} launched {got} times, "
          f"expected {count}")
    check(abs(gap) <= DRYRUN_PEAK_RTOL,
          f"[dryrun] {name}: predicted peak {predicted} B is "
          f"{100 * gap:+.2f}% from the measured {measured} B (limit "
          f"±{100 * DRYRUN_PEAK_RTOL:.0f}%)")
    return out


def dryrun_tp_program(torch, card: dict) -> dict:
    """(p1)'s step (phase 4i) traced on the host, rank 0 of a fake world
    of A·M ranks on meta tensors, against rank 0's tallied step in the
    card's gloo world (``card``): ops, FLOPs and kernel launches equal,
    the predicted peak above the arguments within DRYRUN_PEAK_RTOL of
    the measured one."""
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.launch.steps import _fake_world
    from repro_torch.launch.trace_analysis import tally
    _, a, m, *_ = TP_PATHS["p1"]
    t0 = time.perf_counter()
    with _fake_world(a * m):
        mesh = make_fed_mesh(a, m, device="meta")
        prog = tp_program(torch, "p1", "meta", mesh)
        _, fake = tally(prog["step"], prog["state"], prog["batches"][0],
                        prog["draws"])
        del prog
    trace_s = time.perf_counter() - t0
    measured = card["peak_above_args"]
    gap = (fake.temp_bytes - measured) / measured
    out = {"kernel": "gossip_mix", "trace_s": trace_s,
           "fake": {"ops": fake.ops, "flops": fake.flops,
                    "traffic_bytes": fake.traffic_bytes,
                    "launches": fake.launches,
                    "collective_counts": fake.collective_counts,
                    **fake.memory()},
           "card": card, "peak_gap": gap}
    log(f"[dryrun] p1 (phase 4i, rank 0 of a {a} x {m} world): host trace "
        f"{trace_s:.1f} s, {fake.ops} ops, {fake.flops:.4e} FLOPs, "
        f"launches {fake.launches}, collectives {fake.collective_counts}; "
        f"the card's gloo run: {card['ops']} ops, {card['flops']:.4e} "
        f"FLOPs, launches {card['launches']}, collectives "
        f"{card['collective_counts']}; peak above the arguments predicted "
        f"{fake.temp_bytes / 1e9:.3f} GB, measured {measured / 1e9:.3f} GB "
        f"({100 * gap:+.2f}%)")
    check(card["ops"] == fake.ops and card["flops"] == fake.flops,
          f"[dryrun] p1: the fake trace's {fake.ops} ops and "
          f"{fake.flops:.6e} FLOPs differ from the card's {card['ops']} and "
          f"{card['flops']:.6e}")
    check(fake.launches == card["launches"] == card["tally_launches"],
          f"[dryrun] p1: the fake trace's kernel ops {fake.launches} differ "
          f"from the card's launches {card['launches']} (tally "
          f"{card['tally_launches']})")
    check(abs(gap) <= DRYRUN_PEAK_RTOL,
          f"[dryrun] p1: predicted peak {fake.temp_bytes} B is "
          f"{100 * gap:+.2f}% from the measured {measured} B (limit "
          f"±{100 * DRYRUN_PEAK_RTOL:.0f}%)")
    return out


def chunked_logits_check(torch) -> dict:
    """Qwen1.5-4B at full depth and width, B 1, S CHUNK_CHECK_SEQ,
    impl='xla': the chunked prefill's logits against the one block's
    (``attn_chunked_prefill`` off), within CHUNK_CHECK_TOL·max|logit|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.draws import Draws
    from repro_torch.models import build_model
    cfg = get_config("qwen1.5-4b")
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = model.init(Draws(0, DEVICE))
    gen = torch.Generator().manual_seed(5)
    s = CHUNK_CHECK_SEQ
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s),
                                     generator=gen).to(DEVICE),
             "positions": torch.arange(s, device=DEVICE)[None]}
    out = {}
    with torch.inference_mode():
        for chunked in (True, False):
            m = build_model(dataclasses.replace(
                cfg, attn_chunked_prefill=chunked))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out[chunked] = m.logits(params, batch, remat=False).float()
            torch.cuda.synchronize()
            out[f"ms_{chunked}"] = 1e3 * (time.perf_counter() - t0)
            out[f"peak_{chunked}"] = torch.cuda.max_memory_allocated() - base
    err = (out[True] - out[False]).abs().max().item()
    scale = out[False].abs().max().item()
    del params, out[True], out[False]
    gc.collect()
    torch.cuda.empty_cache()
    row = {"seq": s, "max_abs_diff": err, "scale": scale,
           "tol": CHUNK_CHECK_TOL, "chunked_ms": out["ms_True"],
           "one_block_ms": out["ms_False"],
           "chunked_peak_above_args": out["peak_True"],
           "one_block_peak_above_args": out["peak_False"]}
    log(f"[dryrun] qwen1.5-4b chunked prefill at S {s}, B 1, impl='xla', "
        f"full depth: logits {err:.3e} from the one block's (limit "
        f"{CHUNK_CHECK_TOL}·{scale:.3e}); {row['chunked_ms']:.1f} / "
        f"{row['one_block_ms']:.1f} ms, peak above the weights "
        f"{row['chunked_peak_above_args'] / 1e9:.2f} / "
        f"{row['one_block_peak_above_args'] / 1e9:.2f} GB (chunked / one "
        f"block, first calls)")
    check(err <= CHUNK_CHECK_TOL * scale,
          f"[dryrun] qwen1.5-4b chunked prefill: logits {err:.3e} from the "
          f"one block's > {CHUNK_CHECK_TOL}·{scale:.3e}")
    return row


def remat_peak_check(out: dict) -> dict:
    """Path (c)'s step at S 1,024: the rematerialised program's measured
    peak above the arguments below the one that keeps every activation
    (each already within DRYRUN_PEAK_RTOL of its trace)."""
    on, off = (out[name]["card"]["peak_above_args"]
               for name in ("c S1024", "c S1024 remat off"))
    row = {"seq": 1024, "remat_on_peak_above_args": on,
           "remat_off_peak_above_args": off, "saved_bytes": off - on}
    log(f"[dryrun] path (c) at S 1024: peak above the arguments "
        f"{on / 1e9:.3f} GB with remat, {off / 1e9:.3f} GB without "
        f"({(off - on) / 1e9:.3f} GB saved, {off / on:.2f}×)")
    check(on < off, f"[dryrun] path (c) at S 1024: the rematerialised peak "
                    f"{on} B is not below the {off} B kept without remat")
    return row


def dryrun_phase(torch, tp_paths: dict) -> dict:
    out = {name: dryrun_program(torch, name) for name in DRYRUN_PROGRAMS}
    out["remat_peak"] = remat_peak_check(out)
    out["p1"] = dryrun_tp_program(torch, tp_paths["p1"]["tally"])
    out["chunked_logits"] = chunked_logits_check(torch)
    return out


def step_profile(torch) -> dict:
    """Path (c) alone: its warm step time (run_path) and its profile, for
    ``--step-profile DIR``."""
    impl, fuse, opt, kernel = PATHS["c"]
    _, run = run_path(torch, "c", impl, fuse, opt, kernel)
    torch.cuda.empty_cache()
    return {"step_ms": run["step_ms"], "peak_bytes": run["peak_bytes"],
            "profile": profile_phase(torch, run["step_ms"])}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # python3 chip_smoke.py --mix-timing DIR: only mix_timing,
    # --gap-table DIR: only mamba2_gap_table, --step-profile DIR: only
    # step_profile, and --svd-timing DIR: only svd_timing, on the package
    # under DIR/src
    modes = {"--mix-timing": (mix_timing, "ms"),
             "--gap-table": (mamba2_gap_table, "gap_table"),
             "--step-profile": (step_profile, "path_c"),
             "--svd-timing": (svd_timing, "svd")}
    mode = sys.argv[1] if sys.argv[1:2] and sys.argv[1] in modes else None
    src = Path(sys.argv[2]).resolve() / "src" if mode else ROOT / "src"
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import build
    if mode:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        build.load()
        fn, key = modes[mode]
        print(json.dumps({"src": str(src), "nvidia_smi": smi,
                          key: fn(torch)}), flush=True)
        return 0

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name} × {count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    built = build.load()
    log(f"[build] {built.directory} in {built.build_seconds:.1f} s; "
        f"ptxas -v:")
    for line in built.ptxas_log.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            log("  " + line.strip())

    t0 = time.perf_counter()
    kernels = kernel_phase(torch)
    kernels.update(batched_kernel_phase(torch))
    for kernel, rows in [*shard_block_phase(torch).items(),
                         ("gossip_mix", column_block_phase(torch)),
                         *tp_leaf_phase(torch).items()]:
        kernels[kernel]["variants"].update(rows["variants"])
        kernels[kernel]["max_abs_err"] = max(kernels[kernel]["max_abs_err"],
                                             rows["max_abs_err"])
    kernels.update(compress_kernel_phase(torch))
    kernels.update(batched_ef_kernel_phase(torch))
    f64_errs = f64_kernel_phase(torch)
    bf16_kernels = bf16_kernel_phase(torch)
    kernels.update(zoo_kernel_phase(torch))
    log(f"[kernels] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training, a_final, finals = training_phase(torch)
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_paths = sharded_phase(torch, finals)
    del finals
    log(f"[sharded] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh2d_paths = mesh2d_phase(torch)
    log(f"[mesh2d] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp_paths = tp_phase(torch)
    log(f"[tp] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tree_paths = tree_phase(torch, a_final)
    log(f"[tree] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    delta_paths = delta_phase(torch, a_final)
    log(f"[delta] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    population = population_phase(torch)
    log(f"[population] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f64_paths = f64_path_phase(torch)
    log(f"[f64] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf16_paths = bf16_path_phase(torch)
    log(f"[bf16] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    grads = grad_phase(torch)
    log(f"[grad] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    profile = profile_phase(torch, training["c"]["step_ms"])
    profile["remat_off"] = profile_phase(
        torch, training["c_remat_off"]["step_ms"], remat=False)
    ops_per_step = profile.get("launches_per_step", 0)
    ops_off = profile["remat_off"].get("launches_per_step", 0)
    check(ops_off < OPS_PER_STEP_MAX,
          f"[profile] path (c) with remat off issues {ops_off:.0f} device "
          f"ops a step (limit {OPS_PER_STEP_MAX}): line 4 is not one "
          f"batched pass")
    check(ops_per_step < REMAT_OPS_PER_STEP_MAX,
          f"[profile] path (c) issues {ops_per_step:.0f} device ops a step "
          f"(limit {REMAT_OPS_PER_STEP_MAX}): line 4 is not one batched "
          f"pass and one recompute")
    check(ops_per_step < REMAT_OPS_RATIO_MAX * ops_off,
          f"[profile] path (c) issues {ops_per_step:.0f} device ops a step, "
          f"{ops_per_step / max(ops_off, 1):.2f}× its {ops_off:.0f} with "
          f"remat off (limit {REMAT_OPS_RATIO_MAX}×): the recompute is more "
          f"than one forward of the groups")
    log(f"[profile] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    models = model_phase(torch)
    log(f"[models] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving = serve_phase(torch, a_final)
    del a_final
    log(f"[serve] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paper = paper_phase(torch)
    log(f"[paper] phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dryrun = dryrun_phase(torch, tp_paths)
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s")

    line = []
    for kernel in REPLACES:
        if kernel in ZOO:
            # timed at the first model that runs it; launches from that
            # model's pallas forward
            model = next(iter(ZOO_FULL[kernel]))
            main_variant = kernels[kernel]["variants"][model]
            launches = models[model]["launches"][kernel]
            variant = model
        else:
            variant = PATH_VARIANT[kernel]
            main_variant = kernels[kernel]["variants"][variant]
            # the first path that runs it (#13 runs on none: 0)
            launches = next((p["launches"] for p in training.values()
                             if p.get("kernel") == kernel), 0)
        line.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launches,
            "max_abs_err": kernels[kernel]["max_abs_err"],
            "ms": main_variant["ms"], "plain_ms": main_variant["plain_ms"],
            "bound_ms": main_variant["bound_ms"],
            "bound_by": main_variant["bound_by"],
            "library_ms": main_variant["library_ms"],
            "variant": variant, "variants": kernels[kernel]["variants"]})
        if kernel in f64_errs:
            line[-1]["f64_max_abs_err"] = f64_errs[kernel]
        if "passes_ms" in main_variant:
            line[-1]["passes_ms"] = main_variant["passes_ms"]
        if "mamba2_flat" in kernels[kernel]:
            line[-1]["mamba2_flat"] = kernels[kernel]["mamba2_flat"]
        if kernel in ("gossip_mix", "gossip_mix_sparse", "ef_mix",
                      "ef_mix_sparse"):
            # #1, #2, #9 and #11 on every path that runs them: once a step
            # on the flat buffer (the delta paths too), once per leaf a
            # step on the tree, once a step on each rank of a 2-D path (a
            # list, rank by rank; the tensor-parallel tree's: once per
            # leaf block a step on each rank)
            line[-1]["launches_by_path"] = {
                name: p["launches"] for name, p in
                {**training, **tree_paths, **delta_paths,
                 **sharded_paths, **mesh2d_paths, **tp_paths}.items()
                if p.get("kernel") == kernel}
        if kernel == "gossip_mix_batched":
            # #5 on the sharded lattice (s4), once a step
            line[-1]["launches_by_path"] = {
                name: p["launches"] for name, p in
                {**training, **sharded_paths}.items()
                if p.get("kernel") == kernel}
        if kernel == "gossip_mix_sparse":
            # #2 is the population engine's cohort mix: once a step
            line[-1]["launches_by_path"].update(population_launches(
                population))
    # the mix kernels' bf16 variants: timed at full shape in phase 3c;
    # launches from the bf16 path that runs them ((M1) #3, (M2) #1; the
    # others run on no path: 0)
    for kernel, row in bf16_kernels.items():
        variant = BF16_PATH_VARIANT.get(kernel, PATH_VARIANT[kernel])
        main_variant = row["variants"][variant]
        launches = next((p["launches"] for p in bf16_paths.values()
                         if p["kernel"] == kernel), 0)
        line.append({
            "name": f"{kernel}:bf16", "route": "cuda",
            "source": SOURCES[kernel], "replaces": REPLACES[kernel],
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": main_variant["ms"], "plain_ms": main_variant["plain_ms"],
            "bound_ms": main_variant["bound_ms"],
            "bound_by": main_variant["bound_by"],
            "library_ms": main_variant["library_ms"], "variant": variant,
            "dtype": "bfloat16", "y_share_differing": row["y_share_differing"],
            "variants": row["variants"]})
        flat = next((p["flat_check"] for p in bf16_paths.values()
                     if p["kernel"] == kernel), None)
        if flat is not None:
            line[-1]["max_abs_err"] = max(line[-1]["max_abs_err"],
                                          flat["max_abs_err"])
            line[-1]["path_flat_check"] = flat
    total_s = time.perf_counter() - T_START
    log(f"[smoke] total {total_s:.1f} s (build included)")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "kernels": line,
         "training": training, "tree_paths": tree_paths,
         "delta_paths": delta_paths, "sharded_paths": sharded_paths,
         "mesh2d_paths": mesh2d_paths, "tp_paths": tp_paths,
         "population": population,
         "grads": grads,
         "f64_paths": f64_paths, "bf16_paths": bf16_paths,
         "profile": profile, "models": models, "serve": serving,
         "paper": paper, "dryrun": dryrun,
         "total_s": total_s},
        indent=1))
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
