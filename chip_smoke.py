"""Quickest proof that the PyTorch port runs on the GPU.

  python3 chip_smoke.py

Needs one CUDA card; exits non-zero, and prints no result, without one.
Drives the port (``trpo_robot_control_tpu_torch``) only:

1. names the card and builds the seven CUDA kernels from ``ops/cuda/csrc``
   (the two rollouts one library per joint count, 1-8, and K4 at 7
   joints, K5 and K6 one library per policy shape of phase 8, K1 at 3
   links and K3 one per shape of phase 9, K1, K4 and K3 one per shape of
   phase 10, all in one parallel pass); prints every
   kernel's ``-Xptxas -v`` lines (K4's for each instantiation), then what
   the card makes of each K1 instantiation at c1's and c2's joint counts
   (``rollout_kernel.occupancy`` and the grid at c1's and c2's width; no
   spill stores at 1-3 joints, at least 128 blocks at c2), of each K4
   instantiation (resident blocks and warps per SM from
   ``rollout3d_kernel.occupancy``; at least 16 warps), of K3's at c1's and
   c2's widths (``fvp_kernel.occupancy``) and of K6's two
   (``fvp_ff_kernel.occupancy``);
2. c2 (3-link planar arm, 1024 envs x 100 steps):
   a. K1 rollout kernel against its plain version (eps mode: tight over
      10 steps, looser over the full horizon), then the Philox mode's
      noise statistics and seed determinism, and a SHA-256 of the Philox
      batch at seed K1_SEED (also at c1, 2 links and 64 envs x 50 steps,
      which is held against its plain version too);
   b. K2 moments kernel against its plain version (the Gram summed in
      fp64) on that batch, with the fp32 ``normal_eq_ff`` beside it;
   c. K3 FVP kernel (tensor cores) against its plain version and against
      the statement of its plane products (``gn_fvp_split`` in
      ``tests/test_torch_helpers.py``) on c2's Fisher subsample and on
      c1's (the Fisher batch of K1's Philox batch at K1_SEED), and
      bit-identical repeat calls;
   d. five full-width c2 training iterations through ``trpo.train.train``,
      with the launch counters showing every kernel of that path ran and
      no plain version did;
   e. K1-K3 times (CUDA events, queued behind a sleep of K1_LEAD_MS)
      beside their bounds, plain versions and, for K2, a library
      yardstick; K1 and K3 also at c1, K1 in microseconds per dependent
      step; K3's bound is the tensor-core one (the fp32-FMA figure beside
      it), and K6 on c2's (25, 12, 1024) fp32 subsample is timed as its
      yardstick (K2's time without the lead printed beside);
3. the 7-DoF configs, each at full width with bf16 storage: c3 (reach,
   4096 envs x 200 steps), c4 (reach with the obstacle penalty, 16,384
   envs, Fisher env stride 4) and c5 (reach, track and push tasks, a
   27-wide observation, 65,536 envs, Fisher env stride 8):
   a. K4 3-D rollout kernel in eps mode at full width (fp32 and bf16
      stores) against ``rollout3d_plain`` on every (N / 4096)-th env of
      the same inputs (tight over 8 steps, looser over the full horizon),
      then at full width the Philox mode's noise statistics and seed
      determinism, and a SHA-256 of the Philox batch (signed zeros made
      +0), the digest a kernel that changes no output bit keeps;
   b. K2 in bf16 mode (tensor cores) against its plain version on the
      full-width batch, and bit-identical repeat calls;
   c. K5 surrogate-gradient kernel (bf16 mode, tensor cores) against
      ``surrogate_grad_plain``, and bit-identical repeat calls;
   d. K6 feature-first FVP kernel against its plain version on
      ``obs_ff[::8, :, ::e]``, and bit-identical repeat calls;
   e. five full-width training iterations through ``trpo.train.train``
      (K4, K2, K5 once and K6 ten times per update, no K1/K3, no plain
      version), with the peak device memory;
   f. K4, K2-bf16, K5 and K6 times beside their bounds; K4's bound counts
      the operations of its specialised passes (the fused RNEA sweep's
      figure, with its structural zeros, beside it); K2-bf16's, K5's and
      K6's bounds are the tensor-core ones (their shares printed), with
      the fp32-FMA figures beside them, K6's strided sector reads as a
      note, and K2's library yardstick;
4. early termination, c2 with done_dist 0.1 (K1's TERM instantiation) and
   c5 with done_dist 0.05 (K4's, with the task redraw), each at full
   width:
   a. the kernel in fresh-state mode (the fresh episodes from the
      caller) against its plain version on the same inputs, K4's on every
      16th env: identical done flags and max |kernel - plain| = 0.0 over
      the whole horizon with fp32 stores; K4 with bf16 stores 0 ulps from
      the rounded plain output;
   b. the limit of no done (done_dist 1e-9): in Philox mode the TERM
      instantiation gives the non-terminating one's batch bit for bit;
   c. Philox mode's resets: the fresh state of every early done, read
      back from the next observation, lies in the reset distributions'
      ranges (q, qd, target radius, z >= 0), and c5's fresh task
      families come out within 4 sigma of 1/3 each; the batch's SHA-256;
   d. five full-width training iterations through ``trpo.train.train``,
      launch counts as in 2d / 3e, no plain version, early dones > 0;
   e. the TERM kernels' times beside their bounds, and in turns with the
      same instantiation without a done, the non-terminating kernel and
      TERM at four times the done distance (what the resets cost);
5. c5-planar3 (``c5_planar3``: c5's task mix on a 3-link planar arm,
   65,536 envs x 200 steps, a 15-wide observation, K4 at 3 joints):
   phase 3 with K4 held exactly (0.0 with fp32 stores, 0 ulps from the
   rounded plain output with bf16, over the whole horizon), then phase 4
   at done_dist C5_DONE_DIST, whose Philox resets must put every fresh
   target in the plane (z exactly 0) at a uniform angle;
6. c2-bf16 (``c2_bf16``): K1's bf16 stores 0 ulps from the rounded plain
   output in eps mode and, TERM, in fresh-state mode; K2-bf16 at do 12
   and K3 on the fp32 relayout against their plain versions; five
   training iterations (K1, K2, K3 x 10, no plain version); K1-bf16's
   time beside its bound;
7. every joint count (``other_n_phases``): K1 at 1-8 links and K4 at 1-8
   joints with each (task families, obstacle) pair, fp32 and bf16 stores,
   terminating or not, on 1024 envs x 10 steps against their plain
   versions (0.0, 0 ulps), with each instantiation's occupancy; and K1 at
   8 links timed at c2's width (``k1_n8_record``);
8. policy shapes other than (64, 64) on the 7-DoF path: at each of
   ``POLICY_SHAPES`` (1-3 hidden layers; ``policy_shape_checks``) K4 at
   c3's and c5's observation on 4096 envs x 200 steps, fp32 and bf16
   stores, 0.0 and 0 ulps from its plain version on every 16th env; K5
   in both modes against the fp64 evaluation of its function; K6 against
   its plain version at e = 1 and e = 8; then phase 3 with K4 held exactly
   over the whole horizon on c3-baselines32 (``c3_baselines32``: OpenAI
   Baselines' (32, 32) policy) and c3-deep3 (``c3_deep3``: (64, 64, 64)),
   each trained five full-width iterations (K4, K2, K5 once and K6 ten
   times per update, no plain version) and timed;
9. the same shapes on the planar path (``planar_shape_checks``): K1 at
   c2's arm (1024 envs x 100 steps) in eps mode against its plain version
   (fp32 stores within K1_TIGHT_ATOL over 10 steps and K1_FULL_ATOL over
   the horizon, bf16 stores' ulps and TERM's fresh-state difference
   printed, no spill store), K3 on c2's Fisher subsample and a c1-sized
   one within K3_SHAPE_REL, with their occupancy; then c2-baselines32
   (``c2_baselines32``: Baselines' (32, 32)) and c2-deep3 (``c2_deep3``:
   (64, 64, 64)), each with its K1 digest, trained five full-width
   iterations (K1, K2 once and K3 ten times per update, no K5/K6, no
   plain version) and K1 and K3 timed (``c2_shape_phases``);
10. the unpacked policy forms, widths 65-128 (``wide_shape_checks`` at
   each of ``WIDE_SHAPES``): K1 at c2's arm (fp32 within K1_TIGHT_ATOL /
   K1_FULL_ATOL, bf16 stores, TERM printed, no spill store), K4 at c3's
   arm and c5's observation on 4096 envs x 200 steps against its plain
   version on every 16th env (0.0 and 0 ulps, or, where the plain
   version's matrix product sums in another order, its step-0 actions in
   the fmaf order and phase 3's bounds; TERM 0.0 at RLLAB), K3's wide
   form (split-bf16 products on the tensor cores, a chain of launches) on
   c2's, a c1-sized and c3's fp32 Fisher batch against its plain version
   (K3_SHAPE_REL) and the statement of its arithmetic
   (``gn_fvp_wide_split``, K3_SPLIT_REL), with every launch's occupancy
   and no spill store, up to do 32, da 8; K1, K3 and K4
   timed beside their bounds; then c3-rllab (``c3_rllab``: rllab's
   (100, 50, 25) policy; K4, K2-bf16, the plain surrogate gradient and
   K3 ten times per update on the fp32 relayout, as ``kernel_routes``
   decides) through ``arm3d_phases`` and c2-rllab (``c2_rllab``) through
   ``c2_shape_phases``, each trained five full-width iterations;
11. the MLP value baseline, which sends the update down the batch-major
   branch (``mlp_phases``): c1-, c2- and c3-mlp (``mlp_config``, the
   configs' own baseline_hidden, baseline_lr and baseline_epochs) trained
   five full-width iterations each (K1 or K4 once and K3 ten times an
   update on the n-major Fisher subsample, no K2, K5 or K6, no plain
   version); at c2 and c3 one batch through ``trpo_update`` with and
   without its feature-first keys, held to the update contract
   (``bm_vs_ff``); at c2-mlp 4 iterations straight against 2, a
   checkpoint saved and loaded, and 2 more, bit for bit
   (``resume_check``); K3 on c3-mlp's n-major 102,400 x 24 subsample
   against its plain version and its statement, timed beside its bound,
   with K6 on the same batch's feature-first subsample and the relayout
   timed beside it (``k3_nmajor``);
12. the K-step train loop, ``trpo/train.py:make_train_many``, which on the
   card replays one captured CUDA graph of the train step
   (``train_many_phases``), at c1-c5, c2-term, c5-term and c1-/c2-/c3-mlp
   at full width: TRAIN_MANY_K replays against as many eager steps from
   the same state, bit for bit; the capture's launches equal to one eager
   step's (``step_launches``), no plain version; finite stats and KL <=
   delta in every row; ms an update eager and replayed, the capture's
   seconds and the peak device memory. On each linear path the
   ``fit_normal`` kernel (the ridge solve that replaces eigh, one launch
   an update on every linear path since this phase; none on the MLP
   paths) on that config's first-update normal equations against the
   statement of its arithmetic (``fit_normal_jacobi_statement`` in
   ``tests/test_torch_helpers.py``), the eigh solve and an fp64 one,
   timed beside its bound (the whole card's, one SM's beside it), the
   plain version and ``torch.linalg.eigh`` of the same A_s, with its µs a
   Jacobi round;
13. data parallelism, ``parallel/mesh.py`` (``sharded_phases``), through
   the same kernels: (a) ``make_mesh`` makes a world of one over NCCL in
   this process; at c1-c5 ``make_sharded_update`` on ``shard_batch`` of one
   rollout equals ``trpo_update`` bit for bit with the same launches, and
   at c2 and c5 ``make_train_many(cfg, 3, mesh)`` equals the replayed
   graph of ``make_train_many(cfg, 3)``; all-reduces and bytes an update,
   ms an update sharded and unsharded in turns, one all-reduce's µs;
   (b) SHARD_RANKS gloo ranks spawned on the card (CUDA tensors staged
   through the host) on their ``shard_batch``es of one c2 and one c3
   batch (c3: K6 chosen on the global 102,400-sample subsample, 51,200 a
   rank), bit-identical to each other, the unsharded update's launches on
   each, and the unsharded update's direction (cosine >= 0.999), beta
   (1e-3), accepted exponent and theta (rtol 2e-3, atol 2e-4); c3 on four
   seeds; the summed normal equations within SHARD_MOMENTS_TOL of the
   unsharded ones and the refit within FIT_CAP in the A-norm; ms an
   update and peak memory a rank; then
   ``train_sharded`` for SHARD_TRAIN_ITERS iterations at c2, the ranks bit
   for bit; (c) ``python -m torch.distributed.run --standalone
   --nproc_per_node 1 -m trpo_robot_control_tpu_torch.cli.train --config
   c2_reacher3 --sharded --iters 2`` exits 0;
14. tensor parallelism, ``parallel/tensor.py`` (``tp_phases``): TP_RANKS
   gloo ranks spawned on the card on a (1, TP_RANKS) mesh, the policy's
   first two layers sharded over the 'model' axis; (a) the TP update on one
   c2 and one c3 batch at full width against the unsharded batch-major
   update: ranks bit-identical, one fit_normal launch and no other kernel
   or plain version, direction cosine >= 0.999, beta (1e-3), accepted
   exponent and theta (rtol 2e-3, atol 2e-4); (b) ``train_sharded`` on the
   mesh for TP_TRAIN_ITERS iterations at c2 (K1 and fit_normal once an
   iteration on each rank), the ranks bit for bit; (c) all-reduces and
   bytes on each group and ms a rank per update.

Before the phases it prints the ``-Xptxas -v`` lines of the linear
baseline's two kernels (``fit_normal_kernel``, K2's
``moments_fp32_kernel``) and requires K2's bf16-mode SASS (its tensor-core
kernels and the reduce pass, ``cuobjdump -sass`` with the encodings and
mangled names taken out) to hash to K2_BF16_SASS_SHA256, the digest of
those functions as the design before the one-launch fp32 mode compiled
them: the fp32 redesign left the bf16 mode's code as it was. Phase 2
times K2 fp32 at c2 and at c1 (``k2_times``).

The last lines are the kernels' JSON record (c2/c3 figures at the top
level of each entry, c4/c5/c5-planar3 ones under ``at_c4``/``at_c5``/
``at_c5_planar3``/``at_c3_baselines32``/``at_c3_deep3``, K2's bf16 mode
under ``bf16_mode_c3/c4/c5/...``
and, at c2, ``bf16_mode_c2`` (K1's and K2's), K3 on c2-bf16 under
``at_c2_bf16``, every joint count under ``other_n`` (K1 at 8 links timed
under ``at_n8``), phase 8's shape checks of K4-K6 under
``policy_shapes`` (phase 9's of K1 and K3 too, the c2 paths under
``at_c2_baselines32``/``at_c2_deep3``), phase 10's under
``wide_shapes`` and ``at_c3_rllab``/``at_c2_rllab``, phase 11's under
``at_c1_mlp``/``at_c2_mlp``/``at_c3_mlp`` (K3 on c3-mlp's subsample under
the ``fvp`` entry's ``at_c3_mlp``), and the terminating
instantiations as ``rollout_term``
(c2) and ``rollout3d_term`` (c5, c5-planar3 under ``at_c5_planar3``),
``fit_normal`` at c2, the other linear paths under ``at_<tag>``; phase
12's per-config figures on the ``train_many`` line, phase 13's on the
``sharded`` line and phase 14's on the ``tensor_parallel`` line before
them),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12      # H100 SXM, bf16 tensor cores, dense
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
REPLACES = {
    "rollout": "trpo_robot_control_tpu/ops/pallas/rollout_kernel.py:594",
    "moments": "trpo_robot_control_tpu/ops/pallas/moments_kernel.py:143",
    "fvp": "trpo_robot_control_tpu/ops/pallas/fvp_kernel.py:294",
    "rollout3d": "trpo_robot_control_tpu/ops/pallas/rollout3d_kernel.py:895",
    "pg": "trpo_robot_control_tpu/ops/pallas/pg_kernel.py:312",
    "fvp_ff": "trpo_robot_control_tpu/ops/pallas/fvp_ff_kernel.py:188",
    # no Pallas kernel: the eigh of JAX's fit_normal, which XLA runs
    "fit_normal": "trpo_robot_control_tpu/models/baseline.py:155",
    # the terminating branches of the rollout kernels' bodies
    "rollout_term": "trpo_robot_control_tpu/ops/pallas/rollout_kernel.py:436",
    "rollout3d_term":
        "trpo_robot_control_tpu/ops/pallas/rollout3d_kernel.py:577",
}
SOURCE = "trpo_robot_control_tpu_torch/ops/cuda/csrc/{}.cu"
K1_TIGHT_STEPS, K1_TIGHT_ATOL = 10, 1e-5
# Over the full horizon any fp32 rounding difference (the kernel's MLP sums
# in its own fmaf order, the plain version's in cuBLAS's) feeds back
# through 100 dependent dynamics steps, so the bound is looser.
K1_FULL_ATOL = 1e-2
K2_REL = 1e-5
# SHA-256 of K2's bf16-mode SASS (``k2_bf16_sass``) as the design with a
# two-launch fp32 mode compiled it (nvcc of CUDA 12.9, sm_90a): it shows
# that the one-launch fp32 mode left the bf16 mode's code as it was. Update
# it with a deliberate edit of the bf16 mode or of mma_bf16.cuh, or a new
# nvcc, after checking the new SASS; remove it once the bf16 mode is
# redesigned.
K2_BF16_SASS_SHA256 = \
    "0206a2eeeb3dafcbbd359a745918f6d92b6d759b1ee9fb996445ddfd999c4c32"
K3_REL = 1e-5
# K3 against the statement of its plane products (gn_fvp_split): one fp32
# rounding per product, as tests/test_torch_fvp_bm_split.py holds it
K3_SPLIT_REL = 1e-6
K4_TIGHT_STEPS, K4_TIGHT_ATOL = 8, 1e-5
# K4 runs at full width; its plain version (~50k small ops per step on the
# card) runs on every (N / 4096)-th env of the same inputs (all of c3's):
# envs are independent, so those columns of the kernel's output are what
# the plain version computes.
K4_CHECK_ENVS = 4096
# 200 dependent steps of a 7-DoF arm under gravity amplify any fp32
# rounding difference between the kernel's fmaf MLP sums and cuBLAS's in
# the plain version, so the full-horizon bound is looser, as K1's is.
K4_FULL_ATOL = 1e-2
# (act - mu) / sigma over all Philox draws: mean within +-0.01, std within
# 1 +- 0.01. The tolerance covers the bf16 rounding of act (relative
# 2^-9) and of obs (mu is recomputed from the stored bf16 obs).
K4_Z_TOL = 0.01
K5_REL, K5_MU_ATOL, K5_LOGP_REL = 1e-4, 1e-4, 1e-3
# K5 against the fp64 evaluation with the same bf16 rounding points
# (``pg_fp64``): mu within the slack of its ambiguous roundings plus this,
# g on the samples with no ambiguous rounding within this relative L2;
# a rounding is ambiguous within PG_AMBIG_ULPS fp32 roundings of its
# terms' magnitude (as ``tests/test_torch_helpers.py`` holds it).
PG_MU_FP64_ATOL, PG_G_KEPT_REL, PG_AMBIG_ULPS = 1e-5, 1e-5, 4
K6_REL = 1e-5
# Early termination at full width: c2 and c5 with these done distances
# (the one the JAX tests use for a 7-DoF arm at c5).
C2_DONE_DIST, C5_DONE_DIST = 0.1, 0.05
# Phase 7: each joint count's short launches
OTHER_N_ENVS, OTHER_N_STEPS = 1024, 10
# Fresh states read back from the next observation: q through atan2 of
# its cos/sin rows, qd through the observation's scale, the target as
# (target - ee) + ee with ee from the plain FK; each within this of the
# reset distribution's range.
RESET_TOL = 1e-5


# Phase 8: the policy shapes the TPU's packed kernels take on the 7-DoF
# path (the JAX package's test shapes, Baselines' (32, 32), a 3-layer
# one), each held at kernel level on SHAPE_ENVS envs, K4's plain version on
# every SHAPE_STRIDE-th
POLICY_SHAPES = ((32,), (32, 32), (48, 40), (33, 57), (64,), (64, 64, 64))
SHAPE_ENVS, SHAPE_STRIDE = 4096, 16
# K6 against its plain version at each shape, relative L2 (the (64, 64)
# kernel's bound is K6_REL; it measured <= 2.3e-7)
K6_SHAPE_REL = {hidden: 1e-6 for hidden in POLICY_SHAPES}
# Phase 9: K3 at each of POLICY_SHAPES, relative L2 (K6's bound above; the
# (64, 64) kernel measured <= 3.2e-7)
K3_SHAPE_REL = 1e-6
# K5's fp32 mode against the fp64 evaluation of its (unrounded) function:
# mu's largest error, g's relative L2
PG_FP32_MU_ATOL, PG_FP32_G_REL = 1e-5, 1e-5


# Philox-mode seeds of the K4 digests and timings (phases 3a, 3f, 4)
K4_SEED_A, K4_SEED_T = (4242, 17), (7, 7)
# Philox-mode seed of the K1 digests at c1, c2 and c2-term (phases 2a, 4c)
K1_SEED = (2468, 13)
# K1 takes about as long as its wrapper's host work, so its timings queue
# the launches behind a sleep kernel of this many ms (``cuda_ms``)
K1_LEAD_MS = 20.0


def require(ok: bool, what) -> None:
    """A check that stays under ``python -O``."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, lead_ms: float = 0.0) -> float:
    """Device ms per call of ``fn`` over ``iters`` calls after ``warmup``.
    With ``lead_ms`` a sleep kernel of about that length runs first, so that
    the host has queued every timed call before the card reaches the first:
    the time of a kernel shorter than its wrapper's host work is then the
    card's, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if lead_ms > 0.0:
        torch.cuda._sleep(int(lead_ms * 2e6))      # ~2e6 cycles per ms
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops=PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def mlp_macs(do, hidden, da) -> int:
    """Multiply-adds of the policy MLP's forward pass at one sample."""
    widths = [do, *hidden, da]
    return sum(a * b for a, b in zip(widths, widths[1:]))


def surrogate_grad_macs(do, hidden, da) -> int:
    """K5's function at one sample, each product counted once: the forward
    pass, gW and the back-propagated cotangent of every layer but the
    first, gW0 (2 do H + 3 H H + 3 H da at (H, H))."""
    inner = sum(a * b for a, b in zip(hidden, hidden[1:]))
    return 2 * do * hidden[0] + 3 * inner + 3 * hidden[-1] * da


def fvp_ff_macs(do, hidden, da) -> int:
    """K6's function at one sample, each product counted once: the
    recomputed forward pass and its tangent, the reverse accumulation
    (3 do H + 5 H H + 4 H da at (H, H))."""
    inner = sum(a * b for a, b in zip(hidden, hidden[1:]))
    return 3 * do * hidden[0] + 5 * inner + 4 * hidden[-1] * da


def elementwise_flops(fn) -> int:
    """Floating-point operations that ``fn`` runs through PyTorch: one per
    output element of each arithmetic or transcendental op, 2 m k n per
    matrix product (a TorchFunctionMode counter; views, copies and
    comparisons are free)."""
    from torch.overrides import TorchFunctionMode
    arith = {"add", "__add__", "__radd__", "sub", "__sub__", "__rsub__",
             "mul", "__mul__", "__rmul__", "div", "__truediv__",
             "__rtruediv__", "neg", "__neg__", "sqrt", "rsqrt", "cos", "sin",
             "clamp", "tanh", "exp"}
    count = [0]

    class Counter(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "")
            if name in ("matmul", "__matmul__"):
                a, b = args[0], args[1]
                count[0] += 2 * a.shape[-2] * a.shape[-1] * b.shape[-1]
            elif name in arith and isinstance(out, torch.Tensor):
                count[0] += out.numel()
            return out

    with Counter():
        fn()
    return count[0]


def sha256(*tensors) -> str:
    """SHA-256 of the tensors' fp32 bytes in order, each -0 made +0: the
    digest of a batch up to the sign of a zero."""
    h = hashlib.sha256()
    for x in tensors:
        h.update((x.float() + 0.0).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k4_setup(dev, cfg, seed):
    """The 3-D kernel phases' generator, policy and initial states: (gen,
    params, s0), drawn in this order from ``seed``."""
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = policy.init_params(gen, cfg.obs_dim, cfg.arm.n_joints,
                                cfg.trpo.hidden, cfg.trpo.logstd_init)
    return gen, params, arm.reset(cfg, gen, cfg.n_envs)


def k1_setup(dev, cfg, seed):
    """A planar phase's policy and initial states, drawn as ``k4_setup``
    draws them, and K1_SEED on the device: (params, s0, philox seed)."""
    _, params, s0 = k4_setup(dev, cfg, seed)
    return params, s0, torch.tensor(K1_SEED, dtype=torch.int64, device=dev)


def store_kw(store_dtype):
    """The rollout wrappers' store argument, left out for fp32 stores (so
    that these helpers also drive a tree that predates bf16 stores in K1)."""
    return {} if store_dtype == torch.float32 else dict(
        store_dtype=store_dtype)


def k1_ms(cfg, params, s0, seed, store_dtype=torch.float32):
    """K1's time per launch in Philox mode: 20 launches after warm-up,
    queued behind K1_LEAD_MS of sleep."""
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    kw = store_kw(store_dtype)
    return cuda_ms(lambda: rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt,
                                      seed=seed, **kw), 20,
                   lead_ms=K1_LEAD_MS)


def k1_digest(cfg, params, s0, seed, store_dtype=torch.float32):
    """SHA-256 of K1's Philox batch (obs, act, rew and, when the config
    terminates, dones) at ``seed``."""
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    return sha256(*rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, seed=seed,
                              **store_kw(store_dtype)))


def k1_bound(cfg, P, store_dtype=torch.float32):
    """K1's bound at ``cfg``: the policy MLP's FLOPs over the fp32 peak or
    every input read and output written once (obs and actions in
    ``store_dtype``, the done flags too when the config terminates),
    whichever is larger."""
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    do = cfg.obs_dim
    B = T * N
    es = torch.finfo(store_dtype).bits // 8
    rows = 2 if cfg.done_dist > 0.0 else 1
    return bound_ms(2.0 * mlp_macs(do, cfg.trpo.hidden, n) * B,
                    es * B * (do + n)
                    + 4.0 * (B * rows + N * (2 * n + 2) + P))


def spill_stores(lib):
    """Spill-store bytes per instantiation of library ``lib`` from its
    ``-Xptxas -v`` report."""
    from trpo_robot_control_tpu_torch.ops.cuda import build
    lines = [ln for ln in build.ptxas_report().splitlines()
             if ln.startswith(f"{lib}: ")]
    return [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                       "\n".join(lines))]


def k1_spills():
    """K1's spill-store bytes per instantiation, {joints: [bytes, ...]},
    from the ``-Xptxas -v`` report (four instantiations a joint count);
    requires none at 1-3 joints (c1, c2 and their bf16 and TERM
    instantiations among them) and prints the others'."""
    from trpo_robot_control_tpu_torch.ops.cuda import build
    out = {n: spill_stores(build.lib_name("rollout", n))
           for n in build.JOINT_COUNTS}
    print(f"K1 spill stores per instantiation (bytes), by joint count: {out}")
    for n in (1, 2, 3):
        require(len(out[n]) == 4 and not any(out[n]),
                f"K1 spills at {n} joints: {out[n]}")
    return out


def k1_occupancy():
    """What the card makes of K1's instantiations at c1's and c2's joint
    counts, terminating or not, fp32 and bf16 stores
    (``rollout_kernel.occupancy``), and the grid of each at its config's
    width (c1 for 2 joints, c2 for 3); requires no spill store at 1-3
    joints (``k1_spills``), a resident block and at least 128 blocks at
    c2. Returns {instantiation: occupancy}."""
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2, C2_REACHER3
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    k1_spills()
    out = {}
    for tag, cfg in (("c1", C1_REACHER2), ("c2", C2_REACHER3)):
        for term in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                name = (f"{tag}{'-term' if term else ''}"
                        f"{'-bf16' if dt == torch.bfloat16 else ''}")
                occ = rk.occupancy(cfg.arm.n_joints, term, dt)
                occ["grid_blocks"] = -(-cfg.n_envs // occ["envs_per_block"])
                print(f"K1 occupancy [{name}, {cfg.n_envs} envs]: {occ}")
                require(occ["blocks_per_sm"] >= 1, f"K1 {name}: {occ}")
                require(tag != "c2" or occ["grid_blocks"] >= 128,
                        f"K1 {name}: {occ['grid_blocks']} blocks")
                out[name] = occ
    return out


def k4_occupancy():
    """What the card makes of each K4 instantiation c3-c5 reach
    (``rollout3d_kernel.occupancy``); requires at least 16 resident warps
    per SM for every one. Returns {instantiation: occupancy}."""
    from trpo_robot_control_tpu_torch.configs import (C3_FRANKA7,
                                                      C4_FRANKA7_OBSTACLE,
                                                      C5_MULTITASK)
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    out = {}
    for tag, cfg in (("c3", C3_FRANKA7), ("c4", C4_FRANKA7_OBSTACLE),
                     ("c5", C5_MULTITASK)):
        for term in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                name = (f"{tag}{'-term' if term else ''}-"
                        f"{'bf16' if dt == torch.bfloat16 else 'fp32'}")
                occ = r3.occupancy(cfg.replace(done_dist=0.05 if term
                                               else 0.0), dt)
                print(f"K4 occupancy [{name}]: {occ}")
                require(occ["warps_per_sm"] >= 16,
                        f"K4 {name}: {occ['warps_per_sm']} warps per SM")
                out[name] = occ
    return out


# The SM's shared memory and what the card keeps of it per block
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024


def k4_occupancy_of(name, cfg, dt):
    """One K4 instantiation's occupancy (``rollout3d_kernel.occupancy``):
    requires 16 resident warps per SM, or, where the block's shared memory
    lets fewer blocks in, every block that fits (the reason printed)."""
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    occ = r3.occupancy(cfg, dt)
    fit = SM_SMEM // (occ["smem_dynamic"] + occ["smem_static"]
                      + BLOCK_SMEM_RESERVED)
    occ["blocks_smem_fits"] = fit
    warps = occ["warps_per_sm"]
    why = ""
    if warps < 16:
        why = (f" (below 16 warps: {fit} blocks of "
               f"{occ['smem_dynamic'] + occ['smem_static']} B of shared "
               f"memory fill the SM's {SM_SMEM} B)")
    print(f"K4 occupancy [{name}]: {occ}{why}")
    require(warps >= 16 or occ["blocks_per_sm"] >= fit,
            f"K4 {name}: {warps} warps per SM, {fit} blocks fit")
    return occ


def k6_occupancy():
    """What the card makes of K6's bf16 and fp32 instantiations
    (``fvp_ff_kernel.occupancy``); each must be resident. Returns
    {instantiation: occupancy}."""
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_ff_kernel as ffk
    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        occ = ffk.occupancy(dt)
        print(f"K6 occupancy [{name}]: {occ}")
        require(occ["blocks_per_sm"] >= 1, f"K6 {name} does not fit an SM")
        out[name] = occ
    return out


def k4_ms(cfg, params, s0):
    """3f's K4 time per launch on a 3-D kernel phase's inputs: Philox mode
    with seed K4_SEED_T, bf16 stores."""
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    seed = torch.tensor(K4_SEED_T, dtype=torch.int64, device=s0.q.device)
    return cuda_ms(lambda: r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt,
                                        s0.task, seed=seed,
                                        store_dtype=torch.bfloat16),
                   3, warmup=1)


def k6_ms(params, sub, damping, v, lead_ms=0.0):
    """3f's K6 time per launch: 20 CG calls fvp(v) on a Fisher subsample
    after warm-up (behind ``lead_ms`` of sleep, ``cuda_ms``)."""
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_ff_kernel as ffk
    fvp = ffk.make_gn_fvp_ff(params, sub, damping)
    return cuda_ms(lambda: fvp(v), 20, lead_ms=lead_ms)


def k3_setup(dev, cfg, seed):
    """A planar phase's policy (``k1_setup``) and its Fisher subsample as
    the trainer forms it from K1's Philox batch at K1_SEED: (params,
    obs_fvp (B', do) fp32, the (T', do, N) view it was relaid from)."""
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    params, s0, seed_k1 = k1_setup(dev, cfg, seed)
    obs_ff = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, seed=seed_k1)[0]
    sub = obs_ff[::cfg.trpo.fvp_subsample]
    return params, sub.permute(0, 2, 1).reshape(-1, cfg.obs_dim), sub


def k3_ms(params, obs_fvp, damping, v):
    """K3's time per launch: 50 CG calls fvp(v) on a Fisher subsample
    after warm-up, queued behind K1_LEAD_MS of sleep (the wrapper's host
    work takes about as long as the kernel)."""
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
    fvp = make_gn_fvp(params, obs_fvp, damping)
    return cuda_ms(lambda: fvp(v), 50, lead_ms=K1_LEAD_MS)


def k3_launch_ms(params, obs_fvp, damping, v, calls=20):
    """Device ms per CG call of each launch K3 makes (its wide form's
    chain, the split and the reduce), by kernel name, from
    ``torch.profiler`` over ``calls`` calls after warm-up."""
    from torch.profiler import ProfilerActivity, profile
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
    fvp = make_gn_fvp(params, obs_fvp, damping)
    for _ in range(3):
        fvp(v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fvp(v)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1].replace("void ", "")
            out[name] = out.get(name, 0.0) + t / calls / 1e3
    return out


def device_kernels(fn) -> dict:
    """{kernel name: launches} of one call of ``fn``, from
    ``torch.profiler``'s device trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if (t if t is not None else getattr(e, "cuda_time_total", 0)) > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1].replace("void ", "")
            out[name] = out.get(name, 0) + e.count
    return out


def fvp_macs(do, hidden, da) -> int:
    """K3's function at one sample, each product counted once: the forward
    tangent and the reverse accumulation (2 do H + 4 H H + 4 H da at
    (H, H))."""
    inner = sum(a * b for a, b in zip(hidden, hidden[1:]))
    return 2 * do * hidden[0] + 4 * inner + 4 * hidden[-1] * da


def k3_bound(B, do, da, P, hidden=(64, 64)):
    """K3's bound on B samples: the function's products, each counted once,
    at the bf16 tensor-core peak (its three-plane split is its own cost,
    not the work, as for K5 and K6), or its inputs read once (x, the h_l,
    v and the weights) and Fv written, whichever is larger; and the same
    products at the fp32-FMA peak, labelled, beside it."""
    flops = 2.0 * fvp_macs(do, hidden, da) * B
    nbytes = 4.0 * (B * (do + sum(hidden)) + 3 * P)
    return (bound_ms(flops, nbytes, peak_flops=PEAK_BF16_FLOPS),
            bound_ms(flops, nbytes))


def port_test_helpers():
    """The checkout's ``tests/test_torch_helpers.py`` (numpy and torch
    only; the torch thread count it sets is put back)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_helpers.py")
    spec = importlib.util.spec_from_file_location("test_torch_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    threads = torch.get_num_threads()
    spec.loader.exec_module(mod)
    torch.set_num_threads(threads)
    return mod


def split_statement():
    """``gn_fvp_split``, the PyTorch statement of K3's plane products, from
    the checkout's ``tests/test_torch_helpers.py``."""
    return port_test_helpers().gn_fvp_split


def k3_check(tag, gen, params, obs_fvp, damping):
    """K3 (``make_gn_fvp``) against its plain version within K3_REL and
    against the statement of its plane products within K3_SPLIT_REL, for
    10 v drawn from ``gen``, and bit-identical repeat calls. Returns
    (record, fvp, hs, scale)."""
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
    statement = split_statement()
    B = obs_fvp.shape[0]
    hs = fk.activations(params, obs_fvp)
    scale = torch.exp(-2.0 * params["logstd"]) / B
    P = policy.flatten(params).numel()
    fvp = make_gn_fvp(params, obs_fvp, damping)
    worst_rel = worst_abs = worst_split = 0.0
    for _ in range(10):
        v = torch.randn(P, generator=gen, device=obs_fvp.device)
        f_k = fvp(v)
        f_p = fk.gn_fvp_plain(params, obs_fvp, hs, scale, v, damping)
        f_s = statement(params, obs_fvp, hs, v, damping)
        worst_rel = max(worst_rel, float(torch.linalg.norm(f_k - f_p)
                                         / torch.linalg.norm(f_p)))
        worst_split = max(worst_split, float(torch.linalg.norm(f_k - f_s)
                                             / torch.linalg.norm(f_s)))
        worst_abs = max(worst_abs, float((f_k - f_p).abs().max()))
        require(torch.equal(f_k, fvp(v)), f"{tag} K3 is not deterministic")
    print(f"{tag} K3: B' = {B}, worst relative L2 err {worst_rel:.3e} from "
          f"the plain version (bound {K3_REL}), {worst_split:.3e} from the "
          f"statement of its plane products (bound {K3_SPLIT_REL}) over 10 "
          "v; repeat calls bit-identical")
    require(worst_rel <= K3_REL, f"{tag} K3 error {worst_rel}")
    require(worst_split <= K3_SPLIT_REL,
            f"{tag} K3 error {worst_split} from its statement")
    return (dict(max_abs_err=worst_abs, max_rel_err=worst_rel,
                 split_rel_err=worst_split), fvp, hs, scale)


def k3_occupancy():
    """What the card makes of K3's instantiations at c1's and c2's widths
    (``fvp_kernel.occupancy``); each must be resident. Returns
    {config: occupancy}."""
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2, C2_REACHER3
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    out = {}
    for tag, cfg in (("c1", C1_REACHER2), ("c2", C2_REACHER3)):
        occ = fk.occupancy(cfg.obs_dim, cfg.arm.n_joints)
        print(f"K3 occupancy [{tag}, do {cfg.obs_dim}, da "
              f"{cfg.arm.n_joints}]: {occ}")
        require(occ["blocks_per_sm"] >= 1, f"K3 {tag} does not fit an SM")
        out[tag] = occ
    return out


def k4_term_ms(cfg, params, s0, tag="c5"):
    """4e's K4-term variants (``term_variant_ms``) on c5-term's inputs:
    Philox mode with seed K4_SEED_A, bf16 stores."""
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    seed = torch.tensor(K4_SEED_A, dtype=torch.int64, device=s0.q.device)
    return term_variant_ms(
        f"{tag} K4", lambda d: r3.rollout3d(cfg.replace(done_dist=d), params,
                                        s0.q, s0.qd, s0.tgt, s0.task,
                                        seed=seed,
                                        store_dtype=torch.bfloat16),
        cfg.done_dist, rounds=3, iters=3, warmup=1)


def bf16_ulp(x):
    """One bf16 unit in the last place of each element of x (fp32)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def bf16_ulps(k16, p32):
    """The largest |kernel - round(plain)| in bf16 ulps over pairs of a
    kernel's bf16 stores and the plain version's fp32 outputs."""
    return max(float(((k.float() - p.to(torch.bfloat16).float()).abs()
                      / bf16_ulp(p.to(torch.bfloat16).float())).max())
               for k, p in zip(k16, p32))


def rel_l2(a, ref):
    return float(torch.linalg.norm(a.double() - ref) / torch.linalg.norm(ref))


def pg_fp64(params, obs_ff, act_ff, adv_ff, B, rounding=True):
    """K5's bf16-mode function in fp64 on a time slice of a batch of B
    samples (a copy of ``tests/test_torch_helpers.surrogate_grad_fp64``,
    the gradient flat in ``policy.flatten``'s order):
    every h_l and g_l rounded to bf16 where the port rounds them (any
    depth). A rounding is ambiguous where an fp32 value within
    PG_AMBIG_ULPS fp32 roundings of its terms' magnitude may round to the
    other bf16 neighbour. With ``rounding`` off, K5's fp32-mode function:
    no rounding, none ambiguous. Returns mu, mu_slack (how far ambiguous
    h_l roundings may move mu), kept (the
    samples with no ambiguous rounding), and the gradient over all samples
    and over the kept ones."""
    p = {k: v.double() for k, v in params.items()}
    ab = {k: v.abs() for k, v in p.items()}
    L = sum(1 for k in p if k.startswith("W")) - 1
    T, _, N = obs_ff.shape
    x, a, adv = obs_ff.double(), act_ff.double(), adv_ff.double()[:, None]

    def fwd(W, h):
        return torch.einsum("io,tin->ton", W, h)

    def bwd(W, c):
        return torch.einsum("io,ton->tin", W, c)

    def rnd(v):
        return v.float().to(torch.bfloat16).double() if rounding else v

    eps = PG_AMBIG_ULPS * 2.0 ** -24
    hs, spread = [], torch.zeros_like(x)
    amb = torch.zeros(T, N, dtype=torch.bool, device=x.device)
    h = x
    for i in range(L):
        v = torch.tanh(fwd(p[f"W{i}"], h) + p[f"b{i}"][:, None])
        dz = fwd(ab[f"W{i}"], spread)
        e = eps * ((1 - v * v) * (fwd(ab[f"W{i}"], h.abs())
                                  + ab[f"b{i}"][:, None]) + v.abs()) \
            + (1 - (v.abs() - dz).clamp(min=0) ** 2) * dz
        h = rnd(v)
        spread = torch.maximum(rnd(v + e) - h, h - rnd(v - e)) if rounding \
            else torch.zeros_like(h)
        amb |= (spread > 0).any(1)
        hs.append(h)
    mu = fwd(p[f"W{L}"], h) + p[f"b{L}"][:, None]
    mu_slack = fwd(ab[f"W{L}"], spread)
    inv_var = torch.exp(-2 * p["logstd"])[:, None]
    z = (a - mu) * torch.exp(-p["logstd"])[:, None]
    ct = adv * (a - mu) * inv_var / B
    mag = adv.abs() * inv_var / B * (fwd(ab[f"W{L}"], h.abs())
                                     + ab[f"b{L}"][:, None] + (a - mu).abs())
    cts = [ct]
    for l in range(L, 0, -1):
        d = 1 - hs[l - 1] ** 2
        v = bwd(p[f"W{l}"], ct) * d
        e = eps * (d * bwd(ab[f"W{l}"], mag) + v.abs())
        if rounding:
            amb |= (rnd(v + e) != rnd(v - e)).any(1)
        ct = rnd(v)
        mag = ct.abs()
        cts.append(ct)

    def grads(m):
        g = {"logstd": (adv * m * (z * z - 1)).sum((0, 2)) / B}
        for l, c, h_in in zip(range(L, -1, -1), cts, hs[::-1] + [x]):
            g[f"W{l}"] = torch.einsum("tin,ton->io", h_in, c * m)
            g[f"b{l}"] = (c * m).sum((0, 2))
        return torch.cat([g[k].reshape(-1) for k in sorted(g)])

    kept = ~amb
    return dict(mu=mu, mu_slack=mu_slack, kept=kept, g=grads(1.0),
                g_kept=grads(kept.double()[:, None]))


def pg_fp64_batch(params, obs_ff, act_ff, adv, mus, rounding=True):
    """``pg_fp64`` over the whole batch in time slices of about 2^20
    samples: the flat fp64 gradient over all and over the kept samples,
    the kept mask (T, N) and its share, and for each mu of ``mus`` the
    largest |mu - fp64 mu| less its slack."""
    T, _, N = obs_ff.shape
    step = max(1, 2 ** 20 // N)
    out = dict(g=0.0, g_kept=0.0, kept=[],
               mu_over={k: -math.inf for k in mus})
    for t0 in range(0, T, step):
        sl = slice(t0, t0 + step)
        r = pg_fp64(params, obs_ff[sl], act_ff[sl], adv[sl], T * N,
                    rounding)
        out["g"] = out["g"] + r["g"]
        out["g_kept"] = out["g_kept"] + r["g_kept"]
        out["kept"].append(r["kept"])
        for k, mu in mus.items():
            over = (mu[sl].double() - r["mu"]).abs() - r["mu_slack"]
            out["mu_over"][k] = max(out["mu_over"][k], float(over.max()))
    out["kept"] = torch.cat(out["kept"])
    out["kept_share"] = float(out["kept"].double().mean())
    return out


def k2_check(tag, obs_ff, targets, horizon):
    """K2 against its plain version (the Gram summed in fp64), on the Gram
    and on (A, b) assembled from it; the JAX route's fp32 ``normal_eq_ff``
    is printed beside it. Returns (kernel Gram, plain Gram, tau)."""
    from trpo_robot_control_tpu_torch.models import baseline
    from trpo_robot_control_tpu_torch.ops.cuda import moments_kernel as mk
    T, do, N = obs_ff.shape
    tau = baseline._time_features(T, horizon, obs_ff.device)
    gram_k = mk.extended_gram(obs_ff, targets, tau)
    gram_p = mk.extended_gram_plain(obs_ff, targets, tau)
    F2 = 2 * do + 1
    A_k, b_k = baseline.assemble(gram_k[:F2, :F2], gram_k[:F2, F2:], tau, N,
                                 do)
    A_p, b_p = baseline.assemble(gram_p[:F2, :F2], gram_p[:F2, F2:], tau, N,
                                 do)
    A_n, b_n = baseline.normal_eq_ff(obs_ff, targets, horizon)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rel_A, rel_b = rel(A_k, A_p), rel(b_k, b_p)
    print(f"{tag} K2 ({str(obs_ff.dtype)[6:]}, do {do}): rel err A "
          f"{rel_A:.3e}, b {rel_b:.3e} vs the plain version (Gram summed in "
          f"fp64; bound {K2_REL}); fp32 normal_eq_ff differs from it by A "
          f"{rel(A_n, A_p):.3e}, b {rel(b_n, b_p):.3e}")
    require(rel_A <= K2_REL and rel_b <= K2_REL,
            f"{tag} K2 error {rel_A}, {rel_b}")
    return gram_k, gram_p, tau


def k2_times(tag, obs_ff, targets, tau):
    """K2 fp32 at ``tag``'s shapes: one device kernel a call (the
    profiler's trace of one call); ms a launch queued behind the lead (the
    card's time) and without it, beside its bound, the plain version and
    ``torch.matmul`` of v_ext (the library yardstick). Returns its
    record."""
    from trpo_robot_control_tpu_torch.ops.cuda import moments_kernel as mk
    T, do, N = obs_ff.shape
    B, R = T * N, 2 * do + 5
    kernels = device_kernels(lambda: mk.extended_gram(obs_ff, targets, tau))
    print(f"{tag} moments (fp32): device kernels of one call {kernels}")
    require(kernels == {"moments_fp32_kernel": 1},
            f"{tag} K2 fp32 is not one device launch: {kernels}")
    t_k = cuda_ms(lambda: mk.extended_gram(obs_ff, targets, tau), 50,
                  lead_ms=K1_LEAD_MS)
    t_unled = cuda_ms(lambda: mk.extended_gram(obs_ff, targets, tau), 50)
    t_p = cuda_ms(lambda: mk.extended_gram_plain(obs_ff, targets, tau), 20)
    v_ext = torch.cat([obs_ff, obs_ff * obs_ff, targets[:, None, :],
                       tau[:, :, None].expand(T, 4, N)], dim=1) \
        .permute(1, 0, 2).reshape(R, B).contiguous()
    t_lib = cuda_ms(lambda: torch.matmul(v_ext, v_ext.T), 50)
    bms, by = bound_ms(2.0 * (R * (R + 1) // 2) * B + B * do,
                       4.0 * (B * (do + 1) + 4 * T + R * R))
    print(f"{tag} moments (fp32, one launch, grid {mk.fp32_grid(T, N)}): "
          f"{t_k:.5f} ms/launch queued behind the lead, {t_unled:.5f} "
          f"without it (bound {bms:.5f} ms by {by}, "
          f"{100 * bms / t_k:.1f} % of it reached), plain {t_p:.4f} ms, "
          f"torch.matmul of v_ext {t_lib:.5f} ms")
    return dict(ms=t_k, ms_without_lead=t_unled, plain_ms=t_p,
                bound_ms=bms, bound_by=by, library_ms=t_lib,
                grid=mk.fp32_grid(T, N), device_kernels=kernels)


def refit_ptxas() -> str:
    """The ``-Xptxas -v`` lines of the linear baseline's two kernels."""
    from trpo_robot_control_tpu_torch.ops.cuda import build
    out, keep = [], False
    for ln in build.ptxas_report().splitlines():
        if "Compiling entry" in ln:
            keep = ln.startswith(("fit_normal:", "moments:")) and (
                "fit_normal_kernel" in ln or "moments_fp32_kernel" in ln)
        if keep:
            out.append(ln)
    return "\n".join(out)


def k2_bf16_sass() -> str:
    """SHA-256 of K2's bf16-mode functions (the tensor-core kernels and
    the reduce pass) in the built library's SASS, with the instruction
    encodings and mangled names taken out, in name order."""
    from trpo_robot_control_tpu_torch.ops.cuda import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass",
                           str(build._target("moments"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_\d+_moments_cu_\w+?(?=\d)",
                          "ANON", m.group(1))
            funcs[name] = []
        elif name and "/*" in ln:
            ins = re.sub(r"_ZN\w+", "SYM",
                         re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ln)).strip()
            if ins:
                funcs[name].append(ins)
    keep = sorted(k for k in funcs
                  if "tc_kernel" in k or "reduce_kernel" in k)
    require(len(keep) == 4, f"K2 bf16-mode functions in the SASS: {keep}")
    return hashlib.sha256("\n".join("\n".join(funcs[k]) for k in keep)
                          .encode()).hexdigest()


def train_checked(cfg, n_iters, kernels, expect, train):
    """Train ``n_iters`` full-width iterations with the counts set to 0
    just before; checks the launches, the plain calls and the stats and
    returns (launches, ms per update over iterations 2..n)."""
    def log(st):
        print("iter " + json.dumps({k: (round(v, 6) if isinstance(v, float)
                                        else v) for k, v in st.items()}))

    # the linear baseline's ridge solve: one fit_normal launch an update
    expect = dict(expect, fit_normal=n_iters * (cfg.trpo.baseline != "mlp"))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    _, hist = train(cfg, n_iters=n_iters, seed=0, log_fn=log)
    launches = kernels.launch_counts()
    plain = kernels.plain_calls()
    print(f"{cfg.name} main path: launches {launches}, plain calls {plain}; "
          f"peak device memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    require(launches == expect, f"{cfg.name} main-path launches {launches}")
    require(all(c == 0 for c in plain.values()), f"plain calls {plain}")
    for st in hist:
        require(all(math.isfinite(v) for v in st.values()),
                f"non-finite stats {st}")
        require(st["accepted"] < 0 or st["kl"] <= cfg.trpo.delta,
                f"accepted step outside the trust region {st}")
    if cfg.done_dist > 0.0:
        early = [int(st["early_dones"]) for st in hist]
        print(f"{cfg.name} done_dist {cfg.done_dist}: early dones per "
              f"iteration {early} of {(cfg.horizon - 1) * cfg.n_envs} "
              "env-steps each")
        require(sum(early) > 0, f"{cfg.name}: no early done in {n_iters} "
                "iterations")
    ms_upd = 1e3 * sum(st["wall_s"] for st in hist[1:]) / (n_iters - 1)
    print(f"{cfg.name} update (host clock, iterations 2-{n_iters}): "
          f"{ms_upd:.3f} ms, {1e3 / ms_upd:.2f} updates/s")
    return launches, ms_upd


def k1_c1(dev):
    """K1 at c1 (2 links, 64 envs x 50 steps): eps mode against its plain
    version, the Philox batch's SHA-256 at seed K1_SEED, and its time
    beside its bound; returns its record."""
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    cfg = C1_REACHER2
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    params, s0, seed = k1_setup(dev, cfg, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    k_out = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, eps=eps)
    p_out = rk.rollout_plain(cfg, params, s0.q, s0.qd, s0.tgt, eps)
    errs10 = [float((k[:K1_TIGHT_STEPS] - p[:K1_TIGHT_STEPS]).abs().max())
              for k, p in zip(k_out, p_out)]
    errs = [float((k - p).abs().max()) for k, p in zip(k_out, p_out)]
    print(f"c1 K1 eps mode: max |kernel - plain| (obs, act, rew) {errs10} "
          f"over {K1_TIGHT_STEPS} steps (bound {K1_TIGHT_ATOL}), {errs} over "
          f"{T} steps (bound {K1_FULL_ATOL})")
    require(max(errs10) <= K1_TIGHT_ATOL, f"c1 K1 10-step error {errs10}")
    require(max(errs) <= K1_FULL_ATOL, f"c1 K1 full-horizon error {errs}")
    require(all(bool(torch.isfinite(x).all()) for x in
                rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, seed=seed)),
            "c1 K1: non-finite output")
    digest = k1_digest(cfg, params, s0, seed)
    print(f"c1 K1 Philox batch (seed {K1_SEED}) SHA-256 {digest}")
    ms = k1_ms(cfg, params, s0, seed)
    plain_ms = cuda_ms(lambda: rk.rollout_plain(cfg, params, s0.q, s0.qd,
                                                s0.tgt, eps), 2, warmup=1)
    bms, by = k1_bound(cfg, policy.flatten(params).numel())
    print(f"c1 rollout: {ms:.4f} ms/launch, {1e3 * ms / T:.3f} us per step "
          f"(bound {bms:.4f} ms by {by}), plain {plain_ms:.3f} ms")
    return dict(max_abs_err=max(errs10), ms=ms, us_per_step=1e3 * ms / T,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                philox_sha256=digest)


def k2_c1(dev):
    """K2 fp32 at c1 (64 envs x 50 steps, do 9) on a K1 eps-mode batch:
    against its plain version, and timed (``k2_times``); returns its
    record."""
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    from trpo_robot_control_tpu_torch.ops.gae import gae
    cfg = C1_REACHER2
    params, s0, _ = k1_setup(dev, cfg, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    eps = torch.randn(cfg.horizon, cfg.n_envs, cfg.arm.n_joints,
                      generator=gen, device=dev)
    obs_ff, _, rew_ff = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, eps=eps)
    targets = gae(rew_ff, torch.zeros_like(rew_ff), cfg.trpo.gamma,
                  cfg.trpo.lam, time_axis=0)
    gram_k, gram_p, tau = k2_check("c1", obs_ff, targets, cfg.horizon)
    rec = dict(max_abs_err=float((gram_k - gram_p).abs().max()))
    rec.update(k2_times("c1", obs_ff, targets, tau))
    return rec


def c2_phases(dev):
    """K1-K3 at c2 (and K1, K3 at c1) and c2 training; returns {kernel:
    record}."""
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2, C2_REACHER3
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.ops.cuda import (fvp_kernel as fk,
                                                       moments_kernel as mk,
                                                       rollout_kernel as rk)
    from trpo_robot_control_tpu_torch.ops.gae import gae
    from trpo_robot_control_tpu_torch.trpo.train import train
    cfg = C2_REACHER3
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    do, da = cfg.obs_dim, n
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = policy.init_params(gen, do, da, cfg.trpo.hidden,
                                cfg.trpo.logstd_init)
    s0 = arm.reset(cfg, gen, N)
    rec = {}

    # ---- K1 rollout vs its plain version
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    k_out = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, eps=eps)
    p_out = rk.rollout_plain(cfg, params, s0.q, s0.qd, s0.tgt, eps)
    torch.cuda.synchronize()
    errs10 = [float((k[:K1_TIGHT_STEPS] - p[:K1_TIGHT_STEPS]).abs().max())
              for k, p in zip(k_out, p_out)]
    errs = [float((k - p).abs().max()) for k, p in zip(k_out, p_out)]
    err10, err_full = max(errs10), max(errs)
    print("K1 eps mode: max |kernel - plain| (obs, act, rew) "
          f"{errs10} over {K1_TIGHT_STEPS} steps (bound {K1_TIGHT_ATOL}), "
          f"{errs} over {T} steps (bound {K1_FULL_ATOL})")
    require(err10 <= K1_TIGHT_ATOL, f"K1 10-step error {err10}")
    require(err_full <= K1_FULL_ATOL, f"K1 full-horizon error {err_full}")
    seed_a = torch.tensor([12345, 678], dtype=torch.int64, device=dev)
    seed_b = torch.tensor([12346, 678], dtype=torch.int64, device=dev)
    obs_a, act_a, rew_a = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt,
                                     seed=seed_a)
    obs_a2, act_a2, _ = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt,
                                   seed=seed_a)
    _, act_b, _ = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, seed=seed_b)
    mu = policy.mean_net(params, obs_a.permute(0, 2, 1)).permute(0, 2, 1)
    z = (act_a - mu) / torch.exp(params["logstd"])[None, :, None]
    z_mean, z_std = float(z.mean()), float(z.std())
    print(f"K1 Philox mode: {z.numel()} draws, mean {z_mean:+.5f}, "
          f"std {z_std:.5f}")
    require(abs(z_mean) <= 0.01 and abs(z_std - 1.0) <= 0.01,
            f"K1 Philox noise mean {z_mean}, std {z_std}")
    require(torch.equal(act_a, act_a2) and torch.equal(obs_a, obs_a2),
            "K1: the same seed gave a different batch")
    require(not torch.equal(act_a, act_b),
            "K1: a different seed gave the same batch")
    require(all(bool(torch.isfinite(x).all()) for x in (obs_a, act_a, rew_a)),
            "K1: non-finite output")
    seed_k1 = torch.tensor(K1_SEED, dtype=torch.int64, device=dev)
    digest = k1_digest(cfg, params, s0, seed_k1)
    print(f"c2 K1 Philox batch (seed {K1_SEED}) SHA-256 {digest}")
    rec["rollout"] = dict(max_abs_err=err10, philox_sha256=digest,
                          at_c1=k1_c1(dev))

    # ---- K2 moments vs normal_eq_ff on that rollout's batch
    obs_ff, _, rew_ff = k_out
    targets = gae(rew_ff, torch.zeros_like(rew_ff), cfg.trpo.gamma,
                  cfg.trpo.lam, time_axis=0)
    gram_k, gram_p, tau = k2_check("c2", obs_ff, targets, cfg.horizon)
    rec["moments"] = dict(max_abs_err=float((gram_k - gram_p).abs().max()))

    # ---- K3 FVP vs its plain version and its plane products' statement
    # on c2's Fisher subsample, then on c1's
    k = cfg.trpo.fvp_subsample
    obs_fvp = obs_ff[::k].permute(0, 2, 1).reshape(-1, do)
    B_sub = obs_fvp.shape[0]
    P = policy.flatten(params).numel()
    rec["fvp"], fvp, hs, scale = k3_check("c2", gen, params, obs_fvp,
                                          cfg.trpo.cg_damping)
    params1, obs_fvp1, _ = k3_setup(dev, C1_REACHER2, 4)
    rec1, fvp1, hs1, scale1 = k3_check("c1", gen, params1, obs_fvp1,
                                       C1_REACHER2.trpo.cg_damping)

    # ---- five full-width c2 iterations through the trainer
    n_iters = 5
    launches, _ = train_checked(
        cfg, n_iters, kernels,
        {"rollout": n_iters, "moments": n_iters,
         "fvp": n_iters * cfg.trpo.cg_iters, "rollout3d": 0, "pg": 0,
         "fvp_ff": 0}, train)
    rec["fit_normal"] = dict(launches=launches["fit_normal"])

    # ---- kernel times beside bounds, plain versions and yardsticks
    seed_t = torch.tensor([7, 7], dtype=torch.int64, device=dev)
    t_k1 = k1_ms(cfg, params, s0, seed_t)
    t_k1p = cuda_ms(lambda: rk.rollout_plain(cfg, params, s0.q, s0.qd,
                                             s0.tgt, eps), 2, warmup=1)
    b1 = k1_bound(cfg, P)
    rec["rollout"]["us_per_step"] = 1e3 * t_k1 / T
    k2 = k2_times("c2", obs_ff, targets, tau)
    t_k2, t_k2p, t_k2lib = k2["ms"], k2["plain_ms"], k2["library_ms"]
    b2 = (k2["bound_ms"], k2["bound_by"])
    rec["moments"]["ms_without_lead"] = k2["ms_without_lead"]
    rec["moments"]["grid"] = k2["grid"]
    rec["moments"]["at_c1"] = k2_c1(dev)
    v = torch.randn(P, generator=gen, device=dev)
    t_k3 = cuda_ms(lambda: fvp(v), 50, lead_ms=K1_LEAD_MS)
    t_k3p = cuda_ms(lambda: fk.gn_fvp_plain(params, obs_fvp, hs, scale, v,
                                            cfg.trpo.cg_damping), 20)
    b3, b3fma = k3_bound(B_sub, do, da, P)
    t_k6 = k6_ms(params, obs_ff[::k], cfg.trpo.cg_damping, v,
                 lead_ms=K1_LEAD_MS)
    print(f"c2 fvp: tensor-core bound {b3[0]:.4f} ms ({b3[1]}), "
          f"{100 * b3[0] / t_k3:.1f} % of it reached; fp32-FMA bound "
          f"{b3fma[0]:.4f} ms ({b3fma[1]}); yardstick: K6 on the same "
          f"(25, {do}, {N}) fp32 subsample {t_k6:.4f} ms/launch")
    rec["fvp"].update(bound_fp32_fma_ms=b3fma[0], bound_share=b3[0] / t_k3,
                      k6_on_c2_subsample_ms=t_k6)
    P1 = policy.flatten(params1).numel()
    v1 = torch.randn(P1, generator=gen, device=dev)
    damp1 = C1_REACHER2.trpo.cg_damping
    t1 = cuda_ms(lambda: fvp1(v1), 50, lead_ms=K1_LEAD_MS)
    t1p = cuda_ms(lambda: fk.gn_fvp_plain(params1, obs_fvp1, hs1, scale1,
                                          v1, damp1), 20)
    b31, b31fma = k3_bound(obs_fvp1.shape[0], C1_REACHER2.obs_dim,
                           C1_REACHER2.arm.n_joints, P1)
    rec1.update(ms=t1, plain_ms=t1p, bound_ms=b31[0], bound_by=b31[1],
                bound_fp32_fma_ms=b31fma[0], library_ms=None)
    rec["fvp"]["at_c1"] = rec1
    print(f"c1 fvp: {t1:.4f} ms/launch (bound {b31[0]:.4f} ms by "
          f"{b31[1]}; fp32-FMA {b31fma[0]:.4f}), plain {t1p:.3f} ms")
    for name, ms, plain_ms, (bms, by), lib_ms in (
            ("rollout", t_k1, t_k1p, b1, None),
            ("moments", t_k2, t_k2p, b2, t_k2lib),
            ("fvp", t_k3, t_k3p, b3, None)):
        rec[name].update(launches=launches[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=lib_ms)
        print(f"c2 {name}: {ms:.4f} ms/launch (bound {bms:.4f} ms by {by}), "
              + (f"{1e3 * ms / T:.3f} us per step, " if name == "rollout"
                 else "")
              + f"plain {plain_ms:.3f} ms"
              + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f", {launches[name] // n_iters} launch(es)/update")
    return rec


def k4_flops_per_env_step(r3, cfg, params, s0, eps, task):
    """K4's work per env-step, counted from the plain version at one env
    (two steps less one). The plain version computes the push term and the
    track rotation for every env and selects; the kernel computes them for
    the envs of those tasks only, so their share of this batch is what
    counts."""
    one, two = cfg.replace(horizon=1), cfg.replace(horizon=2)
    per_step = (elementwise_flops(lambda: r3.rollout3d_plain(
        two, params, s0.q[:1], s0.qd[:1], s0.tgt[:1], s0.task[:1],
        eps[:2, :1]))
        - elementwise_flops(lambda: r3.rollout3d_plain(
            one, params, s0.q[:1], s0.qd[:1], s0.tgt[:1], s0.task[:1],
            eps[:1, :1])))
    c = r3.arm3d_consts(cfg)
    if c.n_tasks > 1:
        q = list(s0.q[:1].T)
        fk = r3._fk3(c, [torch.cos(x) for x in q], [torch.sin(x) for x in q])
        tg = tuple(s0.tgt[:1, i] for i in range(3))
        rot = elementwise_flops(lambda: r3.track_target(c, tg, s0.task[:1]))
        per_step -= rot * float((task != 1).float().mean())
        if c.n_tasks > 2:
            d = r3.v_sub(fk[3], tg)
            push = elementwise_flops(lambda: r3.push_penalty(
                c, list(s0.qd[:1].T), fk, d))
            per_step -= push * float((task != 2).float().mean())
    return per_step


def k4_zero_flops_per_env_step(r3, cfg, s0):
    """The structural zeros of the fused RNEA sweep that the kernel's
    specialised passes skip, per env-step: the sweep's count less the
    specialised passes' (``mass_bias_split``, the shared frame vectors
    included), at one env, times the substeps."""
    c = r3.arm3d_consts(cfg)
    q, qd = list(s0.q[:1].T), list(s0.qd[:1].T)
    R, p, axis, _ = r3._fk3(c, [torch.cos(x) for x in q],
                            [torch.sin(x) for x in q])
    fused = elementwise_flops(lambda: r3._mass_bias_fused(c, R, p, axis, qd))
    split = elementwise_flops(lambda: r3.mass_bias_split(c, R, p, axis, qd))
    return c.n_substeps * (fused - split)


def k4_bound(r3, cfg, params, s0, per_step):
    """K4's bound at ``cfg`` from its work per env-step (``per_step``,
    ``k4_flops_per_env_step``): the operations the function needs, the
    fused sweep's less its structural zeros, which the kernel's
    specialised passes skip, or every input read and output written once
    (bf16 stores), whichever is larger; the fused sweep's figure beside it;
    and the share of the bound that -fmad=false leaves reachable (every
    multiply and add of the dynamics is an instruction of its own, the
    bound counts an FMA's two FLOPs per instruction, only the MLP's fmaf
    keep two). Returns (bound, fused bound, zeros per env-step, share)."""
    N, n = cfg.n_envs, cfg.arm.n_joints
    do, da, B = cfg.obs_dim, n, cfg.horizon * cfg.n_envs
    P = sum(x.numel() for x in params.values())
    state_floats = 2 * n + 3 + (cfg.n_tasks > 1)      # q0, qd0, tgt, task
    k4_bytes = B * ((do + da) * 2 + 4) + 4.0 * (N * state_floats + P)
    zero = k4_zero_flops_per_env_step(r3, cfg, s0)
    need = per_step - zero
    mlp = 2 * mlp_macs(do, cfg.trpo.hidden, da)
    return (bound_ms(need * B, k4_bytes), bound_ms(per_step * B, k4_bytes),
            zero, (need / 2) / ((need - mlp) + mlp / 2))


def arm3d_phases(dev, cfg, seed, tag=None, exact=False):
    """K4, K2-bf16 and the update's routes (``kernel_routes``: K5 and K6,
    or for a policy wider than 64 the plain surrogate gradient and K3 on
    the fp32 relayout) on a config of the 3-D kernel and its training;
    returns {kernel: record} for K4 and the routed kernels and the
    bf16-mode record of K2. K4 runs at full width and is held against its
    plain version on ``K4_CHECK_ENVS`` envs spread over the batch by a
    stride; with ``exact`` its fp32 stores must equal the plain version's
    and its bf16 stores the plain version's rounded, over the whole
    horizon."""
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import baseline, policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.ops.cuda import (fvp_ff_kernel as ffk,
                                                       moments_kernel as mk,
                                                       pg_kernel as pk,
                                                       rollout3d_kernel as r3)
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    from trpo_robot_control_tpu_torch.ops.gae import gae
    from trpo_robot_control_tpu_torch.trpo.train import train
    from trpo_robot_control_tpu_torch.trpo.update import kernel_routes
    tag = tag or cfg.name.split("_")[0]
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    do, da = cfg.obs_dim, n
    hidden = cfg.trpo.hidden
    bf16 = torch.bfloat16
    gen, params, s0 = k4_setup(dev, cfg, seed)
    P = policy.flatten(params).numel()
    k_sub, e_sub = cfg.trpo.fvp_subsample, cfg.trpo.fvp_env_subsample
    routes = kernel_routes(cfg.trpo, params, T, N, -(-T // k_sub),
                           -(-N // e_sub))
    use_pg, use_ff = routes["surrgrad"] == "pallas", routes["fvp"] == "ff"
    print(f"{tag} update routes: {routes}")
    rec = {}

    # ---- K4 3-D rollout at full width vs its plain version on every
    # stride-th env of the same inputs (plain timed once, no warm-up)
    stride = max(1, N // K4_CHECK_ENVS)
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    k32 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task, eps=eps)
    k16 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task, eps=eps,
                       store_dtype=bf16)
    require(torch.equal(k16[2], k32[2]), f"{tag} K4: bf16 stores changed "
            "rewards")
    require(all(bool(torch.isfinite(x.float()).all()) for x in (*k32, *k16)),
            f"{tag} K4: non-finite output")
    k32 = tuple(x[..., ::stride] for x in k32)
    k16 = tuple(x[..., ::stride] for x in k16[:2])
    st = arm.EnvState(*(x[::stride] for x in s0))
    Nc = st.q.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = r3.rollout3d_plain(cfg, params, st.q, st.qd, st.tgt, st.task,
                               eps[:, ::stride])
    torch.cuda.synchronize()
    t_k4p = 1e3 * (time.perf_counter() - t0)
    W = K4_TIGHT_STEPS
    errs_w = [float((k[:W] - p[:W]).abs().max()) for k, p in zip(k32, p_out)]
    errs = [float((k - p).abs().max()) for k, p in zip(k32, p_out)]
    print(f"{tag} K4 eps mode on {N} envs, plain version on every "
          f"{stride}-th ({Nc} envs), fp32 stores: max |kernel - "
          f"plain| (obs, act, rew) {errs_w} over {W} steps (bound "
          f"{K4_TIGHT_ATOL}), {errs} over {T} steps (bound {K4_FULL_ATOL})")
    require(max(errs_w) <= K4_TIGHT_ATOL, f"{tag} K4 {W}-step error {errs_w}")
    require(max(errs) <= K4_FULL_ATOL, f"{tag} K4 full-horizon error {errs}")
    ulps = []
    for k, p in zip(k16, p_out[:2]):
        pr = p[:W].to(bf16).float()
        ulps.append(float(((k[:W].float() - pr).abs() / bf16_ulp(pr)).max()))
    full16 = max(float((k.float() - p).abs().max())
                 for k, p in zip(k16, p_out[:2]))
    print(f"{tag} K4 eps mode, bf16 stores: max |kernel - round(plain)| in "
          f"bf16 ulps (obs, act) {ulps} over {W} steps (bound 1); max "
          f"|kernel - plain| {full16:.3e} over {T} steps (bound "
          f"{K4_FULL_ATOL} + the bf16 rounding)")
    require(max(ulps) <= 1.0, f"{tag} K4 bf16 error {ulps} ulps")
    require(full16 <= K4_FULL_ATOL + 2.0 ** -8 * max(
        float(p.abs().max()) for p in p_out[:2]), f"{tag} K4 bf16 full "
        f"{full16}")
    if exact:
        ulps_full = bf16_ulps(k16, p_out[:2])
        print(f"{tag} K4 exact: max |kernel - plain| {max(errs)} over {T} "
              f"steps with fp32 stores (bound 0.0), max |kernel - "
              f"round(plain)| {ulps_full} bf16 ulps with bf16 stores "
              "(bound 0)")
        require(max(errs) == 0.0 and ulps_full == 0.0,
                f"{tag} K4 differs from its plain version: {errs}, "
                f"{ulps_full} ulps")
    del k32, k16, p_out
    seed_a = torch.tensor(K4_SEED_A, dtype=torch.int64, device=dev)
    seed_b = torch.tensor([K4_SEED_A[0] + 1, K4_SEED_A[1]], dtype=torch.int64,
                          device=dev)
    obs_ff, act_ff, rew_ff = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt,
                                          s0.task, seed=seed_a,
                                          store_dtype=bf16)
    digest = sha256(obs_ff, act_ff, rew_ff)
    print(f"{tag} K4 Philox batch (seed {K4_SEED_A}, bf16 stores) SHA-256 "
          f"{digest}")
    again = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task,
                         seed=seed_a, store_dtype=bf16)
    require(all(torch.equal(a, b) for a, b in
                zip((obs_ff, act_ff, rew_ff), again)),
            f"{tag} K4: the same seed gave a different batch")
    del again
    _, act_b, _ = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task,
                               seed=seed_b, store_dtype=bf16)
    require(not torch.equal(act_ff, act_b),
            f"{tag} K4: a different seed gave the same batch")
    del act_b
    # mu from the stored bf16 obs (the task one-hot rows are exact in bf16)
    z_sum = z_sq = 0.0
    for t0_ in range(0, T, 50):
        mu = policy.mean_net(params, obs_ff[t0_:t0_ + 50].float()
                             .permute(0, 2, 1)).permute(0, 2, 1)
        z = (act_ff[t0_:t0_ + 50].float() - mu) \
            / torch.exp(params["logstd"])[None, :, None]
        z_sum += float(z.double().sum())
        z_sq += float((z.double() ** 2).sum())
    cnt = T * da * N
    z_mean = z_sum / cnt
    z_std = math.sqrt((z_sq - cnt * z_mean ** 2) / (cnt - 1))
    print(f"{tag} K4 Philox mode: {cnt} draws, mean {z_mean:+.5f}, "
          f"std {z_std:.5f} (bound {K4_Z_TOL})")
    require(abs(z_mean) <= K4_Z_TOL and abs(z_std - 1.0) <= K4_Z_TOL,
            f"{tag} K4 Philox noise mean {z_mean}, std {z_std}")
    require(all(bool(torch.isfinite(x.float()).all())
                for x in (obs_ff, act_ff, rew_ff)), f"{tag} K4: non-finite")
    rec["rollout3d"] = dict(max_abs_err=max(errs_w), philox_sha256=digest)

    # ---- K2 bf16 mode vs normal_eq_ff on the bf16 batch
    targets = gae(rew_ff, torch.zeros_like(rew_ff), cfg.trpo.gamma,
                  cfg.trpo.lam, time_axis=0)
    gram_k, gram_p, tau = k2_check(tag, obs_ff, targets, cfg.horizon)
    require(torch.equal(gram_k, mk.extended_gram(obs_ff, targets, tau)),
            f"{tag} K2 bf16 mode is not deterministic")
    print(f"{tag} K2 bf16 mode: repeat calls bit-identical")
    rec["moments_bf16"] = dict(
        max_abs_err=float((gram_k - gram_p).abs().max()))
    del gram_p

    # ---- K5 surrogate gradient vs its plain version (its route only)
    adv = (targets - targets.mean()) / (targets.std() + 1e-8)
    if use_pg:
        g_k, mu_k, lp_k = pk.surrogate_grad(params, obs_ff, act_ff, adv)
        g_p, mu_p, lp_p = pk.surrogate_grad_plain(params, obs_ff, act_ff, adv)
        fg_k, fg_p = policy.flatten(g_k), policy.flatten(g_p)
        rel_g = float(torch.linalg.norm(fg_k - fg_p) / torch.linalg.norm(fg_p))
        err_mu = float((mu_k - mu_p).abs().max())
        rel_lp = float(((lp_k - lp_p).abs()
                        / lp_p.abs().clamp_min(1e-6)).max())
        print(f"{tag} K5: rel L2 err g {rel_g:.3e} (bound {K5_REL} at (64, "
              f"64), see below), max |mu "
              f"err| {err_mu:.3e} (bound {K5_MU_ATOL}), max rel logp err "
              f"{rel_lp:.3e} (bound {K5_LOGP_REL})")
        # both fp32 sum orders against the fp64 evaluation with the same bf16
        # rounding points: mu beyond its slack, g in all and on the samples
        # whose roundings are unambiguous (run again with the others' adv 0)
        ref = pg_fp64_batch(params, obs_ff, act_ff, adv,
                            dict(kernel=mu_k, plain=mu_p))
        adv_kept = adv * ref["kept"]
        far, kept_g = {}, {}
        for name, fn, g_all in (("kernel", pk.surrogate_grad, fg_k),
                                ("plain", pk.surrogate_grad_plain, fg_p)):
            g_kept = kept_g[name] = policy.flatten(
                fn(params, obs_ff, act_ff, adv_kept)[0])
            far[name] = (ref["mu_over"][name], rel_l2(g_all, ref["g"]),
                         rel_l2(g_kept, ref["g_kept"]))
            print(f"{tag} K5 {name} vs fp64 evaluation: mu beyond its slack "
                  f"{far[name][0]:.3e} (bound {PG_MU_FP64_ATOL}), rel L2 g "
                  f"{far[name][1]:.3e}, on the {ref['kept_share']:.3f} of "
                  f"samples with unambiguous roundings {far[name][2]:.3e} "
                  f"(bound {PG_G_KEPT_REL})")
        del ref, adv_kept
        require(far["kernel"][0] <= PG_MU_FP64_ATOL
                and far["kernel"][2] <= PG_G_KEPT_REL,
                f"{tag} K5 against the fp64 evaluation {far['kernel']}")
        # the kernel against the plain version: on the samples with
        # unambiguous roundings, where the two compute the same function up
        # to fp32 sums, and, for the (64, 64) policy, on every sample (K5_REL,
        # the bound of its first tensor-core version). A deeper policy
        # carries more bf16 roundings a sample (at (64, 64, 64) 64 % of c3's
        # samples have an ambiguous one, which either sum order may round to
        # the other neighbour), so there only the first holds.
        rel_g_kept = rel_l2(kept_g["kernel"], kept_g["plain"].double())
        print(f"{tag} K5 kernel vs plain on the samples with unambiguous "
              f"roundings: rel L2 g {rel_g_kept:.3e} (bound {PG_G_KEPT_REL})")
        require(rel_g_kept <= PG_G_KEPT_REL, f"{tag} K5 error on the samples "
                f"with unambiguous roundings {rel_g_kept}")
        require((rel_g <= K5_REL or tuple(hidden) != (64, 64))
                and err_mu <= K5_MU_ATOL and rel_lp <= K5_LOGP_REL,
                f"{tag} K5 error {rel_g}, {err_mu}, {rel_lp}")
        del mu_p, lp_p
        again = pk.surrogate_grad(params, obs_ff, act_ff, adv)
        require(torch.equal(policy.flatten(again[0]), fg_k)
                and torch.equal(again[1], mu_k)
                and torch.equal(again[2], lp_k),
                f"{tag} K5 is not deterministic")
        print(f"{tag} K5: repeat calls bit-identical")
        del again, mu_k, lp_k
        rec["pg"] = dict(max_abs_err=float((fg_k - fg_p).abs().max()))

    # ---- K6 feature-first FVP vs its plain version on the subsample,
    # or K3 on its fp32 relayout, as the update routes it
    k, e = cfg.trpo.fvp_subsample, cfg.trpo.fvp_env_subsample
    sub = obs_ff[::k, :, ::e]
    B_sub = sub.shape[0] * sub.shape[2]
    if use_ff:
        fvp = ffk.make_gn_fvp_ff(params, sub, cfg.trpo.cg_damping)
        worst_rel, worst_abs = 0.0, 0.0
        for _ in range(10):
            v = torch.randn(P, generator=gen, device=dev)
            f_k = fvp(v)
            f_p = ffk.gn_fvp_ff_plain(params, sub, v, cfg.trpo.cg_damping)
            worst_rel = max(worst_rel, float(torch.linalg.norm(f_k - f_p)
                                             / torch.linalg.norm(f_p)))
            worst_abs = max(worst_abs, float((f_k - f_p).abs().max()))
            require(torch.equal(f_k, fvp(v)), f"{tag} K6 is not deterministic")
        print(f"{tag} K6 on obs_ff[::{k}, :, ::{e}]: B' = {B_sub}, worst "
              f"relative L2 err {worst_rel:.3e} over 10 v (bound {K6_REL}); "
              "repeat calls bit-identical")
        require(worst_rel <= K6_REL, f"{tag} K6 error {worst_rel}")
        rec["fvp_ff"] = dict(max_abs_err=worst_abs)
    else:
        obs_fvp = sub.permute(0, 2, 1).reshape(-1, do).float()
        rec["fvp"] = dict(max_rel_err=k3_shape_check(
            f"{tag} (fp32 relayout)", gen, params, obs_fvp,
            cfg.trpo.cg_damping))

    # ---- five full-width iterations through the trainer
    n_iters = 5
    launches, ms_upd = train_checked(
        cfg, n_iters, kernels,
        {"rollout": 0, "moments": n_iters,
         "fvp": 0 if use_ff else n_iters * cfg.trpo.cg_iters,
         "rollout3d": n_iters, "pg": n_iters if use_pg else 0,
         "fvp_ff": n_iters * cfg.trpo.cg_iters if use_ff else 0}, train)

    # ---- kernel times beside bounds and plain versions
    B = T * N
    per_step = k4_flops_per_env_step(r3, cfg, params, s0, eps, s0.task)
    print(f"{tag} K4 work per env-step, counted from the plain version: "
          f"{per_step:.1f} FLOP (the policy MLP's "
          f"{2 * mlp_macs(do, hidden, da)} included)")
    t_k4 = k4_ms(cfg, params, s0)
    b4, b4fused, zero, ceiling = k4_bound(r3, cfg, params, s0, per_step)
    need = per_step - zero
    print(f"{tag} K4: {zero:.1f} of the fused sweep's {per_step:.1f} FLOP "
          f"per env-step ({100 * zero / per_step:.1f} %) are structural "
          f"zeros the kernel skips; bound on the {need:.1f} it needs "
          f"{b4[0]:.4f} ms ({b4[1]}), the fused sweep's {b4fused[0]:.4f} "
          f"ms; -fmad=false leaves at most {100 * ceiling:.1f} % of the "
          f"bound reachable")
    rec["rollout3d"].update(zero_flop_share=zero / per_step,
                            bound_fused_ms=b4fused[0], fmad_ceiling=ceiling)
    R = 2 * do + 5
    t_k2 = cuda_ms(lambda: mk.extended_gram(obs_ff, targets, tau), 20)
    t_k2p = cuda_ms(lambda: mk.extended_gram_plain(obs_ff, targets, tau), 5)
    v_ext = torch.cat([baseline.data_rows(obs_ff, targets),
                       tau[:, :, None].expand(T, 4, N)], dim=1) \
        .permute(1, 0, 2).reshape(R, B).contiguous()
    t_k2lib = cuda_ms(lambda: torch.matmul(v_ext, v_ext.T), 20)
    del v_ext
    # every operand is exact in bf16, so the card can do these products
    # on its tensor cores: 2 E B operations at the bf16 peak is the bound.
    # The fp32-FMA figure (the same products summed outside the tensor
    # cores) is kept beside it, labelled.
    b2 = bound_ms(2.0 * (R * (R + 1) // 2) * B,
                  B * (2 * do + 4) + 4.0 * (4 * T + R * R),
                  peak_flops=PEAK_BF16_FLOPS)
    b2fma = bound_ms(2.0 * (R * (R + 1) // 2) * B + B * do,
                     B * (2 * do + 4) + 4.0 * (4 * T + R * R))
    print(f"{tag} moments_bf16: tensor-core bound {b2[0]:.4f} ms ({b2[1]}), "
          f"{100 * b2[0] / t_k2:.1f} % of it reached; fp32-FMA bound "
          f"{b2fma[0]:.4f} ms ({b2fma[1]})")
    rec["moments_bf16"].update(bound_fp32_fma_ms=b2fma[0],
                               bound_share=b2[0] / t_k2)
    rows = [("rollout3d", t_k4, t_k4p, b4, None),
            ("moments_bf16", t_k2, t_k2p, b2, t_k2lib)]
    if use_pg:
        t_k5 = cuda_ms(lambda: pk.surrogate_grad(params, obs_ff, act_ff,
                                                 adv), 10)
        t_k5p = cuda_ms(lambda: pk.surrogate_grad_plain(params, obs_ff, act_ff,
                                                        adv), 3, warmup=1)
        # the MLP's products, each counted once (the kernel's three-plane split
        # of the weights is its own cost, not the work), at the bf16
        # tensor-core peak; the fp32-FMA figure is kept beside it, labelled
        pg_macs = surrogate_grad_macs(do, hidden, da)
        pg_bytes = B * ((do + da) * 2 + 4 + 4 * da + 4) + 4.0 * 2 * P
        b5 = bound_ms(2.0 * pg_macs * B, pg_bytes, peak_flops=PEAK_BF16_FLOPS)
        b5fma = bound_ms(2.0 * pg_macs * B, pg_bytes)
        print(f"{tag} pg: tensor-core bound {b5[0]:.4f} ms ({b5[1]}), "
              f"{100 * b5[0] / t_k5:.1f} % of it reached; fp32-FMA bound "
              f"{b5fma[0]:.4f} ms ({b5fma[1]})")
        rec["pg"].update(bound_fp32_fma_ms=b5fma[0], bound_share=b5[0] / t_k5)
        rows.append(("pg", t_k5, t_k5p, b5, None))
    v = torch.randn(P, generator=gen, device=dev)
    if use_ff:
        t_k6 = k6_ms(params, sub, cfg.trpo.cg_damping, v)
        t_k6p = cuda_ms(lambda: ffk.gn_fvp_ff_plain(params, sub, v,
                                                    cfg.trpo.cg_damping), 5)
        # the function's products, each counted once, at the bf16 tensor-core
        # peak (the kernel's three-plane split of its fp32 operands is its own
        # cost, not the work, as for K5); the fp32-FMA figure beside it,
        # labelled. Bytes: the subsample read once in its storage dtype, v, the
        # weights and Fv. The strided view's reads come in 32-byte sectors:
        # printed as a note, not as the bound.
        ff_macs = fvp_ff_macs(do, hidden, da)
        es = sub.element_size()
        ff_bytes = es * B_sub * do + 4.0 * 3 * P
        b6 = bound_ms(2.0 * ff_macs * B_sub, ff_bytes,
                      peak_flops=PEAK_BF16_FLOPS)
        b6fma = bound_ms(2.0 * ff_macs * B_sub, ff_bytes)
        span = sub.stride(2) * es                  # bytes between two envs
        sectors = (sub.shape[2] if span >= 32
                   else math.ceil(sub.shape[2] * span / 32))
        sector_bytes = 32.0 * sectors * sub.shape[0] * do
        print(f"{tag} fvp_ff: tensor-core bound {b6[0]:.4f} ms ({b6[1]}), "
              f"{100 * b6[0] / t_k6:.1f} % of it reached; fp32-FMA bound "
              f"{b6fma[0]:.4f} ms ({b6fma[1]}); note: the strided view "
              f"(env stride {sub.stride(2)}, {es}-byte elements) reads "
              f"{sector_bytes / 1e6:.1f} MB of 32-byte sectors, "
              f"{1e3 * sector_bytes / PEAK_BYTES:.4f} ms at "
              f"{PEAK_BYTES / 1e12} TB/s")
        rec["fvp_ff"].update(bound_fp32_fma_ms=b6fma[0],
                             bound_share=b6[0] / t_k6,
                             sector_read_mb=sector_bytes / 1e6)
        rows.append(("fvp_ff", t_k6, t_k6p, b6, None))
    else:
        # K3 on the fp32 relayout: its bound as in phase 2e, the
        # function's products at the bf16 tensor-core peak (the wide
        # form runs them on the CUDA cores; ROADMAP B4), the fp32-FMA
        # figure beside it
        t_k3 = k3_ms(params, obs_fvp, cfg.trpo.cg_damping, v)
        hs = fk.activations(params, obs_fvp)
        scale = torch.exp(-2.0 * params["logstd"]) / B_sub
        t_k3p = cuda_ms(lambda: fk.gn_fvp_plain(
            params, obs_fvp, hs, scale, v, cfg.trpo.cg_damping), 10)
        del hs
        b3, b3fma = k3_bound(B_sub, do, da, P, hidden)
        print(f"{tag} fvp: tensor-core bound {b3[0]:.4f} ms ({b3[1]}), "
              f"{100 * b3[0] / t_k3:.1f} % of it reached; fp32-FMA "
              f"bound {b3fma[0]:.4f} ms ({b3fma[1]})")
        rec["fvp"].update(bound_fp32_fma_ms=b3fma[0],
                          bound_share=b3[0] / t_k3, hidden=list(hidden))
        rows.append(("fvp", t_k3, t_k3p, b3, None))
    for name, ms, plain_ms, (bms, by), lib_ms in rows:
        kname = "moments" if name == "moments_bf16" else name
        rec[name].update(launches=launches[kname], ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=lib_ms)
        print(f"{tag} {name}: {ms:.4f} ms/launch (bound {bms:.4f} ms by "
              f"{by}), plain {plain_ms:.3f} ms"
              + (f" (on {Nc} envs, once)" if name == "rollout3d" else "")
              + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f", {launches[kname] // n_iters} launch(es)/update")
    rec["rollout3d"].update(plain_envs=Nc, ms_per_update=ms_upd)
    return rec


def check_fresh_state_mode(tag, k_out, p_out):
    """The TERM kernel in fresh-state mode against its plain version on the
    same inputs: identical done flags, max |kernel - plain| = 0.0. Returns
    (max error, early dones checked)."""
    require(torch.equal(k_out[3], p_out[3]),
            f"{tag}: the kernel's done flags differ from the plain version's")
    errs = [float((k - p).abs().max()) for k, p in zip(k_out[:3], p_out[:3])]
    early = int(p_out[3][:-1].sum())
    print(f"{tag} fresh-state mode: {early} early dones, identical flags; "
          f"max |kernel - plain| (obs, act, rew) {errs} over "
          f"{p_out[0].shape[0]} steps (bound 0.0)")
    require(max(errs) == 0.0, f"{tag}: kernel differs from plain: {errs}")
    require(early > 0, f"{tag}: no early done in the checked envs")
    return max(errs), early


def check_no_done_limit(tag, base, out):
    """TERM with done_dist 1e-9 against the non-terminating instantiation,
    the same seed: bit for bit, no done flag."""
    require(len(base) == 3 and len(out) == 4, f"{tag}: output arity")
    same = all(torch.equal(a, b) for a, b in zip(out[:3], base))
    print(f"{tag} done_dist 1e-9, Philox mode: TERM batch bit-identical to "
          f"the non-terminating one: {same}; done flags set: "
          f"{int(out[3].sum())}")
    require(same and not bool(out[3].any()),
            f"{tag}: the limit of no done is not the non-terminating batch")


def fresh_states_after_dones(obs, dones):
    """(step, env) of every done before the last step, and the
    observation at the next step of each: the fresh episode's first
    observation, (K, do)."""
    idx = torch.nonzero(dones[:-1] > 0.5)
    nxt = obs[idx[:, 0] + 1, :, idx[:, 1]].float()
    return idx, nxt


def check_reset_ranges(tag, c, q, qd, radius):
    """q in +-q0_noise, qd in +-qd0_noise, the target radius in [rmin,
    rmax], each within RESET_TOL, and q's mean within 4 sigma of 0."""
    K = q.shape[0]
    q_max, qd_max = float(q.abs().max()), float(qd.abs().max())
    r_lo, r_hi = float(radius.min()), float(radius.max())
    q_mean = float(q.double().mean())
    q_sig = c.q0_noise / math.sqrt(3.0 * q.numel())
    print(f"{tag} Philox resets: {K} fresh episodes; max |q| {q_max:.6f} "
          f"(q0_noise {c.q0_noise}), mean q {q_mean:+.5f} (4 sigma "
          f"{4 * q_sig:.5f}), max |qd| {qd_max:.7f} (qd0_noise "
          f"{c.qd0_noise}), target radius [{r_lo:.5f}, {r_hi:.5f}] (range "
          f"[{c.rmin:.5f}, {c.rmax:.5f}])")
    require(K > 0, f"{tag}: no early done in Philox mode")
    require(q_max <= c.q0_noise + RESET_TOL, f"{tag}: fresh q {q_max}")
    require(qd_max <= c.qd0_noise + RESET_TOL, f"{tag}: fresh qd {qd_max}")
    require(c.rmin - RESET_TOL <= r_lo and r_hi <= c.rmax + RESET_TOL,
            f"{tag}: fresh target radius [{r_lo}, {r_hi}]")
    require(abs(q_mean) <= 4 * q_sig, f"{tag}: fresh q mean {q_mean}")


def term_variant_ms(tag, launch, done_dist, rounds, iters, warmup,
                    lead_ms=0.0):
    """Per-launch ms of the TERM kernel at ``done_dist``, of the same
    instantiation with no done (1e-9), of the non-terminating kernel (0)
    and of TERM at 4 done_dist (more resets), timed in turns over
    ``rounds`` rounds on the same seed; ``launch(d)`` runs the wrapper at
    done distance d. Prints every round and the resets of each variant;
    returns {variant: mean ms}."""
    variants = {"term": done_dist, "no_done": 1e-9, "nonterminating": 0.0,
                "term_4x": 4.0 * done_dist}
    resets = {k: (int(launch(d)[3][:-1].sum()) if d > 0.0 else 0)
              for k, d in variants.items()}
    times = {k: [] for k in variants}
    for _ in range(rounds):
        for k, d in variants.items():
            times[k].append(cuda_ms(lambda: launch(d), iters, warmup=warmup,
                                    lead_ms=lead_ms))
    for k in variants:
        print(f"{tag} {k} (done_dist {variants[k]:g}, {resets[k]} early "
              f"dones): ms per launch in turns "
              f"{[round(x, 4) for x in times[k]]}")
    return {k: sum(v) / len(v) for k, v in times.items()}


def c2_term_phases(dev):
    """K1's TERM instantiation at c2 with done_dist C2_DONE_DIST: fresh-state
    mode against the plain version, the no-done limit, Philox resets,
    training and its time; returns {"rollout_term": record}."""
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    from trpo_robot_control_tpu_torch.trpo.train import train
    cfg = C2_REACHER3.replace(done_dist=C2_DONE_DIST)
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    c = rk.planar_consts(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    params = policy.init_params(gen, cfg.obs_dim, n, cfg.trpo.hidden,
                                cfg.trpo.logstd_init)
    P = policy.flatten(params).numel()
    s0 = arm.reset(cfg, gen, N)
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    fresh = arm.fresh_episodes(cfg, gen, N)

    # ---- fresh-state mode vs the plain version
    k_out = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, eps=eps,
                       fresh=fresh)
    p_out = rk.rollout_plain(cfg, params, s0.q, s0.qd, s0.tgt, eps, fresh)
    torch.cuda.synchronize()
    err, _ = check_fresh_state_mode("c2 K1-term", k_out, p_out)

    # ---- the limit of no done
    seed = torch.tensor([12345, 678], dtype=torch.int64, device=dev)
    check_no_done_limit(
        "c2 K1-term",
        rk.rollout(cfg.replace(done_dist=0.0), params, s0.q, s0.qd, s0.tgt,
                   seed=seed),
        rk.rollout(cfg.replace(done_dist=1e-9), params, s0.q, s0.qd, s0.tgt,
                   seed=seed))

    # ---- Philox resets read back from the next observation
    obs, _, _, dones = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt,
                                  seed=seed)
    _, o = fresh_states_after_dones(obs, dones)
    q = torch.atan2(o[:, n:2 * n], o[:, :n])
    qd = o[:, 2 * n:3 * n] / c.qd_obs_scale
    *_, eex, eey = rk._fk(c, list(q.T))
    tx, ty = o[:, 3 * n] + eex, o[:, 3 * n + 1] + eey
    check_reset_ranges("c2 K1-term", c, q, qd, torch.sqrt(tx * tx + ty * ty))
    ang = torch.atan2(ty, tx).double()
    cm, sm = float(torch.cos(ang).mean()), float(torch.sin(ang).mean())
    sig = math.sqrt(0.5 / ang.numel())
    print(f"c2 K1-term Philox resets: mean cos, sin of the target angle "
          f"{cm:+.4f}, {sm:+.4f} (4 sigma {4 * sig:.4f})")
    require(abs(cm) <= 4 * sig and abs(sm) <= 4 * sig,
            f"c2 fresh target angle mean cos {cm}, sin {sm}")
    digest = k1_digest(cfg, params, s0, torch.tensor(
        K1_SEED, dtype=torch.int64, device=dev))
    print(f"c2 K1-term Philox batch (seed {K1_SEED}) SHA-256 {digest}")

    # ---- five full-width iterations through the trainer
    n_iters = 5
    launches, _ = train_checked(
        cfg, n_iters, kernels,
        {"rollout": n_iters, "moments": n_iters,
         "fvp": n_iters * cfg.trpo.cg_iters, "rollout3d": 0, "pg": 0,
         "fvp_ff": 0}, train)

    # ---- time beside the bound: K1's (the MLP's FLOPs; every input read
    # and output written once) plus the done flags' bytes; the plain
    # version's reset is selects only, no FLOPs
    t = term_variant_ms(
        "c2 K1", lambda d: rk.rollout(cfg.replace(done_dist=d), params, s0.q,
                                      s0.qd, s0.tgt, seed=seed),
        cfg.done_dist, rounds=3, iters=20, warmup=2, lead_ms=K1_LEAD_MS)
    t_k = t["term"]
    t_p = cuda_ms(lambda: rk.rollout_plain(cfg, params, s0.q, s0.qd, s0.tgt,
                                           eps, fresh), 2, warmup=1)
    bms, by = k1_bound(cfg, P)
    print(f"c2 rollout_term: {t_k:.4f} ms/launch, {1e3 * t_k / T:.3f} us per "
          f"step (bound {bms:.4f} ms by {by}), plain {t_p:.3f} ms, "
          f"{launches['rollout'] // n_iters} launch(es)/update")
    return {"rollout_term": dict(
        launches=launches["rollout"], max_abs_err=err, ms=t_k, plain_ms=t_p,
        bound_ms=bms, bound_by=by, library_ms=None, us_per_step=1e3 * t_k / T,
        done_dist=cfg.done_dist, variants_ms=t, philox_sha256=digest)}


def c5_term_phases(dev, base=None, tag="c5", seed=13):
    """K4's TERM instantiation at c5 (or ``base``, a config of the 3-D
    kernel with three task families) with done_dist C5_DONE_DIST:
    fresh-state mode against the plain version on every (N /
    K4_CHECK_ENVS)-th env, bf16 stores, the no-done limit, Philox resets
    with the task redraw (a planar arm's fresh targets in the z = 0 plane
    at a uniform angle), training and its time; returns
    {"rollout3d_term": record}."""
    from trpo_robot_control_tpu_torch.configs import C5_MULTITASK
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    from trpo_robot_control_tpu_torch.trpo.train import train
    cfg = (base or C5_MULTITASK).replace(done_dist=C5_DONE_DIST)
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    do, da = cfg.obs_dim, n
    bf16 = torch.bfloat16
    c = r3.arm3d_consts(cfg)
    gen, params, s0 = k4_setup(dev, cfg, seed)
    P = policy.flatten(params).numel()
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    fresh = arm.fresh_episodes(cfg, gen, N)

    # ---- fresh-state mode at full width vs the plain version on every
    # stride-th env of the same inputs (plain timed once, no warm-up)
    stride = max(1, N // K4_CHECK_ENVS)
    k32 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task, eps=eps,
                       fresh=fresh)
    k16 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task, eps=eps,
                       fresh=fresh, store_dtype=bf16)
    all_early = int(k32[3][:-1].sum())
    require(torch.equal(k16[2], k32[2]) and torch.equal(k16[3], k32[3]),
            f"{tag} K4-term: bf16 stores changed rewards or done flags")
    k32 = tuple(x[..., ::stride] for x in k32)
    k16 = tuple(x[..., ::stride] for x in k16[:2])
    st = arm.EnvState(*(x[::stride] for x in s0))
    fr = arm.EnvState(*(x[:, ::stride] for x in fresh))
    Nc = st.q.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = r3.rollout3d_plain(cfg, params, st.q, st.qd, st.tgt, st.task,
                               eps[:, ::stride], fr)
    torch.cuda.synchronize()
    t_p = 1e3 * (time.perf_counter() - t0)
    print(f"{tag} K4-term fresh-state mode on {N} envs ({all_early} early "
          f"dones), plain version on every {stride}-th ({Nc} envs):")
    err, _ = check_fresh_state_mode(f"{tag} K4-term", k32, p_out)
    ulps = bf16_ulps(k16, p_out[:2])
    print(f"{tag} K4-term bf16 stores: max |kernel - round(plain)| {ulps} "
          f"bf16 ulps (obs, act) over {T} steps (bound 0)")
    require(ulps == 0.0, f"{tag} K4-term bf16 stores {ulps} ulps")
    del k32, k16, p_out

    # ---- the limit of no done (bf16 stores, as the trainer runs)
    seed = torch.tensor(K4_SEED_A, dtype=torch.int64, device=dev)
    check_no_done_limit(
        f"{tag} K4-term",
        r3.rollout3d(cfg.replace(done_dist=0.0), params, s0.q, s0.qd, s0.tgt,
                     s0.task, seed=seed, store_dtype=bf16),
        r3.rollout3d(cfg.replace(done_dist=1e-9), params, s0.q, s0.qd,
                     s0.tgt, s0.task, seed=seed, store_dtype=bf16))

    # ---- Philox resets (fp32 stores) read back from the next observation
    batch = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task, seed=seed)
    digest = sha256(*batch)
    print(f"{tag} K4-term Philox batch (seed {K4_SEED_A}, fp32 stores) "
          f"SHA-256 {digest}")
    obs, dones = batch[0], batch[3]
    del batch
    early = int(dones[:-1].sum())
    _, o = fresh_states_after_dones(obs, dones)
    del obs
    cq, sq = o[:, :n], o[:, n:2 * n]
    q = torch.atan2(sq, cq)
    qd = o[:, 2 * n:3 * n] / c.qd_obs_scale
    ee = r3._fk3(c, list(cq.T), list(sq.T))[3]
    tgt = torch.stack([o[:, 3 * n + i] + ee[i] for i in range(3)], dim=1)
    check_reset_ranges(f"{tag} K4-term", c, q, qd,
                       torch.linalg.norm(tgt, dim=1))
    z_min = float(tgt[:, 2].min())
    onehot = o[:, 3 * n + 3:]
    counts = onehot.sum(0)
    K = onehot.shape[0]
    sig = math.sqrt(K * (1.0 / 3) * (2.0 / 3))
    print(f"{tag} K4-term Philox resets: {early} early dones; min target z "
          f"{z_min:+.6f}; fresh task counts {counts.tolist()} (expected "
          f"{K / 3:.1f} each, 4 sigma {4 * sig:.1f})")
    if c.planar:
        # the plane's targets: z exactly 0 (the next observation's z row,
        # target z less the planar FK's exact 0), the angle uniform
        z_abs = float(tgt[:, 2].abs().max())
        ang = torch.atan2(tgt[:, 1], tgt[:, 0]).double()
        cm, sm = float(torch.cos(ang).mean()), float(torch.sin(ang).mean())
        asig = math.sqrt(0.5 / ang.numel())
        print(f"{tag} K4-term planar resets: max |target z| {z_abs} (bound "
              f"0.0); mean cos, sin of the target angle {cm:+.4f}, "
              f"{sm:+.4f} (4 sigma {4 * asig:.4f})")
        require(z_abs == 0.0, f"{tag} fresh target z {z_abs}")
        require(abs(cm) <= 4 * asig and abs(sm) <= 4 * asig,
                f"{tag} fresh target angle mean cos {cm}, sin {sm}")
    require(z_min >= -RESET_TOL, f"{tag} fresh target z {z_min}")
    require(bool(((onehot == 0) | (onehot == 1)).all())
            and bool((onehot.sum(1) == 1).all()),
            f"{tag} fresh task one-hot is not one-hot")
    require(all(abs(float(x) - K / 3) <= 4 * sig for x in counts),
            f"{tag} fresh task counts {counts.tolist()}")
    del o, dones

    # ---- five full-width iterations through the trainer
    n_iters = 5
    launches, _ = train_checked(
        cfg, n_iters, kernels,
        {"rollout": 0, "moments": n_iters, "fvp": 0, "rollout3d": n_iters,
         "pg": n_iters, "fvp_ff": n_iters * cfg.trpo.cg_iters}, train)

    # ---- time beside the bound: K4's work per env-step (3f, the
    # structural zeros left out; the fused sweep's figure beside it) plus,
    # for this run's early dones, the plain version's reset (the fresh
    # cos/sin and FK), and the done flags' 4 bytes per env-step
    B = T * N
    per_step = k4_flops_per_env_step(r3, cfg.replace(done_dist=0.0), params,
                                     s0, eps, s0.task)
    zero = k4_zero_flops_per_env_step(r3, cfg, s0)
    one = [x[:1, :1] for x in fresh]
    q1, qd1 = list(s0.q[:1].T), list(s0.qd[:1].T)
    tg1 = tuple(s0.tgt[:1, i] for i in range(3))
    done1 = torch.ones(1, dtype=torch.bool, device=dev)
    per_reset = elementwise_flops(lambda: r3.start_fresh(
        c, done1, [x[0] for x in one], q1, qd1, tg1, s0.task[:1]))
    t = k4_term_ms(cfg, params, s0, tag)
    t_k = t["term"]
    nbytes = B * ((do + da) * 2 + 4 + 4) + 4.0 * (N * (2 * n + 4) + P)
    bms, by = bound_ms((per_step - zero) * B + per_reset * early, nbytes)
    fused = bound_ms(per_step * B + per_reset * early, nbytes)[0]
    print(f"{tag} rollout3d_term: {t_k:.4f} ms/launch (bound {bms:.4f} ms by "
          f"{by}; {per_step - zero:.1f} FLOP per env-step, the fused "
          f"sweep's {per_step:.1f} less its structural zeros, and "
          f"{per_reset} per reset, {early} resets; the fused sweep's bound "
          f"{fused:.4f} ms), plain {t_p:.3f} ms (on {Nc} envs, once), "
          f"{launches['rollout3d'] // n_iters} launch(es)/update")
    return {"rollout3d_term": dict(
        launches=launches["rollout3d"], max_abs_err=err, ms=t_k,
        plain_ms=t_p, bound_ms=bms, bound_by=by, library_ms=None,
        bound_fused_ms=fused, plain_envs=Nc, done_dist=cfg.done_dist,
        variants_ms=t, philox_sha256=digest)}


def c5_planar3():
    """c5's task mix on a 3-link planar arm at c5's full width: the JAX
    package's ``tests/test_multitask.py`` C5_SMALL (``C5_MULTITASK`` with
    ``planar_arm(3)`` and ``CostSpec(ctrl_weight=0.01)``) at 65,536 envs x
    200 steps. Its 15-wide observation routes it to K4 at 3 joints."""
    from trpo_robot_control_tpu_torch.configs import (C5_MULTITASK, CostSpec,
                                                      planar_arm)
    return C5_MULTITASK.replace(name="c5_planar3", arm=planar_arm(3),
                                cost=CostSpec(ctrl_weight=0.01))


def c2_bf16():
    """c2 with bf16 storage: K1's bf16 stores into K2-bf16 (do 12) and K3
    on the fp32 relayout of the Fisher subsample."""
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    return C2_REACHER3.replace(name="c2_bf16", trpo=dataclasses.replace(
        C2_REACHER3.trpo, ff_store_dtype="bf16"))


def c3_baselines32():
    """c3 with OpenAI Baselines' TRPO policy, ``MlpPolicy(hid_size=32,
    num_hid_layers=2)`` with tanh (baselines/trpo_mpi/run_mujoco.py)."""
    from trpo_robot_control_tpu_torch.configs import C3_FRANKA7
    return C3_FRANKA7.replace(name="c3_baselines32", trpo=dataclasses.replace(
        C3_FRANKA7.trpo, hidden=(32, 32)))


def c3_deep3():
    """c3 with three 64-wide hidden layers, the JAX package's 3-layer test
    shape (tests/test_pallas_fvp.py)."""
    from trpo_robot_control_tpu_torch.configs import C3_FRANKA7
    return C3_FRANKA7.replace(name="c3_deep3", trpo=dataclasses.replace(
        C3_FRANKA7.trpo, hidden=(64, 64, 64)))


def c2_baselines32():
    """c2 with OpenAI Baselines' TRPO policy, ``MlpPolicy(hid_size=32,
    num_hid_layers=2)`` with tanh (baselines/trpo_mpi/run_mujoco.py)."""
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    return C2_REACHER3.replace(name="c2_baselines32", trpo=dataclasses.replace(
        C2_REACHER3.trpo, hidden=(32, 32)))


def c2_deep3():
    """c2 with three 64-wide hidden layers, the JAX package's 3-layer test
    shape (tests/test_pallas_fvp.py)."""
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    return C2_REACHER3.replace(name="c2_deep3", trpo=dataclasses.replace(
        C2_REACHER3.trpo, hidden=(64, 64, 64)))


def phase8_libs():
    """The libraries phase 8 runs beyond the default ones: K4 at 7 joints,
    K5 and K6, at every shape of POLICY_SHAPES."""
    from trpo_robot_control_tpu_torch.ops.cuda import build
    return [build.lib_name(src, 7 if src == "rollout3d" else None, hidden)
            for hidden in POLICY_SHAPES
            for src in ("rollout3d", "pg", "fvp_ff")]


def policy_shape_checks(dev):
    """Phase 8a: K4, K5 and K6 at every shape of POLICY_SHAPES. K4 in eps
    mode on SHAPE_ENVS envs x 200 steps at c3's observation (do 24) and at
    c5's (do 27, three task families), fp32 and bf16 stores, against its
    plain version on every SHAPE_STRIDE-th env over the whole horizon
    (0.0 and 0 ulps); K5 on c3's batch in both modes against the fp64
    evaluation of its function (bf16 mode with its rounding points, as
    phase 3c holds it at (64, 64); fp32 mode unrounded); K6 against its
    plain version on the Fisher subsample obs_ff[::8, :, ::e], e = 1 on
    c3's batch and e = 8 on c5's, within K6_SHAPE_REL; with K4's and K6's
    occupancy at each shape. Returns {kernel: {shape: record}}."""
    from trpo_robot_control_tpu_torch.configs import C3_FRANKA7, C5_MULTITASK
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import (fvp_ff_kernel as ffk,
                                                       pg_kernel as pk,
                                                       rollout3d_kernel as r3)
    bf16 = torch.bfloat16
    out = {"rollout3d": {}, "pg": {}, "fvp_ff": {}}
    for hidden in POLICY_SHAPES:
        key = "x".join(map(str, hidden))
        r4, r5, r6 = {}, {}, {}
        for tag, base, e in (("c3", C3_FRANKA7, 1), ("c5", C5_MULTITASK, 8)):
            cfg = base.replace(n_envs=SHAPE_ENVS, trpo=dataclasses.replace(
                base.trpo, hidden=hidden))
            T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
            gen, params, s0 = k4_setup(dev, cfg, 20)
            eps = torch.randn(T, N, n, generator=gen, device=dev)
            k32 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task,
                               eps=eps)
            k16 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task,
                               eps=eps, store_dtype=bf16)
            st = arm.EnvState(*(x[::SHAPE_STRIDE] for x in s0))
            p_out = r3.rollout3d_plain(cfg, params, st.q, st.qd, st.tgt,
                                       st.task, eps[:, ::SHAPE_STRIDE])
            errs = [float((k[..., ::SHAPE_STRIDE] - p).abs().max())
                    for k, p in zip(k32, p_out)]
            ulps = bf16_ulps([x[..., ::SHAPE_STRIDE] for x in k16[:2]],
                             p_out[:2])
            print(f"{key} {tag} K4 eps mode on {N} envs x {T} steps, plain "
                  f"version on every {SHAPE_STRIDE}-th: max |kernel - "
                  f"plain| (obs, act, rew) {errs} with fp32 stores (bound "
                  f"0.0), {ulps} bf16 ulps from the rounded plain output "
                  "with bf16 stores (bound 0)")
            require(max(errs) == 0.0 and ulps == 0.0
                    and torch.equal(k16[2], k32[2]),
                    f"{key} {tag} K4 differs from its plain version: "
                    f"{errs}, {ulps} ulps")
            occ = r3.occupancy(cfg, bf16, hidden=hidden)
            print(f"{key} {tag} K4 occupancy [bf16]: {occ}")
            require(occ["blocks_per_sm"] >= 1, f"{key} K4 does not fit an SM")
            r4[tag] = dict(max_abs_err=max(errs), bf16_ulps=ulps,
                           plain_envs=st.q.shape[0], occupancy=brief(occ))
            del p_out
            if tag == "c3":
                adv = torch.randn(T, N, generator=gen, device=dev)
                for mode, obs, act in (("fp32", *k32[:2]),
                                       ("bf16", *k16[:2])):
                    rounding = mode == "bf16"
                    g_k, mu_k, _ = pk.surrogate_grad(params, obs, act, adv)
                    ref = pg_fp64_batch(params, obs, act, adv,
                                        dict(kernel=mu_k), rounding=rounding)
                    g_kept = policy.flatten(pk.surrogate_grad(
                        params, obs, act, adv * ref["kept"])[0])
                    mu_over = ref["mu_over"]["kernel"]
                    g_rel = rel_l2(g_kept, ref["g_kept"])
                    mu_b, g_b = ((PG_MU_FP64_ATOL, PG_G_KEPT_REL) if rounding
                                 else (PG_FP32_MU_ATOL, PG_FP32_G_REL))
                    print(f"{key} K5 {mode} mode vs the fp64 evaluation: mu "
                          f"beyond its slack {mu_over:.3e} (bound {mu_b}), "
                          f"rel L2 g on the {ref['kept_share']:.3f} of "
                          f"samples with unambiguous roundings {g_rel:.3e} "
                          f"(bound {g_b})")
                    require(mu_over <= mu_b and g_rel <= g_b,
                            f"{key} K5 {mode} against the fp64 evaluation: "
                            f"{mu_over}, {g_rel}")
                    r5[mode] = dict(mu_over_slack=mu_over, g_rel_l2=g_rel,
                                    kept_share=ref["kept_share"])
                    del ref, g_k, mu_k
            sub = k16[0][::8, :, ::e]
            P = policy.flatten(params).numel()
            fvp = ffk.make_gn_fvp_ff(params, sub, cfg.trpo.cg_damping)
            worst = 0.0
            for _ in range(3):
                v = torch.randn(P, generator=gen, device=dev)
                f_k = fvp(v)
                f_p = ffk.gn_fvp_ff_plain(params, sub, v, cfg.trpo.cg_damping)
                worst = max(worst, float(torch.linalg.norm(f_k - f_p)
                                         / torch.linalg.norm(f_p)))
                require(torch.equal(f_k, fvp(v)),
                        f"{key} K6 is not deterministic")
            occ6 = ffk.occupancy(bf16, hidden)
            print(f"{key} K6 on obs_ff[::8, :, ::{e}] (B' = "
                  f"{sub.shape[0] * sub.shape[2]}): worst relative L2 err "
                  f"{worst:.3e} over 3 v (bound {K6_SHAPE_REL[hidden]}); "
                  f"occupancy {occ6}")
            require(worst <= K6_SHAPE_REL[hidden], f"{key} K6 error {worst}")
            r6[f"e{e}"] = dict(rel_l2=worst, occupancy=brief(occ6),
                               tile=occ6["tile"])
            del k32, k16, sub
        out["rollout3d"][key], out["pg"][key], out["fvp_ff"][key] = r4, r5, r6
    return out


def phase9_libs():
    """The libraries phase 9 runs beyond the default ones: K1 at 3 links
    and K3, at every shape of POLICY_SHAPES."""
    from trpo_robot_control_tpu_torch.ops.cuda import build
    return [build.lib_name(src, 3 if src == "rollout" else None, hidden)
            for hidden in POLICY_SHAPES for src in ("rollout", "fvp")]


def k3_shape_check(tag, gen, params, obs_fvp, damping, rel=K3_SHAPE_REL):
    """K3 (``make_gn_fvp``) against its plain version within ``rel``
    (relative L2) for 3 v drawn from ``gen``, repeat calls bit-identical;
    returns the worst relative L2."""
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
    B = obs_fvp.shape[0]
    hs = fk.activations(params, obs_fvp)
    scale = torch.exp(-2.0 * params["logstd"]) / B
    fvp = make_gn_fvp(params, obs_fvp, damping)
    worst = 0.0
    for _ in range(3):
        v = torch.randn(policy.flatten(params).numel(), generator=gen,
                        device=obs_fvp.device)
        f_k = fvp(v)
        f_p = fk.gn_fvp_plain(params, obs_fvp, hs, scale, v, damping)
        worst = max(worst, float(torch.linalg.norm(f_k - f_p)
                                 / torch.linalg.norm(f_p)))
        require(torch.equal(f_k, fvp(v)), f"{tag} K3 is not deterministic")
    print(f"{tag} K3 on B' = {B} (do {obs_fvp.shape[1]}): worst relative L2 "
          f"err {worst:.3e} over 3 v (bound {rel}); repeat calls "
          "bit-identical")
    require(worst <= rel, f"{tag} K3 error {worst}")
    return worst


def k3_wide_check(tag, gen, params, obs_fvp, damping, n_v=3):
    """K3's wide form (``make_gn_fvp`` at a layer over 64 units) against
    its plain version within K3_SHAPE_REL and against the statement of its
    arithmetic (``gn_fvp_wide_split`` in ``tests/test_torch_helpers.py``)
    within K3_SPLIT_REL, for ``n_v`` v drawn from ``gen``; repeat calls and
    a fresh workspace bit-identical. Returns the worst relative L2 errors
    (plain, statement)."""
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
    statement = port_test_helpers().gn_fvp_wide_split
    B = obs_fvp.shape[0]
    hs = fk.activations(params, obs_fvp)
    scale = torch.exp(-2.0 * params["logstd"]) / B
    fvp = make_gn_fvp(params, obs_fvp, damping)
    worst = worst_s = 0.0
    for _ in range(n_v):
        v = torch.randn(policy.flatten(params).numel(), generator=gen,
                        device=obs_fvp.device)
        f_k = fvp(v)
        f_p = fk.gn_fvp_plain(params, obs_fvp, hs, scale, v, damping)
        f_s = statement(params, obs_fvp, hs, v, damping)
        worst = max(worst, float(torch.linalg.norm(f_k - f_p)
                                 / torch.linalg.norm(f_p)))
        worst_s = max(worst_s, float(torch.linalg.norm(f_k - f_s)
                                     / torch.linalg.norm(f_s)))
        require(torch.equal(f_k, fvp(v))
                and torch.equal(f_k, make_gn_fvp(params, obs_fvp,
                                                 damping)(v)),
                f"{tag} K3 is not deterministic")
    print(f"{tag} K3 on B' = {B} (do {obs_fvp.shape[1]}): worst relative L2 "
          f"err {worst:.3e} from the plain version (bound {K3_SHAPE_REL}), "
          f"{worst_s:.3e} from the statement of its arithmetic (bound "
          f"{K3_SPLIT_REL}) over {n_v} v; repeat calls and a fresh "
          "workspace bit-identical")
    require(worst <= K3_SHAPE_REL and worst_s <= K3_SPLIT_REL,
            f"{tag} K3 error {worst}, {worst_s} from its statement")
    return worst, worst_s


def planar_shape_checks(dev):
    """Phase 9a: K1 and K3 at every shape of POLICY_SHAPES. K1 at c2's arm
    (3 links, 1024 envs x 100 steps) in eps mode against ``rollout_plain``:
    fp32 stores within K1_TIGHT_ATOL over 10 steps and K1_FULL_ATOL over
    the horizon (the maxima printed), bf16 stores the fp32 output rounded
    once and their ulps from the rounded plain output printed, TERM's
    fresh-state mode at done_dist C2_DONE_DIST (difference printed); with
    each instantiation's occupancy and spill stores (none at 3 links). K3
    on that batch's Fisher subsample (25,600 x 12) and on a c1-sized one
    (3,200 x 9, da 2) within K3_SHAPE_REL of its plain version, with its
    occupancy at both; K1's and K3's times at c2 (``k1_ms``, ``k3_ms``).
    Returns {kernel: {shape: record}}."""
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import build
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    bf16 = torch.bfloat16
    out = {"rollout": {}, "fvp": {}}
    for hidden in POLICY_SHAPES:
        key = "x".join(map(str, hidden))
        cfg = C2_REACHER3.replace(trpo=dataclasses.replace(
            C2_REACHER3.trpo, hidden=hidden))
        T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
        gen, params, s0 = k4_setup(dev, cfg, 30)
        eps = torch.randn(T, N, n, generator=gen, device=dev)
        kw = (params, s0.q, s0.qd, s0.tgt)
        k32 = rk.rollout(cfg, *kw, eps=eps)
        k16 = rk.rollout(cfg, *kw, eps=eps, store_dtype=bf16)
        p_out = rk.rollout_plain(cfg, *kw, eps)
        errs10 = [float((k[:K1_TIGHT_STEPS] - p[:K1_TIGHT_STEPS]).abs().max())
                  for k, p in zip(k32, p_out)]
        errs = [float((k - p).abs().max()) for k, p in zip(k32, p_out)]
        ulps = bf16_ulps(k16[:2], p_out[:2])
        print(f"{key} c2 K1 eps mode on {N} envs: max |kernel - plain| (obs, "
              f"act, rew) {errs10} over {K1_TIGHT_STEPS} steps (bound "
              f"{K1_TIGHT_ATOL}), {errs} over {T} steps (bound "
              f"{K1_FULL_ATOL}); bf16 stores {ulps} ulps from the rounded "
              "plain output")
        require(max(errs10) <= K1_TIGHT_ATOL and max(errs) <= K1_FULL_ATOL,
                f"{key} K1 error {errs10}, {errs}")
        require(all(torch.equal(a, b.to(bf16)) for a, b in
                    zip(k16[:2], k32[:2])) and torch.equal(k16[2], k32[2]),
                f"{key} K1 bf16 stores are not its fp32 output rounded")
        cfg_t = cfg.replace(done_dist=C2_DONE_DIST)
        fresh = arm.fresh_episodes(cfg_t, gen, N)
        kt = rk.rollout(cfg_t, *kw, eps=eps, fresh=fresh)
        pt = rk.rollout_plain(cfg_t, *kw, eps, fresh)
        term_err = max(float((k - p).abs().max()) for k, p in zip(kt, pt))
        early = int(kt[3][:-1].sum())
        print(f"{key} c2 K1-term fresh-state mode: max |kernel - plain| "
              f"{term_err} over {T} steps, {early} early dones (plain "
              f"{int(pt[3][:-1].sum())})")
        require(all(bool(torch.isfinite(x).all()) for x in kt),
                f"{key} K1-term: non-finite output")
        del k32, k16, p_out, kt, pt
        spills = spill_stores(build.lib_name("rollout", n, hidden))
        occ = {}
        for term in (False, True):
            for dt in (torch.float32, bf16):
                name = (f"{'term' if term else 'plain'}-"
                        f"{'bf16' if dt == bf16 else 'fp32'}")
                o = rk.occupancy(n, term, dt, hidden)
                print(f"{key} K1 occupancy [c2, {name}]: {o}")
                require(o["blocks_per_sm"] >= 1, f"{key} K1 {name}: {o}")
                occ[name] = brief(o)
        print(f"{key} K1 spill stores per instantiation (bytes): {spills}")
        require(len(spills) == 4 and not any(spills),
                f"{key} K1 spills at 3 links: {spills}")
        out["rollout"][key] = dict(max_abs_err=max(errs10),
                                   max_abs_err_full=max(errs), bf16_ulps=ulps,
                                   term_max_abs_err=term_err,
                                   term_early_dones=early,
                                   spill_stores=spills, occupancy=occ)
        # ---- K3 on c2's Fisher subsample of a Philox batch, and c1-sized;
        # K1's and K3's times at c2
        seed_k1 = torch.tensor(K1_SEED, dtype=torch.int64, device=dev)
        obs_ff = rk.rollout(cfg, *kw, seed=seed_k1)[0]
        obs_fvp = obs_ff[::cfg.trpo.fvp_subsample].permute(0, 2, 1) \
            .reshape(-1, cfg.obs_dim)
        rel2 = k3_wide_check(f"{key} c2", gen, params, obs_fvp,
                             cfg.trpo.cg_damping)
        ms1 = k1_ms(cfg, params, s0, seed_k1)
        ms3 = k3_ms(params, obs_fvp, cfg.trpo.cg_damping, torch.randn(
            policy.flatten(params).numel(), generator=gen, device=dev))
        print(f"{key} c2 K1 {ms1:.4f} ms/launch ({1e3 * ms1 / T:.3f} us a "
              f"step), K3 {ms3:.4f} ms/launch")
        out["rollout"][key].update(ms=ms1, us_per_step=1e3 * ms1 / T)
        params1 = policy.init_params(gen, 9, 2, hidden,
                                     cfg.trpo.logstd_init)
        obs1 = torch.randn(3200, 9, generator=gen, device=dev)
        rel1 = k3_wide_check(f"{key} c1-sized", gen, params1, obs1,
                             cfg.trpo.cg_damping)
        occ3 = {}
        for tag, do, da in (("c2", 12, 3), ("c1", 9, 2)):
            o = fk.occupancy(do, da, hidden)
            print(f"{key} K3 occupancy [{tag}, do {do}, da {da}]: {o}")
            require(o["blocks_per_sm"] >= 1, f"{key} K3 does not fit an SM")
            occ3[tag] = brief(o) | {"tile": o["tile"]}
        out["fvp"][key] = dict(rel_l2=rel2, rel_l2_c1=rel1, ms=ms3,
                               occupancy=occ3)
        del obs_ff, obs_fvp
    return out


def c2_shape_phases(dev, cfg, seed):
    """Phase 9b and 10b: a c2 path at another policy shape
    (``c2_baselines32``, ``c2_deep3``, ``c2_rllab``): the Philox batch's
    SHA-256 at K1_SEED; five full-width training iterations (K1, K2 once
    and K3 ten times per update, no K5 or K6, no plain version); K1 and K3
    times beside their bounds, their launches and their plain versions'
    times. Returns {kernel: record}."""
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    from trpo_robot_control_tpu_torch.trpo.train import train
    tag = cfg.name
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    do, da, hidden = cfg.obs_dim, n, cfg.trpo.hidden
    params, s0, seed_k1 = k1_setup(dev, cfg, seed)
    P = policy.flatten(params).numel()
    digest = k1_digest(cfg, params, s0, seed_k1)
    print(f"{tag} K1 Philox batch (seed {K1_SEED}) SHA-256 {digest}")

    # ---- five full-width iterations through the trainer
    n_iters = 5
    launches, ms_upd = train_checked(
        cfg, n_iters, kernels,
        {"rollout": n_iters, "moments": n_iters,
         "fvp": n_iters * cfg.trpo.cg_iters, "rollout3d": 0, "pg": 0,
         "fvp_ff": 0}, train)

    # ---- K1 and K3 beside their bounds and plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 100)
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    t_k1 = k1_ms(cfg, params, s0, seed_k1)
    t_k1p = cuda_ms(lambda: rk.rollout_plain(cfg, params, s0.q, s0.qd,
                                             s0.tgt, eps), 2, warmup=1)
    b1, by1 = k1_bound(cfg, P)
    obs_ff = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, seed=seed_k1)[0]
    obs_fvp = obs_ff[::cfg.trpo.fvp_subsample].permute(0, 2, 1) \
        .reshape(-1, do)
    B_sub = obs_fvp.shape[0]
    v = torch.randn(P, generator=gen, device=dev)
    t_k3 = k3_ms(params, obs_fvp, cfg.trpo.cg_damping, v)
    hs = fk.activations(params, obs_fvp)
    scale = torch.exp(-2.0 * params["logstd"]) / B_sub
    t_k3p = cuda_ms(lambda: fk.gn_fvp_plain(params, obs_fvp, hs, scale, v,
                                            cfg.trpo.cg_damping), 20)
    b3, b3fma = k3_bound(B_sub, do, da, P, hidden)
    print(f"{tag} rollout: {t_k1:.4f} ms/launch, {1e3 * t_k1 / T:.3f} us per "
          f"step (bound {b1:.4f} ms by {by1}), plain {t_k1p:.3f} ms, "
          f"{launches['rollout'] // n_iters} launch(es)/update")
    print(f"{tag} fvp: {t_k3:.4f} ms/launch (tensor-core bound {b3[0]:.4f} "
          f"ms by {b3[1]}, {100 * b3[0] / t_k3:.1f} % of it reached; "
          f"fp32-FMA {b3fma[0]:.4f}), plain {t_k3p:.3f} ms, "
          f"{launches['fvp'] // n_iters} launch(es)/update")
    return {"rollout": dict(
                launches=launches["rollout"], max_abs_err=None, ms=t_k1,
                plain_ms=t_k1p, bound_ms=b1, bound_by=by1, library_ms=None,
                us_per_step=1e3 * t_k1 / T, philox_sha256=digest,
                ms_per_update=ms_upd, hidden=list(hidden)),
            "fvp": dict(
                launches=launches["fvp"], ms=t_k3, plain_ms=t_k3p,
                bound_ms=b3[0], bound_by=b3[1], bound_fp32_fma_ms=b3fma[0],
                bound_share=b3[0] / t_k3, library_ms=None,
                hidden=list(hidden))}


# Phase 10: the unpacked policy forms, widths 65-128 (the TPU kernels'
# `_policy_ff` and `_fvp_kernel`): one unit past the packed limit, JAX's
# own unpacked test shape (tests/test_pallas_fvp.py), rllab's policy
# (Duan et al. 2016; the GAE paper's 3-D robot policy) and the top of the
# range, the layouts' worst case
WIDE_SHAPES = ((65,), (96, 96), (100, 50, 25), (128, 128, 128))
RLLAB = (100, 50, 25)
# K4-term's fresh-state check at RLLAB: the done distance of the card
# test of K4's TERM instantiations (tests/test_torch_cuda.py), at which
# the checked envs of c3's batch finish early (at C5_DONE_DIST few do)
K4_WIDE_DONE_DIST = 0.4


def c3_rllab():
    """c3 with rllab's policy: three tanh hidden layers of 100, 50 and 25
    units (Duan et al. 2016, "Benchmarking Deep Reinforcement Learning for
    Continuous Control"; Schulman et al. 2016's 3-D robot policy)."""
    from trpo_robot_control_tpu_torch.configs import C3_FRANKA7
    return C3_FRANKA7.replace(name="c3_rllab", trpo=dataclasses.replace(
        C3_FRANKA7.trpo, hidden=RLLAB))


def c2_rllab():
    """c2 with rllab's (100, 50, 25) policy (``c3_rllab``)."""
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    return C2_REACHER3.replace(name="c2_rllab", trpo=dataclasses.replace(
        C2_REACHER3.trpo, hidden=RLLAB))


def phase10_libs():
    """The libraries phase 10 runs beyond the default ones: K1 at 3 links,
    K4 at 7 joints and K3, at every shape of WIDE_SHAPES."""
    from trpo_robot_control_tpu_torch.ops.cuda import build
    return [build.lib_name(src, {"rollout": 3, "rollout3d": 7}.get(src),
                           hidden)
            for hidden in WIDE_SHAPES
            for src in ("rollout", "rollout3d", "fvp")]


def step0_fmaf_err(params, obs0, act0, eps0):
    """max |act0 - the step-0 actions in the rollout kernels' fmaf order|:
    obs0 (do, n), act0 (da, n), eps0 (n, da); the policy mean from
    ``mean_fmaf`` (``tests/test_torch_helpers.py``)."""
    L = sum(1 for k in params if k.startswith("W"))
    mu = port_test_helpers().mean_fmaf(params, obs0)
    want = (mu + params[f"b{L - 1}"][:, None]) \
        + torch.exp(params["logstd"])[:, None] * eps0.T
    return float((act0 - want).abs().max())


def first_differing_step(k_act, p_act):
    """The first step whose actions differ (T: none)."""
    diff = (k_act - p_act).abs().amax(dim=(1, 2))
    return int(torch.nonzero(diff).min()) if bool((diff > 0).any()) \
        else k_act.shape[0]


def k4_wide_check(key, tag, cfg, params, s0, eps):
    """K4 at a wide shape against its plain version on every SHAPE_STRIDE-th
    env (``policy_shape_checks``' rule). Where the two differ, the step-0
    actions show whose sum order parts: the kernel's must equal those of
    ``mean_fmaf`` (``tests/test_torch_helpers.py``: the MLP in the fmaf
    order), and the output is then held to phase 3's bounds
    (K4_TIGHT_ATOL over K4_TIGHT_STEPS, K4_FULL_ATOL over the horizon, bf16
    within 1 ulp of the rounded plain output over K4_TIGHT_STEPS). Returns
    its record."""
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    bf16 = torch.bfloat16
    T, N = cfg.horizon, cfg.n_envs
    k32 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task, eps=eps)
    k16 = r3.rollout3d(cfg, params, s0.q, s0.qd, s0.tgt, s0.task, eps=eps,
                       store_dtype=bf16)
    require(all(torch.equal(a, b.to(bf16)) for a, b in zip(k16[:2], k32[:2]))
            and torch.equal(k16[2], k32[2]),
            f"{key} {tag} K4 bf16 stores are not its fp32 output rounded")
    S = SHAPE_STRIDE
    st = arm.EnvState(*(x[::S] for x in s0))
    k32 = tuple(x[..., ::S] for x in k32)
    k16 = tuple(x[..., ::S] for x in k16[:2])
    p_out = r3.rollout3d_plain(cfg, params, st.q, st.qd, st.tgt, st.task,
                               eps[:, ::S])
    errs = [float((k - p).abs().max()) for k, p in zip(k32, p_out)]
    ulps = bf16_ulps(k16, p_out[:2])
    rec = dict(max_abs_err=max(errs), bf16_ulps=ulps, plain_envs=st.q.shape[0])
    if max(errs) == 0.0:
        print(f"{key} {tag} K4 eps mode on {N} envs x {T} steps, plain on "
              f"every {S}-th: max |kernel - plain| (obs, act, rew) {errs} "
              f"with fp32 stores, {ulps} bf16 ulps with bf16 stores (exact)")
        require(ulps == 0.0, f"{key} {tag} K4 bf16 {ulps} ulps")
        return rec
    # where the orders part: the first step whose actions differ, and at
    # step 0 the kernel's and the plain version's actions against the fmaf
    # order's
    first = first_differing_step(k32[1], p_out[1])
    k_vs_f = step0_fmaf_err(params, k32[0][0], k32[1][0], eps[0, ::S])
    p_vs_f = step0_fmaf_err(params, k32[0][0], p_out[1][0], eps[0, ::S])
    W = K4_TIGHT_STEPS
    errs_w = [float((k[:W] - p[:W]).abs().max()) for k, p in zip(k32, p_out)]
    ulps_w = bf16_ulps([x[:W] for x in k16], [x[:W] for x in p_out[:2]])
    print(f"{key} {tag} K4 eps mode on {N} envs x {T} steps, plain on every "
          f"{S}-th: max |kernel - plain| (obs, act, rew) {errs_w} over {W} "
          f"steps (bound {K4_TIGHT_ATOL}), {errs} over {T} (bound "
          f"{K4_FULL_ATOL}); actions first differ at step {first}; step 0: "
          f"kernel - fmaf-order statement {k_vs_f}, plain - statement "
          f"{p_vs_f} (the plain version's matrix product sums in another "
          f"order); bf16 stores {ulps_w} ulps over {W} steps (bound 1), "
          f"{ulps} over {T}")
    require(k_vs_f == 0.0, f"{key} {tag} K4 step 0 is not the fmaf order")
    require(max(errs_w) <= K4_TIGHT_ATOL and max(errs) <= K4_FULL_ATOL
            and ulps_w <= 1.0, f"{key} {tag} K4 error {errs_w}, {errs}, "
            f"{ulps_w} ulps")
    rec.update(max_abs_err_tight=max(errs_w), first_differing_step=first,
               step0_kernel_vs_fmaf=k_vs_f, step0_plain_vs_fmaf=p_vs_f)
    return rec


def wide_shape_checks(dev):
    """Phase 10a: K1, K4 and K3 at every shape of WIDE_SHAPES. K1 at c2's
    arm (1024 envs x 100 steps) in eps mode against ``rollout_plain``
    (fp32 stores within K1_TIGHT_ATOL over 10 steps and K1_FULL_ATOL over
    the horizon, bf16 stores its fp32 output rounded, their ulps from the
    rounded plain output and TERM's fresh-state difference printed, no
    spill store); K4 at c3's arm (4096 envs x 200 steps; its time beside
    its bound) and at c5's 27-wide observation, fp32 and bf16 stores, on
    every SHAPE_STRIDE-th env (``k4_wide_check``), and at RLLAB also TERM
    in fresh-state mode at done_dist K4_WIDE_DONE_DIST (0.0); K3 on c2's
    Fisher subsample (25,600 x 12), a c1-sized one (3,200 x 9, da 2) and
    c3's fp32 relayout (102,400 x 24, da 7) within K3_SHAPE_REL of its
    plain version and K3_SPLIT_REL of its statement (``k3_wide_check``),
    repeat calls and a fresh workspace bit-identical, every launch of its
    wide form resident with no spill store (do 32, da 8 too); each
    kernel's occupancy, K1's and K3's times at
    c2 beside their bounds and plain versions (K1 and K4 at 8 joints and
    the widest shape: ``tests/test_torch_cuda.py``'s spill check).
    Returns {kernel: {shape: record}}."""
    from trpo_robot_control_tpu_torch.configs import (C2_REACHER3,
                                                      C3_FRANKA7,
                                                      C5_MULTITASK)
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import build
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    bf16 = torch.bfloat16
    out = {"rollout": {}, "rollout3d": {}, "fvp": {}}
    widen = lambda base, hidden, **kw: base.replace(
        trpo=dataclasses.replace(base.trpo, hidden=hidden), **kw)
    for hidden in WIDE_SHAPES:
        key = "x".join(map(str, hidden))
        # ---- K1 at c2's arm
        cfg = widen(C2_REACHER3, hidden)
        T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
        gen, params, s0 = k4_setup(dev, cfg, 40)
        eps = torch.randn(T, N, n, generator=gen, device=dev)
        kw = (params, s0.q, s0.qd, s0.tgt)
        P = policy.flatten(params).numel()
        k32 = rk.rollout(cfg, *kw, eps=eps)
        k16 = rk.rollout(cfg, *kw, eps=eps, store_dtype=bf16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_out = rk.rollout_plain(cfg, *kw, eps)
        torch.cuda.synchronize()
        t_k1p = 1e3 * (time.perf_counter() - t0)
        errs10 = [float((k[:K1_TIGHT_STEPS] - p[:K1_TIGHT_STEPS]).abs().max())
                  for k, p in zip(k32, p_out)]
        errs = [float((k - p).abs().max()) for k, p in zip(k32, p_out)]
        ulps = bf16_ulps(k16[:2], p_out[:2])
        print(f"{key} c2 K1 eps mode on {N} envs: max |kernel - plain| (obs, "
              f"act, rew) {errs10} over {K1_TIGHT_STEPS} steps (bound "
              f"{K1_TIGHT_ATOL}), {errs} over {T} steps (bound "
              f"{K1_FULL_ATOL}); bf16 stores {ulps} ulps from the rounded "
              "plain output")
        require(max(errs10) <= K1_TIGHT_ATOL and max(errs) <= K1_FULL_ATOL,
                f"{key} K1 error {errs10}, {errs}")
        require(all(torch.equal(a, b.to(bf16)) for a, b in
                    zip(k16[:2], k32[:2])) and torch.equal(k16[2], k32[2]),
                f"{key} K1 bf16 stores are not its fp32 output rounded")
        if max(errs) > 0.0:
            # where the orders part (``k4_wide_check``)
            k_vs_f = step0_fmaf_err(params, k32[0][0], k32[1][0], eps[0])
            p_vs_f = step0_fmaf_err(params, k32[0][0], p_out[1][0], eps[0])
            print(f"{key} c2 K1 actions first differ at step "
                  f"{first_differing_step(k32[1], p_out[1])}; step 0: "
                  f"kernel - fmaf-order statement {k_vs_f}, plain - "
                  f"statement {p_vs_f}")
            require(k_vs_f == 0.0, f"{key} K1 step 0 is not the fmaf order")
        cfg_t = cfg.replace(done_dist=C2_DONE_DIST)
        fresh = arm.fresh_episodes(cfg_t, gen, N)
        kt = rk.rollout(cfg_t, *kw, eps=eps, fresh=fresh)
        pt = rk.rollout_plain(cfg_t, *kw, eps, fresh)
        term_err = max(float((k - p).abs().max()) for k, p in zip(kt, pt))
        early = int(kt[3][:-1].sum())
        print(f"{key} c2 K1-term fresh-state mode: max |kernel - plain| "
              f"{term_err} over {T} steps, {early} early dones (plain "
              f"{int(pt[3][:-1].sum())})")
        require(all(bool(torch.isfinite(x).all()) for x in kt),
                f"{key} K1-term: non-finite output")
        del k32, k16, p_out, kt, pt
        spills = spill_stores(build.lib_name("rollout", n, hidden))
        o = rk.occupancy(n, False, hidden=hidden)
        print(f"{key} K1 occupancy [c2]: {o}; spill stores per "
              f"instantiation (bytes) {spills}")
        require(len(spills) == 4 and not any(spills),
                f"{key} K1 spills at 3 links: {spills}")
        seed_k1 = torch.tensor(K1_SEED, dtype=torch.int64, device=dev)
        ms1 = k1_ms(cfg, params, s0, seed_k1)
        b1, by1 = k1_bound(cfg, P)
        out["rollout"][key] = dict(
            max_abs_err=max(errs10), max_abs_err_full=max(errs),
            bf16_ulps=ulps, term_max_abs_err=term_err, term_early_dones=early,
            spill_stores=spills, occupancy=brief(o) | {
                "smem_dynamic": o["smem_dynamic"]},
            ms=ms1, us_per_step=1e3 * ms1 / T, plain_ms=t_k1p, bound_ms=b1,
            bound_by=by1)
        # ---- K3 on c2's Fisher subsample of a Philox batch, c1-sized, and
        # (below) c3's relayout
        obs_ff = rk.rollout(cfg, *kw, seed=seed_k1)[0]
        obs_fvp = obs_ff[::cfg.trpo.fvp_subsample].permute(0, 2, 1) \
            .reshape(-1, cfg.obs_dim)
        rel2 = k3_wide_check(f"{key} c2", gen, params, obs_fvp,
                             cfg.trpo.cg_damping)
        v = torch.randn(P, generator=gen, device=dev)
        ms3 = k3_ms(params, obs_fvp, cfg.trpo.cg_damping, v)
        B3 = obs_fvp.shape[0]
        hs = fk.activations(params, obs_fvp)
        scale = torch.exp(-2.0 * params["logstd"]) / B3
        ms3p = cuda_ms(lambda: fk.gn_fvp_plain(params, obs_fvp, hs, scale, v,
                                               cfg.trpo.cg_damping), 10)
        launch2 = k3_launch_ms(params, obs_fvp, cfg.trpo.cg_damping, v)
        print(f"{key} c2 K3's launches (ms a call): " + ", ".join(
            f"{k} {t:.4f}" for k, t in sorted(launch2.items(),
                                              key=lambda x: -x[1])))
        b3, b3fma = k3_bound(B3, cfg.obs_dim, n, P, hidden)
        print(f"{key} c2 K1 {ms1:.4f} ms/launch ({1e3 * ms1 / T:.3f} us a "
              f"step; bound {b1:.4f} ms by {by1}, plain {t_k1p:.1f} ms), K3 "
              f"{ms3:.4f} ms/launch (tensor-core bound {b3[0]:.4f} ms by "
              f"{b3[1]}, fp32-FMA {b3fma[0]:.4f}; plain {ms3p:.4f} ms)")
        del hs
        params1 = policy.init_params(gen, 9, 2, hidden,
                                     cfg.trpo.logstd_init)
        obs1 = torch.randn(3200, 9, generator=gen, device=dev)
        rel1 = k3_wide_check(f"{key} c1-sized", gen, params1, obs1,
                             cfg.trpo.cg_damping)
        del obs_ff, obs_fvp
        # ---- K4 at c3's and c5's observation; K3 on c3's relayout
        r4 = {}
        for tag, base in (("c3", C3_FRANKA7), ("c5", C5_MULTITASK)):
            cfg3 = widen(base, hidden, n_envs=SHAPE_ENVS)
            T3, N3, n3 = cfg3.horizon, cfg3.n_envs, cfg3.arm.n_joints
            gen3, params3, s3 = k4_setup(dev, cfg3, 41)
            eps3 = torch.randn(T3, N3, n3, generator=gen3, device=dev)
            r4[tag] = k4_wide_check(key, tag, cfg3, params3, s3, eps3)
            o4 = r3.occupancy(cfg3, bf16, hidden=hidden)
            print(f"{key} {tag} K4 occupancy [bf16]: {o4}")
            require(o4["blocks_per_sm"] >= 1, f"{key} K4 does not fit an SM")
            r4[tag]["occupancy"] = brief(o4) | {
                "smem_dynamic": o4["smem_dynamic"]}
            if tag == "c3":
                t4 = k4_ms(cfg3, params3, s3)
                b4, b4f, _, _ = k4_bound(r3, cfg3, params3, s3,
                                         k4_flops_per_env_step(
                                             r3, cfg3, params3, s3, eps3,
                                             s3.task))
                print(f"{key} c3 K4 {t4:.4f} ms/launch (bound {b4[0]:.4f} ms "
                      f"by {b4[1]}, fused sweep {b4f[0]:.4f})")
                r4[tag].update(ms=t4, bound_ms=b4[0], bound_by=b4[1],
                               bound_fused_ms=b4f[0])
                obs3 = r3.rollout3d(cfg3, params3, s3.q, s3.qd, s3.tgt,
                                    s3.task, eps=eps3)[0]
                k_sub = cfg3.trpo.fvp_subsample
                obs_fvp3 = obs3[::k_sub].permute(0, 2, 1) \
                    .reshape(-1, cfg3.obs_dim)
                rel3 = k3_wide_check(f"{key} c3 (fp32 relayout)", gen3,
                                     params3, obs_fvp3,
                                     cfg3.trpo.cg_damping)
                v3 = torch.randn(policy.flatten(params3).numel(),
                                 generator=gen3, device=dev)
                ms3c3 = k3_ms(params3, obs_fvp3, cfg3.trpo.cg_damping, v3)
                launch3 = k3_launch_ms(params3, obs_fvp3,
                                       cfg3.trpo.cg_damping, v3)
                print(f"{key} c3 (fp32 relayout) K3 {ms3c3:.4f} ms a call; "
                      "its launches (ms a call): "
                      + ", ".join(f"{k} {t:.4f}" for k, t in
                                  sorted(launch3.items(),
                                         key=lambda x: -x[1])))
                del obs3, obs_fvp3
            if tag == "c3" and hidden == RLLAB:
                cfg_t = cfg3.replace(done_dist=K4_WIDE_DONE_DIST)
                fresh = arm.fresh_episodes(cfg_t, gen3, N3)
                S = SHAPE_STRIDE
                kt = tuple(x[..., ::S] for x in r3.rollout3d(
                    cfg_t, params3, s3.q, s3.qd, s3.tgt, s3.task, eps=eps3,
                    fresh=fresh))
                st = arm.EnvState(*(x[::S] for x in s3))
                pt = r3.rollout3d_plain(
                    cfg_t, params3, st.q, st.qd, st.tgt, st.task,
                    eps3[:, ::S], arm.EnvState(*(x[:, ::S] for x in fresh)))
                err_t, early_t = check_fresh_state_mode(
                    f"{key} c3 K4-term (done_dist {K4_WIDE_DONE_DIST})", kt,
                    pt)
                r4[tag].update(term_max_abs_err=err_t,
                               term_early_dones=early_t)
                del kt, pt
        out["rollout3d"][key] = r4
        # K3's launches: each resident, none with local (spill) memory, at
        # c2's, c1's and c3's widths and the widest instantiation (do 32,
        # da 8); the library's spill stores from its -Xptxas -v report
        occ3 = {}
        for tag, do, da in (("c2", 12, 3), ("c1", 9, 2), ("c3", 24, 7),
                            ("do32_da8", 32, 8)):
            o3 = fk.occupancy(do, da, hidden)
            for name, ok in o3["kernels"].items():
                print(f"{key} K3 occupancy [{tag}, do {do}, da {da}] {name}: "
                      f"{ok}")
                require(ok["blocks_per_sm"] >= 1 and ok["local_bytes"] == 0,
                        f"{key} K3 {name} does not fit an SM or spills: {ok}")
            occ3[tag] = {name: brief(ok) | {"tile": ok["tile"],
                                            "smem_dynamic": ok["smem_dynamic"]}
                         for name, ok in o3["kernels"].items()}
        spills3 = spill_stores(build.lib_name("fvp", None, hidden))
        print(f"{key} K3 spill stores per kernel (bytes): {spills3}")
        require(spills3 and not any(spills3), f"{key} K3 spills: {spills3}")
        out["fvp"][key] = dict(rel_l2=rel2[0], rel_l2_split=rel2[1],
                               rel_l2_c1=rel1[0], rel_l2_split_c1=rel1[1],
                               rel_l2_c3=rel3[0], rel_l2_split_c3=rel3[1],
                               ms=ms3, plain_ms=ms3p, bound_ms=b3[0],
                               bound_by=b3[1], bound_fp32_fma_ms=b3fma[0],
                               occupancy=occ3, spill_stores=spills3,
                               launches_ms=launch2, ms_c3=ms3c3,
                               launches_ms_c3=launch3)
    return out


def k1_exact(tag, k_out, p_out, k16=None):
    """K1 against its plain version on the same inputs: max |kernel -
    plain| = 0.0 (identical done flags where there are any) and, given the
    bf16 stores' batch, obs and actions 0 ulps from the rounded plain
    output with rewards and done flags unchanged. Returns the max error."""
    errs = [float((k - p).abs().max()) for k, p in zip(k_out, p_out)]
    ulps = None if k16 is None else bf16_ulps(k16[:2], p_out[:2])
    print(f"{tag}: max |kernel - plain| (obs, act, rew[, dones]) {errs} "
          f"over {p_out[0].shape[0]} steps (bound 0.0)"
          + ("" if k16 is None else f"; bf16 stores {ulps} ulps from the "
             "rounded plain output (bound 0)"))
    require(max(errs) == 0.0, f"{tag}: kernel differs from plain: {errs}")
    if k16 is not None:
        require(ulps == 0.0 and all(torch.equal(a, b) for a, b in
                                    zip(k16[2:], k_out[2:])),
                f"{tag}: bf16 stores {ulps} ulps, or other outputs moved")
    return max(errs)


def c2_bf16_phases(dev):
    """c2 with bf16 storage (``c2_bf16``): K1's bf16 stores 0 ulps from the
    rounded plain output in eps mode and, TERM, in fresh-state mode; the
    Philox batch's SHA-256; K2-bf16 at do 12 and K3 on the fp32 relayout
    against their plain versions; five full-width training iterations
    (K1, K2 once and K3 ten times per update, no plain version); K1-bf16's
    time beside its bound. Returns {kernel: record}."""
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    from trpo_robot_control_tpu_torch.ops.gae import gae
    from trpo_robot_control_tpu_torch.trpo.train import train
    cfg = c2_bf16()
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    bf16 = torch.bfloat16
    gen, params, s0 = k4_setup(dev, cfg, 20)
    P = policy.flatten(params).numel()
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    k32 = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, eps=eps)
    k16 = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt, eps=eps,
                     store_dtype=bf16)
    p_out = rk.rollout_plain(cfg, params, s0.q, s0.qd, s0.tgt, eps)
    err = k1_exact("c2-bf16 K1 eps mode", k32, p_out, k16)
    cfg_t = cfg.replace(done_dist=C2_DONE_DIST)
    fresh = arm.fresh_episodes(cfg_t, gen, N)
    kt32 = rk.rollout(cfg_t, params, s0.q, s0.qd, s0.tgt, eps=eps,
                      fresh=fresh)
    kt16 = rk.rollout(cfg_t, params, s0.q, s0.qd, s0.tgt, eps=eps,
                      fresh=fresh, store_dtype=bf16)
    pt = rk.rollout_plain(cfg_t, params, s0.q, s0.qd, s0.tgt, eps, fresh)
    check_fresh_state_mode("c2-bf16 K1-term", kt32, pt)
    k1_exact("c2-bf16 K1-term fresh-state mode", kt32, pt, kt16)
    del k32, k16, p_out, kt32, kt16, pt
    seed = torch.tensor(K1_SEED, dtype=torch.int64, device=dev)
    digest = k1_digest(cfg, params, s0, seed, bf16)
    print(f"c2-bf16 K1 Philox batch (seed {K1_SEED}, bf16 stores) SHA-256 "
          f"{digest}")
    obs_ff, act_ff, rew_ff = rk.rollout(cfg, params, s0.q, s0.qd, s0.tgt,
                                        seed=seed, store_dtype=bf16)
    require(obs_ff.dtype == bf16 and act_ff.dtype == bf16
            and rew_ff.dtype == torch.float32, "c2-bf16 K1 store types")
    rec = {"rollout": dict(max_abs_err=err, philox_sha256=digest)}

    # ---- K2 bf16 mode (do 12) and K3 on the fp32 relayout
    targets = gae(rew_ff, torch.zeros_like(rew_ff), cfg.trpo.gamma,
                  cfg.trpo.lam, time_axis=0)
    gram_k, gram_p, tau = k2_check("c2-bf16", obs_ff, targets, cfg.horizon)
    from trpo_robot_control_tpu_torch.ops.cuda import moments_kernel as mk
    require(torch.equal(gram_k, mk.extended_gram(obs_ff, targets, tau)),
            "c2-bf16 K2 bf16 mode is not deterministic")
    rec["moments"] = dict(max_abs_err=float((gram_k - gram_p).abs().max()))
    k = cfg.trpo.fvp_subsample
    obs_fvp = obs_ff[::k].permute(0, 2, 1).reshape(-1, cfg.obs_dim).float()
    rec["fvp"] = k3_check("c2-bf16", gen, params, obs_fvp,
                          cfg.trpo.cg_damping)[0]

    # ---- five full-width iterations through the trainer
    n_iters = 5
    launches, ms_upd = train_checked(
        cfg, n_iters, kernels,
        {"rollout": n_iters, "moments": n_iters,
         "fvp": n_iters * cfg.trpo.cg_iters, "rollout3d": 0, "pg": 0,
         "fvp_ff": 0}, train)

    # ---- K1-bf16's time beside its bound and the fp32 stores' time
    t_k = k1_ms(cfg, params, s0, seed, bf16)
    t_32 = k1_ms(cfg, params, s0, seed)
    t_p = cuda_ms(lambda: rk.rollout_plain(cfg, params, s0.q, s0.qd, s0.tgt,
                                           eps), 2, warmup=1)
    bms, by = k1_bound(cfg, P, bf16)
    print(f"c2-bf16 rollout: {t_k:.4f} ms/launch, {1e3 * t_k / T:.3f} us per "
          f"step (bound {bms:.4f} ms by {by}); fp32 stores {t_32:.4f} ms; "
          f"plain {t_p:.3f} ms, {launches['rollout'] // n_iters} "
          "launch(es)/update")
    rec["rollout"].update(launches=launches["rollout"], ms=t_k, plain_ms=t_p,
                          bound_ms=bms, bound_by=by, library_ms=None,
                          us_per_step=1e3 * t_k / T, fp32_stores_ms=t_32,
                          ms_per_update=ms_upd)
    rec["moments"]["launches"] = launches["moments"]
    rec["fvp"]["launches"] = launches["fvp"]
    return rec


def brief(occ):
    """An occupancy's blocks and warps per SM, registers and local bytes."""
    return {k: occ[k] for k in ("blocks_per_sm", "warps_per_sm", "registers",
                                "local_bytes")}


def median_distance(obs, n):
    """The median over envs of |target - ee| at step 1 of a batch's obs
    (T, do, N) of an n-joint arm (rows 3n .. 3n + 2)."""
    return float(torch.linalg.norm(obs[1, 3 * n:3 * n + 3].float(),
                                   dim=0).median())


def nj_arms(n):
    """The arms phase 7 runs at ``n`` joints: ``planar_arm(n)`` and a
    spatial arm with gravity, the first n of ``franka_like_arm``'s joints
    1-6 (joint 1 at joint 0's origin) followed by its joints 1 and 2
    again, with its links 1-6, 0 and 1."""
    from trpo_robot_control_tpu_torch.configs import (franka_like_arm,
                                                      planar_arm)
    fr = franka_like_arm()
    first = dataclasses.replace(fr.joints[1], pos=fr.joints[0].pos)
    joints = ((first,) + fr.joints[2:] + fr.joints[1:3])[:n]
    links = (fr.links[1:] + fr.links[:2])[:n]
    return planar_arm(n), dataclasses.replace(fr, joints=joints, links=links)


def other_n_phases(dev):
    """Phase 7: every joint count of K1 (planar arms; fp32 and bf16 stores,
    terminating or not) and of K4 (each of the six (task families,
    obstacle) pairs: the planar arm with the obstacle off, the spatial arm
    with it on; fp32 and bf16 stores, terminating or not), each launched in
    eps mode (TERM in fresh-state mode, done_dist the median distance to
    the target at step 1, so that about half the envs are done early) on
    OTHER_N_ENVS envs x OTHER_N_STEPS steps and held to its plain version:
    0.0 with fp32 stores, 0 ulps from the rounded plain output with bf16;
    with each instantiation's occupancy. Returns {"rollout": {n: record},
    "rollout3d": {n: {pair: record}}}."""
    from trpo_robot_control_tpu_torch.configs import (C2_REACHER3,
                                                      C4_FRANKA7_OBSTACLE,
                                                      C5_MULTITASK)
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.ops.cuda import build
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    N, T = OTHER_N_ENVS, OTHER_N_STEPS
    bf16 = torch.bfloat16
    spills = k1_spills()
    out = {"rollout": {}, "rollout3d": {}}
    for n in build.JOINT_COUNTS:
        planar, spatial = nj_arms(n)
        # ---- K1
        cfg = C2_REACHER3.replace(arm=planar, n_envs=N, horizon=T)
        gen, params, s0 = k4_setup(dev, cfg, 100 + n)
        eps = torch.randn(T, N, n, generator=gen, device=dev)
        kw = (params, s0.q, s0.qd, s0.tgt)
        k_out = rk.rollout(cfg, *kw, eps=eps)
        err = k1_exact(f"n={n} K1", k_out, rk.rollout_plain(cfg, *kw, eps),
                       rk.rollout(cfg, *kw, eps=eps, store_dtype=bf16))
        cfg_t = cfg.replace(done_dist=median_distance(k_out[0], n))
        fresh = arm.fresh_episodes(cfg_t, gen, N)
        kt = rk.rollout(cfg_t, *kw, eps=eps, fresh=fresh)
        pt = rk.rollout_plain(cfg_t, *kw, eps, fresh)
        _, early = check_fresh_state_mode(f"n={n} K1-term", kt, pt)
        k1_exact(f"n={n} K1-term", kt, pt,
                 rk.rollout(cfg_t, *kw, eps=eps, fresh=fresh,
                            store_dtype=bf16))
        occ = {}
        for term in (False, True):
            for dt in (torch.float32, bf16):
                name = (f"{'term' if term else 'plain'}-"
                        f"{'bf16' if dt == bf16 else 'fp32'}")
                o = rk.occupancy(n, term, dt)
                print(f"K1 occupancy [n={n}, {name}]: {o}")
                require(o["blocks_per_sm"] >= 1, f"K1 n={n} {name}: {o}")
                occ[name] = brief(o)
        out["rollout"][n] = dict(max_abs_err=err, term_early_dones=early,
                                 spill_stores=spills[n], occupancy=occ)
        # ---- K4, each pair
        out["rollout3d"][n] = {}
        for n_tasks in r3.TASK_FAMILIES:
            for obstacle in (False, True):
                pair = f"tasks{n_tasks}-{'obstacle' if obstacle else 'free'}"
                a = spatial if obstacle else planar
                cost = (C4_FRANKA7_OBSTACLE.cost if obstacle
                        else C5_MULTITASK.cost)
                if obstacle:     # beside the base column, active from step 0
                    cost = dataclasses.replace(cost,
                                               obstacle_center=(0.0, 0.0, 0.3))
                cfg = C5_MULTITASK.replace(arm=a, cost=cost, n_tasks=n_tasks,
                                           n_envs=N, horizon=T)
                gen, params, s0 = k4_setup(dev, cfg, 200 + 10 * n + n_tasks)
                eps = torch.randn(T, N, n, generator=gen, device=dev)
                kw = (params, s0.q, s0.qd, s0.tgt, s0.task)
                tag = f"n={n} K4 {pair}"
                k_out = r3.rollout3d(cfg, *kw, eps=eps)
                err = k1_exact(tag, k_out, r3.rollout3d_plain(cfg, *kw, eps),
                               r3.rollout3d(cfg, *kw, eps=eps,
                                            store_dtype=bf16))
                cfg_t = cfg.replace(done_dist=median_distance(k_out[0], n))
                fresh = arm.fresh_episodes(cfg_t, gen, N)
                kt = r3.rollout3d(cfg_t, *kw, eps=eps, fresh=fresh)
                pt = r3.rollout3d_plain(cfg_t, *kw, eps, fresh)
                _, early = check_fresh_state_mode(f"{tag}-term", kt, pt)
                k1_exact(f"{tag}-term", kt, pt,
                         r3.rollout3d(cfg_t, *kw, eps=eps, fresh=fresh,
                                      store_dtype=bf16))
                occ = {}
                for c_, term in ((cfg, "plain"), (cfg_t, "term")):
                    for dt in (torch.float32, bf16):
                        name = f"{term}-{'bf16' if dt == bf16 else 'fp32'}"
                        occ[name] = brief(k4_occupancy_of(
                            f"n={n} {pair} {name}", c_, dt))
                out["rollout3d"][n][pair] = dict(
                    max_abs_err=err, term_early_dones=early, occupancy=occ)
    return out


def k1_n8_record(dev):
    """K1 at 8 links at c2's width and depth (1024 envs x 100 steps),
    Philox mode: its time beside its bound and its plain version's."""
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    cfg = C2_REACHER3.replace(arm=nj_arms(8)[0])
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    gen, params, s0 = k4_setup(dev, cfg, 8)
    seed = torch.tensor(K1_SEED, dtype=torch.int64, device=dev)
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    ms = k1_ms(cfg, params, s0, seed)
    plain_ms = cuda_ms(lambda: rk.rollout_plain(cfg, params, s0.q, s0.qd,
                                                s0.tgt, eps), 1, warmup=1)
    bms, by = k1_bound(cfg, policy.flatten(params).numel())
    print(f"n=8 rollout at c2's width: {ms:.4f} ms/launch, "
          f"{1e3 * ms / T:.3f} us per step (bound {bms:.4f} ms by {by}), "
          f"plain {plain_ms:.3f} ms")
    return dict(ms=ms, us_per_step=1e3 * ms / T, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None, n_envs=N,
                horizon=T)


# Phase 11: the MLP value baseline, which sends the update down the
# batch-major branch (as in JAX): the configs' own baseline_hidden (64,),
# baseline_lr and baseline_epochs, nothing cut
def mlp_config(cfg):
    """``cfg`` with the MLP value baseline, named ``<c>_mlp``."""
    return cfg.replace(name=cfg.name.split("_")[0] + "_mlp",
                       trpo=dataclasses.replace(cfg.trpo, baseline="mlp"))


def bm_vs_ff(dev, cfg, seed):
    """One batch of ``cfg`` (linear baseline) through ``trpo_update`` with
    and without its feature-first keys: the same accepted exponent,
    direction cosine >= 0.999, |beta| relative error <= 1e-3 (the update
    contract), and no K2, K5 or K6 launch on the batch-major call, whose
    FVP is K3 on the n-major subsample. Returns its record."""
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    state = init_state(cfg, seed=seed, device=dev)
    batch = arm.make_rollout_fn(cfg)(state.params, state.gen)
    out = {}
    for name, b in (("ff", batch),
                    ("bm", {k: batch[k] for k in ("obs", "actions",
                                                  "rewards")})):
        kernels.reset_counts()
        _, _, st = trpo_update(cfg, state.params, state.w, b,
                               return_directions=True)
        out[name] = (st, kernels.launch_counts(), kernels.plain_calls())
    (st_f, l_f, _), (st_b, l_b, p_b) = out["ff"], out["bm"]
    cosine = port_test_helpers().cosine
    cos_x, cos_g = (cosine(st_f[v].cpu().numpy(), st_b[v].cpu().numpy())
                    for v in ("x", "g"))
    beta_rel = abs(float(st_b["beta"]) - float(st_f["beta"])) \
        / float(st_f["beta"])
    acc = (int(st_f["accepted"]), int(st_b["accepted"]))
    print(f"{cfg.name} batch-major against feature-first on one batch: "
          f"cos x {cos_x:.6f}, cos g {cos_g:.6f}, |beta| rel {beta_rel:.3e}, "
          f"accepted {acc}; launches ff {l_f}, batch-major {l_b}")
    require(l_b == {"rollout": 0, "moments": 0, "fvp": cfg.trpo.cg_iters,
                    "rollout3d": 0, "pg": 0, "fvp_ff": 0, "fit_normal": 1}
            and all(c == 0 for c in p_b.values()),
            f"{cfg.name} batch-major launches {l_b}, plain calls {p_b}")
    require(cos_x >= 0.999 and beta_rel <= 1e-3 and acc[0] == acc[1],
            f"{cfg.name} batch-major against feature-first: cos x {cos_x}, "
            f"beta rel {beta_rel}, accepted {acc}")
    return dict(cos_x=cos_x, cos_g=cos_g, beta_rel_err=beta_rel,
                accepted=list(acc), launches_bm=l_b, launches_ff=l_f)


def resume_check(dev, cfg):
    """4 training iterations straight against 2, a checkpoint saved and
    loaded, and 2 more: params, baseline weights and every stat but the
    wall time bit-identical."""
    import tempfile

    from trpo_robot_control_tpu_torch.trpo.train import train
    from trpo_robot_control_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    straight, h4 = train(cfg, n_iters=4, seed=0, device=dev)
    half, _ = train(cfg, n_iters=2, seed=0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        back = load_checkpoint(save_checkpoint(tmp, cfg, half), cfg, dev)
    resumed, h2 = train(cfg, n_iters=2, state=back)

    leaves = port_test_helpers().state_leaves
    same = all(torch.equal(a, b) for a, b in zip(leaves(straight),
                                                 leaves(resumed)))
    stats_same = all({k: v for k, v in a.items() if k != "wall_s"}
                     == {k: v for k, v in b.items() if k != "wall_s"}
                     for a, b in zip(h4[2:], h2))
    print(f"{cfg.name} resume on the card: 4 iterations straight against "
          f"2 + save + load + 2: params and w bit-identical {same}, stats "
          f"bit-identical {stats_same}")
    require(same and stats_same, f"{cfg.name}: the resumed run differs")
    return dict(bit_identical=True)


def k3_nmajor(dev, cfg, launches, seed):
    """K3 on ``cfg``'s n-major Fisher subsample, as the batch-major branch
    forms it from a trainer batch (``obs[::e].reshape(-1, do)[::k]``, fp32,
    contiguous): held to its plain version and its statement
    (``k3_check``), timed behind the lead beside its bound and its plain
    version, with K6 on the same batch's feature-first subsample and the
    relayout's own time beside it. Returns its record."""
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel as fk
    gen, params, _ = k4_setup(dev, cfg, seed)
    batch = arm.make_rollout_fn(cfg)(params, gen)
    tr = cfg.trpo
    k, e, do, da = tr.fvp_subsample, tr.fvp_env_subsample, cfg.obs_dim, \
        cfg.arm.n_joints

    def relayout():
        obs = batch["obs"].to(torch.float32,
                              memory_format=torch.contiguous_format)
        sub = obs[::e].reshape(-1, do)[::k]
        return torch.empty(sub.shape, dtype=torch.float32,
                           device=dev).copy_(sub)

    obs_fvp = relayout()
    B = obs_fvp.shape[0]
    rec, fvp, hs, scale = k3_check(cfg.name, gen, params, obs_fvp,
                                   tr.cg_damping)
    P = policy.flatten(params).numel()
    v = torch.randn(P, generator=gen, device=dev)
    t_k3 = k3_ms(params, obs_fvp, tr.cg_damping, v)
    t_p = cuda_ms(lambda: fk.gn_fvp_plain(params, obs_fvp, hs, scale, v,
                                          tr.cg_damping), 20)
    (b3, by), (b3fma, _) = k3_bound(B, do, da, P, tr.hidden)
    t_rel = cuda_ms(relayout, 20)
    t_k6 = k6_ms(params, batch["obs_ff"][::k, :, ::e], tr.cg_damping, v,
                 lead_ms=K1_LEAD_MS)
    print(f"{cfg.name} fvp on the n-major ({B}, {do}) subsample: "
          f"{t_k3:.4f} ms/launch (tensor-core bound {b3:.4f} ms by {by}, "
          f"{100 * b3 / t_k3:.1f} % of it reached; fp32-FMA {b3fma:.4f}), "
          f"plain {t_p:.3f} ms, {launches} launches on the main path; the "
          f"relayout {t_rel:.4f} ms; K6 on the same batch's feature-first "
          f"subsample {t_k6:.4f} ms/launch")
    rec.update(launches=launches, ms=t_k3, plain_ms=t_p, bound_ms=b3,
               bound_by=by, bound_fp32_fma_ms=b3fma, bound_share=b3 / t_k3,
               library_ms=None, samples=B, relayout_ms=t_rel,
               k6_on_ff_subsample_ms=t_k6)
    return rec


def mlp_phases(dev):
    """Phase 11: c1-, c2- and c3-mlp trained five full-width iterations
    each (K1 or K4 once and K3 ten times an update on the n-major
    subsample, no K2, K5 or K6, no plain version, KL <= delta); at c2 and
    c3 one batch through the batch-major branch against the feature-first
    one; at c2-mlp a checkpoint resume on the card; K3 on c3-mlp's n-major
    subsample. Returns {config: {kernel: record}}."""
    from trpo_robot_control_tpu_torch.configs import (C1_REACHER2,
                                                      C2_REACHER3,
                                                      C3_FRANKA7)
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import train
    t0 = time.perf_counter()
    out = {}
    n_iters = 5
    for base in (C1_REACHER2, C2_REACHER3, C3_FRANKA7):
        cfg = mlp_config(base)
        roll = "rollout3d" if base is C3_FRANKA7 else "rollout"
        expect = {"rollout": 0, "moments": 0,
                  "fvp": n_iters * cfg.trpo.cg_iters, "rollout3d": 0,
                  "pg": 0, "fvp_ff": 0}
        expect[roll] = n_iters
        launches, ms_upd = train_checked(cfg, n_iters, kernels, expect,
                                         train)
        out[cfg.name] = {
            roll: dict(launches=launches[roll], ms_per_update=ms_upd),
            "fvp": dict(launches=launches["fvp"], ms_per_update=ms_upd)}
    for base, seed in ((C2_REACHER3, 20), (C3_FRANKA7, 21)):
        out[mlp_config(base).name]["fvp"]["bm_vs_ff"] = bm_vs_ff(dev, base,
                                                                 seed)
    c2m, c3m = mlp_config(C2_REACHER3), mlp_config(C3_FRANKA7)
    out[c2m.name]["fvp"]["resume"] = resume_check(dev, c2m)
    out[c3m.name]["fvp"].update(
        k3_nmajor(dev, c3m, out[c3m.name]["fvp"]["launches"], 22))
    print(f"MLP-baseline phases took {time.perf_counter() - t0:.1f} s")
    return out


# Phase 12: make_train_many, the K-step train loop replayed as one captured
# CUDA graph of the train step, on every path at full width, and the
# fit_normal kernel on each linear path's first-update normal equations
TRAIN_MANY_K = 10
# the kernel and the eigh solve against an fp64 one with the same floor,
# and against each other, in the A-norm: within FIT_UNITS fp32 unit
# roundoffs times the kept condition number (tests/test_torch_helpers.py:
# fit_bound), capped at this (readings up to 1.9e-4 on these full-width
# systems; w = 0 reads 1.0)
FIT_CAP = 1e-3


def train_many_configs():
    """(tag, config, seed) of every path phase 12 captures."""
    from trpo_robot_control_tpu_torch.configs import (C1_REACHER2,
                                                      C2_REACHER3,
                                                      C3_FRANKA7,
                                                      C4_FRANKA7_OBSTACLE,
                                                      C5_MULTITASK)
    return [("c1", C1_REACHER2, 30), ("c2", C2_REACHER3, 31),
            ("c3", C3_FRANKA7, 32), ("c4", C4_FRANKA7_OBSTACLE, 33),
            ("c5", C5_MULTITASK, 34),
            ("c2_term", C2_REACHER3.replace(done_dist=C2_DONE_DIST), 35),
            ("c5_term", C5_MULTITASK.replace(done_dist=C5_DONE_DIST), 36),
            ("c1_mlp", mlp_config(C1_REACHER2), 37),
            ("c2_mlp", mlp_config(C2_REACHER3), 38),
            ("c3_mlp", mlp_config(C3_FRANKA7), 39)]


def step_launches(cfg, params):
    """One train step's launches on ``cfg``'s path: its rollout kernel, K2
    and fit_normal on a linear baseline, K5 and K6 or K3 as the update's
    routes decide (``trpo/update.py:kernel_routes``)."""
    from trpo_robot_control_tpu_torch.envs.arm import _planar_route
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.update import kernel_routes
    tr = cfg.trpo
    T, N, k, e = cfg.horizon, cfg.n_envs, tr.fvp_subsample, \
        tr.fvp_env_subsample
    linear = tr.baseline != "mlp"
    routes = kernel_routes(tr, params, T, N, -(-T // k), -(-N // e),
                           ff=linear)
    out = dict.fromkeys(kernels.WRAPPERS, 0)
    out["rollout" if _planar_route(cfg) else "rollout3d"] = 1
    out["moments"] = out["fit_normal"] = int(linear)
    out["pg"] = int(routes["surrgrad"] == "pallas")
    out[{"ff": "fvp_ff", "bm": "fvp"}[routes["fvp"]]] = tr.cg_iters
    return out


def fit_flops(m: int) -> int:
    """The fewest fp32 operations that fit_normal's w needs on an m x m
    system, whatever the algorithm: the Jacobi scaling (m^2 products
    d_i d_j, m^2 divisions), A_s reduced to tridiagonal form by Householder
    reflections (4 m^3 / 3; Golub and Van Loan, Matrix Computations,
    section 8.3) and the reflectors applied to b/d and back (4 m^2). The
    tridiagonal eigenproblem and its rotations applied to one vector are
    O(m^2) and not counted; forming the eigenvectors, as the kernel and
    eigh do, would bring the count to about 9 m^3 (ibid.). Independent of
    the sweeps the kernel runs."""
    return 4 * m ** 3 // 3 + 6 * m * m


def first_update_system(dev, cfg, state):
    """(A + ridge I, b): ``cfg``'s first-update normal equations, from the
    rollout of ``state`` on a copy of its generator, the initial linear
    baseline's values, GAE and K2's moments, as ``trpo_update`` forms
    them."""
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import baseline
    from trpo_robot_control_tpu_torch.ops.cuda.moments_kernel import \
        baseline_moments
    from trpo_robot_control_tpu_torch.ops.gae import gae
    tr = cfg.trpo
    gen = torch.Generator(device=dev)
    gen.set_state(state.gen.get_state())
    batch = arm.make_rollout_fn(cfg)(state.params, gen)
    obs_ff, rew = batch["obs_ff"], batch["rewards_ff"]
    values = baseline.values_ff(state.w, obs_ff, cfg.horizon)
    adv_raw = gae(rew, values, tr.gamma, tr.lam, dones=batch.get("dones_ff"),
                  time_axis=0)
    A, b = baseline_moments(obs_ff, adv_raw + values, cfg.horizon)
    return A + tr.baseline_reg * torch.eye(A.shape[0], device=dev), b


def fit_normal_check(dev, tag, cfg, state):
    """The fit_normal kernel on ``cfg``'s first-update normal equations
    (``first_update_system``): against the statement of its arithmetic
    run on the card, bit for bit (w and the sweeps: the same separately
    rounded operations in the same order); the statement's eigenpairs a
    decomposition of A_s and w their solve (``fit_pairs_errors``); the
    kernel against the eigh solve (the plain version) and both against an
    fp64 solve, within ``fit_bound`` capped at FIT_CAP; timed beside its
    bound, the plain version and ``torch.linalg.eigh`` of the same A_s
    (the library yardstick). Returns its record."""
    from trpo_robot_control_tpu_torch.ops.cuda import fit_kernel as fk
    A, b = first_update_system(dev, cfg, state)
    m = A.shape[0]
    w, sweeps = fk.jacobi_solve(A, b)
    sweeps = int(sweeps)
    helpers = port_test_helpers()
    w_s, lam_s, Q_s, sweeps_s = helpers.fit_normal_jacobi_statement(A, b)
    w64, kept = helpers.fp64_floored_solve(A, b)
    w_p = fk.fit_normal_plain(A, b)
    bit = bool(torch.equal(w, w_s))
    res, solve = helpers.fit_pairs_errors(A, b, w, lam_s, Q_s)
    err = dict(w_abs=float((w - w_s).abs().max()),
               plain=helpers.a_norm_rel(A, w, w_p),
               kernel_fp64=helpers.a_norm_rel(A, w, w64),
               plain_fp64=helpers.a_norm_rel(A, w_p, w64),
               pairs_residual=res, solve_from_pairs=solve)
    bound64 = helpers.fit_bound(kept, FIT_CAP)
    print(f"{tag} fit_normal (F {m}): {sweeps} sweeps (statement "
          f"{sweeps_s}), bit-identical to the statement {bit} (max |w "
          f"difference| {err['w_abs']:.2e}); the statement's pairs: "
          f"residual {res:.2e}, solve {solve:.2e}; against the eigh solve "
          f"{err['plain']:.2e} in the A-norm; kernel / eigh against fp64 "
          f"{err['kernel_fp64']:.2e} / {err['plain_fp64']:.2e} (kept "
          f"condition {kept:.3e}, bound {bound64:.2e})")
    require(bit and sweeps == sweeps_s and sweeps < fk.MAX_SWEEPS,
            f"{tag} fit_normal against its statement: sweeps {sweeps} / "
            f"{sweeps_s}, {err}")
    require(res <= helpers.FIT_RES_TOL and solve <= helpers.FIT_SOLVE_TOL,
            f"{tag} fit_normal's pairs: {err}")
    require(max(err["plain"], err["kernel_fp64"], err["plain_fp64"])
            <= bound64, f"{tag} fit_normal against the eigh and fp64 "
            f"solves: {err}, bound {bound64}")
    require(all(torch.equal(fk.fit_normal(A, b), w) for _ in range(3)),
            f"{tag} fit_normal: repeat calls differ")
    d = torch.sqrt(torch.diagonal(A) + 1e-20)
    A_s = A / (d[:, None] * d[None, :])
    t_k = cuda_ms(lambda: fk.fit_normal(A, b), 50, lead_ms=K1_LEAD_MS)
    t_p = cuda_ms(lambda: fk.fit_normal_plain(A, b), 20)
    t_lib = cuda_ms(lambda: torch.linalg.eigh(A_s), 20)
    flops = fit_flops(m)
    bms, by = bound_ms(flops, 4.0 * (m * m + 2 * m))
    one_sm = 1e3 * flops / (PEAK_FP32_FLOPS / 132)
    rounds = sweeps * (m - 1)
    us_round = 1e3 * t_k / max(rounds, 1)
    print(f"{tag} fit_normal: {t_k:.4f} ms/launch, {us_round:.3f} us a "
          f"round ({sweeps} sweeps x {m - 1} rounds) (bound {bms:.3e} ms "
          f"by {by}, one SM's {one_sm:.3e} ms), plain {t_p:.4f} ms, "
          f"torch.linalg.eigh of A_s {t_lib:.4f} ms")
    return dict(max_abs_err=err["w_abs"], ms=t_k, plain_ms=t_p,
                us_per_round=us_round,
                bound_ms=bms, bound_by=by, bound_one_sm_ms=one_sm,
                library_ms=t_lib, sweeps=sweeps, F=m, flops=flops,
                bit_identical_to_statement=bit, kept_condition=kept,
                errors=err)


def train_many_check(dev, tag, cfg, seed):
    """``make_train_many(cfg, K)`` on the card against K eager steps of
    ``make_train_step`` from the same state, bit for bit (parameters,
    baseline weights, every stat); the capture's launches equal to one
    eager step's (``step_launches``), no plain version; finite stats and
    KL <= delta in every row of two calls; ms an update eager (the K-step
    loop, no host read, after two warm-up steps) and replayed (a second
    call), the warm-up's and capture's seconds, the peak device memory.
    Returns its record."""
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import (WARMUP_STEPS,
                                                         init_state,
                                                         make_train_many,
                                                         make_train_step)
    K = TRAIN_MANY_K
    step = make_train_step(cfg)
    linear = cfg.trpo.baseline != "mlp"
    leaves = port_test_helpers().state_leaves

    warm = init_state(cfg, seed=seed + 100, device=dev)
    for _ in range(2):
        warm, _ = step(warm)
    del warm
    state0 = init_state(cfg, seed=seed, device=dev)
    expect = step_launches(cfg, state0.params)
    rec = dict(fit_normal=fit_normal_check(dev, tag, cfg, state0)
               if linear else None)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, rows = state0, []
    for i in range(K):
        ref, st = step(ref)
        rows.append(st)
        if i == 0:
            one, one_plain = kernels.launch_counts(), kernels.plain_calls()
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / K
    ref_leaves = leaves(ref)
    del ref, state0
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    fn = make_train_many(cfg, K)
    kernels.reset_counts()
    t0 = time.perf_counter()
    state, stacked = fn(init_state(cfg, seed=seed, device=dev))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main, plain = kernels.launch_counts(), kernels.plain_calls()
    g = fn.graphed()
    print(f"{tag} make_train_many: launches at capture {g.launches}, on "
          f"the call (warm-up and capture) {main}, one eager step {one}")
    require(one == expect and all(c == 0 for c in one_plain.values()),
            f"{tag} eager step launches {one}, plain {one_plain}, "
            f"expected {expect}")
    require(g.launches == one and all(c == 0 for c in g.plain_calls.values())
            and all(c == 0 for c in plain.values()),
            f"{tag} capture launches {g.launches}, plain {g.plain_calls}")
    require(main == {k: (WARMUP_STEPS + 1) * v for k, v in one.items()},
            f"{tag} make_train_many launches {main}")
    same_state = all(torch.equal(a, b) for a, b in zip(leaves(state),
                                                       ref_leaves))
    diff = [k for k in stacked
            if not torch.equal(stacked[k], torch.stack([r[k] for r in rows]))]
    print(f"{tag} graph against eager over {K} steps: state bit-identical "
          f"{same_state}, stats differing {diff}")
    require(same_state and not diff and set(stacked) == set(rows[0]),
            f"{tag}: graph replay differs from the eager steps ({diff})")
    del rows, ref_leaves
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stacked2 = fn(state)
    torch.cuda.synchronize()
    graph_ms = 1e3 * (time.perf_counter() - t0) / K
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for st in (stacked, stacked2):
        host = {k: v.double().cpu() for k, v in st.items()}
        require(all(bool(torch.isfinite(v).all()) for v in host.values()),
                f"{tag}: non-finite stats {host}")
        ok = (host["accepted"] < 0) | (host["kl"] <= cfg.trpo.delta)
        require(bool(ok.all()), f"{tag}: an accepted step outside the trust "
                f"region {host}")
    require(state.iteration == 2 * K, f"{tag}: iteration {state.iteration}")
    print(f"{tag} update: eager {eager_ms:.3f} ms, graph replay "
          f"{graph_ms:.3f} ms ({1e3 / graph_ms:.2f} updates/s); warm-up "
          f"{g.warmup_s:.2f} s, capture {g.capture_s:.2f} s, first call "
          f"{first_s:.2f} s; peak device memory {peak:.3f} GiB")
    rec.update(eager_ms=eager_ms, graph_ms=graph_ms, capture_s=g.capture_s,
               warmup_s=g.warmup_s, first_call_s=first_s, peak_gib=peak,
               launches_at_capture=g.launches, bit_identical=True)
    return rec


def train_many_phases(dev):
    """Phase 12: ``train_many_check`` on every path of
    ``train_many_configs``. Returns {tag: record}."""
    t0 = time.perf_counter()
    out = {tag: train_many_check(dev, tag, cfg, seed)
           for tag, cfg, seed in train_many_configs()}
    print(f"train_many phases took {time.perf_counter() - t0:.1f} s")
    print("train_many " + json.dumps(
        {tag: {k: v for k, v in r.items() if k != "fit_normal"}
         for tag, r in out.items()}))
    return out


# Phase 13: data parallelism (parallel/mesh.py) through the same kernels:
# (a) a world of one over NCCL in this process, bit for bit the unsharded
# path; (b) SHARD_RANKS gloo ranks sharing the card on one batch each of c2
# and c3, held to the unsharded update at ROADMAP's parity contract and
# test_sharding.py's bounds, then train_sharded; (c) the CLI under torchrun
SHARD_RANKS = 2
SHARD_TRAIN_ITERS = 3
SHARD_TIMEOUT_S = 300
SHARD_REPS = 3
# 13b's batches, (tag, config, seed): c3 on four seeds, since the refit's
# end-to-end check there reads the ridge solve's sensitivity
SHARD_BATCHES = (("c2", "C2_REACHER3", 48), ("c3", "C3_FRANKA7", 49),
                 ("c3_s50", "C3_FRANKA7", 50), ("c3_s51", "C3_FRANKA7", 51),
                 ("c3_s52", "C3_FRANKA7", 52))
# the ranks' summed normal equations against the unsharded ones (fp32
# sums in another order): max |dA_ij| / sqrt(A_ii A_jj), max |db| / max |b|
SHARD_MOMENTS_TOL = 1e-5


def all_reduce_us(group, n: int, dev) -> dict:
    """Host µs a ``collectives.all_reduce`` of ``n`` fp32 on ``dev`` over
    ``group``: each call synchronised, and queued (50 calls, then one
    synchronisation); and a bare ``dist.all_reduce`` in place, queued."""
    import torch.distributed as dist
    from trpo_robot_control_tpu_torch.parallel import collectives
    x = torch.ones(n, device=dev)
    sync = 1e3 * host_ms(lambda: collectives.all_reduce(x, group), 50)

    def queued(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0) / reps
    return dict(n=n, synchronised_us=sync,
                queued_us=queued(lambda: collectives.all_reduce(x, group)),
                bare_queued_us=queued(lambda: dist.all_reduce(x, group=group)))


class NormalEquations:
    """While entered, records the data rows that ``trpo_update`` hands K2
    (``rows``: obs_ff, the targets, the horizon) and each (A + ridge I, b)
    that ``baseline.fit_moments`` hands ``fit_normal`` (``seen``, on the
    host in fp64); both calls run as before."""

    def __enter__(self):
        from trpo_robot_control_tpu_torch.models import baseline
        from trpo_robot_control_tpu_torch.trpo import update
        self.saved = [(baseline, "fit_normal", baseline.fit_normal),
                      (update, "baseline_moments", update.baseline_moments)]
        self.seen, self.rows = [], []
        solve, moments = baseline.fit_normal, update.baseline_moments

        def fit_spy(A, b, *args, **kw):
            self.seen.append((A.detach().double().cpu(),
                              b.detach().double().cpu()))
            return solve(A, b, *args, **kw)

        def moments_spy(obs_ff, targets, horizon):
            self.rows.append((obs_ff, targets, horizon))
            return moments(obs_ff, targets, horizon)
        baseline.fit_normal, update.baseline_moments = fit_spy, moments_spy
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def exact_refit(obs_ff, targets, horizon: int, reg: float):
    """The ridge refit from the same rows with K2's Gram summed exactly
    (``extended_gram_plain``: fp64 sums, rounded to fp32 once), solved by
    ``fit_normal``: the unsharded refit with its sums in another order.
    Returns (w, A + ridge I in fp64 on the host)."""
    from trpo_robot_control_tpu_torch.models import baseline
    from trpo_robot_control_tpu_torch.ops.cuda.moments_kernel import \
        extended_gram_plain
    T, do, N = obs_ff.shape
    tau = baseline._time_features(T, horizon, obs_ff.device)
    gram = extended_gram_plain(obs_ff, targets.contiguous(), tau)
    F2 = 2 * do + 1
    A, b = baseline.assemble(gram[:F2, :F2], gram[:F2, F2:], tau, N, do)
    A = A + reg * torch.eye(A.shape[0], device=A.device)
    return baseline.fit_normal(A, b), A.double().cpu()


def moments_err(A, b, A_ref, b_ref) -> dict:
    """The summed normal equations against the unsharded ones:
    max |dA_ij| / sqrt(A_ii A_jj) and max |db_i| / max |b|."""
    d = torch.sqrt(torch.diagonal(A_ref))
    return dict(A=float(((A - A_ref).abs() / (d[:, None] * d[None, :])).max()),
                b=float((b - b_ref).abs().max() / b_ref.abs().max()))


def kept_directions(A, rel_floor: float = 1e-6) -> dict:
    """The Jacobi-scaled A's eigenvalues in fp64 that ``fit_normal`` keeps
    (>= rel_floor times the largest): their count, of F, and the kept
    condition number."""
    d = torch.sqrt(torch.diagonal(A))
    lam = torch.linalg.eigvalsh(A / (d[:, None] * d[None, :]))
    kept = lam[lam > rel_floor * lam[-1]]
    return dict(kept=int(kept.numel()), F=int(lam.numel()),
                cond=float(lam[-1] / kept[0]))


def host_ms(fn, reps: int = SHARD_REPS) -> float:
    """Host ms a call of ``fn`` over ``reps`` calls after one, each ending
    in a synchronisation (an update's time as its caller sees it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def sharded_one(dev):
    """13a: ``make_mesh`` with no group makes a world of one over NCCL; at
    c1-c5 ``make_sharded_update`` on ``shard_batch`` of one rollout equals
    ``trpo_update`` bit for bit (parameters, baseline, every stat) with the
    same launches; at c2 and c5 ``make_train_many(cfg, 3, mesh)`` (eager)
    equals ``make_train_many(cfg, 3)`` (the replayed graph) bit for bit.
    Counts, all-reduces and ms an update (unsharded, sharded, sharded,
    unsharded) per config. Destroys the group. Returns {tag: record}."""
    import torch.distributed as dist
    from trpo_robot_control_tpu_torch.configs import (C1_REACHER2,
                                                      C2_REACHER3,
                                                      C3_FRANKA7,
                                                      C4_FRANKA7_OBSTACLE,
                                                      C5_MULTITASK)
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.parallel import collectives
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                         make_train_many)
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    leaves = port_test_helpers().state_leaves
    mesh = pm.make_mesh(device=dev)
    backend = dist.get_backend(mesh.group)
    require(backend == "nccl" and mesh.shape == {"data": 1, "model": 1},
            f"world of one: {backend}, {mesh.shape}")
    out = {}
    for tag, cfg, seed in (("c1", C1_REACHER2, 40), ("c2", C2_REACHER3, 41),
                           ("c3", C3_FRANKA7, 42),
                           ("c4", C4_FRANKA7_OBSTACLE, 43),
                           ("c5", C5_MULTITASK, 44)):
        st = init_state(cfg, seed=seed, device=dev)
        batch = arm.make_rollout_fn(cfg)(st.params, st.gen)
        kernels.reset_counts()
        ref = trpo_update(cfg, st.params, st.w, batch)
        want = kernels.launch_counts()
        update = pm.make_sharded_update(cfg, mesh)
        kernels.reset_counts()
        collectives.reset_counts()
        got = update(st.params, st.w, pm.shard_batch(mesh, batch))
        launches, plain = kernels.launch_counts(), kernels.plain_calls()
        calls = collectives.all_reduce.calls
        nbytes = collectives.all_reduce.bytes
        a, b = (leaves(type("S", (), dict(params=r[0], w=r[1]))) for r in
                (ref, got))
        bit = all(torch.equal(x, y) for x, y in zip(a, b)) and \
            ref[2].keys() == got[2].keys() and \
            all(torch.equal(ref[2][k], got[2][k]) for k in ref[2])
        print(f"{tag} sharded update, world of one ({backend}): "
              f"bit-identical {bit}; launches {launches} (unsharded "
              f"{want}); {calls} all-reduces, {nbytes} bytes an update")
        require(bit and launches == want
                and all(c == 0 for c in plain.values()),
                f"{tag} world of one against the unsharded update")
        ms = [host_ms(lambda: trpo_update(cfg, st.params, st.w, batch)),
              host_ms(lambda: update(st.params, st.w, batch))]
        ms += [host_ms(lambda: update(st.params, st.w, batch)),
               host_ms(lambda: trpo_update(cfg, st.params, st.w, batch))]
        unsharded_ms, sharded_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        print(f"{tag} ms an update (host, synchronised; turns unsharded, "
              f"sharded, sharded, unsharded {[round(m, 3) for m in ms]}): "
              f"unsharded {unsharded_ms:.3f}, sharded on one rank "
              f"{sharded_ms:.3f}")
        out[tag] = dict(bit_identical=bit, launches=launches,
                        all_reduces=calls, all_reduce_bytes=nbytes,
                        unsharded_ms=unsharded_ms, sharded_ms=sharded_ms,
                        turns_ms=ms)
        del st, batch, ref, got
    ar = all_reduce_us(mesh.group, 5190, dev)
    print(f"one all-reduce of c2's P = 5190 floats ({backend}, world of "
          f"one): {ar['synchronised_us']:.1f} µs synchronised, "
          f"{ar['queued_us']:.1f} µs queued, bare dist.all_reduce "
          f"{ar['bare_queued_us']:.1f} µs queued")
    out["all_reduce"] = ar
    for tag, cfg, seed in (("c2", C2_REACHER3, 45), ("c5", C5_MULTITASK, 46)):
        s1, st1 = make_train_many(cfg, 3)(init_state(cfg, seed, dev))
        s2, st2 = make_train_many(cfg, 3, mesh)(init_state(cfg, seed, dev))
        bit = all(torch.equal(x, y) for x, y in zip(leaves(s1), leaves(s2))) \
            and st1.keys() == st2.keys() \
            and all(torch.equal(st1[k], st2[k]) for k in st1)
        print(f"{tag} make_train_many(cfg, 3, mesh) against the replayed "
              f"graph: bit-identical {bit}")
        require(bit, f"{tag} sharded train loop against the unsharded one")
        out[tag]["train_many_bit_identical"] = bit
    dist.destroy_process_group()
    return out


def _shard_rank(rank, port, tmp, dev):
    """13b, one rank of SHARD_RANKS over gloo on the card (a spawned
    process): its ``shard_batch`` of each saved batch through
    ``make_sharded_update`` (launches, all-reduces, ms an update), then
    ``train_sharded`` at c2; writes ``rank<r>.pt`` to ``tmp``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SHARD_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.parallel import collectives
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    pm.init_distributed(timeout_s=120)
    mesh = pm.make_mesh(device=dev, backend="gloo")
    out = {}
    for tag, _, _ in SHARD_BATCHES:
        saved = torch.load(os.path.join(tmp, f"{tag}.pt"), weights_only=False)
        cfg = saved["cfg"]
        params = {k: v.to(dev) for k, v in saved["params"].items()}
        w = saved["w"].to(dev)
        local = pm.shard_batch(mesh, saved["batch"])
        update = pm.make_sharded_update(cfg, mesh)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        collectives.reset_counts()
        with NormalEquations() as normal:
            new, w_new, st = update(params, w, local, return_directions=True)
        torch.cuda.synchronize()
        rec = dict(launches=kernels.launch_counts(),
                   plain=kernels.plain_calls(),
                   all_reduces=collectives.all_reduce.calls,
                   all_reduce_bytes=collectives.all_reduce.bytes,
                   moments=normal.seen,
                   theta=torch.cat([new[k].reshape(-1) for k in sorted(new)]
                                   ).cpu(),
                   w=w_new.cpu(), stats={k: v.cpu() for k, v in st.items()})
        rec["ms"] = host_ms(lambda: update(params, w, local))
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[tag] = rec
    out["all_reduce"] = all_reduce_us(mesh.group, 5190, dev)
    cfg = torch.load(os.path.join(tmp, "c2.pt"), weights_only=False)["cfg"]
    kernels.reset_counts()
    t0 = time.perf_counter()
    state, hist = pm.train_sharded(cfg, mesh, n_iters=SHARD_TRAIN_ITERS,
                                   seed=47)
    torch.cuda.synchronize()
    out["train"] = dict(
        seconds=time.perf_counter() - t0, history=hist,
        launches=kernels.launch_counts(),
        leaves=[x.cpu() for x in port_test_helpers().state_leaves(state)])
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def sharded_gloo(dev):
    """13b: one batch each of c2 (1024 x 100: K1, K2 fp32, fit_normal, K3
    x 10) and, on SHARD_BATCHES' four seeds, c3 (4096 x 200: K4, K2-bf16,
    K5-bf16 on the global 819,200 samples, K6 on the global 102,400-sample
    subsample, 51,200 a rank), collected once by the unsharded rollout and
    updated unsharded here, then by SHARD_RANKS spawned gloo ranks sharing
    the card on their ``shard_batch``es: ranks bit-identical; against the
    unsharded update the direction cosine >= 0.999, |beta| rel <= 1e-3,
    the same accepted exponent (else both KLs against delta printed, and
    a failure), theta within rtol 2e-3 atol 2e-4 (tests/test_sharding.py
    :48-63); the normal equations the ranks solve (summed over them, ridge
    added) within SHARD_MOMENTS_TOL of the unsharded ones, and the refit
    within FIT_CAP of the unsharded one in the A-norm (the relative RMS
    error of the predictions over the batch; the max error of the
    predictions against their mean scale, test_sharding.py's form, is
    printed beside it, with the same two figures for the unsharded rows
    summed exactly, and the directions the solve keeps and its kept
    condition number for both systems); each rank's launches those of the
    unsharded update, no plain version; then
    train_sharded's SHARD_TRAIN_ITERS iterations at c2: KL <= delta,
    finite stats, ranks bit-identical. Returns its record."""
    import socket
    import tempfile

    import torch.multiprocessing as mp
    from trpo_robot_control_tpu_torch import configs
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import baseline, policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    cosine = port_test_helpers().cosine
    refs, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, name, seed in SHARD_BATCHES:
            cfg = getattr(configs, name)
            st = init_state(cfg, seed=seed, device=dev)
            batch = arm.make_rollout_fn(cfg)(st.params, st.gen)
            kernels.reset_counts()
            with NormalEquations() as normal:
                new, w_new, stats = trpo_update(cfg, st.params, st.w, batch,
                                                return_directions=True)
            launches = kernels.launch_counts()
            w_exact, _ = exact_refit(*normal.rows[0], cfg.trpo.baseline_reg)
            refs[tag] = dict(launches=launches, moments=normal.seen,
                             w_exact=w_exact.cpu(),
                             theta=policy.flatten(new).cpu(),
                             theta0=policy.flatten(st.params).cpu(),
                             w=w_new.cpu(), stats={k: v.cpu()
                                                   for k, v in stats.items()},
                             obs=batch["obs"], horizon=cfg.horizon,
                             delta=cfg.trpo.delta)
            refs[tag]["ms"] = host_ms(
                lambda: trpo_update(cfg, st.params, st.w, batch))
            torch.save(dict(cfg=cfg, params={k: v.cpu() for k, v in
                                             st.params.items()},
                            w=st.w.cpu(), batch={k: v.cpu() for k, v in
                                                 batch.items()}),
                       os.path.join(tmp, f"{tag}.pt"))
            del st, batch
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        ctx = mp.spawn(_shard_rank, args=(port, tmp, dev), nprocs=SHARD_RANKS,
                       join=False)
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"phase 13b: the ranks did not finish in "
                                   f"{SHARD_TIMEOUT_S} s")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(SHARD_RANKS)]
    print(f"phase 13b: {SHARD_RANKS} gloo ranks on one card, {spawn_s:.1f} s "
          "from spawn to exit; one all-reduce of P = 5190 floats a rank "
          f"{[r['all_reduce'] for r in ranks]}")
    out["all_reduce"] = [r["all_reduce"] for r in ranks]
    checks = []                 # required once every batch is printed
    for tag, ref in refs.items():
        r0 = ranks[0][tag]
        same = all(torch.equal(r0["theta"], r[tag]["theta"])
                   and torch.equal(r0["w"], r[tag]["w"])
                   and all(torch.equal(r0["stats"][k], r[tag]["stats"][k])
                           for k in r0["stats"]) for r in ranks[1:])
        st, st_ref = r0["stats"], ref["stats"]
        cos = cosine(st["x"].numpy(), st_ref["x"].numpy())
        beta_rel = abs(float(st["beta"]) - float(st_ref["beta"])) \
            / float(st_ref["beta"])
        acc, acc_ref = int(st["accepted"]), int(st_ref["accepted"])
        th_err = (r0["theta"] - ref["theta"]).abs()
        th_over = int((th_err > 2e-4 + 2e-3 * ref["theta"].abs()).sum())
        phi = baseline.features(ref["obs"].float(), ref["horizon"]).reshape(
            -1, r0["w"].numel()).cpu()
        v, v_ref = phi @ r0["w"], phi @ ref["w"]
        v_err = float((v - v_ref).abs().max() / (v_ref.abs().mean() + 1e-6))
        (A, b), (A_ref, b_ref) = r0["moments"][0], ref["moments"][0]
        m_err = moments_err(A, b, A_ref, b_ref)
        kept, kept_ref = kept_directions(A), kept_directions(A_ref)
        a_norm = port_test_helpers().a_norm_rel
        refit = dict(sharded=a_norm(A_ref, r0["w"], ref["w"]),
                     exact_sums=a_norm(A_ref, ref["w_exact"], ref["w"]))
        v_x = phi @ ref["w_exact"]
        v_err_x = float((v_x - v_ref).abs().max()
                        / (v_ref.abs().mean() + 1e-6))
        print(f"{tag} normal equations, the ranks' sum against the unsharded"
              f" ones: |dA| {m_err['A']:.3e} of sqrt(A_ii A_jj), |db| "
              f"{m_err['b']:.3e} of max |b| (limit {SHARD_MOMENTS_TOL:g}); "
              f"the solve keeps {kept['kept']} / {kept['F']} directions at "
              f"kept condition {kept['cond']:.3e} (unsharded "
              f"{kept_ref['kept']}, {kept_ref['cond']:.3e}); the refit "
              f"against the unsharded one, A-norm (limit {FIT_CAP:g}) / "
              f"max |dv| of mean |v|: sharded {refit['sharded']:.3e} / "
              f"{v_err:.3e}, the unsharded rows with exact sums "
              f"{refit['exact_sums']:.3e} / {v_err_x:.3e}")
        print(f"{tag} {SHARD_RANKS} gloo ranks against the unsharded update: "
              f"ranks bit-identical {same}; direction cosine {cos:.7f}, "
              f"|beta| rel {beta_rel:.3e}, accepted {acc} / {acc_ref}, max "
              f"|theta error| {float(th_err.max()):.3e} ({th_over} over "
              f"rtol 2e-3 atol 2e-4), baseline {v_err:.3e} of scale; "
              f"launches a rank {[r[tag]['launches'] for r in ranks]} "
              f"(unsharded {ref['launches']}); all-reduces "
              f"{r0['all_reduces']}, {r0['all_reduce_bytes']} bytes an "
              f"update; ms an update {[round(r[tag]['ms'], 3) for r in ranks]}"
              f" (unsharded {ref['ms']:.3f}); peak GiB a rank "
              f"{[round(r[tag]['peak_gib'], 3) for r in ranks]}")
        if acc != acc_ref:
            print(f"{tag}: accepted exponents differ; KL sharded "
                  f"{float(st['kl']):.6e}, unsharded {float(st_ref['kl']):.6e}"
                  f", delta {ref['delta']}")
        require(same, f"{tag}: the ranks' updates differ")
        require(all(r[tag]["launches"] == ref["launches"]
                    and all(c == 0 for c in r[tag]["plain"].values())
                    for r in ranks), f"{tag}: the ranks' routes differ from "
                "the unsharded update's")
        checks.append((cos >= 0.999 and beta_rel <= 1e-3 and acc == acc_ref
                       and th_over == 0,
                       f"{tag}: the sharded update against the unsharded "
                       "one"))
        checks.append((len(r0["moments"]) == len(ref["moments"]) == 1
                       and max(m_err.values()) <= SHARD_MOMENTS_TOL
                       and refit["sharded"] <= FIT_CAP,
                       f"{tag}: the summed normal equations and the refit "
                       "against the unsharded ones"))
        out[tag] = dict(ranks_bit_identical=same, direction_cosine=cos,
                        beta_rel=beta_rel, accepted=acc,
                        theta_max_abs_err=float(th_err.max()),
                        baseline_err=v_err, baseline_err_exact_sums=v_err_x,
                        refit_a_norm=refit, moments_err=m_err,
                        kept=kept, kept_unsharded=kept_ref,
                        launches=r0["launches"],
                        all_reduces=r0["all_reduces"],
                        all_reduce_bytes=r0["all_reduce_bytes"],
                        ms=[r[tag]["ms"] for r in ranks],
                        unsharded_ms=ref["ms"],
                        peak_gib=[r[tag]["peak_gib"] for r in ranks])
    for ok, what in checks:
        require(ok, what)
    trains = [r["train"] for r in ranks]
    hist = trains[0]["history"]
    same = all(all(torch.equal(a, b) for a, b in zip(trains[0]["leaves"],
                                                     t["leaves"]))
               and [{k: v for k, v in h.items() if k != "wall_s"}
                    for h in t["history"]]
               == [{k: v for k, v in h.items() if k != "wall_s"}
                   for h in hist] for t in trains[1:])
    ok = all(all(math.isfinite(v) for v in h.values())
             and (h["accepted"] < 0 or h["kl"] <= C2_REACHER3.trpo.delta)
             for h in hist)
    print(f"c2 train_sharded on {SHARD_RANKS} gloo ranks, "
          f"{SHARD_TRAIN_ITERS} iterations: ranks bit-identical {same}; "
          f"returns {[round(h['mean_return'], 4) for h in hist]}, kl "
          f"{[round(h['kl'], 6) for h in hist]}, accepted "
          f"{[h['accepted'] for h in hist]}; ms an iteration "
          f"{[round(1e3 * h['wall_s'], 3) for h in hist]}; launches "
          f"{trains[0]['launches']}")
    require(same and ok and len(hist) == SHARD_TRAIN_ITERS,
            "train_sharded on two ranks")
    out["train_c2"] = dict(ranks_bit_identical=same,
                           ms=[1e3 * h["wall_s"] for h in hist],
                           launches=trains[0]["launches"])
    return out


def sharded_cli():
    """13c: the CLI under torchrun, one rank, ``--sharded`` at c2; exit 0
    and two iteration lines. Returns its seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m",
           "trpo_robot_control_tpu_torch.cli.train", "--config", "c2_reacher3", "--sharded", "--iters", "2"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=SHARD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("iter")]
    mesh = [ln for ln in run.stderr.splitlines() if ln.startswith("mesh:")]
    print(f"torchrun ... cli.train --config c2_reacher3 --sharded --iters 2: "
          f"exit {run.returncode} in {seconds:.1f} s; {mesh}; " + "; ".join(
              lines))
    require(run.returncode == 0 and len(lines) == 2,
            f"the sharded CLI: {run.stderr[-2000:]}")
    return seconds


def sharded_phases(dev):
    """Phase 13 (13a-c). Returns its record."""
    t0 = time.perf_counter()
    rec = dict(world_of_one=sharded_one(dev), gloo_ranks=sharded_gloo(dev),
               cli_s=sharded_cli())
    rec["seconds"] = time.perf_counter() - t0
    print(f"sharded phases took {rec['seconds']:.1f} s")
    print("sharded " + json.dumps(rec))
    return rec


# Phase 14: tensor parallelism (parallel/tensor.py): TP_RANKS gloo ranks
# sharing the card on a (1, TP_RANKS) mesh, the policy's first two layers
# sharded over the 'model' axis, (a) the TP update at full width on one
# batch each of c2 and c3 against the unsharded batch-major update,
# (b) the TP train step at c2, (c) all-reduces, bytes and ms per update
TP_RANKS = 2
TP_TRAIN_ITERS = 3
TP_BATCHES = (("c2", "C2_REACHER3", 53), ("c3", "C3_FRANKA7", 54))
# host ms of the TP update over this many calls after one (c3's forwards
# all-reduce hundreds of MB through the host)
TP_REPS = {"c2": SHARD_REPS, "c3": 1}
BM_KEYS = ("obs", "actions", "rewards")


def _tp_rank(rank, port, tmp, dev):
    """14, one rank of TP_RANKS over gloo on the card (a spawned process),
    model index ``rank`` on one data index: the TP update on each saved
    batch (launches, all-reduces by group, ms an update, peak memory), then
    ``train_sharded`` for TP_TRAIN_ITERS iterations at c2; writes
    ``tp<r>.pt`` to ``tmp``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(TP_RANKS),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.parallel import collectives
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    pm.init_distributed(timeout_s=120)
    mesh = pm.make_mesh(n_data=1, n_model=TP_RANKS, device=dev,
                        backend="gloo")
    out = {}
    for tag, _, _ in TP_BATCHES:
        saved = torch.load(os.path.join(tmp, f"{tag}.pt"), weights_only=False)
        cfg = saved["cfg"]
        params = {k: v.to(dev) for k, v in saved["params"].items()}
        w = saved["w"].to(dev)
        batch = pm.shard_batch(mesh, saved["batch"])
        update = pm.make_sharded_update_tp(cfg, mesh)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        collectives.reset_counts()
        new, w_new, st = update(params, w, batch, return_directions=True)
        torch.cuda.synchronize()
        rec = dict(launches=kernels.launch_counts(),
                   plain=kernels.plain_calls(),
                   model=collectives.group_counts(mesh.model_group),
                   data=collectives.group_counts(mesh.group),
                   theta=torch.cat([new[k].reshape(-1) for k in sorted(new)]
                                   ).cpu(),
                   w=w_new.cpu(), stats={k: v.cpu() for k, v in st.items()})
        rec["ms"] = host_ms(lambda: update(params, w, batch), TP_REPS[tag])
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[tag] = rec
        del params, w, batch, saved, new, w_new, st
    cfg = torch.load(os.path.join(tmp, "c2.pt"), weights_only=False)["cfg"]
    kernels.reset_counts()
    collectives.reset_counts()
    t0 = time.perf_counter()
    state, hist = pm.train_sharded(cfg, mesh, n_iters=TP_TRAIN_ITERS,
                                   seed=55)
    torch.cuda.synchronize()
    out["train"] = dict(
        seconds=time.perf_counter() - t0, history=hist,
        launches=kernels.launch_counts(), plain=kernels.plain_calls(),
        model=collectives.group_counts(mesh.model_group),
        leaves=[x.cpu() for x in port_test_helpers().state_leaves(state)])
    torch.save(out, os.path.join(tmp, f"tp{rank}.pt"))
    torch.distributed.destroy_process_group()


def tp_phases(dev):
    """Phase 14: one batch each of c2 (1024 x 100, K1) and c3 (4096 x 200,
    K4, bf16 storage) collected by the unsharded rollout and updated here
    by the unsharded batch-major ``trpo_update`` (the batch's obs, actions
    and rewards: K3 x 10, fit_normal), then by TP_RANKS spawned gloo ranks
    sharing the card on a (1, TP_RANKS) mesh (``make_sharded_update_tp``:
    plain PyTorch, one fit_normal launch, no other kernel, no plain
    version): (a) the ranks' full parameters, baseline and stats bit for
    bit the same; against the unsharded update the direction cosine >=
    0.999, |beta| rel <= 1e-3, the same accepted exponent (else both KLs
    against delta printed, and a failure) and theta within rtol 2e-3 atol
    2e-4 (tests/test_tensor_parallel.py:66-67); (b) ``train_sharded`` on
    the mesh for TP_TRAIN_ITERS iterations at c2: K1 and fit_normal once an
    iteration on each rank, no plain version, KL <= delta, finite stats,
    the ranks bit for bit; (c) per update, the all-reduces and their bytes
    on the model and the data group (none: one data index) and ms a rank
    beside the unsharded update's. Returns its record."""
    import socket
    import tempfile

    import torch.multiprocessing as mp
    from trpo_robot_control_tpu_torch import configs
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    t_start = time.perf_counter()
    cosine = port_test_helpers().cosine
    refs, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, name, seed in TP_BATCHES:
            cfg = getattr(configs, name)
            st = init_state(cfg, seed=seed, device=dev)
            batch = {k: v for k, v in arm.make_rollout_fn(cfg)(
                st.params, st.gen).items() if k in BM_KEYS}
            kernels.reset_counts()
            new, w_new, stats = trpo_update(cfg, st.params, st.w, batch,
                                            return_directions=True)
            refs[tag] = dict(launches=kernels.launch_counts(),
                             theta=policy.flatten(new).cpu(),
                             stats={k: v.cpu() for k, v in stats.items()},
                             delta=cfg.trpo.delta)
            refs[tag]["ms"] = host_ms(
                lambda: trpo_update(cfg, st.params, st.w, batch),
                TP_REPS[tag])
            torch.save(dict(cfg=cfg, params={k: v.cpu() for k, v in
                                             st.params.items()},
                            w=st.w.cpu(), batch={k: v.cpu() for k, v in
                                                 batch.items()}),
                       os.path.join(tmp, f"{tag}.pt"))
            del st, batch, new, w_new, stats
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        ctx = mp.spawn(_tp_rank, args=(port, tmp, dev), nprocs=TP_RANKS,
                       join=False)
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(f"phase 14: the ranks did not finish in "
                                   f"{SHARD_TIMEOUT_S} s")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"tp{r}.pt"),
                            weights_only=False) for r in range(TP_RANKS)]
    print(f"phase 14: {TP_RANKS} gloo ranks on one card, a (1, {TP_RANKS}) "
          f"mesh, {spawn_s:.1f} s from spawn to exit")
    checks = []                 # required once every batch is printed
    for tag, ref in refs.items():
        r0 = ranks[0][tag]
        same = all(torch.equal(r0["theta"], r[tag]["theta"])
                   and torch.equal(r0["w"], r[tag]["w"])
                   and all(torch.equal(r0["stats"][k], r[tag]["stats"][k])
                           for k in r0["stats"]) for r in ranks[1:])
        st, st_ref = r0["stats"], ref["stats"]
        cos = cosine(st["x"].numpy(), st_ref["x"].numpy())
        beta_rel = abs(float(st["beta"]) - float(st_ref["beta"])) \
            / float(st_ref["beta"])
        acc, acc_ref = int(st["accepted"]), int(st_ref["accepted"])
        th_err = (r0["theta"] - ref["theta"]).abs()
        th_over = int((th_err > 2e-4 + 2e-3 * ref["theta"].abs()).sum())
        want = {k: int(k == "fit_normal") for k in r0["launches"]}
        routes = all(r[tag]["launches"] == want
                     and all(c == 0 for c in r[tag]["plain"].values())
                     for r in ranks)
        print(f"{tag} TP update on {TP_RANKS} gloo ranks against the "
              f"unsharded batch-major update: ranks bit-identical {same}; "
              f"direction cosine {cos:.9f}, |beta| rel {beta_rel:.3e}, "
              f"accepted {acc} / {acc_ref}, max |theta error| "
              f"{float(th_err.max()):.3e} ({th_over} over rtol 2e-3 atol "
              f"2e-4); launches a rank {[r[tag]['launches'] for r in ranks]}"
              f" (unsharded {ref['launches']}); all-reduces an update, "
              f"model group {r0['model'][0]} ({r0['model'][1]} bytes), data "
              f"group {r0['data'][0]} ({r0['data'][1]} bytes); ms an update "
              f"{[round(r[tag]['ms'], 3) for r in ranks]} (unsharded "
              f"{ref['ms']:.3f}); peak GiB a rank "
              f"{[round(r[tag]['peak_gib'], 3) for r in ranks]}")
        if acc != acc_ref:
            print(f"{tag}: accepted exponents differ; KL TP "
                  f"{float(st['kl']):.6e}, unsharded {float(st_ref['kl']):.6e}"
                  f", delta {ref['delta']}")
        checks.append((same, f"{tag}: the TP ranks' updates differ"))
        checks.append((routes, f"{tag}: the TP update's launches"))
        checks.append((cos >= 0.999 and beta_rel <= 1e-3 and acc == acc_ref
                       and th_over == 0,
                       f"{tag}: the TP update against the unsharded one"))
        out[tag] = dict(ranks_bit_identical=same, direction_cosine=cos,
                        beta_rel=beta_rel, accepted=acc,
                        theta_max_abs_err=float(th_err.max()),
                        launches=r0["launches"],
                        model_all_reduces=list(r0["model"]),
                        data_all_reduces=list(r0["data"]),
                        ms=[r[tag]["ms"] for r in ranks],
                        unsharded_ms=ref["ms"],
                        peak_gib=[r[tag]["peak_gib"] for r in ranks])
    trains = [r["train"] for r in ranks]
    hist = trains[0]["history"]
    same = all(all(torch.equal(a, b) for a, b in zip(trains[0]["leaves"],
                                                     t["leaves"]))
               and [{k: v for k, v in h.items() if k != "wall_s"}
                    for h in t["history"]]
               == [{k: v for k, v in h.items() if k != "wall_s"}
                   for h in hist] for t in trains[1:])
    ok = all(all(math.isfinite(v) for v in h.values())
             and (h["accepted"] < 0 or h["kl"] <= C2_REACHER3.trpo.delta)
             for h in hist)
    want = {k: TP_TRAIN_ITERS if k in ("rollout", "fit_normal") else 0
            for k in trains[0]["launches"]}
    launched = all(t["launches"] == want
                   and all(c == 0 for c in t["plain"].values())
                   for t in trains)
    print(f"c2 TP train_sharded on {TP_RANKS} gloo ranks, {TP_TRAIN_ITERS} "
          f"iterations: ranks bit-identical {same}; returns "
          f"{[round(h['mean_return'], 4) for h in hist]}, kl "
          f"{[round(h['kl'], 6) for h in hist]}, accepted "
          f"{[h['accepted'] for h in hist]}; ms an iteration "
          f"{[round(1e3 * h['wall_s'], 3) for h in hist]}; launches a rank "
          f"{[t['launches'] for t in trains]}; model-group all-reduces "
          f"{trains[0]['model'][0]} ({trains[0]['model'][1]} bytes)")
    checks.append((same and ok and len(hist) == TP_TRAIN_ITERS,
                   "the TP train step on two ranks"))
    checks.append((launched, "the TP train step's launches: K1 and "
                   "fit_normal once an iteration"))
    for good, what in checks:
        require(good, what)
    out["train_c2"] = dict(ranks_bit_identical=same,
                           ms=[1e3 * h["wall_s"] for h in hist],
                           launches=trains[0]["launches"])
    out["seconds"] = time.perf_counter() - t_start
    print(f"tensor-parallel phase took {out['seconds']:.1f} s")
    print("tensor_parallel " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from trpo_robot_control_tpu_torch.device import resolve
    from trpo_robot_control_tpu_torch.ops.cuda import build

    dev = resolve(None)
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    libs = [n for n, (_, _, hidden) in build.LIBS.items() if hidden is None]
    libs += phase8_libs() + phase9_libs() + phase10_libs()
    print(f"build: {build.build_all(libs):.1f} s ({len(libs)} libraries)")
    print(build.ptxas_report())
    print("the refit's kernels, -Xptxas -v:\n" + refit_ptxas())
    sass = k2_bf16_sass()
    print(f"K2 bf16-mode SASS SHA-256 {sass} (the parent design's "
          f"{K2_BF16_SASS_SHA256}): "
          + ("unchanged" if sass == K2_BF16_SASS_SHA256 else "CHANGED"))
    require(sass == K2_BF16_SASS_SHA256, "K2's bf16-mode SASS changed")
    occupancy_k1 = k1_occupancy()
    occupancy = k4_occupancy()
    occupancy_k3 = k3_occupancy()
    occupancy_k6 = k6_occupancy()

    from trpo_robot_control_tpu_torch.configs import (C3_FRANKA7,
                                                      C4_FRANKA7_OBSTACLE,
                                                      C5_MULTITASK)
    rec = c2_phases(dev)
    print(f"c2 phases done at {time.perf_counter() - t_start:.1f} s")
    rec.update(arm3d_phases(dev, C3_FRANKA7, seed=1))
    print(f"c3 phases done at {time.perf_counter() - t_start:.1f} s")
    more = {}
    for tag, cfg, seed in (("c4", C4_FRANKA7_OBSTACLE, 2),
                           ("c5", C5_MULTITASK, 3)):
        more[tag] = arm3d_phases(dev, cfg, seed)
        print(f"{tag} phases done at {time.perf_counter() - t_start:.1f} s")
    rec.update(c2_term_phases(dev))
    print(f"c2 termination phases done at "
          f"{time.perf_counter() - t_start:.1f} s")
    rec.update(c5_term_phases(dev))
    print(f"c5 termination phases done at "
          f"{time.perf_counter() - t_start:.1f} s")
    p3 = c5_planar3()
    more["c5_planar3"] = arm3d_phases(dev, p3, seed=5, tag="c5_planar3",
                                      exact=True)
    print(f"c5-planar3 phases done at {time.perf_counter() - t_start:.1f} s")
    p3_term = c5_term_phases(dev, p3, tag="c5_planar3", seed=14)
    print(f"c5-planar3 termination phases done at "
          f"{time.perf_counter() - t_start:.1f} s")
    c2b = c2_bf16_phases(dev)
    print(f"c2-bf16 phases done at {time.perf_counter() - t_start:.1f} s")
    other_n = other_n_phases(dev)
    n8 = k1_n8_record(dev)
    print(f"phases at every joint count done at "
          f"{time.perf_counter() - t_start:.1f} s")
    shapes = policy_shape_checks(dev)
    for cfg, seed in ((c3_baselines32(), 6), (c3_deep3(), 7)):
        more[cfg.name] = arm3d_phases(dev, cfg, seed, tag=cfg.name,
                                      exact=True)
    print(f"policy-shape phases done at "
          f"{time.perf_counter() - t_start:.1f} s")
    shapes.update(planar_shape_checks(dev))
    for cfg, seed in ((c2_baselines32(), 8), (c2_deep3(), 9)):
        more[cfg.name] = c2_shape_phases(dev, cfg, seed)
    print(f"planar policy-shape phases done at "
          f"{time.perf_counter() - t_start:.1f} s")
    wide = wide_shape_checks(dev)
    more["c3_rllab"] = arm3d_phases(dev, c3_rllab(), 15, tag="c3_rllab")
    more["c2_rllab"] = c2_shape_phases(dev, c2_rllab(), 16)
    print(f"wide policy phases done at {time.perf_counter() - t_start:.1f} s")
    more.update(mlp_phases(dev))
    print(f"MLP-baseline phases done at "
          f"{time.perf_counter() - t_start:.1f} s")
    for tag, r in train_many_phases(dev).items():
        if r["fit_normal"] is None:
            continue
        if tag == "c2":
            rec["fit_normal"].update(r["fit_normal"])
        else:
            more.setdefault(tag, {})["fit_normal"] = r["fit_normal"]
    print(f"train_many phases done at {time.perf_counter() - t_start:.1f} s")
    sharded_phases(dev)
    print(f"sharded phases done at {time.perf_counter() - t_start:.1f} s")
    tp_phases(dev)
    print(f"tensor-parallel phase done at "
          f"{time.perf_counter() - t_start:.1f} s")
    out = []
    for name in ("rollout", "moments", "fvp", "rollout3d", "pg", "fvp_ff",
                 "rollout_term", "rollout3d_term", "fit_normal"):
        r = rec[name]
        src = name.replace("_term", "")
        entry = dict(name=name, route="cuda", source=SOURCE.format(src),
                     replaces=REPLACES[name], launches=r["launches"],
                     max_abs_err=r["max_abs_err"], ms=r["ms"],
                     plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                     bound_by=r["bound_by"], library_ms=r["library_ms"],
                     ok=True)
        entry.update({k: v for k, v in r.items() if k not in entry})
        key = "moments_bf16" if name == "moments" else name
        if key in rec and key != name:
            entry["bf16_mode_c3"] = rec[key]
        for tag, r in more.items():
            if key in r:
                entry[("bf16_mode_" if key != name else "at_") + tag] = r[key]
        if name == "rollout":
            entry["occupancy"] = occupancy_k1
            entry.update(bf16_mode_c2=c2b["rollout"], at_n8=n8,
                         other_n=other_n["rollout"])
        if name == "moments":
            entry["bf16_mode_c2"] = c2b["moments"]
        if name == "fvp":
            entry["at_c2_bf16"] = c2b["fvp"]
        if name == "rollout3d_term":
            entry["at_c5_planar3"] = p3_term["rollout3d_term"]
        if name == "rollout3d":
            entry["occupancy"] = occupancy
            entry["other_n"] = other_n["rollout3d"]
        if name == "fvp":
            entry["occupancy"] = occupancy_k3
        if name == "fvp_ff":
            entry["occupancy"] = occupancy_k6
        if name in shapes:
            entry["policy_shapes"] = shapes[name]
        if name in wide:
            entry["wide_shapes"] = wide[name]
        out.append(entry)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
