"""Quickest proof that the PyTorch port runs on the GPU.

  python3 chip_smoke.py

Needs one CUDA card; exits non-zero, and prints no result, without one.
Drives the port (``trpo_robot_control_tpu_torch``) only:

1. names the card and builds the CUDA kernels from ``ops/cuda/csrc``;
2. K1 rollout kernel against its plain version at c2 width (eps mode:
   tight over 10 steps, looser over the full horizon), then the Philox
   mode's noise statistics and seed determinism;
3. K2 moments kernel against ``normal_eq_ff`` on that rollout's batch;
4. K3 FVP kernel against the plain ``make_gn_fvp`` on c2's Fisher
   subsample, and bit-identical repeat calls;
5. five full-width c2 training iterations through ``trpo.train.train``,
   with the launch counters showing every kernel ran on that path and no
   plain version did;
6. times each kernel (CUDA events) beside its bound, its plain version
   and, for K2, a library yardstick.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
REPLACES = {
    "rollout": "trpo_robot_control_tpu/ops/pallas/rollout_kernel.py:594",
    "moments": "trpo_robot_control_tpu/ops/pallas/moments_kernel.py:143",
    "fvp": "trpo_robot_control_tpu/ops/pallas/fvp_kernel.py:294",
}
SOURCE = "trpo_robot_control_tpu_torch/ops/cuda/csrc/{}.cu"
K1_TIGHT_STEPS, K1_TIGHT_ATOL = 10, 1e-5
# Over the full horizon any fp32 rounding difference (the kernel's MLP sums
# in its own fmaf order, the plain version's in cuBLAS's) feeds back
# through 100 dependent dynamics steps, so the bound is looser.
K1_FULL_ATOL = 1e-2
K2_REL = 1e-5
K3_REL = 1e-5


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


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from trpo_robot_control_tpu_torch.configs import C2_REACHER3
    from trpo_robot_control_tpu_torch.device import resolve
    from trpo_robot_control_tpu_torch.envs import arm
    from trpo_robot_control_tpu_torch.models import baseline, policy
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.ops.cuda import (build, fvp_kernel,
                                                       moments_kernel,
                                                       rollout_kernel)
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
    from trpo_robot_control_tpu_torch.ops.gae import gae
    from trpo_robot_control_tpu_torch.trpo.train import train

    dev = resolve(None)
    t_start = time.perf_counter()

    # ---- 1) the card and the build
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"build: {build.build_all():.1f} s")
    print(build.ptxas_report())

    cfg = C2_REACHER3
    T, N, n = cfg.horizon, cfg.n_envs, cfg.arm.n_joints
    do, da = cfg.obs_dim, n
    H = cfg.trpo.hidden[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = policy.init_params(gen, do, da, cfg.trpo.hidden,
                                cfg.trpo.logstd_init)
    s0 = arm.reset(cfg, gen, N)
    record = {}

    # ---- 2) K1 rollout vs its plain version
    eps = torch.randn(T, N, n, generator=gen, device=dev)
    k_out = rollout_kernel.rollout(cfg, params, s0.q, s0.qd, s0.tgt, eps=eps)
    p_out = rollout_kernel.rollout_plain(cfg, params, s0.q, s0.qd, s0.tgt,
                                         eps)
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
    obs_a, act_a, rew_a = rollout_kernel.rollout(cfg, params, s0.q, s0.qd,
                                                 s0.tgt, seed=seed_a)
    obs_a2, act_a2, _ = rollout_kernel.rollout(cfg, params, s0.q, s0.qd,
                                               s0.tgt, seed=seed_a)
    _, act_b, _ = rollout_kernel.rollout(cfg, params, s0.q, s0.qd, s0.tgt,
                                         seed=seed_b)
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
    record["rollout"] = dict(max_abs_err=err10)

    # ---- 3) K2 moments vs normal_eq_ff on that rollout's batch
    obs_ff, _, rew_ff = k_out
    targets = gae(rew_ff, torch.zeros_like(rew_ff), cfg.trpo.gamma,
                  cfg.trpo.lam, time_axis=0)
    A_k, b_k = moments_kernel.baseline_moments(obs_ff, targets, cfg.horizon)
    A_r, b_r = baseline.normal_eq_ff(obs_ff, targets, cfg.horizon)
    tau = baseline._time_features(T, cfg.horizon, dev)
    gram_k = moments_kernel.extended_gram(obs_ff, targets, tau)
    gram_p = moments_kernel.extended_gram_plain(obs_ff, targets, tau)
    rel_A = float((A_k - A_r).abs().max() / A_r.abs().max())
    rel_b = float((b_k - b_r).abs().max() / b_r.abs().max())
    err_gram = float((gram_k - gram_p).abs().max())
    print(f"K2: rel err A {rel_A:.3e}, b {rel_b:.3e} vs normal_eq_ff "
          f"(bound {K2_REL}); max |kernel - plain| Gram {err_gram:.3e} "
          f"(max |Gram| {float(gram_p.abs().max()):.3e})")
    require(rel_A <= K2_REL and rel_b <= K2_REL, f"K2 error {rel_A}, {rel_b}")
    record["moments"] = dict(max_abs_err=err_gram)

    # ---- 4) K3 FVP vs the plain make_gn_fvp on c2's Fisher subsample
    k = cfg.trpo.fvp_subsample
    obs_fvp = obs_ff[::k].permute(0, 2, 1).reshape(-1, do)
    B_sub = obs_fvp.shape[0]
    hs = fvp_kernel.activations(params, obs_fvp)
    scale = torch.exp(-2.0 * params["logstd"]) / B_sub
    P = policy.flatten(params).numel()
    fvp = make_gn_fvp(params, obs_fvp, cfg.trpo.cg_damping)
    worst_rel, worst_abs = 0.0, 0.0
    for _ in range(10):
        v = torch.randn(P, generator=gen, device=dev)
        fk_ = fvp(v)
        fp_ = fvp_kernel.gn_fvp_plain(params, obs_fvp, hs, scale, v,
                                      cfg.trpo.cg_damping)
        worst_rel = max(worst_rel, float(torch.linalg.norm(fk_ - fp_)
                                         / torch.linalg.norm(fp_)))
        worst_abs = max(worst_abs, float((fk_ - fp_).abs().max()))
        require(torch.equal(fk_, fvp(v)), "K3 is not deterministic")
    print(f"K3: B' = {B_sub}, worst relative L2 err {worst_rel:.3e} over 10 v "
          f"(bound {K3_REL}); repeat calls bit-identical")
    require(worst_rel <= K3_REL, f"K3 error {worst_rel}")
    record["fvp"] = dict(max_abs_err=worst_abs)

    # ---- 5) five full-width c2 iterations through the trainer
    n_iters = 5
    kernels.reset_counts()

    def log(st):
        print("iter " + json.dumps({k_: (round(v_, 6) if isinstance(v_, float)
                                         else v_) for k_, v_ in st.items()}))

    _, hist = train(cfg, n_iters=n_iters, seed=0, log_fn=log)
    launches = kernels.launch_counts()
    plain = kernels.plain_calls()
    print(f"main path: launches {launches}, plain calls {plain}")
    require(launches == {"rollout": n_iters, "moments": n_iters,
                         "fvp": n_iters * cfg.trpo.cg_iters},
            f"main-path launches {launches}")
    require(all(c == 0 for c in plain.values()), f"plain calls {plain}")
    for st in hist:
        require(all(math.isfinite(v_) for v_ in st.values()),
                f"non-finite stats {st}")
        require(st["accepted"] < 0 or st["kl"] <= cfg.trpo.delta,
                f"accepted step outside the trust region {st}")
    ms_upd = 1e3 * sum(st["wall_s"] for st in hist[1:]) / (n_iters - 1)
    print(f"c2 update (host clock, iterations 2-{n_iters}): {ms_upd:.3f} ms, "
          f"{1e3 / ms_upd:.2f} updates/s")

    # ---- 6) kernel times beside bounds, plain versions and yardsticks
    B = T * N
    seed_t = torch.tensor([7, 7], dtype=torch.int64, device=dev)
    t_k1 = cuda_ms(lambda: rollout_kernel.rollout(
        cfg, params, s0.q, s0.qd, s0.tgt, seed=seed_t), 20)
    t_k1p = cuda_ms(lambda: rollout_kernel.rollout_plain(
        cfg, params, s0.q, s0.qd, s0.tgt, eps), 2, warmup=1)
    mlp_macs = do * H + H * H + H * da
    b1 = bound_ms(2.0 * mlp_macs * B,
                  4.0 * (B * (do + da + 1) + N * (2 * n + 2) + P))
    t_k2 = cuda_ms(lambda: moments_kernel.extended_gram(obs_ff, targets, tau),
                   50)
    t_k2p = cuda_ms(lambda: moments_kernel.extended_gram_plain(
        obs_ff, targets, tau), 20)
    R = 2 * do + 5
    v_ext = torch.cat([obs_ff, obs_ff * obs_ff, targets[:, None, :],
                       tau[:, :, None].expand(T, 4, N)], dim=1) \
        .permute(1, 0, 2).reshape(R, B).contiguous()
    t_k2lib = cuda_ms(lambda: torch.matmul(v_ext, v_ext.T), 50)
    b2 = bound_ms(2.0 * (R * (R + 1) // 2) * B + B * do,
                  4.0 * (B * (do + 1) + 4 * T + R * R))
    v = torch.randn(P, generator=gen, device=dev)
    t_k3 = cuda_ms(lambda: fvp(v), 50)
    t_k3p = cuda_ms(lambda: fvp_kernel.gn_fvp_plain(
        params, obs_fvp, hs, scale, v, cfg.trpo.cg_damping), 20)
    fvp_macs = 2 * do * H + 4 * H * H + 4 * H * da
    b3 = bound_ms(2.0 * fvp_macs * B_sub,
                  4.0 * (B_sub * (do + 2 * H) + 3 * P))
    times = {"rollout": (t_k1, t_k1p, b1, None),
             "moments": (t_k2, t_k2p, b2, t_k2lib),
             "fvp": (t_k3, t_k3p, b3, None)}
    out = []
    for name in ("rollout", "moments", "fvp"):
        ms, plain_ms, (bms, by), lib_ms = times[name]
        out.append(dict(name=name, route="cuda", source=SOURCE.format(name),
                        replaces=REPLACES[name], launches=launches[name],
                        max_abs_err=record[name]["max_abs_err"], ms=ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=lib_ms, ok=True))
        print(f"{name}: {ms:.4f} ms/launch (bound {bms:.4f} ms by {by}), "
              f"plain {plain_ms:.3f} ms"
              + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f", {launches[name] // n_iters} launch(es)/update")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
