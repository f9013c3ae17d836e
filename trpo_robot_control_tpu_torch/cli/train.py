"""Training CLI for the PyTorch port: pick a config, train, print one line
of stats per iteration.

  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 --iters 20
  python -m trpo_robot_control_tpu_torch.cli.train --config c5_multitask \
      --iters 2 --device cpu --n-envs 64 --horizon 16
  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 \
      --iters 20 --done-dist 0.1

Runs on the CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="c2_reacher3",
                    help="c1_reacher2, c2_reacher3, c3_franka7, "
                         "c4_franka7_obstacle or c5_multitask")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--n-envs", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--done-dist", type=float, default=None,
                    help="early episode termination distance (0 = fixed "
                         "horizon; > 0 = an episode ends, and the env "
                         "starts a fresh one, on reaching the target)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    from ..configs import CONFIGS
    from ..trpo.train import train

    cfg = CONFIGS[args.config]
    if args.n_envs:
        cfg = cfg.replace(n_envs=args.n_envs)
    if args.horizon:
        cfg = cfg.replace(horizon=args.horizon)
    if args.done_dist is not None:
        cfg = cfg.replace(done_dist=args.done_dist)
    early_steps = (cfg.horizon - 1) * cfg.n_envs

    def log(s):
        done = ""
        if "early_dones" in s:
            done = (f"  early dones {int(s['early_dones'])} "
                    f"({100 * s['early_dones'] / early_steps:.3f}%)")
        print(f"iter {s['iter']:4d}  return {s['mean_return']:9.3f}  "
              f"kl {s['kl']:.5f}  accepted {s['accepted']:2d}  "
              f"beta {s['beta']:.4f}  surr {s['surr']:+.5f}  "
              f"cg_res {s['cg_residual']:.3e}{done}  "
              f"{1e3 * s['wall_s']:.1f} ms", flush=True)

    train(cfg, n_iters=args.iters, seed=args.seed, log_fn=log,
          device=args.device)


if __name__ == "__main__":
    main()
