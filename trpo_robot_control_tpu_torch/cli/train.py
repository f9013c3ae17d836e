"""Training CLI for the PyTorch port: pick a config, train, print one line
of stats per iteration, with JSONL metrics and checkpoints.

  python -m trpo_robot_control_tpu_torch.cli.train --config c1_reacher2 --iters 50
  python -m trpo_robot_control_tpu_torch.cli.train --config c5_multitask \
      --iters 2 --device cpu --n-envs 64 --horizon 16
  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 \
      --iters 20 --done-dist 0.1
  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 \
      --baseline mlp --trpo hidden=32,32 --trpo cg_iters=20 \
      --jsonl run.jsonl --ckpt-dir ckpt --ckpt-every 10
  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 \
      --resume ckpt/ckpt_000020.npz --iters 20

Runs on the CUDA device unless ``--device cpu`` is given. ``--trpo
KEY=VALUE`` sets any TRPOSpec field, cast to the field's type (a tuple
field takes comma-separated integers, a bool field true/false/1/0).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def _cast(cur, raw: str):
    """``raw`` as a value of the type of ``cur``."""
    if isinstance(cur, bool):
        if raw.lower() not in ("true", "false", "1", "0"):
            raise ValueError(f"not a bool: {raw!r}")
        return raw.lower() in ("true", "1")
    if isinstance(cur, tuple):
        return tuple(int(x) for x in raw.split(",") if x.strip())
    return type(cur)(raw)


def trpo_overrides(trpo, pairs):
    """``trpo`` with each KEY=VALUE of ``pairs`` set; exits, listing the
    fields, on a field TRPOSpec does not have."""
    fields = [f.name for f in dataclasses.fields(trpo)]
    over = {}
    for kv in pairs:
        key, sep, raw = kv.partition("=")
        if not sep or key not in fields:
            sys.exit(f"--trpo: unknown TRPOSpec field {kv!r} "
                     f"(fields: {fields})")
        try:
            over[key] = _cast(getattr(trpo, key), raw)
        except ValueError as err:
            sys.exit(f"--trpo {kv!r}: {err}")
    return dataclasses.replace(trpo, **over)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="c1_reacher2",
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for checkpoints (one at the end, and "
                         "every --ckpt-every iterations)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", default=None,
                    help="path to a checkpoint .npz to resume from (the "
                         "JAX package's checkpoints load too)")
    ap.add_argument("--jsonl", default=None, help="metrics JSONL path")
    ap.add_argument("--baseline", choices=("linear", "mlp"), default=None,
                    help="value baseline: linear ridge fit (default) or "
                         "small-MLP Adam refit")
    ap.add_argument("--trpo", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="set a TRPOSpec field, e.g. --trpo cg_iters=20 "
                         "--trpo hidden=32,32 --trpo delta=0.005 "
                         "(repeatable; cast to the field's type)")
    args = ap.parse_args(argv)

    from ..configs import CONFIGS
    from ..trpo.train import train
    from ..utils.checkpoint import (config_hash, load_checkpoint,
                                    save_checkpoint)
    from ..utils.metrics import JsonlLogger

    cfg = CONFIGS[args.config]
    if args.n_envs:
        cfg = cfg.replace(n_envs=args.n_envs)
    if args.horizon:
        cfg = cfg.replace(horizon=args.horizon)
    if args.done_dist is not None:
        cfg = cfg.replace(done_dist=args.done_dist)
    if args.baseline is not None:
        cfg = cfg.replace(trpo=dataclasses.replace(cfg.trpo,
                                                   baseline=args.baseline))
    if args.trpo:
        cfg = cfg.replace(trpo=trpo_overrides(cfg.trpo, args.trpo))
    early_steps = (cfg.horizon - 1) * cfg.n_envs

    logger = JsonlLogger(args.jsonl, echo=False)
    logger.header({"config": cfg.name, "config_hash": config_hash(cfg),
                   "n_envs": cfg.n_envs, "horizon": cfg.horizon})
    state = load_checkpoint(args.resume, cfg, args.device) \
        if args.resume else None

    def log(s):
        logger(s)
        done = ""
        if "early_dones" in s:
            done = (f"  early dones {int(s['early_dones'])} "
                    f"({100 * s['early_dones'] / early_steps:.3f}%)")
        print(f"iter {s['iter']:4d}  return {s['mean_return']:9.3f}  "
              f"kl {s['kl']:.5f}  accepted {s['accepted']:2d}  "
              f"beta {s['beta']:.4f}  surr {s['surr']:+.5f}  "
              f"cg_res {s['cg_residual']:.3e}{done}  "
              f"{1e3 * s['wall_s']:.1f} ms", flush=True)

    state, _ = train(cfg, n_iters=args.iters, seed=args.seed, log_fn=log,
                     state=state, device=args.device,
                     checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt_dir)
    if args.ckpt_dir:
        print(f"checkpoint: {save_checkpoint(args.ckpt_dir, cfg, state)}",
              file=sys.stderr)
    logger.close()


if __name__ == "__main__":
    main()
