"""Where the time of one training iteration goes, on the card.

  python -m trpo_robot_control_tpu_torch.cli.profile --config c2_reacher3
  python -m trpo_robot_control_tpu_torch.cli.profile --config c5_multitask \
      --done-dist 0.05
  python -m trpo_robot_control_tpu_torch.cli.profile --config c3_franka7 \
      --baseline mlp

Runs two warm-up iterations, then times ``--iters`` iterations on the host
clock (each ends in the stats' device-to-host copy), then profiles another
``--iters`` with ``torch.profiler`` and prints, per iteration: the host
time of each ``trpo/...`` layer range and the device time of the kernels
it launched, the device time of the busiest kernels, and the device's
busy and idle shares of the profiled wall time, and the peak device memory
allocated over the timed iterations. Needs a CUDA card. ``profile(cfg,
iters)`` does the same for a config that is not in ``CONFIGS`` (such as
``C5_MULTITASK.replace(arm=planar_arm(3), ...)``), from a script.
"""
from __future__ import annotations

import argparse
import subprocess
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="c2_reacher3")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--done-dist", type=float, default=None,
                    help="early episode termination distance (default: "
                         "the config's, 0 = fixed horizon)")
    ap.add_argument("--baseline", choices=("linear", "mlp"), default=None,
                    help="value baseline (default: the config's)")
    args = ap.parse_args(argv)

    import dataclasses

    from ..configs import CONFIGS
    cfg = CONFIGS[args.config]
    if args.done_dist is not None:
        cfg = cfg.replace(done_dist=args.done_dist)
    if args.baseline is not None:
        cfg = cfg.replace(trpo=dataclasses.replace(cfg.trpo,
                                                   baseline=args.baseline))
    profile(cfg, args.iters)


def profile(cfg, iters: int = 5):
    """Profile ``iters`` training iterations of ``cfg`` on the card, as the
    module's docstring sets out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from ..device import resolve
    from ..trpo.train import init_state, make_train_step, stats_to_host

    dev = resolve(None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; config {cfg.name}, {cfg.n_envs} envs x "
          f"{cfg.horizon} steps, done_dist {cfg.done_dist}, baseline "
          f"{cfg.trpo.baseline}")
    state = init_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg)

    early = []

    def run(k):
        nonlocal state
        for _ in range(k):
            state, stats = step(state)
            early.append(stats_to_host(stats).get("early_dones"))

    run(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run(iters)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    print(f"unprofiled: {ms:.3f} ms per iteration ({1e3 / ms:.2f} it/s); "
          f"peak device memory allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} GiB")
    if early[-1] is not None:
        print(f"early dones per iteration: {[int(x) for x in early]}")

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        t0 = time.perf_counter()
        run(iters)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    per = 1.0 / iters
    print(f"profiled: {1e-3 * wall_us * per:.3f} ms per iteration")
    host = {e.key: e.cpu_time_total for e in prof.key_averages()
            if e.key.startswith("trpo/") and e.device_type == DeviceType.CPU}
    dev_evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in dev_evs if e.name.startswith("trpo/")]
    kern = [(e.time_range.start, e.time_range.end) for e in dev_evs
            if not e.name.startswith("trpo/")]
    print("layer ranges, per iteration: host ms; device span ms (first "
          "kernel start to last kernel end); ms of kernels inside the span")
    for name in sorted(host):
        span = kin = 0.0
        for e in spans:
            if e.name == name:
                s0, s1 = e.time_range.start, e.time_range.end
                span += s1 - s0
                kin += sum(max(0.0, min(s1, k1) - max(s0, k0))
                           for k0, k1 in kern)
        print(f"  {name:22s} host {1e-3 * host[name] * per:8.3f}  "
              f"span {1e-3 * span * per:8.3f}  kernels {1e-3 * kin * per:8.3f}")
    busy_us = sum(k1 - k0 for k0, k1 in kern)
    print(f"device busy {1e-3 * busy_us * per:.3f} ms per iteration = "
          f"{100 * busy_us / wall_us:.1f}% of the profiled wall time "
          f"(idle {100 * (1 - busy_us / wall_us):.1f}%); "
          f"{len(kern) * per:.0f} device ops per iteration")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("trpo/")]
    print("top 20 by device time, per iteration: ms, launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {1e-3 * e.self_device_time_total * per:8.3f}  "
              f"{e.count * per:6.1f}  {e.key[:90]}")

if __name__ == "__main__":
    main()
