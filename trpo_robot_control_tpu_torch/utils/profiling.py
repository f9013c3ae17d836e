"""Tracing and profiling hooks (port of
``trpo_robot_control_tpu/utils/profiling.py``):

- ``trace(path)``: a context manager around ``torch.profiler.profile``
  (the CPU, and the card where there is one) that yields the profiler and,
  given a path, writes a Chrome trace of the region there on exit
  (``cli/profile.py`` reads its events);
- ``cost_analysis(fn, *args)``: the FLOPs of one call of ``fn``, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (the matrix products,
  convolutions and attention it has formulas for; elementwise ops count
  nothing), as XLA's cost analysis reports them;
- ``debug_checks()``: anomaly mode with its NaN checks in the backward,
  and a NaN check on the output of every op (JAX's ``jax_debug_nans``):
  a NaN raises FloatingPointError naming the op. For debugging runs, never
  the hot path: every op's check reads a flag back to the host.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """Profile the region; with ``path``, export its Chrome trace there."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True) as prof:
        yield prof
    if path is not None:
        prof.export_chrome_trace(path)


def cost_analysis(fn, *args, **kwargs) -> dict:
    """{"flops": total, "by_op": {op name: flops}} of ``fn(*args,
    **kwargs)``, run once."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(counter.get_total_flops()), "by_op": by_op}


# ops whose output is memory not yet written: a NaN bit pattern there is
# not a result
_UNWRITTEN = ("empty", "new_empty", "empty_like", "empty_strided")


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError where an op's floating output holds a
    NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNWRITTEN:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_checks():
    """Anomaly mode (NaN checks in the backward) and a NaN check on every
    op's output while entered; the earlier anomaly settings after."""
    old = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.set_anomaly_enabled(True, True)
    try:
        with _NanCheck():
            yield
    finally:
        torch.set_anomaly_enabled(*old)
