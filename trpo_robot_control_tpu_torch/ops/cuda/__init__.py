"""Hand-written CUDA kernels for Hopper (``sm_90a``), bound with ctypes.

Each ``*_kernel`` module holds one kernel's wrapper, which counts its
launches in ``<wrapper>.launches``, and the plain PyTorch version of the
same function, which counts its calls in ``<plain>.calls``. Importing this
package builds nothing: ``build.library`` compiles at first use.
"""
from __future__ import annotations

from . import (fit_kernel, fvp_ff_kernel, fvp_kernel, moments_kernel,
               pg_kernel, rollout3d_kernel, rollout_kernel)

WRAPPERS = {"rollout": rollout_kernel.rollout,
            "moments": moments_kernel.extended_gram,
            "fvp": fvp_kernel.gn_fvp,
            "rollout3d": rollout3d_kernel.rollout3d,
            "pg": pg_kernel.surrogate_grad,
            "fvp_ff": fvp_ff_kernel.gn_fvp_ff,
            "fit_normal": fit_kernel.fit_normal}
PLAIN = {"rollout": rollout_kernel.rollout_plain,
         "moments": moments_kernel.extended_gram_plain,
         "fvp": fvp_kernel.gn_fvp_plain,
         "rollout3d": rollout3d_kernel.rollout3d_plain,
         "pg": pg_kernel.surrogate_grad_plain,
         "fvp_ff": fvp_ff_kernel.gn_fvp_ff_plain,
         "fit_normal": fit_kernel.fit_normal_plain}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in PLAIN.values():
        fn.calls = 0


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def plain_calls() -> dict:
    return {k: fn.calls for k, fn in PLAIN.items()}
