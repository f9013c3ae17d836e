"""The update's cross-rank reductions (JAX ``jax.lax.psum`` / ``pmean`` over
the mesh's 'data' axis, ``trpo/update.py:27-32`` there).

``group`` is the mesh's 'data' process group (``parallel/mesh.py``), or
None outside a mesh, where every helper returns its input as it is: the
unsharded path runs no collective and no copy. Over a group each call is
one ``all_reduce`` SUM of a contiguous copy (gloo has no AVG, so the mean
divides by the group's size afterwards; over a world of one the sum is the
input and the division by 1 exact, so a world of one computes the unsharded
update bit for bit). Every rank receives the same bits, so whatever the
ranks compute from a reduction stays identical across them. Each call
counts in ``all_reduce.calls`` and ``all_reduce.bytes``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """The number of ranks on ``group``'s axis; 1 outside a mesh."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x, group):
    """The sum of ``x`` over ``group``'s ranks, in a new tensor; a failed
    collective raises."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    all_reduce.calls += 1
    all_reduce.bytes += y.numel() * y.element_size()
    return y


all_reduce.calls = 0
all_reduce.bytes = 0


def reset_counts() -> None:
    all_reduce.calls = 0
    all_reduce.bytes = 0


def _reduce(xs, group, mean: bool):
    if group is None:
        return xs
    if isinstance(xs, torch.Tensor):
        y = all_reduce(xs, group)
        return y / group_size(group) if mean else y
    # several tensors of one dtype: one all_reduce of their concatenation
    sizes = [x.numel() for x in xs]
    y = _reduce(torch.cat([x.reshape(-1) for x in xs]), group, mean)
    return [part.view(x.shape) for part, x in zip(torch.split(y, sizes), xs)]


def psum(xs, group):
    """The sum over the group of a tensor, or of each tensor of a sequence
    (a list back, from one collective); ``xs`` itself outside a mesh."""
    return _reduce(xs, group, mean=False)


def pmean(xs, group):
    """The mean over the group, as ``psum``."""
    return _reduce(xs, group, mean=True)
