"""The update's cross-rank reductions (JAX ``jax.lax.psum`` / ``pmean`` over
the mesh's axes, ``trpo/update.py:27-32`` and ``parallel/tensor.py``
there).

``group`` is one of the mesh's process groups (``parallel/mesh.py``: the
'data' group, or on the tensor-parallel path the 'model' group), or None
outside a mesh or over an axis of size one, where every helper returns its
input as it is: no collective and no copy. Over a group each call is one
``all_reduce`` SUM of a contiguous copy (gloo has no AVG, so the mean
divides by the group's size afterwards; over a world of one the sum is the
input and the division by 1 exact, so a world of one computes the unsharded
update bit for bit). Every rank receives the same bits, so whatever the
ranks compute from a reduction stays identical across them. Each call
counts in ``all_reduce.calls`` and ``all_reduce.bytes``, and in
``all_reduce.by_group[group]`` ([calls, bytes]) for its group.

``model_sum`` is the tensor-parallel forward's sum over the 'model' group
as an autograd function whose backward is the identity (Megatron's "g"):
everything after the sum is the same on every model rank, so each rank's
partial sum receives the output's cotangent as it is. An all-reduce in the
backward too (``torch.distributed.nn.functional.all_reduce``) would scale
the sharded leaves' gradients by the group's size, the fault JAX's
``parallel/tensor.py:64-68`` warns of.
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
    nbytes = y.numel() * y.element_size()
    all_reduce.calls += 1
    all_reduce.bytes += nbytes
    tally = all_reduce.by_group.setdefault(group, [0, 0])
    tally[0] += 1
    tally[1] += nbytes
    return y


def reset_counts() -> None:
    all_reduce.calls = 0
    all_reduce.bytes = 0
    all_reduce.by_group = {}


reset_counts()


def group_counts(group) -> tuple:
    """(calls, bytes) of the all-reduces over ``group`` since the last
    ``reset_counts``; (0, 0) for None."""
    return tuple(all_reduce.by_group.get(group, (0, 0)))


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


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_sum(x, group):
    """The sum of ``x`` over the 'model' group, its backward the identity
    (the module's docstring); ``x`` itself without a group."""
    return x if group is None else _ModelSum.apply(x, group)
