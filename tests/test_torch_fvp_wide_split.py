"""K3's wide form's arithmetic (``csrc/fvp.cu``, ``namespace wide``: a
hidden layer over 64 units) stated in PyTorch
(``test_torch_helpers.gn_fvp_wide_split``): per sample the forward tangent,
the head, u and the reverse chain with every hidden layer's fp32 operands
split into three bf16 planes and the six plane products that hold fp32's
24 bits summed (hi hi on its own), then each layer's [a; 1]^T g over
chunks of samples within the grad launch's splits, the splits summed in
the reduce pass's order. On the CPU, at small batches with a ragged tail,
it is held to the plain version, to the JAX package's ``make_gn_fvp`` and
once to its Pallas kernel in interpret mode (whose widths take the
unpacked ``_fvp_kernel``); hi hi alone misses the bound, so the check has
teeth. The card test and ``chip_smoke.py`` hold the kernel to the same
statement."""
import numpy as np
import pytest
import torch

from jax.flatten_util import ravel_pytree

from chip_smoke import K3_SPLIT_REL
from test_torch_helpers import (gn_fvp_wide_split, j, n, policy_params_np,
                                t)
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.pallas.fvp_kernel import make_pallas_gn_fvp
from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel

WIDE = [(65,), (100, 50, 25), (128, 128, 128)]
B_SUB = 1100       # two default splits of 512 and a ragged third of 76


def _inputs(hidden, do, da, B=B_SUB, seed=41):
    rng = np.random.RandomState(seed)
    pn = policy_params_np(np.random.RandomState(seed + 1), do, da, hidden)
    obs = rng.standard_normal((B, do)).astype(np.float32)
    v = rng.standard_normal(sum(x.size for x in pn.values())) \
        .astype(np.float32)
    pc = {k: t(x) for k, x in pn.items()}
    hs = fvp_kernel.activations(pc, t(obs))
    scale = torch.exp(-2.0 * pc["logstd"]) / B
    return pn, pc, obs, hs, scale, v


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("hidden", WIDE)
@pytest.mark.parametrize("do,da", [(12, 3), (27, 7)])
def test_wide_statement_matches_plain_and_jax(hidden, do, da):
    """c2's widths and the other instantiations' (do > 16, da > 4)."""
    pn, pc, obs, hs, scale, v = _inputs(hidden, do, da)
    f_s = gn_fvp_wide_split(pc, t(obs), hs, t(v), 0.1)
    f_p = fvp_kernel.gn_fvp_plain(pc, t(obs), hs, scale, t(v), 0.1)
    pj = {k: j(x) for k, x in pn.items()}
    f_j = np.asarray(j_make_gn_fvp(pj, ravel_pytree(pj)[1], j(obs),
                                   0.1)(j(v)))
    assert _rel(n(f_s), n(f_p)) <= K3_SPLIT_REL
    assert _rel(n(f_s), f_j) <= K3_SPLIT_REL


def test_wide_statement_matches_pallas_interpret():
    """Once against ``make_pallas_gn_fvp`` in interpret mode at
    (100, 50, 25), which takes its unpacked ``_fvp_kernel``, with a padded
    tail (300 samples in blocks of 128)."""
    pn, pc, obs, hs, scale, v = _inputs((100, 50, 25), 12, 3, B=300)
    pj = {k: j(x) for k, x in pn.items()}
    f_pal = np.asarray(make_pallas_gn_fvp(pj, ravel_pytree(pj)[1], j(obs),
                                          damping=0.1, block_b=128,
                                          interpret=True)(j(v)))
    f_s = gn_fvp_wide_split(pc, t(obs), hs, t(v), 0.1)
    assert _rel(n(f_s), f_pal) <= K3_SPLIT_REL


@pytest.mark.parametrize("hidden", WIDE)
def test_hi_hi_alone_misses_the_bound(hidden):
    """Only the hi hi plane products (one bf16 product per fp32 one) miss
    K3_SPLIT_REL by far: the checks can tell."""
    pn, pc, obs, hs, scale, v = _inputs(hidden, 12, 3)
    f_p = fvp_kernel.gn_fvp_plain(pc, t(obs), hs, scale, t(v), 0.1)
    f_s = gn_fvp_wide_split(pc, t(obs), hs, t(v), 0.1, pairs=((0, 0),))
    assert _rel(n(f_s), n(f_p)) > 100 * K3_SPLIT_REL


@pytest.mark.parametrize("B", [1, 33, 700])
def test_wide_statement_splits_and_ragged_chunks(B):
    """The splits and chunks do not move the statement: one split, two,
    or as many as the grid takes, with one sample, a chunk and a sample,
    and a ragged last chunk."""
    pn, pc, obs, hs, scale, v = _inputs((100, 50, 25), 12, 3, B=B, seed=B)
    f_p = fvp_kernel.gn_fvp_plain(pc, t(obs), hs, scale, t(v), 0.1)
    for splits in (1, 2, fvp_kernel.MAX_BLOCKS):
        f_s = gn_fvp_wide_split(pc, t(obs), hs, t(v), 0.1, splits=splits)
        assert _rel(n(f_s), n(f_p)) <= K3_SPLIT_REL


def test_wide_workspace_sizes():
    """The wide form's planes: each hidden-to-hidden W_l twice (as W_l and
    W_l^T), v's blocks with dW0's rows padded to 16; the tile is a split
    of the grad launch."""
    assert fvp_kernel.plane_sizes((100, 50, 25), 24) == (
        6 * (112 * 64 + 64 * 32), 3 * (32 * 112 + 112 * 64 + 64 * 32))
    assert fvp_kernel.plane_sizes((65,), 9) == (0, 3 * 16 * 80)
    assert fvp_kernel.plane_sizes((64, 64), 12) == (
        3 * 64 * 64, 3 * (12 * 64 + 64 * 64))
