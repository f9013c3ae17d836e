"""K3's tensor-core arithmetic (``csrc/fvp.cu``) stated in PyTorch
(``test_torch_helpers.gn_fvp_split``): the hidden activations read as
given, every fp32 operand of the six 64-wide products split into three
bf16 planes by ``pg_kernel.split3``, the six plane products that hold
fp32's 24 bits summed in fp64 and rounded where the kernel's accumulators
round, in the kernel's tiles of 128 samples and its reduce order. On the
CPU, at small shapes with a ragged last tile, it is held to the plain
version, to the JAX package's ``make_gn_fvp`` and to its Pallas kernel
``make_pallas_gn_fvp`` in interpret mode, on the same numpy inputs; hi hi
alone misses the bounds, so the checks have teeth. The card test holds the
kernel to the same statement."""
import numpy as np
import pytest
import torch

from jax.flatten_util import ravel_pytree

from chip_smoke import K3_REL
from test_torch_helpers import gn_fvp_split, j, n, policy_params_np, t
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.pallas.fvp_kernel import make_pallas_gn_fvp
from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel

# the statement against the fp32 function (the six products leave one
# fp32 rounding per product; the plain version's own sums are ~2e-7 from
# fp64)
SPLIT_REL = 1e-6
B_SUB = 200                    # a full tile of 128 and a ragged one of 72


def _inputs(do, da, seed=21):
    rng = np.random.RandomState(seed)
    pn = policy_params_np(np.random.RandomState(seed + 1), do, da)
    obs = rng.standard_normal((B_SUB, do)).astype(np.float32)
    v = rng.standard_normal(sum(x.size for x in pn.values())) \
        .astype(np.float32)
    pc = {k: t(x) for k, x in pn.items()}
    hs = fvp_kernel.activations(pc, t(obs))
    scale = torch.exp(-2.0 * pc["logstd"]) / B_SUB
    return pn, pc, obs, hs, scale, v


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("do,da", [(9, 2), (12, 3)])
def test_split_statement_matches_plain_and_jax(do, da):
    """c1's and c2's widths (do 9, da 2 and do 12, da 3)."""
    pn, pc, obs, hs, scale, v = _inputs(do, da)
    f_s = gn_fvp_split(pc, t(obs), hs, t(v), 0.1)
    f_p = fvp_kernel.gn_fvp_plain(pc, t(obs), hs, scale, t(v), 0.1)
    pj = {k: j(x) for k, x in pn.items()}
    _, unravel = ravel_pytree(pj)
    f_j = np.asarray(j_make_gn_fvp(pj, unravel, j(obs), 0.1)(j(v)))
    f_pal = np.asarray(make_pallas_gn_fvp(pj, unravel, j(obs), damping=0.1,
                                          block_b=128, interpret=True)(j(v)))
    assert _rel(n(f_s), n(f_p)) <= SPLIT_REL
    assert _rel(n(f_s), f_j) <= SPLIT_REL
    assert _rel(n(f_s), f_pal) <= SPLIT_REL


def test_hi_hi_alone_misses_the_bound():
    """Only the hi hi plane products (one bf16 product per fp32 one) fail
    the card's K3_REL by far: the check on the card can tell."""
    pn, pc, obs, hs, scale, v = _inputs(12, 3)
    f_p = fvp_kernel.gn_fvp_plain(pc, t(obs), hs, scale, t(v), 0.1)
    f_s = gn_fvp_split(pc, t(obs), hs, t(v), 0.1, pairs=((0, 0),))
    assert _rel(n(f_s), n(f_p)) > 2 * K3_REL


@pytest.mark.parametrize("B", [1, 129, 300])
def test_split_statement_blocks_and_ragged_tiles(B):
    """The per-block sums and the reduce order do not move the statement:
    one block over all tiles, or a tile per block, with one sample, a last
    tile of one sample, and three tiles."""
    pn, pc, obs, hs, scale, v = _inputs(12, 3)
    rng = np.random.RandomState(B)
    obs = t(rng.standard_normal((B, 12)).astype(np.float32))
    hs = fvp_kernel.activations(pc, obs)
    scale = torch.exp(-2.0 * pc["logstd"]) / B
    f_p = fvp_kernel.gn_fvp_plain(pc, obs, hs, scale, t(v), 0.1)
    for blocks in (1, 2, 132):
        f_s = gn_fvp_split(pc, obs, hs, t(v), 0.1, blocks=blocks)
        assert _rel(n(f_s), n(f_p)) <= SPLIT_REL
