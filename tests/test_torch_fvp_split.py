"""K6's tensor-core arithmetic (``csrc/fvp_ff.cu``) stated in PyTorch
(``test_torch_helpers.gn_fvp_ff_split``): every fp32 operand split into
three bf16 planes by ``pg_kernel.split3``, the six plane products that
hold fp32's 24 bits summed in fp64 and rounded where the kernel's
accumulators round. On the CPU, at small shapes, it is held to the plain
version and to the JAX package's ``make_gn_fvp`` on the same numpy inputs;
schemes with fewer plane products miss the bounds, so the checks have
teeth. The card test holds the kernel to the same statement."""
import numpy as np
import pytest
import torch

from jax.flatten_util import ravel_pytree

from chip_smoke import K6_REL
from test_torch_helpers import gn_fvp_ff_split, j, n, policy_params_np, t
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu_torch.ops.cuda import fvp_ff_kernel

# the statement against the fp32 function (the six products leave one
# fp32 rounding per product; the plain version's own sums are ~2e-7 from
# fp64)
SPLIT_REL = 1e-6
T_SUB, N_SUB, DA = 2, 96, 7


def _inputs(do, dtype, seed=12):
    rng = np.random.RandomState(seed)
    pn = policy_params_np(np.random.RandomState(5), do, DA)
    obs = rng.standard_normal((8 * T_SUB, do, N_SUB)).astype(np.float32)
    sub = t(obs).to(dtype)[::8]
    v = rng.standard_normal(sum(x.size for x in pn.values())) \
        .astype(np.float32)
    return pn, sub, v


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("do", [24, 27])
def test_split_statement_matches_plain_and_jax(do, dtype):
    pn, sub, v = _inputs(do, dtype)
    pc = {k: t(x) for k, x in pn.items()}
    f_s = gn_fvp_ff_split(pc, sub, t(v), 0.1)
    f_p = fvp_ff_kernel.gn_fvp_ff_plain(pc, sub, t(v), 0.1)
    pj = {k: j(x) for k, x in pn.items()}
    _, unravel = ravel_pytree(pj)
    flat = sub.float().permute(0, 2, 1).reshape(-1, do)
    f_j = np.asarray(j_make_gn_fvp(pj, unravel, j(flat), 0.1)(j(v)))
    assert _rel(n(f_s), n(f_p)) <= SPLIT_REL
    assert _rel(n(f_s), f_j) <= SPLIT_REL


@pytest.mark.parametrize("pairs,bound", [
    (((0, 0),), K6_REL),                        # hi hi alone: ~2.7e-3
    (((0, 0), (0, 1), (1, 0)), SPLIT_REL),      # no 2^-16 terms: ~4e-6
])
def test_fewer_plane_products_miss_the_bound(pairs, bound):
    """hi hi alone fails the card's K6_REL; dropping the three 2^-16
    terms (hi lo, lo hi, mid mid) stays inside K6_REL but fails the
    statement's own 1e-6."""
    pn, sub, v = _inputs(27, torch.bfloat16)
    pc = {k: t(x) for k, x in pn.items()}
    f_p = fvp_ff_kernel.gn_fvp_ff_plain(pc, sub, t(v), 0.1)
    f_s = gn_fvp_ff_split(pc, sub, t(v), 0.1, pairs=pairs)
    assert _rel(n(f_s), n(f_p)) > 2 * bound


def test_split_statement_blocks_and_ragged_tiles():
    """The per-block sums and the reduce order do not move the statement:
    one block over all tiles, or a tile per block, with a ragged last
    tile (N' = 70)."""
    pn, sub, v = _inputs(24, torch.bfloat16)
    sub = sub[:, :, :70]
    pc = {k: t(x) for k, x in pn.items()}
    f_p = fvp_ff_kernel.gn_fvp_ff_plain(pc, sub, t(v), 0.1)
    for blocks in (1, 3, 132):
        f_s = gn_fvp_ff_split(pc, sub, t(v), 0.1, blocks=blocks)
        assert _rel(n(f_s), n(f_p)) <= SPLIT_REL
