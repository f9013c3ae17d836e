"""The three-way bf16 split of an fp32 weight that K5's bf16 mode
(``csrc/pg.cu``) makes in its prologue, stated by ``pg_kernel.split3``:
the planes sum to the weight bit for bit, so a bf16 activation times the
three planes, each product exact, is the fp32 product. Policy weights from
the parity tests' generator, scaled over six decades.

Also the fp64 evaluation (``surrogate_grad_fp64``) that the card test
holds the kernel to: it passes the plain version and fails weights
rounded to fewer planes."""
import numpy as np
import pytest
import torch

from test_torch_helpers import (PG_G_KEPT_REL, PG_MU_FP64_ATOL,
                                pg_fp64_errors, policy_params_np,
                                surrogate_grad_fp64)
from trpo_robot_control_tpu_torch.models import policy
from trpo_robot_control_tpu_torch.ops.cuda.pg_kernel import split3

SCALES = [1e-3, 1e-2, 1e-1, 1.0, 1e1, 1e2, 1e3]


def _weights(scale):
    pn = policy_params_np(np.random.RandomState(7), 27, 7)
    w = np.concatenate([pn[k].ravel() for k in ("W0", "W1", "W2")])
    return torch.tensor((w * np.float32(scale)).astype(np.float32))


@pytest.mark.parametrize("scale", SCALES)
def test_split3_planes_sum_to_the_weight(scale):
    w = _weights(scale)
    hi, mid, lo = split3(w)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # in fp64 and in the fp32 order the kernel's sums take
    assert torch.equal(hi.double() + mid.double() + lo.double(), w.double())
    assert torch.equal((hi.float() + mid.float()) + lo.float(), w)
    # each plane is below half an ulp of the one before, as round-to-
    # nearest leaves it (2^-8 relative in bf16)
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all())
    assert bool((lo.float().abs() <= mid.float().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("scale", SCALES)
def test_split3_products_are_exact(scale):
    w = _weights(scale)
    rng = np.random.RandomState(8)
    x = torch.tensor(np.tanh(rng.standard_normal(w.shape))
                     .astype(np.float32)).to(torch.bfloat16)
    hi, mid, lo = split3(w)
    xd = x.double()
    three = xd * hi.double() + xd * mid.double() + xd * lo.double()
    assert torch.equal(three, xd * w.double())
    # one bf16 plane alone is not the product: the split is needed
    assert not torch.equal(xd * hi.double(), xd * w.double())


def _batch(T, do, N):
    g = torch.Generator().manual_seed(2)
    pc = {k: torch.tensor(v) for k, v in
          policy_params_np(np.random.RandomState(11), do, 7).items()}
    obs = torch.randn(T, do, N, generator=g).to(torch.bfloat16)
    act = torch.randn(T, 7, N, generator=g).to(torch.bfloat16)
    return pc, obs, act, torch.randn(T, N, generator=g)


def _errors(weights, pc, obs, act, adv):
    ref = surrogate_grad_fp64(pc, obs, act, adv)
    _, mu, _ = policy.surrogate_grad_ff(weights, obs, act, adv,
                                        store_dtype=torch.bfloat16)
    g_m, _, _ = policy.surrogate_grad_ff(weights, obs, act,
                                         adv * ref["kept"],
                                         store_dtype=torch.bfloat16)
    return ref, pg_fp64_errors(ref, mu, g_m)


# The card test holds K5's bf16 mode to the fp64 evaluation so; these
# show on the CPU that the check passes an fp32 implementation with the
# exact weights (the plain version) ...
@pytest.mark.parametrize("do", [24, 27])
def test_fp64_evaluation_holds_the_plain_version(do):
    pc, obs, act, adv = _batch(6, do, 200)
    ref, (mu_over, g_rel) = _errors(pc, pc, obs, act, adv)
    assert mu_over <= PG_MU_FP64_ATOL and g_rel <= PG_G_KEPT_REL
    assert float(ref["kept"].double().mean()) > 0.3


# ... and fails one whose weights are rounded to two bf16 planes (hi +
# mid, 2^-17 relative) or to one
@pytest.mark.parametrize("planes", [2, 1])
def test_fp64_evaluation_rejects_inexact_weights(planes):
    pc, obs, act, adv = _batch(6, 24, 200)
    w = dict(pc)
    for k in ("W0", "W1"):
        w[k] = sum(p.float() for p in split3(pc[k])[:planes])
        assert not torch.equal(w[k], pc[k])
    _, (mu_over, g_rel) = _errors(w, pc, obs, act, adv)
    assert mu_over > 10 * PG_MU_FP64_ATOL and g_rel > 5 * PG_G_KEPT_REL
