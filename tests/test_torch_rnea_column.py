"""The 3-D rollout kernel's specialised RNEA passes, stated in PyTorch
(``rollout3d_kernel.column_pass`` / ``bias_pass``), against the plain
version's fused sweep (``_mass_bias_fused``) on the CPU, bit for bit:
column j starts at joint j with no angular-velocity terms and no
gravity, the bias pass drops its zero-acceleration terms, and both leave
out only terms that are exactly +-0 in the fused sweep."""
import numpy as np
import pytest
import torch

from trpo_robot_control_tpu_torch.configs import C3_FRANKA7
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3

# one thread, as test_torch_helpers.py pins it: the suite runs under xdist
torch.set_num_threads(1)


def _sweep(seed):
    c = r3.arm3d_consts(C3_FRANKA7)
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.uniform(-np.pi, np.pi, (c.n, 256))
                         .astype(np.float32))
    qd = list(torch.from_numpy(rng.uniform(-3.0, 3.0, (c.n, 256))
                               .astype(np.float32)))
    R, p, axis, _ = r3._fk3(c, list(torch.cos(q)), list(torch.sin(q)))
    return c, R, p, axis, qd


@pytest.mark.parametrize("j", range(7))
def test_column_pass_is_column_j_of_the_fused_sweep(j):
    c, R, p, axis, qd = _sweep(0)
    M, _ = r3._mass_bias_fused(c, R, p, axis, qd)
    col = r3.column_pass(c, r3.pass_frames(c, R, p, axis), j)
    assert len(col) == j + 1
    for i in range(j + 1):
        assert torch.equal(col[i], M[(i, j)]), (i, j)


def test_bias_pass_is_the_fused_sweeps_bias_row():
    c, R, p, axis, qd = _sweep(1)
    M, bias = r3._mass_bias_fused(c, R, p, axis, qd)
    M_s, bias_s = r3.mass_bias_split(c, R, p, axis, qd)
    assert M_s.keys() == M.keys()
    assert all(torch.equal(M_s[k], M[k]) for k in M)
    assert all(torch.equal(a, b) for a, b in zip(bias_s, bias))
