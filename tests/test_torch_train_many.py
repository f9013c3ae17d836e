"""``make_train_many`` (``trpo/train.py``, the port of JAX's K-step train
loop) on the CPU, at small shapes: K steps in one call equal K calls of
``make_train_step`` bit for bit (parameters, baseline weights, every stat)
at a small c1, a small c3 with bf16 storage, a small c2 with the MLP
baseline and a small terminating c2; two calls equal 2K eager steps; the
stacked stats carry JAX's keys with shape (K,); a mesh is refused. The
card's graph replay is held to the eager loop in ``test_torch_cuda.py``
and ``chip_smoke.py``."""
import dataclasses

import pytest
import torch

from test_torch_helpers import state_leaves
from trpo_robot_control_tpu.configs import C1_REACHER2 as J_C1
from trpo_robot_control_tpu.trpo.train import init_state as j_init_state
from trpo_robot_control_tpu.trpo.train import \
    make_train_many as j_make_train_many
from trpo_robot_control_tpu_torch.configs import (C1_REACHER2, C2_REACHER3,
                                                  C3_FRANKA7)
from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                     make_train_many,
                                                     make_train_step)

torch.set_num_threads(1)
K = 3


def _mlp(cfg):
    return cfg.replace(trpo=dataclasses.replace(
        cfg.trpo, baseline="mlp", baseline_hidden=(16,)))


CONFIGS = {
    "c1": C1_REACHER2.replace(n_envs=16, horizon=10),
    "c3_bf16": C3_FRANKA7.replace(n_envs=16, horizon=16),
    "c2_mlp": _mlp(C2_REACHER3.replace(n_envs=16, horizon=12)),
    "c2_term": C2_REACHER3.replace(n_envs=16, horizon=12, done_dist=0.25),
}


def _eager(cfg, state, n):
    step = make_train_step(cfg)
    rows = []
    for _ in range(n):
        state, stats = step(state)
        rows.append(stats)
    return state, rows


def _assert_same(state, stacked, ref_state, ref_rows):
    assert state.iteration == ref_state.iteration
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(state),
                                                 state_leaves(ref_state)))
    assert set(stacked) == set(ref_rows[0])
    for k, v in stacked.items():
        ref = torch.stack([r[k] for r in ref_rows])
        assert v.shape == (len(ref_rows),) and v.dtype == ref.dtype, k
        assert torch.equal(v, ref), (k, v, ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_many_equals_eager_steps(name):
    cfg = CONFIGS[name]
    ref_state, ref_rows = _eager(cfg, init_state(cfg, seed=1, device="cpu"),
                                 K)
    state, stacked = make_train_many(cfg, K)(
        init_state(cfg, seed=1, device="cpu"))
    _assert_same(state, stacked, ref_state, ref_rows)
    assert state.iteration == K
    if cfg.done_dist > 0.0:
        assert "early_dones" in stacked


def test_two_calls_equal_2k_eager_steps():
    cfg = CONFIGS["c1"]
    fn = make_train_many(cfg, K)
    state, first = fn(init_state(cfg, seed=2, device="cpu"))
    state, second = fn(state)
    ref_state, ref_rows = _eager(cfg, init_state(cfg, seed=2, device="cpu"),
                                 2 * K)
    _assert_same(state, {k: torch.cat([first[k], second[k]]) for k in first},
                 ref_state, ref_rows)


def test_stacked_stats_carry_jax_keys():
    """One JAX ``make_train_many`` call at a tiny c1, n_steps 2, on the
    CPU: the same keys, each of shape (2,), and the iteration count."""
    jcfg = J_C1.replace(n_envs=8, horizon=10)
    j_state, j_stats = j_make_train_many(jcfg, 2)(j_init_state(jcfg, seed=0))
    cfg = C1_REACHER2.replace(n_envs=8, horizon=10)
    state, stats = make_train_many(cfg, 2)(init_state(cfg, seed=0,
                                                      device="cpu"))
    assert set(stats) == set(j_stats)
    assert all(tuple(v.shape) == (2,) for v in stats.values())
    assert all(tuple(v.shape) == (2,) for v in j_stats.values())
    assert state.iteration == int(j_state.iteration) == 2


def test_train_many_over_a_mesh_refuses_uneven_envs():
    """Over a mesh (``parallel/mesh.py``), ``n_envs`` must split evenly over
    the data axis (JAX ``parallel/mesh.py:118-120``); the check comes
    before any collective (``tests/test_torch_sharding.py`` runs the mesh
    path itself)."""
    from trpo_robot_control_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(group=None, shape={"data": 3, "model": 1}, rank=0,
                device=torch.device("cpu"))
    with pytest.raises(ValueError, match="evenly"):
        make_train_many(CONFIGS["c1"], K, mesh=mesh)
