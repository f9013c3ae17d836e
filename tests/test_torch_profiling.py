"""The port's ``utils/profiling.py`` (JAX ``utils/profiling.py``): ``trace``
writes a Chrome trace of a train step, ``cost_analysis`` counts the policy
forward's matrix-product FLOPs, ``debug_checks`` raises on a NaN and leaves
the anomaly settings as it found them, and trains c5 (JAX
``tests/test_multitask.py:69``) the same as without it. CPU, small shapes.
"""
import json

import pytest
import torch

from trpo_robot_control_tpu_torch.configs import C1_REACHER2, C5_MULTITASK
from trpo_robot_control_tpu_torch.models import policy
from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                     make_train_step, train)
from trpo_robot_control_tpu_torch.utils.profiling import (cost_analysis,
                                                          debug_checks,
                                                          trace)

C1_TINY = C1_REACHER2.replace(n_envs=8, horizon=5)


def test_trace_writes_a_chrome_trace_of_the_step(tmp_path):
    """Every layer range of the update (``trpo/...``) is in the exported
    trace, and the profiler handed out holds them too."""
    state = init_state(C1_TINY, device="cpu")
    path = tmp_path / "step.json"
    with trace(str(path)) as prof:
        make_train_step(C1_TINY)(state)
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    ranges = {"trpo/rollout", "trpo/values_gae", "trpo/baseline_fit",
              "trpo/surrogate_grad", "trpo/cg_fvp", "trpo/line_search"}
    assert ranges <= names
    assert ranges <= {e.key for e in prof.key_averages()}


def test_cost_analysis_counts_the_policy_forward():
    """c1's (64, 64) policy on B samples: 2 B (do H0 + H0 H1 + H1 da)
    FLOPs, its three products, as FlopCounterMode counts matrix products."""
    params = init_state(C1_TINY, device="cpu").params
    B, do, da = 7, C1_TINY.obs_dim, C1_TINY.arm.n_joints
    H0, H1 = C1_TINY.trpo.hidden
    cost = cost_analysis(policy.mean_net, params, torch.zeros(B, do))
    assert cost["flops"] == 2 * B * (do * H0 + H0 * H1 + H1 * da)
    assert sum(cost["by_op"].values()) == cost["flops"]


def test_debug_checks_raise_on_a_nan_and_restore_the_state():
    """A NaN out of any op raises FloatingPointError naming it; anomaly mode
    is on inside and as it was after (also after the raise)."""
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    with pytest.raises(FloatingPointError, match="log"):
        with debug_checks():
            assert torch.is_anomaly_enabled()
            torch.log(torch.tensor([-1.0]))
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == before
    with debug_checks():
        torch.empty(64)            # unwritten memory is not a result
        torch.log(torch.tensor([2.0]))
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_multitask_training_runs_with_debug_checks():
    """JAX tests/test_multitask.py:69 at c5 64 envs x 16 steps, 2
    iterations: finite returns, and the same stats as without the checks."""
    cfg = C5_MULTITASK.replace(n_envs=64, horizon=16)
    with debug_checks():
        _, hist = train(cfg, n_iters=2, seed=0, device="cpu")
    _, plain = train(cfg, n_iters=2, seed=0, device="cpu")
    assert all(torch.isfinite(torch.tensor(h["mean_return"])) for h in hist)
    assert [{k: v for k, v in h.items() if k != "wall_s"} for h in hist] \
        == [{k: v for k, v in h.items() if k != "wall_s"} for h in plain]
