"""Early termination in the 7-DoF slice on the CPU: K4's plain version on
the draws that JAX's terminating rollout made, at c4 (obstacle) and c5
(three task families, whose fresh episodes redraw the task), and the c5
update on that batch against JAX's (``tests/test_parity.py``'s criteria).

Obs and actions agree within 5e-4 and rewards within 2e-3, the bounds of
the fused component math against the generic RNEA path
(``test_torch_rollout3d.py``); the done flags must be identical. The
done distance 0.4 gives early dones within 16 steps at N = 64 (c4 6, c5
13 with these seeds)."""
import functools

import pytest

from test_torch_helpers import (check_against_jax, check_update_parity,
                                jax_ff_batch)


@functools.lru_cache(maxsize=None)
def _c5():
    return check_against_jax("c5_multitask", 64, 16, 0.4, 5, 5e-4, 2e-3)


@pytest.mark.parametrize("name", ["c4_franka7_obstacle", "c5_multitask"])
def test_rollout3d_plain_terminates_as_jax(name):
    if name == "c5_multitask":
        _c5()
    else:
        check_against_jax(name, 64, 16, 0.4, 4, 5e-4, 2e-3)


def test_update_parity_on_a_terminating_batch_c5():
    """bf16 storage, Fisher strides 8 and 8, the line search on every 8th
    env; the batch has resets that redrew the task family."""
    _, jcfg, pcfg, pn, bj = _c5()
    check_update_parity(jcfg, pcfg, pn, jax_ff_batch(jcfg, bj))
