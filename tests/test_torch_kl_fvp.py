"""The KL-Hessian FVP (``fvp_impl="kl"`` / ``fvp_form="kl"``) on the CPU
against the JAX package: the port's ``make_kl_fvp`` against JAX's
``make_kl_fvp`` and against the port's GN form, within JAX's own
tolerance (``tests/test_parity.py``); the update routed through it as JAX
routes it, held to JAX's ``trpo_update(..., fvp_form="kl")`` by the port's
update contract; and the switch values the port honours, the others
refused on the card (``tests/test_torch_cuda.py`` runs that there)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

from test_torch_helpers import (cosine, env_inputs_np, j, jax_batch,
                                jax_init_params_np, n, policy_params_np, t,
                                torch_batch_from_jax)
from trpo_robot_control_tpu.configs import C1_REACHER2 as J_C1
from trpo_robot_control_tpu.ops.fvp import make_kl_fvp as j_make_kl_fvp
from trpo_robot_control_tpu.trpo.update import trpo_update as j_trpo_update
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops import fvp as pfvp
from trpo_robot_control_tpu_torch.trpo.train import init_state
from trpo_robot_control_tpu_torch.trpo.update import (HONOURED,
                                                      check_switch,
                                                      kernel_routes,
                                                      trpo_update)
from trpo_robot_control_tpu_torch.utils.convert import (params_from_numpy,
                                                        w_from_numpy)

RLLAB = (100, 50, 25)
# JAX's own bounds for its two FVP forms (tests/test_parity.py)
RTOL, ATOL = 2e-4, 2e-6


def _fvp_case(hidden, seed):
    rng = np.random.RandomState(seed)
    pn = policy_params_np(rng, 12, 3, hidden)
    obs = rng.standard_normal((300, 12)).astype(np.float32)
    vs = [rng.standard_normal(sum(x.size for x in pn.values()))
          .astype(np.float32) for _ in range(2)]
    return pn, obs, vs


@pytest.mark.parametrize("hidden", [(64, 64), RLLAB])
def test_kl_fvp_matches_jax(hidden):
    """The port's ``make_kl_fvp`` against JAX's on the same inputs, at a
    2-layer policy and at rllab's (100, 50, 25)."""
    pn, obs, vs = _fvp_case(hidden, 81)
    pj = {k: j(v) for k, v in pn.items()}
    f_j = j_make_kl_fvp(pj, ravel_pytree(pj)[1], j(obs), 0.1)
    f_t = pfvp.make_kl_fvp({k: t(v) for k, v in pn.items()}, t(obs), 0.1)
    for v in vs:
        np.testing.assert_allclose(n(f_t(t(v))), np.asarray(f_j(j(v))),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [(64, 64), RLLAB])
def test_kl_fvp_matches_gn_fvp(hidden):
    """The two forms agree at theta = theta_old, as in JAX."""
    pn, obs, vs = _fvp_case(hidden, 82)
    pc = {k: t(v) for k, v in pn.items()}
    f_kl = pfvp.make_kl_fvp(pc, t(obs), 0.1)
    f_gn = pfvp.make_gn_fvp(pc, t(obs), 0.1)
    for v in vs:
        np.testing.assert_allclose(n(f_kl(t(v))), n(f_gn(t(v))), rtol=RTOL,
                                   atol=ATOL)


def _c1(**trpo):
    N, T = 64, 10
    return tuple(base.replace(n_envs=N, horizon=T,
                              trpo=dataclasses.replace(base.trpo, **trpo))
                 for base in (J_C1, pconfigs.C1_REACHER2))


@pytest.mark.parametrize("how", ["fvp_impl", "fvp_form"])
def test_update_takes_kl_fvp_as_jax_does(how):
    """A small c1 update with ``fvp_impl="kl"``, or with the default
    switches and ``fvp_form="kl"``, runs ``make_kl_fvp`` for every CG call
    and no FVP kernel, and agrees with JAX's ``trpo_update(...,
    fvp_form="kl")`` on the same batch: cosine >= 0.999, |beta| rel <=
    1e-3, the same accepted exponent."""
    jcfg, pcfg = _c1(fvp_impl="kl") if how == "fvp_impl" else _c1()
    form = "kl" if how == "fvp_form" else "gn"
    pn = jax_init_params_np(jcfg, seed=3)
    w0 = np.zeros(2 * jcfg.obs_dim + 4, np.float32)
    bj = jax_batch(jcfg, pn, *env_inputs_np(jcfg, jcfg.n_envs, seed=4))
    _, _, st_j = jax.jit(lambda p, w, b: j_trpo_update(
        jcfg, p, w, b, fvp_form=form, return_directions=True))(
            {k: j(v) for k, v in pn.items()}, j(w0), bj)
    kernels.reset_counts()
    pfvp.make_kl_fvp.calls = 0
    _, _, st_t = trpo_update(pcfg, params_from_numpy(pn, "cpu"),
                             w_from_numpy(w0, "cpu"),
                             torch_batch_from_jax(bj), fvp_form=form,
                             return_directions=True)
    assert pfvp.make_kl_fvp.calls == pcfg.trpo.cg_iters
    assert kernels.plain_calls()["fvp"] == 0
    assert kernels.plain_calls()["fvp_ff"] == 0
    assert cosine(n(st_t["x"]), st_j["x"]) >= 0.999
    beta_j = float(st_j["beta"])
    assert abs(float(st_t["beta"]) - beta_j) / beta_j <= 1e-3
    assert int(st_t["accepted"]) == int(st_j["accepted"])


def test_kl_route_never_takes_the_kernels():
    """At c3's and c5's full size, where the GN form takes K6, "kl" (either
    way) takes the KL form on the batch-major relayout, as in JAX; an
    unknown ``fvp_form`` raises."""
    for cfg in (pconfigs.C3_FRANKA7, pconfigs.C5_MULTITASK):
        tr, T, N = cfg.trpo, cfg.horizon, cfg.n_envs
        params = init_state(cfg, device="cpu").params
        sub = (-(-T // tr.fvp_subsample), -(-N // tr.fvp_env_subsample))
        assert kernel_routes(tr, params, T, N, *sub)["fvp"] == "ff"
        assert kernel_routes(tr, params, T, N, *sub, fvp_form="kl")["fvp"] \
            == "kl"
        kl = dataclasses.replace(tr, fvp_impl="kl")
        assert kernel_routes(kl, params, T, N, *sub)["fvp"] == "kl"
    st = init_state(pconfigs.C1_REACHER2, device="cpu")
    with pytest.raises(ValueError, match="fvp_form"):
        trpo_update(pconfigs.C1_REACHER2, st.params, st.w,
                    {"obs_ff": None, "actions_ff": None}, fvp_form="xla")


@pytest.mark.parametrize("name,value", [
    ("fvp_impl", "xla"), ("fvp_impl", "pallas_ff"), ("moments_impl", "xla"),
    ("moments_impl", "triton"), ("rollout_impl", "xla"),
    ("rollout_impl", "scan")])
def test_switch_values_the_port_does_not_run_raise_on_the_card(name, value):
    """The JAX meanings the port has no counterpart for (the "xla" forms)
    and any other value raise NotImplementedError on a CUDA device, naming
    the switch and its value; the honoured values pass; on the CPU the
    plain forms run, so nothing raises there."""
    with pytest.raises(NotImplementedError, match=f"{name}='{value}'"):
        check_switch(name, value, "cuda")
    check_switch(name, value, "cpu")
    for ok in HONOURED[name]:
        check_switch(name, ok, "cuda")


def test_rollout_impl_pallas3d_takes_the_3d_kernel():
    """``rollout_impl="pallas3d"`` sends a planar reach arm to the 3-D
    kernel (its plain version on the CPU), as the JAX package forces its
    3-D kernel; "auto" keeps the planar one."""
    cfg = pconfigs.C1_REACHER2.replace(n_envs=8, horizon=4)
    for impl, used in (("auto", "rollout"), ("pallas3d", "rollout3d")):
        kernels.reset_counts()
        gen = torch.Generator().manual_seed(5)
        st = init_state(cfg, device="cpu")
        batch = make_rollout_fn(cfg.replace(rollout_impl=impl))(st.params,
                                                                gen)
        calls = kernels.plain_calls()
        assert calls[used] == 1 and sum(calls.values()) == 1
        assert batch["obs_ff"].shape == (4, cfg.obs_dim, 8)
