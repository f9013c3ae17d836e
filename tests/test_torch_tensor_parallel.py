"""Tensor parallelism (the port's ``parallel/tensor.py`` and the mesh's
'model' axis) against the JAX package's (``tests/test_tensor_parallel.py``).

Four gloo ranks, started once for the module (``_torch_tp_worker.py``, one
thread each, CPU tensors), make the (2, 2) and the (1, 4) mesh over one
world and run, at test_tensor_parallel.py's c1 (32 envs x 20 steps, its
``_collect``): the sharded forward, ``make_vdot``, the sharded GN-FVP and
``model_sum``'s backward; the TP update with the linear baseline at both
meshes and with the MLP baseline at (2, 2); 8 iterations of the TP train
step, ``make_train_many`` over the mesh, and the CLI with ``--n-model 2``.
While they run, this process makes the inputs and the JAX references:
JAX's unsharded update and its TP update at (2, 2) over four of the
conftest's eight CPU devices.

The parameters are held to JAX's at the port's bound against JAX (rtol
1e-2, atol 1e-3, ``tests/test_torch_update.py``) with the step's direction
cosine >= 0.999, not at test_tensor_parallel.py's rtol 2e-3, atol 2e-4:
ten fp32 CG iterations on this Fisher land 1-3e-2 of x from an fp64 CG on
every path, the port's and JAX's alike, and any change in the order of a
sum (here the 'model' partial sums) re-draws that error (ROADMAP's
reference caveats, ``tests/_torch_cg_cause.py``; the readings against
the tighter bound: ``tests/_torch_tp_readings.py``). Each all-reduced
quantity is held to the port's one-process update at fp32's rounding.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

import _torch_tp_worker as W
from test_torch_helpers import cosine, jit_jax_rollout, jit_jax_update
from test_torch_sharding import _free_ports
from trpo_robot_control_tpu.configs import C1_REACHER2 as J_C1
from trpo_robot_control_tpu.parallel import mesh as jmesh
from trpo_robot_control_tpu.trpo.train import init_state as j_init_state
from trpo_robot_control_tpu_torch.models import baseline as pb
from trpo_robot_control_tpu_torch.ops.cg import conjugate_gradient
from trpo_robot_control_tpu_torch.parallel import tensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
# how long the ranks may take once the JAX references are done
WAIT_S = 120


def _jcfg(case):
    cfg = J_C1.replace(n_envs=W.N_ENVS, horizon=W.HORIZON)
    if case == "mlp":
        return cfg.replace(trpo=dataclasses.replace(
            cfg.trpo, baseline="mlp", baseline_epochs=3))
    return cfg


def _inputs():
    """numpy: JAX's initial policy (the MLP config's state, whose policy is
    the linear config's) and MLP baseline, the linear baseline's zeros and
    test_tensor_parallel.py's batch (rollout key 42)."""
    state = j_init_state(_jcfg("mlp"), 0)
    batch = jit_jax_rollout(_jcfg("lin"))(state.params,
                                          jax.random.PRNGKey(42))
    params = {k: np.asarray(v) for k, v in state.params.items()}
    return dict(params=params,
                batch={k: np.asarray(batch[k])
                       for k in ("obs", "actions", "rewards")},
                w_lin={"w": np.zeros(2 * params["W0"].shape[0] + 4,
                                     np.float32)},
                w_mlp={k: np.asarray(v) for k, v in state.w.items()})


def _jax_refs(inputs):
    """{"lin"|"mlp": {"unsharded"|"tp": (theta, w, stats)}}, numpy; the
    TP update at (2, 2), linear baseline."""
    p = {k: jax.numpy.asarray(v) for k, v in inputs["params"].items()}
    b = {k: jax.numpy.asarray(v) for k, v in inputs["batch"].items()}

    def host(r):
        return (np.asarray(ravel_pytree(r[0])[0]),
                np.asarray(ravel_pytree(r[1])[0]),
                {k: np.asarray(v) for k, v in r[2].items()})
    w_lin = jax.numpy.asarray(inputs["w_lin"]["w"])
    w_mlp = jax.tree.map(jax.numpy.asarray, inputs["w_mlp"])
    mesh = jmesh.make_mesh(n_data=2, n_model=2)
    return {"lin": {"unsharded": host(jit_jax_update(_jcfg("lin"))(
                        p, w_lin, b)),
                    "tp": host(jmesh.make_sharded_update_tp(
                        _jcfg("lin"), mesh)(p, w_lin,
                                            jmesh.shard_batch(mesh, b)))},
            "mlp": {"unsharded": host(jit_jax_update(_jcfg("mlp"))(
                p, w_mlp, b))}}


def run_world(d):
    """Starts the ranks in directory ``d``; they wait for ``inputs.npz``
    (written whole by one rename) while this process makes the inputs and
    then the JAX references. Returns {inputs, refs, ranks}."""
    port = _free_ports(1)[0]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(RANKS))
    worker = os.path.join(REPO, "tests", "_torch_tp_worker.py")
    ranks = [subprocess.Popen([sys.executable, worker, str(d)],
                              env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(RANKS)]
    try:
        inputs = _inputs()
        np.savez(d / "inputs_tmp.npz", **{
            f"{part}/{k}": v for part in ("params", "batch", "w_lin", "w_mlp")
            for k, v in inputs[part].items()})
        os.replace(d / "inputs_tmp.npz", d / "inputs.npz")
        refs = _jax_refs(inputs)
        logs = [p.communicate(timeout=WAIT_S)[0] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log[-3000:]
    return dict(inputs=inputs, refs=refs,
                ranks=[dict(np.load(d / f"rank{r}.npz"))
                       for r in range(RANKS)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("tp"))


def _stats(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _theta0(inputs):
    p = inputs["params"]
    return np.concatenate([p[k].reshape(-1) for k in sorted(p)])


def test_mesh_places_rank_r_at_data_r_over_m_and_model_r_mod_m(world):
    """JAX's ``devices.reshape(n_data, n_model)``: rank r at (r // m, r % m)."""
    for r, res in enumerate(world["ranks"]):
        for tag, (_, m) in W.MESHES.items():
            assert res[f"mesh/{tag}"].tolist() == [r // m, r % m], (r, tag)


@pytest.mark.parametrize("tag", list(W.MESHES))
def test_tp_forward_equals_mean_net(world, tag):
    """test_tensor_parallel.py:33-52: the sharded forward on each rank's
    envs equals ``policy.mean_net`` (rtol 1e-5, atol 1e-6)."""
    for res in world["ranks"]:
        np.testing.assert_allclose(res[f"{tag}/mu_tp"], res[f"{tag}/mu"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tag", list(W.MESHES))
def test_vdot_and_fvp_match_the_one_process_forms(world, tag):
    """``make_vdot`` on two shards equals ``torch.dot`` of the full vectors
    (rtol 1e-6), and the sharded GN-FVP at one fixed v, gathered, equals
    the port's one-process ``make_gn_fvp`` on the whole batch within 1e-6
    of its norm, the same bits on every rank."""
    ranks = world["ranks"]
    for res in ranks:
        got, want = res[f"{tag}/vdot"]
        assert abs(got - want) <= 1e-6 * abs(want)
        np.testing.assert_array_equal(res[f"{tag}/fvp"], ranks[0][f"{tag}/fvp"])
    assert _rel(ranks[0][f"{tag}/fvp"], ranks[0]["one/fvp"]) <= 1e-6


@pytest.mark.parametrize("tag", list(W.MESHES))
def test_model_sum_backward_is_the_identity(world, tag):
    """The sharded W0's gradient of sum(tanh(z1)) through ``model_sum`` is
    its columns of the one-process gradient on the rank's envs (rtol 1e-5,
    atol 1e-6 of the largest entry: each is a sum over the envs' samples of
    terms up to ~100 times it); through ``torch.distributed.nn.functional.all_reduce``,
    whose backward all-reduces again, it is n_model times that (the fault
    JAX's ``parallel/tensor.py:64-68`` warns of)."""
    inputs = world["inputs"]
    p = {k: torch.tensor(v) for k, v in inputs["params"].items()}
    n_data, n_model = W.MESHES[tag]
    obs = inputs["batch"]["obs"]
    m = obs.shape[0] // n_data
    k = p["W0"].shape[1] // n_model
    for r, res in enumerate(world["ranks"]):
        d, i = divmod(r, n_model)
        o = torch.tensor(obs[d * m:(d + 1) * m]).reshape(-1, obs.shape[-1])
        w0 = p["W0"].clone().requires_grad_(True)
        z = torch.tanh(torch.tanh(o @ w0 + p["b0"]) @ p["W1"] + p["b1"]).sum()
        want = torch.autograd.grad(z, w0)[0][:, i * k:(i + 1) * k].numpy()
        got = res[f"{tag}/grad_W0/model_sum"]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_allclose(res[f"{tag}/grad_W0/nn_all_reduce"],
                                   n_model * got, rtol=1e-6, atol=1e-7)


def _held_to_jax(res, prefix, ref, theta0, what):
    """test_tensor_parallel.py's bounds: the same accepted exponent, beta
    rtol 2e-3, kl rtol 5e-3 atol 1e-5; theta at the port's bound against
    JAX with the step's direction cosine >= 0.999 (the module's
    docstring)."""
    theta, st = res[f"{prefix}/theta"], _stats(res, f"{prefix}/stats/")
    th_j, _, st_j = ref
    assert int(st["accepted"]) == int(st_j["accepted"]), what
    np.testing.assert_allclose(float(st["beta"]), float(st_j["beta"]),
                               rtol=2e-3, err_msg=what)
    np.testing.assert_allclose(float(st["kl"]), float(st_j["kl"]),
                               rtol=5e-3, atol=1e-5, err_msg=what)
    np.testing.assert_allclose(theta, th_j, rtol=1e-2, atol=1e-3,
                               err_msg=what)
    assert cosine(theta - theta0, th_j - theta0) >= 0.999, what


@pytest.mark.parametrize("case,tag", W.UPDATES)
def test_tp_update_matches_jax_unsharded(world, case, tag):
    """The TP update against JAX's unsharded update on the same batch
    (test_tensor_parallel.py:54-100); with the MLP baseline the refit's
    weights too (rtol 2e-3, atol 2e-4, as there)."""
    res = world["ranks"][0]
    ref = world["refs"][case]["unsharded"]
    _held_to_jax(res, f"{case}/{tag}", ref, _theta0(world["inputs"]),
                 f"{case} {tag}")
    if case == "mlp":
        np.testing.assert_allclose(res[f"{case}/{tag}/w"], ref[1],
                                   rtol=2e-3, atol=2e-4)


def test_tp_update_matches_jax_tp_update(world):
    """The TP update at (2, 2) against JAX's ``make_sharded_update_tp`` at
    (2, 2), the same shard boundaries, at the same bounds."""
    _held_to_jax(world["ranks"][0], "lin/2x2", world["refs"]["lin"]["tp"],
                 _theta0(world["inputs"]), "JAX TP")


@pytest.mark.parametrize("case,tag", W.UPDATES)
def test_tp_update_matches_the_ports_one_process_update(world, case, tag):
    """Against the port's own one-process ``trpo_update`` on the whole
    batch, each all-reduced quantity at fp32's rounding: g within 2e-6 of
    its norm, surr_old within 1e-6, the advantages' std and the mean return
    at rtol 1e-6, the refit baseline's predictions within 1e-3 of their
    scale; the same accepted exponent, beta at rtol 2e-3, the step's
    direction cosine >= 0.9999 and its error within 2e-2 of its norm
    (``tests/test_torch_sharding.py``'s rule)."""
    r0 = world["ranks"][0]
    st, one = _stats(r0, f"{case}/{tag}/stats/"), \
        _stats(r0, f"one/{case}/stats/")
    assert _rel(st["g"], one["g"]) <= 2e-6
    assert abs(float(st["surr_old"]) - float(one["surr_old"])) <= 1e-6
    for k in ("adv_std", "mean_return"):
        np.testing.assert_allclose(float(st[k]), float(one[k]), rtol=1e-6,
                                   err_msg=k)
    values = _values(case, world["inputs"])
    v_one = values(r0[f"one/{case}/w"])
    assert np.abs(values(r0[f"{case}/{tag}/w"]) - v_one).max() \
        / (np.abs(v_one).mean() + 1e-6) < 1e-3
    assert int(st["accepted"]) == int(one["accepted"])
    np.testing.assert_allclose(float(st["beta"]), float(one["beta"]),
                               rtol=2e-3)
    theta0 = _theta0(world["inputs"])
    step = r0[f"{case}/{tag}/theta"] - theta0
    step_one = r0[f"one/{case}/theta"] - theta0
    assert cosine(step, step_one) >= 0.9999
    assert _rel(step, step_one) <= 2e-2


def _values(case, inputs):
    """The refit baseline's predictions on the batch's features, from flat
    (sorted-key) weights."""
    obs = inputs["batch"]["obs"]
    phi = pb.features(torch.tensor(obs), W.HORIZON).reshape(
        -1, 2 * obs.shape[-1] + 4)
    if case == "lin":
        return lambda w: phi.numpy() @ w
    like = inputs["w_mlp"]

    def mlp(flat):
        out, i = {}, 0
        for k in sorted(like):
            out[k] = torch.tensor(flat[i:i + like[k].size].reshape(
                like[k].shape))
            i += like[k].size
        return pb.predict_mlp(out, phi).numpy()
    return mlp


def test_all_reduces_counted_by_group(world):
    """Each update's all-reduces are tallied per group: at (2, 2) on both
    the model and the data group; at (1, 4), one data index, on the model
    group only (no data group)."""
    for res in world["ranks"]:
        for case, tag in W.UPDATES:
            model_calls, model_bytes, data_calls, _ = \
                res[f"{case}/{tag}/all_reduces"].tolist()
            assert model_calls > 0 and model_bytes > 0, (case, tag)
            assert (data_calls > 0) == (W.MESHES[tag][0] > 1), (case, tag)


def test_tp_train_step_improves(world):
    """test_tensor_parallel.py:122-134: 8 TP train steps at (2, 2), each
    within the trust region, the mean return of the last three above the
    first three's; the state keeps the full W0; ``make_train_many`` over
    the mesh equals two of ``train_sharded``'s steps bit for bit."""
    res = world["ranks"][0]
    ret, kl = res["train/mean_return"], res["train/kl"]
    assert len(ret) == W.TRAIN_ITERS
    assert (kl <= 0.01 + 1e-6).all(), kl
    assert np.mean(ret[-3:]) > np.mean(ret[:3]), ret
    assert res["train/W0_shape"].tolist() == \
        list(world["inputs"]["params"]["W0"].shape)
    assert bool(res["train/many_same"])


def test_ranks_agree_bit_for_bit(world):
    """Every update's parameters, baseline and stats, and the train run,
    are the same bits on all four ranks."""
    r0 = world["ranks"][0]
    keys = [k for k in r0 if k.startswith(("lin/", "mlp/", "train/"))
            and not k.endswith("/all_reduces")]
    assert keys
    for res in world["ranks"][1:]:
        for k in keys:
            np.testing.assert_array_equal(res[k], r0[k], err_msg=k)


def test_cli_n_model_trains_in_the_ranks(world):
    """``cli.train.main([... "--n-model", "2", "--device", "cpu"])`` in the
    four ranks: a (2, 2) mesh, two iteration lines from rank 0, none from
    the others, and the world ended."""
    for r, res in enumerate(world["ranks"]):
        out = str(res["cli/out"])
        lines = [ln for ln in out.splitlines() if ln.startswith("iter")]
        assert len(lines) == (2 if r == 0 else 0), out
        assert bool(res["cli/ended_world"])
    assert "mesh: {'data': 2, 'model': 2}" in str(world["ranks"][0]["cli/out"])


def test_tp_refuses_shallow_or_uneven_policies():
    """JAX's asserts as ValueError: one hidden layer, or a first hidden
    width that does not split over the model axis."""
    rng = np.random.RandomState(0)
    deep = {k: torch.tensor(v) for k, v in
            _policy_np(rng, (6, 6)).items()}
    shallow = {k: torch.tensor(v) for k, v in _policy_np(rng, (6,)).items()}
    with pytest.raises(ValueError, match="hidden layers"):
        tensor.shard_policy_params(shallow, 2, 0)
    with pytest.raises(ValueError, match="hidden layers"):
        tensor.mean_net_tp(shallow, torch.zeros(3, 4), None)
    with pytest.raises(ValueError, match="does not split"):
        tensor.shard_policy_params(deep, 4, 0)
    local = tensor.shard_policy_params(deep, 3, 1)
    assert local["W0"].shape == (4, 2) and local["W1"].shape == (2, 6)


def _policy_np(rng, hidden, do=4, da=2):
    sizes = [do] + list(hidden) + [da]
    p = {}
    for i in range(len(sizes) - 1):
        p[f"W{i}"] = rng.standard_normal(sizes[i:i + 2]).astype(np.float32)
        p[f"b{i}"] = rng.standard_normal(sizes[i + 1]).astype(np.float32)
    p["logstd"] = np.zeros(da, np.float32)
    return p


def test_shard_and_unshard_round_trip_in_a_world_of_one():
    """With no group the zero-padded sum is the padding itself: sharding
    to each model index and unsharding gives back the full leaves' slices
    and zeros elsewhere, exactly."""
    p = {k: torch.tensor(v) for k, v in
         _policy_np(np.random.RandomState(1), (8, 5)).items()}
    total = {k: torch.zeros_like(v) for k, v in p.items()}
    for i in range(4):
        full = tensor.unshard_policy_params(
            tensor.shard_policy_params(p, 4, i), 4, i, None)
        for k in tensor.SHARDED_KEYS:
            total[k] += full[k]
    for k in tensor.SHARDED_KEYS:
        assert torch.equal(total[k], p[k]), k


def test_cg_vdot_none_is_the_flat_path_and_a_split_vdot_matches():
    """``conjugate_gradient`` with ``vdot=None`` is the recurrence on
    ``torch.dot`` bit for bit (the flat path as it was); a ``vdot`` that
    sums the dots of two parts of the flat vector agrees with it to fp32's
    rounding (x within 1e-5 of its norm on a well-conditioned system)."""
    rng = np.random.RandomState(2)
    M = rng.standard_normal((40, 40)).astype(np.float32)
    F = torch.tensor(M @ M.T / 40 + np.eye(40, dtype=np.float32))
    g = torch.tensor(rng.standard_normal(40).astype(np.float32))

    def fvp(v):
        return F @ v

    x, r, rr = conjugate_gradient(fvp, g, 10)
    xr, rr_, p, rdotr = torch.zeros_like(g), g, g, torch.dot(g, g)
    for _ in range(10):
        z = fvp(p)
        alpha = rdotr / (torch.dot(p, z) + 1e-12)
        xr = xr + alpha * p
        rr_ = rr_ - alpha * z
        new = torch.dot(rr_, rr_)
        p = rr_ + (new / (rdotr + 1e-12)) * p
        rdotr = new
    assert torch.equal(x, xr) and torch.equal(r, rr_) and torch.equal(rr, rdotr)

    def split(u, v):
        return torch.dot(u[:13], v[:13]) + torch.dot(u[13:], v[13:])

    xs, _, _ = conjugate_gradient(fvp, g, 10, vdot=split)
    assert float(torch.linalg.norm(xs - x) / torch.linalg.norm(x)) <= 1e-5
    assert abs(float(split(g, x)) - float(torch.dot(g, x))) \
        <= 1e-6 * abs(float(torch.dot(g, x)))
