"""Data parallelism (the port's ``parallel/mesh.py``) against the JAX
package's (``tests/test_sharding.py``).

Two gloo ranks, started once for the module (``_torch_sharding_worker.py``,
one thread each, the plain versions of the kernels), each run the sharded
update on their halves of one c1 batch at test_sharding.py's size (32 envs
x 20 steps, its ``_collect``): the feature-first branch (the batch's
feature-first views, the line search on every 2nd env), the batch-major
branch, the env stride ``fvp_env_subsample=2`` and the MLP baseline. Each
is held to JAX's unsharded update and to its sharded update over two of the
conftest's eight CPU devices (the same shard boundaries) at
test_sharding.py's tolerances (``:48-63``), the parameters at the port's
bound against JAX (the test's docstring says why), and to the port's own
one-process update, each all-reduced quantity at fp32's rounding; the ranks
must agree bit for bit. The ranks also run the kernel gates on a global
batch, ``make_train_many`` over the mesh and the rank streams, and each
first meets an absent peer. While they run, this process computes the
inputs and the JAX references. A world of one, in this process, is the
unsharded update and train loop bit for bit.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

import _torch_sharding_worker as W
from test_torch_helpers import cosine, jit_jax_rollout
from trpo_robot_control_tpu.configs import C1_REACHER2 as J_C1
from trpo_robot_control_tpu.parallel import mesh as jmesh
from trpo_robot_control_tpu.trpo.train import init_state as j_init_state
from trpo_robot_control_tpu.trpo.update import trpo_update as j_update
from trpo_robot_control_tpu_torch.models import baseline as pb
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.parallel import mesh as pm
from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                     make_train_many,
                                                     make_train_step, train)
from trpo_robot_control_tpu_torch.trpo.update import (FVP_FF_MIN_B,
                                                      SURRGRAD_MIN_B,
                                                      kernel_routes,
                                                      trpo_update)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
# how long the ranks may take once the JAX references are done
WAIT_S = 120
def _free_ports(n):
    """``n`` distinct free ports (each socket held until all are bound)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _jcfg(case):
    cfg = J_C1.replace(n_envs=W.N_ENVS, horizon=W.HORIZON)
    return cfg.replace(trpo=dataclasses.replace(cfg.trpo,
                                                **W.UPDATE_CASES[case]))


def _inputs():
    """{case: (params, w, batch)} as numpy: JAX's initial state (the MLP
    config's, whose policy is the linear one's; the linear baseline starts
    at zero), the batch-major batch of test_sharding.py's ``_collect`` and
    its feature-first views (T, d, N), (T, N), the rollout kernels'
    layout."""
    state = j_init_state(_jcfg("mlp"), 0)
    bm = jit_jax_rollout(_jcfg("bm"))(state.params, jax.random.PRNGKey(42))
    bm = {k: np.asarray(v) for k, v in bm.items()}
    params = {k: np.asarray(v) for k, v in state.params.items()}
    ff = {"obs_ff": bm["obs"].transpose(1, 2, 0),
          "actions_ff": bm["actions"].transpose(1, 2, 0),
          "rewards_ff": bm["rewards"].T}
    w0 = {"w": np.zeros(2 * params["W0"].shape[0] + 4, np.float32)}
    w_mlp = {k: np.asarray(v) for k, v in state.w.items()}
    return {"ff": (params, w0, ff), "bm": (params, w0, bm),
            "sub": (params, w0, bm), "mlp": (params, w_mlp, bm)}


def _jax_batch(batch):
    """A numpy batch as JAX takes it: the feature-first keys with their
    batch-major views."""
    b = dict(batch)
    if "obs_ff" in b:
        b.update(obs=b["obs_ff"].transpose(2, 0, 1),
                 actions=b["actions_ff"].transpose(2, 0, 1),
                 rewards=b["rewards_ff"].T)
    return {k: jax.numpy.asarray(v) for k, v in b.items()}


def _jax_refs(inputs):
    """{case: {"unsharded"|"sharded": (theta, w, stats)}}, numpy."""
    mesh2 = jmesh.make_mesh(n_data=RANKS)
    out = {}
    for case, (params, w, batch) in inputs.items():
        cfg = _jcfg(case)
        p = {k: jax.numpy.asarray(v) for k, v in params.items()}
        w = w["w"] if set(w) == {"w"} else w
        w = jax.tree.map(jax.numpy.asarray, w)
        b = _jax_batch(batch)
        one = jax.jit(lambda p, w, b, cfg=cfg: j_update(cfg, p, w, b))(
            p, w, b)
        two = jmesh.make_sharded_update(cfg, mesh2)(
            p, w, jmesh.shard_batch(mesh2, b))
        out[case] = {
            tag: (np.asarray(ravel_pytree(r[0])[0]),
                  np.asarray(ravel_pytree(r[1])[0]),
                  {k: np.asarray(v) for k, v in r[2].items()})
            for tag, r in (("unsharded", one), ("sharded", two))}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks start first and meet their absent peers while this process
    makes the inputs (``inputs.npz``, written whole by one rename) and then
    the JAX references."""
    d = tmp_path_factory.mktemp("sharding")
    ports = _free_ports(1 + RANKS)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]),
               WORLD_SIZE=str(RANKS))
    worker = os.path.join(REPO, "tests", "_torch_sharding_worker.py")
    ranks = [subprocess.Popen([sys.executable, worker, str(d),
                               str(ports[1 + r])],
                              env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(RANKS)]
    try:
        inputs = _inputs()
        np.savez(d / "inputs_tmp.npz", **{
            f"{case}/{part}/{k}": v
            for case, tup in inputs.items()
            for part, arrs in zip(("params", "w", "batch"), tup)
            for k, v in arrs.items()})
        os.replace(d / "inputs_tmp.npz", d / "inputs.npz")
        refs = _jax_refs(inputs)
        logs = [p.communicate(timeout=WAIT_S)[0] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, log in zip(ranks, logs):
        assert p.returncode == 0, log[-3000:]
    yield dict(inputs=inputs, refs=refs,
               ranks=[dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)])


@pytest.fixture
def one():
    """A world of one, made by ``make_mesh`` itself, destroyed after."""
    mesh = pm.make_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def _stats(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(W.UPDATE_CASES))
def test_two_ranks_match_jax_sharded_and_unsharded(world, case):
    """Against each JAX update, test_sharding.py's bounds: the same
    accepted exponent, beta rtol 2e-3, kl rtol 5e-3 atol 1e-5, the refit
    baseline's predictions within 2e-2 of their scale; the parameters at
    the port's bound against JAX (tests/test_torch_update.py: rtol 1e-2,
    atol 1e-3) with the step's direction cosine >= 0.999 (the parity
    contract). test_sharding.py's theta bound (rtol 2e-3, atol 2e-4) sits
    within a few times this system's fp32 spread: rounding g differently
    by 3e-7 moves x by ~1e-3 and theta by up to 8.5e-5 after CG's ten
    iterations; the port's two ranks move theta by up to 2.5e-4 from its
    one-process update, JAX's by 6.1e-5, and the port's one-process MLP
    update is 4.6e-4 from JAX's."""
    r0, r1 = world["ranks"]
    for k in r0:
        if k.startswith(case + "/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    theta, st = r0[f"{case}/theta"], _stats(r0, f"{case}/stats/")
    params, w0, batch = world["inputs"][case]
    theta0 = np.concatenate([params[k].reshape(-1) for k in sorted(params)])
    values = _values(case, w0, batch)
    v = values(r0[f"{case}/w"])
    for tag, (th_j, w_j, st_j) in world["refs"][case].items():
        assert int(st["accepted"]) == int(st_j["accepted"]), tag
        np.testing.assert_allclose(float(st["beta"]), float(st_j["beta"]),
                                   rtol=2e-3, err_msg=tag)
        np.testing.assert_allclose(float(st["kl"]), float(st_j["kl"]),
                                   rtol=5e-3, atol=1e-5, err_msg=tag)
        v_j = values(w_j)
        assert np.abs(v - v_j).max() / (np.abs(v_j).mean() + 1e-6) \
            < 2e-2, tag
        np.testing.assert_allclose(theta, th_j, rtol=1e-2, atol=1e-3,
                                   err_msg=tag)
        assert cosine(theta - theta0, th_j - theta0) >= 0.999, tag


@pytest.mark.parametrize("case", list(W.UPDATE_CASES))
def test_two_ranks_match_the_ports_one_process_update(world, case):
    """Against the port's own one-process update on the whole batch, each
    all-reduced quantity at fp32's rounding: g within 2e-6 of its norm,
    surr_old within 1e-6 (the whitened advantages' unit scale), the
    advantages' std and the mean return at rtol 1e-6, each FVP form's Fv at
    one fixed v (the ranks' mean of their Fv) within 1e-6 of its norm, the
    refit baseline's predictions within 1e-3 of their scale; the same
    accepted exponent, beta at rtol 2e-3, the step's direction cosine
    >= 0.9999 and its error within 2e-2 of its norm. Theta is not held to
    test_sharding.py's bound here: fp32 CG's own rounding (4e-4 of x against
    an fp64 CG on this Fisher) is re-drawn by any change in the order of
    the sums, and the one-process update moves theta by up to 5.6e-4 when
    only the order of the envs changes (``_torch_sharding_spread.py``)."""
    r0 = world["ranks"][0]
    st, one = _stats(r0, f"{case}/stats/"), _stats(r0, f"one/{case}/stats/")

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(st["g"], one["g"]) <= 2e-6
    assert abs(float(st["surr_old"]) - float(one["surr_old"])) <= 1e-6
    for k in ("adv_std", "mean_return"):
        np.testing.assert_allclose(float(st[k]), float(one[k]), rtol=1e-6,
                                   err_msg=k)
    for name in ("gn", "kl", "ff"):
        assert rel(r0[f"fvp/{name}"], r0[f"one/fvp/{name}"]) <= 1e-6, name
    params, w0, batch = world["inputs"][case]
    values = _values(case, w0, batch)
    v_one = values(r0[f"one/{case}/w"])
    assert np.abs(values(r0[f"{case}/w"]) - v_one).max() \
        / (np.abs(v_one).mean() + 1e-6) < 1e-3
    assert int(st["accepted"]) == int(one["accepted"])
    np.testing.assert_allclose(float(st["beta"]), float(one["beta"]),
                               rtol=2e-3)
    theta0 = np.concatenate([params[k].reshape(-1) for k in sorted(params)])
    step, step_one = r0[f"{case}/theta"] - theta0, \
        r0[f"one/{case}/theta"] - theta0
    assert cosine(step, step_one) >= 0.9999
    assert rel(step, step_one) <= 2e-2


def _values(case, w0, batch):
    """The refit baseline's predictions on the batch's features, from flat
    weights: ``values(w) -> (N * T,)``."""
    obs = batch["obs"] if "obs" in batch else \
        batch["obs_ff"].transpose(2, 0, 1)
    phi = pb.features(torch.tensor(obs), W.HORIZON).reshape(
        -1, 2 * obs.shape[-1] + 4)
    if case == "mlp":
        return lambda w: pb.predict_mlp(_w_dict(w0, w), phi).numpy()
    return lambda w: phi.numpy() @ w


def _w_dict(like, flat):
    """A flat (sorted-key) MLP weight vector as the dict of ``like``'s
    shapes, torch."""
    out, i = {}, 0
    for k in sorted(like):
        m = like[k].size
        out[k] = torch.tensor(flat[i:i + m].reshape(like[k].shape))
        i += m
    return out


def test_kernel_routes_read_the_global_batch(world):
    """Both gates on a shape where the local and the global batch fall on
    either side; in the ranks' update, K6's route (its plain version on
    the CPU) on a subsample of FVP_FF_MIN_B / 2 samples a rank."""
    tr = W.config("routes").trpo
    params = init_state(W.config("routes"), device="cpu").params
    T, k = W.ROUTES_T, W.ROUTES_K
    N = W.ROUTES_N // RANKS
    assert (T // k) * N * RANKS == FVP_FF_MIN_B
    one = kernel_routes(tr, params, T, N, T // k, N)
    two = kernel_routes(tr, params, T, N, T // k, N, n_data=RANKS)
    assert (one["fvp"], two["fvp"]) == ("bm", "ff")
    N_sg = SURRGRAD_MIN_B // (2 * T)
    assert kernel_routes(tr, params, T, N_sg, T, N_sg)["surrgrad"] == "xla"
    assert kernel_routes(tr, params, T, N_sg, T, N_sg,
                         n_data=RANKS)["surrgrad"] == "pallas"
    for r in world["ranks"]:
        # K6 ten times, no K3, the plain surrogate gradient (64k samples)
        assert r["routes/plain_calls"].tolist() == [tr.cg_iters, 0, 0]


def test_world_of_one_is_the_unsharded_path_bit_for_bit(one):
    """make_mesh with no group makes a world of one: the sharded update
    equals trpo_update bit for bit on both branches (the MLP refit's
    averaged gradients included), and two sharded train steps, by
    make_train_many and train_sharded, equal two unsharded ones."""
    assert one.shape == {"data": 1, "model": 1}
    inputs = _inputs_small()
    for case, (params, w, batch) in inputs.items():
        cfg = W.config(case)
        a = trpo_update(cfg, params, w, batch)
        b = pm.make_sharded_update(cfg, one)(params, w,
                                              pm.shard_batch(one, batch))
        _same(a, b, case)
    cfg = W.config("ff")
    state, stacked = make_train_many(cfg, 2, one)(init_state(cfg, seed=1,
                                                             device="cpu"))
    ref, step = init_state(cfg, seed=1, device="cpu"), make_train_step(cfg)
    rows = []
    for _ in range(2):
        ref, st = step(ref)
        rows.append(st)
    _same((state.params, state.w, stacked),
          (ref.params, ref.w, {k: torch.stack([r[k] for r in rows])
                               for k in rows[0]}), "train_many")
    assert torch.equal(state.gen.get_state(), ref.gen.get_state())
    _, h1 = pm.train_sharded(cfg, one, n_iters=2, seed=4)
    _, h2 = train(cfg, n_iters=2, seed=4, device="cpu")
    assert [{k: v for k, v in h.items() if k != "wall_s"} for h in h1] \
        == [{k: v for k, v in h.items() if k != "wall_s"} for h in h2]


def _inputs_small():
    """A port-made batch (the CPU rollout) for each branch."""
    from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
    out = {}
    for case in ("ff", "mlp"):
        cfg = W.config(case)
        st = init_state(cfg, seed=2, device="cpu")
        out[case] = (st.params, st.w, make_rollout_fn(cfg)(st.params, st.gen))
    return out


def _same(a, b, what):
    (pa, wa, sa), (pb, wb, sb) = a, b
    assert torch.equal(ppol.flatten(pa), ppol.flatten(pb)), what
    wa = wa if isinstance(wa, dict) else {"w": wa}
    wb = wb if isinstance(wb, dict) else {"w": wb}
    assert all(torch.equal(wa[k], wb[k]) for k in wa), what
    assert sa.keys() == sb.keys(), what
    assert all(torch.equal(sa[k], sb[k]) for k in sa), (what, [
        k for k in sa if not torch.equal(sa[k], sb[k])])


def test_train_many_on_two_ranks_keeps_ranks_identical(world):
    """make_train_many(cfg, 2, mesh): parameters, baseline and every stat
    bit-identical across the ranks, finite, each accepted step inside the
    trust region; the state's generator the same on both; each rank's
    rollout stream its own, and deterministic for a fixed seed."""
    r0, r1 = world["ranks"]
    for k in r0:
        if k.startswith("train/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    st = _stats(r0, "train/stats/")
    assert all(np.isfinite(v).all() for v in st.values())
    assert ((st["accepted"] < 0) | (st["kl"] <= 0.01)).all()
    assert bool(r0["train/uneven_raised"])
    for r in (r0, r1):
        np.testing.assert_array_equal(r["stream/draw0"], r["stream/draw1"])
        np.testing.assert_array_equal(r["stream/next0"], r["stream/next1"])
    assert not np.array_equal(r0["stream/draw0"], r1["stream/draw0"])
    np.testing.assert_array_equal(r0["stream/next0"], r1["stream/next0"])


def test_resume_on_two_ranks_replays_the_uninterrupted_run(world):
    """train_sharded for 2 iterations with a checkpoint, then 1 more from
    it, equals 3 straight iterations bit for bit on both ranks (every rank
    loads rank 0's state and derives its rollout stream from it); only
    rank 0 wrote, one file."""
    for r in world["ranks"]:
        assert bool(r["resume/same"])
        assert r["resume/files"].tolist() == ["ckpt_000002.npz"]


def test_uneven_envs_and_n_model_rejected(world):
    """test_sharding.py:125-133: uneven envs over the data axis raise
    ValueError (the ranks' make_train_many, and shard_batch); a 'model'
    axis that does not fit the world (2 in a world of one) raises
    ValueError before any process group is made."""
    assert all(bool(r["train/uneven_raised"]) for r in world["ranks"])
    with pytest.raises(ValueError, match="does not match the world size 1"):
        pm.make_mesh(n_model=2, device="cpu")
    assert not torch.distributed.is_initialized()
    two = pm.Mesh(group=None, shape={"data": 2, "model": 1}, rank=1,
                  device=torch.device("cpu"))
    with pytest.raises(ValueError, match="evenly"):
        pm.shard_batch(two, {"obs": torch.zeros(31, 4, 3)})
    half = pm.shard_batch(two, {"obs": torch.arange(8.0).reshape(4, 2),
                                "obs_ff": torch.arange(8.0).reshape(2, 4)})
    assert half["obs"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert half["obs_ff"].tolist() == [[2.0, 3.0], [6.0, 7.0]]
    assert half["obs_ff"].is_contiguous()


def test_absent_peer_raises_within_the_timeout(world):
    """init_distributed with TRPO_DIST_INIT_TIMEOUT=5 and no peer: a one-line
    RuntimeError naming the rank, the world size and the address, from rank
    0 (its store waits for rank 1) and from rank 1 (no store to reach),
    each after the timeout; no hang (each rank, before it joins its world)."""
    for r, res in enumerate(world["ranks"]):
        error, seconds = str(res["absent/error"]), float(res["absent/seconds"])
        assert error and "\n" not in error
        assert f"rank {r}/2" in error and "127.0.0.1:" in error
        assert W.ABSENT_TIMEOUT_S - 0.5 <= seconds <= W.ABSENT_TIMEOUT_S + 2


def test_cli_sharded_trains_in_one_process(capsys):
    """``--sharded`` in one process takes the mesh path (a world of one),
    as the JAX CLI's flag does, and leaves no process group behind."""
    from trpo_robot_control_tpu_torch.cli.train import main
    main(["--config", "c1_reacher2", "--iters", "2", "--n-envs", "16",
          "--horizon", "10", "--device", "cpu", "--seed", "3", "--sharded"])
    cap = capsys.readouterr()
    assert len([ln for ln in cap.out.splitlines()
                if ln.startswith("iter")]) == 2
    assert "mesh: {'data': 1, 'model': 1}" in cap.err
    assert not torch.distributed.is_initialized()
