"""One rank of ``tests/test_torch_sharding.py``'s two-rank gloo world (no
tests here; the port only, no JAX).

  RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
      python tests/_torch_sharding_worker.py DIR PROBE_PORT

First meets an absent peer: ``init_distributed`` as rank r of a world of
two on PROBE_PORT, where no peer ever comes. Then waits for
``DIR/inputs.npz`` (the test's numpy inputs), joins the world on
MASTER_PORT, runs every case on this rank's shard and writes
``DIR/rank<r>.npz``; one thread, the plain versions of the kernels (CPU
tensors).
"""
import dataclasses
import hashlib
import os
import sys
import time

import numpy as np
import torch

# c1 at tests/test_sharding.py's size, and each update case's TRPOSpec
# fields: the feature-first branch (with the line search on every 2nd env),
# the batch-major branch, the env-strided Fisher subsample, the MLP baseline
N_ENVS, HORIZON = 32, 20
UPDATE_CASES = {"ff": dict(ls_subsample=2), "bm": {},
                "sub": dict(fvp_env_subsample=2), "mlp": dict(baseline="mlp")}
# the routes case: a global (T, N) batch whose Fisher subsample (every 2nd
# step) is FVP_FF_MIN_B samples globally and half that on a rank
ROUTES_T, ROUTES_N, ROUTES_K = 16, 8000, 2
TRAIN_SEED, STREAM_SEED = 3, 5
# the absent peer's rendezvous timeout (TRPO_DIST_INIT_TIMEOUT); how long a
# rank waits for the inputs and for its peer
ABSENT_TIMEOUT_S, WAIT_S = 5, 60


def config(case):
    """The port's config of ``case`` (the test builds JAX's alike)."""
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2
    cfg = C1_REACHER2.replace(n_envs=N_ENVS, horizon=HORIZON)
    if case == "routes":
        return cfg.replace(n_envs=ROUTES_N, horizon=ROUTES_T,
                           trpo=dataclasses.replace(
                               cfg.trpo, fvp_subsample=ROUTES_K))
    return cfg.replace(trpo=dataclasses.replace(cfg.trpo,
                                                **UPDATE_CASES.get(case, {})))


def routes_batch(obs_dim, n_joints):
    """The routes case's whole batch, numpy: random (T, d, N) views."""
    rng = np.random.RandomState(7)
    T, N = ROUTES_T, ROUTES_N
    return {"obs_ff": rng.standard_normal((T, obs_dim, N)),
            "actions_ff": rng.standard_normal((T, n_joints, N)),
            "rewards_ff": rng.standard_normal((T, N))}


def _tensors(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
            for k in data.files if k.startswith(prefix)}


def _flat(d):
    return torch.cat([d[k].reshape(-1) for k in sorted(d)]).numpy()


def _record(res, prefix, new, w_new, st):
    res[f"{prefix}/theta"] = _flat(new)
    res[f"{prefix}/w"] = _flat(w_new) if isinstance(w_new, dict) \
        else w_new.numpy()
    res.update({f"{prefix}/stats/{k}": v.numpy() for k, v in st.items()})


def _absent_peer(pm, port):
    """``init_distributed`` with no peer on ``port``: its error and seconds
    (rank 0's store waits for rank 1; rank 1 finds no store)."""
    env = dict(os.environ)
    os.environ.update({"MASTER_PORT": str(port),
                       pm.TIMEOUT_ENV: str(ABSENT_TIMEOUT_S)})
    t0 = time.monotonic()
    try:
        pm.init_distributed()
        error = ""
    except RuntimeError as e:
        error = str(e)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return error, time.monotonic() - t0


def _wait_for(path):
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError(f"no {path} after {WAIT_S} s")
        time.sleep(0.05)


def main(out_dir, probe_port):
    torch.set_num_threads(1)
    from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
    from trpo_robot_control_tpu_torch.ops.cuda.fvp_ff_kernel import \
        make_gn_fvp_ff
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp, make_kl_fvp
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                         make_train_many)
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    error, seconds = _absent_peer(pm, probe_port)
    res = {"absent/error": np.array(error), "absent/seconds": seconds}
    _wait_for(os.path.join(out_dir, "inputs.npz"))
    pm.init_distributed(timeout_s=WAIT_S)
    mesh = pm.make_mesh(device="cpu")
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    for case in UPDATE_CASES:
        params = _tensors(data, f"{case}/params/")
        w = _tensors(data, f"{case}/w/")
        w = w if set(w) != {"w"} else w["w"]
        batch = _tensors(data, f"{case}/batch/")
        if "obs_ff" in batch:
            batch = batch_from_ff(batch["obs_ff"], batch["actions_ff"],
                                  batch["rewards_ff"])
        new, w_new, st = pm.make_sharded_update(config(case), mesh)(
            params, w, pm.shard_batch(mesh, batch), return_directions=True)
        _record(res, case, new, w_new, st)
        if mesh.rank == 0:
            # the port's one-process update on the whole batch
            _record(res, f"one/{case}", *trpo_update(
                config(case), params, w, batch, return_directions=True))

    # each FVP form at one fixed v: the ranks' mean of their Fv against
    # the one-process Fv on the whole batch's samples
    params = _tensors(data, "bm/params/")
    obs = _tensors(data, "bm/batch/")["obs"]
    v = torch.from_numpy(np.random.RandomState(11).standard_normal(
        sum(p.numel() for p in params.values())).astype(np.float32))
    damping = config("bm").trpo.cg_damping
    local = pm.shard_batch(mesh, {"obs": obs, "obs_ff": obs.permute(1, 2, 0)})
    for name, make, whole, mine in (
            ("gn", make_gn_fvp, obs.reshape(-1, obs.shape[-1]),
             local["obs"].reshape(-1, obs.shape[-1])),
            ("kl", make_kl_fvp, obs.reshape(-1, obs.shape[-1]),
             local["obs"].reshape(-1, obs.shape[-1])),
            ("ff", make_gn_fvp_ff, obs.permute(1, 2, 0).contiguous(),
             local["obs_ff"])):
        res[f"fvp/{name}"] = make(params, mine, damping,
                                  axis_name=mesh.group)(v).numpy()
        if mesh.rank == 0:
            res[f"one/fvp/{name}"] = make(params, whole, damping)(v).numpy()

    # the kernel gates on the global batch: K6's route (its plain version
    # here) on a subsample under FVP_FF_MIN_B locally, over it globally
    cfg = config("routes")
    b = {k: torch.from_numpy(v.astype(np.float32))
         for k, v in routes_batch(cfg.obs_dim, cfg.arm.n_joints).items()}
    state = init_state(cfg, seed=0, device="cpu")
    kernels.reset_counts()
    pm.make_sharded_update(cfg, mesh)(
        state.params, state.w, pm.shard_batch(
            mesh, batch_from_ff(b["obs_ff"], b["actions_ff"],
                                b["rewards_ff"])))
    res["routes/plain_calls"] = np.array(
        [kernels.plain_calls()[k] for k in ("fvp_ff", "fvp", "pg")])

    # make_train_many over the mesh: two steps from one seed on every rank
    cfg = config("bm")
    st, stacked = make_train_many(cfg, 2, mesh)(
        init_state(cfg, seed=TRAIN_SEED, device="cpu"))
    res["train/theta"] = _flat(st.params)
    res["train/w"] = st.w.numpy()
    res["train/gen"] = st.gen.get_state().numpy()
    res.update({f"train/stats/{k}": v.numpy() for k, v in stacked.items()})
    try:
        make_train_many(cfg.replace(n_envs=N_ENVS - 1), 2, mesh)
        res["train/uneven_raised"] = np.array(False)
    except ValueError:
        res["train/uneven_raised"] = np.array(True)

    # checkpoints: rank 0 writes, every rank loads; three sharded
    # iterations straight against two, a checkpoint, and one more
    from trpo_robot_control_tpu_torch.utils.checkpoint import load_checkpoint
    ckpt = os.path.join(out_dir, "ckpt")
    full, _ = pm.train_sharded(cfg, mesh, n_iters=3, seed=TRAIN_SEED)
    pm.train_sharded(cfg, mesh, n_iters=2, seed=TRAIN_SEED,
                     checkpoint_every=2, checkpoint_dir=ckpt)
    torch.distributed.barrier()          # rank 0's file is written
    resumed, _ = pm.train_sharded(
        cfg, mesh, n_iters=1,
        state=load_checkpoint(os.path.join(ckpt, "ckpt_000002.npz"), cfg,
                              "cpu"))
    res["resume/same"] = np.array(
        resumed.iteration == full.iteration == 3
        and all(torch.equal(full.params[k], resumed.params[k])
                for k in full.params) and torch.equal(full.w, resumed.w))
    res["resume/files"] = np.array(sorted(os.listdir(ckpt)))

    # the rank streams: this rank's draw and the state's next generator,
    # twice from one seed
    for i in range(2):
        gen = torch.Generator().manual_seed(STREAM_SEED)
        res[f"stream/draw{i}"] = torch.rand(
            8, generator=pm.rank_stream(mesh, gen)).numpy()
        res[f"stream/next{i}"] = np.frombuffer(hashlib.sha256(
            gen.get_state().numpy().tobytes()).digest(), np.uint8)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **res)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
