"""One rank of ``tests/test_torch_tensor_parallel.py``'s four-rank gloo world
(no tests here; the port only, no JAX).

  RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
      python tests/_torch_tp_worker.py DIR

Waits for ``DIR/inputs.npz`` (the test's numpy inputs), joins the world,
makes the (2, 2) and the (1, 4) mesh over it, runs every case and writes
``DIR/rank<r>.npz``; one thread, the plain PyTorch versions (CPU tensors).
The CLI runs last: it ends the world.
"""
import contextlib
import dataclasses
import io
import os
import sys
import time

import numpy as np
import torch

# c1 at tests/test_tensor_parallel.py's size (its ``CFG``), and the meshes
N_ENVS, HORIZON = 32, 20
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the update cases: (config case, mesh); the MLP baseline as JAX's test
# runs it (3 Adam epochs), at (2, 2)
UPDATES = (("lin", "2x2"), ("lin", "1x4"), ("mlp", "2x2"))
TRAIN_ITERS, TRAIN_SEED = 8, 0
WAIT_S = 90


def config(case):
    """The port's config of ``case`` (the test builds JAX's alike)."""
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2
    cfg = C1_REACHER2.replace(n_envs=N_ENVS, horizon=HORIZON)
    if case == "mlp":
        return cfg.replace(trpo=dataclasses.replace(
            cfg.trpo, baseline="mlp", baseline_epochs=3))
    return cfg


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


def _shard_flat(flat, params, n_model, idx):
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.parallel import tensor
    return policy.flatten(tensor.shard_policy_params(
        policy.unflatten(flat, params), n_model, idx))


def _wait_for(path):
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError(f"no {path} after {WAIT_S} s")
        time.sleep(0.05)


def main(out_dir):
    torch.set_num_threads(1)
    from torch.distributed.nn.functional import all_reduce as nn_all_reduce

    from trpo_robot_control_tpu_torch.cli.train import main as cli_main
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
    from trpo_robot_control_tpu_torch.parallel import collectives, tensor
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                         make_train_many)
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    _wait_for(os.path.join(out_dir, "inputs.npz"))
    pm.init_distributed(timeout_s=WAIT_S)
    meshes = {tag: pm.make_mesh(n_data=d, n_model=m, device="cpu")
              for tag, (d, m) in MESHES.items()}
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    params = _tensors(data, "params/")
    batch = _tensors(data, "batch/")
    ws = {"lin": _tensors(data, "w_lin/")["w"], "mlp": _tensors(data, "w_mlp/")}
    rank = torch.distributed.get_rank()
    res = {f"mesh/{tag}": np.array([mesh.rank, mesh.model_rank])
           for tag, mesh in meshes.items()}
    do = params["W0"].shape[0]
    obs_all = batch["obs"].reshape(-1, do)
    P = sum(p.numel() for p in params.values())
    rng = np.random.RandomState(3)
    u, u2 = (torch.from_numpy(rng.standard_normal(P).astype(np.float32))
             for _ in range(2))
    v = torch.from_numpy(np.random.RandomState(11).standard_normal(
        P).astype(np.float32))
    damping = config("lin").trpo.cg_damping

    for tag, mesh in meshes.items():
        n_model, idx = mesh.shape["model"], mesh.model_rank
        local = tensor.shard_policy_params(params, n_model, idx)
        obs = pm.shard_batch(mesh, batch)["obs"].reshape(-1, do)
        # the sharded forward on this rank's envs, beside mean_net
        res[f"{tag}/mu_tp"] = tensor.mean_net_tp(local, obs,
                                                 mesh.model_group).numpy()
        res[f"{tag}/mu"] = policy.mean_net(params, obs).numpy()
        # the global inner product of two shards, beside the full one
        vdot = tensor.make_vdot(local, mesh.model_group)
        res[f"{tag}/vdot"] = np.array([
            float(vdot(_shard_flat(u, params, n_model, idx),
                       _shard_flat(u2, params, n_model, idx))),
            float(torch.dot(u, u2))])
        # the FVP at one fixed v, gathered to the full vector, on the
        # whole batch's samples split over the data ranks
        fvp = tensor.make_gn_fvp_tp(local, obs, damping, mesh.group,
                                    mesh.model_group)
        fv = fvp(_shard_flat(v, params, n_model, idx))
        res[f"{tag}/fvp"] = policy.flatten(tensor.unshard_policy_params(
            policy.unflatten(fv, local), n_model, idx,
            mesh.model_group)).numpy()
        # Megatron's "g": the sharded leaves' gradient of sum(mu) through
        # model_sum, and through an all-reduce whose backward all-reduces
        # again (n_model times too large)
        for name, fn in (("model_sum", collectives.model_sum),
                         ("nn_all_reduce", nn_all_reduce)):
            w0 = local["W0"].clone().requires_grad_(True)
            h = torch.tanh(obs @ w0 + local["b0"])
            z = fn(h @ local["W1"], group=mesh.model_group) \
                if name == "nn_all_reduce" else fn(h @ local["W1"],
                                                   mesh.model_group)
            (gw,) = torch.autograd.grad(torch.tanh(z + local["b1"]).sum(), w0)
            res[f"{tag}/grad_W0/{name}"] = gw.numpy()
    if rank == 0:
        res["one/fvp"] = make_gn_fvp(params, obs_all, damping)(v).numpy()

    for case, tag in UPDATES:
        mesh = meshes[tag]
        collectives.reset_counts()
        new, w_new, st = pm.make_sharded_update_tp(config(case), mesh)(
            params, ws[case], pm.shard_batch(mesh, batch),
            return_directions=True)
        _record(res, f"{case}/{tag}", new, w_new, st)
        res[f"{case}/{tag}/all_reduces"] = np.array(
            collectives.group_counts(mesh.model_group)
            + collectives.group_counts(mesh.group))
        if rank == 0 and tag == "2x2":
            _record(res, f"one/{case}", *trpo_update(
                config(case), params, ws[case], batch,
                return_directions=True))

    # the train step: train_sharded's TRAIN_ITERS iterations at (2, 2), and
    # make_train_many's first two against train_sharded's
    cfg, mesh = config("lin"), meshes["2x2"]
    state, hist = pm.train_sharded(cfg, mesh, n_iters=TRAIN_ITERS,
                                   seed=TRAIN_SEED)
    for k in ("mean_return", "kl", "accepted"):
        res[f"train/{k}"] = np.array([h[k] for h in hist])
    res["train/theta"] = _flat(state.params)
    res["train/W0_shape"] = np.array(state.params["W0"].shape)
    two, _ = pm.train_sharded(cfg, mesh, n_iters=2, seed=TRAIN_SEED)
    many, _ = make_train_many(cfg, 2, mesh)(
        init_state(cfg, TRAIN_SEED, device="cpu"))
    res["train/many_same"] = np.array(
        many.iteration == two.iteration == 2
        and np.array_equal(_flat(many.params), _flat(two.params))
        and torch.equal(many.w, two.w))

    # the CLI, last: --n-model 2 over this world of four, which it ends
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        cli_main(["--n-model", "2", "--device", "cpu", "--n-envs",
                  str(N_ENVS), "--horizon", str(HORIZON), "--iters", "2",
                  "--seed", "3"])
    res["cli/out"] = np.array(out.getvalue())
    res["cli/ended_world"] = np.array(
        not torch.distributed.is_initialized())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


if __name__ == "__main__":
    main(sys.argv[1])
