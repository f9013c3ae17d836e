"""The PyTorch port's ground rules: it imports nothing of JAX or of the
JAX package, its entry points run on CUDA unless asked for the CPU, its
configs equal the reference's, and what it does not port yet raises."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import test_torch_helpers  # noqa: F401  (pins torch threads)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "trpo_robot_control_tpu_torch"


def test_port_and_cli_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import trpo_robot_control_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import trpo_robot_control_tpu_torch.cli.train\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'trpo_robot_control_tpu'\n"
        "       or m.startswith('trpo_robot_control_tpu.')]\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('trpo_robot_control_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # the walk really imported


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|trpo_robot_control_tpu)(?![\w])",
    re.MULTILINE)


def test_source_scan_no_jax_imports():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    for mod in ("envs/rigid_body.py", "ops/cuda/rollout3d_kernel.py",
                "ops/cuda/pg_kernel.py", "ops/cuda/fvp_ff_kernel.py"):
        assert f"trpo_robot_control_tpu_torch/{mod}" in scanned
    for f in files:
        hits = _IMPORT.findall(f.read_text())
        assert not hits, f"{f}: imports {hits}"


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    from trpo_robot_control_tpu_torch.configs import C1_REACHER2
    from trpo_robot_control_tpu_torch.device import resolve
    from trpo_robot_control_tpu_torch.trpo.train import init_state, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve(None)
    with pytest.raises(RuntimeError):
        init_state(C1_REACHER2)
    with pytest.raises(RuntimeError):
        train(C1_REACHER2.replace(n_envs=8, horizon=5), n_iters=1)
    assert resolve("cpu").type == "cpu"
    st = init_state(C1_REACHER2, device="cpu")
    assert st.w.device.type == "cpu" and st.gen.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_c3_entry_point_needs_cuda_unless_cpu(monkeypatch):
    from trpo_robot_control_tpu_torch.cli.train import main
    from trpo_robot_control_tpu_torch.configs import C3_FRANKA7
    from trpo_robot_control_tpu_torch.trpo.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = C3_FRANKA7.replace(n_envs=16, horizon=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(small, n_iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", "c3_franka7", "--iters", "1", "--n-envs", "16",
              "--horizon", "8"])
    _, hist = train(small, n_iters=1, device="cpu")
    assert len(hist) == 1 and hist[0]["mean_return"] < 0.0


@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3", "c3_franka7",
                                  "c4_franka7_obstacle", "c5_multitask"])
def test_configs_equal_jax(name):
    from trpo_robot_control_tpu.configs import CONFIGS as J
    from trpo_robot_control_tpu_torch.configs import CONFIGS as P
    assert set(P) == set(J)
    assert dataclasses.asdict(P[name]) == dataclasses.asdict(J[name])
    assert P[name].obs_dim == J[name].obs_dim
    assert P[name].arm.reach == J[name].arm.reach


def test_cli_trains_on_cpu(capsys):
    from trpo_robot_control_tpu_torch.cli.train import main
    main(["--config", "c1_reacher2", "--iters", "2", "--n-envs", "16",
          "--horizon", "10", "--device", "cpu", "--seed", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("iter")]
    assert len(lines) == 2 and "return" in lines[0]


def test_cli_has_no_unported_flags():
    """Data and tensor parallelism (ROADMAP A5, A6) are not ported: the CLI
    refuses their flags. The checkpoint, metrics and baseline flags are
    (``tests/test_torch_checkpoint.py``)."""
    from trpo_robot_control_tpu_torch.cli.train import main
    for flag in ("--sharded", "--n-model"):
        with pytest.raises(SystemExit):
            main(["--iters", "1", "--device", "cpu", flag, "1"])


def test_unported_paths_raise():
    from trpo_robot_control_tpu_torch.configs import (C1_REACHER2,
                                                      C3_FRANKA7,
                                                      C4_FRANKA7_OBSTACLE,
                                                      C5_MULTITASK,
                                                      planar_arm)
    from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    make_rollout_fn(C3_FRANKA7)               # ported in slice 2
    make_rollout_fn(C4_FRANKA7_OBSTACLE)      # ported in slice 3
    make_rollout_fn(C5_MULTITASK)
    make_rollout_fn(C3_FRANKA7.replace(done_dist=0.05))     # slice 4
    make_rollout_fn(C1_REACHER2.replace(done_dist=0.05))
    make_rollout_fn(C1_REACHER2.replace(trpo=dataclasses.replace(
        C1_REACHER2.trpo, ff_store_dtype="bf16")))
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        make_rollout_fn(C1_REACHER2.replace(arm=planar_arm(9)))
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        make_rollout_fn(C5_MULTITASK.replace(arm=planar_arm(9)))
    # the MLP baseline and the batch-major update path (slice 16)
    small = C1_REACHER2.replace(n_envs=8, horizon=5)
    mlp = small.replace(trpo=dataclasses.replace(small.trpo,
                                                 baseline="mlp"))
    st = init_state(mlp, device="cpu")
    assert set(st.w) == {"W0", "b0", "W1", "b1"}
    full = make_rollout_fn(small)(st.params, st.gen)
    _, w_new, stats = trpo_update(mlp, st.params, st.w, full)
    assert set(w_new) == set(st.w)
    st = init_state(small, device="cpu")
    batch = {k: full[k] for k in ("obs", "actions", "rewards")}
    _, w_new, stats = trpo_update(small, st.params, st.w, batch)
    assert w_new.shape == st.w.shape
    assert all(bool(torch.isfinite(v)) for v in stats.values())
    with pytest.raises(NotImplementedError, match="data parallelism"):
        trpo_update(small, st.params, st.w, batch, axis_name="data")


@pytest.mark.parametrize("path", ["c5-planar3", "c2-bf16", "planar5"])
def test_rollout_fn_takes_planar_task_mixes_bf16_and_more_links(path):
    """c5's task mix on a 3-link planar arm goes to the 3-D kernel (bf16
    stores, a 15-wide observation with the task one-hot), c2 with bf16
    storage to the planar kernel's bf16 stores, a 5-link planar reacher to
    the planar kernel; each returns the batch's keys and store types."""
    from trpo_robot_control_tpu_torch.configs import (C2_REACHER3,
                                                      C5_MULTITASK, CostSpec,
                                                      planar_arm)
    from trpo_robot_control_tpu_torch.envs.arm import (_planar_route,
                                                       make_rollout_fn)
    from trpo_robot_control_tpu_torch.models import policy
    cfg, planar, store = {
        "c5-planar3": (C5_MULTITASK.replace(arm=planar_arm(3),
                                            cost=CostSpec(ctrl_weight=0.01)),
                       False, torch.bfloat16),
        "c2-bf16": (C2_REACHER3.replace(trpo=dataclasses.replace(
            C2_REACHER3.trpo, ff_store_dtype="bf16")), True, torch.bfloat16),
        "planar5": (C2_REACHER3.replace(arm=planar_arm(5)), True,
                    torch.float32)}[path]
    cfg = cfg.replace(n_envs=16, horizon=4)
    assert _planar_route(cfg) == planar
    gen = torch.Generator().manual_seed(0)
    n = cfg.arm.n_joints
    params = policy.init_params(gen, cfg.obs_dim, n, cfg.trpo.hidden,
                                cfg.trpo.logstd_init)
    batch = make_rollout_fn(cfg)(params, gen)
    assert set(batch) == {"obs", "actions", "rewards", "obs_ff",
                          "actions_ff", "rewards_ff"}
    assert batch["obs_ff"].shape == (4, cfg.obs_dim, 16)
    assert batch["actions_ff"].shape == (4, n, 16)
    assert batch["obs_ff"].dtype == store == batch["actions_ff"].dtype
    assert batch["rewards_ff"].dtype == torch.float32
    if path == "c5-planar3":
        assert cfg.obs_dim == 15
        onehot = batch["obs_ff"][:, -3:].float()
        assert bool((onehot.sum(1) == 1).all())
