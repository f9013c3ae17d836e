"""The port's checkpoints, JSONL metrics and CLI flags
(``utils/checkpoint.py``, ``utils/metrics.py``, ``cli/train.py``).

A checkpoint holds the JAX package's npz keys, so it loads in either
package: the JAX ``save_checkpoint``'s in the port's ``load_checkpoint``
and the port's in JAX's, params and baseline weights bit for bit, for the
linear and the MLP baseline. The port adds its generator's state, so a
resumed run is bit-identical to an uninterrupted one
(``tests/test_train.py``'s resume check)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from test_torch_helpers import n
from trpo_robot_control_tpu.configs import CONFIGS as JCONFIGS
from trpo_robot_control_tpu.trpo.train import init_state as j_init_state
from trpo_robot_control_tpu.utils import checkpoint as jck
from trpo_robot_control_tpu_torch.cli.train import main
from trpo_robot_control_tpu_torch.configs import CONFIGS as PCONFIGS
from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                     make_train_step, train)
from trpo_robot_control_tpu_torch.utils.checkpoint import (config_hash,
                                                           latest_checkpoint,
                                                           load_checkpoint,
                                                           save_checkpoint)
from trpo_robot_control_tpu_torch.utils.metrics import JsonlLogger


def _cfg(baseline, configs=PCONFIGS):
    c = configs["c1_reacher2"]
    return c.replace(n_envs=16, horizon=10, trpo=dataclasses.replace(
        c.trpo, baseline=baseline, baseline_hidden=(16,)))


def _w_items(w):
    return sorted(w.items()) if isinstance(w, dict) else [("w", w)]


def _assert_same_state(a, b):
    assert sorted(a.params) == sorted(b.params)
    for k in a.params:
        np.testing.assert_array_equal(n(a.params[k]), n(b.params[k]))
    wa, wb = _w_items(a.w), _w_items(b.w)
    assert [k for k, _ in wa] == [k for k, _ in wb]
    for (_, x), (_, y) in zip(wa, wb):
        np.testing.assert_array_equal(n(x), n(y))


@pytest.mark.parametrize("baseline", ["linear", "mlp"])
def test_checkpoint_round_trip(tmp_path, baseline):
    cfg = _cfg(baseline)
    state, _ = train(cfg, n_iters=2, seed=3, device="cpu")
    path = save_checkpoint(str(tmp_path), cfg, state)
    assert path.endswith("ckpt_000002.npz")
    back = load_checkpoint(path, cfg, device="cpu")
    _assert_same_state(state, back)
    assert back.iteration == 2
    assert torch.equal(back.gen.get_state(), state.gen.get_state())
    assert isinstance(back.w, dict) == (baseline == "mlp")
    assert latest_checkpoint(str(tmp_path)) == path
    assert latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("baseline", ["linear", "mlp"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, baseline):
    jcfg, pcfg = _cfg(baseline, JCONFIGS), _cfg(baseline)
    assert jck.config_hash(jcfg) == config_hash(pcfg)
    js = j_init_state(jcfg, seed=4)
    path = jck.save_checkpoint(str(tmp_path), jcfg, js)
    ps = load_checkpoint(path, pcfg, device="cpu")
    _assert_same_state(js, ps)
    assert ps.iteration == 0
    # no generator state: seeded from the key's two words, deterministic
    again = load_checkpoint(path, pcfg, device="cpu")
    assert torch.equal(ps.gen.get_state(), again.gen.get_state())
    _, hist = train(pcfg, n_iters=1, state=ps)
    assert np.isfinite(hist[0]["mean_return"])


@pytest.mark.parametrize("baseline", ["linear", "mlp"])
def test_port_checkpoint_loads_in_jax(tmp_path, baseline):
    jcfg, pcfg = _cfg(baseline, JCONFIGS), _cfg(baseline)
    ps = init_state(pcfg, seed=5, device="cpu")
    path = save_checkpoint(str(tmp_path), pcfg, ps)
    js = jck.load_checkpoint(path, jcfg)
    _assert_same_state(ps, js)
    assert np.asarray(js.key).dtype == np.uint32 and js.key.shape == (2,)
    assert int(js.iteration) == 0
    jax.random.split(js.key)                   # a valid JAX key


@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3", "c3_franka7",
                                  "c4_franka7_obstacle", "c5_multitask"])
def test_config_hashes_equal_jax(name):
    assert config_hash(PCONFIGS[name]) == jck.config_hash(JCONFIGS[name])


@pytest.mark.parametrize("baseline", ["linear", "mlp"])
def test_checkpoint_resume_deterministic(tmp_path, baseline):
    cfg = _cfg(baseline)
    step = make_train_step(cfg)
    state = init_state(cfg, seed=1, device="cpu")
    for _ in range(3):
        state, _ = step(state)
    path = save_checkpoint(str(tmp_path), cfg, state)
    state_a, st_a = step(state)
    restored = load_checkpoint(path, cfg, device="cpu")
    state_b, st_b = step(restored)
    _assert_same_state(state_a, state_b)
    assert torch.equal(state_a.gen.get_state(), state_b.gen.get_state())
    for k in st_a:
        assert torch.equal(st_a[k], st_b[k]), k


def test_config_hash_mismatch_rejected(tmp_path):
    cfg = _cfg("linear")
    path = save_checkpoint(str(tmp_path), cfg,
                           init_state(cfg, seed=2, device="cpu"))
    with pytest.raises(ValueError, match="config hash"):
        load_checkpoint(path, cfg.replace(horizon=cfg.horizon + 1),
                        device="cpu")
    load_checkpoint(path, None, device="cpu")        # no cfg: no check


def test_jsonl_logger_lines(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    log = JsonlLogger(str(path))
    log.header({"config": "c1_reacher2"})
    log({"iter": 1, "mean_return": -3.5, "kl": 0.004, "accepted": 0,
         "g_norm": 0.1, "wall_s": 0.02})
    log({"iter": 2, "mean_return": -3.0, "kl": 0.005, "accepted": 1,
         "g_norm": 0.2, "wall_s": 0.03})
    log.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0] == {"config": "c1_reacher2"}
    assert [x["iter"] for x in lines[1:]] == [1, 2]
    assert all(x["t"] >= 0.0 for x in lines[1:])
    assert lines[2]["mean_return"] == -3.0
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0].startswith("iter    1 return")
    quiet = JsonlLogger(None, echo=False)
    quiet({"iter": 3})
    assert capsys.readouterr().err == ""


CLI = ["--config", "c1_reacher2", "--n-envs", "16", "--horizon", "10",
       "--device", "cpu", "--seed", "3"]


def _iter_lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("iter")]


def test_cli_baseline_mlp(capsys, tmp_path):
    main(CLI + ["--iters", "2", "--baseline", "mlp",
                "--ckpt-dir", str(tmp_path)])
    assert len(_iter_lines(capsys)) == 2
    st = load_checkpoint(latest_checkpoint(str(tmp_path)), device="cpu")
    assert isinstance(st.w, dict) and st.w["W0"].shape == (22, 64)  # 2 do + 4


def test_cli_checkpoints_every_and_at_the_end(capsys, tmp_path):
    main(CLI + ["--iters", "5", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "2"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_000002.npz", "ckpt_000004.npz",
                     "ckpt_000005.npz"]
    assert "checkpoint:" in capsys.readouterr().err


def test_cli_resume(capsys, tmp_path):
    main(CLI + ["--iters", "3", "--ckpt-dir", str(tmp_path / "a")])
    straight = _iter_lines(capsys)
    main(CLI + ["--iters", "2", "--ckpt-dir", str(tmp_path / "b")])
    capsys.readouterr()
    main(CLI + ["--iters", "1", "--resume",
                str(tmp_path / "b" / "ckpt_000002.npz")])
    resumed = _iter_lines(capsys)
    assert len(resumed) == 1 and resumed[0].startswith("iter    3")
    # the same line but its wall time
    assert resumed[0].rsplit("  ", 1)[0] == straight[2].rsplit("  ", 1)[0]


def test_cli_jsonl(capsys, tmp_path):
    path = tmp_path / "run.jsonl"
    main(CLI + ["--iters", "2", "--jsonl", str(path)])
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    cfg = PCONFIGS["c1_reacher2"].replace(n_envs=16, horizon=10)
    assert lines[0] == {"config": "c1_reacher2",
                        "config_hash": config_hash(cfg), "n_envs": 16,
                        "horizon": 10}
    assert [x["iter"] for x in lines[1:]] == [1, 2]
    assert {"mean_return", "kl", "accepted", "beta", "wall_s", "t"} \
        <= set(lines[1])


def test_cli_trpo_overrides(capsys, tmp_path, monkeypatch):
    seen = {}
    import trpo_robot_control_tpu_torch.trpo.train as ptrain
    real = ptrain.train

    def spy(cfg, **kw):
        seen["trpo"] = cfg.trpo
        return real(cfg, **kw)

    monkeypatch.setattr(ptrain, "train", spy)
    main(CLI + ["--iters", "1", "--trpo", "cg_iters=7", "--trpo",
                "delta=0.005", "--trpo", "hidden=32,16", "--trpo",
                "fvp_impl=kl"])
    tr = seen["trpo"]
    assert (tr.cg_iters, tr.delta, tr.hidden, tr.fvp_impl) == \
        (7, 0.005, (32, 16), "kl")
    assert len(_iter_lines(capsys)) == 1
    with pytest.raises(SystemExit, match="unknown TRPOSpec field.*cg_iters"):
        main(CLI + ["--iters", "1", "--trpo", "no_such_field=1"])
    with pytest.raises(SystemExit, match="unknown TRPOSpec field"):
        main(CLI + ["--iters", "1", "--trpo", "cg_iters"])
