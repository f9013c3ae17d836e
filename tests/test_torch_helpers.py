"""Shared helpers for the PyTorch port's parity tests (no tests here).

Inputs are made with numpy from a seed and handed to both the JAX package
(on the CPU) and the port (``device="cpu"``), as numpy arrays. JAX is
imported only inside the helpers that need it, so the card-only tests
(``test_torch_cuda.py``) run where JAX is not installed.
"""
import numpy as np
import torch

torch.set_num_threads(1)


def t(x):
    """numpy / JAX array -> fp32 CPU torch tensor."""
    return torch.tensor(np.asarray(x, np.float32))


def j(x):
    """numpy / torch tensor -> fp32 JAX array."""
    import jax.numpy as jnp
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return jnp.asarray(np.asarray(x, np.float32))


def n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def policy_params_np(rng, do, da, hidden=(64, 64), logstd=-0.5,
                     out_scale=0.3):
    """Policy params as numpy, with a non-trivial final layer so the mean
    is not ~0."""
    sizes = [do] + list(hidden) + [da]
    p = {}
    for i in range(len(sizes) - 1):
        s = 1.0 / np.sqrt(sizes[i])
        if i == len(sizes) - 2:
            s *= out_scale
        p[f"W{i}"] = (s * rng.standard_normal((sizes[i], sizes[i + 1]))) \
            .astype(np.float32)
        p[f"b{i}"] = (0.1 * rng.standard_normal(sizes[i + 1])) \
            .astype(np.float32)
    p["logstd"] = np.full(da, logstd, np.float32) \
        + (0.05 * rng.standard_normal(da)).astype(np.float32)
    return p


def env_inputs_np(cfg, N, seed):
    """Initial states, targets and action noise for a rollout, drawn with
    numpy from the reference's distributions."""
    rng = np.random.RandomState(seed)
    spec = cfg.arm
    n = spec.n_joints
    q0 = spec.q0_noise * rng.uniform(-1, 1, (N, n))
    qd0 = spec.qd0_noise * rng.uniform(-1, 1, (N, n))
    r = rng.uniform(spec.target_rmin_frac, spec.target_rmax_frac, N) \
        * spec.reach
    if all(np.allclose(j.rpy, 0.0) for j in spec.joints):
        th = rng.uniform(0, 2 * np.pi, N)
        tgt = np.stack([r * np.cos(th), r * np.sin(th), np.zeros(N)], -1)
    else:       # a normalised 3-normal on the upper hemisphere
        u = rng.standard_normal((N, 3))
        u = u / np.linalg.norm(u, axis=-1, keepdims=True)
        u[:, 2] = np.abs(u[:, 2])
        tgt = r[:, None] * u
    eps = rng.standard_normal((cfg.horizon, N, n))
    return tuple(x.astype(np.float32) for x in (q0, qd0, tgt, eps))


# An obstacle centre beside the 7-DoF arm's third and fourth joint origins
# at q = 0, so that c4's sphere penalty is active from the first step (the
# config's own sphere is reached only as the arm moves).
OBSTACLE_ON_ARM = (0.1, 0.0, 0.7)


def tasks_np(cfg, N, seed):
    """Task families uniform on {0..n_tasks-1}, as the reset draws them."""
    return np.random.RandomState(seed).randint(0, cfg.n_tasks, N) \
        .astype(np.int32)


def jax_batch(cfg, params_np, q0, qd0, tgt, eps):
    """The JAX reference batch: the fused Pallas rollout in interpret mode
    with caller noise, so it carries obs_ff/actions_ff/rewards_ff."""
    from trpo_robot_control_tpu.ops.pallas.rollout_kernel import \
        pallas_rollout
    N = q0.shape[0]
    params = {k: j(v) for k, v in params_np.items()}
    return pallas_rollout(cfg, params, 0, n_envs=N, eps=j(eps),
                          block_b=min(N, 128), interpret=True, q0=j(q0),
                          qd0=j(qd0), tgt=j(tgt))


def jax_batch3d(cfg, params_np, q0, qd0, tgt, eps, store_bf16=True,
                task=None):
    """The JAX reference batch of a 3-D arm: ``rollout3d_reference`` run
    op by op (``jax.disable_jit``: a few seconds, where compiling its scan
    takes a minute on the CPU), with the kernel-native ff views added and
    obs_ff/actions_ff cast to bf16 as the c3-c5 kernel stores them. ``task``
    (N,) int: each env's task family, for configs with several."""
    import jax
    import jax.numpy as jnp

    from trpo_robot_control_tpu.ops.pallas.rollout3d_kernel import \
        rollout3d_reference
    with jax.disable_jit():
        ref = rollout3d_reference(
            cfg, {k: j(v) for k, v in params_np.items()}, j(q0), j(qd0),
            j(tgt), j(eps), task=None if task is None else jnp.asarray(task))
    ref = {k: jnp.asarray(np.asarray(v)) for k, v in ref.items()}
    dt = jnp.bfloat16 if store_bf16 else jnp.float32
    return dict(ref, obs_ff=jnp.transpose(ref["obs"], (1, 2, 0)).astype(dt),
                actions_ff=jnp.transpose(ref["actions"], (1, 2, 0)).astype(dt),
                rewards_ff=ref["rewards"].T)


def torch_ff(x):
    """A JAX / numpy (T, d, N) array -> torch, keeping bf16 as bf16 (the
    values pass through fp32 exactly)."""
    out = t(np.asarray(x, np.float32))
    return out.to(torch.bfloat16) if str(np.asarray(x).dtype) == "bfloat16" \
        else out


def torch_batch_from_jax(batch):
    from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
    return batch_from_ff(torch_ff(batch["obs_ff"]),
                         torch_ff(batch["actions_ff"]),
                         t(batch["rewards_ff"]))


def jit_jax_update(cfg):
    import jax

    from trpo_robot_control_tpu.trpo.update import trpo_update
    return jax.jit(lambda p, w, b: trpo_update(cfg, p, w, b,
                                               return_directions=True))
