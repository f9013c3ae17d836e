"""Shared helpers for the PyTorch port's parity tests (no tests here).

Inputs are made with numpy from a seed and handed to both the JAX package
(on the CPU) and the port (``device="cpu"``), as numpy arrays. JAX is
imported only inside the helpers that need it, so the card-only tests
(``test_torch_cuda.py``) run where JAX is not installed.
"""
import functools

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
                         t(batch["rewards_ff"]),
                         t(batch["dones_ff"]) if "dones_ff" in batch else None)


def jax_ff_batch(cfg, batch):
    """A batch-major JAX batch (numpy) with the kernel-native views added:
    obs_ff, actions_ff (T, d, N), in bf16 when the config stores bf16,
    rewards_ff and dones_ff (T, N)."""
    import jax.numpy as jnp
    dt = jnp.bfloat16 if cfg.trpo.ff_store_dtype == "bf16" else jnp.float32
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    out.update(obs_ff=jnp.asarray(batch["obs"].transpose(1, 2, 0)).astype(dt),
               actions_ff=jnp.asarray(
                   batch["actions"].transpose(1, 2, 0)).astype(dt),
               rewards_ff=jnp.asarray(batch["rewards"].T))
    if "dones" in batch:
        out["dones_ff"] = jnp.asarray(batch["dones"].T)
    return out


def jax_init_params_np(cfg, seed):
    """The JAX package's policy initialisation, as numpy."""
    import jax

    from trpo_robot_control_tpu.models import policy as jpol
    p = jpol.init_params(jax.random.PRNGKey(seed), cfg.obs_dim,
                         cfg.arm.n_joints, cfg.trpo.hidden,
                         cfg.trpo.logstd_init)
    return {k: np.asarray(v) for k, v in p.items()}


def check_update_parity(jcfg, pcfg, params_np, jbatch):
    """The port's trpo_update against the JAX package's on the same batch,
    held to tests/test_parity.py's criteria: direction cosine >= 0.999,
    |beta| relative error <= 1e-3, the same accepted exponent. Returns the
    port's stats."""
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    from trpo_robot_control_tpu_torch.utils.convert import (
        params_from_numpy, w_from_numpy)
    w0 = np.zeros(2 * jcfg.obs_dim + 4, np.float32)
    _, _, st_j = jit_jax_update(jcfg)({k: j(v) for k, v in params_np.items()},
                                      j(w0), jbatch)
    _, w_t, st_t = trpo_update(pcfg, params_from_numpy(params_np, "cpu"),
                               w_from_numpy(w0, "cpu"),
                               torch_batch_from_jax(jbatch),
                               return_directions=True)
    assert cosine(n(st_t["x"]), st_j["x"]) >= 0.999
    beta_j = float(st_j["beta"])
    assert abs(float(st_t["beta"]) - beta_j) / beta_j <= 1e-3
    assert int(st_t["accepted"]) == int(st_j["accepted"])
    assert bool(torch.isfinite(w_t).all())
    return st_t


@functools.lru_cache(maxsize=None)
def jit_jax_update(cfg):
    """JAX's ``trpo_update`` for ``cfg``, jitted once per config in a
    process (the configs are frozen dataclasses), so the tests that update
    at one config share its compilation."""
    import jax

    from trpo_robot_control_tpu.trpo.update import trpo_update
    return jax.jit(lambda p, w, b: trpo_update(cfg, p, w, b,
                                               return_directions=True))


@functools.lru_cache(maxsize=None)
def jit_jax_rollout(cfg):
    """JAX's ``envs/arm.py:rollout`` for ``cfg`` with its policy's sampling,
    jitted once per config in a process: ``fn(params, key) -> batch``."""
    import jax

    from trpo_robot_control_tpu.envs import arm as jarm
    from trpo_robot_control_tpu.models import policy as jpol
    return jax.jit(lambda p, k: jarm.rollout(cfg, p, jpol.sample, k))


def jax_terminating(cfg, params_np, seed):
    """JAX's terminating rollout (``envs/arm.py:rollout``, jitted) from
    ``PRNGKey(seed)``, and the draws it made, reproduced from the same key:
    the initial state (q, qd, tgt, task), the action noise eps (T, N, n)
    and the fresh episodes (q, qd, tgt, task) with a leading T axis, row t
    being what an env done at step t starts. All numpy."""
    import jax

    from trpo_robot_control_tpu.envs import arm as jarm
    N, T, n_j = cfg.n_envs, cfg.horizon, cfg.arm.n_joints
    key = jax.random.PRNGKey(seed)
    params = {k: j(v) for k, v in params_np.items()}
    batch = jit_jax_rollout(cfg)(params, key)
    k_reset, k_roll = jax.random.split(key)
    s0 = jarm.reset(cfg, k_reset, N)
    eps, fresh = [], []
    for k_t in jax.random.split(k_roll, T):
        k_act, k_re = jax.random.split(k_t)
        eps.append(np.asarray(jax.random.normal(k_act, (N, n_j))))
        fresh.append(jarm.reset(cfg, k_re, N))
    fresh = tuple(np.stack([np.asarray(f[i]) for f in fresh])
                  for i in range(4))
    return ({k: np.asarray(v) for k, v in batch.items()},
            tuple(np.asarray(x) for x in s0), np.stack(eps), fresh)


def torch_state(x):
    """A (q, qd, tgt, task) numpy tuple -> torch, task as int32."""
    return (t(x[0]), t(x[1]), t(x[2]),
            torch.tensor(np.asarray(x[3], np.int32)))


def done_mismatch(d_port, d_jax, obs_port, obs_jax, rows, done_dist):
    """The assertion message for done flags (T, N) that differ: at each
    such step, the distance the side that did not reset reports in its
    next observation (the target-minus-end-effector rows), beside
    done_dist. A distance within fp32 drift of done_dist is a near-tie
    between two orders of the same arithmetic."""
    out = []
    for tt, e in np.argwhere(d_port != d_jax)[:5]:
        obs = obs_port if d_port[tt, e] < 0.5 else obs_jax
        dist = float(np.linalg.norm(obs[tt + 1, rows, e]))
        out.append(f"step {tt} env {e}: distance {dist:.7f} vs done_dist "
                   f"{done_dist} (margin {dist - done_dist:+.2e})")
    return "done flags differ: " + "; ".join(out)


def check_against_jax(name, N, T, done_dist, seed, atol_obs, atol_rew,
                      params_np=None):
    """The port's terminating plain rollout (K1's or K4's, as the port's
    rollout function routes the config) on the draws of JAX's terminating
    rollout of config ``name`` (a name of both packages' ``CONFIGS``, or a
    (JAX config, port config) pair) from ``PRNGKey(seed)`` with
    ``params_np`` (default: ``policy_params_np`` of ``seed``): identical
    done flags before the last step, at least one of them set, and obs,
    act, rew within the given tolerances. Returns (early dones, JAX
    config, port config, params, JAX batch)."""
    from trpo_robot_control_tpu.configs import CONFIGS as JCONFIGS
    from trpo_robot_control_tpu_torch.configs import CONFIGS as PCONFIGS
    from trpo_robot_control_tpu_torch.envs.arm import _planar_route
    from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
    from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk
    jbase, pbase = ((JCONFIGS[name], PCONFIGS[name]) if isinstance(name, str)
                    else name)
    jcfg = jbase.replace(n_envs=N, horizon=T, done_dist=done_dist)
    pcfg = pbase.replace(n_envs=N, horizon=T, done_dist=done_dist)
    pn = params_np if params_np is not None else policy_params_np(
        np.random.RandomState(seed), jcfg.obs_dim, jcfg.arm.n_joints)
    bj, s0, eps, fresh = jax_terminating(jcfg, pn, seed)
    pt = {k: t(v) for k, v in pn.items()}
    q0, qd0, tgt, task = torch_state(s0)
    if _planar_route(pcfg):
        out = rk.rollout(pcfg, pt, q0, qd0, tgt, eps=t(eps),
                         fresh=torch_state(fresh))
    else:
        out = r3.rollout3d(pcfg, pt, q0, qd0, tgt, task, eps=t(eps),
                           fresh=torch_state(fresh))
    obs, act, rew, dones = (n(x) for x in out)
    d_jax = bj["dones"].T                         # (T, N), last row 1
    nj = jcfg.arm.n_joints
    rows = slice(3 * nj, 3 * nj + 3)
    obs_jax = bj["obs"].transpose(1, 2, 0)
    early = int(d_jax[:-1].sum())
    assert early > 0, "no early done: the branch was not exercised"
    assert np.array_equal(dones[:-1], d_jax[:-1]), done_mismatch(
        dones[:-1], d_jax[:-1], obs, obs_jax, rows, done_dist)
    np.testing.assert_allclose(obs, obs_jax, atol=atol_obs, err_msg="obs")
    np.testing.assert_allclose(act, bj["actions"].transpose(1, 2, 0),
                               atol=atol_obs, err_msg="actions")
    np.testing.assert_allclose(rew, bj["rewards"].T, atol=atol_rew,
                               err_msg="rewards")
    return early, jcfg, pcfg, pn, bj


# fp32 roundings of a sum's magnitude that an fp32 implementation may be
# off from the exact sum, in ``surrogate_grad_fp64``'s ambiguity test
AMBIG_ULPS = 4


def surrogate_grad_fp64(params, obs_ff, act_ff, adv_ff, ulps=AMBIG_ULPS,
                        B=None):
    """The bf16-mode surrogate gradient (``policy.surrogate_grad_ff`` with
    bf16 storage) evaluated in fp64, on the tensors' device, with what an
    fp32 implementation may differ from it by.

    Every hidden activation h_l and back-propagated cotangent g_l is
    rounded to bf16 where the port rounds it (any depth). An
    fp32 implementation's value before such a rounding may be off from
    this one by ``ulps`` fp32 roundings of the terms' magnitude (sum of
    |terms|, through tanh's slope); where the bf16 roundings of the two
    ends of that interval differ, the rounding is ambiguous and either
    bf16 neighbour is right. Returns a dict:

    - ``mu``, ``g`` (a tree like the port's): the fp64 values;
    - ``mu_slack`` (T, da, N): how far mu may move through ambiguous h_l
      roundings (|W_L|^T of each last h's spread, with every earlier
      layer's spread carried into the next one's interval). An fp32 mu is within mu_slack plus its
      own sums' error of ``mu``;
    - ``kept`` (T, N) bool: samples with no ambiguous rounding;
    - ``g_kept``: ``g`` over the kept samples only, which is what an fp32
      implementation gives for ``adv_ff * kept`` up to its own sums.

    ``B`` is the whole batch's T * N where the call gets a slice of it."""
    p = {k: v.double() for k, v in params.items()}
    ab = {k: v.abs() for k, v in p.items()}
    L = sum(1 for k in p if k.startswith("W")) - 1
    T, _, N = obs_ff.shape
    B = B or T * N
    x, a, adv = obs_ff.double(), act_ff.double(), adv_ff.double()[:, None]

    def fwd(W, h):
        return torch.einsum("io,tin->ton", W, h)

    def bwd(W, c):
        return torch.einsum("io,ton->tin", W, c)

    def rnd(v):
        return v.float().to(torch.bfloat16).double()

    eps = ulps * 2.0 ** -24
    hs, spread = [], torch.zeros_like(x)
    amb = torch.zeros(T, N, dtype=torch.bool, device=x.device)
    h = x
    for i in range(L):
        v = torch.tanh(fwd(p[f"W{i}"], h) + p[f"b{i}"][:, None])
        dz = fwd(ab[f"W{i}"], spread)
        e = eps * ((1 - v * v) * (fwd(ab[f"W{i}"], h.abs())
                                  + ab[f"b{i}"][:, None]) + v.abs()) \
            + (1 - (v.abs() - dz).clamp(min=0) ** 2) * dz
        h = rnd(v)
        spread = torch.maximum(rnd(v + e) - h, h - rnd(v - e))
        amb |= (spread > 0).any(1)
        hs.append(h)
    mu = fwd(p[f"W{L}"], h) + p[f"b{L}"][:, None]
    mu_slack = fwd(ab[f"W{L}"], spread)
    inv_var = torch.exp(-2 * p["logstd"])[:, None]
    z = (a - mu) * torch.exp(-p["logstd"])[:, None]
    ct = adv * (a - mu) * inv_var / B
    mag = adv.abs() * inv_var / B * (fwd(ab[f"W{L}"], h.abs())
                                     + ab[f"b{L}"][:, None] + (a - mu).abs())
    cts = [ct]
    for l in range(L, 0, -1):
        d = 1 - hs[l - 1] ** 2
        v = bwd(p[f"W{l}"], ct) * d
        e = eps * (d * bwd(ab[f"W{l}"], mag) + v.abs())
        amb |= (rnd(v + e) != rnd(v - e)).any(1)
        ct = rnd(v)
        mag = ct.abs()
        cts.append(ct)

    def grads(m):
        g = {"logstd": (adv * m * (z * z - 1)).sum((0, 2)) / B}
        for l, c, h_in in zip(range(L, -1, -1), cts, hs[::-1] + [x]):
            g[f"W{l}"] = torch.einsum("tin,ton->io", h_in, c * m)
            g[f"b{l}"] = (c * m).sum((0, 2))
        return g

    kept = ~amb
    return dict(mu=mu, g=grads(1.0),
                g_kept=grads(kept.double()[:, None]), mu_slack=mu_slack,
                kept=kept)


# an fp32 bf16-mode surrogate gradient against ``surrogate_grad_fp64``:
# mu within its slack plus this, g on the kept samples within this
# relative L2 (their fp32 sums' error; the plain version's is ~3e-7)
PG_MU_FP64_ATOL = 1e-5
PG_G_KEPT_REL = 1e-5


def pg_fp64_errors(ref, mu, g_masked):
    """(max of |mu - ref mu| less its slack, relative L2 distance of the
    gradient for ``adv * ref["kept"]`` from ``ref["g_kept"]``)."""
    from trpo_robot_control_tpu_torch.models import policy
    over = float(((mu.double() - ref["mu"]).abs() - ref["mu_slack"]).max())
    f = policy.flatten(g_masked).double()
    f64 = policy.flatten(ref["g_kept"])
    return over, float(torch.linalg.norm(f - f64) / torch.linalg.norm(f64))


# The FVP kernels' plane products (csrc/fvp.cu, fvp_ff.cu): hi hi, then
# the five others that hold fp32's 24 bits
SIX_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def _plane_products(pairs):
    """(planes, mm, tr) of the FVP kernels' split statements: ``planes``
    splits an fp32 tensor into the three bf16 planes of
    ``pg_kernel.split3`` (in fp64); ``mm(*terms)`` sums the plane products
    ``pairs`` of each (A planes, B planes) term in fp64, hi hi on its own
    and the others together, each rounded to fp32 where the kernels'
    accumulators round, then added in fp32; ``tr`` transposes planes."""
    from trpo_robot_control_tpu_torch.ops.cuda.pg_kernel import split3
    rest = [pq for pq in pairs if pq != (0, 0)]

    def planes(x):
        return [p.double() for p in split3(x.float())]

    def mm(*terms):
        hi = sum(a[0] @ b[0] for a, b in terms).float()
        if not rest:
            return hi
        return hi + sum(a[p] @ b[q] for a, b in terms for p, q in rest).float()

    def tr(ps):
        return [p.transpose(-1, -2) for p in ps]

    return planes, mm, tr


def _reduce_tiles(flat, blocks, v, damping):
    """The kernels' sums over tiles: flat (tiles, Pg) per-tile gradients,
    added in fp32 per block over its tiles (block b takes tiles b, b + G,
    ...), the blocks' partials summed in the reduce pass's order (8
    groups, blocks g, g + 8, ...), then the damping and the logstd block."""
    n_tiles = flat.shape[0]
    G = min(n_tiles, blocks)
    part = []
    for b in range(G):
        tot = flat[b]
        for i in range(b + G, n_tiles, G):
            tot = tot + flat[i]
        part.append(tot)
    groups = []
    for gi in range(8):
        s = torch.zeros_like(flat[0])
        for b in range(gi, G, 8):
            s = s + part[b]
        groups.append(s)
    red = groups[0]
    for s in groups[1:]:
        red = red + s
    Pg = red.shape[0]
    return torch.cat([red + damping * v[:Pg],
                      2.0 * v[Pg:] + damping * v[Pg:]])


def _flat_grads(per_tile, n_tiles):
    return torch.cat([per_tile[k].reshape(n_tiles, -1)
                      for k in ("W0", "W1", "W2", "b0", "b1", "b2")], 1)


def gn_fvp_ff_split(params, obs_sub_ff, v, damping, pairs=SIX_PAIRS,
                    blocks=None):
    """A PyTorch statement of K6's arithmetic, on the tensors' device.

    Every 64-wide product takes its operands as the three bf16 planes of
    ``pg_kernel.split3`` (a bf16 x is its own hi plane, the other two
    zero) and sums the plane products ``pairs`` (``_plane_products``). The
    da-wide head runs in fp32. Samples go in the kernel's tiles of one
    time step and ``fvp_ff_kernel.TILE`` envs (padding gets u = 0); the
    weight gradients are per-tile sums, summed as ``_reduce_tiles`` says."""
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_ff_kernel
    blocks = blocks or fvp_ff_kernel.MAX_BLOCKS
    tile = fvp_ff_kernel.TILE
    planes, mm, tr = _plane_products(pairs)
    Ts, do, N = obs_sub_ff.shape
    nt = -(-N // tile)
    dev = obs_sub_ff.device
    x = torch.zeros(Ts, nt * tile, do, device=dev)
    x[:, :N] = obs_sub_ff.permute(0, 2, 1).float()
    x = x.reshape(Ts * nt, tile, do)
    mask = torch.zeros(Ts, nt * tile, 1, device=dev)
    mask[:, :N] = 1.0
    mask = mask.reshape(Ts * nt, tile, 1)
    p, t = params, policy.unflatten(v, params)
    scale = torch.exp(-2.0 * p["logstd"]) / (Ts * N)
    xp, w0, dw0 = planes(x), planes(p["W0"]), planes(t["W0"])
    w1, dw1 = planes(p["W1"]), planes(t["W1"])
    h0 = torch.tanh(mm((xp, w0)) + p["b0"])
    dh0 = (1.0 - h0 * h0) * (mm((xp, dw0)) + t["b0"])
    h0p = planes(h0)
    h1 = torch.tanh(mm((h0p, w1)) + p["b1"])
    dh1 = (1.0 - h1 * h1) * (mm((planes(dh0), w1), (h0p, dw1)) + t["b1"])
    u = (dh1 @ p["W2"] + h1 @ t["W2"] + t["b2"]) * scale * mask
    g1 = (u @ p["W2"].T) * (1.0 - h1 * h1)
    g1p = planes(g1)
    g0 = mm((g1p, tr(w1))) * (1.0 - h0 * h0)
    per_tile = {"W0": mm((tr(xp), planes(g0))), "W1": mm((tr(h0p), g1p)),
                "W2": h1.transpose(1, 2) @ u, "b0": g0.sum(1),
                "b1": g1.sum(1), "b2": u.sum(1)}
    return _reduce_tiles(_flat_grads(per_tile, Ts * nt), blocks, v, damping)


def gn_fvp_split(params, obs, hs, v, damping, pairs=SIX_PAIRS, blocks=None):
    """A PyTorch statement of K3's arithmetic (``csrc/fvp.cu``), the
    batch-major twin of ``gn_fvp_ff_split``, on the tensors' device.

    The activations h0, h1 = ``hs`` are read as given, not recomputed. The
    six 64-wide products (x dW0, dh0 W1 + h0 dW1, g1 W1^T, h0^T g1,
    x^T g0) take their fp32 operands as three bf16 planes and sum the
    plane products ``pairs`` (``_plane_products``); the da-wide head runs
    in fp32. Samples go in the kernel's tiles of ``fvp_kernel.TILE``
    (padding gets x = h0 = h1 = 0 and u = 0); the weight gradients are
    per-tile sums, summed as ``_reduce_tiles`` says over the kernel's grid
    of at most ``fvp_kernel.MAX_BLOCKS`` blocks."""
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel
    blocks = blocks or fvp_kernel.MAX_BLOCKS
    tile = fvp_kernel.TILE
    planes, mm, tr = _plane_products(pairs)
    B, do = obs.shape
    nt = -(-B // tile)
    dev = obs.device

    def padded(a):
        out = torch.zeros(nt * tile, a.shape[1], device=dev)
        out[:B] = a.float()
        return out.reshape(nt, tile, a.shape[1])

    x, h0, h1 = padded(obs), padded(hs[0]), padded(hs[1])
    mask = padded(torch.ones(B, 1, device=dev))
    p, t = params, policy.unflatten(v, params)
    scale = torch.exp(-2.0 * p["logstd"]) / B
    xp, h0p = planes(x), planes(h0)
    w1 = planes(p["W1"])
    dh0 = (1.0 - h0 * h0) * (mm((xp, planes(t["W0"]))) + t["b0"])
    dh1 = (1.0 - h1 * h1) * (mm((planes(dh0), w1), (h0p, planes(t["W1"])))
                             + t["b1"])
    u = (dh1 @ p["W2"] + h1 @ t["W2"] + t["b2"]) * scale * mask
    g1 = (u @ p["W2"].T) * (1.0 - h1 * h1)
    g1p = planes(g1)
    g0 = mm((g1p, tr(w1))) * (1.0 - h0 * h0)
    per_tile = {"W0": mm((tr(xp), planes(g0))), "W1": mm((tr(h0p), g1p)),
                "W2": h1.transpose(1, 2) @ u, "b0": g0.sum(1),
                "b1": g1.sum(1), "b2": u.sum(1)}
    return _reduce_tiles(_flat_grads(per_tile, nt), blocks, v, damping)


def gn_fvp_wide_split(params, obs, hs, v, damping, pairs=SIX_PAIRS,
                      splits=None):
    """A PyTorch statement of K3's wide form's arithmetic (``csrc/fvp.cu``,
    ``namespace wide``; a hidden layer over 64 units, any depth), on the
    tensors' device.

    The activations ``hs`` are read as given. Per sample: the forward
    tangent layer by layer (x dW0, then dh_{l-1} W_l + h_{l-1} dW_l, each
    fp32 operand as three bf16 planes and the plane products ``pairs``
    summed, hi hi on its own, as ``_plane_products`` states), the head in
    fp32, u, and the reverse chain g_{l-1} = (g_l W_l^T)(1 - h_{l-1}^2) the
    same way. Then each layer's weight gradient and bias sum as one plane
    product [a_j; 1]^T g_j (a_0 = x, a_j = h_{j-1}, g_L = u) over each
    chunk of ``fvp_kernel.WIDE_CHUNK`` samples (hi and ml rounded once a
    chunk), the chunks of a split added in order in fp32; the splits
    (``splits`` of them: by default the kernel's, ``fvp_kernel.WIDE_SPLIT``
    samples a split, at most ``fvp_kernel.MAX_BLOCKS``, each a whole
    number of chunks) summed in the reduce pass's order
    (``_reduce_tiles``)."""
    from trpo_robot_control_tpu_torch.models import policy
    from trpo_robot_control_tpu_torch.ops.cuda import fvp_kernel
    planes, mm, tr = _plane_products(pairs)
    L = len(hs)
    B = obs.shape[0]
    S = splits or min(-(-B // fvp_kernel.WIDE_SPLIT), fvp_kernel.MAX_BLOCKS)
    C = fvp_kernel.WIDE_CHUNK
    span = -(-(-(-B // S)) // C) * C
    p, t = params, policy.unflatten(v, params)
    x, hs = obs.float(), [h.float() for h in hs]
    scale = torch.exp(-2.0 * p["logstd"]) / B
    dh = (1.0 - hs[0] * hs[0]) * (mm((planes(x), planes(t["W0"]))) + t["b0"])
    for l in range(1, L):
        dh = (1.0 - hs[l] * hs[l]) * (
            mm((planes(dh), planes(p[f"W{l}"])),
               (planes(hs[l - 1]), planes(t[f"W{l}"]))) + t[f"b{l}"])
    u = (dh @ p[f"W{L}"] + hs[L - 1] @ t[f"W{L}"] + t[f"b{L}"]) * scale
    gs = [None] * L + [u]
    gs[L - 1] = (u @ p[f"W{L}"].T) * (1.0 - hs[L - 1] * hs[L - 1])
    for l in range(L - 1, 0, -1):
        gs[l - 1] = mm((planes(gs[l]), tr(planes(p[f"W{l}"])))) \
            * (1.0 - hs[l - 1] * hs[l - 1])

    def chunks(a):
        """(B, w) -> (S, chunks a split, C, w), zero past B."""
        out = torch.zeros(S * span, a.shape[1], device=a.device)
        out[:B] = a
        return out.reshape(S, span // C, C, a.shape[1])

    ones = torch.ones(B, 1, device=obs.device)
    ws, bs = [], []
    for a, g in zip([x] + hs[:L], gs):
        r = mm((tr(planes(chunks(torch.cat([a, ones], 1)))),
                planes(chunks(g))))
        tot = r[:, 0]
        for i in range(1, r.shape[1]):
            tot = tot + r[:, i]
        ws.append(tot[:, :-1].reshape(S, -1))
        bs.append(tot[:, -1])
    return _reduce_tiles(torch.cat(ws + bs, 1), S, v, damping)


def mean_fmaf(params, obs):
    """The policy mean of obs (do, n) before the head's bias as the rollout
    kernels sum it, on the tensors' device: each unit one fmaf chain over
    its inputs in index order from 0 (every product exact in fp64, every
    sum rounded to fp32 once), tanh(z + b) between layers. A matrix
    product may sum in another order (cuBLAS picks its kernel by shape),
    so where a kernel and its plain version part, this says whose order
    the kernel's step-0 actions follow."""
    L = sum(1 for k in params if k.startswith("W"))
    h = obs.float()
    for l in range(L):
        W = params[f"W{l}"].double()
        z = torch.zeros(W.shape[1], h.shape[1], device=h.device)
        for d in range(W.shape[0]):
            z = (z.double() + W[d][:, None] * h[d].double()[None, :]).float()
        h = torch.tanh(z + params[f"b{l}"][:, None]) if l < L - 1 else z
    return h


def spd_system_np(do, cond, seed):
    """A (F, F), b (F,) fp32, F = 2 do + 4: A = D M D, M with eigenvalues
    log-spaced over [1/cond, 1] in a random basis, D spread over six
    decades (what fit_normal's Jacobi scaling undoes)."""
    rng = np.random.RandomState(seed)
    F = 2 * do + 4
    Q, _ = np.linalg.qr(rng.standard_normal((F, F)))
    M = (Q * np.logspace(0, -np.log10(cond), F)) @ Q.T
    D = np.exp(rng.uniform(-3, 3, F))
    A = (D[:, None] * M * D[None, :]).astype(np.float32)
    return 0.5 * (A + A.T), rng.standard_normal(F).astype(np.float32)


def fp64_floored_solve(A, b, rel_floor=1e-6):
    """fit_normal's solve in fp64 on A's device: (w (F,) fp64, the kept
    spectrum's condition number lambda_max / smallest kept lambda)."""
    A64, b64 = A.double(), b.double()
    d = torch.sqrt(torch.diagonal(A64) + 1e-20)
    lam, Q = torch.linalg.eigh(A64 / (d[:, None] * d[None, :]))
    keep = lam > rel_floor * lam[-1]
    inv = torch.where(keep, 1.0 / lam, torch.zeros_like(lam))
    return Q @ (inv * (Q.T @ (b64 / d))) / d, float(lam[-1] / lam[keep].min())


def a_norm_rel(A, w, ref):
    """||w - ref||_A / ||ref||_A in fp64: the relative error of the
    predictions phi @ w over the batch whose normal equations A holds."""
    A64, e, r = A.double(), (w - ref).double(), ref.double()
    return float(torch.sqrt(e @ A64 @ e) / torch.sqrt(r @ A64 @ r))


# fit_normal against the fp64 floored solve, in the A-norm: within
# FIT_UNITS fp32 unit roundoffs times the kept condition number, the most
# any fp32 solve of an fp32 A_s promises, and never past a fixed cap set
# from readings (``fit_bound``), so that w = 0 (which reads 1.0) fails
FIT_UNITS = 20.0
# the cap on SPD systems with a random right-hand side (spd_system_np):
# at kept condition ~1e6 fp32 Jacobi and fp32 eigh alike read up to 0.27
FIT_CAP_SPD = 0.5
# the statement's eigenpairs: ||A_s Q - Q diag(lambda)||_F / ||A_s||_F
# (readings up to 1.5e-6 at F = 68), and w against the fp64 solve with
# those same pairs, in the A-norm (readings up to 4.3e-5): the solve's
# own rounding, free of the condition number
FIT_RES_TOL = 1e-5
FIT_SOLVE_TOL = 5e-4


def fit_bound(kept_cond, cap):
    """The bound on ``a_norm_rel`` of an fp32 fit against the fp64 one."""
    return min(FIT_UNITS * 2.0 ** -24 * kept_cond, cap)


def fit_pairs_errors(A, b, w, lam, Q, rel_floor=1e-6):
    """(the backward residual of the pairs (lam, Q) of A_s, w's A-norm
    error against the fp64 floored solve with those pairs): the first
    holds the eigendecomposition, the second the floor and the solve."""
    A64 = A.double()
    d = torch.sqrt(torch.diagonal(A64) + 1e-20)
    S = A64 / (d[:, None] * d[None, :])
    lam, Q = lam.double(), Q.double()
    res = float(torch.linalg.norm(S @ Q - Q * lam) / torch.linalg.norm(S))
    inv = torch.where(lam > rel_floor * lam.max(), 1.0 / lam,
                      torch.zeros_like(lam))
    ref = Q @ (inv * (Q.T @ (b.double() / d))) / d
    return res, a_norm_rel(A, w, ref)


def state_leaves(st):
    """A train state's parameters, then its baseline weights (a linear
    baseline's one tensor, or the MLP's dict), in a fixed order."""
    w = st.w if isinstance(st.w, dict) else {"w": st.w}
    return [st.params[k] for k in sorted(st.params)] \
        + [w[k] for k in sorted(w)]


def _round_robin(m):
    """The fit_normal kernel's schedule over m (even) indices: per round r
    the (p, q), p < q, of pair 0 = (r, m - 1) and pair k = (r + k, r - k)
    mod m - 1, as index tensors."""
    rounds = []
    for r in range(m - 1):
        pr = [(r, m - 1)] + [
            tuple(sorted(((r + k) % (m - 1), (r - k + m - 1) % (m - 1))))
            for k in range(1, m // 2)]
        rounds.append((torch.tensor([p for p, _ in pr]),
                       torch.tensor([q for _, q in pr])))
    return rounds


def fixed_position_schedule(m):
    """The fit_normal kernel's schedule as it walks it (``csrc/
    fit_normal.cu``): index i < m - 1 sits at position (i - r) mod (m - 1)
    in round r and index m - 1 at m - 1; every round pairs positions
    (k, m - 1 - k), pair k; between rounds every index but m - 1 moves down
    one position, cyclically; a pair's p (the angle's sign) is its smaller
    index. Returns ([(layout, pairs)] per round, the layout after the m - 1
    rounds): layout[pos] the index at pos, pairs[k] = (p, q), p < q."""
    layout = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = [tuple(sorted((layout[k], layout[m - 1 - k])))
                 for k in range(m // 2)]
        rounds.append((list(layout), pairs))
        layout = layout[1:m - 1] + layout[:1] + [m - 1]
    return rounds, layout


def schedule_index_at(pos, r, m):
    """The index at position ``pos`` in round ``r``, in closed form (the
    kernel steps it: one up, mod m - 1, a round, position m - 1 fixed)."""
    return m - 1 if pos == m - 1 else (pos + r) % (m - 1)


def schedule_position_of(i, r, m):
    """Index ``i``'s position in round ``r``, in closed form (the kernel's
    row threads step it: one down, mod m - 1, a round)."""
    return m - 1 if i == m - 1 else (i - r) % (m - 1)


def _square_sum(S, off):
    """sum of S's squares (off: the diagonal skipped), summed as the kernel
    sums them: row i in column order, then the rows in order."""
    m = S.shape[0]
    zero = torch.zeros((), device=S.device)
    diag = torch.arange(m, device=S.device)
    rows = torch.zeros(m, device=S.device)
    for j in range(m):
        sq = S[:, j] * S[:, j]
        rows = rows + (torch.where(diag == j, zero, sq) if off else sq)
    tot = zero
    for i in range(m):
        tot = tot + rows[i]
    return tot


def fit_normal_jacobi_statement(A, b, eps=1e-20, rel_floor=1e-6, tol=None,
                                max_sweeps=None):
    """The arithmetic of the fit_normal kernel (``ops/cuda/csrc/
    fit_normal.cu``) as fp32 tensor ops on A's device, each separately
    rounded, in the kernel's order: the Jacobi scaling, cyclic two-sided
    Jacobi in the kernel's round-robin order with Rutishauser's angles
    (rows rotated by a pair's angle, then columns; the block of pairs
    (P, Q), P < Q, mirrored below the diagonal; a diagonal block
    a_pp - t a_pq, a_qq + t a_pq and zeros), the stop rule (off-diagonal
    squares <= tol^2 ||A_s||_F^2 before a sweep, at most ``max_sweeps``),
    the floor and the solve, each sum in the kernel's order. Returns (w,
    lambda, Q, sweeps) with the eigenpairs in the kernel's order."""
    from trpo_robot_control_tpu_torch.ops.cuda import fit_kernel
    tol = fit_kernel.TOL if tol is None else tol
    max_sweeps = fit_kernel.MAX_SWEEPS if max_sweeps is None else max_sweeps
    A, b = A.float(), b.float()
    dev, m = A.device, A.shape[0]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    zero = f32(0.0)
    d = torch.sqrt(torch.diagonal(A) + f32(eps))
    S = A / (d[:, None] * d[None, :])
    V = torch.eye(m, device=dev)
    thr = f32(tol * tol) * _square_sum(S, False)
    pair_of = torch.empty(m, dtype=torch.long, device=dev)
    sweeps = 0
    for _ in range(max_sweeps):
        if bool(_square_sum(S, True) <= thr):
            break
        sweeps += 1
        for p, q in _round_robin(m):
            p, q = p.to(dev), q.to(dev)
            app, aqq, apq = S[p, p], S[q, q], S[p, q]
            theta = (aqq - app) / (f32(2.0) * apq)
            sgn = torch.where(theta >= 0, f32(1.0), f32(-1.0))
            t = sgn / (torch.abs(theta)
                       + torch.sqrt(theta * theta + f32(1.0)))
            t = torch.where(apq == 0, zero, t)
            c = f32(1.0) / torch.sqrt(t * t + f32(1.0))
            s = t * c
            X = S.clone()
            X[p] = c[:, None] * S[p] - s[:, None] * S[q]
            X[q] = s[:, None] * S[p] + c[:, None] * S[q]
            Y = X.clone()
            Y[:, p] = c * X[:, p] - s * X[:, q]
            Y[:, q] = s * X[:, p] + c * X[:, q]
            pair_of[p] = torch.arange(m // 2, device=dev)
            pair_of[q] = torch.arange(m // 2, device=dev)
            Y = torch.where(pair_of[:, None] > pair_of[None, :], Y.T, Y)
            ta = t * apq
            Y[p, p] = app - ta
            Y[q, q] = aqq + ta
            Y[p, q] = zero
            Y[q, p] = zero
            S = Y
            Vn = V.clone()
            Vn[:, p] = c * V[:, p] - s * V[:, q]
            Vn[:, q] = s * V[:, p] + c * V[:, q]
            V = Vn
    lam = torch.diagonal(S).clone()
    floor = f32(rel_floor) * torch.max(lam)
    inv = torch.where(lam > floor, f32(1.0) / lam, zero)
    y = b / d
    z = torch.zeros(m, device=dev)
    for i in range(m):
        z = z + V[i, :] * y[i]
    z = z * inv
    ws = torch.zeros(m, device=dev)
    for k in range(m):
        ws = ws + V[:, k] * z[k]
    w = ws / d
    return torch.where(torch.isfinite(w), w, zero), lam, V, sweeps
