"""K1: fused planar-arm rollout (``csrc/rollout.cu``).

Replaces ``pallas_rollout`` in
``trpo_robot_control_tpu/ops/pallas/rollout_kernel.py``: the whole horizon
of a planar single-task arm of 1-8 links in one launch (FK, closed-form
mass matrix and
centripetal bias, unrolled Cholesky, semi-implicit Euler, tanh-MLP policy,
Gaussian action, torque clip, reward) and, when ``cfg.done_dist > 0``, the
terminating branch: an env whose post-step end effector comes within
``done_dist`` of its target is flagged done and starts a fresh episode
before the next step. It takes any tanh policy of 1-3 hidden layers of
1-128 units (``build.hidden_shape``; a policy other than the default
(64, 64) builds a library of its own, one wider than 64 units the
kernel's wide form, the TPU kernel's unpacked ``_policy_ff``; past those
it raises NotImplementedError, naming ROADMAP B3). A block holds 8 envs in five
warps: four compute the policy's hidden units across their lanes, one
does each env's serial work; see the source for what bounds it on the
card and what its design does about that. ``occupancy`` reports what the
card makes of each instantiation.

``rollout`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), on CPU tensors it runs ``rollout_plain``, the same feature-first
math in plain PyTorch. Outputs keep the kernel's (T, d, N) layout, which
is what the update consumes; obs and actions are stored in
``store_dtype`` (fp32 or bf16, rounded once at the store: the trajectory
stays fp32), rewards and done flags in fp32. The kernel is built for
``JOINT_COUNTS`` (one library per count); past them, the observation
outgrows the update kernels' 32 features (ROADMAP B3).

Noise: ``eps`` (T, N, n) from the caller gives an exact comparison with
the plain version and with the JAX reference; without it the kernel draws
Philox4x32-10 normals keyed by ``seed`` (an int64 pair on the device,
drawn by the caller from its ``torch.Generator``). Philox mode exists only
on the card: the caller draws ``eps`` on the CPU. Fresh episodes of a
terminating config follow the noise: with ``eps`` the caller passes them
too, ``fresh`` = (q (T, N, n), qd (T, N, n), tgt (T, N, 3), task (T, N)),
the episode an env starts when it is done at step t being row t; in
Philox mode the kernel draws them from the reset distributions of
``envs/arm.py:reset``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

JOINT_COUNTS = build.JOINT_COUNTS

_SIG = {"trpo_rollout_launch":
        [ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 13
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "trpo_rollout_occupancy": [ctypes.c_int] * 3 + [ctypes.c_void_p]}


class PlanarConsts(NamedTuple):
    n: int
    l: tuple        # link lengths (joint offsets along the parent x)
    lc: tuple       # COM offsets along the link x
    m: tuple
    iz: tuple       # inertia about z at the COM
    damping: float
    dt: float
    n_substeps: int
    torque_limit: float
    qd_limit: float
    qd_obs_scale: float
    ctrl_weight: float
    chol_reg: float
    # early termination (done_dist > 0) and the reset distributions of
    # envs/arm.py:reset: q and qd uniform in +-noise, the target at a
    # radius uniform in [rmin, rmax] and an angle uniform in [0, 2 pi)
    done_dist: float = 0.0
    q0_noise: float = 0.0
    qd0_noise: float = 0.0
    rmin: float = 0.0
    rmax: float = 0.0


def planar_consts(cfg, chol_reg: float = 1e-6) -> PlanarConsts:
    """Constants of a planar, gravity-free, single-task reach arm; raises
    NotImplementedError for what this kernel does not cover."""
    spec = cfg.arm
    planar = all(abs(v) < 1e-12 for j in spec.joints for v in j.rpy)
    if not planar or abs(spec.gravity) > 1e-12:
        raise NotImplementedError(
            "non-planar arms and gravity take the 3-D rollout kernel "
            "(ops/cuda/rollout3d_kernel.py)")
    if cfg.n_tasks != 1 or cfg.cost.obstacle_weight != 0.0:
        raise NotImplementedError(
            "multi-task and obstacle costs take the 3-D rollout kernel "
            "(ops/cuda/rollout3d_kernel.py)")
    n = spec.n_joints
    l = tuple(float(spec.joints[i + 1].pos[0]) for i in range(n - 1)) \
        + (float(spec.ee_offset[0]),)
    return PlanarConsts(
        n=n, l=l,
        lc=tuple(float(lk.com[0]) for lk in spec.links),
        m=tuple(float(lk.mass) for lk in spec.links),
        iz=tuple(float(lk.inertia_diag[2]) for lk in spec.links),
        damping=float(spec.joint_damping), dt=float(spec.dt),
        n_substeps=int(spec.n_substeps),
        torque_limit=float(spec.torque_limit),
        qd_limit=float(spec.qd_limit),
        qd_obs_scale=float(spec.qd_obs_scale),
        ctrl_weight=float(cfg.cost.ctrl_weight), chol_reg=chol_reg,
        done_dist=float(cfg.done_dist), q0_noise=float(spec.q0_noise),
        qd0_noise=float(spec.qd0_noise),
        rmin=float(spec.target_rmin_frac * spec.reach),
        rmax=float(spec.target_rmax_frac * spec.reach))


def done_dist2(c) -> float:
    """done_dist^2, taken in fp64 and rounded to fp32 once where it meets
    the fp32 distance, as the JAX kernels' Python-float product is."""
    return c.done_dist * c.done_dist


# ------------------------------------------------------- plain version
# Lists of (N,) tensors, feature-first, in the op order of the kernel.

def _fk(c: PlanarConsts, q):
    th, acc = [], None
    for i in range(c.n):
        acc = q[i] if acc is None else acc + q[i]
        th.append(acc)
    cth = [torch.cos(t) for t in th]
    sth = [torch.sin(t) for t in th]
    px, py = [], []
    x = torch.zeros_like(q[0])
    y = torch.zeros_like(q[0])
    for i in range(c.n):
        px.append(x)
        py.append(y)
        x = x + c.l[i] * cth[i]
        y = y + c.l[i] * sth[i]
    cx = [px[i] + c.lc[i] * cth[i] for i in range(c.n)]
    cy = [py[i] + c.lc[i] * sth[i] for i in range(c.n)]
    return px, py, cx, cy, x, y


def _mass(c: PlanarConsts, px, py, cx, cy):
    M = {}
    for i in range(c.n):
        for j in range(i, c.n):
            acc = None
            for k in range(j, c.n):
                dot = ((cy[k] - py[i]) * (cy[k] - py[j])
                       + (cx[k] - px[i]) * (cx[k] - px[j]))
                term = c.m[k] * dot + c.iz[k]
                acc = term if acc is None else acc + term
            M[(i, j)] = acc
    return M


def _bias(c: PlanarConsts, qd, px, py, cx, cy):
    n = c.n
    w, acc = [], None
    for i in range(n):
        acc = qd[i] if acc is None else acc + qd[i]
        w.append(acc)
    ax, ay = torch.zeros_like(qd[0]), torch.zeros_like(qd[0])
    acx, acy = [], []
    for i in range(n):
        w2 = w[i] * w[i]
        acx.append(ax - w2 * (cx[i] - px[i]))
        acy.append(ay - w2 * (cy[i] - py[i]))
        if i + 1 < n:
            ax = ax - w2 * (px[i + 1] - px[i])
            ay = ay - w2 * (py[i + 1] - py[i])
    tau = [None] * n
    fx, fy, nz = (torch.zeros_like(qd[0]) for _ in range(3))
    p_cx, p_cy = torch.zeros_like(qd[0]), torch.zeros_like(qd[0])
    for i in range(n - 1, -1, -1):
        Fx = c.m[i] * acx[i]
        Fy = c.m[i] * acy[i]
        nz = (nz + (cx[i] - px[i]) * Fy - (cy[i] - py[i]) * Fx
              + (p_cx - px[i]) * fy - (p_cy - py[i]) * fx)
        tau[i] = nz
        fx = Fx + fx
        fy = Fy + fy
        p_cx, p_cy = px[i], py[i]
    return tau


def _chol_solve(c: PlanarConsts, M, rhs):
    n = c.n
    L, inv_d = {}, [None] * n
    for j in range(n):
        s = M[(j, j)] + c.chol_reg
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        inv = torch.rsqrt(s)
        inv_d[j] = inv
        L[(j, j)] = s * inv
        for i in range(j + 1, n):
            t = M[(j, i)]
            for k in range(j):
                t = t - L[(i, k)] * L[(j, k)]
            L[(i, j)] = t * inv
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[(k, i)] * x[k]
        x[i] = s * inv_d[i]
    return x


def _policy_mean(params, obs):
    """obs (do, N) -> mu (da, N). A one-unit layer (a one-action head, or
    a hidden layer of width 1) is multiplied as two rows, the second zero,
    so that on the card it takes the matrix product's FMA chain over its
    inputs in order, as the rollout kernels sum it, and not a
    matrix-vector product's order."""
    def layer(W, b, h):
        if W.shape[1] == 1:
            return (torch.cat([W, torch.zeros_like(W)], dim=1).T @ h)[:1] \
                + b[:, None]
        return W.T @ h + b[:, None]

    L = sum(1 for k in params if k.startswith("W"))
    h = obs
    for i in range(L - 1):
        h = torch.tanh(layer(params[f"W{i}"], params[f"b{i}"], h))
    return layer(params[f"W{L - 1}"], params[f"b{L - 1}"], h)


def rollout_plain(cfg, params, q0, qd0, tgt, eps, fresh=None):
    """q0/qd0 (N, n), tgt (N, 3), eps (T, N, n) -> obs_ff (T, do, N),
    act_ff (T, n, N), rew_ff (T, N) and, when ``cfg.done_dist > 0``, the
    done flags (T, N); ``fresh`` (q, qd, tgt, task) with a leading T axis
    holds the episodes that done envs start (task unused here)."""
    rollout_plain.calls += 1
    c = planar_consts(cfg)
    n = c.n
    term = c.done_dist > 0.0
    if term and fresh is None:
        raise ValueError("a terminating config needs the fresh episodes")
    sigma = torch.exp(params["logstd"])[:, None]
    q = list(q0.T)
    qd = list(qd0.T)
    tgtx, tgty = tgt[:, 0], tgt[:, 1]
    h = c.dt / c.n_substeps
    if term:
        dd2 = torch.tensor(done_dist2(c), dtype=q0.dtype, device=q0.device)
    obs_t, act_t, rew_t, done_t = [], [], [], []
    for t in range(eps.shape[0]):
        px, py, cx, cy, eex, eey = _fk(c, q)
        qs = torch.stack(q)
        obs = torch.cat([torch.cos(qs), torch.sin(qs),
                         c.qd_obs_scale * torch.stack(qd),
                         torch.stack([tgtx - eex, tgty - eey,
                                      torch.zeros_like(eex)])])
        act = _policy_mean(params, obs) + sigma * eps[t].T
        tau = list(torch.clamp(act, -c.torque_limit, c.torque_limit))
        for s in range(c.n_substeps):
            if s > 0:
                px, py, cx, cy, eex, eey = _fk(c, q)
            M = _mass(c, px, py, cx, cy)
            bias = _bias(c, qd, px, py, cx, cy)
            rhs = [tau[i] - bias[i] - c.damping * qd[i] for i in range(n)]
            qdd = _chol_solve(c, M, rhs)
            qd = [torch.clamp(qd[i] + h * qdd[i], -c.qd_limit, c.qd_limit)
                  for i in range(n)]
            q = [q[i] + h * qd[i] for i in range(n)]
        _, _, _, _, eex, eey = _fk(c, q)
        dx, dy = eex - tgtx, eey - tgty
        ctrl = None
        for i in range(n):
            t2 = tau[i] * tau[i]
            ctrl = t2 if ctrl is None else ctrl + t2
        dist2 = dx * dx + dy * dy
        obs_t.append(obs)
        act_t.append(act)
        rew_t.append(-(dist2 + c.ctrl_weight * ctrl))
        if term:            # a done env starts the fresh episode of row t
            done = dist2 < dd2
            done_t.append(done.to(q0.dtype))
            q = [torch.where(done, x, y) for x, y in zip(fresh[0][t].T, q)]
            qd = [torch.where(done, x, y) for x, y in zip(fresh[1][t].T, qd)]
            tgtx = torch.where(done, fresh[2][t, :, 0], tgtx)
            tgty = torch.where(done, fresh[2][t, :, 1], tgty)
    out = (torch.stack(obs_t), torch.stack(act_t), torch.stack(rew_t))
    return out + (torch.stack(done_t),) if term else out


rollout_plain.calls = 0


# ------------------------------------------------------------- wrapper

def fresh_feature_first(fresh, T, N, n, dev, width):
    """The fresh episodes (T, N, ...) relaid feature-first for the kernel:
    q, qd (T, n, N) and the target's first ``width`` coordinates
    (T, width, N), fp32."""
    q, qd, tgt = fresh[0], fresh[1], fresh[2]
    if (q.shape != (T, N, n) or qd.shape != (T, N, n)
            or tgt.shape != (T, N, 3)
            or any(x.device != dev for x in (q, qd, tgt))):
        raise ValueError(f"fresh q, qd must be ({T}, {N}, {n}) and tgt "
                         f"({T}, {N}, 3) on {dev}")
    return [x.to(torch.float32).permute(0, 2, 1).contiguous()
            for x in (q, qd, tgt[..., :width])]


def check_joints(n: int, what: str) -> None:
    """Raises NotImplementedError for a joint count ``what`` (a kernel) is
    not built for."""
    if n not in JOINT_COUNTS:
        raise NotImplementedError(
            f"the {what} is built for {JOINT_COUNTS[0]}-{JOINT_COUNTS[-1]} "
            f"joints, not {n}; past {JOINT_COUNTS[-1]} the observation "
            "outgrows the update kernels' 32 features (ROADMAP B3)")


def check_store(store_dtype) -> None:
    if store_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"store_dtype must be fp32 or bf16, not {store_dtype}")


def check_fresh(term: bool, eps, fresh) -> None:
    if not term and fresh is not None:
        raise ValueError("fresh episodes belong to a terminating config")
    if term and (eps is None) != (fresh is None):
        raise ValueError("a terminating rollout takes fresh episodes with "
                         "eps, and draws them with the Philox seed")


def rollout(cfg, params, q0, qd0, tgt, eps=None, seed=None, fresh=None,
            store_dtype=torch.float32):
    """Fused rollout: q0/qd0 (N, n), tgt (N, 3), and either eps (T, N, n)
    (with ``fresh`` when the config terminates) or seed (int64 (2,) on the
    device) -> obs_ff (T, do, N) and act_ff (T, n, N) in ``store_dtype``,
    rew_ff (T, N) fp32 and, when ``cfg.done_dist > 0``, dones (T, N)
    fp32."""
    c = planar_consts(cfg)
    term = c.done_dist > 0.0
    check_fresh(term, eps, fresh)
    check_store(store_dtype)
    if not q0.is_cuda:
        if eps is None:
            raise ValueError("Philox noise runs only in the CUDA kernel; "
                             "pass eps on the CPU")
        out = rollout_plain(cfg, params, q0, qd0, tgt, eps, fresh)
        return (out[0].to(store_dtype), out[1].to(store_dtype)) + out[2:]
    N, n = q0.shape
    T = cfg.horizon
    do = 3 * n + 3
    dev = q0.device
    hidden = build.hidden_shape(params, "rollout")
    check_joints(n, "planar rollout kernel")
    if params["W0"].shape[0] != do:
        raise ValueError(f"W0 takes {params['W0'].shape[0]} inputs, the "
                         f"observation has {do}")
    if (eps is None) == (seed is None):
        raise ValueError("pass exactly one of eps and seed")
    ins = dict(q0=q0.T, qd0=qd0.T, tgt=tgt[:, :2].T, **params)
    ins = {k: v.to(torch.float32).contiguous() for k, v in ins.items()}
    for k, v in ins.items():
        if v.device != dev:
            raise ValueError(f"{k} is on {v.device}, the batch on {dev}")
    if eps is not None:
        if eps.shape != (T, N, n) or eps.device != dev:
            raise ValueError(f"eps must be ({T}, {N}, {n}) on {dev}")
        eps_ff = eps.to(torch.float32).permute(0, 2, 1).contiguous()
        seed_p = ctypes.c_void_p(None)
    else:
        if seed.dtype != torch.int64 or seed.numel() != 2 or seed.device != dev:
            raise ValueError("seed must be an int64 (2,) tensor on the device")
        eps_ff = None
        seed_p = build.ptr(seed)
    fresh_ff = [None] * 3
    if fresh is not None:
        fresh_ff = fresh_feature_first(fresh, T, N, n, dev, 2)
    obs = torch.empty(T, do, N, device=dev, dtype=store_dtype)
    act = torch.empty(T, n, N, device=dev, dtype=store_dtype)
    rew = torch.empty(T, N, device=dev)
    dones = torch.empty(T, N, device=dev) if term else None
    consts = list(c.l) + list(c.lc) + list(c.m) + list(c.iz) + [
        c.damping, c.dt / c.n_substeps, c.torque_limit, c.qd_limit,
        c.qd_obs_scale, c.ctrl_weight, c.chol_reg, done_dist2(c),
        c.q0_noise, c.qd0_noise, c.rmin, c.rmax]
    consts_arr = (ctypes.c_float * len(consts))(*consts)
    opt = lambda x: build.ptr(x) if x is not None else ctypes.c_void_p(None)
    lib = build.library(build.lib_name("rollout", n, hidden), _SIG)
    hid, n_hid, weights = build.policy_args(ins, hidden)
    err = lib.trpo_rollout_launch(
        consts_arr, c.n_substeps, n, int(term),
        int(store_dtype == torch.bfloat16), hid, n_hid,
        *(build.ptr(ins[k]) for k in ("q0", "qd0", "tgt")), weights,
        opt(eps_ff), seed_p,
        *(opt(x) for x in fresh_ff),
        build.ptr(obs), build.ptr(act), build.ptr(rew), opt(dones), N, T,
        build.stream_handle(dev))
    build.check(err, "rollout kernel")
    rollout.launches += 1
    return (obs, act, rew, dones) if term else (obs, act, rew)


rollout.launches = 0


def occupancy(n: int, term: bool, store_dtype=torch.float32,
              hidden=build.DEFAULT_HIDDEN) -> dict:
    """What the card makes of the instantiation for ``n`` joints,
    terminating or not, with ``store_dtype`` stores and a policy of
    ``hidden`` widths: resident blocks and warps per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    bytes per thread (the stack frame: spills, and the slow-path array of
    the precise trig, which ``-Xptxas -v`` tells apart), static shared
    bytes, dynamic shared bytes (the wide form's hidden-to-hidden layers;
    0 at widths up to 64), threads and envs per block. Raises
    NotImplementedError for an ``n`` or a policy it is not built for."""
    check_joints(n, "planar rollout kernel")
    check_store(store_dtype)
    hidden = build.check_hidden(hidden, "rollout")
    out = (ctypes.c_int * 7)()
    err = build.library(build.lib_name("rollout", n, hidden),
                        _SIG).trpo_rollout_occupancy(
        n, int(term), int(store_dtype == torch.bfloat16), out)
    build.check(err, "rollout kernel occupancy")
    blocks, regs, local, static, threads, envs, dyn = out
    return dict(blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
                registers=regs, local_bytes=local, smem_static=static,
                smem_dynamic=dyn, threads=threads, envs_per_block=envs)
