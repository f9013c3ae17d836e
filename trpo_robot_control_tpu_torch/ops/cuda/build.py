"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout (the hash covers the source, the headers it includes from
``csrc/`` and the flags, so an edited source or header rebuilds). The two
rollout sources build one library per joint count,
``lib<name>_nj<n>-<hash>.so`` with ``-DTRPO_NJ=<n>``, n in
``JOINT_COUNTS``, so that each ``nvcc`` compiles one count's
instantiations. The five sources whose kernels run the policy MLP
(``PER_SHAPE``: both rollouts, the surrogate gradient and both FVPs)
build, for a policy other than the default (64, 64) one,
one library per hidden shape, ``lib<name>[_nj<n>]_h<w0>x<w1>...`` with
``-DTRPO_H0=<w0> -DTRPO_H1=<w1> ...`` (``csrc/policy_shape.cuh``): a run builds
only its own policy's. Each takes 1-``MAX_DEPTH`` hidden layers of at most
``MAX_WIDTH[source]`` units (``check_hidden``). The first call to
``library`` builds every missing
default library that takes no joint count and the one asked for, one
``nvcc`` each, all started together; ``build_all`` builds the default
libraries, and any others it is given, so. Each
compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside its library. Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("rollout", "moments", "fvp", "rollout3d", "pg", "fvp_ff",
           "fit_normal")
# the sources built once per joint count, and the counts
PER_JOINT = ("rollout", "rollout3d")
JOINT_COUNTS = tuple(range(1, 9))
# the sources built once per policy shape other than DEFAULT_HIDDEN, and
# what each takes: 1-3 hidden layers, each at most MAX_WIDTH units wide
# (ROADMAP B3 for more). The rollouts and the batch-major FVP take the
# JAX package's unpacked forms, up to 128 units; the surrogate gradient
# and the feature-first FVP only its packed ones, up to 64, as their TPU
# kernels do.
PER_SHAPE = ("rollout", "fvp", "rollout3d", "pg", "fvp_ff")
DEFAULT_HIDDEN = (64, 64)
MAX_DEPTH = 3
MAX_WIDTH = {"rollout": 128, "rollout3d": 128, "fvp": 128, "pg": 64,
             "fvp_ff": 64}
KERNEL = {"rollout": "planar rollout kernel",
          "rollout3d": "3-D rollout kernel", "fvp": "FVP kernel",
          "pg": "surrogate-gradient kernel",
          "fvp_ff": "feature-first FVP kernel"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The rollouts' dynamics round every multiply and add as PyTorch's separate
# elementwise ops do, so that the dependent steps stay close to the plain
# versions; their policy MLPs still use explicit fmaf.
EXTRA_FLAGS = {"rollout": ("-fmad=false",), "rollout3d": ("-fmad=false",)}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def hidden_shape(params, source: str) -> tuple:
    """The hidden widths of ``params``' tanh MLP ({W0..WL}); raises
    NotImplementedError, naming ROADMAP B3, for a policy the kernel of
    ``source`` is not built for (``check_hidden``)."""
    L = sum(1 for k in params if k.startswith("W")) - 1
    return check_hidden(
        tuple(int(params[f"W{i}"].shape[1]) for i in range(L)), source)


def check_hidden(hidden: tuple, source: str) -> tuple:
    """``hidden``, or NotImplementedError, naming ROADMAP B3, where the
    kernel of ``source`` is not built for it: past ``MAX_DEPTH`` hidden
    layers or ``MAX_WIDTH[source]`` units a layer."""
    hidden = tuple(hidden)
    cap = MAX_WIDTH[source]
    if not 1 <= len(hidden) <= MAX_DEPTH or max(hidden) > cap:
        raise NotImplementedError(
            f"the {KERNEL[source]} takes 1-{MAX_DEPTH} hidden layers of "
            f"1-{cap} units, not {hidden} (ROADMAP B3)")
    return hidden


def policy_args(weights, hidden: tuple) -> tuple:
    """The C entry points' policy arguments: the hidden widths as an int
    array and their count, and a host array of the device pointers W0, b0,
    ..., W_L, b_L, logstd from ``weights`` (contiguous fp32 tensors kept
    alive by the caller)."""
    keys = [f"{w}{l}" for l in range(len(hidden) + 1) for w in "Wb"]
    ptrs = (ctypes.c_void_p * (len(keys) + 1))(
        *(weights[k].data_ptr() for k in keys + ["logstd"]))
    return (ctypes.c_int * len(hidden))(*hidden), len(hidden), ptrs


def lib_name(source: str, n_joints: int | None = None,
             hidden: tuple = DEFAULT_HIDDEN) -> str:
    """The library of ``source``; a per-joint source's for ``n_joints``, a
    per-shape source's for the hidden widths ``hidden`` (registered in
    ``LIBS`` on first use)."""
    name = source if n_joints is None else f"{source}_nj{n_joints}"
    hidden = tuple(hidden)
    if hidden == DEFAULT_HIDDEN:
        return name
    if source not in PER_SHAPE:
        raise ValueError(f"{source} is built for {DEFAULT_HIDDEN} only")
    name += "_h" + "x".join(map(str, hidden))
    LIBS.setdefault(name, (source, n_joints, hidden))
    return name


# every library: name -> (source, joint count or None, hidden widths or
# None for DEFAULT_HIDDEN); the default ones, and others as lib_name
# registers them
LIBS = {lib_name(s, n): (s, n, None) for s in SOURCES
        for n in (JOINT_COUNTS if s in PER_JOINT else (None,))}


def _flags(name: str) -> tuple:
    src, n, hidden = LIBS[name]
    return (NVCC_FLAGS + EXTRA_FLAGS.get(src, ())
            + ((f"-DTRPO_NJ={n}",) if n else ())
            + tuple(f"-DTRPO_H{i}={w}" for i, w in enumerate(hidden or ())))


def _sources(name: str) -> bytes:
    """The source and, recursively, every header it includes from csrc/."""
    seen, todo, out = set(), [f"{name}.cu"], b""
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.add(f)
        text = (CSRC / f).read_bytes()
        out += text
        todo += [m.decode() for m in _INCLUDE.findall(text)
                 if (CSRC / m.decode()).exists()]
    return out


def _target(name: str) -> Path:
    digest = hashlib.sha256(_sources(LIBS[name][0])
                            + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=None) -> float:
    """Compile every missing library of ``names`` (the default libraries
    when None) in parallel; returns the seconds."""
    if names is None:
        names = [n for n, (_, _, hidden) in LIBS.items() if hidden is None]
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for name in names:
            so = _target(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            log = open(so.with_suffix(".log"), "w")
            cmd = [nvcc, *_flags(name), "-o", str(tmp),
                   str(CSRC / f"{LIBS[name][0]}.cu")]
            procs.append((name, so, tmp, log,
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
        failed = []
        for name, so, tmp, log, p in procs:
            rc = p.wait(timeout=NVCC_TIMEOUT_S)
            log.close()
            if rc != 0:
                failed.append(f"{name}: nvcc exit {rc}\n"
                              + so.with_suffix(".log").read_text())
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    finally:
        for _, _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return time.perf_counter() - t0


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (``lib_name``; built on first use), with
    ``argtypes`` set from ``signatures`` {function: [ctypes types]}; every
    entry point returns a cudaError_t as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            wanted = [n for n, (_, nj, hidden) in LIBS.items()
                      if n == name or (nj is None and hidden is None)]
            if not all(_target(n).exists() for n in wanted):
                build_all(wanted)
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def ptxas_report() -> str:
    """The ``-Xptxas -v`` lines of every built library."""
    lines = []
    for name in LIBS:
        log = _target(name).with_suffix(".log")
        if log.exists():
            lines += [f"{name}: {ln.strip()}" for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]
    return "\n".join(lines)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
