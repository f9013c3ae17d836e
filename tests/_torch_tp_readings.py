"""The TP update's parameters against JAX's, read against
tests/test_tensor_parallel.py's theta bound (rtol 2e-3, atol 2e-4), which
``tests/test_torch_tensor_parallel.py`` does not require (its docstring
says why); no tests here. Runs that module's four ranks once.

  python tests/_torch_tp_readings.py

Per update case and mesh, against JAX's unsharded update (and at (2, 2)
its TP update) and the port's one-process update: max |d theta|, its
excess over the bound (> 0 is over), the step's direction cosine, |beta|
rel and the accepted exponents; then each update's all-reduces and bytes
on the model and the data group.
"""
import os
import sys
import tempfile
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (JAX on eight CPU devices, as the tests)

import numpy as np  # noqa: E402

import test_torch_tensor_parallel as T  # noqa: E402
from test_torch_helpers import cosine  # noqa: E402


def over(theta, ref):
    return float(np.max(np.abs(theta - ref) - (2e-4 + 2e-3 * np.abs(ref))))


def main():
    with tempfile.TemporaryDirectory() as d:
        world = T.run_world(Path(d))
    r0, th0 = world["ranks"][0], T._theta0(world["inputs"])
    for case, tag in T.W.UPDATES:
        theta = r0[f"{case}/{tag}/theta"]
        st = T._stats(r0, f"{case}/{tag}/stats/")
        refs = dict(world["refs"][case])
        refs["port one-process"] = (r0[f"one/{case}/theta"], None,
                                    T._stats(r0, f"one/{case}/stats/"))
        for name, (th, _, st_r) in refs.items():
            print(f"{case} {tag} against {name}: max |dtheta| "
                  f"{np.abs(theta - th).max():.3e} (over {over(theta, th):+.2e})"
                  f", cosine 1 - {1 - cosine(theta - th0, th - th0):.2e}, "
                  f"|beta| rel {abs(float(st['beta']) / float(st_r['beta']) - 1):.2e}"
                  f", accepted {int(st['accepted'])} / {int(st_r['accepted'])}")
        print(f"{case} {tag} all-reduces (model calls, bytes, data calls, "
              f"bytes): {r0[f'{case}/{tag}/all_reduces'].tolist()}")


if __name__ == "__main__":
    main()
