"""Structured JSONL metrics (port of
``trpo_robot_control_tpu/utils/metrics.py``): one line per TRPO iteration,
the host-side stats the trainer reads once per iteration, with the seconds
since the logger was made as ``t``.
"""
from __future__ import annotations

import json
import sys
import time


class JsonlLogger:
    def __init__(self, path=None, echo=True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def header(self, record: dict) -> None:
        """Write one line (the run's config) before the iterations."""
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def __call__(self, stats: dict):
        rec = dict(stats)
        rec["t"] = round(time.time() - self._t0, 3)
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(f"iter {rec.get('iter', '?'):>4} "
                  f"return {rec.get('mean_return', float('nan')):9.3f} "
                  f"kl {rec.get('kl', float('nan')):.4f} "
                  f"k {rec.get('accepted', -1):3.0f} "
                  f"|g| {rec.get('g_norm', float('nan')):8.4f} "
                  f"{1e3 * rec.get('wall_s', 0):8.1f} ms",
                  file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
