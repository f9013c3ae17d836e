"""Carry weights between the JAX package and the port as numpy arrays.

Both packages use the same parameter keys (``W0..WL, b0..bL, logstd``)
and the same flat order, so params converted here make both compute the
same thing. Baseline weights are one array (linear) or a dict of them
(the MLP's ``W0..WL, b0..bL``).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(params: dict, device) -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def w_from_numpy(w, device):
    if isinstance(w, dict):
        return params_from_numpy(w, device)
    return torch.tensor(np.asarray(w, np.float32), device=device)


def w_to_numpy(w):
    if isinstance(w, dict):
        return params_to_numpy(w)
    return w.detach().cpu().numpy()
