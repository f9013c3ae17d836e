"""Device resolution for the port's entry points.

``None`` means ``cuda``. Without a GPU the caller must ask for the CPU
explicitly: the port never drops to the CPU on its own.

Full fp32 everywhere: TF32 matmul/conv operands are switched off at every
entry point. This is the GPU form of the JAX package's ``_full_precision``
(``envs/rigid_body.py``) and ``Precision.HIGHEST`` (``models/baseline.py``);
reduced-precision operands cost ~1.9e-3 relative on the baseline's normal
equations.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
