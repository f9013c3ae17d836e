"""PyTorch + CUDA port of the TRPO robot-control engine, for one NVIDIA H100.

The JAX package ``trpo_robot_control_tpu`` is the reference; this package
mirrors its layout module for module and imports none of it. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version (see ``ops/cuda/``).
"""
