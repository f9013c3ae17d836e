"""Data parallelism over ``torch.distributed`` (port of
``trpo_robot_control_tpu/parallel/``): ``mesh`` builds the mesh, shards the
batch and runs the sharded update and train loop; ``collectives`` holds the
update's cross-rank reductions. Tensor parallelism (JAX ``tensor.py``) is
not ported: ROADMAP A6."""
