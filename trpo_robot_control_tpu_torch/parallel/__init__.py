"""Data and tensor parallelism over ``torch.distributed`` (port of
``trpo_robot_control_tpu/parallel/``): ``mesh`` builds the ('data', 'model')
mesh, shards the batch and runs the sharded updates and train loop;
``tensor`` shards the policy's first two layers over the 'model' axis;
``collectives`` holds the cross-rank reductions."""
