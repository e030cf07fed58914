"""Training: loss, schedules and optimizers, checkpoints, metrics recorder
(counterpart of ``boostmvsnerfs_tpu/train``)."""
