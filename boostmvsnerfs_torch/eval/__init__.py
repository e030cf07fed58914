"""Image and depth metrics, LPIPS and the per-scene evaluator (counterpart
of ``boostmvsnerfs_tpu/eval``)."""
