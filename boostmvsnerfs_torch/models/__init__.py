"""ENeRF / BoostENeRF networks (counterpart of ``boostmvsnerfs_tpu/models``)."""
