"""Train and eval steps (counterpart of ``boostmvsnerfs_tpu/parallel``; the
device mesh and GSPMD sharding have no counterpart yet)."""
