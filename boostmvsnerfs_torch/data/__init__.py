"""Datasets and the batch loader (counterpart of ``boostmvsnerfs_tpu/data``)."""

from boostmvsnerfs_torch.data.registry import make_dataset  # noqa: F401
