"""Geometry, sampling, cost-volume and volume-rendering ops on tensors."""
