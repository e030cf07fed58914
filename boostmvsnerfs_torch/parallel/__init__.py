"""Train steps, the device mesh and the sharded eval forward (counterpart of
``boostmvsnerfs_tpu/parallel``): ``train`` (the steps, on one device or on
the ranks of a (data, rays) mesh), ``mesh`` (process groups, the (data,
rays) and (cv, rays) meshes, the batch split, differentiable collectives,
cross-rank BatchNorm) and ``staged`` (``StagedENeRF``'s mesh path)."""
