"""Dataset factory keyed on config module names (counterpart of
``boostmvsnerfs_tpu/data/registry.py``).

Replaces the reference's imp.load_source dynamic loading
(lib/datasets/make_dataset.py:31-42) with an explicit registry that
dispatches on the module name's last component, so the configs'
``boostmvsnerfs_tpu.data.free`` selects the port's Free dataset.
"""

from __future__ import annotations

import os

from boostmvsnerfs_torch.models.enerf import CascadeConfig


def make_dataset(cfg, split: str):
    ds_cfg = cfg["train_dataset" if split == "train" else "test_dataset"]
    module = cfg["train_dataset_module" if split == "train" else "test_dataset_module"]
    cas = CascadeConfig.from_cfg(cfg["enerf"])
    module = module.rsplit(".", 1)[-1]
    data_root = os.path.join(cfg["workspace"], ds_cfg["data_root"])
    input_h_w = ds_cfg.get("input_h_w")
    scene = cfg.get("scene") or None
    n_views = (
        cfg["enerf"]["train_input_views"][1]
        if split == "train"
        else cfg["enerf"]["test_input_views"]
    )

    if "free" in module:
        from boostmvsnerfs_torch.data.free import FreeDataset

        return FreeDataset(
            data_root, split, cas, input_h_w=input_h_w or (480, 736),
            scenes=[scene] if scene else None,
            n_train_views=n_views, n_test_views=n_views,
        )
    if "scannet" in module:
        from boostmvsnerfs_torch.data.scannet import ScanNetDataset

        return ScanNetDataset(
            data_root, split, cas, input_h_w=input_h_w or (480, 640),
            scenes=[scene] if scene else None, n_views=n_views,
        )
    if "dtu" in module:
        from boostmvsnerfs_torch.data.dtu import DTUDataset

        return DTUDataset(
            data_root, split, cas,
            ann_file=ds_cfg.get("ann_file"),
            scenes=[scene] if scene else None, n_views=n_views,
            # default MVSNeRF-protocol split ids; overridable for
            # reduced-camera captures (and fixture-scale tests)
            train_ids=ds_cfg.get("train_ids"),
            val_ids=ds_cfg.get("val_ids"),
        )
    if "custom" in module:
        from boostmvsnerfs_torch.data.custom import CustomDataset

        return CustomDataset(
            data_root, split, cas, scene=scene, input_h_w=input_h_w or (480, 736),
        )
    raise ValueError(f"unknown dataset module: {module}")
