"""Custom LLFF-style captures (COLMAP -> imgs2poses -> poses_bounds.npy).

Reference lib/datasets/custom/enerf_base.py: identical camera conventions to
the Free dataset; the scene directory is provided explicitly and all frames
are available as sources (k_best fusion over 12 views by default —
reference configs/custom/custom.yaml:4-8). Counterpart of
``boostmvsnerfs_tpu/data/custom.py``.
"""

from __future__ import annotations

from boostmvsnerfs_torch.data.free import FreeDataset


class CustomDataset(FreeDataset):
    def __init__(self, data_root, split, cas_cfg, scene, input_h_w=(480, 736),
                 n_train_views=12, n_test_views=12):
        super().__init__(
            data_root,
            split,
            cas_cfg,
            input_h_w=input_h_w,
            scenes=[scene],
            n_train_views=n_train_views,
            n_test_views=n_test_views,
        )
