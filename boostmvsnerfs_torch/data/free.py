"""Free dataset (LLFF-style large-scale scenes).

Reference lib/datasets/free/enerf_base.py: 7 scenes, LLFF poses_bounds.npy
cameras, half-resolution ``images_2`` copies, every-8th-frame test split,
nearest-camera source-view selection.

Counterpart of ``boostmvsnerfs_tpu/data/free.py``: the same metas and
arrays for the same files.
"""

from __future__ import annotations

import os

import numpy as np

from boostmvsnerfs_torch.data.base import MultiViewDataset, nearest_src_views, resize_area
from boostmvsnerfs_torch.data.formats import parse_poses_bounds, read_image_file

FREE_SCENES = ["grass", "hydrant", "lab", "pillar", "road", "sky", "stair"]


class FreeDataset(MultiViewDataset):
    def __init__(
        self,
        data_root: str,
        split: str,
        cas_cfg,
        input_h_w=(480, 736),
        scenes=None,
        n_train_views: int = 3,
        n_test_views: int = 3,
    ):
        super().__init__(cas_cfg, split, input_h_w)
        self.data_root = data_root
        scenes = scenes or FREE_SCENES
        for scene in scenes:
            c2ws, ixts, depth_ranges = parse_poses_bounds(
                os.path.join(data_root, scene, "poses_bounds.npy")
            )
            img_dir = os.path.join(data_root, scene, "images_2")
            names = sorted(
                f
                for f in os.listdir(img_dir)
                if f.lower().endswith((".png", ".jpg", ".jpeg"))
            )
            info = {
                "c2ws": c2ws,
                "ixts": ixts,
                "depth_ranges": depth_ranges,
                "image_names": names,
                "scene_name": scene,
            }
            self.scene_infos[scene] = info

            all_ids = list(range(len(names)))
            train_ids = [i for i in all_ids if i % 8 != 0]
            render_ids = (
                train_ids if split == "train" else [i for i in all_ids if i % 8 == 0]
            )
            c2ws_train = c2ws[train_ids]
            n_src = n_train_views if split == "train" else n_test_views
            for i in render_ids:
                order = nearest_src_views(
                    c2ws_train, c2ws[i], n_src, exclude_self=(i in train_ids)
                )
                src = [train_ids[j] for j in order]
                self.metas.append((scene, i, src))

    def read_image(self, info, view_idx, for_target: bool):
        path = os.path.join(
            self.data_root, info["scene_name"], "images_2", info["image_names"][view_idx]
        )
        img = read_image_file(path).astype(np.float32)
        orig = img.shape[:2][::-1]
        img = resize_area(img, *self.input_h_w)
        return img / 255.0, orig
