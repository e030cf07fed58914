"""ScanNet_plus dataset (indoor scenes).

Reference lib/datasets/scannet_plus/enerf_base.py: ``exported/{color,pose,
intrinsic}`` layout, fixed depth range [0.25, 6], train/test id lists from
split files, principal point recentered to the resized image center.

Counterpart of ``boostmvsnerfs_tpu/data/scannet.py``: the same metas and
arrays for the same files.
"""

from __future__ import annotations

import os

import numpy as np

from boostmvsnerfs_torch.data.base import MultiViewDataset, nearest_src_views, resize_area
from boostmvsnerfs_torch.data.formats import (
    read_image_file,
    load_split_ids,
    read_scannet_intrinsic,
    read_scannet_pose,
)

SCANNET_SCENES = [
    "scene0000_01", "scene0079_00", "scene0158_00", "scene0316_00",
    "scene0521_00", "scene0553_00", "scene0616_00", "scene0653_00",
]


class ScanNetDataset(MultiViewDataset):
    def __init__(
        self,
        data_root: str,
        split: str,
        cas_cfg,
        input_h_w=(480, 640),
        scenes=None,
        split_root: str | None = None,
        n_views: int = 3,
    ):
        super().__init__(cas_cfg, split, input_h_w)
        self.data_root = data_root
        split_root = split_root or os.path.join(data_root, "splits")
        scenes = scenes or SCANNET_SCENES
        for scene in scenes:
            color_dir = os.path.join(data_root, scene, "exported", "color")
            n_imgs = len(
                [f for f in os.listdir(color_dir)
                 if os.path.isfile(os.path.join(color_dir, f))]
            )
            c2ws = np.stack(
                [
                    read_scannet_pose(
                        os.path.join(data_root, scene, "exported", "pose", f"{i}.txt")
                    )
                    for i in range(n_imgs)
                ]
            )
            ixt = read_scannet_intrinsic(
                os.path.join(
                    data_root, scene, "exported", "intrinsic", "intrinsic_color.txt"
                )
            )
            info = {
                "c2ws": c2ws.astype(np.float32),
                "ixts": np.tile(ixt, (n_imgs, 1, 1)).astype(np.float32),
                "depth_ranges": np.full((n_imgs, 2), [0.25, 6.0], np.float32),
                "image_names": [f"{i}.jpg" for i in range(n_imgs)],
                "scene_name": scene,
            }
            self.scene_infos[scene] = info

            train_ids = load_split_ids(os.path.join(split_root, scene, "train.txt"))
            test_ids = load_split_ids(os.path.join(split_root, scene, "test.txt"))
            render_ids = train_ids if split == "train" else test_ids
            c2ws_train = c2ws[train_ids]
            for i in render_ids:
                order = nearest_src_views(
                    c2ws_train, c2ws[i], n_views, exclude_self=(i in train_ids)
                )
                src = [train_ids[j] for j in order]
                self.metas.append((scene, i, src))

    def camera(self, info, view_idx, orig_size):
        c2w = info["c2ws"][view_idx]
        ixt = info["ixts"][view_idx].copy()
        ixt[0] *= self.input_h_w[1] / orig_size[0]
        ixt[1] *= self.input_h_w[0] / orig_size[1]
        # principal point recentered (reference scannet_plus/enerf_base.py:161-162)
        ixt[0, 2] = self.input_h_w[1] / 2
        ixt[1, 2] = self.input_h_w[0] / 2
        return ixt.astype(np.float32), np.linalg.inv(c2w).astype(np.float32)

    def read_image(self, info, view_idx, for_target: bool):
        path = os.path.join(
            self.data_root,
            info["scene_name"],
            "exported",
            "color",
            info["image_names"][view_idx],
        )
        img = read_image_file(path).astype(np.float32)
        orig = img.shape[:2][::-1]
        img = resize_area(img, *self.input_h_w)
        return img / 255.0, orig
