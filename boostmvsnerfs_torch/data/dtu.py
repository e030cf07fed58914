"""DTU dataset (pretraining + depth evaluation).

Reference lib/datasets/dtu/enerf_base.py: MVSNet camera files with 4x
intrinsic upscale, Rectified/ image layout, pairs-file train/val view ids,
random source-view jitter during training, PFM depth ground truth with the
reference's crop for evaluation, depth range [425, 905].

Counterpart of ``boostmvsnerfs_tpu/data/dtu.py``: the same metas and
arrays for the same files.
"""

from __future__ import annotations

import os

import numpy as np

from boostmvsnerfs_torch.data.base import MultiViewDataset, resize_area
from boostmvsnerfs_torch.data.formats import read_image_file, read_mvsnet_cam, read_pfm

# MVSNeRF's DTU split (reference data/mvsnet/pairs.th content; the pairs file
# is a torch pickle — these ids are the published MVSNeRF protocol).
DTU_TRAIN_IDS = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 26, 27, 28, 29, 30, 31, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
    45, 46, 47,
]
DTU_VAL_IDS = [32, 24, 23, 44]


class DTUDataset(MultiViewDataset):
    def __init__(
        self,
        data_root: str,
        split: str,
        cas_cfg,
        ann_file: str | None = None,
        scenes=None,
        n_views: int = 3,
        train_ids=None,
        val_ids=None,
    ):
        super().__init__(cas_cfg, split, input_h_w=None)
        self.data_root = data_root
        self.depth_ranges = [425.0, 905.0]
        if scenes is None:
            with open(ann_file) as f:
                scenes = [line.strip() for line in f if line.strip()]
        train_ids = train_ids or DTU_TRAIN_IDS
        val_ids = val_ids or DTU_VAL_IDS

        for scene in scenes:
            info = {"ixts": [], "exts_w2c": [], "img_paths": [], "dpt_paths": []}
            n_cams = len(
                [f for f in os.listdir(os.path.join(data_root, "Cameras", "train"))
                 if f.endswith("_cam.txt")]
            )
            for i in range(n_cams):
                ixt, ext, _ = read_mvsnet_cam(
                    os.path.join(data_root, "Cameras/train/{:08d}_cam.txt".format(i))
                )
                ixt = ixt.copy()
                ixt[:2] *= 4  # camera files are at 1/4 res (reference :42)
                info["ixts"].append(ixt.astype(np.float32))
                info["exts_w2c"].append(ext.astype(np.float32))
                info["dpt_paths"].append(
                    os.path.join(
                        data_root, "Depths/{}/depth_map_{:04d}.pfm".format(scene, i)
                    )
                )
                info["img_paths"].append(
                    os.path.join(
                        data_root,
                        "Rectified/{}_train/rect_{:03d}_3_r5000.png".format(scene, i + 1),
                    )
                )
            info["c2ws"] = np.stack(
                [np.linalg.inv(e) for e in info["exts_w2c"]]
            ).astype(np.float32)
            info["ixts"] = np.stack(info["ixts"])
            self.scene_infos[scene] = info

            if split == "train" and len(scenes) != 1:
                t_ids = list(range(n_cams))
                e_ids = list(range(n_cams))
            elif split == "train":
                t_ids = list(train_ids)
                e_ids = list(train_ids)
            else:
                t_ids = list(train_ids)
                e_ids = list(val_ids)

            cam_pts = info["c2ws"][t_ids][:, :3, 3]
            for tar in e_ids:
                p = info["c2ws"][tar][:3, 3]
                order = np.argsort(np.linalg.norm(cam_pts - p[None], axis=-1))
                if tar in t_ids:
                    order = order[1:]
                # one extra candidate for train-time jitter (reference :68)
                n = n_views + 1 if split == "train" else n_views
                src = [t_ids[i] for i in order[:n]]
                self.metas.append((scene, tar, src))

    def scene_near_far(self, info, tar_view):
        return np.asarray(self.depth_ranges, dtype=np.float32)

    def jitter_src_views(self, src_views, input_views_num, rng):
        """Random source jitter (reference lib/datasets/dtu/enerf_base.py:75-78):
        with p=0.1 include the target view among candidates, then sample
        ``input_views_num`` without replacement."""
        if self.split != "train" or input_views_num is None:
            return list(src_views)[: input_views_num or len(src_views)]
        cands = list(src_views)[: input_views_num + 1]
        pick = rng.permutation(len(cands))[:input_views_num]
        return [cands[i] for i in pick]

    def read_image(self, info, view_idx, for_target: bool):
        img = read_image_file(info["img_paths"][view_idx]).astype(
            np.float32
        )
        return img / 255.0, img.shape[:2][::-1]

    def camera(self, info, view_idx, orig_size):
        return info["ixts"][view_idx].copy(), info["exts_w2c"][view_idx]

    def read_depth(self, info, view_idx):
        """Eval ground-truth depth with the reference's 1/2-res + crop
        protocol (lib/datasets/dtu/enerf_base.py:85-87)."""
        dpt = read_pfm(info["dpt_paths"][view_idx])[0].astype(np.float32)
        dpt = resize_area(dpt, dpt.shape[0] // 2, dpt.shape[1] // 2)
        return dpt[44:556, 80:720]

    def add_extra_fields(self, info, tar_view, sample):
        if self.split != "train" and os.path.exists(
            info["dpt_paths"][tar_view]
        ):
            sample["tar_dpt"] = self.read_depth(info, tar_view)
