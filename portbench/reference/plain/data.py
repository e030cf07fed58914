"""The reference's own inputs, read from a Free-layout scene's files: the
cameras from ``poses_bounds.npy``, the images from ``images_2/``, each
target's source views by camera distance, the scene's depth range, and the
rays of every level. The program's data layer derives the same from the
same files; the reference reads none of what it made.

Layout (the Free captures'): LLFF rows [down, right, -forward | t | (H, W,
focal)] at full resolution; the images at half of it; every 8th view a
test view; a test target's sources are its nearest train cameras, a train
target's the nearest others.
"""

from __future__ import annotations

import os

import numpy as np


def cameras(scene_dir: str):
    """(c2ws (N, 4, 4), intrinsics at the images' size (N, 3, 3), depth
    ranges (N, 2)), float32."""
    pb = np.load(os.path.join(scene_dir, "poses_bounds.npy"))
    rows = pb[:, :15].reshape(-1, 3, 5)
    n = len(rows)
    c2ws = np.tile(np.eye(4), (n, 1, 1))
    c2ws[:, :3, 0], c2ws[:, :3, 1], c2ws[:, :3, 2] = rows[:, :, 1], rows[:, :, 0], -rows[:, :, 2]
    c2ws[:, :3, 3] = rows[:, :, 3]
    ixts = np.tile(np.eye(3), (n, 1, 1))
    ixts[:, 0, 0] = ixts[:, 1, 1] = rows[:, 2, 4] / 2.0
    ixts[:, 0, 2], ixts[:, 1, 2] = rows[:, 1, 4] / 4.0, rows[:, 0, 4] / 4.0
    return c2ws.astype(np.float32), ixts.astype(np.float32), pb[:, -2:].astype(np.float32)


def image_names(scene_dir: str) -> list:
    return sorted(f for f in os.listdir(os.path.join(scene_dir, "images_2"))
                  if f.lower().endswith((".png", ".jpg", ".jpeg")))


def split_ids(n: int) -> tuple[list, list]:
    """(train views, test views): every 8th view is a test view."""
    return [i for i in range(n) if i % 8], [i for i in range(n) if i % 8 == 0]


def source_views(c2ws: np.ndarray, target: int, n_views: int) -> list:
    """The ``n_views`` train cameras nearest the target's, the target left
    out where it is a train view."""
    train, _ = split_ids(len(c2ws))
    dist = np.linalg.norm(c2ws[train, :3, 3] - c2ws[target, :3, 3], axis=-1)
    order = [train[j] for j in np.argsort(dist, kind="stable")]
    return [v for v in order if v != target][:n_views]


def _image(scene_dir: str, name: str, H: int, W: int) -> np.ndarray:
    from PIL import Image

    with Image.open(os.path.join(scene_dir, "images_2", name)) as img:
        pixels = np.asarray(img).astype(np.float32)
    if pixels.shape[:2] != (H, W):
        raise ValueError(f"{name}: {pixels.shape[:2]} is not the served size {(H, W)}")
    return pixels / 255.0


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Area interpolation (OpenCV's ``INTER_AREA``), as the recipe's loader
    scales a target to a level's size."""
    if img.shape[:2] == (H, W):
        return img
    import cv2

    return cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)


def sample(scene_dir: str, target: int, n_views: int, H: int, W: int,
           render_scale, with_rgb: bool) -> dict:
    """One target's inputs at H x W over its ``n_views`` nearest sources:
    the source images in [-1, 1], every camera as (intrinsics, world to
    camera), the scene's near and far, each source's depth range and each
    level's rays (every pixel of the level's raster); with ``with_rgb``,
    each level's target colours."""
    c2ws, ixts, ranges = cameras(scene_dir)
    names = image_names(scene_dir)
    src = source_views(c2ws, target, n_views)
    out = {
        "all_src_inps": np.stack([_image(scene_dir, names[v], H, W) * 2.0 - 1.0 for v in src]),
        "all_src_exts": np.linalg.inv(c2ws[src]).astype(np.float32),
        "all_src_ixts": ixts[src],
        "tar_ext": np.linalg.inv(c2ws[target]).astype(np.float32),
        "tar_ixt": ixts[target],
        "near_far": np.array([ranges[:, 0].min(), ranges[:, 1].max()], np.float32),
        "depth_ranges": ranges[src],
    }
    for k in ("inps", "exts", "ixts"):
        out[f"src_{k}"] = out[f"all_src_{k}"]
    tar = _image(scene_dir, names[target], H, W) if with_rgb else None
    for i, scale in enumerate(render_scale):
        H_r, W_r = int(H * scale), int(W * scale)
        out[f"ray_idx_{i}"] = np.arange(H_r * W_r, dtype=np.int32)
        if with_rgb:
            out[f"rgb_{i}"] = resize_area(tar, H_r, W_r).reshape(-1, 3).astype(np.float32)
    return out


def batch(samples: list) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
