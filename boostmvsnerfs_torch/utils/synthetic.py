"""Synthetic multi-view scenes for smoke runs and tests: batches, the
port's copy of ``boostmvsnerfs_tpu/utils/synthetic.py`` (same arrays for
the same seed), and Free / ScanNet scenes written to disk in the datasets'
layouts."""

from __future__ import annotations

import os

import numpy as np

from boostmvsnerfs_torch.data.formats import write_image_file
from boostmvsnerfs_torch.models.boost_enerf import view_combinations


def look_at_ext(center, target=None, up=None):
    """OpenCV-convention w2c: camera x right, y down, z forward (det=+1)."""
    target = np.zeros(3) if target is None else target
    up = np.array([0.0, 1.0, 0.0]) if up is None else up
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ center
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3], ext[:3, 3] = R, t
    return ext


def make_scene_batch(
    B: int = 1,
    n_views: int = 3,
    H: int = 128,
    W: int = 192,
    render_scales=(0.25, 1.0),
    seed: int = 0,
    boost: bool = False,
    k_best: int = 4,
    input_views: int = 3,
    with_targets: bool = False,
    ray_subsample: dict | None = None,
    rig: str = "orbit",
):
    """A synthetic batch in the package convention (numpy arrays).

    ``ray_subsample``: optional {level: num_rays} for random ray subsets;
    by default full-image ray grids per level. ``rig`` is ``orbit`` (an
    inward-facing circular rig, wide baselines) or ``forward`` (a
    forward-walking handheld path with the target amid the sources, the
    Free-dataset evaluation geometry).
    """
    rng = np.random.default_rng(seed)
    radius = 3.0
    ixt = np.array(
        [[W * 1.1, 0.0, W / 2], [0.0, W * 1.1, H / 2], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )
    if rig == "forward":
        def walk(t):
            return np.array([0.15 * np.sin(0.5 * t), 0.04 * np.cos(0.9 * t), 0.25 * t])

        exts = np.stack([
            look_at_ext(walk(s), target=walk(s) + np.array([0.0, 0.0, 5.0]))
            for s in range(n_views)
        ])
        t_mid = (n_views - 1) / 2.0 + 0.5  # target between source frames
        tar_ext = look_at_ext(walk(t_mid), target=walk(t_mid) + np.array([0.0, 0.0, 5.0]))
        near_far = np.array([2.0, 6.0], dtype=np.float32)
    else:
        exts = np.stack([
            look_at_ext(np.array([
                radius * np.sin(0.25 * s - 0.4),
                0.3 * np.cos(0.9 * s),
                radius * np.cos(0.25 * s - 0.4),
            ]))
            for s in range(n_views)
        ])
        tar_ext = look_at_ext(np.array([0.15, 0.1, radius]))
        near_far = np.array([1.5, 6.0], dtype=np.float32)
    batch = {
        "src_inps": rng.uniform(-1, 1, (B, n_views, H, W, 3)).astype(np.float32),
        "src_exts": np.tile(exts, (B, 1, 1, 1)),
        "src_ixts": np.tile(ixt, (B, n_views, 1, 1)),
        "tar_ext": np.tile(tar_ext, (B, 1, 1)),
        "tar_ixt": np.tile(ixt, (B, 1, 1)),
        "near_far": np.tile(near_far, (B, 1)),
    }
    for i, scale in enumerate(render_scales):
        H_r, W_r = int(H * scale), int(W * scale)
        if ray_subsample and i in ray_subsample:
            idx = rng.integers(0, H_r * W_r, (B, ray_subsample[i])).astype(np.int32)
        else:
            idx = np.tile(np.arange(H_r * W_r, dtype=np.int32), (B, 1))
        batch[f"ray_idx_{i}"] = idx
        if with_targets:
            batch[f"rgb_{i}"] = rng.uniform(0, 1, idx.shape + (3,)).astype(np.float32)
    if boost:
        batch["all_src_inps"] = batch["src_inps"]
        batch["all_src_exts"] = batch["src_exts"]
        batch["all_src_ixts"] = batch["src_ixts"]
        combos = view_combinations(n_views, input_views)
        batch["combos"] = combos
        batch["k_best"] = np.tile(np.arange(k_best, dtype=np.int32) % len(combos), (B, 1))
    return batch


def mvsnerf_batch(batch: dict, k_best=(0, 5, 9, 14), input_views: int = 3) -> dict:
    """A ``make_scene_batch(boost=True)`` batch completed for (Boost)MVSNeRF,
    as ``scripts/bench_mvsnerf.py`` completes it: every view's depth range
    is the scene's ``near_far``, ``combos`` is the C(N, ``input_views``)
    table, ``k_best`` the given combination ids for every batch entry, and
    ``ray_idx_0`` covers every pixel."""
    B, n_views, H, W = batch["all_src_inps"].shape[:4]
    out = dict(batch)
    out["depth_ranges"] = np.tile(np.asarray(batch["near_far"], np.float32)[:, None, :],
                                  (1, n_views, 1))
    out["combos"] = view_combinations(n_views, input_views)
    out["k_best"] = np.tile(np.asarray(k_best, np.int32), (B, 1))
    out["ray_idx_0"] = np.tile(np.arange(H * W, dtype=np.int32), (B, 1))
    return out


def _turn(yaw: float, pitch: float) -> np.ndarray:
    """A camera rotation: ``yaw`` about y after ``pitch`` about x (radians)."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    return (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))


def _rig_turns(n: int, rig: str, seed: int) -> np.ndarray:
    """Per-camera rotations (n, 3, 3): none for the ``line`` / ``circle``
    rigs; for ``varied`` a seeded yaw in +-0.15 and pitch in +-0.1 rad, so
    that each view sees its own part of the scene and every combination of
    views covers a target differently."""
    if rig != "varied":
        return np.tile(np.eye(3), (n, 1, 1))
    rng = np.random.default_rng([seed, 1])
    return np.stack([_turn(*a) for a in rng.uniform([-0.15, -0.1], [0.15, 0.1], (n, 2))])


def write_free_scene(root: str, scene: str, n: int = 16, H: int = 64, W: int = 96,
                     seed: int = 11, rig: str = "circle") -> None:
    """A Free-layout scene on disk (``<root>/<scene>/poses_bounds.npy`` and
    ``images_2/NNNN.png``): ``n`` uniform-noise RGB images of H x W, cameras
    on a circle of radius 3 looking along +z (``rig="varied"``: each turned
    as ``_rig_turns`` says), depth range [2, 8], focal 100 * W / 96 at full
    resolution. At the defaults these are the files of
    ``tests/test_data.py::_write_free_scene``."""
    rng = np.random.default_rng(seed)
    turns = _rig_turns(n, rig, seed)
    os.makedirs(os.path.join(root, scene, "images_2"), exist_ok=True)
    pb = np.zeros((n, 17), np.float64)
    for i in range(n):
        # 3x5 LLFF pose block: [down | right | -fwd | t | hwf]
        angle = 0.2 * i
        c2w = np.eye(4)
        c2w[:3, :3] = turns[i]
        c2w[:3, 3] = [3 * np.sin(angle), 0.1, 3 * np.cos(angle)]
        m = np.zeros((3, 5))
        m[:3, 1] = c2w[:3, 0]
        m[:3, 0] = c2w[:3, 1]
        m[:3, 2] = -c2w[:3, 2]
        m[:3, 3] = c2w[:3, 3]
        m[0, 4], m[1, 4], m[2, 4] = H * 2, W * 2, 100.0 * W / 96
        pb[i, :15] = m.reshape(-1)
        pb[i, 15:] = [2.0, 8.0]
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        write_image_file(os.path.join(root, scene, "images_2", f"{i:04d}.png"), img)
    np.save(os.path.join(root, scene, "poses_bounds.npy"), pb)


def write_scannet_scene(root: str, scene: str, n: int = 6, H: int = 48, W: int = 64,
                        seed: int = 2, test_ids=(3, 5), rig: str = "line") -> None:
    """A ScanNet-layout scene on disk (``<root>/<scene>/exported/{color,
    pose,intrinsic}`` and ``<root>/splits/<scene>/{train,test}.txt``): ``n``
    uniform-noise JPEG images of H x W, cameras 0.1 apart along x at z = 2
    looking along +z (``rig="varied"``: each turned as ``_rig_turns`` says),
    focal 60 * W / 64 about the image centre; the frames in ``test_ids``
    form the test split and the rest the train split. At the defaults
    these are the files of ``tests/test_data.py::test_scannet_dataset``."""
    rng = np.random.default_rng(seed)
    turns = _rig_turns(n, rig, seed)
    exported = os.path.join(root, scene, "exported")
    for sub in ("color", "pose", "intrinsic"):
        os.makedirs(os.path.join(exported, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "splits", scene), exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        write_image_file(os.path.join(exported, "color", f"{i}.jpg"), img)
        c2w = np.eye(4)
        c2w[:3, :3] = turns[i]
        c2w[:3, 3] = [0.1 * i, 0, 2.0]
        np.savetxt(os.path.join(exported, "pose", f"{i}.txt"), c2w)
    f = 60.0 * W / 64
    np.savetxt(os.path.join(exported, "intrinsic", "intrinsic_color.txt"),
               np.array([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    train = [i for i in range(n) if i not in test_ids]
    for split, ids in (("train", train), ("test", test_ids)):
        with open(os.path.join(root, "splits", scene, f"{split}.txt"), "w") as fh:
            fh.write("\n".join(f"{i}.jpg" for i in ids))
