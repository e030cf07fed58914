"""Novel camera trajectories for free-viewpoint video (counterpart of
``boostmvsnerfs_tpu/utils/camera_paths.py``, the same poses for the same
anchors).

Reference lib/utils/rend_utils.py:19-162 (spiral and interpolated camera
paths) and lib/networks/mvsnerf/utils.py:479-508 (``gen_render_path`` pose
interpolation). Host code on numpy, OpenCV camera axes (x right, y down,
z forward); poses are (4, 4) camera-to-world matrices.
"""

from __future__ import annotations

import numpy as np

from boostmvsnerfs_torch.utils.colmap import qvec2rotmat, rotmat2qvec


def normalize(v):
    return v / (np.linalg.norm(v) + 1e-10)


def look_at(eye, target, up=np.array([0.0, 1.0, 0.0])):
    """OpenCV-convention c2w (x right, y down, z forward; det=+1)."""
    fwd = normalize(target - eye)
    right = normalize(np.cross(fwd, up))
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def average_pose(c2ws: np.ndarray) -> np.ndarray:
    """Mean camera pose of a trajectory (LLFF-style, OpenCV axes)."""
    center = c2ws[:, :3, 3].mean(0)
    fwd = normalize(c2ws[:, :3, 2].sum(0))
    down = normalize(c2ws[:, :3, 1].sum(0))
    right = normalize(np.cross(down, fwd))
    down2 = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down2, fwd, center
    return c2w


def spiral_path(
    c2ws: np.ndarray,
    n_frames: int = 60,
    n_rots: int = 2,
    zrate: float = 0.5,
    rads_scale: float = 1.0,
    focus_depth: float | None = None,
) -> np.ndarray:
    """Spiral around the average pose (LLFF render path): radii from the
    90th percentile of the cameras' offsets, every frame looking at the
    point ``focus_depth`` (default 1) ahead of the average pose."""
    avg = average_pose(c2ws)
    rads = np.percentile(np.abs(c2ws[:, :3, 3] - avg[:3, 3]), 90, axis=0)
    rads = rads * rads_scale + 1e-6
    if focus_depth is None:
        focus_depth = 1.0

    out = []
    for t in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
        offset = np.array(
            [np.cos(t) * rads[0], -np.sin(t) * rads[1], -np.sin(t * zrate) * rads[2]]
        )
        eye = avg[:3, 3] + avg[:3, :3] @ offset
        target = avg[:3, 3] + avg[:3, 2] * focus_depth
        out.append(look_at(eye, target, up=-avg[:3, 1]))
    return np.stack(out)


def _slerp(q0, q1, t):
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(d)
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_path(c2ws: np.ndarray, n_frames: int = 60) -> np.ndarray:
    """Smooth interpolation through the input camera poses (rotation slerp +
    linear translation), reference gen_render_path semantics: the first
    frame is the first pose, the last frame the last."""
    n = len(c2ws)
    qs = np.stack([rotmat2qvec(c[:3, :3]) for c in c2ws])
    ts = c2ws[:, :3, 3]
    out = []
    for p in np.linspace(0, n - 1, n_frames):
        i = min(int(np.floor(p)), n - 2)
        f = p - i
        c2w = np.eye(4)
        c2w[:3, :3] = qvec2rotmat(_slerp(qs[i], qs[i + 1], f))
        c2w[:3, 3] = (1 - f) * ts[i] + f * ts[i + 1]
        out.append(c2w)
    return np.stack(out)
