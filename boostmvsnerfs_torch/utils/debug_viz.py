"""Geometry debug visualizations: epipolar-line checks and per-pixel depth
probability plots (counterpart of ``boostmvsnerfs_tpu/utils/debug_viz.py``,
the same segments and points for the same inputs).

A re-design of the reference's manual debug tooling:

* ``epipolar_segments`` / ``epipolar_check_figure`` — reference
  lib/utils/enerf/val_data_utils.py:7-72 (``validate``/``transform``):
  unproject target pixels at the scene near/far depths, project into every
  source view, and draw the resulting epipolar segments over the source
  images. A correct camera convention shows each target feature lying ON
  its segment in every source view. The reference samples SIFT keypoints
  (cv2.xfeatures2d, a non-free build); here points come from a Harris-like
  gradient-corner score with a uniform-grid fallback — no cv2 dependency.
* ``depth_prob_figure`` — reference lib/networks/enerf/utils.py:733-751
  (``vis_prob``): the depth-hypothesis probability curve of one pixel next
  to the regressed depth/std maps. The reference drops into ipdb and
  plt.show(); here figures save to PNG (headless hosts).

Matplotlib is optional: the data-side functions are pure numpy; the
``*_figure`` writers raise a clear error when it is unavailable.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# epipolar check
# ---------------------------------------------------------------------------


def epipolar_segments(
    points_xy: np.ndarray,  # (N, 2) target pixel coords
    tar_ixt: np.ndarray,  # (3, 3)
    tar_ext: np.ndarray,  # (4, 4) w2c
    src_ixt: np.ndarray,  # (3, 3)
    src_ext: np.ndarray,  # (4, 4) w2c
    near: float,
    far: float,
) -> np.ndarray:
    """(N, 2, 2) [near_xy, far_xy] source-view endpoints per target pixel.

    The reference ``transform`` (val_data_utils.py:50-72): scale pixel
    homogeneous coords by depth, unproject through inv(tar_ixt) and
    inv(tar_ext), reproject with src_ext/src_ixt, divide by depth.
    """
    pts = np.asarray(points_xy, np.float64)
    out = []
    for depth in (float(near), float(far)):
        p = np.concatenate(
            [pts * depth, np.full_like(pts[:, :1], depth)], axis=-1
        )
        cam = p @ np.linalg.inv(tar_ixt).T  # target camera frame
        world = np.concatenate([cam, np.ones_like(cam[:, :1])], axis=-1)
        world = world @ np.linalg.inv(tar_ext).T
        src_cam = (world @ src_ext.T)[:, :3]
        uvz = src_cam @ src_ixt.T
        out.append(uvz[:, :2] / uvz[:, 2:3])
    return np.stack(out, axis=1).astype(np.float32)


def corner_points(img: np.ndarray, n: int, border: int = 8,
                  seed: int = 0) -> np.ndarray:
    """(n, 2) feature-like pixel coords: top gradient-product (Harris-style
    det proxy) responses on a blurred grid, de-duplicated by cell. Replaces
    the reference's SIFT keypoints (val_data_utils.py:15-18) without the
    non-free cv2.xfeatures2d build; falls back to a uniform grid on flat
    images."""
    g = np.asarray(img, np.float32)
    if g.ndim == 3:
        g = g.mean(-1)
    H, W = g.shape
    gy, gx = np.gradient(g)
    score = (gx * gx) * (gy * gy) - (gx * gy) ** 2
    score[:border], score[-border:] = 0, 0
    score[:, :border], score[:, -border:] = 0, 0
    if not np.any(score > 0):
        ys = np.linspace(border, H - border - 1, max(int(np.sqrt(n)), 2))
        xs = np.linspace(border, W - border - 1, max(int(np.sqrt(n)), 2))
        grid = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
        return grid[:n].astype(np.float32)
    # one best corner per coarse cell for spatial spread
    cells = max(int(np.ceil(np.sqrt(n * 2))), 2)
    pts = []
    for cy in range(cells):
        for cx in range(cells):
            y0, y1 = H * cy // cells, H * (cy + 1) // cells
            x0, x1 = W * cx // cells, W * (cx + 1) // cells
            block = score[y0:y1, x0:x1]
            if block.size == 0 or block.max() <= 0:
                continue
            iy, ix = np.unravel_index(np.argmax(block), block.shape)
            pts.append((x0 + ix, y0 + iy, block[iy, ix]))
    pts.sort(key=lambda t: -t[2])
    sel = np.asarray([(x, y) for x, y, _ in pts[:n]], np.float32)
    if len(sel) < n:  # pad from the global argsort
        flat = np.argsort(score.ravel())[::-1][: n - len(sel)]
        extra = np.stack([flat % W, flat // W], -1).astype(np.float32)
        sel = np.concatenate([sel, extra]) if len(sel) else extra
    return sel[:n]


def epipolar_check_figure(
    batch: dict, out_path: str, num_points: int = 10, seed: int = 0
) -> np.ndarray:
    """Save the epipolar sanity figure for batch item 0; returns the
    (S, N, 2, 2) segment endpoints for programmatic checks.

    ``batch`` uses the batch convention (``utils/synthetic.make_scene_batch``):
    ``tar_img`` or ``src_inps`` for pixels, ``tar_ixt``/``tar_ext``/
    ``src_ixts``/``src_exts``/``near_far``.
    """
    src_inps = np.asarray(batch["src_inps"])[0]  # (S, H, W, 3) in [-1, 1]
    tar_img = (
        np.asarray(batch["tar_img"])[0]
        if "tar_img" in batch
        else src_inps[0] * 0.5 + 0.5
    )
    tar_ixt = np.asarray(batch["tar_ixt"])[0]
    tar_ext = np.asarray(batch["tar_ext"])[0]
    near, far = np.asarray(batch["near_far"])[0]
    pts = corner_points(tar_img, num_points, seed=seed)

    S = src_inps.shape[0]
    segs = np.stack(
        [
            epipolar_segments(
                pts, tar_ixt, tar_ext,
                np.asarray(batch["src_ixts"])[0, s],
                np.asarray(batch["src_exts"])[0, s],
                near, far,
            )
            for s in range(S)
        ]
    )

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # pragma: no cover
        raise RuntimeError(
            "matplotlib is required for epipolar_check_figure; use "
            "epipolar_segments/corner_points for the raw data"
        ) from e

    fig, axes = plt.subplots(1, 1 + S, figsize=(4 * (1 + S), 4))
    axes[0].imshow(np.clip(tar_img, 0, 1))
    axes[0].set_title("target")
    axes[0].axis("off")
    colors = plt.cm.tab10(np.linspace(0, 1, len(pts)))
    for i, (x, y) in enumerate(pts):
        axes[0].plot([x], [y], ".", color=colors[i])
    for s in range(S):
        ax = axes[1 + s]
        ax.imshow(np.clip(src_inps[s] * 0.5 + 0.5, 0, 1))
        ax.set_title(f"src {s}")
        ax.axis("off")
        for i in range(len(pts)):
            ax.plot(segs[s, i, :, 0], segs[s, i, :, 1], "-", color=colors[i])
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return segs


# ---------------------------------------------------------------------------
# depth probability
# ---------------------------------------------------------------------------


def depth_prob_figure(
    depth: np.ndarray,  # (H, W) regressed depth
    std: np.ndarray,  # (H, W) regressed std
    prob: np.ndarray,  # (D, H, W) softmax depth probabilities
    depth_values: np.ndarray,  # (D, H, W) | (D,) hypothesis depths
    uv: tuple,  # (u row, v col) pixel to inspect
    out_path: str,
) -> dict:
    """Save the reference ``vis_prob`` panel (utils.py:733-751): depth map,
    std map, and the pixel's probability-vs-depth curve with the
    [depth-std, depth+std] bracket. Returns the plotted curve data."""
    u, v = int(uv[0]), int(uv[1])
    depth = np.asarray(depth)
    std = np.asarray(std)
    prob = np.asarray(prob)
    dv = np.asarray(depth_values)
    x = dv[:, u, v] if dv.ndim == 3 else dv
    y = prob[:, u, v]
    d, s = float(depth[u, v]), float(std[u, v])

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # pragma: no cover
        raise RuntimeError("matplotlib is required for depth_prob_figure") from e

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, title in ((axes[0], depth, "depth"), (axes[1], std, "std")):
        im = ax.imshow(img)
        ax.plot([v], [u], "r.")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    axes[2].plot(x, y, ".-")
    axes[2].plot([d - s, d + s], [0.1, 0.1], "-")
    axes[2].set_title(f"P(depth) at ({u}, {v})")
    axes[2].set_xlabel("depth")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return {"depths": x, "prob": y, "depth": d, "std": s}
