"""The benchmark's scenes, made from the seed.

A scene is a Free-layout capture written to disk (``<root>/<scene>/
poses_bounds.npy`` and ``images_2/NNNN.jpg``), which the port's Free dataset
reads as it reads the paper's scenes: cameras along a forward-walking path
(the Free captures' geometry) and smooth images. The geometry is the same
for every seed; the seed draws the images. Smooth images stand for captured
ones: on uniform noise, float32's own rounding alone moves a frame's colour
by up to 0.13 between two runs of the same convolutions.

The generators are frozen copies: ``smooth_image`` of the sinusoid images
the port's smoke script draws, and ``write_free_scene`` of the port's
synthetic Free writer on a forward walk.
"""

from __future__ import annotations

import os

import numpy as np

# a Free scene's depth range and focal length at full resolution over width
DEPTH_RANGE = (2.0, 8.0)
FOCAL_OVER_W = 100.0 / 96.0
# the walk: metres a frame along +z, and the sway and turns of a hand-held camera
STEP = 0.1


def smooth_image(H: int, W: int, rng: np.random.Generator) -> np.ndarray:
    """An image (H, W, 3) in [-1, 1] made of six seeded sinusoids."""
    yy, xx = np.meshgrid(np.arange(H) / H, np.arange(W) / W, indexing="ij")
    img = np.zeros((H, W, 3))
    for _ in range(6):
        fx, fy, phase = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)[:, :, None]
        img += rng.uniform(-0.25, 0.25, (1, 1, 3)) * wave
    return img


def _turn(yaw: float, pitch: float) -> np.ndarray:
    """A rotation: ``yaw`` about y after ``pitch`` about x (radians)."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    return (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))


def walk_c2ws(n: int) -> np.ndarray:
    """Camera-to-world poses (n, 4, 4), OpenCV axes, of a forward walk:
    ``STEP`` along +z a frame, with a sideways and vertical sway and small
    turns, so that every combination of views covers a target differently."""
    c2ws = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        c2ws[i, :3, :3] = _turn(0.08 * np.sin(0.3 * i), 0.04 * np.cos(0.5 * i))
        c2ws[i, :3, 3] = [0.15 * np.sin(0.2 * i), 0.04 * np.cos(0.35 * i), STEP * i]
    return c2ws


def write_free_scene(root: str, scene: str, n: int, H: int, W: int, seed: int) -> None:
    """A Free-layout scene of ``n`` smooth H x W JPEG images (quality 95)
    on ``walk_c2ws``; the LLFF pose rows hold the full resolution (2H, 2W)
    and its focal length, as the Free captures' ``images_2`` copies do."""
    from PIL import Image

    img_dir = os.path.join(root, scene, "images_2")
    os.makedirs(img_dir, exist_ok=True)
    c2ws = walk_c2ws(n)
    pb = np.zeros((n, 17), np.float64)
    for i in range(n):
        m = np.zeros((3, 5))  # [down | right | -fwd | t | hwf]
        m[:, 1], m[:, 0], m[:, 2], m[:, 3] = c2ws[i, :3, 0], c2ws[i, :3, 1], -c2ws[i, :3, 2], \
            c2ws[i, :3, 3]
        m[:, 4] = [2 * H, 2 * W, FOCAL_OVER_W * W]
        pb[i, :15] = m.reshape(-1)
        pb[i, 15:] = DEPTH_RANGE
        img = smooth_image(H, W, np.random.default_rng([seed, i]))
        pixels = np.clip(np.round((img + 1.0) * 127.5), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(img_dir, f"{i:04d}.jpg"), quality=95)
    np.save(os.path.join(root, scene, "poses_bounds.npy"), pb)
