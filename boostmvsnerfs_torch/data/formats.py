"""On-disk image, camera and depth formats (counterpart of
``boostmvsnerfs_tpu/data/formats.py``).

Every image the data layer reads or writes goes through
``read_image_file`` / ``write_image_file``: imageio where it is installed,
as in the JAX package, else Pillow (both decode through Pillow, so the
arrays are the same). Neither is imported with the module.

Pure-numpy readers of the reference's formats (all public interchange
formats):
* LLFF ``poses_bounds.npy`` — reference lib/datasets/free/enerf_base.py:39-50
* MVSNet ``*_cam.txt`` — reference lib/utils/data_utils.py:41-52
* PFM depth maps — reference lib/utils/data_utils.py:68-96
* ScanNet ``exported/`` pose/intrinsic text files —
  reference lib/datasets/scannet_plus/enerf_base.py:37-50
"""

from __future__ import annotations

import os
import re

import numpy as np


def read_image_file(path: str) -> np.ndarray:
    """An image file as a numpy array (uint8 (H, W, 3) for RGB)."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img)
    return np.asarray(imageio.imread(path))


def write_image_file(path: str, img: np.ndarray) -> None:
    """Write a uint8 image; the format follows the file's suffix."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        from PIL import Image

        Image.fromarray(np.asarray(img)).save(path)
        return
    imageio.imwrite(path, img)


def parse_poses_bounds(path: str):
    """LLFF poses_bounds.npy -> (c2ws (N,4,4), ixts (N,3,3), depth_ranges (N,2)).

    The stored rows are 3x5 [down, right, -forward | t | (H, W, focal)]; the
    reference remaps columns to a right-up-backward c2w and halves the
    intrinsics for the ``images_2`` half-resolution copies
    (lib/datasets/free/enerf_base.py:39-46).
    """
    pb = np.load(path)
    poses = pb[:, :15].reshape(-1, 3, 5)
    n = len(poses)
    c2ws = np.eye(4, dtype=np.float64)[None].repeat(n, 0)
    c2ws[:, :3, 0] = poses[:, :3, 1]
    c2ws[:, :3, 1] = poses[:, :3, 0]
    c2ws[:, :3, 2] = -poses[:, :3, 2]
    c2ws[:, :3, 3] = poses[:, :3, 3]
    ixts = np.eye(3)[None].repeat(n, 0)
    ixts[:, 0, 0] = poses[:, 2, 4]
    ixts[:, 1, 1] = poses[:, 2, 4]
    ixts[:, 0, 2] = poses[:, 1, 4] / 2.0
    ixts[:, 1, 2] = poses[:, 0, 4] / 2.0
    ixts[:, :2] *= 0.5  # images_2 half-resolution convention
    depth_ranges = pb[:, -2:]
    return (
        c2ws.astype(np.float32),
        ixts.astype(np.float32),
        depth_ranges.astype(np.float32),
    )


def read_mvsnet_cam(path: str):
    """MVSNet camera file -> (ixt (3,3), ext (4,4) w2c, depth_min)."""
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    ext = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    ixt = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    return ixt, ext, depth_min


def read_pfm(path: str):
    """PFM file -> (data (H,W) or (H,W,3) float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("utf-8"))
        if not dim:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = data.reshape(shape)
    return np.flipud(data).copy(), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.flipud(image).astype(np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


def read_scannet_pose(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float32)


def read_scannet_intrinsic(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float32)[:3, :3]


def load_split_ids(path: str) -> list[int]:
    """ScanNet-plus split list: file names -> integer frame ids
    (reference lib/datasets/scannet_plus/enerf_base.py:66-70)."""
    names = np.loadtxt(path, dtype="U")
    return [int(os.path.basename(str(f)).split(".")[0]) for f in np.atleast_1d(names)]
