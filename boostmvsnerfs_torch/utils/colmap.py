"""COLMAP sparse-model I/O (cameras / images / points3D, bin + txt)
(counterpart of ``boostmvsnerfs_tpu/utils/colmap.py``, the same arrays for
the same models).

Own implementation of the public COLMAP format (the reference vendors
COLMAP's scripts at lib/utils/colmap/read_write_model.py). Covers what the
custom-capture pipeline needs: parsing a reconstruction into camera
intrinsics/extrinsics and converting to LLFF ``poses_bounds.npy``
(reference notebook flow, BoostMVSNeRFs_DEMO.ipynb + README.md:140-149).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

# camera model id -> (name, #params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: i for i, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = p[0], p[1], p[2]
            fx = fy = f
        elif self.model in ("PINHOLE", "OPENCV", "FULL_OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        elif self.model == "RADIAL":
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            raise ValueError(f"unsupported camera model {self.model}")
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclasses.dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2)
    point3D_ids: np.ndarray  # (N,)

    def R(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)

    def w2c(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R()
        m[:3, 3] = self.tvec
        return m


@dataclasses.dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q *= -1
    return q


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


# ---------------------------------------------------------------------------
# binary readers/writers
# ---------------------------------------------------------------------------

def read_cameras_bin(path) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * np_, "d" * np_))
            cams[cid] = Camera(cid, name, int(w), int(h), params)
    return cams


def write_cameras_bin(cams: dict, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_images_bin(path) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read(f, 8, "Q")
            data = np.array(_read(f, 24 * npts, "ddq" * npts)).reshape(-1, 3)
            images[iid] = Image(
                iid, qvec, tvec, cam_id, name.decode(),
                data[:, :2].astype(np.float64), data[:, 2].astype(np.int64),
            )
    return images


def write_images_bin(images: dict, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def read_points3d_bin(path) -> dict:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            pid = _read(f, 8, "q")[0]
            xyz = np.array(_read(f, 24, "ddd"))
            rgb = np.array(_read(f, 3, "BBB"))
            err = _read(f, 8, "d")[0]
            (tl,) = _read(f, 8, "Q")
            track = np.array(_read(f, 8 * tl, "ii" * tl)).reshape(-1, 2)
            pts[pid] = Point3D(pid, xyz, rgb, err, track[:, 0], track[:, 1])
    return pts


def write_points3d_bin(pts: dict, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<q", p.id))
            f.write(struct.pack("<ddd", *p.xyz))
            f.write(struct.pack("<BBB", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pidx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(pidx)))


def read_model(path: str):
    """(cameras, images, points3D) from a sparse model directory (binary)."""
    return (
        read_cameras_bin(os.path.join(path, "cameras.bin")),
        read_images_bin(os.path.join(path, "images.bin")),
        read_points3d_bin(os.path.join(path, "points3D.bin")),
    )


def write_model(cams, images, pts, path: str):
    os.makedirs(path, exist_ok=True)
    write_cameras_bin(cams, os.path.join(path, "cameras.bin"))
    write_images_bin(images, os.path.join(path, "images.bin"))
    write_points3d_bin(pts, os.path.join(path, "points3D.bin"))


# ---------------------------------------------------------------------------
# LLFF conversion (imgs2poses equivalent)
# ---------------------------------------------------------------------------

def colmap_to_poses_bounds(cams: dict, images: dict, pts: dict) -> np.ndarray:
    """Sparse model -> LLFF poses_bounds rows (N, 17), sorted by image name.

    Pose block is the LLFF [down|right|-forward|t|(H, W, f)] 3x5 layout the
    Free dataset parser expects (reference lib/datasets/free/enerf_base.py:40-46);
    bounds are per-image [0.1%, 99.9%] depth percentiles of visible points.
    """
    rows = []
    for iid in sorted(images, key=lambda i: images[i].name):
        im = images[iid]
        cam = cams[im.camera_id]
        K = cam.K()
        w2c = im.w2c()
        c2w = np.linalg.inv(w2c)
        # c2w columns: right, down?? LLFF stores [down, right, -fwd]
        m = np.zeros((3, 5))
        m[:, 0] = c2w[:3, 1]  # down (LLFF stores -up first)
        m[:, 1] = c2w[:3, 0]  # right
        m[:, 2] = -c2w[:3, 2]  # -forward (backward)
        m[:, 3] = c2w[:3, 3]
        m[0, 4], m[1, 4], m[2, 4] = cam.height, cam.width, K[0, 0]

        vis_ids = im.point3D_ids[im.point3D_ids >= 0]
        depths = []
        for pid in vis_ids:
            if pid in pts:
                p_cam = w2c[:3, :3] @ pts[pid].xyz + w2c[:3, 3]
                if p_cam[2] > 0:
                    depths.append(p_cam[2])
        if depths:
            lo, hi = np.percentile(depths, [0.1, 99.9])
        else:
            lo, hi = 0.1, 100.0
        rows.append(np.concatenate([m.reshape(-1), [lo, hi]]))
    return np.stack(rows)
