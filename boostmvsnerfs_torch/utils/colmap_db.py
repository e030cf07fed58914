"""COLMAP SQLite database I/O for the custom-capture pipeline
(counterpart of ``boostmvsnerfs_tpu/utils/colmap_db.py``).

The reference vendors COLMAP's ``database.py`` script
(``lib/utils/colmap/database.py``) so user captures can be
fed through COLMAP feature extraction / matching / mapping before LLFF-style
pose conversion (``BoostMVSNeRFs_DEMO.ipynb`` flow).  This module is an
independent implementation of the same publicly documented COLMAP schema
(https://colmap.github.io/database.html): the SQL table layout and the
pair-id packing are fixed by the COLMAP binary, so they match by necessity;
the API is our own (context-managed writer + typed readers returning numpy
arrays / dataclasses from :mod:`boostmvsnerfs_torch.utils.colmap`).

Typical use (writing known camera intrinsics before running COLMAP so the
mapper does not have to estimate them):

    with ColmapDB.create(path) as db:
        cam_id = db.add_camera(CAMERA_MODELS["PINHOLE"], w, h,
                               [fx, fy, cx, cy], prior_focal=True)
        for name in images:
            db.add_image(name, cam_id)
"""

from __future__ import annotations

import sqlite3
from typing import Iterator

import numpy as np

# COLMAP camera model ids (fixed by the COLMAP binary format; same ids as
# utils/colmap.py's CAMERA_MODEL table)
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": 0,
    "PINHOLE": 1,
    "SIMPLE_RADIAL": 2,
    "RADIAL": 3,
    "OPENCV": 4,
    "OPENCV_FISHEYE": 5,
    "FULL_OPENCV": 6,
    "FOV": 7,
    "SIMPLE_RADIAL_FISHEYE": 8,
    "RADIAL_FISHEYE": 9,
    "THIN_PRISM_FISHEYE": 10,
}

MAX_IMAGE_ID = 2 ** 31 - 1

# Schema per https://colmap.github.io/database.html — identical column
# layout to what the COLMAP binary creates (it must be, to interoperate).
_SCHEMA = (
    """CREATE TABLE IF NOT EXISTS cameras (
        camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
        model INTEGER NOT NULL,
        width INTEGER NOT NULL,
        height INTEGER NOT NULL,
        params BLOB,
        prior_focal_length INTEGER NOT NULL)""",
    f"""CREATE TABLE IF NOT EXISTS images (
        image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
        name TEXT NOT NULL UNIQUE,
        camera_id INTEGER NOT NULL,
        prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
        prior_tx REAL, prior_ty REAL, prior_tz REAL,
        CONSTRAINT image_id_check
            CHECK(image_id >= 0 and image_id < {MAX_IMAGE_ID}),
        FOREIGN KEY(camera_id) REFERENCES cameras(camera_id))""",
    """CREATE TABLE IF NOT EXISTS keypoints (
        image_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL,
        cols INTEGER NOT NULL,
        data BLOB,
        FOREIGN KEY(image_id) REFERENCES images(image_id)
            ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS descriptors (
        image_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL,
        cols INTEGER NOT NULL,
        data BLOB,
        FOREIGN KEY(image_id) REFERENCES images(image_id)
            ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS matches (
        pair_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL,
        cols INTEGER NOT NULL,
        data BLOB)""",
    """CREATE TABLE IF NOT EXISTS two_view_geometries (
        pair_id INTEGER PRIMARY KEY NOT NULL,
        rows INTEGER NOT NULL,
        cols INTEGER NOT NULL,
        data BLOB,
        config INTEGER NOT NULL,
        F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB)""",
    "CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name)",
)


def pair_id(image_id1: int, image_id2: int) -> int:
    """COLMAP's symmetric packing of an image-id pair into one int64."""
    lo, hi = sorted((int(image_id1), int(image_id2)))
    return lo * MAX_IMAGE_ID + hi


def unpack_pair_id(pid: int) -> tuple[int, int]:
    return pid // MAX_IMAGE_ID, pid % MAX_IMAGE_ID


def _blob(a: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(a, dtype=dtype).tobytes()


def _unblob(b, dtype, cols: int) -> np.ndarray:
    if b is None:
        return np.zeros((0, cols), dtype=dtype)
    return np.frombuffer(b, dtype=dtype).reshape(-1, cols).copy()


class ColmapDB:
    """Typed reader/writer over a COLMAP ``database.db``."""

    def __init__(self, conn: sqlite3.Connection):
        self.conn = conn

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def create(cls, path: str) -> "ColmapDB":
        db = cls(sqlite3.connect(path))
        for stmt in _SCHEMA:
            db.conn.execute(stmt)
        return db

    @classmethod
    def open(cls, path: str) -> "ColmapDB":
        return cls(sqlite3.connect(path))

    def close(self):
        self.conn.commit()
        self.conn.close()

    def __enter__(self) -> "ColmapDB":
        return self

    def __exit__(self, *exc):
        self.close()

    # -- writers -------------------------------------------------------
    def add_camera(
        self,
        model: int | str,
        width: int,
        height: int,
        params,
        prior_focal: bool = False,
        camera_id: int | None = None,
    ) -> int:
        if isinstance(model, str):
            model = CAMERA_MODELS[model]
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, int(width), int(height),
             _blob(np.asarray(params), np.float64), int(prior_focal)),
        )
        return cur.lastrowid

    def add_image(
        self,
        name: str,
        camera_id: int,
        prior_q=(None,) * 4,
        prior_t=(None,) * 3,
        image_id: int | None = None,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints (N, 2|4|6) float32: x, y [, affine params]."""
        kp = np.asarray(keypoints, np.float32)
        assert kp.ndim == 2 and kp.shape[1] in (2, 4, 6), kp.shape
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, *kp.shape, _blob(kp, np.float32)),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        d = np.asarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, *d.shape, _blob(d, np.uint8)),
        )

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        """matches (N, 2) uint32 keypoint-index pairs."""
        m = np.asarray(matches, np.uint32)
        assert m.ndim == 2 and m.shape[1] == 2, m.shape
        if image_id1 > image_id2:  # pair ids are stored lo-hi
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id(image_id1, image_id2), *m.shape, _blob(m, np.uint32)),
        )

    def add_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        matches: np.ndarray,
        F=np.eye(3),
        E=np.eye(3),
        H=np.eye(3),
        qvec=np.array([1.0, 0.0, 0.0, 0.0]),
        tvec=np.zeros(3),
        config: int = 2,
    ):
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pair_id(image_id1, image_id2), *m.shape, _blob(m, np.uint32),
             config, _blob(np.asarray(F), np.float64),
             _blob(np.asarray(E), np.float64),
             _blob(np.asarray(H), np.float64),
             _blob(np.asarray(qvec), np.float64),
             _blob(np.asarray(tvec), np.float64)),
        )

    # -- readers -------------------------------------------------------
    def cameras(self) -> dict[int, dict]:
        out = {}
        for cid, model, w, h, params, prior in self.conn.execute(
            "SELECT * FROM cameras"
        ):
            out[cid] = {
                "model": model,
                "width": w,
                "height": h,
                "params": np.frombuffer(params, np.float64).copy(),
                "prior_focal": bool(prior),
            }
        return out

    def images(self) -> dict[int, dict]:
        out = {}
        for row in self.conn.execute("SELECT * FROM images"):
            iid, name, cid = row[:3]
            out[iid] = {"name": name, "camera_id": cid,
                        "prior_q": row[3:7], "prior_t": row[7:10]}
        return out

    def keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT cols, data FROM keypoints WHERE image_id = ?",
            (image_id,),
        ).fetchone()
        if row is None:
            return np.zeros((0, 2), np.float32)
        return _unblob(row[1], np.float32, row[0])

    def matches(self) -> Iterator[tuple[int, int, np.ndarray]]:
        for pid, cols, data in self.conn.execute(
            "SELECT pair_id, cols, data FROM matches"
        ):
            i1, i2 = unpack_pair_id(pid)
            yield i1, i2, _unblob(data, np.uint32, cols)
