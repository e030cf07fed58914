"""The port's capture and export utilities against JAX's, on the same seeded
inputs: COLMAP model I/O and the LLFF conversion (``utils/colmap.py``), the
COLMAP database (``utils/colmap_db.py``), PLY I/O, marching tetrahedra and
the mesh export (``utils/ply.py``, ``utils/mesh.py``), the mask labels
(``utils/masks.py``), and ``python -m boostmvsnerfs_torch.capture_to_llff``
against ``scripts/capture_to_llff.py``. Bar: equal arrays (these are numpy
copies)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from boostmvsnerfs_torch.utils import colmap, colmap_db, masks, mesh, ply
from boostmvsnerfs_tpu.utils import colmap as jcolmap
from boostmvsnerfs_tpu.utils import colmap_db as jcolmap_db
from boostmvsnerfs_tpu.utils import masks as jmasks
from boostmvsnerfs_tpu.utils import mesh as jmesh
from boostmvsnerfs_tpu.utils import ply as jply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy_model(mod, seed: int = 0, n_images: int = 3, n_pts: int = 24):
    """A sparse model of ``mod``'s dataclasses from a seeded generator:
    PINHOLE intrinsics, cameras turned about y, points in front of them,
    some of each image's observations unmatched (-1)."""
    rng = np.random.default_rng(seed)
    cams = {1: mod.Camera(1, "PINHOLE", 64, 48, np.array([60.0, 61.0, 32.0, 24.0]))}
    pts = {}
    for pid in range(n_pts):
        pts[pid] = mod.Point3D(pid, rng.uniform(-1, 1, 3) + [0, 0, 3.0],
                               rng.integers(0, 255, 3).astype(np.uint8), float(rng.uniform()),
                               np.arange(1, n_images + 1), np.full(n_images, pid))
    images = {}
    for iid in range(1, n_images + 1):
        a = 0.15 * iid
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        ids = np.arange(n_pts)
        ids[rng.uniform(size=n_pts) < 0.2] = -1
        images[iid] = mod.Image(iid, mod.rotmat2qvec(R), rng.uniform(-0.2, 0.2, 3), 1,
                                f"img_{iid:03d}.png", rng.uniform(0, 48, (n_pts, 2)), ids)
    return cams, images, pts


def test_quaternions_match_jax(rng):
    for _ in range(8):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_model_io_matches_jax(tmp_path, writer):
    """A model written by either package reads back equal in both, and the
    two packages write the same bytes."""
    ports = {"port": colmap, "jax": jcolmap}
    cams, images, pts = _toy_model(ports[writer])
    ports[writer].write_model(cams, images, pts, str(tmp_path / "a"))
    other = "jax" if writer == "port" else "port"
    ports[other].write_model(*_toy_model(ports[other]), str(tmp_path / "b"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    got, want = colmap.read_model(str(tmp_path / "a")), jcolmap.read_model(str(tmp_path / "a"))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            for field, value in vars(w[k]).items():
                np.testing.assert_array_equal(getattr(g[k], field), value)


def test_poses_bounds_match_jax():
    np.testing.assert_array_equal(colmap.colmap_to_poses_bounds(*_toy_model(colmap)),
                                  jcolmap.colmap_to_poses_bounds(*_toy_model(jcolmap)))


def _fill_db(mod, path, rng):
    kp = [rng.uniform(0, 640, size=(n, 2)).astype(np.float32) for n in (50, 40)]
    m = np.stack([rng.integers(0, 40, 30), rng.integers(0, 40, 30)], 1).astype(np.uint32)
    with mod.ColmapDB.create(path) as db:
        cam = db.add_camera("PINHOLE", 640, 480, [500.0, 501.0, 320.0, 240.0], prior_focal=True)
        ids = [db.add_image(f"{c}.jpg", cam) for c in "ab"]
        for i, k in zip(ids, kp):
            db.add_keypoints(i, k)
        db.add_matches(ids[1], ids[0], m)  # reversed ids: the columns flip
        db.add_two_view_geometry(ids[0], ids[1], m)
    return ids


def test_colmap_db_matches_jax(tmp_path):
    """The same writes through either package; each database read by both
    gives equal cameras, images, keypoints and matches."""
    paths = {}
    for name, mod in (("port", colmap_db), ("jax", jcolmap_db)):
        paths[name] = str(tmp_path / f"{name}.db")
        ids = _fill_db(mod, paths[name], np.random.default_rng(0))
    assert colmap_db.pair_id(*ids) == jcolmap_db.pair_id(*ids) == colmap_db.pair_id(*ids[::-1])
    assert colmap_db.unpack_pair_id(colmap_db.pair_id(3, 7)) == (3, 7)
    for path in paths.values():
        with colmap_db.ColmapDB.open(path) as db, jcolmap_db.ColmapDB.open(path) as jdb:
            cams, jcams = db.cameras(), jdb.cameras()
            assert cams.keys() == jcams.keys()
            for k in cams:
                assert {f: v for f, v in cams[k].items() if f != "params"} == \
                    {f: v for f, v in jcams[k].items() if f != "params"}
                np.testing.assert_array_equal(cams[k]["params"], jcams[k]["params"])
            assert db.images() == jdb.images()
            for i in ids:
                np.testing.assert_array_equal(db.keypoints(i), jdb.keypoints(i))
            (i1, i2, m), = list(db.matches())
            (j1, j2, jm), = list(jdb.matches())
            assert (i1, i2) == (j1, j2) == tuple(sorted(ids))
            np.testing.assert_array_equal(m, jm)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_matches_jax(tmp_path, rng, binary):
    v = rng.standard_normal((17, 3)).astype(np.float32)
    f = rng.integers(0, 17, size=(9, 3)).astype(np.int32)
    c = rng.integers(0, 256, size=(17, 3)).astype(np.uint8)
    n = rng.standard_normal((17, 3)).astype(np.float32)
    ply.write_ply(str(tmp_path / "port.ply"), v, faces=f, colors=c, normals=n, binary=binary)
    jply.write_ply(str(tmp_path / "jax.ply"), v, faces=f, colors=c, normals=n, binary=binary)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    got, want = ply.read_ply(str(tmp_path / "jax.ply")), jply.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(got["vertex"], want["vertex"])
    np.testing.assert_array_equal(got["face"], want["face"])
    np.testing.assert_array_equal(got["face"], f)


@pytest.mark.parametrize("field,level", [("sphere", 0.0), ("noise", 0.3), ("flat", 0.5)])
def test_marching_tetrahedra_matches_jax(rng, field, level):
    n = 17
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = {"sphere": 0.6 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2),
           "noise": rng.uniform(0, 1, (n, n, n)).astype(np.float32),
           "flat": np.zeros((n, n, n), np.float32)}[field]
    spacing, origin = np.full(3, 2.0 / (n - 1), np.float32), (-1.0, -1.0, -1.0)
    for dedup in (True, False):
        got = mesh.marching_tetrahedra(vol, level, spacing, origin, dedup=dedup)
        want = jmesh.marching_tetrahedra(vol, level, spacing, origin, dedup=dedup)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert (len(got[1]) > 0) == (field != "flat")


def _density(pts):
    """A density field as a NeRF sigma head's query gives it: (M, 1)."""
    return 0.5 - np.linalg.norm(pts * [1.0, 1.3, 0.8], axis=-1, keepdims=True)


def test_query_density_grid_and_extract_mesh_match_jax(tmp_path):
    bbox = [[-1, -0.8, -1.2], [1, 0.9, 1.1]]
    got = mesh.query_density_grid(_density, bbox, N=13, batch=77)
    want = jmesh.query_density_grid(_density, bbox, N=13, batch=77)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    out = {}
    for name, mod in (("port", mesh), ("jax", jmesh)):
        path = str(tmp_path / f"{name}.ply")
        out[name] = mod.extract_mesh(_density, 0.0, bbox, output_path=path, N=20, batch=1000)
    for g, w in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(g, w)
    assert len(out["port"][1]) > 50
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_masks_match_jax(rng):
    assert masks.ADE20K_LABELS == jmasks.ADE20K_LABELS and len(masks.ADE20K_LABELS) == 150
    assert masks.HUMAN_LABELS == jmasks.HUMAN_LABELS
    for human in (False, True):
        assert masks.get_label_id_mapping(human) == jmasks.get_label_id_mapping(human)
    labels = ["person", "sky", "bed ", "flag"]
    assert masks.get_class_ids_from_labels(labels) == jmasks.get_class_ids_from_labels(labels)
    label_map = rng.integers(0, 150, (24, 32))
    for sel, human in ((["sky", 12], False), (["tree", "grass"], False), (["person"], True)):
        np.testing.assert_array_equal(masks.mask_from_labels(label_map, sel, human),
                                      jmasks.mask_from_labels(label_map, sel, human))


def _run(args, cwd):
    r = subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=cwd,
                       env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"},
                       timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_capture_to_llff_matches_the_script(tmp_path):
    """``python -m boostmvsnerfs_torch.capture_to_llff`` writes the same
    ``poses_bounds.npy`` as ``scripts/capture_to_llff.py`` from one sparse
    model; ``--init-db`` seeds the same database."""
    out = {}
    for name, cmd in (("port", ["-m", "boostmvsnerfs_torch.capture_to_llff"]),
                      ("script", [os.path.join(REPO, "scripts", "capture_to_llff.py")])):
        scene = tmp_path / name
        colmap.write_model(*_toy_model(colmap), str(scene / "sparse" / "0"))
        (scene / "images").mkdir()
        for i in range(3):
            (scene / "images" / f"img_{i + 1:03d}.png").write_bytes(b"")
        _run([*cmd, str(scene), "--init-db", "60", "61", "32", "24", "64", "48"], REPO)
        out[name] = np.load(scene / "poses_bounds.npy")
        with colmap_db.ColmapDB.open(str(scene / "database.db")) as db:
            out[name + "_db"] = (db.cameras(), db.images())
    np.testing.assert_array_equal(out["port"], out["script"])
    np.testing.assert_array_equal(out["port"],
                                  jcolmap.colmap_to_poses_bounds(*_toy_model(jcolmap)))
    (cams, imgs), (jcams, jimgs) = out["port_db"], out["script_db"]
    assert imgs == jimgs and len(imgs) == 3
    np.testing.assert_array_equal(cams[1]["params"], jcams[1]["params"])
    assert cams[1]["prior_focal"] and cams[1]["width"] == 64
