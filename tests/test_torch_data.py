"""The port's datasets and loader against JAX's, on Free, ScanNet and DTU
scenes written to disk (the fixtures of tests/test_data.py and
tests/test_dtu_data.py; the Free and ScanNet ones from the port's
``utils/synthetic``).

Both packages read the same files; every array of ``get_sample`` must be
equal (exact), on the test split and on the train split with its random
rays, patches and view jitter drawn from the same numpy ``rng``. The
``Loader`` must give the same batches in the same order: shuffle, per-process
sharding, view-count and image-size sampling.
"""

import os

import numpy as np
import pytest

from boostmvsnerfs_torch.data import formats
from boostmvsnerfs_torch.data.base import (
    resize_area,
    resize_nearest,
    sample_patch_pixels,
    sample_train_pixels,
)
from boostmvsnerfs_torch.data.custom import CustomDataset
from boostmvsnerfs_torch.data.dtu import DTUDataset
from boostmvsnerfs_torch.data.free import FreeDataset
from boostmvsnerfs_torch.data.loader import Loader
from boostmvsnerfs_torch.data.scannet import ScanNetDataset
from boostmvsnerfs_torch.models.enerf import CascadeConfig
from boostmvsnerfs_torch.utils.synthetic import write_free_scene, write_scannet_scene
from boostmvsnerfs_tpu.data import base as jbase
from boostmvsnerfs_tpu.data import formats as jformats
from boostmvsnerfs_tpu.data.custom import CustomDataset as JaxCustomDataset
from boostmvsnerfs_tpu.data.dtu import DTUDataset as JaxDTUDataset
from boostmvsnerfs_tpu.data.free import FreeDataset as JaxFreeDataset
from boostmvsnerfs_tpu.data.loader import Loader as JaxLoader
from boostmvsnerfs_tpu.data.scannet import ScanNetDataset as JaxScanNetDataset
from boostmvsnerfs_tpu.models.enerf import CascadeConfig as JaxCascadeConfig
from tests.helpers import look_at_ext
from tests.test_dtu_data import _write_cam

H, W = 64, 96
# eval: full-image rays; train: random rays, mask-weighted, with patches
# of even sizes (odd ones: test_patch_pixels_stay_in_frame)
EVAL = dict(volume_planes=(16, 8))
TRAIN = dict(volume_planes=(16, 8), train_img=(False, False), num_rays=(64, 128),
             num_patchs=(2, 1), patch_size=(2, 4), sample_on_mask=True)


def _pair(**kw):
    return CascadeConfig(**kw), JaxCascadeConfig(**kw)


@pytest.fixture(scope="module")
def free_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("free"))
    write_free_scene(root, "grass")
    return root


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scannet"))
    write_scannet_scene(root, "scene0000_01")
    return root


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    """tests/test_dtu_data.py's DTU layout, with depth maps of the smallest
    size the eval crop takes (1112 x 1440 at full, 556 x 720 after the
    1/2 resize)."""
    root = str(tmp_path_factory.mktemp("dtu"))
    rng = np.random.default_rng(4)
    scene = "scan1"
    for d in ("Cameras/train", f"Depths/{scene}", f"Rectified/{scene}_train"):
        os.makedirs(os.path.join(root, d))
    ixt = np.array([[W * 0.3, 0, W / 8], [0, W * 0.3, H / 8], [0, 0, 1]], np.float32)
    for i in range(8):
        ext = look_at_ext(np.array([600 * np.sin(0.15 * i), 50.0, 600 * np.cos(0.15 * i)]))
        _write_cam(os.path.join(root, f"Cameras/train/{i:08d}_cam.txt"), ixt, ext)
        formats.write_image_file(
            os.path.join(root, f"Rectified/{scene}_train/rect_{i + 1:03d}_3_r5000.png"),
            rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        formats.write_pfm(os.path.join(root, f"Depths/{scene}/depth_map_{i:04d}.pfm"),
                          rng.uniform(400, 900, (1112, 1440)).astype(np.float32))
    return root


def _assert_samples_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if k == "meta":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _check_dataset(ds, jds, n_views=None, size_hw=None):
    assert ds.metas == jds.metas
    assert len(ds) == len(jds) > 0
    for i in range(len(ds)):
        got = ds.get_sample(i, n_views, np.random.default_rng(i), size_hw=size_hw)
        want = jds.get_sample(i, n_views, np.random.default_rng(i), size_hw=size_hw)
        _assert_samples_equal(got, want)


@pytest.mark.parametrize("split,kw", [("test", EVAL), ("train", TRAIN)])
def test_free_samples_match_jax(free_root, split, kw):
    cas, jcas = _pair(**kw)
    args = dict(input_h_w=(48, 80), scenes=["grass"], n_train_views=4, n_test_views=5)
    _check_dataset(FreeDataset(free_root, split, cas, **args),
                   JaxFreeDataset(free_root, split, jcas, **args), n_views=3)


def test_free_sample_resized_matches_jax(free_root):
    cas, jcas = _pair(**EVAL)
    args = dict(input_h_w=(H, W), scenes=["grass"])
    _check_dataset(FreeDataset(free_root, "test", cas, **args),
                   JaxFreeDataset(free_root, "test", jcas, **args), size_hw=(32, 64))


def test_custom_samples_match_jax(free_root):
    cas, jcas = _pair(**EVAL)
    _check_dataset(CustomDataset(free_root, "test", cas, "grass", input_h_w=(H, W)),
                   JaxCustomDataset(free_root, "test", jcas, "grass", input_h_w=(H, W)))


@pytest.mark.parametrize("split,kw", [("test", EVAL), ("train", TRAIN)])
def test_scannet_samples_match_jax(scannet_root, split, kw):
    cas, jcas = _pair(**kw)
    args = dict(input_h_w=(H, W), scenes=["scene0000_01"], n_views=3)
    _check_dataset(ScanNetDataset(scannet_root, split, cas, **args),
                   JaxScanNetDataset(scannet_root, split, jcas, **args))


@pytest.mark.parametrize("split,kw", [("test", EVAL), ("train", TRAIN)])
def test_dtu_samples_match_jax(dtu_root, split, kw):
    """The train split jitters the source views with the rng; the test
    split carries the cropped ground-truth depth."""
    cas, jcas = _pair(**kw)
    args = dict(scenes=["scan1"], n_views=3, train_ids=[1, 2, 3, 4, 5], val_ids=[0, 6])
    ds = DTUDataset(dtu_root, split, cas, **args)
    _check_dataset(ds, JaxDTUDataset(dtu_root, split, jcas, **args), n_views=2)
    if split == "test":
        assert ds.get_sample(0)["tar_dpt"].shape == (512, 640)


@pytest.mark.parametrize("loader_kw", [
    dict(batch_size=1),
    dict(batch_size=2, shuffle=True, seed=3, num_processes=2, process_index=1),
    dict(batch_size=1, shuffle=True, ep_iter=5, input_views_num=[2, 3, 4],
         input_views_prob=[0.2, 0.5, 0.3], num_workers=2),
    dict(batch_size=2, shuffle=True, seed=1, image_size_meta={
        "strategy": "range", "min_hw": [32, 48], "max_hw": [64, 96]}),
])
def test_loader_matches_jax(free_root, loader_kw):
    cas, jcas = _pair(**TRAIN)
    args = dict(input_h_w=(H, W), scenes=["grass"], n_train_views=4)
    loader = Loader(FreeDataset(free_root, "train", cas, **args), **loader_kw)
    jloader = JaxLoader(JaxFreeDataset(free_root, "train", jcas, **args), **loader_kw)
    assert len(loader) == len(jloader)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            _assert_samples_equal(g, w)


def test_sample_train_pixels_matches_jax():
    msk = np.random.default_rng(0).uniform(size=(24, 32)) > 0.7
    for kw in (dict(), dict(sample_on_mask=True), dict(num_patchs=3, patch_size=5),
               dict(sample_on_mask=True, num_patchs=2, patch_size=4)):
        got = sample_train_pixels(np.random.default_rng(1), 24, 32, 100, msk, **kw)
        want = jbase.sample_train_pixels(np.random.default_rng(1), 24, 32, 100, msk, **kw)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("patch_size", [2, 3, 4, 5])
def test_patch_pixels_stay_in_frame(patch_size):
    """Mask-drawn patch centres clip so that the whole patch stays in the
    frame. JAX clips odd sizes one pixel too far (ROADMAP fault 11); the
    port's pixels equal JAX's wherever JAX's patch is in-frame, and every
    one of the port's is."""
    H_r, W_r = 12, 20
    msk = np.zeros((H_r, W_r), bool)
    msk[:, -2:] = msk[-2:, :] = True  # centres at the right and bottom edges
    jax_out = 0
    for seed in range(40):
        X, Y = sample_patch_pixels(np.random.default_rng(seed), 3, patch_size, H_r, W_r, msk)
        jX, jY = jbase.sample_patch_pixels(np.random.default_rng(seed), 3, patch_size, H_r,
                                           W_r, msk)
        assert X.min() >= 0 and Y.min() >= 0 and X.max() < W_r and Y.max() < H_r
        inside = (jX.max() < W_r) and (jY.max() < H_r)
        jax_out += not inside
        if inside:
            np.testing.assert_array_equal(X, jX)
            np.testing.assert_array_equal(Y, jY)
    assert jax_out == 0 if patch_size % 2 == 0 else jax_out > 0


@pytest.mark.parametrize("fn,jfn", [(resize_area, jbase.resize_area),
                                    (resize_nearest, jbase.resize_nearest)])
def test_resizes_match_jax(fn, jfn):
    img = np.random.default_rng(0).uniform(size=(50, 70, 3)).astype(np.float32)
    for hw in ((25, 35), (32, 48), (50, 70)):
        np.testing.assert_array_equal(fn(img, *hw), jfn(img, *hw))


def test_image_and_pfm_files_roundtrip(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (9, 13, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    formats.write_image_file(path, img)
    np.testing.assert_array_equal(formats.read_image_file(path), img)
    dpt = np.random.default_rng(1).uniform(size=(7, 5)).astype(np.float32)
    formats.write_pfm(str(tmp_path / "d.pfm"), dpt)
    got, _ = formats.read_pfm(str(tmp_path / "d.pfm"))
    want, _ = jformats.read_pfm(str(tmp_path / "d.pfm"))
    np.testing.assert_array_equal(got, dpt)
    np.testing.assert_array_equal(got, want)


def test_image_reader_falls_back_to_pillow(tmp_path, monkeypatch):
    """Without imageio (as on the GPU machine) Pillow reads and writes."""
    import sys

    img = np.random.default_rng(0).integers(0, 255, (9, 13, 3), dtype=np.uint8)
    formats.write_image_file(str(tmp_path / "a.png"), img)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    np.testing.assert_array_equal(formats.read_image_file(str(tmp_path / "a.png")), img)
    formats.write_image_file(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(formats.read_image_file(str(tmp_path / "b.png")), img)
