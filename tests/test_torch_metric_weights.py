"""The port's metric-weight converters (``eval/vgg.convert_torchvision_weights``,
``eval/lpips.convert_lpips_weights``, ``python -m
boostmvsnerfs_torch.convert_metric_weights``) on random weights in
torchvision's and lpips' layouts, on the CPU.

The ``.npz`` files they write hold JAX's layout (``conv{i}_kernel`` HWIO,
``conv{i}_bias``, ``lin{i}``), and JAX's ``load_lpips`` /
``perceptual_loss_fn`` read them to the same distances and loss as the
port's (1e-5). Neither torchvision nor lpips is imported: both are made
unimportable while the converters run.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boostmvsnerfs_torch import convert_metric_weights as cli
from boostmvsnerfs_torch.eval import lpips as tlpips
from boostmvsnerfs_torch.eval import vgg as tvgg
from boostmvsnerfs_tpu.eval import lpips as jlpips
from boostmvsnerfs_tpu.eval import vgg as jvgg

# torchvision's vgg16().features: the convolutions' indices and channels
VGG16_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
               (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512),
               (24, 512, 512), (26, 512, 512), (28, 512, 512))


def _vgg_state(seed: int, prefix: str = "") -> dict:
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for n, cin, cout in VGG16_CONVS:
        sd[f"{prefix}{n}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) / np.sqrt(9 * cin)
        sd[f"{prefix}{n}.bias"] = torch.randn(cout, generator=gen) * 0.01
    return sd


def _lpips_state(seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen) * 2.0 / c
            for i, c in enumerate(tlpips.LIN_CHANNELS)}


@pytest.fixture
def no_packages(monkeypatch):
    """torchvision and lpips unimportable."""
    for name in ("torchvision", "lpips"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The CLI over a whole-model torchvision file (classifier included) and
    an lpips ``vgg.pth``: (the written paths, the source state dicts)."""
    d = tmp_path_factory.mktemp("weights")
    vgg = _vgg_state(0, "features.")
    vgg["classifier.0.weight"] = torch.zeros(8, 16)
    lin = _lpips_state(1)
    torch.save(vgg, d / "vgg16.pth")
    torch.save(lin, d / "vgg.pth")
    mp = pytest.MonkeyPatch()
    for name in ("torchvision", "lpips"):
        mp.setitem(sys.modules, name, None)
    try:
        written = cli.main(["--vgg", str(d / "vgg16.pth"), "--lpips", str(d / "vgg.pth"),
                            "--out-dir", str(d / "out")])
    finally:
        mp.undo()
    return written, vgg, lin


def test_cli_writes_jaxs_layout(files):
    written, vgg, lin = files
    assert sorted(written) == ["lpips", "vgg"]
    data = np.load(written["vgg"])
    assert sorted(data.files) == sorted(f"conv{i}_{p}" for i in range(13)
                                        for p in ("kernel", "bias"))
    for i, (n, _, _) in enumerate(VGG16_CONVS):
        np.testing.assert_array_equal(data[f"conv{i}_kernel"],
                                      vgg[f"features.{n}.weight"].numpy().transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(data[f"conv{i}_bias"], vgg[f"features.{n}.bias"].numpy())
    heads = np.load(written["lpips"])
    assert sorted(heads.files) == [f"lin{i}" for i in range(5)]
    for i, c in enumerate(tlpips.LIN_CHANNELS):
        np.testing.assert_array_equal(heads[f"lin{i}"],
                                      lin[f"lin{i}.model.1.weight"].numpy().reshape(c))


@pytest.mark.parametrize("prefix", ["", "features."])
def test_vgg_converter_takes_either_state_dict(tmp_path, no_packages, prefix):
    sd = _vgg_state(2, prefix)
    torch.save(sd, tmp_path / "w.pth")
    got = tvgg.convert_torchvision_weights(str(tmp_path / "w.pth"), str(tmp_path / "w.npz"))
    np.testing.assert_array_equal(got["conv12_kernel"],
                                  sd[f"{prefix}28.weight"].numpy().transpose(2, 3, 1, 0))
    assert tvgg.vgg_state_dict_from_npz(str(tmp_path / "w.npz")).keys() == \
        tvgg.VGG16Features().state_dict().keys()


def test_converters_refuse_other_networks(tmp_path, no_packages):
    sd = _vgg_state(3)
    del sd["28.weight"], sd["28.bias"]
    torch.save(sd, tmp_path / "w.pth")
    with pytest.raises(ValueError, match="12 convolutions"):
        tvgg.convert_torchvision_weights(str(tmp_path / "w.pth"), str(tmp_path / "w.npz"))
    lin = _lpips_state(4)
    lin["lin4.model.1.weight"] = torch.zeros(1, 256, 1, 1)
    torch.save(lin, tmp_path / "l.pth")
    with pytest.raises(ValueError, match="lin4 has 256 channels"):
        tlpips.convert_lpips_weights(str(tmp_path / "l.pth"), str(tmp_path / "l.npz"))


def _images(seed: int, n: int = 2, H: int = 32, W: int = 48) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, H, W, 3)).astype(np.float32)


def test_lpips_from_the_npz_matches_jax(files):
    written, _, _ = files
    a, b = _images(5), _images(6)
    got = tlpips.load_lpips(written["vgg"], written["lpips"], "cpu")(torch.tensor(a),
                                                                    torch.tensor(b))
    want = jlpips.load_lpips(written["vgg"], written["lpips"])(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_perceptual_loss_from_the_npz_matches_jax(files):
    written, _, _ = files
    a, b = (_images(s) * 0.5 + 0.5 for s in (7, 8))
    got = tvgg.perceptual_loss_fn(tvgg.load_vgg(written["vgg"], "cpu"))(torch.tensor(a),
                                                                       torch.tensor(b))
    want = jvgg.perceptual_loss_fn(jvgg.load_vgg_params(written["vgg"]))(jnp.asarray(a),
                                                                        jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
