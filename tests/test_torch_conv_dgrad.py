"""The data-gradient route of ``models/blocks.conv_at`` on the CPU.

``ops/cuda/conv_dgrad``'s plain version (the CUDA kernel's contract: a
convolution's input gradient, equally a transposed convolution's forward)
against autograd and ``F.conv_transpose3d`` for every 3D family the
networks use, including the 41 -> 8 and 8 -> 1 layers and a
channels-last output gradient; ``KernelConv`` on the route against the
module's own autograd; ``conv_at``'s choice of route and its launches;
the one shape rule outside which the route stays off and the wrapper
raises;
BoostENeRF and BoostMVSNeRF training steps whose gradients do not move
with the route; and an eval frame of each family whose output does not
move. The route runs on CUDA only, so the cases that take it here add the
CPU to ``blocks.DGRAD_DEVICES`` (and ``WGRAD_DEVICES``). The CUDA kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``kernels`` and
``kernels_train``).

Tolerances: float64 where the sum order is the only difference (rtol 1e-10
for one convolution; 1e-8 of each leaf's largest gradient for a whole
step, whose BatchNorms and softmaxes amplify a rounding by ~1e5). A float32
step is held against the float64 one: the route's error on each leaf may be
at most twice the error of the step without it, plus 1e-5 of the leaf's
largest gradient (float32 alone reads up to 3% on a BoostENeRF leaf at this
geometry, the route moving a leaf by up to 0.5%). A float32 eval frame, on a
target camera between two sources (on a source camera the in-frame masks
flip by rounding, ROADMAP fault 4), moves by rounding only: rtol 1e-5 of
each output's largest magnitude. Everything runs on one thread.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from boostmvsnerfs_torch.models import blocks
from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.boost_mvsnerf import BoostMVSNeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
from boostmvsnerfs_torch.models.mvsnerf import MVSNeRFConfig
from boostmvsnerfs_torch.ops.cuda import conv_dgrad
from boostmvsnerfs_torch.parallel.train import make_blocked_loss
from boostmvsnerfs_torch.train.loss import enerf_loss
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_torch.utils.roofline import conv_dgrad_counts, conv_wgrad_counts
from boostmvsnerfs_torch.utils.synthetic import look_at_ext, make_scene_batch, mvsnerf_batch

# (input shape, weight shape, stride, transposed, output gradient channels-last)
FAMILIES = {
    "s1": ((2, 16, 4, 6, 7), (8, 16, 3, 3, 3), 1, False, False),
    "s2_even": ((2, 8, 4, 6, 8), (16, 8, 3, 3, 3), 2, False, False),
    "s2_odd": ((2, 8, 5, 7, 9), (16, 8, 3, 3, 3), 2, False, False),
    "transposed_s2_op1": ((2, 64, 2, 3, 4), (64, 32, 3, 3, 3), 2, True, False),
    "in41_out8": ((1, 41, 3, 5, 6), (8, 41, 3, 3, 3), 1, False, True),
    "in8_out1": ((2, 8, 4, 5, 6), (1, 8, 3, 3, 3), 1, False, False),
    "channels_last": ((2, 32, 4, 5, 6), (8, 32, 3, 3, 3), 1, False, True),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _routes(monkeypatch, dgrad=True, wgrad=True, dtype=torch.float32) -> list:
    """Open the routes on the CPU (``dtype`` the kernels' operand type);
    returns the list that counts ``conv_dgrad``'s launches (its plain
    version's calls here)."""
    monkeypatch.setattr(blocks, "WGRAD_DEVICES", ("cuda", "cpu") if wgrad else ("cuda",))
    monkeypatch.setattr(blocks, "DGRAD_DEVICES", ("cuda", "cpu") if dgrad else ("cuda",))
    monkeypatch.setattr(blocks, "KERNEL_DTYPE", dtype)
    calls = []
    real = conv_dgrad.conv_dgrad_plain
    monkeypatch.setattr(conv_dgrad, "conv_dgrad_plain",
                        lambda *a: calls.append(1) or real(*a))
    return calls


def _family_tensors(name, dtype=torch.float64):
    x_shape, w_shape, s, transposed, channels_last = FAMILIES[name]
    gen = torch.Generator().manual_seed(len(name))
    x = torch.randn(x_shape, generator=gen, dtype=dtype)
    w = torch.randn(w_shape, generator=gen, dtype=dtype)
    return x, w, s, transposed, channels_last


def _plain_case(name):
    """The plain version against autograd (a convolution's input gradient)
    or ``F.conv_transpose3d`` (a transposed convolution's forward, with a
    bias), float64."""
    def case(monkeypatch):
        x, w, s, transposed, channels_last = _family_tensors(name)
        stride, padding = (s,) * 3, (1,) * 3
        if transposed:
            b = torch.randn(w.shape[1], dtype=torch.float64)
            want = F.conv_transpose3d(x, w, b, stride=s, padding=1, output_padding=s - 1)
            got = conv_dgrad.conv_transpose_forward(x, w, b, stride, padding, (s - 1,) * 3)
        else:
            x.requires_grad_()
            y = F.conv3d(x, w, stride=s, padding=1)
            g = torch.randn_like(y)
            if channels_last:  # as the permuted cost volume's convolution gives it
                g = g.contiguous(memory_format=torch.channels_last_3d)
            want = torch.autograd.grad(y, x, g)[0]
            got = conv_dgrad.conv_data_grad(g, w, x.shape, stride, padding)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    return case


def _function_case(name):
    """``KernelConv`` on both routes against autograd through the module's
    own call, float64: forward, input, weight and bias gradients; the data
    gradient launched once (the transposed forward, or the input
    gradient)."""
    def case(monkeypatch):
        calls = _routes(monkeypatch, dtype=torch.float64)
        x, w, s, transposed, channels_last = _family_tensors(name)
        kind = nn.ConvTranspose3d if transposed else nn.Conv3d
        extra = {"output_padding": s - 1} if transposed else {}
        m = kind(w.shape[0] if transposed else w.shape[1], w.shape[1] if transposed else
                 w.shape[0], 3, stride=s, padding=1, **extra).double()
        with torch.no_grad():
            m.weight.copy_(w)
        if channels_last:  # a permuted view, as the cost volume reaches conv0
            x = x.movedim(1, -1).contiguous().movedim(-1, 1)
        x.requires_grad_()
        y_ref = m(x)
        g = torch.randn_like(y_ref)
        want = torch.autograd.grad(y_ref, [x, *m.parameters()], g)
        y = blocks.conv_at(m, x)
        assert calls == ([1] if transposed else [])
        got = torch.autograd.grad(y, [x, *m.parameters()], g)
        assert calls == [1]
        torch.testing.assert_close(y, y_ref, rtol=1e-10, atol=1e-10)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    return case


def _choice_case(setting: str):
    """``conv_at``'s route and ``conv_dgrad``'s launches: a float32
    transposed convolution takes the kernel for its forward with or
    without gradients (its own input gradient stays PyTorch's), a float32
    3D convolution in training for its input gradient; 2D, bf16, other
    kernel sizes or paddings, and a device outside ``DGRAD_DEVICES`` keep
    PyTorch's."""
    def case(monkeypatch):
        calls = _routes(monkeypatch, dgrad=setting != "cuda_only")
        torch.manual_seed(0)
        transposed = setting.startswith("transposed")
        if transposed:
            conv = nn.ConvTranspose3d(8, 4, 3, stride=2, padding=1, output_padding=1, bias=False)
            x = torch.randn(1, 8, 2, 3, 4)
        elif setting == "conv2d":
            conv, x = nn.Conv2d(4, 8, 3, padding=1, bias=False), torch.randn(1, 4, 5, 6)
        elif setting == "k5":
            conv, x = nn.Conv3d(4, 8, 5, padding=2, bias=False), torch.randn(1, 4, 3, 5, 6)
        else:
            conv, x = nn.Conv3d(4, 8, 3, padding=1, bias=False), torch.randn(1, 4, 3, 5, 6)
        dtype = torch.bfloat16 if setting == "bfloat16" else None
        if setting == "transposed_frozen":
            conv.weight.requires_grad_(False)
        grad = setting not in ("transposed_eval", "no_grad")
        x.requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y = blocks.conv_at(conv, x, dtype)
        want = blocks._conv(conv, x.to(dtype or x.dtype), conv.weight.to(dtype or x.dtype), None)
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        forward = len(calls)
        if grad:
            y.float().square().sum().backward()
        launches = {"transposed_eval": (1, 1), "transposed_frozen": (1, 1),
                    "transposed_train": (1, 1), "conv_train": (0, 1)}
        assert (forward, len(calls)) == launches.get(setting, (0, 0)), setting
        # a 3D convolution's forward without gradients is not a data gradient
        assert blocks.routes_dgrad(conv, x, dtype) == (setting in launches
                                                       or setting == "no_grad"), setting
    return case


def _walk_target(batch: dict) -> dict:
    """The target camera between source frames 1 and 2 of the forward rig
    (on frame 2 the in-frame masks flip by rounding, ROADMAP fault 4)."""
    pos = np.array([0.15 * np.sin(0.75), 0.04 * np.cos(1.35), 0.375])
    batch["tar_ext"] = look_at_ext(pos, target=pos + np.array([0.0, 0.0, 5.0]))[None]
    return batch


def _enerf(dtype):
    model = BoostENeRF(CascadeConfig(k_best=2, volume_planes=(16, 8), num_samples=(8, 2)),
                       device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in random_state_dict(model, 0).items()})
    return model.to(dtype)


def _mvsnerf(dtype):
    model = BoostMVSNeRF(MVSNeRFConfig(k_best=2, num_samples=8), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in random_state_dict(model, 0).items()})
    return model.to(dtype)


def _cast(batch: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def _enerf_batch(dtype, targets=True):
    return _cast(to_tensors(_walk_target(make_scene_batch(
        B=1, n_views=4, H=64, W=96, boost=True, k_best=2, seed=0, rig="forward",
        with_targets=targets)), "cpu"), dtype)


def _mvs_batch(dtype, rays=256):
    b = _walk_target(make_scene_batch(B=1, n_views=4, H=32, W=64, boost=True, seed=0,
                                      rig="forward", render_scales=(1.0,),
                                      ray_subsample={0: rays} if rays else None,
                                      with_targets=bool(rays)))
    out = mvsnerf_batch(b, k_best=(0, 3))
    if rays:
        out["ray_idx_0"], out["rgb_0"] = b["ray_idx_0"], b["rgb_0"]
    return _cast(to_tensors(out, "cpu"), dtype)


MVS_CAS = CascadeConfig(num=1, loss_weight=(1.0,), render_if=(True,), train_img=(False,))


def _step_grads(family: str, dtype, monkeypatch, dgrad: bool) -> dict:
    """One training step's gradients (a BoostENeRF blocked step of K=2 of
    C(4,3) at 64x96 in 4 ray blocks; a BoostMVSNeRF step of 256 random
    rays at 32x64), the weight-gradient route on, the data-gradient route
    on or off."""
    calls = _routes(monkeypatch, dgrad=dgrad, dtype=dtype)
    if family == "enerf":
        model = _enerf(dtype).train()
        loss, _ = make_blocked_loss(model, 4)(_enerf_batch(dtype))
        routed = 21  # 5 transposed forwards, 16 input gradients
    else:
        model = _mvsnerf(dtype).train()
        batch = _mvs_batch(dtype)
        c = MVS_CAS
        loss, _ = enerf_loss(model.render(batch), batch, c.loss_weight, c.num, c.render_if,
                             None, None, c.train_img)
        routed = 10  # 3 transposed forwards, 7 input gradients
    loss.backward()
    assert len(calls) == (routed if dgrad else 0)
    return {n: p.grad.double() for n, p in model.named_parameters()}


def _step_case(family: str):
    """The step's gradients with the data-gradient route against those
    without it: in float64 equal to 1e-8 of each leaf's largest gradient;
    in float32 each leaf's error against the float64 step at most twice
    the step's own without the route, plus 1e-5 of the leaf's largest
    gradient (module docstring)."""
    def case(monkeypatch):
        want = _step_grads(family, torch.float64, monkeypatch, dgrad=False)
        got = _step_grads(family, torch.float64, monkeypatch, dgrad=True)
        assert got.keys() == want.keys()
        for n in want:
            floor = 1e-8 * float(want[n].abs().max())
            torch.testing.assert_close(got[n], want[n], rtol=1e-8, atol=floor, msg=n)
        off = _step_grads(family, torch.float32, monkeypatch, dgrad=False)
        on = _step_grads(family, torch.float32, monkeypatch, dgrad=True)
        for n in want:
            scale = float(want[n].abs().max())
            err_on = float((on[n] - want[n]).abs().max())
            err_off = float((off[n] - want[n]).abs().max())
            assert err_on <= 2 * err_off + 1e-5 * scale, (n, err_on, err_off, scale)
    return case


def _frame_case(family: str):
    """An eval frame (float32, the module in eval mode) with the route, its
    transposed convolutions on ``conv_dgrad`` (5 a BoostENeRF frame, 3 a
    BoostMVSNeRF one), against the frame without it: every output within
    rounding (rtol 1e-5 of its largest magnitude)."""
    def case(monkeypatch):
        outs, launches = [], []
        for dgrad in (False, True):
            calls = _routes(monkeypatch, dgrad=dgrad)
            if family == "enerf":
                model, batch = _enerf(torch.float32), _enerf_batch(torch.float32, False)
            else:
                model, batch = _mvsnerf(torch.float32), _mvs_batch(torch.float32, None)
            with torch.no_grad():
                outs.append(model.eval()(batch))
            launches.append(len(calls))
        assert launches == [0, 5 if family == "enerf" else 3]
        want, got = outs
        assert got.keys() == want.keys()
        for k in want:
            scale = float(want[k].abs().max())
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5 * scale, msg=k)
    return case


def _counts_case(monkeypatch):
    """The data gradient's work (``utils/roofline.conv_dgrad_counts``): the
    multiply-adds of the weight gradient of the same convolution, and the
    transposed convolution counted as the data gradient of its adjoint."""
    x, g, w = (2, 8, 6, 8, 10), (2, 16, 3, 4, 5), (16, 8, 3, 3, 3)
    assert conv_dgrad_counts(g, x, w, (2,) * 3, (1,) * 3) == conv_wgrad_counts(
        x, g, w, (2,) * 3, (1,) * 3)
    nbytes, ops = conv_dgrad_counts((1, 1, 1, 1, 3), (1, 2, 1, 1, 3), (1, 2, 3, 3, 3), (1,) * 3,
                                    (1,) * 3)
    assert ops == 2 * 2 * 7  # 7 live (position, tap) pairs along x, one along y and z
    assert nbytes == 4 * (3 + 6 + 54)


def _refused_case(kernel: int, padding: int, stride: int):
    """One shape rule (``conv_dgrad.fits``): outside it ``routes_dgrad``
    keeps PyTorch's convolution and ``conv_data_grad`` raises."""
    def case(monkeypatch):
        _routes(monkeypatch)
        conv = nn.Conv3d(4, 8, kernel, stride=stride, padding=padding, bias=False)
        x = torch.randn(1, 4, 6, 7, 8, requires_grad=True)
        g = torch.randn_like(conv(x))
        assert not conv_dgrad.fits(conv.kernel_size, conv.stride, conv.padding)
        assert not blocks.routes_dgrad(conv, x)
        with pytest.raises(ValueError, match="kernel 3, padding 1, stride 1 or 2"):
            conv_dgrad.conv_data_grad(g, conv.weight, x.shape, conv.stride, conv.padding)
    return case


CASES = {
    **{f"plain_{f}": _plain_case(f) for f in FAMILIES},
    **{f"refused_k{k}_p{p}_s{s}": _refused_case(k, p, s)
       for k, p, s in ((5, 2, 1), (3, 0, 1), (3, 1, 3))},
    **{f"route_{f}": _function_case(f) for f in FAMILIES},
    **{f"conv_at_{s}": _choice_case(s)
       for s in ("transposed_eval", "transposed_frozen", "transposed_train", "conv_train",
                 "no_grad", "conv2d", "k5", "bfloat16", "cuda_only")},
    **{f"step_{f}": _step_case(f) for f in ("enerf", "mvsnerf")},
    **{f"frame_{f}": _frame_case(f) for f in ("enerf", "mvsnerf")},
    "roofline_counts": _counts_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_dgrad(case, monkeypatch):
    CASES[case](monkeypatch)
