"""The weight-gradient route of ``models/blocks.conv_at`` on the CPU.

``KernelConv`` (the convolution's forward, PyTorch's input gradient, the
weight gradient of ``ops/cuda/conv_wgrad``, here its plain version) against
autograd through ``F.conv2d`` / ``F.conv3d`` / ``F.conv_transpose3d`` for
every family the networks use, including a permuted, channels-last-strided
input as the cost volume is; ``conv_at``'s choice of route; and a BoostENeRF
blocked training step whose gradients do not move when the route is taken.
The route runs on CUDA only, so the cases that take it here add the CPU to
``blocks.WGRAD_DEVICES``. The CUDA kernel itself is held against the plain
version on the card (``chip_smoke.py``, phase ``kernels_train``).

Tolerances: float64 for the single convolutions, where the plain version's
sum order is the only difference (rtol 1e-10); the training step in float32
against the step without the route, on one thread, rtol 1e-5 with an
absolute floor of 1e-5 of each gradient's largest magnitude (gradients that
cancel to ~0 keep float32's rounding of their terms; the largest reading is
8.6e-6, a bias of the FPN).
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from boostmvsnerfs_torch.models import blocks
from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
from boostmvsnerfs_torch.ops.cuda.conv_wgrad import conv_wgrad_plain, plan
from boostmvsnerfs_torch.parallel.train import make_blocked_loss
from boostmvsnerfs_torch.utils.port_weights import random_state_dict
from boostmvsnerfs_torch.utils.roofline import conv_wgrad_counts
from boostmvsnerfs_torch.utils.synthetic import make_scene_batch


def _route_on_cpu(monkeypatch):
    monkeypatch.setattr(blocks, "WGRAD_DEVICES", ("cuda", "cpu"))


def _function_case(conv: nn.Module, x_shape, channels_last=False):
    """KernelConv's input, weight and bias gradients against autograd through
    the module's own call, float64 (module docstring)."""
    def case(monkeypatch):
        _route_on_cpu(monkeypatch)
        torch.manual_seed(0)
        m = conv.double()
        x = torch.randn(x_shape, dtype=torch.float64)
        if channels_last:  # a permuted view, as the cost volume reaches conv0
            x = x.movedim(1, -1).contiguous().movedim(-1, 1)
        x.requires_grad_()
        y_ref = m(x)
        g = torch.randn_like(y_ref)
        want = torch.autograd.grad(y_ref, [x, *m.parameters()], g)
        y = blocks.KernelConv.apply(x, m.weight, m.bias, m, blocks.routes_dgrad(m, x))
        got = torch.autograd.grad(y, [x, *m.parameters()], g)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    return case


def _choice_case(setting: str):
    """``conv_at`` takes the route only with grad on, a weight being trained
    and float32; otherwise it calls the module (or its dtype path) as
    before."""
    def case(monkeypatch):
        _route_on_cpu(monkeypatch)
        calls = []
        real = blocks.KernelConv.apply
        monkeypatch.setattr(blocks.KernelConv, "apply",
                            lambda *a: calls.append(1) or real(*a))
        conv = nn.Conv3d(4, 8, 3, padding=1, bias=False)
        x = torch.randn(1, 4, 3, 5, 6)
        dtype = None
        if setting == "no_grad":
            ctx = torch.no_grad()
        else:
            ctx = torch.enable_grad()
        if setting == "frozen":
            conv.weight.requires_grad_(False)
        if setting == "bfloat16":
            dtype = torch.bfloat16
        if setting == "float32":
            dtype = torch.float32
        with ctx:
            y = blocks.conv_at(conv, x, dtype)
        routed = setting in ("grad", "float32")
        assert calls == ([1] if routed else [])
        want = blocks._conv(conv, x.to(dtype or x.dtype), conv.weight.to(dtype or x.dtype), None)
        torch.testing.assert_close(y, want, rtol=0, atol=0)
        monkeypatch.setattr(blocks, "WGRAD_DEVICES", ("cuda",))
        assert not blocks.routes_wgrad(conv, x, dtype)  # CPU tensors never route
    return case


def _boost_step_grads(route: bool, monkeypatch) -> dict:
    monkeypatch.setattr(blocks, "WGRAD_DEVICES", ("cuda", "cpu") if route else ("cuda",))
    model = BoostENeRF(CascadeConfig(k_best=2, volume_planes=(16, 8), num_samples=(8, 2)),
                       device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in random_state_dict(model, 0).items()})
    model.train()
    batch = to_tensors(make_scene_batch(B=1, n_views=4, H=64, W=96, boost=True, k_best=2,
                                        seed=0, rig="forward", with_targets=True), "cpu")
    calls = []
    real = blocks.KernelConv.apply
    monkeypatch.setattr(blocks.KernelConv, "apply", lambda *a: calls.append(1) or real(*a))
    loss, _ = make_blocked_loss(model, 4)(batch)
    loss.backward()
    assert bool(calls) == route
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _boost_step_case(monkeypatch):
    """A BoostENeRF blocked training step (K=2 of C(4,3), 64x96, 4 ray
    blocks) gives the same gradients with the route as without it. Both run
    on one thread: with several, the CPU port's own reductions differ from
    run to run by up to 1.2e-5 of a leaf's largest gradient."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _boost_step_grads(False, monkeypatch)
        got = _boost_step_grads(True, monkeypatch)
    finally:
        torch.set_num_threads(threads)
    assert got.keys() == want.keys()
    for n in want:
        floor = 1e-5 * float(want[n].abs().max())
        torch.testing.assert_close(got[n], want[n], rtol=1e-5, atol=floor, msg=n)


def _plan_case(monkeypatch):
    """The kernel's launch shape: channels padded to the thread tile, the
    rows cut into slices that cover them once."""
    p = plan(M=1, C=3, taps=27, rows=1000, sms=132)
    assert (p["tm"], p["cg"], p["cx"]) == (1, 1, 4)
    p = plan(M=6, C=8, taps=27, rows=1000, sms=132, row_taps=3)
    assert (p["tm"], p["cg"], p["cx"]) == (4, 8, 8)
    assert p["slices"] * p["rows_per_slice"] >= 1000 > (p["slices"] - 1) * p["rows_per_slice"]
    p = plan(M=64, C=32, taps=27, rows=10, sms=132)
    assert (p["tm"], p["cg"], p["cx"], p["slices"], p["rows_per_slice"]) == (16, 64, 32, 10, 1)
    # the plain version against autograd in both roles
    x, g = torch.randn(2, 3, 9, 10, dtype=torch.float64), torch.randn(2, 5, 5, 5,
                                                                   dtype=torch.float64)
    w = torch.zeros(5, 3, 5, 5, dtype=torch.float64, requires_grad=True)
    want = torch.autograd.grad(F.conv2d(x, w, stride=2, padding=2), w, g)[0]
    torch.testing.assert_close(conv_wgrad_plain(x, g, w.shape, (2, 2), (2, 2)), want)
    wt = torch.zeros(5, 3, 3, 3, 3, dtype=torch.float64, requires_grad=True)
    xt = torch.randn(2, 5, 3, 4, 5, dtype=torch.float64)
    y = F.conv_transpose3d(xt, wt, stride=2, padding=1, output_padding=1)
    gt = torch.randn_like(y)
    want = torch.autograd.grad(y, wt, gt)[0]
    got = conv_wgrad_plain(xt, gt, wt.shape, (2, 2, 2), (1, 1, 1), transposed=True)
    torch.testing.assert_close(got, want)


def _counts_case(monkeypatch):
    """The weight gradient's work (``utils/roofline.conv_wgrad_counts``): one
    multiply-add per live (position, tap) pair, taps on the padding left
    out, and the transposed convolution counted as its adjoint."""
    nbytes, ops = conv_wgrad_counts((2, 3, 3, 3), (2, 5, 3, 3), (5, 3, 3, 3), (1, 1), (1, 1))
    assert ops == 2 * 2 * 5 * 3 * 7 * 7  # 7 live pairs an axis of 3 with k3 p1
    assert nbytes == 4 * (54 + 90 + 135)
    want = conv_wgrad_counts((2, 4, 6, 8, 10), (2, 8, 3, 4, 5), (8, 4, 3, 3, 3), (2,) * 3,
                             (1,) * 3)
    assert conv_wgrad_counts((2, 8, 3, 4, 5), (2, 4, 6, 8, 10), (8, 4, 3, 3, 3), (2,) * 3,
                             (1,) * 3, transposed=True) == want


CASES = {
    **{f"conv2d_k{k}_s{s}{'_bias' if b else ''}":
       _function_case(nn.Conv2d(5, 7, k, stride=s, padding=k // 2, bias=b), (2, 5, 11, 13))
       for k in (1, 3, 5) for s in (1, 2) for b in (False, True)},
    "conv2d_k3_rgb_channels_last": _function_case(nn.Conv2d(3, 8, 3, padding=1, bias=False),
                                                  (2, 3, 12, 10), channels_last=True),
    **{f"conv3d_k3_s{s}": _function_case(nn.Conv3d(4, 6, 3, stride=s, padding=1, bias=False),
                                         (2, 4, 5, 7, 9)) for s in (1, 2)},
    "conv3d_k3_channels_last": _function_case(nn.Conv3d(16, 8, 3, padding=1, bias=False),
                                              (2, 16, 4, 6, 5), channels_last=True),
    "conv3d_k3_bias": _function_case(nn.Conv3d(8, 1, 3, padding=1), (1, 8, 4, 5, 6)),
    "deconv3d_k3_s2": _function_case(
        nn.ConvTranspose3d(8, 4, 3, stride=2, padding=1, output_padding=1, bias=False),
        (2, 8, 2, 3, 4)),
    **{f"conv_at_{s}": _choice_case(s)
       for s in ("grad", "float32", "no_grad", "frozen", "bfloat16")},
    "boost_enerf_blocked_step": _boost_step_case,
    "plan_and_plain": _plan_case,
    "roofline_counts": _counts_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_wgrad(case, monkeypatch):
    CASES[case](monkeypatch)
