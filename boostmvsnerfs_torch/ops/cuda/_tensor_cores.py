"""What the tensor-core kernels (renderer MLP, ENeRF head) share on the host.

The Pallas kernels run their dense layers with bf16 operands and float32
sums (``mlp.py`` ``compute_dtype``, ``enerf_head.py`` at the TPU's default
precision). ``dense`` is that contract in plain PyTorch, and
``padded_rows`` lays a layer's weights out as the CUDA kernels read them;
``packed`` fills a wrapper's weight buffers from the current parameters.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


def check_compute_dtype(name: str, compute_dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{name}: compute_dtype must be torch.bfloat16 or torch.float32, "
                        f"got {compute_dtype}")


def dense(x: torch.Tensor, w: torch.Tensor, b=None, compute_dtype=torch.float32) -> torch.Tensor:
    """``F.linear`` with both operands rounded to ``compute_dtype`` and the
    products summed in float32, as JAX's ``dense`` with
    ``preferred_element_type=float32``: a bf16 product is exact in float32,
    so with TF32 off only the order of the sums differs from the kernels."""
    if compute_dtype != torch.float32:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
    return F.linear(x, w, b)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """The values rounded to bf16, kept in float32."""
    return t.to(torch.bfloat16).float()


def padded_rows(w: torch.Tensor, n_rows: int, k_pad: int, cols) -> torch.Tensor:
    """A layer's (out, in) weights as ``n_rows`` rows of ``k_pad + 8``
    elements, flat: the input columns [a, b) of each ``((a, b), at)`` of
    ``cols`` from column ``at`` on, zeros elsewhere. ``k_pad`` is a multiple
    of 16 (the k16 steps of ``mma.sync``), and the 8 more elements start
    each shared-memory row 4 banks after the one above, so the kernels'
    ``ldmatrix`` reads hit distinct banks."""
    out = w.new_zeros(n_rows, k_pad + 8)
    for (a, b), at in cols:
        out[:w.shape[0], at:at + b - a] = w[:, a:b]
    return out.reshape(-1)


# (layout, device, layer names, shapes) -> the index buffers of its plan
_plans: dict = {}


def packed(params: dict, layout) -> tuple[torch.Tensor, ...]:
    """The float32 buffers ``layout(params, round_bf16)``, gathered from the
    parameters' current values. ``layout`` places the weights by steps that
    depend on the shapes alone (slices, transposes, zero pads,
    concatenations) and rounds to bf16 only through the function it is
    given. Run once on the elements' indices, it yields the plan: which
    parameter element, rounded or not, each buffer element holds. A call
    then takes a few launches where the layout takes tens, and holds the
    values of this call, however a parameter changed since the last one
    (in place, through ``.data``, on another device)."""
    tensors = [t for pair in params.values() for t in pair]
    dev = tensors[0].device
    key = (layout, dev, tuple(params), tuple(tuple(t.shape) for t in tensors))
    plan = _plans.get(key)
    if plan is None:
        # source index 0 holds a zero, 1..n-1 the elements of ``tensors`` in
        # order, n..2n-1 the same rounded to bf16 (the zero pads stay zero)
        n = 1 + sum(t.numel() for t in tensors)
        starts = itertools.accumulate((t.numel() for t in tensors), initial=1)
        ids = iter([torch.arange(s, s + t.numel(), dtype=torch.float64).reshape(t.shape)
                    for s, t in zip(starts, tensors)])
        plan = layout({name: tuple(next(ids) for _ in pair) for name, pair in params.items()},
                      lambda t: t + n)
        plan = _plans[key] = tuple(buf.long().to(dev) for buf in plan)
    flat = torch.cat([tensors[0].new_zeros(1), *(t.reshape(-1) for t in tensors)]).float()
    src = torch.cat([flat, round_bf16(flat)])
    return tuple(src[i] for i in plan)
