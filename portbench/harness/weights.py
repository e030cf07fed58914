"""Seeded weights for a model, made on the card in two large calls.

Every floating entry of a state dict is drawn from one normal and one
uniform buffer of a ``torch.Generator`` on the device, then scaled as the
port's seeded random weights are: conv and linear weights N(0, 1/fan_in),
biases and BatchNorm means N(0, 0.1), BatchNorm scales and variances
U(0.5, 1.5); ``num_batches_tracked`` 0. The same seed gives the same
weights; the program and the reference are both given them.
"""

from __future__ import annotations

import math

import torch


def _kind(key: str, shape: tuple, keys: set) -> tuple[str, float]:
    stem = key.rsplit(".", 1)[0]
    if key.endswith("running_var") or (key.endswith(".weight") and f"{stem}.running_var" in keys):
        return "uniform", 0.0
    if key.endswith(("running_mean", ".bias")):
        return "normal", 0.1
    return "normal", 1.0 / math.sqrt(math.prod(shape[1:]) or 1)


def seeded_state_dict(template: dict, seed: int, device) -> dict:
    """Weights for every entry of ``template`` (a state dict), on ``device``."""
    keys = set(template)
    plan, sizes = [], {"normal": 0, "uniform": 0}
    for k, v in template.items():
        if not v.is_floating_point():
            plan.append((k, None, 0, 0.0))
            continue
        kind, scale = _kind(k, tuple(v.shape), keys)
        plan.append((k, kind, sizes[kind], scale))
        sizes[kind] += v.numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device) + 0.5
    out = {}
    for k, kind, at, scale in plan:
        v = template[k]
        if kind is None:
            out[k] = torch.zeros_like(v, device=device)
        elif kind == "normal":
            out[k] = (normal[at:at + v.numel()] * scale).reshape(v.shape)
        else:
            out[k] = uniform[at:at + v.numel()].reshape(v.shape)
    return out
