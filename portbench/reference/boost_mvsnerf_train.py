"""The plain reference of BoostMVSNeRF's per-scene fine-tuning step
(``configs/exps/finetune/mvsnerf_ours/free/base.yaml``): a batch of targets,
each with its random rays, rendered in training mode; the colour loss, its
gradients, the clip and Adam.

The model is ``plain/boost_mvsnerf.py``'s, given the benchmark's weights
and put in training mode: BatchNorm takes batch statistics, the plane-sweep
warp's gathers, the trilinear lookup of the encoding volume and the ``v0``
MLP run in float32 under autograd, and the colour lookup takes kernel #3's
plain version in float32 without gradient. The step runs in the caller's
precision: the flow holds it at float32 with TF32 off, and the control at
TF32, one step below (``check.tf32``).

Departures from the published MVSNeRF and BoostMVSNeRFs training, as the
recipe runs on this code:

* the volume's depth planes are the samples a ray (8), as the port's and
  the JAX package's MVSNeRF take both from ``cas_config.num_samples``; the
  tree's ``volume_planes`` (128) is not read;
* the loss is the colour MSE on the drawn rays at ``loss_weight[0]``, with
  no perceptual term (the recipe trains on random rays, not whole images);
* a batch without ``k_best`` takes every pick as its first combination: the
  recipe's view selection runs on the train split's 3-view samples, whose
  table holds one combination (``boost_enerf.train_batch``), so a target's
  K volumes are that combination K times;
* the learning rate stays at its base over the checked steps: the recipe's
  exponential schedule steps once an epoch of 1,000 steps;
* the weights are seeded, not the pretrained MVSNeRF checkpoint, and the
  scene is the benchmark's synthetic one.
"""

from __future__ import annotations

import torch

from portbench.reference.boost_enerf import BETAS, GRAD_CLIP, train_batch
from portbench.reference.plain.boost_mvsnerf import BoostMVSNeRF
from portbench.reference.plain.enerf import to_tensors
from portbench.reference.plain.mvsnerf import MVSNeRFConfig

__all__ = ["build", "loss", "train_steps"]

FAULTS = ("half_batch", "altered")


def build(cfg: dict, state_dict: dict, device) -> BoostMVSNeRF:
    """The reference model of ``cfg`` (the recipe's tree) on ``device``,
    holding ``state_dict``, in training mode."""
    model = BoostMVSNeRF(MVSNeRFConfig.from_cfg(cfg), device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.train()


def loss(model: BoostMVSNeRF, cfg: dict, batch: dict, fault: str | None = None):
    """The recipe's loss of a batch of tensors: the colour MSE of the
    rendered rays against their targets, at the level's weight. ``fault``
    plants one for the check's readings: ``half_batch`` takes the loss over
    the first half of the targets, ``altered`` renders every colour 2%
    darker."""
    cas = cfg["enerf"]["cas_config"]
    if int(cas["num"]) != 1 or any(cas["train_img"]):
        raise ValueError("the MVSNeRF recipe renders one level of random rays")
    rgb, tar = model.render(batch)["rgb_level0"], batch["rgb_0"]
    if fault == "altered":
        rgb = rgb * 0.98
    if fault == "half_batch":
        n = rgb.shape[0] // 2
        rgb, tar = rgb[:n], tar[:n]
    return float(cas["loss_weight"][0]) * torch.mean((rgb - tar) ** 2)


def train_steps(cfg: dict, state_dict: dict, batches: list, device,
                fault: str | None = None) -> dict:
    """Fine-tuning steps of ``cfg`` from ``state_dict`` over ``batches``
    (numpy, one step each: the targets' views, cameras, drawn rays
    ``ray_idx_0`` and their colours ``rgb_0``): the loss, the backward,
    every gradient clipped to [-40, 40], Adam (the recipe's lr and eps,
    betas (0.9, 0.999)). Returns each step's loss, each parameter's first
    gradient as Adam takes it and its values after the last step."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    lr, eps = float(cfg["train"]["lr"]), float(cfg["train"]["eps"])
    losses, first = [], {}
    model = build(cfg, state_dict, device)
    params = dict(model.named_parameters())
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    for t, np_batch in enumerate(batches, 1):
        if "k_best" not in np_batch:
            np_batch = train_batch(cfg, np_batch)
        batch = to_tensors({k: x for k, x in np_batch.items() if k != "meta"}, model.device)
        model.zero_grad(set_to_none=True)
        value = loss(model, cfg, batch, fault)
        value.backward()
        losses.append(float(value.detach()))
        with torch.no_grad():
            for n, p in params.items():
                if p.grad is None:
                    continue
                g = p.grad.clamp(-GRAD_CLIP, GRAD_CLIP)
                if t == 1:
                    first[n] = g.clone()
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v[n] / (1 - BETAS[1] ** t)).sqrt() + eps
                p.sub_(lr / (1 - BETAS[0] ** t) * m[n] / denom)
    return {"losses": losses, "first_grads": first,
            "params": {n: p.detach().clone() for n, p in params.items()}}
