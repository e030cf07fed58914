"""Learning-rate schedules and optimizers (counterpart of
``boostmvsnerfs_tpu/train/schedule.py``, which builds them with optax).

Mirrors the reference recipes:
* Adam / AdamW with per-config lr, eps and weight decay (reference
  lib/train/optimizer.py); RAdam (threshold 5, SGD below it); SGD with
  momentum 0.9;
* exponential decay ``lr * gamma^(epoch / decay_epochs)`` stepped per epoch
  (reference lib/utils/optimizer/lr_scheduler.py:68-75), multi-step decay,
  and warmup into multi-step decay;
* gradient value clipping at 40 before the optimizer (reference
  lib/train/trainers/trainer.py:61 ``clip_grad_value_(40)``; JAX
  ``optax.chain(optax.clip(40.0), ...)``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

GRAD_CLIP = 40.0


def make_lr_schedule(train_cfg: dict, ep_iter: int) -> Callable[[int], float]:
    """The learning rate at each *step*; epoch = step // ep_iter (the
    reference steps its scheduler per epoch)."""
    base = float(train_cfg["lr"])
    sched = train_cfg.get("scheduler", {"type": "exponential", "gamma": 0.5,
                                        "decay_epochs": 50})
    stype = sched.get("type", "exponential")
    gamma = float(sched.get("gamma", 0.5))
    ep_iter = max(ep_iter, 1)
    milestones = list(sched.get("milestones", []))
    if stype == "exponential":
        decay_epochs = float(sched.get("decay_epochs", 50))
        return lambda step: base * gamma ** ((step // ep_iter) / decay_epochs)
    if stype == "multi_step":
        return lambda step: base * gamma ** sum(step // ep_iter >= m for m in milestones)
    if stype == "warmup_multi_step":
        # reference lib/utils/optimizer/lr_scheduler.py:7-50 WarmupMultiStepLR:
        # linear (or constant) warmup over warmup_iters epochs into
        # multi-step decay, the decay applying from each milestone epoch on
        warmup_factor = float(sched.get("warmup_factor", 1.0 / 3))
        warmup_iters = int(sched.get("warmup_iters", 5))
        warmup_method = sched.get("warmup_method", "linear")
        if warmup_method not in ("constant", "linear"):
            raise ValueError(f"unknown warmup_method: {warmup_method}")

        def schedule(step):
            epoch = step // ep_iter
            if warmup_method == "constant":
                wf = warmup_factor if epoch < warmup_iters else 1.0
            else:
                alpha = min(epoch / max(warmup_iters, 1), 1.0)
                wf = warmup_factor * (1.0 - alpha) + alpha
            return base * wf * gamma ** sum(epoch >= m for m in milestones)

        return schedule
    raise ValueError(f"unknown scheduler type: {stype}")


class RAdam(torch.optim.Optimizer):
    """Rectified Adam as optax's ``radam`` computes it (``scale_by_radam``):
    with rho_t = rho_inf - 2 t b2^t / (1 - b2^t), the update is the
    bias-corrected first moment alone while rho_t < ``threshold``, and
    r_t * m_hat / (sqrt(v_hat) + eps) from there on, with optax's float32
    scalars. ``torch.optim.RAdam`` adds eps to sqrt(v) before the bias
    correction, switches at rho_t > 5 and takes rho_t in float64, so it is
    not used. ``weight_decay`` adds wd * param to the
    gradient first (optax ``add_decayed_weights`` ahead of ``radam``)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, threshold=threshold,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                # float32 scalars, as optax evaluates them: rho_t is a
                # difference of two numbers near 2000, so its rounding
                # (~0.03 early on) moves r_t by ~1% near the threshold
                f32 = np.float32
                b2t = f32(b2) ** f32(t)
                rho = f32(rho_inf) - f32(2 * t) * b2t / (f32(1.0) - b2t)
                update = mu / float(f32(1.0) - f32(b1) ** f32(t))
                if rho >= group["threshold"]:
                    r = np.sqrt((rho - f32(4.0)) * (rho - f32(2.0)) * f32(rho_inf)
                                / ((f32(rho_inf) - f32(4.0)) * (f32(rho_inf) - f32(2.0)) * rho))
                    update = float(r) * update / ((nu / float(f32(1.0) - b2t)).sqrt()
                                                  + group["eps"])
                p.sub_(group["lr"] * update)
        return loss


def make_optimizer(train_cfg: dict, ep_iter: int) -> Callable:
    """A factory ``params -> (optimizer, lr scheduler)`` for the config's
    optimizer and schedule. The scheduler scales the base lr per step; call
    ``apply_update`` after ``backward()`` (clip, step, schedule)."""
    schedule = make_lr_schedule(train_cfg, ep_iter)
    base = float(train_cfg["lr"])
    opt_name = train_cfg.get("optim", "adam")
    eps = float(train_cfg.get("eps", 1e-8))
    wd = float(train_cfg.get("weight_decay", 0.0))
    if opt_name not in ("adam", "radam", "sgd"):
        raise ValueError(f"unknown optimizer: {opt_name}")

    def build(params):
        params = list(params)
        if opt_name == "adam":
            opt = (torch.optim.AdamW(params, lr=base, eps=eps, weight_decay=wd) if wd > 0
                   else torch.optim.Adam(params, lr=base, eps=eps))
        elif opt_name == "radam":
            opt = RAdam(params, lr=base, eps=eps, threshold=5.0, weight_decay=wd)
        else:
            opt = torch.optim.SGD(params, lr=base, momentum=0.9)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: schedule(step) / base if base else 0.0)

    return build


def apply_update(optimizer: torch.optim.Optimizer, scheduler) -> None:
    """Clip every gradient to [-40, 40], take the optimizer step and advance
    the schedule by one step."""
    for group in optimizer.param_groups:
        torch.nn.utils.clip_grad_value_(group["params"], GRAD_CLIP)
    optimizer.step()
    scheduler.step()
