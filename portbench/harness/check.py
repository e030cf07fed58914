"""The check that decides ``correct``: what the program produced, held
against the plain reference of the configuration's family.

The reference (``portbench/reference/<family>.py``) is given the seeded
weights, and it reads its inputs from the scene's files itself
(``reference/plain/data.py``): cameras, depth range, source views, images.

Frames (``frame_readings``). For each frame that the seeded sample kept
(``drive.Reservoir``), the reference works out the coverage masks of every
view combination and replays the greedy search over them along the
program's picks: at each step, how much less of the frame the program's
pick newly covers than the step's best (where the program stopped, the
best's whole gain); the largest is ``pick_step_gap``, a share of the
frame's pixels. Where it is within ``TIE``, the program's picks are the
reference's greedy outcome and the reference renders the frame at them;
otherwise it renders at its own greedy picks, so that a wrong pick shows as
a wrong frame. The program's frame is judged against the reference's: the
colour's mean absolute error (``rgb_mae``), and the depth's mean absolute
error over its mean (``depth_rel_mae``). Also read, not compared: the
colour's largest error and its 99.9th percentile (``rgb_max``,
``rgb_p999``), and the smallest margin of a greedy step of the reference
(``min_pick_margin``: the winner's newly covered share over the next
best's). Each number is the largest over the sampled frames (``min_``: the
smallest).

Fine-tuning steps (``train_readings``). The reference follows the first
steps that set-up ran through the window's own step, from the same seeded
weights on the same targets and view counts (the recipe loader's draw),
and reads: the first step's loss (``first_loss_rel_gap``) and every step's
(``loss_rel_gap``), each leaf's first gradient as the optimizer took it
(``grad_leaf_gap``: the gap between the program's norm and the reference's
over the larger of the reference's norm of that leaf and of the median
leaf), each leaf's change over the steps (``update_leaf_gap``, by the same
measure) and the median leaf's change (``update_median_gap``). Leaves whose
reference gradient is under ``ROUNDOFF`` of the median leaf's move under
Adam by round-off alone and are left out of the change.

The cell's limits file (``portbench/limits/<cell>.json``) names the numbers
compared and their limits; the run is correct when every one lies within
its limit.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os

import numpy as np
import torch

from portbench.reference.plain.boost_enerf import greedy_steps, view_combinations

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a reference gradient under this share of the median leaf's: round-off under Adam
ROUNDOFF = 1e-3
# a greedy step whose pick newly covers within this share of the frame of the
# step's best is a tie: above the program's readings (0 on every seed), below
# the smallest margin of a greedy step measured (1.96e-6; PERF.md)
TIE = 1e-6


def limits_of(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def family_of(cfg: dict):
    """The reference module of the configuration's model family."""
    return importlib.import_module(
        f"portbench.reference.{cfg['network_module'].rsplit('.', 1)[-1]}")


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN convolutions and CUDA matmuls in TF32 inside the block when
    ``enabled``: the control's precision, one step below float32."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def pick_step_gap(masks: np.ndarray, picks, k: int) -> float:
    """The greedy search of ``k`` steps replayed along ``picks`` over
    coverage masks (n, H, W): the largest shortfall of a step's pick against
    the step's best newly covered share, or the best's whole gain where
    ``picks`` stopped (repeats pad a search that stopped)."""
    chosen = list(dict.fromkeys(int(i) for i in picks))
    free = np.ones(masks.shape[1:], np.float64)
    worst = 0.0
    for j in range(k):
        gains = {i: float((masks[i] * free).mean()) for i in range(len(masks))
                 if i not in chosen[:j]}
        best = max(gains.values(), default=0.0)
        if j >= len(chosen):
            return max(worst, best)
        worst = max(worst, best - gains[chosen[j]])
        free = free * (1.0 - masks[chosen[j]])
    return worst


def reference_frame(flow, fam, ref_model, key: int, picks=None) -> dict:
    """The reference's masks of frame ``key`` (its inputs read from the
    scene's files, ``flow.reference_batch``), its own greedy picks (padded
    with repeats to k, as the port pads them), their smallest margin, how
    far ``picks`` fall from a greedy outcome (``pick_step_gap``), and its
    frame at ``picks`` where that is within ``TIE``, else at its own
    picks."""
    np_batch = flow.reference_batch(key)
    combos = view_combinations(np_batch["all_src_inps"].shape[1],
                               int(flow.tree["enerf"]["cost_volume_input_views"]))
    np_batch["combos"] = combos
    masks = fam.coverage(ref_model, np_batch, combos)[:, 0]
    own, margins = greedy_steps(masks, flow.k)
    own = (own or [0]) + (own or [0])[-1:] * (flow.k - max(len(own), 1))
    gap = 0.0 if picks is None else pick_step_gap(masks, picks, flow.k)
    at = own if picks is None or gap > TIE else list(picks)
    np_batch["k_best"] = np.asarray(at, np.int32)[None]
    out = fam.frame(ref_model, np_batch)
    return {"picks": own, "margin": min(margins, default=0.0), "pick_step_gap": gap,
            "outputs": {k: out[k] for k in flow.compared}}


def frame_numbers(got: dict, want: dict, compared) -> dict:
    """The numbers of one frame: ``got`` the judged frame's outputs,
    ``want`` the reference's (``reference_frame``)."""
    rgb_key, depth_key = compared
    e = (got[rgb_key].float() - want["outputs"][rgb_key].float()).abs().flatten()
    d = want["outputs"][depth_key].float()
    de = (got[depth_key].float() - d).abs()
    return {"rgb_mae": float(e.mean()), "rgb_max": float(e.max()),
            "rgb_p999": float(torch.quantile(e[:: max(1, e.numel() // 2**24)], 0.999)),
            "depth_rel_mae": float(de.mean() / d.abs().mean()),
            "pick_step_gap": want["pick_step_gap"], "min_pick_margin": want["margin"]}


def worst(numbers: list) -> dict:
    """The largest of each number over the frames, the smallest of a
    ``min_`` one (NaN wins)."""
    out = {}
    for n in numbers:
        for k, v in n.items():
            pick = min if k.startswith("min_") else max
            out[k] = v if math.isnan(v) or k not in out else pick(out[k], v)
    return out


def frame_readings(flow, samples, control: bool = False) -> dict:
    """The numbers over ``samples``: the program's frames and picks
    against the reference's; with ``control``, the reference computed with
    TF32 (its own picks and frame) in the program's place."""
    fam = family_of(flow.tree)
    ref_model = fam.build(flow.tree, flow.weights, flow.ctx.device)
    numbers = []
    for s in samples:
        if control:
            with tf32(True):
                low = reference_frame(flow, fam, ref_model, s.key)
            got, picks = low["outputs"], low["picks"]
        else:
            got, picks = s.outputs, s.picks
        want = reference_frame(flow, fam, ref_model, s.key, picks)
        numbers.append(frame_numbers(got, want, flow.compared))
    del ref_model
    if flow.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return worst(numbers)


def _leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of the leaf and of the median leaf."""
    names = [n for n in want if keep is None or n in keep]
    ref = {n: float(want[n]) for n in names}
    median = float(np.median(list(ref.values())))
    return max(abs(float(got.get(n, 0.0)) - ref[n]) / max(ref[n], median, 1e-30) for n in names)


def _median_gap(got: dict, want: dict, keep) -> float:
    """The gap between the median leaf's norm on each side, over the
    reference's."""
    g = float(np.median([float(got.get(n, 0.0)) for n in keep]))
    w = float(np.median([float(want[n]) for n in keep]))
    return abs(g - w) / max(w, 1e-30)


def train_readings(flow, fault: str | None = None) -> dict:
    """The fine-tuning numbers (module docstring): the program's first
    steps, or with ``fault`` the reference with it planted (``control``:
    TF32; ``half_batch``, ``altered``: ``reference.train_steps``' faults)
    in the program's place, against the reference."""
    fam = family_of(flow.tree)
    n = len(flow.losses)
    blocks = int(flow.ctx.traffic["reference_ray_blocks"])
    batches = [flow.reference_batch(t) for t in range(n)]
    p0 = flow.weights
    ref = fam.train_steps(flow.tree, p0, batches, flow.ctx.device, blocks)
    if fault is None:
        got = {"losses": flow.losses, "first_grads": flow.first_grads, "params": flow.after}
    else:
        with tf32(fault == "control"):
            got = fam.train_steps(flow.tree, p0, batches, flow.ctx.device, blocks,
                                  None if fault == "control" else fault)

    def norms(d):
        return {k: float(v.float().norm()) for k, v in d.items()}

    def change(params):
        return {k: float((v.float() - p0[k].float()).norm()) for k, v in params.items()}

    g_ref = norms(ref["first_grads"])
    median = float(np.median(list(g_ref.values())))
    moved = {k for k, v in g_ref.items() if v >= ROUNDOFF * median}
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    out = {
        "first_loss_rel_gap": loss_gaps[0],
        "loss_rel_gap": max(loss_gaps),
        "grad_leaf_gap": _leaf_gap(norms(got["first_grads"]), g_ref),
        "update_leaf_gap": _leaf_gap(change(got["params"]), change(ref["params"]), moved),
        "update_median_gap": _median_gap(change(got["params"]), change(ref["params"]), moved),
        "leaves_left_out": float(len(g_ref) - len(moved)),
    }
    if flow.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}) for the numbers ``limits`` names."""
    shown = {k: [values.get(k, float("nan")), lim] for k, lim in limits.items()}
    ok = all(not math.isnan(v) and v <= lim for v, lim in shown.values())
    return ok, shown
