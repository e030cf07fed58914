"""The paper's ``.pth`` checkpoints as the port's ``latest.pt`` (counterpart of
``scripts/convert_reference_ckpt.py`` and ``boostmvsnerfs_tpu/utils/
port_weights.py::load_torch_checkpoint``).

The port's modules carry the reference's parameter names
(``utils/port_weights.py``), so a reference ``state_dict`` needs no layout
change: each of the model's entries is taken under its own name. Where the
reference differs:

* its InPlaceABN blocks (the MVSNeRF feature and cost-regularisation nets)
  hold no ``num_batches_tracked``, which the port's batch norms have: a
  missing one is written as 0, as ``port_weights._state_dict`` writes it;
* its ``Renderer_attention`` (MVSNeRF ``net_type`` v1) ties
  ``pts_linears.1..D-1`` into one module, so its checkpoint holds the same
  tensor under each of those names: each of the port's separate layers
  takes a copy;
* entries the model does not have are left out, as JAX's ``port_enerf`` /
  ``port_mvsnerf`` leave them out, and listed.

The model is built from the flags of JAX's script (the family, the ENeRF
levels and view-direction aggregation, the MVSNeRF MLP depth); an MVSNeRF
head's kind is read from the checkpoint's names as the JAX-tree carrier reads
it (``port_weights._mvs_head_kind``: ``color_attention`` marks v1,
``ray_attention`` color_fusion; v0 and v2 share one layout). The converted
weights load into it with ``strict=True`` before anything is written, so a
missing or misshapen entry fails here, not at eval. The result is
``{"model": state_dict}`` as ``0.pt`` and ``latest.pt`` in the output
directory (``train/checkpoint.CheckpointManager``), which ``run_evaluate``
reads from ``cfg.trained_model_dir`` and the fine-tuning recipes from
``<workspace>/trained_model/pretrain/<cfg.pretrain>``.

Usage: ``python -m boostmvsnerfs_torch.convert_ckpt <pth> <out_dir>
[--family enerf|mvsnerf] [--levels 2] [--mlp-depth 6] [--no-viewdir-agg]``.
"""

from __future__ import annotations

import argparse

import torch
from torch import nn

FAMILIES = ("enerf", "mvsnerf")


def load_reference_checkpoint(path: str) -> dict:
    """The network ``state_dict`` of a reference ``.pth`` (``{"net":
    state_dict, ...}`` or a bare state dict), on the CPU."""
    # The reference's training checkpoints pickle its optimizer and
    # scheduler objects beside "net"; weights_only=True refuses to unpickle
    # them, so only a checkpoint from a trusted source may be read here.
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "net" in ckpt:
        ckpt = ckpt["net"]
    return {k: v.detach().cpu() for k, v in ckpt.items()}


def build_model(family: str, ref_names, levels: int = 2, mlp_depth: int = 6,
                viewdir_agg: bool = True) -> nn.Module:
    """The port's model of ``family`` on the CPU, from the converter's flags
    and, for MVSNeRF, the head kind of ``ref_names``. ENeRF and BoostENeRF
    share one layout; so do MVSNeRF and BoostMVSNeRF."""
    from boostmvsnerfs_torch.models.enerf import ENeRF, CascadeConfig
    from boostmvsnerfs_torch.models.mvsnerf import MVSNeRF, MVSNeRFConfig
    from boostmvsnerfs_torch.utils.port_weights import _mvs_head_kind

    if family == "enerf":
        if not 1 <= levels <= CascadeConfig.num:
            raise ValueError(f"--levels {levels}: the cascade has 1 to {CascadeConfig.num}")
        return ENeRF(CascadeConfig(num=levels, viewdir_agg=viewdir_agg), device="cpu")
    if family == "mvsnerf":
        kind = _mvs_head_kind(ref_names)  # 'mlp' (v0 / v2), 'attention' (v1), 'color_fusion'
        cfg = MVSNeRFConfig(mlp_depth=mlp_depth, net_type="v0" if kind == "mlp" else kind)
        return MVSNeRF(cfg, device="cpu")
    raise ValueError(f"family {family!r} not in {FAMILIES}")


def convert_state_dict(ref: dict, model: nn.Module) -> tuple[dict, list]:
    """``ref`` (a reference ``state_dict``) loaded into ``model`` with
    ``strict=True``: returns (the model's ``state_dict``, the names of
    ``ref`` left out). Raises when an entry is missing or misshapen."""
    own = model.state_dict()
    state = {}
    for k, v in own.items():
        if k in ref:
            state[k] = ref[k].to(v.dtype).clone()
        elif k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.int64)
    model.load_state_dict(state, strict=True)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, \
        sorted(set(ref) - set(own))


def convert(pth: str, out_dir: str, family: str = "enerf", levels: int = 2,
            mlp_depth: int = 6, viewdir_agg: bool = True) -> dict:
    """Convert ``pth`` into ``out_dir``; returns the checkpoint's path, the
    model's parameter count and the names left out."""
    from boostmvsnerfs_torch.train.checkpoint import CheckpointManager

    ref = load_reference_checkpoint(pth)
    model = build_model(family, ref, levels, mlp_depth, viewdir_agg)
    state, left_out = convert_state_dict(ref, model)
    mgr = CheckpointManager(out_dir)
    mgr.save({"model": state}, epoch=0, latest=True)
    return {"path": mgr.latest_path(), "left_out": left_out,
            "parameters": sum(p.numel() for p in model.parameters())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Convert a reference .pth into the port's latest.pt")
    ap.add_argument("pth")
    ap.add_argument("out_dir", help="e.g. cfg.trained_model_dir, or "
                    "<workspace>/trained_model/pretrain/enerf for fine-tuning")
    ap.add_argument("--family", choices=FAMILIES, default="enerf",
                    help="enerf (also enerf_ours) or mvsnerf (also mvsnerf_ours)")
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--mlp-depth", type=int, default=6)
    ap.add_argument("--no-viewdir-agg", action="store_true")
    args = ap.parse_args(argv)
    out = convert(args.pth, args.out_dir, args.family, args.levels, args.mlp_depth,
                  not args.no_viewdir_agg)
    print(f"ported {out['parameters']:,} parameters")
    print(f"left out {len(out['left_out'])} entries the model does not have"
          + (": " + ", ".join(out["left_out"]) if out["left_out"] else ""))
    print(f"saved to {out['path']}")
    return out
