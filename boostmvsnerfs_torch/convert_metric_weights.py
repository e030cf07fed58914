"""``python -m boostmvsnerfs_torch.convert_metric_weights --vgg PTH [--lpips
PTH] --out-dir DIR``: the pretrained metric and loss weights, from local
files, as the ``.npz`` files both packages read.

``--vgg`` takes torchvision's VGG16 weights (``vgg16-397923af.pth``, or a
saved ``features`` state dict) and writes ``DIR/vgg16_features.npz``;
``--lpips`` takes the lpips package's ``weights/v0.1/vgg.pth`` and writes
``DIR/lpips_vgg_lin.npz``. Neither package is imported and nothing is
downloaded: the files are the user's to supply. Then point the config at
them::

    vgg_weights: DIR/vgg16_features.npz        # the perceptual loss
    lpips_weights:
      vgg: DIR/vgg16_features.npz              # LPIPS's backbone
      lin: DIR/lpips_vgg_lin.npz               # LPIPS's heads
"""

from __future__ import annotations

import argparse
import os

from boostmvsnerfs_torch.eval.lpips import convert_lpips_weights
from boostmvsnerfs_torch.eval.vgg import convert_torchvision_weights

VGG_NPZ = "vgg16_features.npz"
LPIPS_NPZ = "lpips_vgg_lin.npz"


def main(argv=None) -> dict:
    """Convert the given files; returns {kind: written path}."""
    ap = argparse.ArgumentParser(prog="python -m boostmvsnerfs_torch.convert_metric_weights")
    ap.add_argument("--vgg", required=True, help="torchvision's VGG16 state dict (.pth)")
    ap.add_argument("--lpips", help="the lpips package's VGG heads (vgg.pth)")
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    written = {"vgg": os.path.join(args.out_dir, VGG_NPZ)}
    convert_torchvision_weights(args.vgg, written["vgg"])
    if args.lpips:
        written["lpips"] = os.path.join(args.out_dir, LPIPS_NPZ)
        convert_lpips_weights(args.lpips, written["lpips"])
    for path in written.values():
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
