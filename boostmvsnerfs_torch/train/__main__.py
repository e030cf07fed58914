"""Training entry over a YAML config (counterpart of the root ``train.py``).

Usage, from the repository root:

    python -m boostmvsnerfs_torch.train --cfg_file configs/... \\
        [--device cuda] [--ray_blocks N] [key value ...]

e.g. ``--cfg_file configs/exps/finetune/enerf_ours/free/base.yaml workspace
<dir> scene <name>``. Runs ``runner.run_train`` on CUDA unless ``--device
cpu`` is given, under the package's numerics (``set_numerics``).
``--ray_blocks N`` (N > 1) renders each level in ray blocks recomputed in
the backward, for batches whose unblocked step (JAX's, the default)
outgrows the card.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ray_blocks", type=int, default=0)
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "multi-GPU training is not in the port yet (ROADMAP queue 1 item 6)")

    from boostmvsnerfs_torch import set_numerics
    from boostmvsnerfs_torch.config import make_cfg
    from boostmvsnerfs_torch.runner import run_train

    set_numerics()
    return run_train(make_cfg(args.cfg_file, args.opts), device=args.device,
                     ray_blocks=args.ray_blocks)


if __name__ == "__main__":
    main()
