"""``python -m boostmvsnerfs_torch.convert_ckpt <pth> <out_dir> [--family
enerf|mvsnerf] [--levels 2] [--mlp-depth 6] [--no-viewdir-agg]``: a reference
``.pth`` as the port's ``latest.pt`` (``utils/convert_ckpt.py``)."""

from boostmvsnerfs_torch.utils.convert_ckpt import main

if __name__ == "__main__":
    main()
