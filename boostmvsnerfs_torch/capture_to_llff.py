"""COLMAP sparse model -> LLFF ``poses_bounds.npy`` (counterpart of
``scripts/capture_to_llff.py``, the same file for the same model).

The reference custom-capture pipeline (BoostMVSNeRFs_DEMO.ipynb) runs COLMAP,
then LLFF's imgs2poses.py, to produce the ``poses_bounds.npy`` that the
Free / custom datasets read. This does the same conversion from a COLMAP
binary model with ``utils/colmap.py``.

Usage, from the repository root:

    python -m boostmvsnerfs_torch.capture_to_llff <scene_dir>
        # reads <scene_dir>/sparse/0/{cameras,images,points3D}.bin
    python -m boostmvsnerfs_torch.capture_to_llff <scene_dir> --model <model_dir>

Optionally seed a COLMAP database with known PINHOLE intrinsics first, so
that the mapper skips self-calibration (``utils/colmap_db.py``):

    python -m boostmvsnerfs_torch.capture_to_llff <scene_dir> --init-db FX FY CX CY W H
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from boostmvsnerfs_torch.utils.colmap import colmap_to_poses_bounds, read_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dir")
    ap.add_argument("--model", default=None,
                    help="COLMAP model dir (default <scene>/sparse/0)")
    ap.add_argument("--init-db", nargs=6, type=float, default=None,
                    metavar=("FX", "FY", "CX", "CY", "W", "H"),
                    help="create database.db with fixed PINHOLE intrinsics")
    args = ap.parse_args(argv)

    if args.init_db is not None:
        from boostmvsnerfs_torch.utils.colmap_db import ColmapDB

        fx, fy, cx, cy, w, h = args.init_db
        db_path = os.path.join(args.scene_dir, "database.db")
        names = sorted(os.path.basename(p)
                       for p in glob.glob(os.path.join(args.scene_dir, "images", "*")))
        with ColmapDB.create(db_path) as db:
            cam = db.add_camera("PINHOLE", int(w), int(h), [fx, fy, cx, cy], prior_focal=True)
            for name in names:
                db.add_image(name, cam)
        print(f"seeded {db_path} with {len(names)} images (PINHOLE)")
        if args.model is None and not os.path.isdir(os.path.join(args.scene_dir, "sparse", "0")):
            return None  # the database only; run COLMAP next, then this again

    model_dir = args.model or os.path.join(args.scene_dir, "sparse", "0")
    pb = colmap_to_poses_bounds(*read_model(model_dir))
    out = os.path.join(args.scene_dir, "poses_bounds.npy")
    np.save(out, pb)
    print(f"wrote {out}: {pb.shape[0]} poses, "
          f"bounds [{pb[:, -2].min():.3f}, {pb[:, -1].max():.3f}]")
    return out


if __name__ == "__main__":
    main()
