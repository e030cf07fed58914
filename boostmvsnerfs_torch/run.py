"""Type-dispatched runs over a YAML config (counterpart of the root
``run.py``).

Usage, from the repository root:

    python -m boostmvsnerfs_torch.run \\
        --type {dataset,network,preprocess,evaluate,visualize,path,gui} \\
        --cfg_file configs/... [--device cuda] [key value ...]

e.g. ``--type evaluate --cfg_file configs/exps/evaluate/enerf_ours/free_eval.yaml
workspace <dir> scene <name>``; ``--type path`` renders ``render_num``
(default 30) frames of a ``path_type`` (``interpolate`` or ``spiral``)
camera path; ``--type gui`` serves the browser viewer at
``http://127.0.0.1:8008/`` (``gui_host``, ``gui_port``). Runs on CUDA unless
``--device cpu`` is given, under the
package's numerics (``set_numerics``). Each run returns its result to
``main``'s caller.
"""

from __future__ import annotations

import argparse
import os
import time


def run_dataset(cfg, device):
    """Loader smoke run (reference run.py:5-12): builds every test batch."""
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader

    n = sum(1 for _ in Loader(make_dataset(cfg, "test"), batch_size=1))
    print(f"{n} test batches")


def run_network(cfg, device):
    """Forward-latency smoke run (reference run.py:14-37): up to 21 frames,
    the mean over those after the first."""
    import numpy as np
    import torch

    from boostmvsnerfs_torch import resolve_device, runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader

    device = resolve_device(device)
    model = runner.make_network(cfg, device)
    runner._init_or_load(cfg, model)
    boost = runner.requires_view_selection(cfg)
    vs = runner.load_view_selection(cfg) if boost else None
    times = []
    for i, np_batch in enumerate(Loader(make_dataset(cfg, "test"), batch_size=1)):
        if boost:
            np_batch = runner.attach_boost_inputs(np_batch, vs, cfg)
        batch = runner._device_batch(np_batch, device)
        t0 = time.perf_counter()
        model(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        if i >= 20:
            break
    print(f"network latency: {np.mean(times[1:]) * 1000:.1f} ms "
          f"(fps {1.0 / np.mean(times[1:]):.2f})")


def run_preprocess(cfg, device):
    """The view-selection pre-pass over the train and test splits
    (reference run.py:39-69)."""
    from boostmvsnerfs_torch import runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader

    model = runner.make_network(cfg, device)
    runner._init_or_load(cfg, model)
    loaders = [Loader(make_dataset(cfg, "train"), 1), Loader(make_dataset(cfg, "test"), 1)]
    out = runner.run_view_selection(cfg, model, loaders)
    print(f"view selection written for {len(out)} target views")


def run_evaluate(cfg, device):
    from boostmvsnerfs_torch import runner

    return runner.run_evaluate(cfg, device=device)


def run_visualize(cfg, device):
    """Every test view through the model into the ``Visualizer``: colour
    and depth videos, or PNG frames (reference run.py:81-108). A boost
    model's view selection is read from ``view_selection.json``, which the
    pre-pass writes first when it is missing (as ``run_evaluate`` does)."""
    from boostmvsnerfs_torch import resolve_device, runner
    from boostmvsnerfs_torch.data import make_dataset
    from boostmvsnerfs_torch.data.loader import Loader
    from boostmvsnerfs_torch.eval.visualizer import Visualizer
    from boostmvsnerfs_torch.models.enerf import CascadeConfig

    device = resolve_device(device)
    model = runner.make_network(cfg, device)
    runner._init_or_load(cfg, model)
    loader = Loader(make_dataset(cfg, "test"), batch_size=1)
    boost = runner.requires_view_selection(cfg)
    if boost:
        if not os.path.exists(runner.view_selection_path(cfg)):
            runner.run_view_selection(cfg, model, [loader])
        vs = runner.load_view_selection(cfg)
    vis = Visualizer(CascadeConfig.from_cfg(cfg["enerf"]), cfg["result_dir"],
                     write_video=cfg.get("write_video", True), fps=int(cfg.get("fps", 10)))
    for np_batch in loader:
        if boost:
            np_batch = runner.attach_boost_inputs(np_batch, vs, cfg)
        vis.visualize(model(runner._device_batch(np_batch, device)), np_batch)
    return vis.summarize()


def run_path(cfg, device):
    """A novel camera path to video (``runner.render_novel_path``)."""
    from boostmvsnerfs_torch import runner

    return runner.render_novel_path(cfg, n_frames=int(cfg.get("render_num", 30)),
                                    path_type=cfg.get("path_type", "interpolate"),
                                    device=device)


def run_gui(cfg, device):
    """The browser viewer (``interactive/server.py``) on ``gui_host``:``gui_port``
    (default 127.0.0.1:8008), serving until interrupted."""
    from boostmvsnerfs_torch.interactive.server import run_gui as serve

    serve(cfg, device, port=int(cfg.get("gui_port", 8008)), host=cfg.get("gui_host", "127.0.0.1"))


RUNS = {"dataset": run_dataset, "network": run_network, "preprocess": run_preprocess,
        "evaluate": run_evaluate, "visualize": run_visualize, "path": run_path, "gui": run_gui}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--type", required=True, choices=sorted(RUNS))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    from boostmvsnerfs_torch import set_numerics
    from boostmvsnerfs_torch.config import make_cfg

    set_numerics()
    return RUNS[args.type](make_cfg(args.cfg_file, args.opts), args.device)


if __name__ == "__main__":
    main()
