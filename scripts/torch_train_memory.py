"""Peak memory and time of the port's BoostENeRF fine-tuning step on one GPU.

    python3 scripts/torch_train_memory.py [--cases 1:0,2:0,4:0,4:2,4:16,1:16] [--steps 3]

Each case ``B:R`` runs ``--steps`` Adam steps of BoostENeRF (K=4, the
reference cascade, both levels on full images, lr 5e-5) on a synthetic
batch of B target views at 480x736 with 3 source views each (the training
split of the fine-tuning recipe, configs/exps/finetune/enerf_ours/free/
base.yaml: one view combination, taken K times), in R ray blocks (0: the
unblocked step of JAX's ``run_train``, ``parallel/train.make_train_step``;
R > 1: ``make_blocked_train_step``), f32 with TF32 off. It prints one JSON
line per case: the peak memory (``torch.cuda.max_memory_allocated``),
each step's wall time to a synchronisation and, for one more step under
torch.profiler (``utils/profiling.complete_profile``), its device-busy time
(the kernels' summed time; one stream) against that step's CUDA-event
time, so the host's share is 1 - busy / step; or ``oom`` with the memory
held when the card ran out. Then the card's name and power limit from
nvidia-smi. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cases", default="1:0,2:0,4:0,4:2,4:16,1:16")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("torch_train_memory: needs a CUDA device", file=sys.stderr)
        return 1
    from boostmvsnerfs_torch import set_numerics
    from boostmvsnerfs_torch.models.boost_enerf import BoostENeRF
    from boostmvsnerfs_torch.models.enerf import CascadeConfig, to_tensors
    from boostmvsnerfs_torch.ops.cuda import _build
    from boostmvsnerfs_torch.parallel.train import (
        create_train_state,
        make_blocked_train_step,
        make_train_step,
    )
    from boostmvsnerfs_torch.train.schedule import make_optimizer
    from boostmvsnerfs_torch.utils.profiling import block_kernels, complete_profile
    from boostmvsnerfs_torch.utils.synthetic import make_scene_batch

    set_numerics()
    _build.build()
    model = BoostENeRF(CascadeConfig(k_best=4))
    state = create_train_state(model, make_optimizer({"lr": 5e-5}, 500))
    for case in args.cases.split(","):
        B, blocks = (int(v) for v in case.split(":"))
        batch = to_tensors(make_scene_batch(B=B, n_views=3, H=480, W=736, boost=True, k_best=4,
                                            seed=0, rig="forward", with_targets=True),
                           model.device)
        step = make_blocked_train_step(model, blocks) if blocks > 1 else make_train_step(model)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = {"batch": B, "ray_blocks": blocks}
        try:
            times = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(step(state, batch)["loss"])
                times.append((time.perf_counter() - t0) * 1e3)
            rec.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, step_ms=times)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with complete_profile() as prof:
                start.record()
                step(state, batch)
                end.record()
            busy = sum(e.device_time_total for e in block_kernels(prof)) / 1e3
            wall = start.elapsed_time(end)
            rec.update(profiled_step_ms=wall, device_busy_ms=busy, host_share=1 - busy / wall)
        except torch.cuda.OutOfMemoryError:
            rec.update(oom=True, held_gib=torch.cuda.max_memory_allocated() / 2**30)
        state.optimizer.zero_grad(set_to_none=True)
        del batch
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
