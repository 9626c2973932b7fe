#!/usr/bin/env python3
"""Data-parallel face training over several GPUs on NCCL, held against one
process.

    python3 scripts/torch_data_parallel_nccl.py [N_RANKS]

One process per GPU (N_RANKS, by default every visible card) joins an NCCL
group and takes its rows of a global batch of 2 x N_RANKS; each runs
chip_smoke.py's train_face_256 configuration in f32 at full width (256 px,
ngf 32, K = 1, VGG and the FlowNet2 teacher on) for one single-frame and one
temporal step (`parallel/dryrun.py` `check_data_parallel`).  The same steps
then run in this process at the global batch on the first card.  Every
step's losses must equal the one process's within JAX's dryrun tolerances,
the first step's frames within 1e-3, and after each step every parameter,
buffer and Adam moment must be bitwise equal across the ranks.  Prints one
JSON line with ms per step per rank and in one process (host clock around a
synchronise), the teacher's ms and the B2 launches per rank, then the
cards' names and power limits.  Needs CUDA devices; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BATCH_PER_RANK = 2
FRAME_TOL = 1e-3


def main() -> int:
    import torch
    from fsvid2vid_tpu_torch.parallel.dryrun import check_data_parallel
    if not torch.cuda.is_available():
        print("torch_data_parallel_nccl: no CUDA device", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="fsv_nccl_") as tmp:
        report = check_data_parallel(
            dict(batch_size=BATCH_PER_RANK * n, pool_size=0), n_ranks=n, device="cuda",
            backend="nccl", teacher=True, work_dir=tmp, timeout_s=300,
            deadline_s=600, image_tol=FRAME_TOL)
    print(json.dumps({
        "ranks": n, "global_batch": BATCH_PER_RANK * n, "backend": "nccl",
        "frame_max_abs_diff": report["frame_max_abs_diff"],
        "max_loss_diff": [max(d.values()) for d in report["diff"]],
        "ms_per_step_one_process": report["single"]["ms"],
        "ms_per_step_ranks": [r["ms"] for r in report["ranks"]],
        "teacher_ms": {"one_process": report["single"]["teacher_ms"],
                       "ranks": [r["teacher_ms"] for r in report["ranks"]]},
        "tensors_equal_across_ranks": report["ranks"][0]["n_tensors"],
        "b2_launches_by_rank": [r["b2_launches_by_route"] for r in report["ranks"]],
        "losses_one_process": report["single"]["losses"],
        "losses_ranks": report["ranks"][0]["losses"]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
