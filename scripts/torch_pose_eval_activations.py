#!/usr/bin/env python3
"""Largest activations of the pose generator at eval, over repeated runs of
chip_smoke.py's pose CLI phase on one GPU.

    python3 scripts/torch_pose_eval_activations.py [RUNS]

Each run (4 by default) is chip_smoke.py's `phase_pose_cli` in a fresh
temporary directory: the synthetic pose dataset, `cli.train` for a
single-frame and a temporal epoch, the remat pair, then `cli.test` for 8
frames from `latest`.  During `cli.test` only, a global forward hook reads
every module's output.  After each run it prints one JSON line: the largest
|output| of the first frame's eight largest modules, the modules of the
first frame whose largest |output| passes 50 in call order (batch norms
with their input's largest |value|, smallest running variance and largest
|running mean|), the first module whose output held a non-finite value from
finite inputs, the largest |flow| of each warp, and the test CLI's
non-finite frames.  GPU training is not bitwise deterministic, so the runs
differ.  Then the card's name and power limit.  Needs a CUDA device and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SHOWN = 50.0   # a module of the first frame is listed past this |output|


def largest(x):
    """(all finite, largest finite |value|) over the float tensors of x."""
    import torch
    if torch.is_tensor(x):
        ts = [x]
    elif isinstance(x, (list, tuple)):
        ts = [t for t in x if torch.is_tensor(t)]
    else:
        ts = []
    ts = [t for t in ts if t.is_floating_point() and t.numel()]
    if not ts:
        return True, 0.0
    finite = all(bool(torch.isfinite(t).all()) for t in ts)
    return finite, max(float(t.float().abs().nan_to_num(0, 0, 0).amax()) for t in ts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_pose_eval_activations: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from fsvid2vid_tpu_torch.cli import test as cli_test
    from fsvid2vid_tpu_torch.inference import pipeline
    from fsvid2vid_tpu_torch.models import generator

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    on, names, rec = [False], {}, {}

    fold = pipeline.fold_spectral_norm

    def named_fold(model):
        names.update({id(m): n for n, m in model.named_modules()})
        return fold(model)

    warp = generator.flow_warp

    def read_warp(image, flow):
        if on[0]:
            rec["flows"].append(largest(flow)[1])
        return warp(image, flow)

    step = pipeline.InferencePipeline.step

    def counted_step(self, *a, **k):
        out = step(self, *a, **k)
        rec["frame"] += 1
        return out

    def hook(module, inputs, output):
        if not on[0]:
            return
        finite, top = largest(output)
        name = names.get(id(module), type(module).__name__)
        if rec["frame"] == 0:
            rec["top"].append((top, name))
            if top > SHOWN:
                row = [name, top]
                if hasattr(module, "running_var"):
                    row += [largest(list(inputs))[1], float(module.running_var.min()),
                            float(module.running_mean.abs().max())]
                rec["calls"].append(row)
        if not finite and rec["first_nonfinite"] is None and largest(list(inputs))[0]:
            rec["first_nonfinite"] = {"module": name, "frame": rec["frame"]}

    test_main = cli_test.main

    def observed_test(argv):
        on[0] = True
        try:
            out = test_main(argv)
            rec["nonfinite_frames"] = out.nonfinite_frames
            return out
        finally:
            on[0] = False

    pipeline.fold_spectral_norm = named_fold
    generator.flow_warp = read_warp
    pipeline.InferencePipeline.step = counted_step
    cli_test.main = observed_test
    torch.nn.modules.module.register_module_forward_hook(hook)
    for run in range(runs):
        rec.clear()
        rec.update(frame=0, top=[], calls=[], flows=[], first_nonfinite=None,
                   nonfinite_frames=None)
        with tempfile.TemporaryDirectory(prefix="fsv_pose_act_") as tmp:
            chip_smoke.phase_pose_cli(torch, tmp)
        print(json.dumps({"run": run, "top": sorted(rec["top"], reverse=True)[:8],
                          "calls": rec["calls"], "first_nonfinite": rec["first_nonfinite"],
                          "flows": rec["flows"], "nonfinite_frames": rec["nonfinite_frames"]}),
              flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
