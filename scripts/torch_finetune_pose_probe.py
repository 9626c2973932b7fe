#!/usr/bin/env python3
"""Watch the generator's output layer during the pose finetune of chip_smoke.py.

    python3 scripts/torch_finetune_pose_probe.py [REPEATS]

Runs `phase_build` once, then REPEATS times (default 3) `phase_pose_cli`
(the pose CLI's training, whose checkpoint the finetune starts from) and
`phase_finetune_pose` (`cli.test --finetune`, 100 bf16 steps), each in a
fresh temporary directory.  During each finetune, hooks on the generator's
`conv_img` record, per call, the share of output pixels at which the bf16
tanh is exactly +-1 (there its derivative 1 - y^2 is exactly 0, so no
gradient reaches any generator parameter through that pixel), and per
backward the largest |gradient| of `conv_img.weight`.  Prints each phase's
lines as chip_smoke.py does, then one JSON line per repeat with the
finetune's count of moved G parameters beside those records, then the card's
name and power limit.  Needs a CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from fsvid2vid_tpu_torch.inference import finetune as ft_lib
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    smi = cs.phase_device(torch)
    cs.phase_build()
    real = ft_lib.finetune
    emitted = []
    emit = cs.emit
    cs.emit = lambda obj: (emitted.append(obj), emit(obj))

    def watched(cfg, models, *args, **kw):
        conv = models.netG.conv_img
        saturated, grad_max = [], []

        def fwd(_, __, out):
            y = torch.tanh(out.detach())
            saturated.append((y.abs() == 1).float().mean())

        hooks = [conv.register_forward_hook(fwd),
                 conv.weight.register_hook(lambda g: grad_max.append(g.abs().max()))]
        try:
            return real(cfg, models, *args, **kw)
        finally:
            for h in hooks:
                h.remove()
            record.update(
                conv_img_calls=len(saturated),
                saturated_share=[float(s) for s in saturated],
                grad_steps=len(grad_max),
                grad_max=[float(g) for g in grad_max])

    for i in range(repeats):
        record = {"repeat": i}
        ft_lib.finetune = watched
        try:
            with tempfile.TemporaryDirectory(prefix="fsv_pose_probe_") as tmp:
                cs.phase_pose_cli(torch, tmp)
                try:
                    cs.phase_finetune_pose(torch, tmp)
                    record["gate"] = "held"
                except AssertionError:
                    record["gate"] = "failed"
        finally:
            ft_lib.finetune = real
        res = [e for e in emitted if e.get("phase") == "finetune_pose"][-1]
        record["g_params_moved"] = res["g_params_moved"]
        sat, grads = record["saturated_share"], record["grad_max"]
        record["summary"] = {
            "saturated_share_min": min(sat), "saturated_share_max": max(sat),
            "calls_fully_saturated": sum(s == 1.0 for s in sat),
            "steps_with_zero_conv_img_grad": sum(g == 0.0 for g in grads),
            "grad_max_max": max(grads) if grads else None}
        print(json.dumps(record), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
