"""Faults of the cells whose traffic kinds benchmark/faults.py does not
know, planted in the port underneath a run to show that the correctness
check catches them; like faults.py, each patches the port, never the
reference.

train_pose (pose with face refinement):
  skip_refiner      netGf skipped: the coarse face is cropped and pasted
                    back unchanged, so netGf takes no gradient
  shifted_face_box  every face box 8 px to the right (the refiner's crop
                    and paste, and the face discriminator's crops)
  no_face_d_in_g    netDf left out of the G losses: Gf_GAN and Gf_GAN_Feat
                    (with the crops' L1 and VGG terms) read 0
  unwarped_parts    the reference's nine body-part masks compared with the
                    target's without the flow's warp
and training's faults (faults.TRAIN), which patch what both kinds run.

train_dp (data parallel over ranks), each reaching every rank's process
through the environment (benchmark/drivers/train_dp.py FAULT):
  rank_skips_average  the last rank takes part in the gradient all-reduce
                      but keeps its own gradients, so its parameters
                      leave the other ranks'
and training's faults (faults.TRAIN), planted in every rank.

  python -m benchmark.cell_faults --workload <cell> --seeds <n> [<n> ...] --fault NAME

prints one JSON line a seed, the program's numbers against the f32
reference, as `python -m benchmark.control --fault` does for the other
kinds.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from unittest import mock

from benchmark import faults

POSE = ("skip_refiner", "shifted_face_box", "no_face_d_in_g", "unwarped_parts")
DP = ("rank_skips_average",) + faults.TRAIN
SHIFT_PX = 8.0


@contextlib.contextmanager
def planted(kind: str, name: str):
    """Fault `name` in the port for traffic of `kind`."""
    if kind == "train_pose":
        with (_pose(name) if name in POSE else faults.planted("train", name)):
            yield
    elif kind == "train_dp":
        if name not in DP:
            raise ValueError(f"data-parallel fault {name!r}: one of {DP}")
        from benchmark.drivers.train_dp import FAULT
        with mock.patch.dict(os.environ, {FAULT: name}):
            yield
    else:
        with faults.planted(kind, name):
            yield


def _pose(name: str):
    import torch
    import fsvid2vid_tpu_torch.losses.collector as collector
    import fsvid2vid_tpu_torch.models.face_refiner as fr
    import fsvid2vid_tpu_torch.training.step as step_mod
    if name == "skip_refiner":
        def coarse_pasted(cfg, netGf, label_valid, fake_image, label, *refs):
            boxes = fr.get_face_boxes(cfg, label, crop_smaller=4)
            coarse = fr.crop_face_region(cfg, fake_image, label, crop_smaller=4,
                                         boxes=boxes).detach()
            return fr.replace_face_region(cfg, fake_image, torch.zeros_like(coarse), label,
                                          coarse, crop_smaller=4, boxes=boxes)
        return mock.patch.object(step_mod, "refine_face_region", coarse_pasted)
    if name == "shifted_face_box":
        boxes = fr.get_face_boxes

        def shifted(*args, **kw):
            out = boxes(*args, **kw)
            return out + out.new_tensor([0.0, 0.0, SHIFT_PX, SHIFT_PX])
        return mock.patch.object(fr, "get_face_boxes", shifted)
    if name == "no_face_d_in_g":
        face = collector.discriminate_face

        def d_only(*args):   # compute_gan_losses passes nine, for_discriminator last
            if args[-1]:
                return face(*args)
            zero = torch.zeros((), device=args[3].device)
            return [zero, zero]
        return mock.patch.object(collector, "discriminate_face", d_only)
    if name == "unwarped_parts":
        warp = collector.flow_warp

        def parts_unwarped(x, flow):
            return x if x.shape[1] == 9 else warp(x, flow)
        return mock.patch.object(collector, "flow_warp", parts_unwarped)
    raise ValueError(f"pose fault {name!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", required=True)
    args = p.parse_args(argv)
    import torch
    from benchmark.control import readings
    from benchmark.registry import Registry
    from benchmark.run import ROOT
    if not torch.cuda.is_available():
        print("benchmark.cell_faults: no CUDA device", file=sys.stderr)
        return 2
    registry = Registry(ROOT)
    kind = registry.traffic(registry.cell(args.workload)["traffic"])["kind"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        with planted(kind, args.fault):
            out = readings(registry, args.workload, seed, "cuda", control=False)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
