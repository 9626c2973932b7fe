#!/usr/bin/env python3
"""The served step's device operations in two modes of the pipeline, on
one card.

    python3 scripts/torch_serve_layouts.py [cell ...] [--seed N] [--steps N]
                                           [--modes A,B]

For each serving cell (default: both of BENCHMARK.json), built, weighted
and warmed up as `python -m benchmark.run` builds it
(benchmark/drivers/serve.py), `--steps` steps after a reset run under
torch.profiler in two modes (default nchw,channels_last), in turns A, B,
B, A, each on a fresh generator of the same seed:

  nchw           the generator as the pipeline served it before it ran
                 channels-last: spectral norms folded, weights NCHW, each
                 input copied NCHW-contiguous (`.contiguous()`)
  channels_last  the pipeline as it is (inference/fold.py `serving_module`)
  plain_norms    channels_last with every norm composed as a chain of
                 passes, as before the fused norm (ops/norm_modulate.py)

and prints one JSON line a cell and mode with

  step_ms        host ms a step (the frames on the host), median
  device_ms      device ms a step by kernel name, the busiest first
  transposes_ms  cuDNN's nchwToNhwc / nhwcToNchw kernels, ms a step
  convs          per convolution shape (input and weight, as
                 aten::cudnn_convolution records them): calls a step, device
                 ms a step, and the kernels it ran, the busiest first
  batch_conv     the batch_conv calls of a step by route
  norm_ms        device ms a step under the fused norm's operator
  norm_modulate  the norms' calls of a step by route

Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.registry import Registry  # noqa: E402
from benchmark.run import Run  # noqa: E402
from fsvid2vid_tpu_torch.inference import fold, pipeline  # noqa: E402
from fsvid2vid_tpu_torch.models import layers  # noqa: E402
from fsvid2vid_tpu_torch.ops.batch_conv import batch_conv  # noqa: E402
from fsvid2vid_tpu_torch.ops.norm_modulate import norm_modulate  # noqa: E402

TRANSPOSES = ("nchwToNhwcKernel", "nhwcToNchwKernel")
CONV_OPS = ("aten::cudnn_convolution", "aten::_convolution", "aten::convolution")
NORM_OP = "fsv::norm_modulate"
MODES = ("nchw", "channels_last", "plain_norms")


def nchw_layout():
    """The pipeline as it served NCHW."""
    return [mock.patch.object(pipeline, "serving_module",
                              lambda net: fold.fold_spectral_norm(net.eval())),
            mock.patch.object(pipeline, "_nchw",
                              lambda x: x.movedim(-1, -3).contiguous())]


def patches_of(mode: str):
    if mode == "nchw":
        return nchw_layout()
    if mode == "plain_norms":
        return [mock.patch.object(layers, "fused_route", lambda *a, **k: False)]
    return []


def kernels_by_op(prof):
    """{conv shape key: [calls, {kernel: us}]} over the convolution ops,
    {kernel: us} over every op, and the us of the fused norm's kernels."""
    convs = collections.defaultdict(lambda: [0, collections.Counter()])
    every = collections.Counter()
    norm_us = 0.0
    for e in prof.events():
        for k in e.kernels:
            every[k.name] += k.duration
        if e.name in CONV_OPS and e.kernels:
            key = json.dumps(e.input_shapes[:2])
            convs[key][0] += 1
            for k in e.kernels:
                convs[key][1][k.name] += k.duration
        if e.name == NORM_OP:
            norm_us += sum(k.duration for k in e.kernels)
    return convs, every, norm_us


def measure(run, drv, mode: str, steps: int) -> dict:
    from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
    patches = patches_of(mode)
    for p in patches:
        p.start()
    try:
        cfg, _ = drv.configs(run)
        g = drv.build_generator(torch, cfg, run.traffic, run.seed, run.device,
                                FewShotGenerator)
        pipe = pipeline.InferencePipeline(cfg, g, compute_dtype=cfg.compute_dtype)
        clips = drv.Clips(torch, cfg, run.traffic, run.seed, run.device)
        drv.warm_up(run, pipe, clips)
        clip = clips.make(-3)
        pipe.reset(clip["ref_labels"], clip["ref_images"], clip["labels"][0])
        pipe.step(clip["labels"][0])
        host = []
        for t in range(1, steps + 1):
            t0 = time.perf_counter()
            pipe.step(clip["labels"][t])["fake_image"].cpu()
            host.append(1e3 * (time.perf_counter() - t0))
        before = dict(batch_conv.calls_by_route)
        norms_before = dict(norm_modulate.calls_by_route)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                record_shapes=True) as prof:
            for t in range(1, steps + 1):
                pipe.step(clip["labels"][t])["fake_image"].cpu()
            torch.cuda.synchronize()
        routes = {k: (v - before[k]) / steps for k, v in batch_conv.calls_by_route.items()}
        norm_routes = {k: (v - norms_before[k]) / steps
                       for k, v in norm_modulate.calls_by_route.items()}
    finally:
        for p in patches:
            p.stop()
    convs, every, norm_us = kernels_by_op(prof)
    per_step = lambda us: round(us / steps / 1e3, 4)
    out = {
        "mode": mode,
        "step_ms": round(statistics.median(host), 3),
        "device_ms_total": per_step(sum(every.values())),
        "device_ms": {k[:90]: per_step(v) for k, v in every.most_common(15)},
        "transposes_ms": per_step(sum(v for k, v in every.items()
                                      if any(t in k for t in TRANSPOSES))),
        "convs": sorted(({"shapes": json.loads(key), "calls": n / steps,
                          "ms": per_step(sum(ks.values())),
                          "kernels": {k[:90]: per_step(v) for k, v in ks.most_common(3)}}
                         for key, (n, ks) in convs.items()), key=lambda c: -c["ms"]),
        "batch_conv": routes,
        "norm_ms": per_step(norm_us),
        "norm_modulate": norm_routes,
    }
    del pipe, g, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--seed", type=int, default=2147483001)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--modes", default="nchw,channels_last")
    args = ap.parse_args()
    a, b = args.modes.split(",")
    if not {a, b} <= set(MODES):
        sys.exit(f"--modes: two of {MODES}")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    registry = Registry(ROOT)
    cells = args.cells or [w["name"] for w in registry.spec["workloads"]
                           if registry.traffic(w["traffic"])["kind"] == "serve"]
    drv = registry.driver("serve")
    for name in cells:
        c = registry.cell(name)
        run = Run(torch=torch, device=torch.device("cuda"), cell=c,
                  config=registry.config(c["config"]), traffic=registry.traffic(c["traffic"]),
                  seed=args.seed, seconds=30.0, trace=True, started=time.time())
        for mode in (a, b, b, a):
            out = measure(run, drv, mode, args.steps)
            print(json.dumps({"cell": name, "device": torch.cuda.get_device_name(0), **out}),
                  flush=True)


if __name__ == "__main__":
    main()
