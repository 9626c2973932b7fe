"""Serving traffic: S streams batched into one `InferencePipeline.step` of
the port (fsvid2vid_tpu_torch/inference/pipeline.py), in a closed loop,
since each frame needs the one before it.

A clip is `clip_frames` frames of every stream: at its first step the
pipeline is `reset` with the clip's references (K a stream), then each step
takes one driving label a stream and hands all S frames to the host
(`.cpu()`, as a server hands frames on).  A step's latency runs from the
call (with the reset, at a clip's start) to its frames on the host.  Clip c's
inputs come from (seed, c) alone, so the check can make them again.

Inputs (benchmark/inputs.py), per stream: K references, each a label map
and an image (tanh of a smooth map); the stream follows one of them, picked
from the seed, its label moved by the traffic's "motion" at every frame.
The traffic's "labels" give the maps:
  gaussian  smooth N(0, 1) maps on a grid of `cells`, plus `noise` N(0, 1)
            at every frame (face edge maps: label_nc 0);
  regions   piecewise-constant maps of `classes` classes on a grid of
            `cells` (street segmentation: class indices).

Correctness: after the window, with the program freed, the reference
(benchmark/reference, f32, TF32 off) recomputes a sample of the window's
steps drawn from the seed: clip 0's first step (the reset and a frame
without previous frames), and in every clip one later step, fed the
previous frame that the program served (the reference follows the program
step by step there, so that rounding does not compound over a clip).  The
sampled frames of every stream are compared.
"""
from __future__ import annotations

import contextlib
import gc
import math
import random
import time
from typing import Dict, List, Tuple

from benchmark import inputs, weights
from benchmark.precision import no_tf32
from benchmark.readings import Readings, Step
from benchmark.seeds import subseed

# warm-up: rounds of a reset and this many steps, on inputs of their own
WARMUP_ROUNDS, WARMUP_STEPS = 2, 3
# the reference recomputes a step this many streams at a time
STREAM_BLOCK = 4


# ----------------------------------------------------------------------
# configurations and inputs
# ----------------------------------------------------------------------
def configs(run):
    """(program Config, reference Config) from the configuration file and
    the traffic's fields."""
    from fsvid2vid_tpu_torch.config import preset
    from benchmark.reference.config import preset as ref_preset
    fields = dict(run.config["fields"], **run.traffic["config_fields"])
    cfg = preset(run.config["preset"], **fields)
    return cfg, ref_preset(run.config["preset"], **dict(fields, compute_dtype="float32"))


class Clips:
    """Clip c's references and labels for every stream, made on the device
    from (seed, c)."""

    def __init__(self, torch, cfg, traffic: dict, seed: int, device):
        self.torch, self.traffic, self.seed, self.device = torch, traffic, seed, device
        self.s, self.k = traffic["streams"], cfg.n_shot
        self.h, self.w = cfg.height, cfg.width
        self.t = traffic["clip_frames"]
        self.cl = 1 if cfg.label_nc > 0 else cfg.input_nc

    def make(self, c: int) -> Dict:
        torch, spec, motion = self.torch, self.traffic["labels"], self.traffic["motion"]
        g = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "clip", c))
        s, k, h, w, t = self.s, self.k, self.h, self.w, self.t
        fav = torch.randint(k, (s,), device=self.device, generator=g)
        rows = torch.arange(s, device=self.device)
        if spec["kind"] == "gaussian":
            ref_labels = inputs.smooth(torch, g, s * k, self.cl, h, w, spec["cells"])
        elif spec["kind"] == "regions":
            ref_labels = inputs.classes(torch, g, s * k, h, w, spec["classes"], spec["cells"])
        else:
            raise ValueError(f"labels kind {spec['kind']!r}")
        ref_labels = ref_labels.view(s, k, h, w, -1)
        follow = ref_labels[rows, fav]
        labels = torch.stack([inputs.moved(torch, follow, i, motion) for i in range(t)])
        if spec["kind"] == "gaussian":
            labels = labels + spec["noise"] * torch.randn(
                labels.shape, device=self.device, generator=g)
        ref_images = torch.tanh(inputs.smooth(torch, g, s * k, 3, h, w,
                                              self.traffic["image_cells"]))
        return {"ref_labels": ref_labels, "ref_images": ref_images.view(s, k, h, w, 3),
                "labels": labels}


def sampled_frames(traffic: dict, seed: int, c: int) -> List[int]:
    """The checked frames of clip c: one later frame drawn from the seed,
    and in clip 0 its first frame as well."""
    t = 1 + random.Random(subseed(seed, "sample", c)).randrange(traffic["clip_frames"] - 1)
    return [0, t] if c == 0 else [t]


def build_generator(torch, cfg, traffic: dict, seed: int, device, make):
    """`make(cfg)` built without storage on `device`, filled from the seed."""
    spec = traffic["weights"]
    with torch.device("meta"):
        net = make(cfg)
    net = net.to_empty(device=device)
    weights.fill(net, subseed(seed, "netG"), gain=spec["gain"],
                 random_stats=spec["random_stats"])
    if cfg.n_shot > 1 and spec.get("sharpen"):
        weights.focus_attention(net, cfg.n_downsample_A, spec["sharpen"])
    return net.eval()


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------
def execute(run):
    torch, device, traffic = run.torch, run.device, run.traffic
    from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
    from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
    cfg, ref_cfg = configs(run)
    g = build_generator(torch, cfg, traffic, run.seed, device, FewShotGenerator)
    pipe = InferencePipeline(cfg, g, compute_dtype=cfg.compute_dtype)
    clips = Clips(torch, cfg, traffic, run.seed, device)
    warm_up(run, pipe, clips)
    readings, kept = window(run, pipe, clips)
    if run.trace:
        readings.trace = traced_segment(run, pipe, clips)
    memory_peak = run.memory_peak()
    frames = sum(s.frames for s in readings.steps)
    del pipe, g
    gc.collect()
    run.empty_cache()

    compared, checked, failed = check(run, ref_cfg, clips, kept)
    if run.trace:
        readings.flops = count_flops(torch, ref_cfg, traffic)
    return dict(readings=readings, attempted=frames, failed=failed,
                memory_peak_bytes=memory_peak, compared=compared, checked=checked)


def warm_up(run, pipe, clips: Clips) -> float:
    """This cell's shapes only (a reset, a frame without and frames with
    previous frames), WARMUP_ROUNDS times, on inputs of their own; returns
    the last round's seconds a step with previous frames."""
    warm = clips.make(-1)
    for _ in range(WARMUP_ROUNDS):
        pipe.reset(warm["ref_labels"], warm["ref_images"], warm["labels"][0])
        pipe.step(warm["labels"][0])["fake_image"].cpu()
        t0 = time.perf_counter()
        for t in range(1, WARMUP_STEPS):
            pipe.step(warm["labels"][t])["fake_image"].cpu()
        step_s = (time.perf_counter() - t0) / (WARMUP_STEPS - 1)
    run.synchronize()
    return step_s


def window(run, pipe, clips: Clips):
    """The measured window: whole steps until `seconds` have passed."""
    traffic, s = run.traffic, run.traffic["streams"]
    n_frames = traffic["clip_frames"]
    kept: Dict = {}
    steps: List[Step] = []
    reset_ms: List[float] = []
    c, t, clip = -1, n_frames, None
    start = time.perf_counter()
    while time.perf_counter() - start < run.seconds:
        if t == n_frames:
            c, t = c + 1, 0
            clip = clips.make(c)
            wanted = {f - d for f in sampled_frames(traffic, run.seed, c)
                      for d in (0, 1) if f - d >= 0}
        t0 = time.perf_counter()
        if t == 0:
            pipe.reset(clip["ref_labels"], clip["ref_images"], clip["labels"][0])
            if run.trace:   # the reset alone, in the traced run only
                run.synchronize()
                reset_ms.append(1e3 * (time.perf_counter() - t0))
        out = pipe.step(clip["labels"][t])
        frame = out["fake_image"].cpu()
        t1 = time.perf_counter()
        steps.append(Step(t0, t1, s, "reset" if t == 0 else "step"))
        if t in wanted:
            kept[(c, t)] = frame
            kept[("ref_idx", c, t)] = out["ref_idx"]
        t += 1
    readings = Readings(setup_s=run.setup_s(start), steps=steps, window_start=start,
                        window_end=steps[-1].end)
    if reset_ms:
        readings.spans["reset_ms"] = reset_ms
    kept["n_clips"] = c + 1
    return readings, kept


def control(run, fp8: bool = True) -> Dict[str, Dict[str, float]]:
    """Readings for the correctness limits at the cell's size: the program,
    warmed up as a run is, serves clips 0..n-1 up to each one's sampled
    frame, n the clips that a window of `run.seconds` starts at the
    warm-up's step time; then the reference in f32 and, as the control,
    the same reference in fp8 (benchmark/precision.py; with `fp8`) recompute
    the sampled steps.  Returns the program's gaps and the control's, each
    from the f32 reference, and n."""
    from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
    from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
    from benchmark.precision import Fp8Operands
    torch, device = run.torch, run.device
    cfg, ref_cfg = configs(run)
    g = build_generator(torch, cfg, run.traffic, run.seed, device, FewShotGenerator)
    pipe = InferencePipeline(cfg, g, compute_dtype=cfg.compute_dtype)
    clips = Clips(torch, cfg, run.traffic, run.seed, device)
    n_clips = math.ceil(run.seconds / (clips.t * warm_up(run, pipe, clips)))
    kept: Dict = {"n_clips": n_clips}
    for c in range(n_clips):
        clip, wanted = clips.make(c), sampled_frames(run.traffic, run.seed, c)
        pipe.reset(clip["ref_labels"], clip["ref_images"], clip["labels"][0])
        for t in range(max(wanted) + 1):
            out = pipe.step(clip["labels"][t])
            if t in wanted or t + 1 in wanted:
                kept[(c, t)] = out["fake_image"].cpu()
                kept[("ref_idx", c, t)] = out["ref_idx"]
    del pipe, g
    run.empty_cache()
    steps = checked_steps(run, kept)
    f32 = reference_frames(run, ref_cfg, clips, kept, steps)
    out = {"program": gaps(torch, kept, f32), "clips": n_clips}
    if fp8:
        out["control"] = gaps(torch, reference_frames(run, ref_cfg, clips, kept, steps,
                                                      mode=Fp8Operands()), f32)
    return out


def traced_segment(run, pipe, clips: Clips):
    """`trace.steps` further steps under the profiler, from a fresh clip's
    reset, so that the segment holds a clip's start."""
    from torch.profiler import record_function
    from benchmark.tracing import Tracer
    clip = clips.make(-2)
    spec = run.traffic["trace"]
    with Tracer(run.torch, shapes=spec.get("shapes", False),
                host_ops=spec.get("host_ops", True)) as tr:
        for t in range(run.traffic["trace"]["steps"]):
            if t == 0:
                with record_function("bench.reset"):
                    pipe.reset(clip["ref_labels"], clip["ref_images"], clip["labels"][0])
            with record_function("bench.step"):
                out = pipe.step(clip["labels"][t])
            with record_function("bench.frames_to_host"):
                out["fake_image"].cpu()
    return tr.summary


def count_flops(torch, ref_cfg, traffic: dict) -> Dict[str, float]:
    """FLOP of a reset, a clip's first frame and a later frame of the
    reference at the cell's shapes (FlopCounterMode on fake tensors: nothing
    runs; after the check, so that the window does not pay for the garbage
    the fake tensors leave)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference.inference.pipeline import InferencePipeline
    from benchmark.reference.models.generator import FewShotGenerator
    s, k, h, w = traffic["streams"], ref_cfg.n_shot, ref_cfg.height, ref_cfg.width
    cl = 1 if ref_cfg.label_nc > 0 else ref_cfg.input_nc
    out = {}
    with FakeTensorMode():
        pipe = InferencePipeline(ref_cfg, FewShotGenerator(ref_cfg).eval())
        label = torch.zeros(s, h, w, cl)
        for kind, call in (("reset", lambda: pipe.reset(torch.zeros(s, k, h, w, cl),
                                                        torch.zeros(s, k, h, w, 3), label)),
                           ("first", lambda: pipe.step(label)),
                           ("step", lambda: pipe.step(label))):
            with FlopCounterMode(display=False) as fc:
                call()
            out[kind] = float(fc.get_total_flops())
    return out


# ----------------------------------------------------------------------
# correctness
# ----------------------------------------------------------------------
def reference_frames(run, ref_cfg, clips: Clips, kept: Dict, steps, mode=None):
    """The reference's frames of the sampled `steps`, fed each step's
    inputs and the program's previous frame, in blocks of streams; `mode`
    (a TorchFunctionMode) computes them in another precision."""
    torch, device = run.torch, run.device
    from benchmark.reference.inference.pipeline import InferencePipeline
    from benchmark.reference.models.generator import FewShotGenerator
    g = build_generator(torch, ref_cfg, run.traffic, run.seed, device, FewShotGenerator)
    pipe = InferencePipeline(ref_cfg, g)
    block = STREAM_BLOCK
    out = {}
    with no_tf32(torch), (mode or contextlib.nullcontext()):
        for c, t in steps:
            clip = clips.make(c)
            frames, ref_idx = [], []
            for b in range(0, clips.s, block):
                rows = slice(b, b + block)
                pipe.reset(clip["ref_labels"][rows], clip["ref_images"][rows],
                           clip["labels"][0][rows])
                if t > 0:
                    prev = kept[(c, t - 1)][rows].to(device)
                    pipe.prevs = {"label": pipe._run.labels(clip["labels"][t - 1][rows])[1],
                                  "fake": prev}
                    pipe.t = 1
                step = pipe.step(clip["labels"][t][rows])
                frames.append(step["fake_image"].cpu())
                ref_idx.append(step["ref_idx"])
            out[(c, t)] = torch.cat(frames)
            if ref_idx[0] is not None:
                out[("ref_idx", c, t)] = torch.cat(ref_idx)
    del pipe, g
    run.empty_cache()
    return out


def gaps(torch, candidate: Dict, reference: Dict) -> Dict[str, float]:
    """frame_mean_gap: the mean absolute gap of the candidate's frames from
    the reference's over every sampled frame of every stream (compared);
    frame_max_gap, the largest (a widest gap swings from seed to seed, as
    one reference picked otherwise on near-tied attention moves one frame
    a long way); frame_stream_gap, the worst stream's mean gap over its
    sampled frames; ref_idx_flips, the sampled frames whose most-attended
    reference differs."""
    keys = [k for k in reference if k[0] != "ref_idx"]
    diff = torch.stack([(candidate[k].float() - reference[k].float()).abs().flatten(1)
                        for k in keys])                 # (steps, streams, pixels)
    flips = sum(int((candidate[("ref_idx",) + k].cpu() != reference[("ref_idx",) + k].cpu())
                    .sum()) for k in keys if ("ref_idx",) + k in reference)
    if not torch.isfinite(diff).all():
        return {"frame_mean_gap": float("inf"), "frame_max_gap": float("inf"),
                "frame_stream_gap": float("inf"), "ref_idx_flips": flips}
    return {"frame_mean_gap": diff.mean().item(), "frame_max_gap": diff.max().item(),
            "frame_stream_gap": diff.mean((0, 2)).max().item(), "ref_idx_flips": flips}


def checked_steps(run, kept: Dict) -> List[Tuple[int, int]]:
    """The sampled steps the window completed, each with its previous frame."""
    return [(c, t) for c in range(kept["n_clips"])
            for t in sampled_frames(run.traffic, run.seed, c)
            if (c, t) in kept and (t == 0 or (c, t - 1) in kept)]


def check(run, ref_cfg, clips: Clips, kept: Dict):
    """The gaps of the sampled frames, their count, and how many of them
    hold a value that is not finite (failed frames)."""
    torch = run.torch
    steps = checked_steps(run, kept)
    reference = reference_frames(run, ref_cfg, clips, kept, steps)
    failed = sum(int((~torch.isfinite(kept[k]).flatten(1).all(1)).sum()) for k in steps)
    return gaps(torch, kept, reference), len(steps) * clips.s, failed
