#!/usr/bin/env python3
"""Where the saved K = 8 serving programs spend a frame's extra host time.

    python3 scripts/torch_serve_turns.py

Exports chip_smoke.py's serve_export_k8_512 model (slice_k8_512's: face
512 px, K = 8, full width, random weights, bf16 as the JAX export's recipe)
and times per-frame ms (host clock around a synchronise, reset + 8 frames
a turn) in the turns session, unchecked, pipeline, pipeline, unchecked,
session on one card:

  session    the saved programs as `load_serving` loads them
  unchecked  the same programs from `ExportedProgram.module(check_guards=False)`
             (where this torch has it) with their input-check pre-hook
             removed: torch.export's per-call checks of every input skipped
  pipeline   InferencePipeline.step on the same weights (bf16 autocast)

and the host ms of the step program's input-check pre-hook alone on one
frame's inputs (~800 parameter tensors among them), and one warm frame of
each under torch.profiler (kernel ms, launches, busy share).  The
unchecked frames must equal the session's.  Prints one JSON line.  Needs a CUDA device;
imports nothing of JAX.
"""
from __future__ import annotations

import inspect
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fsvid2vid_tpu_torch.config import face_config  # noqa: E402
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline  # noqa: E402
from fsvid2vid_tpu_torch.inference.serve import PROGRAMS, load_serving  # noqa: E402

CHECK_HOOK = "_check_input_constraints_pre_hook"


def unchecked(out_dir, session):
    """Swap the session's programs for ones that skip the input checks;
    returns what could be skipped with this torch."""
    guards = "check_guards" in inspect.signature(torch.export.ExportedProgram.module).parameters
    skipped = {"guards": guards}
    for name in PROGRAMS:
        m = session.programs[name]
        if guards:
            m = torch.export.load(os.path.join(out_dir, f"{name}.pt2")).module(
                check_guards=False)
        hooks = [k for k, h in m._forward_pre_hooks.items()
                 if getattr(h, "__name__", "") == CHECK_HOOK]
        for k in hooks:
            del m._forward_pre_hooks[k]
        skipped["pre_hooks"] = len(hooks)
        session.programs[name] = m
    return skipped


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_turns: no CUDA device", file=sys.stderr)
        return 1
    smi = cs.phase_device(torch)
    cfg = face_config(fine_size=512, load_size=512, n_shot=8, batch_size=1,
                      is_train=False, init_variance=1.0)
    g = cs.build(torch, cfg, seed=0)
    labels, ref_labels, ref_images = cs.seeded_inputs(torch, cfg, 8, cs.SERVE_FRAMES, seed=1)
    res = {"card": smi, "frames": cs.SERVE_FRAMES}
    with tempfile.TemporaryDirectory(prefix="fsv_serve_turns_") as tmp:
        out_dir = os.path.join(tmp, "serve_k8")
        session, res["export"] = cs.export_and_load(torch, cfg, g, out_dir, torch.bfloat16)
        fast = load_serving(out_dir)
        res["skipped"] = unchecked(out_dir, fast)

        # the step program's input-check pre-hook alone
        session.reset(ref_labels, ref_images, labels[0])
        session.step(labels[0])
        args = (session.params, session.cache, session._tensor(labels[1]), *session._refs,
                session.prevs)
        step = session.programs["step"]
        hook = [h for h in step._forward_pre_hooks.values()
                if getattr(h, "__name__", "") == CHECK_HOOK][0]
        call = (lambda: hook(step, args, {})) if len(
            inspect.signature(hook).parameters) == 3 else (lambda: hook(step, args))
        call()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        res["input_check_ms"] = 1e3 * (time.perf_counter() - t0) / 20
        res["inputs"] = len(torch.utils._pytree.tree_leaves(args))

        pipe = InferencePipeline(cfg, g, compute_dtype="bfloat16")
        runs = {"session": lambda: cs.session_frames(torch, session, labels, ref_labels,
                                                     ref_images),
                "unchecked": lambda: cs.session_frames(torch, fast, labels, ref_labels,
                                                       ref_images),
                "pipeline": lambda: cs.run_frames(torch, pipe, labels, ref_labels,
                                                  ref_images)[:2]}
        frames = {who: fn()[0] for who, fn in runs.items()}      # warm-up
        res["unchecked_equals_session"] = bool(torch.equal(frames["session"],
                                                           frames["unchecked"]))
        turns = []
        for who in ("session", "unchecked", "pipeline", "pipeline", "unchecked", "session"):
            turns.append({"who": who, "frame_ms": runs[who]()[1]})
        res["turns"] = turns
        median = lambda xs: sorted(xs)[len(xs) // 2]
        res["median_frame_ms"] = {who: median([m for t in turns if t["who"] == who
                                               for m in t["frame_ms"]]) for who in runs}
        # one warm frame of each under torch.profiler: kernel ms and launches
        res["profile"] = {
            "session": cs.profile_call(torch, lambda: session.step(labels[2])),
            "unchecked": cs.profile_call(torch, lambda: fast.step(labels[2])),
            "pipeline": cs.profile_step(torch, pipe, labels[2])}
    print(json.dumps(res), flush=True)
    return 0 if res["unchecked_equals_session"] else 1


if __name__ == "__main__":
    sys.exit(main())
