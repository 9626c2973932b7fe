"""The data-parallel check: train steps sharded over ranks against the same
steps in one process (the PyTorch counterpart of __graft_entry__.py's
`dryrun_multichip`).

`dryrun_data_parallel(n_ranks, device, backend)` mirrors the JAX dryrun: the
tiny K = 2 face configuration, one global batch drawn from a seed, one
single-frame `train_step` split over `n_ranks` processes (each its rows of
the batch) against the same step in this process on the same weights and
batch, within JAX's tolerances (`loss_tolerance`), then a temporal step.
It checks more than the JAX dryrun, which only asks the temporal step for
finite losses: the temporal step too is held to those tolerances, against
the one process's temporal step from the state the ranks' single-frame step
left (`run_steps`); the first step's frames must equal the one process's;
and after every step each rank's parameters, buffers and optimizer moments
must be bitwise equal to every other rank's.

`check_data_parallel` is the general form: any face configuration, the flow
teacher on or off.  Every rank is a
child process (`python -m fsvid2vid_tpu_torch.parallel.dryrun SPEC RANK`)
that meets the others through a FileStore in a work directory, with a
timeout on every collective and a deadline on the whole run: a rank that
fails or hangs fails the check, and the others are killed.

  python -c "from fsvid2vid_tpu_torch.parallel.dryrun import dryrun_data_parallel as d; \\
      print(d(2, 'cpu', 'gloo'))"
"""
from __future__ import annotations

import datetime
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from fsvid2vid_tpu_torch.parallel import mesh

# JAX's dryrun: losses that pass through the just-updated discriminator move
# with reduction-order noise in Adam's first (sign-like) update, so only
# these are held tightly (__graft_entry__.py:112-121)
TIGHT = ("D_real", "D_fake", "F_Flow", "F_Warp", "F_Mask", "G_VGG")
STEPS = ((False, False), (True, True))   # (warp_prev, has_prev): single-frame, temporal
SEED = 0
NETWORKS = ("netG", "netGf", "netD", "netDT", "netDf")
REPO = Path(__file__).resolve().parents[2]


def loss_tolerance(key: str, a: float) -> float:
    """JAX's dryrun tolerances around the one-process loss a."""
    if key in TIGHT:
        return 5e-3 * max(abs(a), 1.0) + 1e-3
    return 5e-2 * max(abs(a), 1.0)


def dryrun_config_kwargs(n_ranks: int, **overrides) -> Dict:
    """__graft_entry__.py's tiny face configuration: K = 2 references, one
    sample per rank, no VGG loss; no replay pool (each rank would keep its
    own)."""
    kw = dict(ngf=4, nff=4, ndf=4, fine_size=32, load_size=32, n_blocks_F=2,
              n_downsample_G=3, n_adaptive_layers=2, batch_size=n_ranks,
              no_vgg_loss=True, n_shot=2, pool_size=0)
    kw.update(overrides)
    return kw


def make_sequence(cfg, frames: int, seed: int) -> Dict[str, np.ndarray]:
    """The global batch: labels N(0, 1), images tanh of N(0, 1), channel
    last, (B, T | K, H, W, C)."""
    rng = np.random.RandomState(seed)
    b, k, h, w, cl = cfg.batch_size, cfg.n_shot, cfg.height, cfg.width, cfg.gen_input_nc
    f32 = lambda x: x.astype(np.float32)
    return {"tgt_label": f32(rng.randn(b, frames, h, w, cl)),
            "tgt_image": f32(np.tanh(rng.randn(b, frames, h, w, 3))),
            "ref_labels": f32(rng.randn(b, k, h, w, cl)),
            "ref_images": f32(np.tanh(rng.randn(b, k, h, w, 3)))}


def state_digests(state) -> Dict[str, str]:
    """sha1 of the bytes of every parameter and buffer of the trained
    networks and of every optimizer moment, by name."""
    tensors = {}
    for attr in NETWORKS:
        net = getattr(state.models, attr)
        if net is not None:
            tensors.update({f"{attr}.{k}": v for k, v in net.state_dict().items()})
    for name in ("opt_G", "opt_D"):
        for i, st in getattr(state, name).state_dict()["state"].items():
            tensors.update({f"{name}.{i}.{k}": v for k, v in st.items()
                            if isinstance(v, torch.Tensor)})
    return {k: hashlib.sha1(v.detach().reshape(-1).contiguous().view(torch.uint8)
                            .cpu().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_file(spec: Dict, t: int) -> str:
    return os.path.join(spec["work_dir"], f"state_after{t}.pt")


def _save_state(state, path: str) -> None:
    nets = {a: getattr(state.models, a).state_dict() for a in NETWORKS
            if getattr(state.models, a) is not None}
    torch.save({"nets": nets, "opt_G": state.opt_G.state_dict(),
                "opt_D": state.opt_D.state_dict()}, path)


def _load_state(state, path: str, device) -> None:
    saved = torch.load(path, map_location=device, weights_only=True)
    for a, sd in saved["nets"].items():
        getattr(state.models, a).load_state_dict(sd)
    state.opt_G.load_state_dict(saved["opt_G"])
    state.opt_D.load_state_dict(saved["opt_D"])


def run_steps(spec: Dict, device) -> Dict:
    """The steps in this process, on its rows of the global batch (all of
    them outside a process group).  In a group rank 0 saves the state after
    each step but the last; outside one, the state after each such step is
    replaced by the ranks' (when they ran first), so that every step of
    the one process starts from the weights, buffers and Adam moments the
    ranks' step started from: Adam's first updates are nearly +-lr, so
    reduction-order noise in near-zero gradients would otherwise flip
    their signs and carry into the next step's losses.  Returns the losses
    (the global batch's), ms per step on the host clock around a
    synchronise, the state's digests after each step, and the cost-volume
    launches by route since the first step began (the teacher's
    included)."""
    from fsvid2vid_tpu_torch.config import face_config
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    from fsvid2vid_tpu_torch.training.flow_teacher import FlowTeacher
    from fsvid2vid_tpu_torch.training.state import TrainState, build_models
    from fsvid2vid_tpu_torch.training.step import (
        StepFlags, init_prevs, train_step, train_step_faithful, with_vae_noise)

    device = torch.device(device)
    cfg = face_config(**spec["cfg"])
    gen = torch.Generator().manual_seed(SEED)
    models = build_models(cfg, device=device, generator=gen)
    teacher = FlowTeacher(cfg, device=device, generator=gen) if spec["teacher"] else None
    mesh.broadcast_state(models.generators() + models.discriminators())
    state = TrainState(cfg, models)
    step_fn = train_step_faithful if cfg.step_mode == "faithful" else train_step
    rows = mesh.local_rows(cfg.batch_size)
    seq = {k: torch.from_numpy(v[rows]).to(device)
           for k, v in make_sequence(cfg, len(STEPS), SEED).items()}
    for route in cv.cost_volume_cuda.launches_by_route:
        cv.cost_volume_cuda.launches_by_route[route] = 0
    flow_gt = conf_gt = [None, None]
    if teacher is not None:
        _sync(device)
        t0 = time.perf_counter()
        flow_gt, conf_gt = teacher(cfg, seq, cfg.niter_single + 1)
        _sync(device)
        teacher_ms = 1e3 * (time.perf_counter() - t0)
    vae_gen = torch.Generator().manual_seed(SEED + 1)
    at = lambda xs, t: [None if x is None else x[:, t] for x in xs]
    out = {"rank": mesh.rank(), "world": mesh.world(), "rows": [rows.start, rows.stop],
           "losses": [], "ms": [], "digests": []}
    if teacher is not None:
        out["teacher_ms"] = teacher_ms
    prevs = None
    for t, (warp_prev, has_prev) in enumerate(STEPS):
        batch = {"tgt_label": seq["tgt_label"][:, t], "tgt_image": seq["tgt_image"][:, t],
                 "ref_labels": seq["ref_labels"], "ref_images": seq["ref_images"],
                 "flow_gt": at(flow_gt, t), "conf_gt": at(conf_gt, t)}
        if prevs is None:
            prevs = init_prevs(cfg, batch)
        _sync(device)
        t0 = time.perf_counter()
        prevs, losses, visuals = step_fn(cfg, state, with_vae_noise(cfg, batch, vae_gen),
                                         prevs, StepFlags(warp_prev=warp_prev,
                                                          has_prev=has_prev),
                                         compute_dtype="float32")
        _sync(device)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        if t == 0:   # the first generation: the initial weights' forward
            torch.save(visuals["fake_image"].float().cpu(),
                       os.path.join(spec["work_dir"], f"fake{mesh.rank()}_{mesh.world()}.pt"))
        out["losses"].append({k: v.item() for k, v in losses.items()})
        out["digests"].append(state_digests(state))
        if t == len(STEPS) - 1:
            continue
        if mesh.is_initialized():
            if mesh.is_master():
                _save_state(state, _state_file(spec, t))
        elif os.path.exists(_state_file(spec, t)):
            _load_state(state, _state_file(spec, t), device)
    out["b2_launches_by_route"] = dict(cv.cost_volume_cuda.launches_by_route)
    return out


def _child(spec_path: str, rank_: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh.init(spec["backend"], spec["init_method"], spec["n_ranks"], rank_,
              timeout=datetime.timedelta(seconds=spec["timeout_s"]))
    try:
        device = mesh.rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        out = run_steps(spec, device)
        with open(os.path.join(spec["work_dir"], f"rank{rank_}.json"), "w") as f:
            json.dump(out, f)
        mesh.barrier()
    finally:
        mesh.destroy()


def run_ranks(spec: Dict, n_ranks: int, work_dir: str, deadline_s: float) -> List[Dict]:
    """Each rank a child process; their results in rank order.  Raises if a
    rank exits non-zero or the deadline passes (every rank is killed)."""
    spec = dict(spec, n_ranks=n_ranks, work_dir=work_dir,
                init_method=f"file://{os.path.join(work_dir, 'store')}")
    spec_path = os.path.join(work_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    logs, procs = [], []
    try:
        for r in range(n_ranks):
            logs.append(open(os.path.join(work_dir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "fsvid2vid_tpu_torch.parallel.dryrun", spec_path, str(r)],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env, cwd=work_dir))
        end = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = []
        for r in range(n_ranks):
            with open(os.path.join(work_dir, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (exit {codes[r]}):\n" + f.read()[-3000:])
        raise RuntimeError(f"data-parallel ranks failed or passed the {deadline_s} s "
                           "deadline:\n" + "\n".join(tails))
    results = []
    for r in range(n_ranks):
        with open(os.path.join(work_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def check_data_parallel(cfg_kwargs: Dict, n_ranks: int = 2, device: str = "cpu",
                        backend: str = "gloo", teacher: bool = False,
                        work_dir: Optional[str] = None, timeout_s: float = 120.0,
                        deadline_s: float = 600.0, image_tol: float = 1e-4) -> Dict:
    """A single-frame then a temporal f32 step over `n_ranks` ranks against
    the same steps in one process (this one), each from the same state,
    with the flow teacher's ground truth when `teacher`; every step's losses
    are held to `loss_tolerance`.  The first step's generated frames,
    made from the initial weights with the global batch's statistics and
    noise, must equal the one process's rows within `image_tol`.  Raises
    AssertionError on a frame or loss out of tolerance, a non-finite loss,
    or a tensor that differs between ranks; returns both runs' losses, ms
    per step and launches, and each loss's difference."""
    device_ = torch.device(device)
    spec = dict(cfg=cfg_kwargs, teacher=teacher, device=device, backend=backend,
                timeout_s=timeout_s, threads=max(1, torch.get_num_threads() // n_ranks))
    with tempfile.TemporaryDirectory(prefix="fsv_dp_", dir=work_dir) as tmp:
        ranks = run_ranks(spec, n_ranks, tmp, deadline_s)
        if device_.type == "cuda":
            saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            single = run_steps(dict(spec, work_dir=tmp), device_)
        finally:
            if device_.type == "cuda":
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        frames = [torch.load(os.path.join(tmp, f"fake{r}_{n_ranks}.pt")) for r in range(n_ranks)]
        want_frames = torch.load(os.path.join(tmp, "fake0_1.pt"))
    frame_err = (torch.cat(frames) - want_frames).abs().max().item()
    report = {"n_ranks": n_ranks, "device": device, "backend": backend,
              "single": single, "ranks": ranks,
              "frame_max_abs_diff": frame_err, "diff": []}
    if not frame_err <= image_tol:
        raise AssertionError(f"step 0: generated frames over {n_ranks} ranks differ from one "
                             f"process's by {frame_err} (tolerance {image_tol})")
    for t, want in enumerate(single["losses"]):
        got = ranks[0]["losses"][t]
        if set(got) != set(want):
            raise AssertionError(f"step {t}: losses {sorted(got)} != {sorted(want)}")
        for r in ranks[1:]:
            if r["losses"][t] != got:
                raise AssertionError(f"step {t}: rank {r['rank']} reports other losses "
                                     "than rank 0")
        diff = {}
        for k, a in want.items():
            b = got[k]
            if not (math.isfinite(a) and math.isfinite(b)):
                raise AssertionError(f"step {t}: loss {k} not finite ({b} over the ranks, "
                                     f"{a} in one process)")
            diff[k] = abs(a - b)
            if diff[k] > loss_tolerance(k, a):
                raise AssertionError(f"step {t}: loss {k} = {b} over {n_ranks} ranks, {a} "
                                     f"in one process (tolerance {loss_tolerance(k, a)})")
        report["diff"].append(diff)
        first = ranks[0]["digests"][t]
        for r in ranks[1:]:
            differ = [k for k, v in r["digests"][t].items() if first.get(k) != v]
            if differ or set(first) != set(r["digests"][t]):
                raise AssertionError(f"step {t}: rank {r['rank']} differs from rank 0 in "
                                     f"{len(differ)} tensors, e.g. {differ[:5]}")
    for r in [single] + ranks:
        r["n_tensors"] = len(r.pop("digests")[-1])
    return report


def dryrun_data_parallel(n_ranks: int = 2, device: str = "cpu", backend: str = "gloo",
                         work_dir: Optional[str] = None, timeout_s: float = 120.0,
                         deadline_s: float = 600.0, **overrides) -> Dict:
    """__graft_entry__.py's `dryrun_multichip` over processes: the tiny
    K = 2 face configuration (with `overrides` of its fields, e.g.
    step_mode='faithful', or lambda_kld=1 with use_label_ref='concat'), a
    single-frame and a temporal step, each held to JAX's tolerances; ranks
    bitwise equal after each."""
    return check_data_parallel(dryrun_config_kwargs(n_ranks, **overrides), n_ranks,
                               device, backend, work_dir=work_dir,
                               timeout_s=timeout_s, deadline_s=deadline_s)


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
