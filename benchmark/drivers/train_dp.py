"""Data-parallel training traffic: the training traffic of
benchmark/drivers/train.py (its sequences, trainer, feed, recorder, traced
segment, FLOP count, reference steps and comparison, reused by import) on
`ranks` processes, one per card, joined in a torch.distributed group
(NCCL on CUDA, gloo on the CPU), as the port's `cli.train` runs data
parallel (fsvid2vid_tpu_torch/parallel/mesh.py).

Rank 0 is the benchmark's own process; it starts ranks 1.. as children
(`python -m benchmark.drivers.train_dp <spec.json> <rank>`, the cell's
files in the spec) and meets them at tcp://localhost:<a free port>.  The
traffic's `config_fields.batch_size` is the global batch: every rank makes
its own rows of sequence i from (seed, rank, i), and the global batch is
the ranks' rows in rank order.  The window is rank 0's: after each
sequence rank 0 decides whether the window goes on and broadcasts that to
every rank before the next sequence.  The rate
counts the global batch's B x T frames a sequence; the trace, the
teacher's time, the memory and the FLOP (one rank's batch, so `mfu.train`
is one card's share) are rank 0's.

Correctness: set-up's first sequence is recorded on rank 0 as training's
(the losses, which the step averages over the ranks; the first gradients
and updates after the all-reduce); after step 3 every rank's parameters
are held against rank 0's (`rank_gap`: the largest |p_r - p_0| of any
leaf over that leaf's largest |p_0|; the ranks hold bitwise equal
parameters, so a sound run reads 0).  After the window every rank frees
its program and the children exit; then rank 0 leaves the group and the
reference (f32, TF32 off) takes the three steps at the global batch in one
process.  The teacher's flow and B2's first cost volume are compared on
rank 0's rows.

Faults (benchmark/cell_faults.py) reach every rank's process through the
environment (FAULT): "rank_skips_average" plants itself in the last rank,
training's faults (benchmark/faults.py TRAIN) in every rank.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional
from unittest import mock

from benchmark import faults
from benchmark.drivers import train
from benchmark.readings import Readings, Step
from benchmark.seeds import subseed

FAULT = "FSV_BENCH_DP_FAULT"          # the fault benchmark/cell_faults.py plants in the ranks
RANK_SKIPS_AVERAGE = "rank_skips_average"
TIMEOUT_S = 600.0                     # a collective that waits longer raises
ROOT = Path(__file__).resolve().parents[2]


class RankSequences(train.Sequences):
    """Rank `rank`'s rows of sequence i: training's sequences at the rank's
    share of the global batch, made from (seed, rank, i)."""

    def __init__(self, torch, cfg, traffic: dict, seed: int, device, rank: int):
        self.world = traffic["ranks"]
        if cfg.batch_size % self.world:
            raise ValueError(f"global batch {cfg.batch_size} over {self.world} ranks")
        super().__init__(torch, cfg.replace(batch_size=cfg.batch_size // self.world), traffic,
                         subseed(seed, "rank", rank), device)


class GlobalSequences:
    """Sequence i's global batch, as the reference takes it: every rank's
    rows in rank order."""

    def __init__(self, torch, cfg, traffic: dict, seed: int, device):
        self.torch = torch
        self.ranks = [RankSequences(torch, cfg, traffic, seed, device, r)
                      for r in range(traffic["ranks"])]

    def make(self, i: int) -> Dict:
        parts = [r.make(i) for r in self.ranks]
        return {k: self.torch.cat([p[k] for p in parts]) for k in parts[0]}


class RankFeed(train.Feed):
    """training's feed on every rank; after each sequence rank 0's decision
    whether the window goes on reaches every rank (a broadcast) before the
    next sequence."""

    def __init__(self, seqs, first: int, seconds: float, device):
        super().__init__(seqs, first, seconds)
        self.device = device

    def __iter__(self):
        import torch
        import torch.distributed as dist
        i = self.first
        nxt = self.seqs.make(i)
        self.start = last = time.perf_counter()
        while True:
            yield nxt
            now = time.perf_counter()
            self.steps.append(Step(last, now, self.seqs.world * self.seqs.b * self.seqs.t))
            go = torch.tensor([float(now - self.start < self.seconds)], device=self.device)
            dist.broadcast(go, 0)
            if not go.item():
                return
            i, last = i + 1, now
            nxt = self.seqs.make(i)


class RankGap:
    """Wraps a step function: after the CHECKED_STEPS-th step, every rank's
    parameters against rank 0's, the worst over the ranks (`gap`, the same
    on every rank)."""

    def __init__(self, step_fn, bundle):
        self.step_fn, self.bundle, self.calls, self.gap = step_fn, bundle, 0, None

    def __call__(self, *args, **kw):
        out = self.step_fn(*args, **kw)
        self.calls += 1
        if self.calls == train.CHECKED_STEPS:
            self.gap = rank_gap(self.bundle)
        return out


def rank_gap(bundle) -> float:
    import torch
    import torch.distributed as dist
    gaps = []
    with torch.no_grad():
        for p in train.named_parameters(bundle).values():
            rank0 = p.detach().clone()
            dist.broadcast(rank0, 0)
            gaps.append(((p - rank0).abs().max() / rank0.abs().max().clamp(min=1e-30)).float())
        worst = torch.stack(gaps).max().reshape(1)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return worst.item()


def planted_fault(rank: int, world: int):
    """The fault the environment names, in this rank's process."""
    name = os.environ.get(FAULT)
    if name == RANK_SKIPS_AVERAGE:
        return own_gradients_kept() if rank == world - 1 else contextlib.nullcontext()
    if name:
        return faults.planted("train", name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def own_gradients_kept():
    """The fault: this rank takes part in the gradient all-reduce but keeps
    its own gradients."""
    import torch
    from fsvid2vid_tpu_torch.parallel import mesh
    reduce = mesh.all_reduce_grads

    def keeps_own(params):
        params = list(params)
        own = [None if p.grad is None else p.grad.clone() for p in params]
        reduce(params)
        with torch.no_grad():
            for p, g in zip(params, own):
                if g is not None:
                    p.grad.copy_(g)
    mesh.all_reduce_grads = keeps_own
    try:
        yield
    finally:
        mesh.all_reduce_grads = reduce


# ----------------------------------------------------------------------
# what every rank runs
# ----------------------------------------------------------------------
def join(device, init_method: str, world: int, rank: int):
    import datetime
    import torch
    from fsvid2vid_tpu_torch.parallel import mesh
    mesh.init(mesh.backend_for(device), init_method, world, rank,
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))


def all_reduce_bytes() -> Optional[int]:
    """The port's count of the gradients' all-reduced bytes, or None where
    it keeps none."""
    from fsvid2vid_tpu_torch.parallel import mesh
    return getattr(mesh.all_reduce_grads, "bytes", None)


def leave() -> None:
    """Every rank leaves the group together: NCCL's teardown waits for the
    other ranks, so rank 0 leaves before it waits for the children to
    exit."""
    from fsvid2vid_tpu_torch.parallel import mesh
    mesh.barrier()
    mesh.destroy()


def train_rank(run, rank: int, world: int) -> Dict:
    """The program on this rank, built and run under the fault the
    environment names: set-up's sequences, the window, with `run.trace`
    rank 0's traced sequence (the others train it untraced); returns what
    rank 0 reports, the program freed."""
    with planted_fault(rank, world):
        return _train_rank(run, rank, world)


def _train_rank(run, rank: int, world: int) -> Dict:
    torch, traffic = run.torch, run.traffic
    cfg, ref_cfg, trainer, teacher, recorder = train.program(run)
    gap = RankGap(trainer.step_fn, recorder.bundle)
    trainer.step_fn = gap
    seqs = RankSequences(torch, cfg, traffic, run.seed, run.device, rank)
    epoch = train.epoch_of(cfg)
    with train.no_epoch_checkpoint():
        with recorder.cost_volume(train.port_flownet2()):
            trainer.train_epoch(epoch, [seqs.make(i) for i in range(traffic["warmup_sequences"])],
                                teacher)
        run.synchronize()
        spans: Dict[str, List[float]] = {}
        feed = RankFeed(seqs, traffic["warmup_sequences"], run.seconds, run.device)
        trainer.train_epoch(epoch, feed, train.timed(run, teacher, spans)
                            if run.trace and rank == 0 else teacher)
        readings = Readings(setup_s=run.setup_s(feed.start), steps=feed.steps,
                            window_start=feed.start, window_end=feed.steps[-1].end,
                            spans=spans)
        index = traffic["warmup_sequences"] + len(feed.steps)
        if run.trace and rank == 0:
            before = all_reduce_bytes()
            readings.trace = train.traced_segment(run, trainer, teacher, seqs, epoch, index)
            readings.trace.counters["train_steps"] = seqs.t
            if before is not None:
                run.log(f"all_reduce_bytes_per_step {(all_reduce_bytes() - before) / seqs.t}")
        elif run.trace:
            trainer.train_epoch(epoch, [seqs.make(index)], teacher)
    out = dict(readings=readings, cfg=cfg, ref_cfg=ref_cfg, side=recorder.side(),
               rank_gap=gap.gap, memory_peak=run.memory_peak(),
               local_rows=seqs.b, frames=seqs.t)
    del trainer, teacher, recorder, gap
    gc.collect()
    run.empty_cache()
    return out


# ----------------------------------------------------------------------
# rank 0: the run
# ----------------------------------------------------------------------
def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_children(run, world: int, init_method: str, work: str) -> List[subprocess.Popen]:
    spec = dict(cell=run.cell, config=run.config, traffic=run.traffic, seed=run.seed,
                seconds=run.seconds, trace=run.trace, device=run.device.type, world=world,
                init_method=init_method, threads=run.torch.get_num_threads())
    path = os.path.join(work, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return [subprocess.Popen([sys.executable, "-m", "benchmark.drivers.train_dp", path, str(r)],
                             cwd=ROOT, stdout=2)
            for r in range(1, world)]


def wait_children(children: List[subprocess.Popen]) -> None:
    for p in children:
        try:
            rc = p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            for q in children:
                q.kill()
            raise RuntimeError(f"a data-parallel rank ended with {rc}")


def ranks_of(run) -> int:
    world = run.traffic["ranks"]
    if run.device.type == "cuda" and run.torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} CUDA devices")
    return world


def execute(run):
    return run_ranks(run)[0]


def run_ranks(run):
    """The run: the ranks' program, then the reference; returns the
    driver's result and the reference's recorded steps."""
    from fsvid2vid_tpu_torch.parallel import mesh
    torch = run.torch
    world = ranks_of(run)
    if run.device.type == "cuda" and run.device.index is None:
        run.device = torch.device("cuda", 0)
    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory() as work:
        children = start_children(run, world, init_method, work)
        try:
            join(run.device, init_method, world, 0)
            out = train_rank(run, 0, world)
            leave()
            wait_children(children)
        except BaseException:
            for p in children:
                p.kill()
            raise
        finally:
            mesh.destroy()
    readings = out["readings"]
    reference = global_reference(run, out["ref_cfg"])
    if run.trace:
        readings.flops = train.count_flops(
            torch, out["ref_cfg"].replace(batch_size=out["local_rows"]), run.traffic)
    rows = lambda ref: on_rows(ref, out["local_rows"], out["frames"])
    compared = train.compare(out["side"], rows(reference))
    compared["rank_gap"] = float("inf") if out["rank_gap"] is None else out["rank_gap"]
    result = dict(readings=readings, attempted=sum(s.frames for s in readings.steps),
                  failed=train.non_finite(out["side"]), memory_peak_bytes=out["memory_peak"],
                  compared=compared, checked=train.CHECKED_STEPS * out["cfg"].batch_size)
    return result, reference, out["ref_cfg"]


def global_reference(run, ref_cfg, mode=None) -> Dict:
    """The reference's steps (train.reference_steps) on the global batch."""
    with mock.patch.object(train, "Sequences", GlobalSequences):
        return train.reference_steps(run, ref_cfg, mode=mode)


def on_rows(reference: Dict, rows: int, frames: int) -> Dict:
    """The reference's teacher flow and first cost volume cut to rank 0's
    rows (its samples, and their frames in the teacher's flattened batch)."""
    cut = dict(reference)
    if reference["flow"] is not None:
        cut["flow"] = [None if f is None else f[:rows] for f in reference["flow"]]
    if reference["corr"] is not None:
        cut["corr"] = reference["corr"][:rows * frames]
    return cut


def control(run, fp8: bool = True) -> Dict[str, Dict[str, float]]:
    """The correctness readings at the cell's size (benchmark/control.py):
    a run's set-up and one window sequence on every rank against the f32
    reference and, with `fp8`, the reference in fp8 against it."""
    from benchmark.precision import Fp8Operands
    run.seconds = 0.0
    result, f32, ref_cfg = run_ranks(run)
    out = {"program": result["compared"]}
    if fp8:
        out["control"] = train.compare(global_reference(run, ref_cfg, Fp8Operands()), f32)
    return out


def exit_with_parent(poll_s: float = 5.0) -> None:
    """End this process when the process that started it (rank 0) is gone,
    so that a rank 0 killed mid-run leaves no rank holding a card."""
    import threading
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(poll_s)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def child(spec_path: str, rank: int) -> int:
    """A rank other than 0: its part of the run, then exit."""
    import torch
    exit_with_parent()
    from benchmark.run import Run
    from fsvid2vid_tpu_torch.parallel import mesh
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    device = torch.device("cuda", rank) if spec["device"] == "cuda" else torch.device("cpu")
    run = Run(torch=torch, device=device, cell=spec["cell"], config=spec["config"],
              traffic=spec["traffic"], seed=spec["seed"], seconds=spec["seconds"],
              trace=spec["trace"], started=time.time())
    join(device, spec["init_method"], spec["world"], rank)
    try:
        train_rank(run, rank, spec["world"])
        leave()
    finally:
        mesh.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[1], int(sys.argv[2])))
