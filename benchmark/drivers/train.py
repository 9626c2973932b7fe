"""Training traffic: temporal training through the port's
`Trainer.train_epoch` (fsvid2vid_tpu_torch/training/trainer.py) at the
traffic's per-GPU batch and sequence length, with the FlowNet2 teacher; the
loader is bypassed: each sequence is made on the card from (seed, index)
when the trainer asks for it.

A sequence is B samples of T frames, each sample with K references, made
as the serving traffic's clips are (benchmark/inputs.py): label maps
(`labels`: gaussian smooth maps plus `noise`, or `regions` of `classes`
classes) and images (tanh of smooth maps on a grid of `image_cells`); each
sample follows one of its references, its label and image moved by the
traffic's "motion" at every frame, so that the teacher has motion to
estimate.

The epoch is the first of the temporal phase (niter_single + 1), so the
trainer copies the temporal flow network and embedding at the transition
and warps the previous frames.  Set-up trains the first `warmup_sequences`
sequences through the same call and feed as the window; the window trains
further sequences until `seconds` have passed, whole sequences, and its
rate counts B x T frames a sequence.  The trainer's end-of-epoch
checkpoint is not written: it falls outside the window and would write
gigabytes to disk in every run.

Correctness: set-up's first sequence is recorded (the first cost volume
that kernel B2 makes for the teacher, and the teacher's flow; the losses of the first three per-frame steps, the first gradient of every
parameter as Adam holds it after step 1, each parameter's update in step 1
and its change after step 3); after the window, with the program freed,
the reference (benchmark/reference, f32, TF32 off) takes the same three
steps from the same weights and sequence, teacher included.
"""
from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Dict, List, Optional
from unittest import mock

from benchmark import inputs, weights
from benchmark.readings import Readings, Step
from benchmark.seeds import subseed

CHECKED_STEPS = 3
# leaves whose reference gradient is below this share of the median leaf's
# move under Adam by round-off alone: left out of the change's comparison
STILL_LEAF = 1e-3
NETS = ("netG", "netGf", "netD", "netDT", "netDf")
# generator losses that no discriminator takes part in: step 1's are taken
# before any update reaches them (VGG19, the teacher's flow, the warps)
G_ALONE = ("G_VGG", "F_Flow", "F_Warp", "F_Mask", "G_KLD")


def configs(run):
    from fsvid2vid_tpu_torch.config import preset
    from benchmark.reference.config import preset as ref_preset
    fields = dict(run.config["fields"], **run.traffic["config_fields"])
    cfg = preset(run.config["preset"], **fields)
    return cfg, ref_preset(run.config["preset"], **dict(fields, compute_dtype="float32"))


def epoch_of(cfg) -> int:
    """The temporal phase's first epoch."""
    return cfg.niter_single + 1


# ----------------------------------------------------------------------
# weights and inputs
# ----------------------------------------------------------------------
def fill_models(bundle, seed: int, gain: float):
    for name in NETS:
        net = getattr(bundle, name, None)
        if net is not None:
            weights.fill(net, subseed(seed, name), gain=gain)
    if bundle.vgg is not None:
        weights.fill(bundle.vgg, subseed(seed, "vgg"), plain=True)
    return bundle


def program_models(torch, cfg, seed: int, device):
    """The port's own builder, its CPU initialisation skipped: every tensor
    is filled on the card from the seed instead."""
    import fsvid2vid_tpu_torch.training.state as st
    with mock.patch.object(st, "init_weights", lambda net, generator, gain: net), \
            mock.patch.object(st, "init_plain_convs", lambda net, generator: net):
        bundle = st.build_models(cfg, device=device, generator=torch.Generator())
    return fill_models(bundle, seed, cfg.init_variance)


def flownet_state(torch, seed: int, device, make):
    with torch.device("meta"):
        net = make()
    net = weights.fill(net.to_empty(device=device), subseed(seed, "flownet"), plain=True)
    return net


class Sequences:
    """Sequence i's batch for the trainer, made on the device from (seed, i)."""

    def __init__(self, torch, cfg, traffic: dict, seed: int, device):
        self.torch, self.traffic, self.seed, self.device = torch, traffic, seed, device
        self.b, self.k = cfg.batch_size, cfg.n_shot
        self.h, self.w = cfg.height, cfg.width
        self.t = traffic["frames"]
        self.cl = 1 if cfg.label_nc > 0 else cfg.input_nc

    def make(self, i: int) -> Dict:
        torch, spec, motion = self.torch, self.traffic["labels"], self.traffic["motion"]
        g = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "sequence", i))
        b, k, h, w, t = self.b, self.k, self.h, self.w, self.t
        fav = torch.randint(k, (b,), device=self.device, generator=g)
        rows = torch.arange(b, device=self.device)
        if spec["kind"] == "gaussian":
            ref_labels = inputs.smooth(torch, g, b * k, self.cl, h, w, spec["cells"])
        elif spec["kind"] == "regions":
            ref_labels = inputs.classes(torch, g, b * k, h, w, spec["classes"], spec["cells"])
        else:
            raise ValueError(f"labels kind {spec['kind']!r}")
        ref_labels = ref_labels.view(b, k, h, w, -1)
        ref_images = torch.tanh(inputs.smooth(torch, g, b * k, 3, h, w,
                                              self.traffic["image_cells"])).view(b, k, h, w, 3)
        moving = lambda x: torch.stack([inputs.moved(torch, x, j, motion) for j in range(t)], 1)
        tgt_label = moving(ref_labels[rows, fav])
        if spec["kind"] == "gaussian":
            tgt_label = tgt_label + spec["noise"] * torch.randn(
                tgt_label.shape, device=self.device, generator=g)
        return {"tgt_label": tgt_label.contiguous(),
                "tgt_image": moving(ref_images[rows, fav]).contiguous(),
                "ref_labels": ref_labels, "ref_images": ref_images}


# ----------------------------------------------------------------------
# recording the first steps
# ----------------------------------------------------------------------
def named_parameters(bundle) -> Dict[str, object]:
    out = {}
    for name in NETS:
        net = getattr(bundle, name, None)
        if net is not None:
            out.update({f"{name}.{n}": p for n, p in net.named_parameters()})
    return out


def first_gradients(state, params: Dict) -> Dict[str, float]:
    """Each parameter's gradient norm as Adam holds it after its first step:
    exp_avg = (1 - beta1) g."""
    by_param = {}
    for opt in (state.opt_G, state.opt_D):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p)
                if st and "exp_avg" in st:
                    by_param[p] = (st["exp_avg"].float().norm() / (1 - group["betas"][0])).item()
    return {n: by_param[p] for n, p in params.items() if p in by_param}


class StepRecorder:
    """Wraps a step function: records the losses of the first three steps,
    the first gradients and every parameter's update (on the host) after
    step 1 and every parameter's change after step 3, then steps aside;
    `teacher(t)` wraps a teacher so that its first call's flow is recorded,
    and inside `cost_volume(flownet2)` the first cost volume that module's
    FlowNetC takes is (both on the host)."""

    def __init__(self, step_fn, bundle):
        self.step_fn, self.bundle = step_fn, bundle
        self.losses: List[Dict[str, float]] = []
        self.grads: Dict[str, float] = {}
        self.first_updates: Dict[str, object] = {}
        self.changes: Dict[str, float] = {}
        self.flow: Optional[List] = None
        self.corr = None
        self.start = None

    def teacher(self, teacher):
        def call(cfg, seq, epoch):
            flow, conf = teacher(cfg, seq, epoch)
            if self.flow is None:
                self.flow = [None if f is None else f.detach().float().cpu() for f in flow]
            return flow, conf
        return call

    @contextlib.contextmanager
    def cost_volume(self, flownet2):
        correlation = flownet2.correlation

        def call(*args, **kw):
            out = correlation(*args, **kw)
            if self.corr is None:
                self.corr = out.detach().float().cpu()
            return out
        with mock.patch.object(flownet2, "correlation", call):
            yield

    def __call__(self, cfg, state, batch, prevs, flags, **kw):
        params = named_parameters(self.bundle)
        if self.start is None:
            self.start = {n: p.detach().clone() for n, p in params.items()}
        out = self.step_fn(cfg, state, batch, prevs, flags, **kw)
        if len(self.losses) < CHECKED_STEPS:
            self.record(len(self.losses), {k: v.item() for k, v in out[1].items()},
                        state, params)
        return out

    def record(self, t: int, losses: Dict[str, float], state, params: Dict):
        """After step t (0-based): its losses; after the first, the first
        gradients and each parameter's change; after the third, the change."""
        self.losses.append(losses)
        delta = lambda n, p: (p.detach() - self.start[n]).float()
        if t == 0:
            self.grads = first_gradients(state, params)
            self.first_updates = {n: delta(n, p).cpu() for n, p in params.items()}
        if t == CHECKED_STEPS - 1:
            self.changes = {n: delta(n, p).norm().item() for n, p in params.items()}
            self.start = None

    def side(self) -> Dict:
        return {"losses": self.losses, "grads": self.grads, "flow": self.flow,
                "corr": self.corr, "first_updates": self.first_updates, "changes": self.changes}


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------
def program(run):
    """The port's trainer and teacher at the cell's configuration, the
    trainer's step function wrapped by a StepRecorder."""
    from fsvid2vid_tpu_torch.models.flownet.flownet2 import FlowNet2
    from fsvid2vid_tpu_torch.training.flow_teacher import FlowTeacher
    from fsvid2vid_tpu_torch.training.trainer import Trainer
    torch, device = run.torch, run.device
    cfg, ref_cfg = configs(run)
    bundle = program_models(torch, cfg, run.seed, device)
    teacher = None
    if not cfg.no_flow_gt:
        flownet = flownet_state(torch, run.seed, device, FlowNet2)
        teacher = FlowTeacher(cfg, device=device, state_dict=flownet.state_dict())
        del flownet
    trainer = Trainer(cfg, models=bundle, log_fn=lambda msg: None, device=device)
    trainer.setup()
    recorder = StepRecorder(trainer.step_fn, bundle)
    trainer.step_fn = recorder
    if teacher is not None:
        teacher = recorder.teacher(teacher)
    return cfg, ref_cfg, trainer, teacher, recorder


def port_flownet2():
    import fsvid2vid_tpu_torch.models.flownet.flownet2 as flownet2
    return flownet2


@contextlib.contextmanager
def no_epoch_checkpoint():
    import fsvid2vid_tpu_torch.training.checkpoint as ckpt
    with mock.patch.object(ckpt, "save_epoch", lambda *a, **k: None), \
            mock.patch.object(ckpt, "save", lambda *a, **k: None):
        yield


class Feed:
    """The window's sequences: the trainer asks for the next one when it
    has finished the last (its losses are then on the host); past `seconds`
    the feed ends.  Each boundary closes a step of B x T frames."""

    def __init__(self, seqs: Sequences, first: int, seconds: float):
        self.seqs, self.first, self.seconds = seqs, first, seconds
        self.steps: List[Step] = []
        self.start: Optional[float] = None

    def __iter__(self):
        i = self.first
        nxt = self.seqs.make(i)
        self.start = last = time.perf_counter()
        while True:
            yield nxt
            now = time.perf_counter()
            self.steps.append(Step(last, now, self.seqs.b * self.seqs.t))
            if now - self.start >= self.seconds:
                return
            i, last = i + 1, now
            nxt = self.seqs.make(i)


def execute(run):
    torch, traffic = run.torch, run.traffic
    cfg, ref_cfg, trainer, teacher, recorder = program(run)
    seqs = Sequences(torch, cfg, traffic, run.seed, run.device)
    epoch = epoch_of(cfg)
    with no_epoch_checkpoint():
        with recorder.cost_volume(port_flownet2()):
            trainer.train_epoch(epoch, [seqs.make(i) for i in range(traffic["warmup_sequences"])],
                                teacher)
        run.synchronize()
        spans: Dict[str, List[float]] = {}
        feed = Feed(seqs, traffic["warmup_sequences"], run.seconds)
        trainer.train_epoch(epoch, feed, timed(run, teacher, spans) if run.trace else teacher)
        readings = Readings(setup_s=run.setup_s(feed.start), steps=feed.steps,
                            window_start=feed.start, window_end=feed.steps[-1].end,
                            spans=spans)
        if run.trace:
            readings.trace = traced_segment(run, trainer, teacher, seqs, epoch,
                                            traffic["warmup_sequences"] + len(feed.steps))
    memory_peak = run.memory_peak()
    attempted = sum(s.frames for s in readings.steps)
    program_side = recorder.side()
    del trainer, teacher, recorder
    gc.collect()
    run.empty_cache()
    reference = reference_steps(run, ref_cfg)
    if run.trace:
        readings.flops = count_flops(torch, ref_cfg, traffic)
    return dict(readings=readings, attempted=attempted, failed=non_finite(program_side),
                memory_peak_bytes=memory_peak, compared=compare(program_side, reference),
                checked=CHECKED_STEPS * cfg.batch_size)


def non_finite(side) -> int:
    """Checked steps whose losses are not all finite."""
    return sum(not all(v == v and abs(v) != float("inf") for v in step.values())
               for step in side["losses"])


def timed(run, teacher, spans):
    """The teacher with a synchronise after each call, its host-clock ms in
    spans["teacher_ms"] (traced run only)."""
    def call(cfg, seq, epoch):
        t0 = time.perf_counter()
        out = teacher(cfg, seq, epoch)
        run.synchronize()
        spans.setdefault("teacher_ms", []).append(1e3 * (time.perf_counter() - t0))
        return out
    return call


def traced_segment(run, trainer, teacher, seqs: Sequences, epoch: int, index: int):
    """One more sequence under the profiler, the B2 launches' shapes
    recorded."""
    from fsvid2vid_tpu_torch.ops import cost_volume as cv
    from benchmark.tracing import Tracer
    launch = cv._launch_tc
    seq = seqs.make(index)
    with Tracer(run.torch, host_ops=run.traffic["trace"].get("host_ops", True)) as tr:
        def recorded(f1, f2, md, stride):
            tr.counters.setdefault("b2_calls", []).append(
                [list(f1.shape), md, stride, f1.element_size()])
            return launch(f1, f2, md, stride)
        with mock.patch.object(cv, "_launch_tc", recorded):
            trainer.train_epoch(epoch, [seq], teacher)
    return tr.summary


def count_flops(torch, ref_cfg, traffic: dict) -> Dict[str, float]:
    """FLOP of the reference's teacher call for a sequence and of its train
    step (forward, backward, both updates) at a sequence's first frame and
    at a later one, at the cell's shapes (FlopCounterMode on fake tensors:
    nothing runs; after the check, so that the window does not pay for
    the garbage the fake tensors leave)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference.training.flow_teacher import FlowTeacher
    from benchmark.reference.training.state import TrainState, build_models
    from benchmark.reference.training.step import StepFlags, init_prevs, train_step
    out = {}
    with FakeTensorMode():
        seqs = Sequences(torch, ref_cfg, traffic, 0, torch.device("cpu"))
        b, t, k, h, w, cl = seqs.b, seqs.t, seqs.k, seqs.h, seqs.w, seqs.cl
        seq = {"tgt_label": torch.zeros(b, t, h, w, cl), "tgt_image": torch.zeros(b, t, h, w, 3),
               "ref_labels": torch.zeros(b, k, h, w, cl), "ref_images": torch.zeros(b, k, h, w, 3)}
        state = TrainState(ref_cfg, build_models(ref_cfg, None))
        flow, conf = [None, None], [None, None]
        if not ref_cfg.no_flow_gt:
            with FlopCounterMode(display=False) as fc:
                flow, conf = FlowTeacher(None)(ref_cfg, seq, epoch_of(ref_cfg))
            out["teacher"] = float(fc.get_total_flops())
        at = lambda xs: [None if x is None else x[:, 0] for x in xs]
        batch = {"tgt_label": seq["tgt_label"][:, 0], "tgt_image": seq["tgt_image"][:, 0],
                 "ref_labels": seq["ref_labels"], "ref_images": seq["ref_images"],
                 "flow_gt": at(flow), "conf_gt": at(conf)}
        prevs = init_prevs(ref_cfg, batch)
        for kind, has_prev in (("first", False), ("step", True)):
            with FlopCounterMode(display=False) as fc:
                prevs, _, _ = train_step(ref_cfg, state, batch, prevs,
                                         StepFlags(warp_prev=True, has_prev=has_prev))
            out[kind] = float(fc.get_total_flops())
    out["sequence"] = out.get("teacher", 0.0) + out["first"] + (seqs.t - 1) * out["step"]
    return out


# ----------------------------------------------------------------------
# correctness
# ----------------------------------------------------------------------
def reference_steps(run, ref_cfg, mode=None) -> Dict:
    """The reference's first three steps from the program's starting
    weights on sequence 0, recorded as the program's are; `mode` (a
    TorchFunctionMode) computes them in another precision."""
    from benchmark.reference.models.flownet import flownet2
    from benchmark.reference.training.flow_teacher import FlowTeacher
    from benchmark.reference.training.loop import copy_temporal_params, run_sequence
    from benchmark.reference.training.state import TrainState, build_models
    from benchmark.precision import no_tf32
    torch, device = run.torch, run.device
    bundle = fill_models(build_models(ref_cfg, device), run.seed, ref_cfg.init_variance)
    teacher = None
    if not ref_cfg.no_flow_gt:
        teacher = FlowTeacher(device)
        teacher.model.load_state_dict(
            flownet_state(torch, run.seed, device, flownet2.FlowNet2).state_dict())
    copy_temporal_params(ref_cfg, bundle)
    state = TrainState(ref_cfg, bundle)
    recorder = StepRecorder(None, bundle)
    recorder.start = {n: p.detach().clone() for n, p in named_parameters(bundle).items()}
    seq = Sequences(torch, ref_cfg, run.traffic, run.seed, device).make(0)
    params = named_parameters(bundle)

    def after_step(t, losses):
        recorder.record(t, {k: v.item() for k, v in losses.items()}, state, params)

    if teacher is not None:
        teacher = recorder.teacher(teacher)
    with no_tf32(torch), (mode or contextlib.nullcontext()), recorder.cost_volume(flownet2):
        run_sequence(ref_cfg, state, seq, epoch_of(ref_cfg), teacher, CHECKED_STEPS,
                     after_step)
    out = recorder.side()
    del bundle, teacher, state, recorder
    gc.collect()
    run.empty_cache()
    return out


def compare(side: Dict, ref: Dict) -> Dict[str, float]:
    """Gaps of the program's recorded steps (`side`) from the reference's.
    Gaps of values are relative to the reference: the larger of its own
    size and the median's is the denominator.
      loss_gap.step<i>   step i's worst loss, against the median |loss|;
      loss_gap.D1        step 1's worst discriminator loss (taken before any
                         update, as D's gradient is);
      loss_gap.G1        step 1's worst generator loss of G_ALONE (VGG19,
                         the teacher's flow, the warps, the masks: taken
                         before any update reaches them);
      grad_gap.G / .D    the worst leaf's first gradient norm, against the
                         median leaf's (G's is taken through the D that step
                         1 has just updated, D's on the starting weights);
      direction_gap.G / .D
                         1 - the cosine between the program's step-1 update
                         of the net's leaves (all of them as one vector) and
                         the reference's, over the leaves whose reference
                         gradient is at least STILL_LEAF of the median
                         leaf's (0: the same direction; 1: no update or an
                         unrelated one; 2: the opposite);
      direction_gap.leaf_median
                         the median leaf's 1 - cosine, over those leaves;
      change_gap         the worst of those leaves' change after step 3,
                         against the median leaf's change; .median: the
                         median leaf's gap;
      teacher_gap        the teacher's flow on the first sequence: the sum
                         of absolute gaps over the sum of the reference's
                         absolute values;
      b2_gap             likewise, the first cost volume (kernel B2's
                         output) that the teacher's FlowNetC takes."""
    inf = float("inf")
    keys = ([f"loss_gap.step{i + 1}" for i in range(CHECKED_STEPS)]
            + ["loss_gap.D1", "loss_gap.G1", "grad_gap.G", "grad_gap.D", "direction_gap.G",
               "direction_gap.D", "direction_gap.leaf_median", "change_gap",
               "change_gap.median", "teacher_gap", "b2_gap"])
    if len(side["losses"]) < CHECKED_STEPS or len(ref["losses"]) < CHECKED_STEPS:
        return dict.fromkeys(keys, inf)
    out = {}
    for i, (s, r) in enumerate(zip(side["losses"], ref["losses"])):
        floor = statistics.median(abs(v) for v in r.values())
        out[f"loss_gap.step{i + 1}"] = max(_gap(s.get(k, inf), v, floor) for k, v in r.items())
        if i == 0:
            for name, keep in (("D1", lambda k: k.startswith("D")),
                               ("G1", lambda k: k in G_ALONE)):
                out[f"loss_gap.{name}"] = max(
                    [_gap(s.get(k, inf), v, floor) for k, v in r.items() if keep(k)],
                    default=0.0)
    g_floor = statistics.median(ref["grads"].values())
    moving = [n for n, rv in ref["grads"].items() if rv >= STILL_LEAF * g_floor]
    leaf_gaps = {n: _direction_gap([side["first_updates"].get(n)],
                                   [ref["first_updates"][n]]) for n in moving}
    for net in ("G", "D"):
        leaves = [n for n in ref["grads"] if _net(n).startswith(net)]
        out[f"grad_gap.{net}"] = max(_gap(side["grads"].get(n, inf), ref["grads"][n], g_floor)
                                     for n in leaves)
        mine = [n for n in moving if _net(n).startswith(net)]
        out[f"direction_gap.{net}"] = _direction_gap(
            [side["first_updates"].get(n) for n in mine],
            [ref["first_updates"][n] for n in mine])
    out["direction_gap.leaf_median"] = statistics.median(leaf_gaps.values())
    c_floor = statistics.median(ref["changes"][n] for n in moving)
    gaps = [_gap(side["changes"].get(n, inf), ref["changes"][n], c_floor) for n in moving]
    out["change_gap"], out["change_gap.median"] = max(gaps), statistics.median(gaps)
    out["teacher_gap"] = _flow_gap(side["flow"], ref["flow"])
    out["b2_gap"] = _flow_gap([side["corr"]], None if ref["corr"] is None else [ref["corr"]])
    return out


def _net(leaf: str) -> str:
    """"G", "Gf", "D", "DT" or "Df" of a leaf named netG.<...>."""
    return leaf.split(".")[0][3:]


def _direction_gap(mine: List, ref: List) -> float:
    """1 - the cosine between the concatenations of `mine` and `ref`; a
    missing or all-zero `mine` reads 1."""
    dot = norm_m = norm_r = 0.0
    for m, r in zip(mine, ref):
        r = r.double()
        norm_r += float(r.pow(2).sum())
        if m is None:
            continue
        m = m.double()
        dot += float((m * r).sum())
        norm_m += float(m.pow(2).sum())
    if not (norm_m > 0 and norm_r > 0) or dot != dot:
        return 1.0 if dot == dot else float("inf")
    return 1.0 - dot / (norm_m * norm_r) ** 0.5


def _flow_gap(mine: Optional[List], ref: Optional[List]) -> float:
    """The sum of |mine - ref| over the sum of |ref|, over the entries that
    `ref` holds; 0 where there is no `ref`."""
    if ref is None:
        return 0.0
    if mine is None:
        return float("inf")
    num = den = 0.0
    for m, r in zip(mine, ref):
        if r is None:
            continue
        if m is None:
            return float("inf")
        num += float((m.double() - r.double()).abs().sum())
        den += float(r.double().abs().sum())
    if num != num or abs(num) == float("inf"):
        return float("inf")
    return num / max(den, 1e-30)


def _gap(value: float, ref: float, floor: float) -> float:
    if value != value or abs(value) == float("inf"):
        return float("inf")
    return abs(value - ref) / max(abs(ref), floor, 1e-30)


def control(run, fp8: bool = True) -> Dict[str, Dict[str, float]]:
    """Readings for the correctness limits at the cell's size: the program's
    first three steps as a run's set-up takes them, and the reference's in f32 and,
    as the control (with `fp8`), in fp8 (benchmark/precision.py), each
    compared with the f32 reference."""
    from benchmark.precision import Fp8Operands
    torch = run.torch
    cfg, ref_cfg, trainer, teacher, recorder = program(run)
    seqs = Sequences(torch, cfg, run.traffic, run.seed, run.device)
    with no_epoch_checkpoint(), recorder.cost_volume(port_flownet2()):
        trainer.train_epoch(epoch_of(cfg), [seqs.make(0)], teacher)
    side = recorder.side()
    del trainer, teacher, recorder
    gc.collect()
    run.empty_cache()
    f32 = reference_steps(run, ref_cfg)
    out = {"program": compare(side, f32)}
    if fp8:
        out["control"] = compare(reference_steps(run, ref_cfg, mode=Fp8Operands()), f32)
    return out
