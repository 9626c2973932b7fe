"""The port's spans (fsvid2vid_tpu_torch/utils/profiling.py `span`) on the
CPU, at tiny sizes: off by default, on under torch.profiler or
`record(True)`, nested by thread, on the profiler's own clock; the spans
of the trainer, the step, the pipeline and the generator; none in an
exported serving program; kernel B2 as the registered operator
fsv::cost_volume; and the benchmark's readers of the spans
(benchmark/metrics/*_ms.*.py) on synthetic spans and on none."""
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.readings import Readings, Step
from benchmark.registry import Registry
from benchmark.run import ROOT
from benchmark.tracing import HostOp, TraceSummary
from fsvid2vid_tpu_torch.config import face_config
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
from fsvid2vid_tpu_torch.inference.serve import PROGRAMS, export_serving
from fsvid2vid_tpu_torch.models import build_generator
from fsvid2vid_tpu_torch.ops import cost_volume as cv
from fsvid2vid_tpu_torch.training.trainer import Trainer
from fsvid2vid_tpu_torch.utils import profiling
from fsvid2vid_tpu_torch.utils.profiling import SpanRecord
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)

SIZE = 32
TINY = dict(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
            n_downsample_G=3, n_adaptive_layers=2, compute_dtype="float32")
STEP_PHASES = ["fsv.train.generate", "fsv.train.d_losses", "fsv.train.update_D",
               "fsv.train.g_losses", "fsv.train.update_G", "fsv.train.finish"]
SERVE_READERS = ("gen_weights_ms.serve", "gen_flow_ms.serve", "gen_main_ms.serve")
TRAIN_READERS = ("step_host_ms.train", "update_host_ms.train", "forward_host_ms.train")


@pytest.fixture(autouse=True)
def empty_recorder():
    """Each test starts and ends with recording off and no records."""
    profiling.record(False)
    profiling.clear()
    yield
    profiling.record(False)
    profiling.clear()


def children(records, i):
    return [r.name for r in records if r.parent == i]


def index_of(records, name, n=0):
    return [i for i, r in enumerate(records) if r.name == name][n]


def test_off_is_one_shared_noop_and_records_nothing():
    first, second = profiling.span("fsv.a"), profiling.span("fsv.b")
    assert first is second
    with first:
        torch.ones(3).sum()
    assert profiling.spans() == []


def test_spans_nest_under_the_profiler_on_its_clock():
    """Parents by thread, a user annotation of the profiler's per span, and
    the recorder's start within 1 ms of the profiler's on its clock
    (kineto_results.trace_start_ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("fsv.outer"):
            with profiling.span("fsv.inner"):
                torch.ones(64).sum()
            with profiling.span("fsv.inner2"):
                torch.ones(64).sum()
    records = profiling.spans()
    assert [(r.name, r.parent) for r in records] == [
        ("fsv.outer", -1), ("fsv.inner", 0), ("fsv.inner2", 0)]
    assert all(r.start_ns < r.end_ns for r in records)
    assert records[0].start_ns <= records[1].start_ns < records[1].end_ns <= records[2].start_ns
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("fsv.")}
    assert set(events) == {"fsv.outer", "fsv.inner", "fsv.inner2"}
    for r in records:
        e = events[r.name]
        assert getattr(e, "is_user_annotation", True)
        assert abs((r.start_ns - origin) / 1e3 - e.time_range.start) < 1e3
        assert abs((r.end_ns - origin) / 1e3 - e.time_range.end) < 1e3


def test_record_turns_spans_on_without_a_profiler_and_per_thread():
    import threading
    assert profiling.record(True) is False
    with profiling.span("fsv.main"):
        t = threading.Thread(target=lambda: profiling.span("fsv.other").__enter__().__exit__(
            None, None, None))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert profiling.record(False) is True
    with profiling.span("fsv.off"):
        pass
    by_name = {r.name: r for r in profiling.spans()}
    assert set(by_name) == {"fsv.main", "fsv.other"}
    assert by_name["fsv.other"].parent == -1     # another thread's root


def test_self_ms_leaves_out_what_children_cover(monkeypatch):
    ms = 1_000_000
    monkeypatch.setattr(profiling, "_records", [
        SpanRecord("p", -1, 0, 10 * ms), SpanRecord("c", 0, 1 * ms, 4 * ms),
        SpanRecord("c", 0, 3 * ms, 6 * ms), SpanRecord("g", 1, 2 * ms, 3 * ms),
        SpanRecord("p", -1, 20 * ms, 22 * ms)])
    assert profiling.self_ms("p") == pytest.approx([5.0, 2.0])
    assert profiling.self_ms("c") == pytest.approx([2.0, 3.0])


# ----------------------------------------------------------------------
# the program's spans
# ----------------------------------------------------------------------
def stub_teacher(cfg, seq, epoch):
    img = seq["tgt_image"]
    flow, conf = 3 * img[..., :2], (img[..., :1] > 0).float()
    return [flow, 2 * flow], [conf, conf]


def sequence(t, rng):
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(tgt_label=mk(1, t, SIZE, SIZE, 1), tgt_image=np.tanh(mk(1, t, SIZE, SIZE, 3)),
                ref_labels=mk(1, 1, SIZE, SIZE, 1), ref_images=np.tanh(mk(1, 1, SIZE, SIZE, 3)))


@pytest.mark.parametrize("step_mode", ["vjp", "faithful"])
def test_trainer_records_a_sequence_its_teacher_and_each_steps_phases(step_mode, tmp_path):
    cfg = face_config(batch_size=1, checkpoints_dir=str(tmp_path), name="spans",
                      step_mode=step_mode, **TINY)
    torch.manual_seed(0)
    trainer = Trainer(cfg, log_fn=lambda msg: None, device="cpu")
    trainer.setup()
    frames = 2
    profiling.record(True)
    trainer.train_epoch(cfg.niter_single + 1, [sequence(frames, np.random.RandomState(0))],
                        stub_teacher)
    records = profiling.spans()
    seq = index_of(records, "fsv.train.sequence")
    assert records[seq].parent == -1
    assert children(records, seq) == (["fsv.train.wait", "fsv.train.to_device",
                                       "fsv.train.teacher"] + ["fsv.train.step"] * frames
                                      + ["fsv.train.losses_to_host"])
    phases = STEP_PHASES if step_mode == "vjp" else (
        STEP_PHASES[:3] + ["fsv.train.generate"] + STEP_PHASES[3:])
    steps = [i for i in range(len(records)) if records[i].name == "fsv.train.step"]
    for i in steps:
        assert records[i].parent == seq
        assert children(records, i) == phases
    # the end of the data: one more sequence span, holding only its wait
    last = index_of(records, "fsv.train.sequence", 1)
    assert children(records, last) == ["fsv.train.wait"]
    assert [r.name for r in records if r.parent == -1] == [
        "fsv.train.sequence", "fsv.train.sequence", "fsv.train.checkpoint"]
    # the generator's stages inside generate
    gen = index_of(records, "fsv.train.generate")
    assert children(records, gen) == ["fsv.gen.weights", "fsv.gen.main", "fsv.gen.flow",
                                      "fsv.gen.main"]


@pytest.mark.parametrize("k", [1, 2])
def test_pipeline_records_serving_and_generator_stages(k):
    cfg = face_config(batch_size=1, n_shot=k, is_train=False, **TINY)
    torch.manual_seed(0)
    pipe = InferencePipeline(cfg, build_generator(cfg, device="cpu"))
    rng = np.random.RandomState(1)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    labels = mk(3, 1, SIZE, SIZE, 1)
    profiling.record(True)
    pipe.reset(mk(1, k, SIZE, SIZE, 1), np.tanh(mk(1, k, SIZE, SIZE, 3)), labels[0])
    for t in (1, 2):
        pipe.step(labels[t])
    records = profiling.spans()
    assert [r.name for r in records if r.parent == -1] == [
        "fsv.serve.reset", "fsv.serve.step", "fsv.serve.step"]
    assert children(records, 0) == ["fsv.gen.weights"]
    # K = 1 serves from the reset's cache; K > 1 attends to the references
    # with each frame's label
    stages = ["fsv.gen.main", "fsv.gen.flow", "fsv.gen.main"]
    want = stages if k == 1 else ["fsv.gen.weights"] + stages
    for n in (0, 1):
        assert children(records, index_of(records, "fsv.serve.step", n)) == want


@pytest.mark.parametrize("recording", [False, True])
def test_exported_serving_programs_hold_no_profiler_op(recording, tmp_path):
    """Spans are off while a program is exported, even with recording on
    (which records the eager call that makes the example cache)."""
    cfg = face_config(batch_size=1, n_shot=2, is_train=False, **TINY)
    torch.manual_seed(0)
    g = build_generator(cfg, device="cpu")
    profiling.record(recording)
    export_serving(cfg, g, str(tmp_path), dtype=torch.float32)
    assert [r.name for r in profiling.spans()] == (["fsv.gen.weights"] if recording else [])
    for name in PROGRAMS:
        ep = torch.export.load(os.path.join(tmp_path, f"{name}.pt2"))
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_cost_volume_is_a_registered_operator():
    """fsv::cost_volume passes opcheck, shows in a profiler's trace with its
    shapes, and its backward is the plain transpose."""
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn(2, 5, 9, 11, generator=g) for _ in range(2))
    result = torch.library.opcheck(torch.ops.fsv.cost_volume.default, (f1, f2, 4, 2))
    assert set(result.values()) == {"SUCCESS"}, result
    a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = cv.correlation(a, b, 4, 2)
    calls = [e for e in prof.events() if e.name == "fsv::cost_volume"]
    assert len(calls) == 1 and calls[0].input_shapes[0] == [2, 5, 9, 11]
    assert torch.equal(out, cv.cost_volume_plain(f1, f2, 4, 2))
    cot = torch.randn(out.shape, generator=g)
    (out * cot).sum().backward()
    want = cv.cost_volume_backward_plain(f1, f2, cot, 4, 2)
    assert torch.equal(a.grad, want[0]) and torch.equal(b.grad, want[1])


# ----------------------------------------------------------------------
# the benchmark's readers of the spans
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def registry():
    return Registry(ROOT)


def readings(trace=None):
    return Readings(setup_s=1.0, steps=[Step(0.0, 1.0, 8)], window_start=0.0,
                    window_end=1.0, trace=trace)


@pytest.mark.parametrize("name", SERVE_READERS + TRAIN_READERS)
def test_span_readers_read_nothing_without_spans(registry, name):
    reader = registry.metric(name)
    assert reader.read(readings()) is None
    bare = TraceSummary(window_s=1.0, device=[], host=[HostOp("bench.step", 0.0, 9.0, False, 5.0)])
    assert reader.read(readings(bare)) is None


def test_serve_readers_sum_device_time_inside_steps_per_step(registry):
    host = [HostOp("fsv.serve.reset", 0.0, 10.0, False, 900.0),
            HostOp("fsv.gen.weights", 1.0, 9.0, False, 800.0),       # the reset's: not counted
            HostOp("fsv.serve.step", 10.0, 20.0, False, 6000.0),
            HostOp("fsv.gen.weights", 11.0, 12.0, False, 1000.0),
            HostOp("fsv.gen.main", 12.0, 13.0, False, 300.0),
            HostOp("fsv.gen.flow", 13.0, 14.0, False, 2000.0),
            HostOp("fsv.gen.main", 14.0, 19.0, False, 2700.0),
            HostOp("fsv.serve.step", 20.0, 30.0, False, 5000.0),
            HostOp("fsv.gen.weights", 21.0, 22.0, False, 1000.0),
            HostOp("fsv.gen.flow", 23.0, 24.0, False, 1000.0),
            HostOp("fsv.gen.main", 24.0, 29.0, False, 3000.0)]
    r = readings(TraceSummary(window_s=1.0, device=[], host=host))
    got = {name: registry.metric(name).read(r) for name in SERVE_READERS}
    assert got == pytest.approx({"gen_weights_ms.serve": 1.0, "gen_flow_ms.serve": 1.5,
                                 "gen_main_ms.serve": 3.0})


def test_train_readers_take_medians_over_the_steps(registry, monkeypatch):
    ms = 1_000_000
    records = [SpanRecord("fsv.train.sequence", -1, 0, 1000 * ms)]
    for s, (gen, d, upd_d, g, upd_g) in enumerate(
            [(10, 5, 20, 15, 30), (12, 6, 22, 15, 31), (40, 5, 20, 15, 30)]):
        start = 100 * ms * (s + 1)
        step = len(records)
        records.append(SpanRecord("fsv.train.step", 0, start, start + 90 * ms))
        t = start
        for name, dur in zip(STEP_PHASES, (gen, d, upd_d, g, upd_g, 1)):
            records.append(SpanRecord(name, step, t, t + dur * ms))
            t += dur * ms
        records.append(SpanRecord("fsv.gen.main", step + 1, start, start + ms))  # a grandchild
    monkeypatch.setattr(profiling, "_records", records)
    r = readings()
    assert registry.metric("step_host_ms.train").read(r) == pytest.approx(90.0)
    assert registry.metric("update_host_ms.train").read(r) == pytest.approx(50.0)
    assert registry.metric("forward_host_ms.train").read(r) == pytest.approx(33.0)


def test_the_off_span_is_one_cheap_check():
    """The check that keeps every span of a step off (about 20 a serving
    step, 100 a training sequence) when nothing records."""
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("fsv.x"):
            pass
    assert (time.perf_counter() - t0) / n < 1e-5
