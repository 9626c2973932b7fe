"""The benchmark's pose cell (pose_refine.train_512x256_b4) on the CPU: its
driver (benchmark/drivers/train_pose.py) against the plain reference at a
tiny pose size in f32, with face refinement and remat both on and both off; the
label maps it paints; and the spans and the counter it reads
(fsv.train.refine_face, fsv.train.face_d, fsv.train.recompute,
`remat.recomputes`), with their readers (benchmark/nested_spans.py)."""
from __future__ import annotations

import pytest
import torch

from benchmark.registry import Registry
from benchmark.run import ROOT, Run
from fsvid2vid_tpu_torch.config import preset
from fsvid2vid_tpu_torch.models.face_refiner import get_face_boxes
from fsvid2vid_tpu_torch.models.input_process import PART_GROUPS
from fsvid2vid_tpu_torch.models.remat import remat
from fsvid2vid_tpu_torch.utils import profiling
from fsvid2vid_tpu_torch.utils.profiling import SpanRecord
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)

CELL = "pose_refine.train_512x256_b4"
SMALL_G = dict(ngf=8, nff=8, ndf=8, n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2)
# the tiny cells: 128 x 64 maps (64 the least FlowNet2 takes), batch 2, T = 3;
# refinement and remat both on, as the cell runs, and both off
CASES = {"refine_remat": {}, "plain": dict(refine_face=False, remat=False)}
NEW_SPANS = ("fsv.train.refine_face", "fsv.train.face_d", "fsv.train.recompute")


@pytest.fixture(scope="module")
def tiny_registry(tmp_path_factory):
    from benchmark.tests.tiny import make_root
    cells = {f"tiny_pose_{name}.train": (CELL, dict(SMALL_G, **over),
                                         dict(batch=2, frames=3, size=64))
             for name, over in CASES.items()}
    root = make_root(tmp_path_factory.mktemp("bench") / "root", cells)
    return Registry(root, root / "benchmark")


def tiny_run(registry, cell: str, seed: int) -> Run:
    cell = registry.cell(cell)
    config = registry.config(cell["config"])
    config = dict(config, fields=dict(config["fields"], compute_dtype="float32"))
    return Run(torch=torch, device=torch.device("cpu"), cell=cell, config=config,
               traffic=registry.traffic(cell["traffic"]), seed=seed, seconds=0.5,
               trace=False, started=0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_pose_reference_steps_equal_the_port_in_f32(tiny_registry, case):
    """Three train steps of the port's trainer in f32 and of the reference
    on the painted pose maps: losses, first gradients, directions (face
    networks' too) and changes."""
    run = tiny_run(tiny_registry, f"tiny_pose_{case}.train", 2 ** 33 + 19)
    out = tiny_registry.driver("train_pose").control(run, fp8=False)["program"]
    assert ("direction_gap.Gf" in out) is (CASES[case].get("refine_face", True))
    assert "direction_gap.Df" in out
    assert max(out.values()) <= 1e-4, out


# ----------------------------------------------------------------------
# the painted labels
# ----------------------------------------------------------------------
def test_painted_labels_follow_the_pose_encoding():
    """At the cell's size: part ids only on the p / 24 levels, parts 23 and
    24 and every body-part group present, background -1 in every channel,
    the face box (the port's rule) centred on the face and inside the
    frame, and the target moving by sway_px a frame."""
    registry = Registry(ROOT)
    traffic = dict(registry.traffic(registry.cell(CELL)["traffic"]), frames=3)
    cfg = preset("pose", **dict(traffic["config_fields"], batch_size=2))
    seqs = registry.driver("train_pose").FigureSequences(
        torch, cfg, traffic, 2 ** 40 + 5, torch.device("cpu"))
    seq = seqs.make(0)
    assert seq["tgt_label"].shape == (2, 3, 512, 256, 6)
    assert seq["ref_labels"].shape == (2, 1, 512, 256, 6)
    for key in ("tgt_label", "ref_labels"):
        labels = seq[key].flatten(0, 1)
        level = (labels[..., 2] + 1) / 2 * 24
        assert (level - level.round()).abs().max() < 1e-4
        assert labels.min() >= -1 and labels.max() <= 1
        background = labels[..., 2] == -1
        assert (labels[background][:, :3] == -1).all()
        for frame in labels:
            ids = set(((frame[..., 2] + 1) / 2 * 24).round().int().unique().tolist())
            assert {23, 24} <= ids
            assert all(ids & set(group) for group in PART_GROUPS)
            assert (frame[..., 3:] > -1).any()          # the OpenPose render
        boxes = get_face_boxes(cfg, labels)
        face = labels[..., 2] > 0.9
        h, w = labels.shape[1:3]
        for box, mask in zip(boxes, face):
            ys, ye, xs, xe = box.tolist()
            assert 0 <= ys < ye <= h and 0 <= xs < xe <= w
            assert mask[int((ys + ye) / 2), int((xs + xe) / 2)]
            inside = mask[int(ys):int(ye), int(xs):int(xe)].sum()
            assert inside == mask.sum()                 # the whole face in its box
    # the target follows its reference, sway_px a frame along x
    part = seq["tgt_label"][..., 2]
    cols = lambda m: torch.nonzero(m.any(0))[:, 0].float().mean()
    for s in range(2):
        moves = [cols(part[s, t] > -1) - cols(part[s, 0] > -1) for t in range(3)]
        step = traffic["labels"]["sway_px"]
        assert abs(abs(moves[1]) - step) < 1 and abs(abs(moves[2]) - 2 * step) < 1


# ----------------------------------------------------------------------
# the spans and the counter
# ----------------------------------------------------------------------
@pytest.fixture
def recording():
    profiling.record(False)
    profiling.clear()
    profiling.record(True)
    yield
    profiling.record(False)
    profiling.clear()


def test_new_spans_nest_under_the_step_and_recomputes_count(tiny_registry, recording):
    """A tiny pose sequence: refine_face inside generate, face_d inside
    d_losses and g_losses, recompute inside the updates (on the CPU the
    backward runs on the caller's thread), each under fsv.train.step;
    remat.recomputes counts one per re-run; the readers read them."""
    from benchmark.drivers import train
    run = tiny_run(tiny_registry, "tiny_pose_refine_remat.train", 2 ** 33 + 23)
    drv = tiny_registry.driver("train_pose")
    with drv.figures(run):
        cfg, _, trainer, teacher, _ = train.program(run)
        seqs = train.Sequences(torch, cfg, run.traffic, run.seed, run.device)
        profiling.clear()
        before = remat.recomputes
        with train.no_epoch_checkpoint():
            trainer.train_epoch(train.epoch_of(cfg), [seqs.make(0)], teacher)
    records = profiling.spans()
    parents = {name: [] for name in NEW_SPANS}
    for r in records:
        if r.name in parents:
            chain, j = [], r.parent
            while j >= 0:
                chain.append(records[j].name)
                j = records[j].parent
            parents[r.name].append(chain)
    frames = run.traffic["frames"]
    assert [c[:2] for c in parents["fsv.train.refine_face"]] == [
        ["fsv.train.generate", "fsv.train.step"]] * frames
    assert [c[:2] for c in parents["fsv.train.face_d"]] == [
        ["fsv.train.d_losses", "fsv.train.step"], ["fsv.train.g_losses", "fsv.train.step"]] * frames
    recomputes = parents["fsv.train.recompute"]
    assert recomputes and all("fsv.train.step" in c for c in recomputes)
    assert {c[0] for c in recomputes} <= {"fsv.train.update_D", "fsv.train.update_G"}
    assert remat.recomputes - before == len(recomputes)
    for name in ("refine_face_ms.train", "face_d_ms.train", "recompute_ms.train"):
        assert tiny_registry.metric(name).read(None) > 0


def test_nested_readers_place_root_records_by_time_and_read_none_without(monkeypatch):
    """Per step, the outermost records of a name summed, a parentless one
    (a CUDA backward's thread) placed by the step's interval; the median
    over steps, 0 for a step without; None with no such record."""
    from benchmark import nested_spans
    ms = 1_000_000
    records = [SpanRecord("fsv.train.sequence", -1, 0, 1000 * ms),
               SpanRecord("fsv.train.step", 0, 100 * ms, 200 * ms),
               SpanRecord("fsv.train.update_G", 1, 150 * ms, 199 * ms),
               SpanRecord("fsv.train.recompute", -1, 160 * ms, 170 * ms),
               SpanRecord("fsv.train.recompute", -1, 171 * ms, 175 * ms),
               SpanRecord("fsv.train.recompute", 4, 172 * ms, 174 * ms),   # nested: not counted
               SpanRecord("fsv.train.step", 0, 300 * ms, 400 * ms),
               SpanRecord("fsv.train.g_losses", 6, 300 * ms, 320 * ms),
               SpanRecord("fsv.train.face_d", 7, 301 * ms, 303 * ms),
               SpanRecord("fsv.train.step", 0, 500 * ms, 600 * ms),
               SpanRecord("fsv.train.recompute", -1, 510 * ms, 530 * ms),
               SpanRecord("fsv.train.recompute", -1, 700 * ms, 710 * ms)]  # in no step
    monkeypatch.setattr(profiling, "_records", records)
    assert nested_spans.median_step_ms("fsv.train.recompute") == pytest.approx(14.0)
    assert nested_spans.median_step_ms("fsv.train.face_d") == pytest.approx(0.0)
    assert nested_spans.median_step_ms("fsv.train.refine_face") is None
    monkeypatch.setattr(profiling, "_records", [])
    registry = Registry(ROOT)
    for name in ("refine_face_ms.train", "face_d_ms.train", "recompute_ms.train"):
        assert registry.metric(name).read(None) is None
