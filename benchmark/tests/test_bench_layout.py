"""The benchmark is driven by data: a configuration, a traffic mix, a
metric, a roofline formula and a limit added to a copy of benchmark/ are
found by their names, and no file that was there changes."""
from __future__ import annotations

import hashlib
import json
import shutil

import pytest

from benchmark.readings import Readings, Step
from benchmark.registry import Registry
from benchmark.run import ROOT


def digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digests(tmp_path / "benchmark")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "face_k8.json").read_text())
    config["fields"]["ngf"] = 64
    (bench / "configs" / "face_k8_ngf64.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "serve_512_b8.json").read_text())
    traffic["streams"] = 4
    (bench / "traffic" / "serve_512_b4.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "frames_per_step.serve.py").write_text(
        "def read(r):\n    return r.frames() / len(r.steps)\n")
    (bench / "roofline" / "b9.py").write_text("def cost(n):\n    return 2.0 * n, 4.0 * n\n")
    (bench / "limits" / "face_k8_ngf64.serve_512_b4.json").write_text('{"frame_mean_gap": 0.01}')
    spec["configs"].append({"name": "face_k8_ngf64", "source": "https://example.org/ngf64",
                            "file": "benchmark/configs/face_k8_ngf64.json", "reduced": [],
                            "why": "wider"})
    cell = "face_k8_ngf64.serve_512_b4"
    spec["workloads"].append({"name": cell, "config": "face_k8_ngf64",
                              "traffic": "serve_512_b4", "chips": 1, "why": "w"})
    for m in spec["end_to_end"]:
        if "face_k8.serve_512_b8" in m.get("workloads", []):
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "frames_per_step.serve", "unit": "frames",
                              "better": "higher", "source": "host_clock", "layer": "inference",
                              "moves": "frames_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = Registry(tmp_path, bench)
    assert reg.config("face_k8_ngf64")["fields"]["ngf"] == 64
    assert reg.traffic(reg.cell(cell)["traffic"])["streams"] == 4
    assert reg.limits(cell) == {"frame_mean_gap": 0.01}
    assert reg.roofline("b9").cost(3) == (6.0, 12.0)
    assert reg.driver(reg.traffic("serve_512_b4")["kind"]).execute
    per_layer = [m["name"] for m in reg.metrics(cell, per_layer=True)]
    # a per-layer metric without a list of cells reaches every cell that
    # reports the end-to-end metric it moves, this one too
    assert "frames_per_step.serve" in per_layer and "b1_roofline.serve" not in per_layer
    assert "frames_per_step.serve" in [m["name"] for m in reg.metrics(
        "face_k8.serve_512_b8", per_layer=True)]
    assert "frames_per_step.serve" not in [m["name"] for m in reg.metrics(
        "street.train_512x256_b6", per_layer=True)]
    r = Readings(setup_s=1.0, steps=[Step(0.0, 1.0, 8), Step(1.0, 2.0, 8)],
                 window_start=0.0, window_end=2.0)
    assert reg.metric("frames_per_step.serve").read(r) == 8.0
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_finds_its_files():
    reg = Registry(ROOT)
    names = set()
    for cell in reg.spec["workloads"]:
        traffic = reg.traffic(cell["traffic"])
        assert reg.driver(traffic["kind"]).execute and reg.driver(traffic["kind"]).control
        assert reg.config(cell["config"])["fields"]
        assert reg.limits(cell["name"])
        for per_layer in (False, True):
            for m in reg.metrics(cell["name"], per_layer):
                assert callable(reg.metric(m["name"]).read)
                names.add(m["name"])
    assert names == {m["name"] for m in reg.spec["end_to_end"] + reg.spec["per_layer"]}


def test_missing_files_are_named():
    reg = Registry(ROOT)
    with pytest.raises(FileNotFoundError, match="no_such_metric"):
        reg.metric("no_such_metric")
    with pytest.raises(KeyError):
        reg.cell("no_such.cell")
