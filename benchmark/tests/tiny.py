"""A copy of the benchmark with small cells beside the real ones, for runs
on the CPU: the same drivers, metrics and reference at widths and sizes a
test can hold.  `make_root(dest)` writes it and returns its root."""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SMALL_G = dict(ngf=8, nff=8, ndf=8, n_blocks_F=2, n_downsample_G=3, n_adaptive_layers=2)
# (tiny cell, the real cell it shrinks, configuration overrides, traffic overrides)
CELLS = {
    "tiny_face.serve": ("face_k8.serve_512_b8", dict(SMALL_G, n_shot=3),
                        dict(streams=2, clip_frames=6, size=64, cells=[8, 8])),
    "tiny_street.serve": ("street.serve_512x256_b32", SMALL_G,
                          dict(streams=2, clip_frames=6, size=128, cells=[4, 4])),
    "tiny_street.train": ("street.train_512x256_b6", SMALL_G,
                          dict(batch=2, frames=3, size=128, cells=[4, 4])),
    "tiny_face.train": ("face_k8.train_256_b4", dict(SMALL_G, n_shot=3),
                        dict(batch=2, frames=3, size=64, cells=[8, 8])),
}


def make_root(dest: Path, cells=CELLS) -> Path:
    """dest/BENCHMARK.json and dest/benchmark (a copy, with the small cells'
    files added), and the port linked beside them."""
    dest = Path(dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    os.symlink(REPO / "fsvid2vid_tpu_torch", dest / "fsvid2vid_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = dest / "benchmark"
    for name, (real, cfg_over, tr) in cells.items():
        cell = dict(next(w for w in spec["workloads"] if w["name"] == real), name=name)
        cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
        config = json.loads((REPO / cfg_entry["file"]).read_text())
        config["fields"].update(cfg_over)
        cfg_name = f"tiny_{name.replace('.', '_')}"
        (bench / "configs" / f"{cfg_name}.json").write_text(json.dumps(config))
        spec["configs"].append(dict(cfg_entry, name=cfg_name,
                                    file=f"benchmark/configs/{cfg_name}.json"))
        traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
        fields = traffic["config_fields"]
        fields.update(fine_size=tr["size"], load_size=tr["size"])
        if traffic["kind"] == "serve":
            fields["batch_size"] = traffic["streams"] = tr["streams"]
            traffic["clip_frames"] = tr["clip_frames"]
        else:
            fields["batch_size"] = tr["batch"]
            traffic["frames"] = tr["frames"]
        traffic["image_cells"] = [4, 4]
        if "cells" in tr:
            traffic["labels"]["cells"] = tr["cells"]
        (bench / "traffic" / f"{cfg_name}.json").write_text(json.dumps(traffic))
        shutil.copy(bench / "limits" / f"{real}.json", bench / "limits" / f"{name}.json")
        spec["workloads"].append(dict(cell, config=cfg_name, traffic=cfg_name))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest
