#!/usr/bin/env python3
"""Time the pose finetune of two checkouts of the port in turns on one GPU.

    python3 scripts/torch_finetune_pose_turns.py OTHER_CHECKOUT

OTHER_CHECKOUT is another checkout of this repository (for example an
earlier commit unpacked with `git archive`).  Each turn is a fresh process
that runs, from one checkout's chip_smoke.py, `phase_device`, `phase_build`,
`phase_pose_cli` (the pose CLI's training, whose checkpoint the finetune
starts from) and `phase_finetune_pose` (`cli.test --finetune`, 100 steps),
in the order other, this, this, other, so that a drift of the card or the
host over the run falls on both alike.  Prints each turn's finetune_pose
line, then the card's name and power limit, then one JSON object with each
checkout's ms per finetune step and seconds before the first frame, turn by
turn.  Needs a CUDA device and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TURN = """
import sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke as cs
cs.phase_device(torch)
cs.phase_build()
with tempfile.TemporaryDirectory(prefix="fsv_pose_turn_") as tmp:
    cs.phase_pose_cli(torch, tmp)
    cs.phase_finetune_pose(torch, tmp)
"""


def turn(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", TURN], cwd=root, capture_output=True,
                         text=True)
    if out.returncode:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"turn in {root} failed with exit code {out.returncode}")
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith('{"phase": "finetune_pose"'))
    print(line, flush=True)
    res = json.loads(line)
    return {k: res[k] for k in ("ms_per_step", "first_frame_seconds", "seconds")}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"other": Path(sys.argv[1]).resolve(), "this": REPO}
    if not (roots["other"] / "chip_smoke.py").exists():
        print(f"no chip_smoke.py in {roots['other']}", file=sys.stderr)
        return 2
    turns = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        turns[name].append(turn(roots[name]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps({"order": ["other", "this", "this", "other"],
                      "roots": {k: str(v) for k, v in roots.items()}, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
