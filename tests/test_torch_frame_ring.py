"""The ring of previous frames at n_frames_G = 3, where its first state
shows: each of the port's three callers of the one served frame
(inference/pipeline.py `frame_step`, the ring advanced by
models/generator.py `roll_prevs`) against what it mirrors, on the CPU at
the JAX serving tests' size (K = 1 face, 64 px, 3 frames; every other
test runs n_frames_G = 2, where the ring holds one frame).

  * `InferencePipeline` starts the ring zero-filled, as JAX's
    InferencePipeline does: frame 1 reads (zeros, frame 0);
  * `run_sequence` starts it as frame 0 tiled, as JAX's run_sequence does:
    frame 1 reads (frame 0, frame 0);
  * the serving export's `step0` tiles frame 0 too, as JAX's export does,
    and its session is held against the port's `run_sequence`.

The two first states give frames that differ at t = 1 by far more than
the tolerances, so each comparison pins its caller's start.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsvid2vid_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from fsvid2vid_tpu.inference.pipeline import run_sequence as jax_run_sequence
from fsvid2vid_tpu.training.state import build_models
from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline, run_sequence
from fsvid2vid_tpu_torch.inference.serve import export_serving, load_serving
from tests.test_torch_data import few_threads  # noqa: F401 (autouse)
from tests.test_torch_generator import IMG_ATOL, T, Pair

SELF_ATOL = 1e-6
_PAIR = []


def pair():
    if not _PAIR:
        _PAIR.append(Pair(1, n_frames_G=3, fine_size=32, load_size=32, n_blocks_F=1,
                          n_downsample_G=2, n_adaptive_layers=1))
    return _PAIR[0]


def jax_models(p):
    v = p.variables
    return (p.cfg, dataclasses.replace(build_models(p.cfg), netG=p.jm), {"G": v["params"]},
            {"G": {c: x for c, x in v.items() if c != "params"}})


def port_pipeline(p):
    pipe = InferencePipeline(p.tcfg, p.g)
    pipe.reset(p.ref_labels, p.ref_images, p.labels[0])
    return np.stack([pipe.step(lbl)["fake_image"].numpy() for lbl in p.labels])


def port_run_sequence(p):
    return run_sequence(p.tcfg, p.g, p.labels, p.ref_labels, p.ref_images).numpy()


def jax_pipeline(p):
    pipe = JaxPipeline(*jax_models(p))
    pipe.reset(jnp.asarray(p.ref_labels), jnp.asarray(p.ref_images), jnp.asarray(p.labels[0]))
    return np.stack([np.asarray(pipe.step(jnp.asarray(lbl))["fake_image"])
                     for lbl in p.labels])


def jax_sequence(p):
    return np.asarray(jax_run_sequence(
        *jax_models(p), *map(jnp.asarray, (p.labels, p.ref_labels, p.ref_images))))


def export_session(p, out_dir):
    export_serving(p.tcfg, p.g, str(out_dir), dtype=torch.float32)
    s = load_serving(str(out_dir), device="cpu")
    s.reset(p.ref_labels, p.ref_images, p.labels[0])
    return np.stack([s.step(lbl).float().numpy() for lbl in p.labels])


@pytest.mark.parametrize("caller", ["pipeline", "run_sequence", "export"])
def test_ring_first_state_at_three_frames(caller, tmp_path):
    p = pair()
    assert p.tcfg.n_frames_G == 3 and p.tcfg.n_shot == 1
    if caller == "pipeline":
        got, want, atol, other = port_pipeline(p), jax_pipeline(p), IMG_ATOL, port_run_sequence(p)
    elif caller == "run_sequence":
        got, want, atol, other = port_run_sequence(p), jax_sequence(p), IMG_ATOL, port_pipeline(p)
    else:
        got, want, atol, other = (export_session(p, tmp_path), port_run_sequence(p),
                                  SELF_ATOL, port_pipeline(p))
    assert got.shape == want.shape == (T, 1, p.cfg.height, p.cfg.width, 3)
    assert want.std() > 0.02   # frames well above the tolerance
    for t in range(T):
        np.testing.assert_allclose(got[t], want[t], atol=atol, err_msg=f"t={t}")
    # frame 0 reads no ring; frame 1 reads the first state, which the
    # other start would change
    np.testing.assert_allclose(got[0], other[0], atol=SELF_ATOL)
    assert np.abs(got[1] - other[1]).max() > 100 * IMG_ATOL
