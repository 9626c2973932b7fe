"""Serving export of the inference pipeline (port of
fsvid2vid_tpu/inference/serve.py, where the programs are StableHLO).

The three per-frame programs are exported with `torch.export` and saved
beside one parameters file, so that a server runs them without the model
code on its import path:

  artifacts/
    encode.pt2     reference encoding (the K = 1 cache of
                   encode_reference, or at K > 1 the label-independent
                   prefix of encode_reference_multi)
    step0.pt2      first frame (no prevs; blended with the warped reference)
    step.pt2       steady-state frame (prevs ring buffer in and out)
    params.pt      the spectral-norm-folded parameters and buffers
    serving.json   config, dtype, platform, shapes, export seconds

The programs take the parameters as their first input (the generator is
called through `torch.func.functional_call`), so no weight is saved in a
program and one set of programs serves any checkpoint of the same
architecture (`export_params` writes another parameters file).  Each
program is exported for the device type of the generator it is given and
runs on that device type; at K > 1 `step0` and `step` call kernel B1 as the
registered operator fsv::flash_ref_attention (ops/attention_kernel.py),
which this module imports so that a loaded program finds it.

In bf16 the export follows the JAX package's recipe, not the pipeline's
autocast: bf16 parameters (batch-norm statistics and spectral state stay
f32, parallel/precision.py) and bf16 inputs, and frames come out in bf16.
Inputs and outputs are channel-last, as the pipeline's: labels
(B, H, W, Cl) (street: class indices, Cl = 1, one-hot encoded inside),
references (B, K, H, W, *), frames (B, H, W, 3).  The programs run the
pipeline's own frame (`encode_references`, `frame_step`, the ring's
`roll_prevs`), held against InferencePipeline.step by
tests/test_torch_serve.py, and its layout: the generator runs
channels-last, its 4-D parameters saved channels-last and its inputs taken
as channels-last views.  Only the ring's first state is the export's own:
frame 0 tiled, as JAX's export and `run_sequence` start it.
"""
from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict

import torch
import torch.nn as nn

from fsvid2vid_tpu_torch import resolve_device
from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.ops import attention_kernel  # noqa: F401  (registers fsv::flash_ref_attention)
from fsvid2vid_tpu_torch.parallel.precision import bf16_params

PROGRAMS = ("encode", "step0", "step")
PARAMS_FILE = "params.pt"


class _Program(nn.Module):
    """One serving program: `fn(params, *inputs)`.  The generator is held
    by the closure, outside the module tree, so that the exported program
    carries no weight of its own."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Methods(nn.Module):
    """`forward(name, ...)` calls netG.<name>, so that functional_call can
    run the generator's serving methods on a parameters dict."""

    def __init__(self, netG):
        super().__init__()
        self.g = netG

    def forward(self, name, *args, **kw):
        return getattr(self.g, name)(*args, **kw)


def _build_programs(cfg: Config, netG):
    """The three serving programs over a folded eval-mode generator: the
    pipeline's frame (inference/pipeline.py `encode_references`,
    `frame_step`) with the parameters as the first input."""
    from fsvid2vid_tpu_torch.inference.pipeline import encode_references, frame_step
    from fsvid2vid_tpu_torch.models.generator import roll_prevs
    from fsvid2vid_tpu_torch.models.input_process import encode_label, use_valid_labels
    methods = _Methods(netG)

    def caller(params):
        prefixed = {"g." + k: v for k, v in params.items()}
        return lambda name, *args, **kw: torch.func.functional_call(
            methods, prefixed, (name,) + args, kw)

    def valid(x):
        return use_valid_labels(cfg, encode_label(cfg, x)).to(x.dtype)

    def encode(params, ref_labels, ref_images, first_label):
        ref_valid = valid(ref_labels)
        first = valid(first_label) if cfg.n_shot == 1 else None   # read at K = 1 only
        return encode_references(cfg, caller(params), ref_valid, ref_images, first)

    def frame(params, cache, label, ref_labels, ref_images, prevs):
        label_valid = valid(label)
        out = frame_step(cfg, caller(params), cache, label_valid, valid(ref_labels),
                         ref_images, prevs)
        extras = {"ref_idx": out["ref_idx"], "atn": out["atn"]} if cfg.n_shot > 1 else {}
        return out["img_final"], label_valid, extras

    n = max(1, cfg.n_frames_G - 1)

    def step0(params, cache, label, ref_labels, ref_images):
        fake, label_valid, extras = frame(params, cache, label, ref_labels, ref_images, None)
        prevs = {"label": label_valid.repeat(1, 1, 1, n), "fake": fake.repeat(1, 1, 1, n)}
        return fake, prevs, extras

    def step(params, cache, label, ref_labels, ref_images, prevs):
        fake, label_valid, extras = frame(params, cache, label, ref_labels, ref_images, prevs)
        return fake, roll_prevs(prevs, label=label_valid, fake=fake), extras

    return _Program(encode), _Program(step0), _Program(step)


def _label_nc(cfg: Config) -> int:
    """Channels of a label as the programs take it: class indices for
    street, else the dataset's label channels."""
    return 1 if cfg.label_nc else cfg.input_nc


def _example_inputs(cfg: Config, dtype: torch.dtype, device: torch.device):
    h, w, cl = cfg.height, cfg.width, _label_nc(cfg)
    b, k, n = 1, cfg.n_shot, max(1, cfg.n_frames_G - 1)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    prevs = {"label": z(b, h, w, cfg.gen_input_nc * n), "fake": z(b, h, w, 3 * n)}
    return z(b, h, w, cl), z(b, k, h, w, cl), z(b, k, h, w, 3), prevs


def _fold(netG) -> nn.Module:
    from fsvid2vid_tpu_torch.inference.fold import serving_module
    return serving_module(copy.deepcopy(netG))


def _params(folded: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    if dtype == torch.bfloat16:
        return bf16_params(folded)
    if dtype != torch.float32:
        raise ValueError(f"serving dtype {dtype}: float32 or bfloat16")
    return {**{k: v.detach() for k, v in folded.named_parameters()},
            **dict(folded.named_buffers())}


def export_params(netG, path: str, dtype: torch.dtype = torch.bfloat16) -> int:
    """Write the serving parameters of `netG` (folded, cast as the export
    casts them) to `path`, for programs exported from any generator of the
    same architecture.  Returns the file's bytes."""
    torch.save(_params(_fold(netG), dtype), path)
    return os.path.getsize(path)


def export_serving(cfg: Config, netG, out_dir: str,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Export the three programs and the folded parameters of `netG` (left
    unchanged) for its device type.  Returns the bytes of each file.
    VAE (use_kld: z = mu) and use_label_ref='concat' configurations export
    like any other; refine_face does not, as the JAX export has no face
    refiner."""
    if cfg.refine_face:
        raise NotImplementedError(
            "refine_face: the serving export has no face refiner, as the JAX export "
            "(fsvid2vid_tpu/inference/serve.py) has none; serve it with "
            "InferencePipeline")
    os.makedirs(out_dir, exist_ok=True)
    folded = _fold(netG)
    params = _params(folded, dtype)
    device = next(iter(params.values())).device
    programs = dict(zip(PROGRAMS, _build_programs(cfg, folded)))
    label, ref_l, ref_i, prevs = _example_inputs(cfg, dtype, device)
    sizes, seconds = {}, {}
    with torch.no_grad():
        cache = programs["encode"](params, ref_l, ref_i, label)
        for name, args in (("encode", (params, ref_l, ref_i, label)),
                           ("step0", (params, cache, label, ref_l, ref_i)),
                           ("step", (params, cache, label, ref_l, ref_i, prevs))):
            t0 = time.perf_counter()
            exported = torch.export.export(programs[name], args, strict=False)
            exported.example_inputs = None     # else the parameters are saved with it
            path = os.path.join(out_dir, f"{name}.pt2")
            torch.export.save(exported, path)
            seconds[name] = time.perf_counter() - t0
            sizes[f"{name}.pt2"] = os.path.getsize(path)
    path = os.path.join(out_dir, PARAMS_FILE)
    torch.save(params, path)
    sizes[PARAMS_FILE] = os.path.getsize(path)
    with open(os.path.join(out_dir, "serving.json"), "w") as f:
        json.dump({
            "config": cfg.to_json(),
            "dtype": str(dtype).replace("torch.", ""),
            "platform": device.type,
            "shapes": {"label": list(label.shape), "ref_l": list(ref_l.shape),
                       "ref_i": list(ref_i.shape)},
            "export_seconds": seconds,
        }, f, indent=2)
    return sizes


class ServingSession:
    """Drives the saved programs: reset(refs) then step(label) per frame,
    as InferencePipeline does, with no model code.

    `load_params` serves another parameters file (`export_params`) in
    place of the one saved with the programs.  After each step, `ref_idx`
    and `atn` hold the picked reference and the references' attention
    masses (B, K) at K > 1, None at K = 1."""

    def __init__(self, out_dir: str, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(out_dir, "serving.json")) as f:
            self.meta = json.load(f)
        if self.meta["platform"] != self.device.type:
            raise ValueError(f"programs exported for {self.meta['platform']} cannot run "
                             f"on {self.device}")
        self.programs, self.load_seconds = {}, {}
        for name in PROGRAMS:
            t0 = time.perf_counter()
            self.programs[name] = torch.export.load(
                os.path.join(out_dir, f"{name}.pt2")).module()
            self.load_seconds[name] = time.perf_counter() - t0
        self.load_params(os.path.join(out_dir, PARAMS_FILE))
        self.dtype = getattr(torch, self.meta["dtype"])
        self.cache = self.prevs = self._refs = None
        self.ref_idx = self.atn = None
        self.t = 0

    def load_params(self, path: str):
        """Serve the parameters in `path` (export_serving's or
        export_params') from the next reset on."""
        self.params = torch.load(path, map_location=self.device, weights_only=True)
        self._refs = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def reset(self, ref_labels, ref_images, first_label=None):
        """t = 0: run the encode program on the references."""
        ref_labels, ref_images = self._tensor(ref_labels), self._tensor(ref_images)
        if first_label is None:
            first_label = torch.zeros(self.meta["shapes"]["label"], dtype=self.dtype,
                                      device=self.device)
        self._refs = (ref_labels, ref_images)
        with torch.no_grad():
            self.cache = self.programs["encode"](self.params, ref_labels, ref_images,
                                                 self._tensor(first_label))
        self.prevs = None
        self.t = 0

    def step(self, label) -> torch.Tensor:
        """One frame (B, H, W, 3) in the export's dtype."""
        if self._refs is None:
            raise RuntimeError("call reset() first")
        args = (self.params, self.cache, self._tensor(label), *self._refs)
        with torch.no_grad():
            if self.t == 0:
                frame, self.prevs, extras = self.programs["step0"](*args)
            else:
                frame, self.prevs, extras = self.programs["step"](*args, self.prevs)
        self.ref_idx, self.atn = extras.get("ref_idx"), extras.get("atn")
        self.t += 1
        return frame


def load_serving(out_dir: str, device=None) -> ServingSession:
    return ServingSession(out_dir, device)
