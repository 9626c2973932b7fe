"""Sequential inference (port of fsvid2vid_tpu/inference/pipeline.py,
reference test.py:20-53 and Vid2VidModel.inference).

  pipe = InferencePipeline(cfg, netG)
  pipe.reset(ref_labels, ref_images)   # t = 0: encode the references once
  out = pipe.step(label)               # one frame; advances the prevs buffer

For K = 1 the per-frame step skips the reference encoder (encode_reference
cache).  For K > 1 the attention depends on the current label, so each frame
runs the forward from the label-independent encode_reference_multi cache.

Frames, labels and references are channel-last, as in the JAX package:
labels (B, H, W, Cl), references (B, K, H, W, C), frames (B, H, W, 3).
Street labels (label_nc > 0) are class indices, Cl = 1, one-hot encoded on
the device as they enter (`encode_label`, reference encode_input).
Inputs may be numpy arrays or tensors; they are moved to the generator's
device.  With refine_face (at n_shot 1, as the JAX package runs it:
models/face_refiner.py `check_refine_face`) the face generator `netGf`
refines each frame's face region from the first reference's face.  VAE
configurations (use_kld) take z = mu, as at any eval.
`compute_dtype="bfloat16"` runs the convolutions, matrix products and the
attention kernel in bf16 under autocast; outputs are float32.

The generator runs channels-last on every device: its weights are laid out
so once (inference/fold.py `serving_module`, in place), each input enters
as the (..., C, H, W) view of its channel-last memory with no copy, and the
frame leaves as a dense (B, H, W, 3) block.  Every convolution of a step
then runs on NHWC operands, with no layout transposes around it.

`step` hands its frame to the host itself, as a server does (`hand_off`):
on a CUDA device `fake_image` comes back in page-locked host memory, copied
by one asynchronous DMA that the step waits for, with the strides `.cpu()`
gives; on the CPU it is the frame itself.  The previous-frames ring and the
other outputs stay on the device.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.inference.fold import serving_module
from fsvid2vid_tpu_torch.models.face_refiner import check_refine_face, refine_face_region
from fsvid2vid_tpu_torch.models.generator import FewShotGenerator, pick_ref, roll_prevs
from fsvid2vid_tpu_torch.models.input_process import encode_label, use_valid_labels
from fsvid2vid_tpu_torch.utils.profiling import span


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """A channel-last input as the generator takes it: the (..., C, H, W)
    view of the same memory, channels-last, with no copy."""
    return x.movedim(-1, -3)


def _nhwc(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if x is None else x.movedim(-3, -1).float()


def encode_references(cfg: Config, call, ref_valid, ref_images, first_label):
    """The references' cache, made once a clip: `encode_reference` at K = 1
    (it reads the first frame's label), else the label-independent prefix
    of `encode_reference_multi`.  `call(name, *args, **kw)` runs the
    generator's method `name`; the inputs are channel-last, the labels valid
    (`use_valid_labels`)."""
    args = (_nchw(ref_valid), _nchw(ref_images))
    if cfg.n_shot == 1:
        return call("encode_reference", *args, _nchw(first_label))
    return call("encode_reference_multi", *args)


def frame_step(cfg: Config, call, cache, label_valid, ref_valid, ref_images, prevs):
    """One frame's generator outputs from the references' cache (the JAX
    package's `frame_step_jit`): `synthesize` at K = 1, else the forward
    from the prefix, as at K > 1 the attention reads the current label.
    `prevs` is the ring of previous frames ({"label", "fake"}, channel-last,
    advanced by `roll_prevs`), None on a clip's first frame, which then
    blends only with the warped reference.  `call` and the inputs as in
    `encode_references`.  img_final comes back channel-last, a view of the
    generator's output."""
    args = (_nchw(label_valid), _nchw(ref_valid), _nchw(ref_images))
    prev_l, prev_i = (None, None) if prevs is None else (
        _nchw(prevs["label"]), _nchw(prevs["fake"]))
    warp_prev = prevs is not None and cfg.n_frames_G > 1
    if cfg.n_shot == 1:
        out = call("synthesize", *args, cache, prev_l, prev_i, warp_prev=warp_prev)
    else:
        out = call("forward", *args, prev_l, prev_i, warp_prev=warp_prev, prefix=cache)
    return dict(out, img_final=out["img_final"].movedim(-3, -1))


class _Runner:
    """Device placement, precision and the per-frame generator calls."""

    def __init__(self, cfg: Config, netG: FewShotGenerator,
                 compute_dtype: str = "float32",
                 netGf: Optional[FewShotGenerator] = None):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
        check_refine_face(cfg)
        if cfg.refine_face and netGf is None:
            raise ValueError("refine_face: pass the face generator netGf")
        self.cfg = cfg
        self.netG = serving_module(netG)
        self.netGf = serving_module(netGf) if cfg.refine_face else None
        self.device = next(netG.parameters()).device
        self.compute_dtype = compute_dtype

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def labels(self, x):
        """A label as the dataset gives it: (encoded, valid), the second as
        the generator takes it."""
        encoded = encode_label(self.cfg, self.tensor(x))
        return encoded, use_valid_labels(self.cfg, encoded)

    def context(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.compute_dtype == "bfloat16":
            stack.enter_context(torch.autocast(self.device.type, torch.bfloat16))
        return stack

    def call(self, name, *args, **kw):
        """The generator's method `name` on `args`."""
        return getattr(self.netG, name)(*args, **kw)

    def synth(self, cache, label, refs, prevs):
        """One frame (`frame_step`) from (encoded, valid) `label`, `refs` =
        (encoded, valid) reference labels and the reference images, and the
        ring `prevs`, None on a clip's first frame; the face refined with
        refine_face.  Returns the generator's outputs, img_final a dense
        channel-last float32 frame."""
        (label_raw, label_valid), (ref_raw, ref_valid, ref_images) = label, refs
        out = frame_step(self.cfg, self.call, cache, label_valid, ref_valid, ref_images, prevs)
        fake = out["img_final"].contiguous()
        if self.netGf is not None:
            ref_idx = out.get("ref_idx")
            fake = refine_face_region(
                self.cfg, self.netGf, label_valid, fake, label_raw,
                pick_ref(ref_valid, ref_idx), pick_ref(ref_images, ref_idx),
                pick_ref(ref_raw, ref_idx))
        return dict(out, img_final=fake.float())


def hand_off(frame: torch.Tensor) -> torch.Tensor:
    """`frame` on the host, under span fsv.serve.handoff.  A CPU frame is
    returned as it is ("in_place").  A device frame is copied into a fresh
    page-locked block of PyTorch's caching host allocator, laid out as
    `.cpu()` lays it out, by one DMA that is waited for ("pinned"): the
    result is complete when this returns, and no later call writes to it."""
    with span("fsv.serve.handoff"):
        if frame.device.type == "cpu":
            hand_off.calls_by_route["in_place"] += 1
            return frame
        host = torch.empty_like(frame, device="cpu", pin_memory=True)
        host.copy_(frame, non_blocking=True)
        torch.cuda.current_stream(frame.device).synchronize()
        hand_off.calls_by_route["pinned"] += 1
        return host


hand_off.calls_by_route = {"pinned": 0, "in_place": 0}


class InferencePipeline:
    """Stateful frame-by-frame inference with the prevs ring buffer; with
    refine_face, `netGf` is the face generator."""

    def __init__(self, cfg: Config, netG: FewShotGenerator,
                 compute_dtype: str = "float32",
                 netGf: Optional[FewShotGenerator] = None):
        self.cfg = cfg
        self._run = _Runner(cfg, netG, compute_dtype, netGf)
        self.cache = None
        self.prevs = None
        self.t = 0
        self._refs = None

    def reset(self, ref_labels, ref_images, first_label=None):
        """t = 0: cache the reference encoding."""
        with span("fsv.serve.reset"):
            cfg, run = self.cfg, self._run
            ref_raw, ref_valid = run.labels(ref_labels)
            ref_images = run.tensor(ref_images)
            self._refs = (ref_raw, ref_valid, ref_images)
            if first_label is None:
                first_label = torch.zeros_like(ref_valid[:, 0])
            else:
                first_label = run.labels(first_label)[1]
            with run.context():
                self.cache = encode_references(cfg, run.call, ref_valid, ref_images,
                                               first_label)
            b, _, h, w, cl = ref_valid.shape
            n = max(1, cfg.n_frames_G - 1)
            self.prevs = {
                "label": torch.zeros(b, h, w, cl * n, device=run.device),
                "fake": torch.zeros(b, h, w, 3 * n, device=run.device),
            }
            self.t = 0

    def step(self, label) -> Dict[str, torch.Tensor]:
        """One frame.  Returns fake_image (B, H, W, 3) on the host (`hand_off`:
        page-locked and complete on a CUDA device), and on the device the
        flows, masks, raw image and warped images of the frame,
        channel-last; at K > 1 also ref_idx (B,) and atn (B, K), the
        references' attention masses."""
        with span("fsv.serve.step"):
            if self._refs is None:
                raise RuntimeError("call reset() first")
            run = self._run
            label = run.labels(label)
            with run.context():
                out = run.synth(self.cache, label, self._refs,
                                self.prevs if self.t > 0 else None)
            fake = out["img_final"]
            self.prevs = roll_prevs(self.prevs, label=label[1], fake=fake)
            self.t += 1
            rest = dict(flow=[_nhwc(f) for f in out["flow"]],
                        flow_mask=[_nhwc(f) for f in out["flow_mask"]],
                        img_raw=_nhwc(out.get("img_raw")),
                        warped=[_nhwc(f) for f in out["img_warp"]],
                        ref_idx=out.get("ref_idx"), atn=out.get("atn"))
            return dict(fake_image=hand_off(fake), **rest)


def run_sequence(cfg: Config, netG: FewShotGenerator, labels, ref_labels,
                 ref_images, compute_dtype: str = "float32",
                 netGf: Optional[FewShotGenerator] = None) -> torch.Tensor:
    """Whole-clip inference.  labels: (T, B, H, W, Cl).  Returns the frames
    (T, B, H, W, 3).  Frame 0 runs without prevs (blended only with the
    warped reference); later frames carry the prevs ring buffer, which
    starts as frame 0 tiled over the n_frames_G - 1 slots."""
    run = _Runner(cfg, netG, compute_dtype, netGf)
    labels_raw, labels_valid = run.labels(labels)
    ref_raw, ref_valid = run.labels(ref_labels)
    refs = (ref_raw, ref_valid, run.tensor(ref_images))
    n = max(1, cfg.n_frames_G - 1)
    frames, prevs = [], None
    with run.context():
        cache = encode_references(cfg, run.call, ref_valid, refs[2], labels_valid[0])
        for label in zip(labels_raw, labels_valid):
            fake = run.synth(cache, label, refs, prevs)["img_final"]
            frames.append(fake)
            if prevs is None:
                prevs = {"label": label[1].repeat(1, 1, 1, n), "fake": fake.repeat(1, 1, 1, n)}
            else:
                prevs = roll_prevs(prevs, label=label[1], fake=fake)
    return torch.stack(frames)
