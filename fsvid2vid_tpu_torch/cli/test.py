"""Inference CLI of the PyTorch port (the twin of the JAX package's test.py;
reference test.py): sequential frame-by-frame face, pose or street
synthesis from a trained checkpoint, with an HTML result page.

  python -m fsvid2vid_tpu_torch.cli.test --name face --seq_path ... \\
      --ref_img_path ... --adaptive_spade --warp_ref --spade_combine
  python -m fsvid2vid_tpu_torch.cli.test --name pose --dataset_mode fewshot_pose \\
      --adaptive_spade --warp_ref --spade_combine --remove_face_labels \\
      --finetune --seq_path ... --ref_img_path ...

It takes the train CLI's flags and these: --results_dir, --how_many,
--seq_path, --ref_img_path, --ref_img_id (the reference frames' indices,
comma-separated, at least --n_shot of them), --which_epoch, --finetune
(adapt the restored G and discriminators to the first sample's references
for finetune_iters steps before the first frame; the discriminator's
--netD_subarch and adaptive_D_layers come from the run's config.json unless
--netD_subarch is given).  At --n_shot K > 1 each
frame runs the attention once: on the card kernel B1, after a finetune too
(the finetune itself runs the generator's differentiable train-mode path).
With --refine_face (pose, --n_shot 1) the face generator is restored with G
and refines each frame's face, and with --finetune it is adapted with G.
The page is written to <results_dir>/<name>/<ref>_<seq>/index.html.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

from fsvid2vid_tpu_torch.cli.train import build_arg_parser, config_from_args


def build_test_parser():
    parser = build_arg_parser()
    parser.add_argument("--results_dir", type=str, default="./results/")
    parser.add_argument("--how_many", type=int, default=300)
    parser.add_argument("--seq_path", type=str, default="")
    parser.add_argument("--ref_img_path", type=str, default="")
    parser.add_argument("--ref_img_id", type=str, default="0")
    parser.add_argument("--which_epoch", type=str, default="latest")
    parser.add_argument("--finetune", action="store_true")
    return parser


@dataclasses.dataclass
class InferenceRun:
    """What a run wrote and how long the user waited: the page's directory,
    the seconds from the start of `main` to the first frame's image on disk
    (models, checkpoint, finetune, reference encoding), the finetune's
    seconds and per-step losses, each frame's seconds (sample, step, image
    files), and the frames whose output held a non-finite value."""
    web_dir: str
    first_frame_seconds: float
    finetune_seconds: Optional[float]
    finetune_losses: List[dict]
    frame_seconds: List[float]
    nonfinite_frames: List[int]


def main(argv=None) -> InferenceRun:
    """Runs the sequence and returns what it did (InferenceRun)."""
    t_start = time.perf_counter()
    parser = build_test_parser()
    args = parser.parse_args(argv)
    cfg = config_from_args(parser, args, is_train=False)
    saved = os.path.join(cfg.checkpoints_dir, cfg.name, "config.json")
    if cfg.finetune and args.netD_subarch is None and os.path.isfile(saved):
        # the discriminator exists in training and finetune only: its
        # architecture comes from the run's config.json unless given
        from fsvid2vid_tpu_torch.config import Config
        run_cfg = Config.load(saved)
        cfg = cfg.replace(netD_subarch=run_cfg.netD_subarch,
                          adaptive_D_layers=run_cfg.adaptive_D_layers)
    n_refs = len(str(cfg.ref_img_id).split(","))
    if n_refs < cfg.n_shot:
        parser.error(f"--n_shot {cfg.n_shot} needs as many reference frames; "
                     f"--ref_img_id {cfg.ref_img_id!r} names {n_refs}")
    from fsvid2vid_tpu_torch import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"test: {e}")
    import numpy as np
    import torch
    from fsvid2vid_tpu_torch.data.loader import create_dataset
    from fsvid2vid_tpu_torch.inference import finetune as ft_lib
    from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
    from fsvid2vid_tpu_torch.training import checkpoint as ckpt_lib
    from fsvid2vid_tpu_torch.training.state import build_models
    from fsvid2vid_tpu_torch.utils.html import HTML
    from fsvid2vid_tpu_torch.utils.imaging import (
        save_image, tensor2flow, tensor2im, tensor2label, tensor2pose)

    if device.type == "cuda":   # f32 products stay f32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dataset = create_dataset(cfg)
    # with --finetune the bundle holds the discriminators and VGG19 too
    models = build_models(cfg, device=device)
    stored = ckpt_lib.load(cfg, label=args.which_epoch)
    if stored is None:
        print(f"no checkpoint found for {cfg.name}; using random init")
    else:   # every network the bundle has (JAX test.py restores the whole state)
        ckpt_lib.restore_models(models, stored)

    rng = np.random.RandomState(0)
    first = dataset.sample(0, rng)
    finetune_seconds, finetune_losses = None, []
    if cfg.finetune:
        t0 = time.perf_counter()
        _, history = ft_lib.finetune(cfg, models, first["ref_labels"][None],
                                     first["ref_images"][None])
        finetune_losses = [{k: v.item() for k, v in h.items()} for h in history]
        finetune_seconds = time.perf_counter() - t0
        print(f"test-time finetuning done: {len(history)} steps in "
              f"{finetune_seconds:.2f} s")
    pipe = InferencePipeline(cfg, models.netG, compute_dtype=cfg.compute_dtype,
                             netGf=models.netGf)
    pipe.reset(first["ref_labels"][None], first["ref_images"][None],
               first["tgt_label"][:1])

    seq_name = (os.path.basename(os.path.dirname(cfg.ref_img_path or "ref/"))
                + "_" + os.path.basename(os.path.dirname(cfg.seq_path or "seq/")))
    web_dir = os.path.join(cfg.results_dir, cfg.name, seq_name)
    page = HTML(web_dir, f"results: {cfg.name}")

    n = min(len(dataset), cfg.how_many)
    first_frame_seconds, frame_seconds, nonfinite = None, [], []
    for i in range(n):
        t0 = time.perf_counter()
        sample = dataset.sample(i, rng) if i > 0 else first
        label = sample["tgt_label"][-1:]
        out = pipe.step(label)
        fake = out["fake_image"][0].cpu().numpy()
        if not np.isfinite(fake).all():
            nonfinite.append(i)
        visuals = {
            "input_label": (tensor2label(label[0], cfg.label_nc) if cfg.label_nc
                            else tensor2pose(label[0]) if cfg.is_pose
                            else tensor2im(label[0], normalize=False)),
            "synthesized": tensor2im(fake),
        }
        if out["flow"][0] is not None:
            visuals["ref_flow"] = tensor2flow(out["flow"][0][0].cpu().numpy())
        names = []
        for k, img in visuals.items():
            fname = f"{i:05d}_{k}.png"
            save_image(img, os.path.join(page.get_image_dir(), fname))
            names.append(fname)
        page.add_header(f"frame {i:05d}")
        page.add_images(names, [n_.split("_", 1)[1] for n_ in names], names)
        frame_seconds.append(time.perf_counter() - t0)
        if first_frame_seconds is None:
            first_frame_seconds = time.perf_counter() - t_start
        if (i + 1) % 10 == 0:
            print(f"frame {i + 1}/{n}")
    page.save()
    if nonfinite:
        print(f"WARNING: non-finite values in frames {nonfinite}")
    print(f"results written to {web_dir}")
    return InferenceRun(web_dir, first_frame_seconds, finetune_seconds,
                        finetune_losses, frame_seconds, nonfinite)


if __name__ == "__main__":
    main()
