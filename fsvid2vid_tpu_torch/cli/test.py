"""Inference CLI of the PyTorch port (the twin of the JAX package's test.py;
reference test.py): sequential frame-by-frame face or pose synthesis from a
trained checkpoint, with an HTML result page.

  python -m fsvid2vid_tpu_torch.cli.test --name face --seq_path ... \\
      --ref_img_path ... --adaptive_spade --warp_ref --spade_combine

It takes the train CLI's flags and these: --results_dir, --how_many,
--seq_path, --ref_img_path, --ref_img_id, --which_epoch, --finetune (not
ported yet: it exits non-zero).  The page is written to
<results_dir>/<name>/<ref>_<seq>/index.html.
"""
from __future__ import annotations

import os
import sys

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


def main(argv=None) -> str:
    """Runs the sequence and returns the result page's directory."""
    parser = build_test_parser()
    args = parser.parse_args(argv)
    if args.finetune:
        parser.error("--finetune is not ported yet (ROADMAP.md A.11: "
                     "test-time finetune)")
    cfg = config_from_args(parser, args, is_train=False)
    from fsvid2vid_tpu_torch import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"test: {e}")
    import numpy as np
    import torch
    from fsvid2vid_tpu_torch.data.loader import create_dataset
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
    models = build_models(cfg, device=device)
    stored = ckpt_lib.load(cfg, label=args.which_epoch)
    if stored is None:
        print(f"no checkpoint found for {cfg.name}; using random init")
    else:
        ckpt_lib.restore_models(models, stored, keys=("G",))

    rng = np.random.RandomState(0)
    first = dataset.sample(0, rng)
    pipe = InferencePipeline(cfg, models.netG, compute_dtype=cfg.compute_dtype)
    pipe.reset(first["ref_labels"][None], first["ref_images"][None],
               first["tgt_label"][:1])

    seq_name = (os.path.basename(os.path.dirname(cfg.ref_img_path or "ref/"))
                + "_" + os.path.basename(os.path.dirname(cfg.seq_path or "seq/")))
    web_dir = os.path.join(cfg.results_dir, cfg.name, seq_name)
    page = HTML(web_dir, f"results: {cfg.name}")

    n = min(len(dataset), cfg.how_many)
    for i in range(n):
        sample = dataset.sample(i, rng) if i > 0 else first
        label = sample["tgt_label"][-1:]
        out = pipe.step(label)
        visuals = {
            "input_label": (tensor2label(label[0], cfg.label_nc) if cfg.label_nc
                            else tensor2pose(label[0]) if cfg.is_pose
                            else tensor2im(label[0], normalize=False)),
            "synthesized": tensor2im(out["fake_image"][0].cpu().numpy()),
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
        if (i + 1) % 10 == 0:
            print(f"frame {i + 1}/{n}")
    page.save()
    print(f"results written to {web_dir}")
    return web_dir


if __name__ == "__main__":
    main()
