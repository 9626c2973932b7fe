"""Quality-metric CLI of the PyTorch port (the twin of the JAX package's
eval.py): LPIPS, FID, PSNR and SSIM between two frame sets.

  python -m fsvid2vid_tpu_torch.cli.eval --fake_dir results/face/seq/images \\
      --real_dir datasets/face/test_images/seq --vgg16_ckpt vgg16.pth \\
      --lpips_ckpt lpips_vgg.pth [--inception_ckpt inception_v3.pth] [--device cpu]

Frames are matched by sorted file name; the fake frames set the size and
the real ones are resized to it.  vgg16.pth, lpips_vgg.pth and
inception_v3.pth found in --metrics_dir are used where the flags name no
file.  Without the first two the LPIPS backbone is a seeded random
projection and FID uses its space: the numbers compare only with each
other, and the output says `calibrated: false`.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def list_images(d: str):
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
    fs = sorted(f for f in os.listdir(d) if f.lower().endswith(exts))
    if not fs:
        raise SystemExit(f"no images in {d}")
    return [os.path.join(d, f) for f in fs]


def load_batch(paths, size=None):
    """(N, H, W, 3) float32 in [-1, 1]; resized (bicubic) to `size` (H, W)."""
    import numpy as np
    from PIL import Image
    imgs = []
    for p in paths:
        im = Image.open(p).convert("RGB")
        if size is not None:
            im = im.resize((size[1], size[0]), Image.BICUBIC)
        imgs.append(np.asarray(im, np.float32) / 127.5 - 1.0)
    return np.stack(imgs)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--real_dir", required=True)
    ap.add_argument("--fake_dir", required=True)
    ap.add_argument("--vgg16_ckpt", default="")
    ap.add_argument("--lpips_ckpt", default="")
    ap.add_argument("--metrics_dir", default="checkpoints/metrics",
                    help="auto-discovery directory: vgg16.pth / lpips_vgg.pth"
                         " / inception_v3.pth found here are used when the "
                         "explicit --*_ckpt flags are not given")
    ap.add_argument("--inception_ckpt", default="",
                    help="torchvision-layout inception_v3 state_dict; when "
                         "given, FID uses standard InceptionV3 pool3 features")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--how_many", type=int, default=0,
                    help="cap on frame pairs (0 = all)")
    ap.add_argument("--device", type=str, default=None,
                    help="device to run on (default: cuda, which must be present)")
    return ap


def main(argv=None) -> dict:
    """Scores the frames, prints the JSON line and returns it as a dict."""
    args = build_parser().parse_args(argv)
    from fsvid2vid_tpu_torch import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"eval: {e}")
    import numpy as np
    import torch
    from fsvid2vid_tpu_torch.eval import metrics as M

    if device.type == "cuda":   # f32 products stay f32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    real_paths = list_images(args.real_dir)
    fake_paths = list_images(args.fake_dir)
    n = min(len(real_paths), len(fake_paths))
    if len(real_paths) != len(fake_paths):
        print(f"warning: {len(real_paths)} real vs {len(fake_paths)} fake "
              f"frames; evaluating first {n} of each", file=sys.stderr)
    if args.how_many:
        n = min(n, args.how_many)
    real_paths, fake_paths = real_paths[:n], fake_paths[:n]

    # fake frames define the eval resolution; reals are resized to match
    size = load_batch(fake_paths[:1]).shape[1:3]

    def discover(flag_val, fname):
        if flag_val:
            return flag_val
        p = os.path.join(args.metrics_dir, fname)
        if os.path.exists(p):
            print(f"[eval] using discovered checkpoint {p}", file=sys.stderr)
            return p
        return ""
    args.vgg16_ckpt = discover(args.vgg16_ckpt, "vgg16.pth")
    args.lpips_ckpt = discover(args.lpips_ckpt, "lpips_vgg.pth")
    args.inception_ckpt = discover(args.inception_ckpt, "inception_v3.pth")

    lpips_model = M.make_lpips(args.vgg16_ckpt or None, args.lpips_ckpt or None,
                               device=device)
    if args.inception_ckpt:
        from fsvid2vid_tpu_torch.eval.inception import make_inception_extractor
        extractor = make_inception_extractor(args.inception_ckpt, device=device)
        fid_space = "inception-v3-pool3"
    else:
        extractor = M.make_vgg_fid_extractor(lpips_model)
        fid_space = "vgg16-relu4_3" + ("" if lpips_model.calibrated else "-random")

    lp, ps, ss = [], [], []
    feats_r, feats_f = [], []
    with torch.no_grad():
        for i in range(0, n, args.batch):
            rb = torch.from_numpy(load_batch(real_paths[i:i + args.batch], size)).to(device)
            fb = torch.from_numpy(load_batch(fake_paths[i:i + args.batch], size)).to(device)
            lp.append(lpips_model(rb, fb).cpu().numpy())
            ps.append(M.psnr(rb, fb).cpu().numpy())
            ss.append(M.ssim(rb, fb).cpu().numpy())
            feats_r.append(extractor(rb).cpu().numpy())
            feats_f.append(extractor(fb).cpu().numpy())
    lp, ps, ss = (np.concatenate(v) for v in (lp, ps, ss))
    fid = M.fid_from_features(np.concatenate(feats_r), np.concatenate(feats_f))

    calibrated = lpips_model.calibrated and bool(args.inception_ckpt)
    if not calibrated:
        print("[eval] WARNING: UNCALIBRATED metrics — LPIPS/FID use "
              "seeded-random feature nets (no pretrained checkpoints found); "
              "values are self-consistent for tracking but NOT comparable to "
              "published numbers. Drop vgg16.pth/lpips_vgg.pth/"
              f"inception_v3.pth into {args.metrics_dir}/ to calibrate.",
              file=sys.stderr)
    result = {
        "n_frames": int(n),
        "calibrated": calibrated,
        "lpips": float(lp.mean()),
        "lpips_calibrated": lpips_model.calibrated,
        "fid": fid,
        "fid_feature_space": fid_space,
        "psnr_db": float(ps.mean()),
        "ssim": float(ss.mean()),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
