"""Training CLI of the PyTorch port (the twin of the JAX package's train.py;
reference train.py): few-shot vid2vid face, pose or street training on one
CUDA device.

  python -m fsvid2vid_tpu_torch.cli.train --name face --dataroot datasets/face \\
      --adaptive_spade --warp_ref --spade_combine --batchSize 4
  python -m fsvid2vid_tpu_torch.cli.train --name pose --dataroot datasets/pose \\
      --dataset_mode fewshot_pose --adaptive_spade --warp_ref --spade_combine \\
      --remove_face_labels --add_face_D --batchSize 4
  python -m fsvid2vid_tpu_torch.cli.train --name street --dataroot datasets/street \\
      --dataset_mode fewshot_street --adaptive_spade --loadSize 512 --fineSize 512 \\
      --batchSize 6

The argparse surface keeps the JAX CLI's flags, flag for flag, plus
`--device` (CUDA unless named; the tests pass `--device cpu`).  Parsed flags
override the workload preset that `--dataset_mode` names (fewshot_pose
-> pose_config, with remat on; fewshot_street -> street_config, 20 one-hot
label classes at 512 x 256).  A flag the port cannot honour yet exits
non-zero and names its ROADMAP.md item; none is dropped silently.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

# flags of the JAX CLI that the port cannot honour yet -> ROADMAP.md item
UNPORTED_FLAGS = {
    "distributed": "A.12 (data parallel)",
    "coordinator_address": "A.12 (data parallel)",
    "num_processes": "A.12 (data parallel)",
    "process_id": "A.12 (data parallel)",
    "adaptive_conv": "A.2 (generated main-branch conv weights)",
    "refine_face": "A.7 (face refinement)",
}
# flags that main() consumes itself and that name no config field
RUN_FLAGS = {"faithful", "tf_log", "steps_per_epoch", "flownet_ckpt", "vgg_ckpt",
             "device"}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # experiment
    p.add_argument("--name", type=str, default="experiment")
    p.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    p.add_argument("--dataset_mode", type=str, default="fewshot_face")
    p.add_argument("--dataroot", type=str, default=None)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    # sizes
    p.add_argument("--batchSize", dest="batch_size", type=int, default=None)
    p.add_argument("--loadSize", dest="load_size", type=int, default=None)
    p.add_argument("--fineSize", dest="fine_size", type=int, default=None)
    # generator
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--ndf", type=int, default=None)
    p.add_argument("--n_downsample_G", type=int, default=None)
    p.add_argument("--n_adaptive_layers", type=int, default=None)
    p.add_argument("--adaptive_spade", action="store_true")
    p.add_argument("--adaptive_conv", action="store_true")
    p.add_argument("--no_adaptive_embed", action="store_true")
    p.add_argument("--warp_ref", action="store_true")
    p.add_argument("--spade_combine", action="store_true")
    p.add_argument("--add_raw_output_loss", action="store_true")
    p.add_argument("--n_shot", type=int, default=None)
    p.add_argument("--num_D", type=int, default=None)
    p.add_argument("--netD_subarch", type=str, default=None)
    # pose flags
    p.add_argument("--remove_face_labels", action="store_true")
    p.add_argument("--add_face_D", action="store_true")
    p.add_argument("--refine_face", action="store_true")
    p.add_argument("--basic_point_only", action="store_true")
    p.add_argument("--pose_type", type=str, default=None)
    # schedule
    p.add_argument("--niter", type=int, default=None)
    p.add_argument("--niter_decay", type=int, default=None)
    p.add_argument("--niter_single", type=int, default=None)
    p.add_argument("--niter_step", type=int, default=None)
    p.add_argument("--n_frames_total", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--no_TTUR", action="store_true")
    p.add_argument("--no_vgg_loss", action="store_true")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recompute the generator's up blocks, flow nets and "
                        "SC embedders and VGG19 in the backward instead of "
                        "keeping their activations (torch.utils.checkpoint)")
    p.add_argument("--no_flow_gt", action="store_true")
    p.add_argument("--sn_power_iters", type=int, default=None,
                   help="spectral power iterations per step")
    p.add_argument("--faithful", action="store_true",
                   help="reference-faithful alternation (two generator "
                        "forwards per iteration, cfg.step_mode='faithful'; "
                        "the default step is one forward cheaper)")
    p.add_argument("--lambda_temp", type=float, default=None)
    p.add_argument("--load_pretrain", type=str, default=None,
                   help="checkpoint dir to warm-start network weights from "
                        "(reference train_options.py:16)")
    p.add_argument("--pool_size", type=int, default=None,
                   help="fake-image replay pool size for the D update "
                        "(reference hard-codes 0 = disabled)")
    # observability (reference train_options.py:18-23)
    p.add_argument("--print_freq", type=int, default=None)
    p.add_argument("--display_freq", type=int, default=None)
    p.add_argument("--save_latest_freq", type=int, default=None)
    p.add_argument("--save_epoch_freq", type=int, default=None)
    p.add_argument("--tf_log", action="store_true",
                   help="TensorBoard scalar curves (reference --tf_log)")
    # runtime
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported yet)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (not ported yet)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--flownet_ckpt", type=str, default="",
                   help="path to FlowNet2_checkpoint.pth.tar (torch)")
    p.add_argument("--vgg_ckpt", type=str, default="",
                   help="path to torchvision vgg19 state_dict (torch)")
    p.add_argument("--device", type=str, default=None,
                   help="device to run on (default: cuda, which must be present)")
    return p


def _given(value) -> bool:
    return value is not None and value is not False and value != ""


def config_from_args(parser: argparse.ArgumentParser, args, is_train: bool = True):
    """The run's Config: the preset of --dataset_mode with every given flag
    applied.  Exits through `parser.error` on a flag the port cannot
    honour."""
    from fsvid2vid_tpu_torch.config import Config, preset

    given = {k: v for k, v in vars(args).items() if _given(v)}
    for flag, item in UNPORTED_FLAGS.items():
        if flag in given:
            parser.error(f"--{flag} is not ported yet (ROADMAP.md {item})")
    if args.dataset_mode not in ("fewshot_face", "fewshot_pose", "fewshot_street"):
        parser.error(f"unknown --dataset_mode {args.dataset_mode}")
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = set(given) - fields - RUN_FLAGS
    if unknown:   # a flag added to the parser without a meaning here
        parser.error(f"flags with no effect in the port: {sorted(unknown)}")
    overrides = {k: v for k, v in given.items() if k in fields}
    overrides["is_train"] = is_train
    if args.faithful:
        overrides["step_mode"] = "faithful"
    cfg = preset(args.dataset_mode.replace("fewshot_", ""), **overrides)
    if args.debug:
        cfg = cfg.debug_shrink()
    return cfg


@dataclasses.dataclass
class TrainRun:
    """What `setup` builds for a run: the trainer, its loader and teacher."""
    cfg: object
    device: object
    vis: object
    loader: object
    teacher: object
    trainer: object

    def make_data_iter(self, epoch, n_frames_total):
        self.loader.set_epoch_frames(n_frames_total)
        return self.loader.epoch(epoch)


def setup(args, parser=None) -> TrainRun:
    """Config, device, visualizer, loader, teacher and trainer of a run
    (the trainer set up: resumed or warm-started where asked)."""
    parser = parser or build_arg_parser()
    cfg = config_from_args(parser, args, is_train=True)
    from fsvid2vid_tpu_torch import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"train: {e}")
    import torch
    from fsvid2vid_tpu_torch.data.loader import SequenceLoader
    from fsvid2vid_tpu_torch.training.flow_teacher import FlowTeacher
    from fsvid2vid_tpu_torch.training.trainer import Trainer
    from fsvid2vid_tpu_torch.utils.convert import load_torch_state_dict, load_trunk
    from fsvid2vid_tpu_torch.utils.visualizer import Visualizer

    if device.type == "cuda":   # f32 products stay f32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(cfg.checkpoints_dir, cfg.name), exist_ok=True)
    cfg.save(os.path.join(cfg.checkpoints_dir, cfg.name, "config.json"))
    vis = Visualizer(cfg, tb_log=args.tf_log)
    loader = SequenceLoader(cfg, steps_per_epoch=args.steps_per_epoch, seed=cfg.seed)

    teacher = None
    if not cfg.no_flow_gt and cfg.flow_teacher == "flownet2":
        if os.path.isfile(args.flownet_ckpt):
            teacher = FlowTeacher(cfg, device=device,
                                  state_dict=load_torch_state_dict(args.flownet_ckpt))
            vis.vis_print(f"loaded FlowNet2 teacher from {args.flownet_ckpt}")
        else:
            teacher = FlowTeacher(cfg, device=device)
            vis.vis_print("WARNING: no --flownet_ckpt; flow teacher runs "
                          "with random weights (flow loss uninformative)")

    trainer = Trainer(cfg, log_fn=vis.vis_print, visualizer=vis, device=device)
    trainer.setup()
    if trainer.models.vgg is not None:
        if os.path.isfile(args.vgg_ckpt):
            load_trunk(trainer.models.vgg, args.vgg_ckpt)   # torchvision's vgg19
            vis.vis_print(f"loaded VGG19 from {args.vgg_ckpt}")
        elif args.vgg_ckpt:
            vis.vis_print(f"WARNING: no file {args.vgg_ckpt}; VGG19 runs with "
                          "random weights (perceptual loss uninformative)")
    return TrainRun(cfg, device, vis, loader, teacher, trainer)


def main(argv=None) -> TrainRun:
    parser = build_arg_parser()
    run = setup(parser.parse_args(argv), parser)
    run.trainer.fit(run.make_data_iter, flow_teacher=run.teacher)
    run.vis.close()
    return run


if __name__ == "__main__":
    main()
