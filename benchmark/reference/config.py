# The benchmark's frozen copy of fsvid2vid_tpu_torch/config.py, its imports
# pointed at this package: it imports nothing of the port.
"""Typed configuration for the PyTorch port of the few-shot vid2vid framework.

The port's own copy of fsvid2vid_tpu/config.py, without the fields that only
select TPU mechanisms (param dtype, mesh, Pallas switch, space-to-depth
layouts), and with `continue_train`, which the JAX package
leaves to the presence of a checkpoint.  `Config.from_json` ignores unknown fields, so a
config written by the JAX package loads here unchanged.

Replaces the reference's two-stage argparse tree (options/base_options.py:21-132,
options/train_options.py, options/test_options.py) and the per-dataset flag
injection (data/__init__.py:36-38, fewshot_*_dataset.modify_commandline_options)
with a single frozen dataclass plus per-workload presets.  Field names follow the
reference flags (snake_case) so configs map 1:1; derived quantities are
properties.  Configs serialize to/from JSON, replacing the reference's pickled
`opt.pkl` (options/base_options.py:176-193).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # ---- experiment ----
    name: str = "experiment"
    checkpoints_dir: str = "./checkpoints"
    is_train: bool = True
    seed: int = 0

    # ---- input/output sizes (base_options.py:30-34) ----
    batch_size: int = 1
    load_size: int = 256
    fine_size: int = 256
    output_nc: int = 3
    aspect_ratio: float = 1.0  # W/H; H = fine_size / aspect_ratio

    # ---- dataset (base_options.py:37-43 + dataset option setters) ----
    dataroot: str = "datasets/face/"
    dataset_mode: str = "fewshot_face"  # fewshot_face | fewshot_pose | fewshot_street
    label_nc: int = 0       # one-hot channels; 0 => raw label image used directly
    input_nc: int = 1       # label-map channels when label_nc == 0
    resize_or_crop: str = "scale_width"
    no_flip: bool = False
    num_workers: int = 4
    max_dataset_size: int = 2**31

    # pose-only flags (fewshot_pose_dataset.py:26-29)
    pose_type: str = "both"          # 'both' (densepose+openpose) | 'open'
    remove_face_labels: bool = False
    refine_face: bool = False
    basic_point_only: bool = False
    # face-only flag (fewshot_face_dataset.py:24)
    no_upper_face: bool = False

    # ---- generator (base_options.py:53-60) ----
    netG: str = "fewshot"
    n_downsample_G: int = 5
    ngf: int = 32
    norm_G: str = "spectralspadesyncbatch"
    conv_ks: int = 3
    embed_ks: int = 1
    spade_ks: int = 1
    netS: str = "encoderdecoder"

    # ---- reference encoder (base_options.py:63-64) ----
    use_label_ref: str = "mul"       # 'mul' | 'concat'
    res_for_ref: bool = False

    # ---- adaptive weight generation (base_options.py:67-71) ----
    adaptive_conv: bool = False
    adaptive_spade: bool = False
    no_adaptive_embed: bool = False
    n_adaptive_layers: int = 4
    n_fc_layers: int = 2

    # ---- temporal / flow (base_options.py:74-88) ----
    n_frames_G: int = 2
    n_frames_per_gpu: int = 1
    no_flow_gt: bool = False
    n_downsample_F: int = 3
    nff: int = 32
    n_blocks_F: int = 6
    norm_F: str = "spectralsyncbatch"
    flow_multiplier: float = 20.0
    spade_combine: bool = False
    n_sc_layers: int = 2
    sc_arch: str = "unet"
    add_raw_output_loss: bool = False
    sep_flow_prev: bool = False
    no_sep_warp_embed: bool = False

    # ---- attention / multi-reference (base_options.py:91-93) ----
    n_shot: int = 1
    n_downsample_A: int = 2
    warp_ref: bool = False

    # ---- discriminators (base_options.py:96-104) ----
    which_model_netD: str = "multiscale"
    netD_subarch: str = "n_layers"
    num_D: int = 1
    n_layers_D: int = 4
    ndf: int = 32
    norm_D: str = "spectralinstance"
    gan_mode: str = "hinge"          # ls | original | hinge | w
    add_face_D: bool = False
    adaptive_D_layers: int = 1

    # ---- loss weights (base_options.py:106-116) ----
    lambda_kld: float = 0.0
    lambda_feat: float = 10.0
    lambda_temp: float = 0.0
    lambda_flow: float = 10.0
    lambda_mask: float = 10.0
    lambda_vgg: float = 10.0
    lambda_face: float = 10.0
    no_ganFeat_loss: bool = False
    no_vgg_loss: bool = False
    no_TTUR: bool = False

    # fake-image replay pool for the D update (train_options/ImagePool;
    # the reference hard-codes ImagePool(0) — never queried — at
    # loss_collector.py:31, so 0 reproduces it; >0 enables a real pool)
    pool_size: int = 0

    # ---- optimizer (base_options.py:119-124) ----
    lr: float = 4e-4
    beta1: float = 0.5
    beta2: float = 0.999
    init_type: str = "xavier"
    init_variance: float = 0.02

    # ---- schedule (train_options.py:27-36) ----
    niter: int = 50
    niter_decay: int = 50
    niter_single: int = 50
    niter_step: int = 10
    n_frames_D: int = 2
    n_frames_total: int = 2
    max_t_step: int = 4
    save_epoch_freq: int = 5
    print_freq: int = 100
    display_freq: int = 100
    save_latest_freq: int = 1000

    # ---- inference (test_options.py, base_options.py:126) ----
    finetune: bool = False
    finetune_iters: int = 100        # vid2vid_model.py:218
    # start training from a pretrained checkpoint directory
    # (train_options.py:16 --load_pretrain; base_model.py:57-66)
    load_pretrain: str = ""
    seq_path: str = ""
    ref_img_path: str = ""
    ref_img_id: str = "0"
    how_many: int = 300
    results_dir: str = "./results/"
    which_epoch: str = "latest"

    # ---- precision and resume ----
    compute_dtype: str = "bfloat16"  # 'bfloat16': convolutions and matrix
    # products under autocast; parameters, optimizer moments and losses f32
    continue_train: bool = False     # resume from <checkpoints_dir>/<name>/latest
    remat: bool = False  # recompute the generator's SPADE up blocks, flow
    # nets and SC embedders and the perceptual loss's VGG19 in the backward
    # (torch.utils.checkpoint) instead of keeping their activations

    # ---- training-only switches of the JAX package ----
    flow_teacher: str = "flownet2"   # 'flownet2' | 'none'
    step_mode: str = "vjp"           # 'vjp' (default: ONE vjp-linearized
    # generation shared by the D and G phases — bitwise step-1 parity, one
    # full generator forward cheaper) | 'faithful' (training/step.py::
    # train_step_faithful — the reference's exact alternation, two generator
    # forwards per iteration with per-phase spectral advancement; every-step
    # loss parity with torch, docs/CONVERGENCE.md).  CLI: train.py --faithful
    sn_power_iters: int = 1          # spectral u/v power iterations per step;
    # 1 = exact step-1 parity with the reference's D phase, 2 = match its
    # effective 2-forwards-per-iteration advancement (long-horizon GAN
    # dynamics, measured in docs/CONVERGENCE.md "Drift diagnosis")
    debug: bool = False

    # ------------------------------------------------------------------
    # derived
    # ------------------------------------------------------------------
    @property
    def height(self) -> int:
        return int(self.fine_size / self.aspect_ratio)

    @property
    def width(self) -> int:
        return self.fine_size

    def valid_nc(self, raw_nc: int) -> int:
        """Channels that use_valid_labels leaves of a raw label of `raw_nc`:
        the 'open' pose type drops the three DensePose channels."""
        return raw_nc - 3 if self.is_pose and self.pose_type == "open" else raw_nc

    @property
    def gen_input_nc(self) -> int:
        """Generator semantic-input channels (generator.py:63): those of the
        valid labels, which the 'open' pose type strips of the three
        DensePose channels (input_process.use_valid_labels)."""
        return self.valid_nc(self.label_nc if self.label_nc != 0 else self.input_nc)

    @property
    def netD_input_nc(self) -> int:
        """Main discriminator input channels (base_model.py:186-188): the
        target's valid label, and with concat_ref_for_D the reference's raw
        label, each with an image and, for pose, a foreground mask."""
        raw_nc = self.label_nc if (self.label_nc != 0 and not self.is_pose) else self.input_nc
        extra = self.output_nc + (1 if self.concat_fg_mask_for_D else 0)
        nc = self.valid_nc(raw_nc) + extra
        if self.concat_ref_for_D:
            nc += raw_nc + extra
        return nc

    @property
    def is_pose(self) -> bool:
        return "pose" in self.dataset_mode

    @property
    def is_face(self) -> bool:
        return "face" in self.dataset_mode

    @property
    def is_street(self) -> bool:
        return "street" in self.dataset_mode

    @property
    def has_fg(self) -> bool:
        return self.is_pose  # base_model.py:31

    @property
    def concat_ref_for_D(self) -> bool:
        # base_model.py:33
        return (self.is_train or self.finetune) and self.netD_subarch == "n_layers"

    @property
    def concat_fg_mask_for_D(self) -> bool:
        return self.has_fg  # base_model.py:34

    @property
    def adap_embed(self) -> bool:
        return self.adaptive_spade and not self.no_adaptive_embed  # generator.py:47

    @property
    def n_adaptive(self) -> int:
        return self.n_adaptive_layers if self.n_adaptive_layers != -1 else self.n_downsample_G

    @property
    def flow_temp_is_shared(self) -> bool:
        """Whether prev-flow net shares params with ref-flow net (generator.py:159)."""
        sep = self.sep_flow_prev or (self.n_frames_G != 2) or not self.warp_ref
        return not sep

    @property
    def prev_embedding_is_shared(self) -> bool:
        # generator.py:160
        sep = self.spade_combine and (not self.no_sep_warp_embed or not self.warp_ref)
        return self.spade_combine and not sep

    @property
    def tD(self) -> int:
        return min(self.n_frames_D, self.n_frames_G)  # base_model.py:266

    @property
    def use_kld(self) -> bool:
        return self.lambda_kld > 0

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

    def debug_shrink(self) -> "Config":
        """--debug mode: tiny nets + 1-epoch schedule (base_options.py:216-222)."""
        return self.replace(
            debug=True, ngf=4, ndf=4, niter=1, niter_decay=1, niter_step=1,
            niter_single=1, max_dataset_size=self.batch_size * 8,
            save_epoch_freq=1, display_freq=1, print_freq=1,
        )


# ----------------------------------------------------------------------
# Workload presets = dataset modify_commandline_options + canonical scripts
# ----------------------------------------------------------------------

def face_config(**kw) -> Config:
    """Face edge->talking-head (fewshot_face_dataset.py:19-30 + scripts/face/train_g1_256.sh)."""
    base = dict(
        dataset_mode="fewshot_face", dataroot="datasets/face/",
        label_nc=0, input_nc=1, aspect_ratio=1.0,
        adaptive_spade=True, warp_ref=True, spade_combine=True,
    )
    base.update(kw)
    return Config(**base)


def pose_config(**kw) -> Config:
    """DensePose+OpenPose->dance video (fewshot_pose_dataset.py:21-35 + scripts/pose/train_g1.sh)."""
    base = dict(
        dataset_mode="fewshot_pose", dataroot="datasets/pose/",
        label_nc=0, input_nc=6, aspect_ratio=0.5,
        adaptive_spade=True, warp_ref=True, spade_combine=True,
        remove_face_labels=True, add_face_D=True,
        niter=100, niter_single=100, remat=True,
    )
    base.update(kw)
    return Config(**base)


def street_config(**kw) -> Config:
    """Street segmentation->video (fewshot_street_dataset.py:18-33 + scripts/street/train_g1.sh)."""
    base = dict(
        dataset_mode="fewshot_street", dataroot="datasets/street/",
        label_nc=20, input_nc=3, aspect_ratio=2.0,
        resize_or_crop="random_scale_and_crop",
        adaptive_spade=True, load_size=512, fine_size=512,
        niter=20, niter_single=10, niter_step=2, save_epoch_freq=1,
    )
    base.update(kw)
    return Config(**base)


PRESETS = {
    "face": face_config,
    "pose": pose_config,
    "street": street_config,
}


def preset(workload: str, **kw) -> Config:
    return PRESETS[workload](**kw)
