"""Ops of the port: plain PyTorch (image_ops, batch_conv, warp, crop,
spectral_norm) and the wrappers of the hand-written CUDA kernels
(attention_kernel, cost_volume, norm_modulate), which build their kernels
on first use."""
from fsvid2vid_tpu_torch.ops.batch_conv import batch_conv  # noqa: F401
from fsvid2vid_tpu_torch.ops.image_ops import adaptive_avg_pool  # noqa: F401
