"""The benchmark's plain reference: a frozen copy of the port's model, step,
teacher and pipeline code in plain PyTorch (the attention and the
correlation in their plain versions), importing nothing of
fsvid2vid_tpu_torch, fsvid2vid_tpu or JAX.  Later changes to the port do not
reach it, so it stays the yardstick that `correct` is decided against."""
