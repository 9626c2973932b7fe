"""Rematerialisation (`cfg.remat`): the port's counterpart of the JAX
package's `nn.remat` / `jax.checkpoint` around the generator's up blocks,
flow nets and SC embedders and around VGG19.

`remat(fn, *args, modules=...)` runs `fn(*args)` under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: the backward
recomputes the forward instead of keeping its activations, so memory falls
and values and gradients do not move.  A train-mode forward of these
sub-nets writes buffers (spectral u / v advance, batch-norm running
statistics), so the recomputation must neither see the advanced values nor
advance them again: `modules`' buffers are copied before the forward, set
back to the copy while the backward recomputes it, and restored afterwards.
Under no_grad there is nothing to keep and `fn` runs as it is.

Each re-run in the backward is one span fsv.train.recompute and one count
in `remat.recomputes`.  On a CUDA device the backward, and so the span,
runs on autograd's own thread: its record has no parent span.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from fsvid2vid_tpu_torch.utils.profiling import span


def remat(fn: Callable, *args, modules: Iterable[nn.Module] = ()):
    if not torch.is_grad_enabled():
        return fn(*args)
    buffers = [b for m in modules for b in m.buffers()]
    before = []

    @contextlib.contextmanager
    def forward():
        before[:] = [b.detach().clone() for b in buffers]
        yield

    @contextlib.contextmanager
    def recompute():
        remat.recomputes += 1
        now = [b.detach().clone() for b in buffers]
        with torch.no_grad():
            for b, v in zip(buffers, before):
                b.copy_(v)
        try:
            with span("fsv.train.recompute"):
                yield
        finally:
            with torch.no_grad():
                for b, v in zip(buffers, now):
                    b.copy_(v)

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (forward(), recompute()))


remat.recomputes = 0
