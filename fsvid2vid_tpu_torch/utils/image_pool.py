"""Classic GAN fake-image replay pool (the port's copy of
fsvid2vid_tpu/utils/image_pool.py; reference util/image_pool.py:10-37).

The reference instantiates it with size 0 (loss_collector.py:31), making it a
pass-through; the full replay behavior is implemented for parity.  Host-side
numpy state (pools are inherently stateful and tiny)."""
from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.rng = np.random.RandomState(seed)
        self.num_imgs = 0
        self.images = []

    def query(self, images: np.ndarray) -> np.ndarray:
        """images: (B, ...) batch; returns a batch mixing current fakes with
        replayed history (50% swap probability once the pool is full)."""
        if self.pool_size == 0:
            return images
        out = []
        for image in np.asarray(images):
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image.copy())
                out.append(image)
            elif self.rng.rand() > 0.5:
                idx = self.rng.randint(self.pool_size)
                out.append(self.images[idx].copy())
                self.images[idx] = image.copy()
            else:
                out.append(image)
        return np.stack(out)

    # ------------------------------------------------------------------
    # Split-phase API for the train step: the per-sample swap decision and
    # the replacement images are supplied BEFORE the step (begin_step), and
    # the freshly generated fakes stored AFTER it (commit).  Semantics match query(): once the pool
    # is full each sample has a 50% chance of being replaced by a stored fake,
    # and the stored slot is then overwritten with the current fake.
    # ------------------------------------------------------------------

    def begin_step(self, batch_size: int, image_shape):
        """Returns (pool_fake (B,*image_shape) f32, pool_mask (B,1,1,1) bool).
        Where mask is False the step uses the current fake and pool_fake holds
        zeros (ignored)."""
        fake = np.zeros((batch_size,) + tuple(image_shape), np.float32)
        mask = np.zeros((batch_size, 1, 1, 1), bool)
        self._swap_idx = [None] * batch_size
        for b in range(batch_size):
            if self.num_imgs >= self.pool_size and self.rng.rand() > 0.5:
                idx = self.rng.randint(self.pool_size)
                fake[b] = self.images[idx]
                mask[b, 0, 0, 0] = True
                self._swap_idx[b] = idx
        return fake, mask

    def commit(self, images: np.ndarray) -> None:
        """Store the step's generated fakes per the begin_step decisions."""
        images = np.asarray(images, np.float32)
        for b, image in enumerate(images):
            idx = self._swap_idx[b] if hasattr(self, "_swap_idx") else None
            if idx is not None:
                self.images[idx] = image.copy()
            elif self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image.copy())
