"""Dataset registry and the batched, prefetching sequence loader (port of
fsvid2vid_tpu/data/loader.py).

Replaces the reference's torch DataLoader stack (data/__init__.py registry,
custom_dataset_data_loader.py with DistributedSampler) with a pool of
threads that prefetches batches and shards work by host: each process builds
a loader with its (shard_id, num_shards) and reads only its slice of the
global batch, as a DistributedSampler would (custom_dataset_data_loader.py
:20-23).  Every sample is drawn from its own RandomState, seeded by (seed,
epoch, step, global slot), so a batch does not depend on the number of
workers or shards.
"""
from __future__ import annotations

import collections
import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from fsvid2vid_tpu_torch.config import Config
from fsvid2vid_tpu_torch.data.face import FewshotFaceDataset
from fsvid2vid_tpu_torch.data.pose import FewshotPoseDataset
from fsvid2vid_tpu_torch.data.street import FewshotStreetDataset

DATASETS = {"fewshot_face": FewshotFaceDataset, "fewshot_pose": FewshotPoseDataset,
            "fewshot_street": FewshotStreetDataset}


def create_dataset(cfg: Config):
    """Name -> dataset instance (reference find_dataset_using_name,
    data/__init__.py:11-33)."""
    name = cfg.dataset_mode
    if name not in DATASETS:
        raise ValueError(f"unknown dataset_mode {name!r}; "
                         f"available: {sorted(DATASETS)}")
    return DATASETS[name](cfg)


def _collate(samples):
    """Stack per-sample dicts -> batch arrays.

    tgt_*: (B, T, H, W, C); ref_*: (B, K, H, W, C)."""
    out = {}
    for key in ("tgt_label", "tgt_image", "ref_labels", "ref_images"):
        out[key] = np.stack([s[key] for s in samples]).astype(np.float32)
    out["paths"] = [s.get("path") for s in samples]
    return out


class SequenceLoader:
    """Iterates batches of sequence samples, prepared by background threads
    when num_workers > 0.

    Each epoch yields `steps_per_epoch` batches of cfg.batch_size // num_shards
    samples (this host's share).  Set `n_frames_total` before each epoch for
    the temporal curriculum (base_dataset.update_training_batch)."""

    def __init__(self, cfg: Config, dataset=None, steps_per_epoch: int = 1000,
                 shard_id: int = 0, num_shards: int = 1, seed: int = 0,
                 num_workers: Optional[int] = None):
        self.cfg = cfg
        self.dataset = dataset or create_dataset(cfg)
        self.steps_per_epoch = min(
            steps_per_epoch,
            max(1, cfg.max_dataset_size // max(cfg.batch_size, 1)))
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_batch = max(1, cfg.batch_size // num_shards)
        self.seed = seed
        self.num_workers = (cfg.num_workers if num_workers is None
                            else num_workers)

    def set_epoch_frames(self, n_frames_total: int):
        self.dataset.n_frames_total = n_frames_total

    def _sample(self, dataset, epoch: int, step: int, slot: int) -> Dict:
        # deterministic per (epoch, step, global slot) seed
        global_slot = self.shard_id * self.local_batch + slot
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 10_007 + step * 131
             + global_slot) % (2 ** 31))
        index = step * self.cfg.batch_size + global_slot
        return dataset.sample(index % len(dataset), rng)

    def _batch(self, dataset, epoch: int, step: int) -> Dict:
        return _collate([self._sample(dataset, epoch, step, i)
                         for i in range(self.local_batch)])

    def epoch(self, epoch: int) -> Iterator[Dict]:
        """The epoch's batches in order.  With num_workers > 0 that many
        threads prepare them, up to num_workers + 2 ahead of the consumer.
        A sample writes scratch state into its dataset (crop scale, line
        width, normalisation distances), so each thread samples from its own
        copy of the dataset."""
        steps = range(self.steps_per_epoch)
        if self.num_workers <= 0:
            for step in steps:
                yield self._batch(self.dataset, epoch, step)
            return

        local = threading.local()

        def batch(step):
            if not hasattr(local, "dataset"):
                local.dataset = copy.deepcopy(self.dataset)
            return self._batch(local.dataset, epoch, step)

        pool = ThreadPoolExecutor(self.num_workers, thread_name_prefix="loader")
        pending = collections.deque()
        try:
            for step in steps:
                pending.append(pool.submit(batch, step))
                if len(pending) > self.num_workers + 2:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for f in pending:
                f.cancel()
            pool.shutdown(wait=True)
