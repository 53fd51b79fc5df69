"""DataModule: dataset + splits + device pipeline as one object.

Port of ``superdiff_tpu/data/datamodule.py``: the folder-tree index per
split, per-split batch iterators (the native shard loader for shuffled
splits when ``training.use_native_loader`` is set and the library builds,
else ``BatchIterator`` with a shared decode cache), and the device-side
augment/normalize step keyed off the training config.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, Optional, Tuple

import torch

from superdiff_torch.config import Config
from superdiff_torch.data.dataset import BatchIterator, ChestXrayIndex
from superdiff_torch.data.transforms import prepare_batch

logger = logging.getLogger("superdiff_torch")


class DataModule:
    def __init__(self, cfg: Config, dataset_root: str,
                 data_shard: Optional[Tuple[int, int]] = None):
        self.cfg = cfg
        self.root = dataset_root
        # (process_index, process_count) for multi-process data
        # parallelism; None -> torch.distributed's rank and world size at
        # iterator-build time when a group of more than one process is
        # initialised, else unsharded
        self._data_shard = data_shard
        self._indices: Dict[str, ChestXrayIndex] = {}
        self._epochs: Dict[tuple, int] = {}
        self._decode_caches: Dict[tuple, dict] = {}

    def resolve_shard(self) -> Optional[Tuple[int, int]]:
        """The ``(process_index, process_count)`` this module shards batches
        by: the explicit tuple, else ``torch.distributed``'s rank and world
        size when it is initialised with more than one process, else
        None."""
        if self._data_shard is not None:
            return self._data_shard
        import torch.distributed as dist

        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return (dist.get_rank(), dist.get_world_size())
        return None

    def index(self, split: str) -> ChestXrayIndex:
        if split not in self._indices:
            self._indices[split] = ChestXrayIndex(
                self.root, task=self.cfg.task, split=split,
                class_filter=self.cfg.training.class_filter)
        return self._indices[split]

    def iterator(self, split: str, shuffle: Optional[bool] = None,
                 batch_size: Optional[int] = None,
                 epoch: Optional[int] = None):
        """A fresh iterator each call. The shuffle order still advances
        across calls: a per-(split, shuffle, batch_size) epoch counter folds
        into the seed when ``epoch`` is None; an explicit ``epoch`` replays
        that epoch and leaves the counter alone. The host decode cache is
        shared per split and preprocessing settings."""
        t = self.cfg.training
        shuffle = shuffle if shuffle is not None else (split == "train")
        bs = batch_size or t.batch_size
        if epoch is None:
            key = (split, shuffle, bs)
            epoch = self._epochs.get(key, 0)
            self._epochs[key] = epoch + 1
        return self._build_iterator(split, shuffle, bs, epoch)

    def _build_iterator(self, split: str, shuffle: bool, batch_size: int,
                        epoch: int):
        t = self.cfg.training
        shard = self.resolve_shard()
        if shard is not None:
            _, nproc = shard
            if batch_size % nproc:
                raise ValueError(
                    f"global batch_size {batch_size} not divisible by "
                    f"process_count {nproc}")
            batch_size //= nproc  # per-process local batch
        if t.use_native_loader and shuffle:
            it = self._native_iterator(split, batch_size, epoch,
                                       shard=shard)
            if it is not None:
                return it
        cache_key = (split, t.resolution, t.resize_strategy,
                     t.histogram_equalization)
        return BatchIterator(
            self.index(split),
            batch_size=batch_size,
            resolution=t.resolution,
            shuffle=shuffle,
            # eval splits keep the partial tail (the training loop
            # wrap-pads it back to one batch shape)
            drop_last=(split == "train"),
            seed=t.seed + epoch,
            resize_strategy=t.resize_strategy,
            histogram_equalization=t.histogram_equalization,
            cache=self._decode_caches.setdefault(cache_key, {}),
            shard=shard,
        )

    def shard_path(self, split: str) -> str:
        """Where the native loader keeps a split's shard: the JAX package's
        name, so either package reuses the other's."""
        t = self.cfg.training
        return os.path.join(
            self.root, ".shards",
            f"{self.cfg.task}_{split}_{t.resolution}"
            f"_{t.resize_strategy}"
            f"{'_he' if t.histogram_equalization else ''}"
            f"{'' if t.class_filter is None else f'_cf{t.class_filter}'}"
            ".xrc")

    def _native_iterator(self, split: str, batch_size: int, epoch: int = 0,
                         shard: Optional[Tuple[int, int]] = None):
        """The C++ mmap + prefetch loader over a shard built once; None (and
        a warning) when the library is unavailable."""
        from superdiff_torch.data.native_loader import (
            NativeBatchIterator, build_shard_from_index)

        if not NativeBatchIterator.available():
            logger.warning("native loader unavailable; %s batches come from "
                           "BatchIterator", split)
            return None
        t = self.cfg.training
        shard_path = self.shard_path(split)
        if not os.path.exists(shard_path):
            logger.info("building native shard %s", shard_path)
            build_shard_from_index(
                self.index(split), shard_path, t.resolution,
                resize_strategy=t.resize_strategy,
                histogram_equalization=t.histogram_equalization)
        return NativeBatchIterator(shard_path, batch_size,
                                   seed=t.seed + epoch, shard=shard)

    def device_batches(self, split: str,
                       generator: Optional[torch.Generator],
                       device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
        """Host batches -> ``device``: augmented (train only, draws from
        ``generator``, which lives on ``device``) and normalized float32
        NHWC images, int64 labels."""
        t = self.cfg.training
        aug = t.augmentation if split == "train" else "none"
        for batch in self.iterator(split):
            image = prepare_batch(
                torch.from_numpy(batch["image"]).to(device), generator,
                augmentation=aug, normalization=t.normalization)
            yield {"image": image,
                   "label": torch.from_numpy(batch["label"]).long().to(
                       device)}

    def class_counts(self, split: str) -> Dict[str, int]:
        return self.index(split).class_counts()
