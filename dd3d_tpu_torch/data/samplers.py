"""Samplers: infinite shuffled training, repeat-factor, inference sharding;
the port's own copy of dd3d_tpu/data/samplers.py.

Rebuild of the reference's sampler roster (tridet/data/build.py:44-56,
76-84; tridet/data/samplers/group_sampler.py):
- TrainingSampler: infinite stream of shuffled epoch permutations,
- RepeatFactorTrainingSampler: category-frequency repeat factors
  (d2 semantics; r(c) = max(1, sqrt(t / f(c)))),
- InferenceSampler: contiguous shard per process,
- InferenceGroupSampler: keeps fixed-size groups (6-camera samples) on one
  shard (group_sampler.py:30-35).
"""
import math
from typing import Iterator, Sequence

import numpy as np


class TrainingSampler:
    def __init__(self, size: int, shuffle: bool = True, seed: int = 0):
        self._size = size
        self._shuffle = shuffle
        self._seed = seed

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            order = rng.permutation(self._size) if self._shuffle else np.arange(self._size)
            yield from order.tolist()


class RepeatFactorTrainingSampler:
    """cf. detectron2 RepeatFactorTrainingSampler as configured by
    DATALOADER.TRAIN.SAMPLER + REPEAT_THRESHOLD (tridet/data/build.py:48-56)."""

    def __init__(self, dataset_dicts: Sequence[dict], repeat_thresh: float, seed: int = 0, shuffle: bool = True):
        # category frequency = fraction of images containing the category
        counts = {}
        n = len(dataset_dicts)
        for d in dataset_dicts:
            cats = {a["category_id"] for a in d.get("annotations", [])}
            for c in cats:
                counts[c] = counts.get(c, 0) + 1
        freq = {c: v / n for c, v in counts.items()}
        cat_repeat = {c: max(1.0, math.sqrt(repeat_thresh / f)) for c, f in freq.items()}
        self._repeat_factors = []
        for d in dataset_dicts:
            cats = {a["category_id"] for a in d.get("annotations", [])}
            rf = max((cat_repeat[c] for c in cats), default=1.0)
            self._repeat_factors.append(rf)
        self._seed = seed
        self._shuffle = shuffle

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        rf = np.asarray(self._repeat_factors)
        while True:
            # stochastic rounding of fractional parts, per-epoch
            rands = rng.rand(len(rf))
            rep = (np.floor(rf) + (rands < (rf - np.floor(rf)))).astype(np.int64)
            indices = np.repeat(np.arange(len(rf)), rep)
            if self._shuffle:
                rng.shuffle(indices)
            yield from indices.tolist()


class InferenceSampler:
    def __init__(self, size: int, shard_idx: int = 0, num_shards: int = 1):
        shard = np.array_split(np.arange(size), num_shards)[shard_idx]
        self._indices = shard.tolist()

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class InferenceGroupSampler:
    """Shards in units of `group_size` consecutive items
    (tridet/data/samplers/group_sampler.py:7-41)."""

    def __init__(self, size: int, group_size: int, shard_idx: int = 0, num_shards: int = 1):
        if size % group_size != 0:
            raise ValueError(f"{size} items do not split into groups of {group_size}")
        num_groups = size // group_size
        groups = np.array_split(np.arange(num_groups), num_shards)[shard_idx]
        self._indices = [g * group_size + i for g in groups.tolist() for i in range(group_size)]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)
