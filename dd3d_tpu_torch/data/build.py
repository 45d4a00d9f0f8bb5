"""Dataloader builders: threaded map + prefetch, static-shape batches; the
port's own copy of dd3d_tpu/data/build.py.

Rebuild of `tridet/data/build.py` (build_train_dataloader /
build_test_dataloader) without torch's DataLoader:
- dataset dicts come from the DatasetCatalog (materialized once, in-process),
- filter-empty + class histogram (build.py:44-48),
- sampler selection (TrainingSampler / RepeatFactorTrainingSampler),
- a thread pool maps samples (the decode and resize release the GIL), or a
  pool of spawned processes (DATALOADER.TRAIN.USE_PROCESS_POOL),
- ONE resize scale is sampled PER BATCH (not per image) so every batch has a
  single shape: the number of distinct shapes a run meets is the number of
  resize buckets (cuDNN picks its algorithms once a shape).

Rank and world size come from torch.distributed (utils/comm.py), where the
JAX package reads its process index and count: one process a card, each
drawing its own stream and supplying IMS_PER_BATCH / world_size samples a
step, with the padded canvas pinned per bucket so that every rank's batch
has one shape.
"""
import hashlib
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from dd3d_tpu_torch.data.augmentations import ResizeShortestEdge, build_augmentation, resize_shortest_edge_dims
from dd3d_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from dd3d_tpu_torch.data.imageio import decode_resize_batch, oriented_image_size
from dd3d_tpu_torch.data.mapper import DatasetMapper, collate_batch
from dd3d_tpu_torch.data.samplers import (
    InferenceGroupSampler,
    InferenceSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
)
from dd3d_tpu_torch.utils import comm
from dd3d_tpu_torch.utils.tasks import TaskManager

LOG = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Process-pool mapping: the numpy-heavy mapper transforms hold the GIL, so a
# thread pool tops out around one core. Workers are spawned (not forked: the
# parent holds CUDA and NCCL threads); state is sent once via the
# initializer.
# ---------------------------------------------------------------------------
_POOL_STATE: dict = {}


def _pool_worker_init(cfg, dataset_dicts, mapper_kwargs):
    _POOL_STATE["cfg"] = cfg
    _POOL_STATE["dicts"] = dataset_dicts
    _POOL_STATE["mapper_kwargs"] = mapper_kwargs
    _POOL_STATE["mappers"] = {}


def _pool_map_sample(args):
    index, seed, fixed_size = args
    mappers = _POOL_STATE["mappers"]
    if fixed_size not in mappers:
        cfg = _POOL_STATE["cfg"]
        if fixed_size is not None:
            cfg = cfg.clone()
            cfg.INPUT.RESIZE.MIN_SIZE_TRAIN = [fixed_size]
        mappers[fixed_size] = DatasetMapper(
            build_augmentation(cfg, is_train=True), is_train=True, **_POOL_STATE["mapper_kwargs"]
        )
    return mappers[fixed_size](_POOL_STATE["dicts"][index], np.random.RandomState(seed))


# In-process index of a decoded-image cache dir: {digest: filename}. Filled
# by one listdir on first use, updated on store; avoids a glob per lookup.
_DECODED_CACHE_INDEX: Dict[str, Dict[str, str]] = {}


def _decoded_cache_key(path: str, size: int, max_size: int) -> Optional[str]:
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    return hashlib.sha1(f"{path}|{mtime}|{size}|{max_size}".encode()).hexdigest()


def _decoded_cache_lookup(cache_dir: str, key: Optional[str]):
    """(resized_image, (src_h, src_w)) or None. Source dims ride in the
    filename ("<digest>.<h>x<w>.npy") so a hit needs no source-file read."""
    if key is None:
        return None
    idx = _DECODED_CACHE_INDEX.get(cache_dir)
    if idx is None:
        idx = {}
        try:
            for fn in os.listdir(cache_dir):
                if fn.endswith(".npy"):
                    idx[fn.split(".", 1)[0]] = fn
        except OSError:
            pass
        _DECODED_CACHE_INDEX[cache_dir] = idx
    fn = idx.get(key)
    if fn is None:
        return None
    try:
        img = np.load(os.path.join(cache_dir, fn))
        h, w = fn.split(".")[1].split("x")
        return img, (int(h), int(w))
    except (OSError, ValueError, IndexError):
        idx.pop(key, None)
        return None


def _decoded_cache_store(cache_dir: str, key: Optional[str], img: np.ndarray, src_hw):
    if key is None:
        return
    fn = f"{key}.{src_hw[0]}x{src_hw[1]}.npy"
    tmp = os.path.join(cache_dir, f".{fn}.{os.getpid()}.tmp")
    try:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(tmp, img)
        # np.save appends .npy to paths without the suffix
        os.replace(tmp if tmp.endswith(".npy") else tmp + ".npy", os.path.join(cache_dir, fn))
        _DECODED_CACHE_INDEX.setdefault(cache_dir, {})[key] = fn
    except OSError:
        pass  # cache is best-effort; decode already succeeded


def _native_preresize(dataset_dicts, indices, augmentations, cache_dir: str = "", executor=None):
    """Decode+resize for a whole batch through the port's reader
    (data/imageio.decode_resize_batch, on `executor`'s threads), the
    counterpart of the JAX package's one OpenMP C call (cf. reference
    per-image cv2.imread + resize in DataLoader workers,
    tridet/data/dataset_mappers/dataset_mapper.py:110-127 /
    build.py:123-149). Applies when the first augmentation is a
    deterministic single-size ResizeShortestEdge (eval always; train when the
    batch's resize bucket is fixed and crop is off).

    With `cache_dir` set (DATALOADER.DECODED_CACHE_DIR), decoded+resized
    uint8 images are served from / stored to an on-disk .npy cache keyed by
    (path, mtime, resize-target).

    Returns a list aligned with `indices` of (resized_image, (src_h, src_w))
    — the mapper's `preresized` argument — with None entries for files that
    cannot be opened (the mapper's own read raises for them), or None when
    the fast path doesn't apply at all. A file that is neither a PNG nor a
    JPEG raises."""
    if not augmentations or not isinstance(augmentations[0], ResizeShortestEdge):
        return None
    r = augmentations[0]
    if len(r.short_edge_lengths) != 1 or int(r.short_edge_lengths[0]) == 0:
        return None
    size, max_size = int(r.short_edge_lengths[0]), r.max_size

    out = [None] * len(indices)
    keys = [None] * len(indices)
    miss = []
    for j, i in enumerate(indices):
        path = dataset_dicts[i]["file_name"]
        if cache_dir:
            keys[j] = _decoded_cache_key(path, size, max_size)
            hit = _decoded_cache_lookup(cache_dir, keys[j])
            if hit is not None:
                out[j] = hit
                continue
        miss.append(j)
    if miss:
        blobs = []
        for j in miss:
            try:
                with open(dataset_dicts[indices[j]]["file_name"], "rb") as f:
                    blobs.append(f.read())
            except OSError:
                blobs.append(b"")
        # the size of the image the JAX reader returns (turned where cv2 turns it); an unreadable file: the
        # mapper raises
        dims = [oriented_image_size(b) if b else None for b in blobs]
        targets = [resize_shortest_edge_dims(d[0], d[1], size, max_size) if d else None for d in dims]
        imgs = decode_resize_batch(blobs, targets, executor)
        for k, j in enumerate(miss):
            if imgs[k] is not None:
                out[j] = (imgs[k], dims[k])
                if cache_dir:
                    _decoded_cache_store(cache_dir, keys[j], imgs[k], dims[k])
    return out


def print_instances_class_histogram(dataset_dicts, class_names):
    counts = np.zeros(len(class_names), dtype=np.int64)
    for d in dataset_dicts:
        for a in d.get("annotations", []):
            if 0 <= a["category_id"] < len(class_names):
                counts[a["category_id"]] += 1
    LOG.info("Class histogram: %s", {n: int(c) for n, c in zip(class_names, counts)})
    return counts


class TrainDataLoader:
    """Infinite iterator of (batch, meta) with static shapes."""

    def __init__(self, cfg, dataset_name: Optional[str] = None, batch_size: Optional[int] = None,
                 num_workers: Optional[int] = None, seed: int = 0, size_divisibility: int = 128):
        dataset_name = dataset_name or cfg.DATASETS.TRAIN.NAME
        dicts = DatasetCatalog.get(dataset_name)
        # Task gating: only the detection tasks need non-empty annotations
        # (reference gates this with TaskManager, tridet/data/build.py:33-36 —
        # a depth-pretraining run keeps annotation-less images).
        tm = TaskManager(cfg)
        if tm.has_detection_task:
            dicts = [d for d in dicts if len(d.get("annotations", []))]  # filter empty
        md = MetadataCatalog.get(dataset_name)
        print_instances_class_histogram(dicts, md.get("thing_classes", []))
        self.dataset_dicts = dicts

        # Multi-rank: each rank draws an independent stream and supplies
        # IMS_PER_BATCH / world_size samples per step (the reference's
        # per-GPU batch split, tridet/data/build.py:123-128).
        self.num_shards = comm.get_world_size()
        self.rank = comm.get_rank()
        shard_seed = seed + 104729 * self.rank

        sampler_name = cfg.DATALOADER.TRAIN.SAMPLER
        if sampler_name == "RepeatFactorTrainingSampler":
            self.sampler = RepeatFactorTrainingSampler(dicts, cfg.DATALOADER.TRAIN.REPEAT_THRESHOLD, seed=shard_seed)
        else:
            self.sampler = TrainingSampler(len(dicts), seed=shard_seed)

        jitter_cfg = cfg if (cfg.INPUT.AUG_ENABLED and cfg.INPUT.COLOR_JITTER.ENABLED
                             and cfg.INPUT.COLOR_JITTER.get("ON_DEVICE", True)) else None
        # single source of truth for mapper construction — the default
        # mapper, the per-fixed-size thread-path mappers, and the spawned
        # workers must stay byte-identical
        self._mapper_kwargs = dict(
            box3d_on=tm.box3d_on,
            depth_on=tm.depth_on,
            nuscenes=cfg.MODEL.META_ARCHITECTURE == "NuscenesDD3D",
            device_jitter_cfg=jitter_cfg,
        )
        self.mapper = DatasetMapper(
            build_augmentation(cfg, is_train=True), is_train=True, **self._mapper_kwargs
        )
        total_batch = batch_size or cfg.SOLVER.IMS_PER_BATCH
        if total_batch % self.num_shards != 0:
            raise ValueError(f"IMS_PER_BATCH={total_batch} not divisible by {self.num_shards} ranks")
        self.batch_size = total_batch // self.num_shards  # local (per-process) batch
        self.max_gt = cfg.TPU.MAX_GT_PER_IMAGE
        self.size_divisibility = size_divisibility
        self.num_workers = num_workers if num_workers is not None else cfg.DATALOADER.TRAIN.NUM_WORKERS
        self.decoded_cache_dir = cfg.DATALOADER.get("DECODED_CACHE_DIR", "") or ""
        use_pp = cfg.DATALOADER.TRAIN.get("USE_PROCESS_POOL", "auto")
        if isinstance(use_pp, str):
            # CLI overrides arrive as strings; bool('false') is True, so a
            # user's USE_PROCESS_POOL=false must not silently enable the pool
            low = use_pp.strip().lower()
            if low in ("false", "off", "no", "0"):
                use_pp = False
            elif low in ("true", "on", "yes", "1"):
                use_pp = True
            elif low == "auto":
                use_pp = "auto"
            else:
                raise ValueError(f"USE_PROCESS_POOL={use_pp!r} (want true/false/auto)")
        if use_pp == "auto":
            # Spawned workers only pay off with real cores; on a 1-2 core box
            # the spawn+pickle overhead loses to GIL-released decode threads.
            use_pp = (os.cpu_count() or 1) >= 4
        self.use_processes = bool(use_pp) and self.num_workers > 0
        self.seed = seed
        self.min_sizes = list(cfg.INPUT.RESIZE.MIN_SIZE_TRAIN) if cfg.INPUT.AUG_ENABLED else []
        self.cfg = cfg
        # Batch KEY SET is config-derived (see collate_batch): data-derived
        # presence would change the batch's keys between batches and ranks.
        self._want_depth = bool(tm.depth_on)
        self._want_pose = bool(self._mapper_kwargs["nuscenes"])
        # Multi-rank: the padded canvas must be IDENTICAL across ranks (one
        # shape a step keeps the ranks' SyncBN and DDP collectives in step),
        # but each rank sees different images. Precompute the dataset-wide
        # worst-case canvas per resize bucket. Random crops change dims
        # unpredictably, so fall back to local-max padding (and accept
        # same-shape datasets only) when cropping is enabled.
        self._canvas_by_size = None
        if self.num_shards > 1 and self.min_sizes and not cfg.INPUT.CROP.ENABLED:
            dims = {(int(d["height"]), int(d["width"])) for d in dicts
                    if d.get("height") and d.get("width")}
            if dims:
                max_sz = cfg.INPUT.RESIZE.MAX_SIZE_TRAIN
                self._canvas_by_size = {}
                for s in self.min_sizes:
                    hw = [resize_shortest_edge_dims(h, w, s, max_sz) for (h, w) in dims]
                    self._canvas_by_size[s] = (max(x[0] for x in hw), max(x[1] for x in hw))
        if self.num_shards > 1 and self._canvas_by_size is None:
            # Without a pinned canvas each rank pads to its LOCAL max, and
            # the ranks' batch shapes diverge. Allow only when every dataset
            # dict shares one resolution (local max is then globally
            # identical); otherwise fail at setup, not mid-run.
            dims = {(d.get("height"), d.get("width")) for d in dicts}
            if len(dims) != 1 or None in next(iter(dims)):
                raise ValueError(
                    "multi-rank training needs a precomputable padded canvas: "
                    "dataset dicts must carry height/width and INPUT.CROP must be "
                    f"disabled, or all images must share one resolution (got {len(dims)} "
                    "distinct/unknown resolutions; per-rank local-max padding would "
                    "produce divergent global batch shapes)")
            LOG.warning(
                "multi-rank canvas pinning unavailable (crop enabled or no resize "
                "buckets); proceeding because all %d dataset dicts share resolution %s",
                len(dicts), next(iter(dims)))

    def __iter__(self) -> Iterator[tuple]:
        # Bucket (resize scale) choice must be IDENTICAL across ranks — one
        # shape per step on every rank — so it derives from the shared seed;
        # per-sample augmentation seeds come from a per-rank stream.
        rng = np.random.RandomState(self.seed + 1)
        local_rng = np.random.RandomState(self.seed + 7919 * (self.rank + 1))
        idx_iter = iter(self.sampler)
        if self.use_processes:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_pool_worker_init,
                initargs=(self.cfg, self.dataset_dicts, self._mapper_kwargs),
            )
        else:
            pool = ThreadPoolExecutor(max_workers=max(1, self.num_workers))
        prefetch: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def map_samples(indices, seeds, fixed_size):
            if self.use_processes:
                return list(pool.map(_pool_map_sample, [(i, s, fixed_size) for i, s in zip(indices, seeds)]))
            if fixed_size is not None:
                mapper_cfg = self.cfg.clone()
                mapper_cfg.INPUT.RESIZE.MIN_SIZE_TRAIN = [fixed_size]
                mapper = DatasetMapper(
                    build_augmentation(mapper_cfg, is_train=True), is_train=True, **self._mapper_kwargs
                )
            else:
                mapper = self.mapper
            # Batched decode+resize on the pool's threads; the mapper then
            # does only the geometry/annotation work. Returns None (full
            # per-image path) when crop is on or the resize bucket isn't fixed.
            pre = _native_preresize(self.dataset_dicts, indices, mapper.augmentations,
                                    cache_dir=self.decoded_cache_dir, executor=pool)
            if pre is None:
                pre = [None] * len(indices)
            return list(
                pool.map(
                    lambda args: mapper(
                        self.dataset_dicts[args[0]], np.random.RandomState(args[1]), preresized=args[2]
                    ),
                    zip(indices, seeds, pre),
                )
            )

        def make_batch():
            indices = [next(idx_iter) for _ in range(self.batch_size)]
            # one resize scale per batch -> one static shape per batch
            batch_rng = np.random.RandomState(rng.randint(2 ** 31))
            fixed_size = int(batch_rng.choice(self.min_sizes)) if self.min_sizes else None
            seeds = [int(local_rng.randint(2 ** 31)) for _ in indices]
            samples = map_samples(indices, seeds, fixed_size)
            canvas = self._canvas_by_size.get(fixed_size) if self._canvas_by_size else None
            return collate_batch(samples, self.max_gt, self.size_divisibility,
                                 want_depth=self._want_depth, want_pose=self._want_pose,
                                 canvas_hw=canvas)

        def producer():
            try:
                while not stop.is_set():
                    batch = make_batch()
                    # timeout-put so the thread observes `stop` even when the
                    # consumer is gone and the queue stays full (a plain
                    # blocking put would pin the pool + its worker processes
                    # for the rest of the process lifetime, e.g. all through
                    # the final eval after training ends).
                    while not stop.is_set():
                        try:
                            prefetch.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # incl. CancelledError from pool shutdown
                if not stop.is_set():
                    prefetch.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = prefetch.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer stuck in put()
            try:
                while True:
                    prefetch.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5)
            pool.shutdown(wait=False, cancel_futures=True)


class TestDataLoader:
    """Finite iterator over the test set in deterministic order."""

    def __init__(self, cfg, dataset_name: Optional[str] = None, batch_size: Optional[int] = None,
                 group_size: int = 1, shard_idx: int = 0, num_shards: int = 1, size_divisibility: int = 128):
        dataset_name = dataset_name or cfg.DATASETS.TEST.NAME
        self.dataset_dicts = DatasetCatalog.get(dataset_name)
        tm = TaskManager(cfg)
        self.mapper = DatasetMapper(
            build_augmentation(cfg, is_train=False),
            is_train=False,
            box3d_on=tm.box3d_on,
            depth_on=tm.depth_on,
            nuscenes=cfg.MODEL.META_ARCHITECTURE == "NuscenesDD3D",
        )
        if group_size > 1:
            self.sampler = InferenceGroupSampler(len(self.dataset_dicts), group_size, shard_idx, num_shards)
        else:
            self.sampler = InferenceSampler(len(self.dataset_dicts), shard_idx, num_shards)
        self.batch_size = batch_size or cfg.TEST.IMS_PER_BATCH
        self.max_gt = cfg.TPU.MAX_GT_PER_IMAGE
        self.size_divisibility = size_divisibility
        self.num_workers = cfg.DATALOADER.TEST.NUM_WORKERS
        self.decoded_cache_dir = cfg.DATALOADER.get("DECODED_CACHE_DIR", "") or ""

    def __len__(self):
        return -(-len(self.sampler) // self.batch_size)

    def __iter__(self):
        indices = list(self.sampler)
        # shared rng is safe ONLY because test-time transforms are
        # deterministic (ResizeShortestEdge with a single MIN_SIZE_TEST)
        rng = np.random.RandomState(0)
        with ThreadPoolExecutor(max_workers=max(1, self.num_workers)) as pool:
            for i in range(0, len(indices), self.batch_size):
                chunk = indices[i : i + self.batch_size]
                # Test-time resize is deterministic single-size, so the whole
                # chunk decodes+resizes at once on the pool's threads.
                pre = _native_preresize(self.dataset_dicts, chunk, self.mapper.augmentations,
                                        cache_dir=self.decoded_cache_dir, executor=pool)
                if pre is None:
                    pre = [None] * len(chunk)
                samples = list(pool.map(
                    lambda a: self.mapper(self.dataset_dicts[a[0]], rng, preresized=a[1]),
                    zip(chunk, pre)))
                yield collate_batch(samples, self.max_gt, self.size_divisibility,
                                    want_pose=bool(self.mapper.nuscenes))


def build_train_dataloader(cfg, **kw) -> TrainDataLoader:
    return TrainDataLoader(cfg, **kw)


def build_test_dataloader(cfg, **kw) -> TestDataLoader:
    return TestDataLoader(cfg, **kw)
