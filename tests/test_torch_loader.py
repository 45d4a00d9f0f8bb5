"""The port's train loader (dd3d_tpu_torch/data/build.py: samplers, training
augmentations and mapper, collate, per-batch resize buckets, multi-rank
canvas pinning) against the JAX package's TrainDataLoader on the port's
KITTI-format fixture: the first 3 batches (every array of the batch, and the
meta) byte-identical, for world size 1 and for ranks 0 and 1 of 2, with both
samplers, flip and device-side color jitter on, on the thread path.

The JAX side's ranks come from jax.process_index()/process_count(),
monkeypatched inside the test; the port's from torch.distributed, in two
gloo processes. The port's process pool gives the thread path's batches.
"""
import jax
import numpy as np
import pytest

from dd3d_tpu.configs import get_experiment_cfg as jax_experiment_cfg
from dd3d_tpu.data import register_datasets as jax_register_datasets
from dd3d_tpu.data.build import TrainDataLoader as JaxTrainDataLoader
from dd3d_tpu_torch.overfit_smoke import make_fixture
from tests.torch_dist_workers import loader_batches
from tests.torch_port_util import run_gloo

N_BATCHES = 3
SAMPLERS = ["TrainingSampler", "RepeatFactorTrainingSampler"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("kitti")), n_images=8)


def overrides(root, sampler, use_processes=False):
    """dd3d_kitti_dla34_overfit at small resize buckets (three, so batches
    change shape), batch 4, flip and color jitter as configured."""
    return {"DATASET_ROOT": root, "INPUT.RESIZE.MIN_SIZE_TRAIN": [96, 112, 160], "SOLVER.IMS_PER_BATCH": 4,
            "DATALOADER.TRAIN.SAMPLER": sampler, "DATALOADER.TRAIN.USE_PROCESS_POOL": use_processes,
            "DATALOADER.TRAIN.NUM_WORKERS": 2}


def jax_batches(monkeypatch, cfg_overrides, rank, world):
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    cfg = jax_experiment_cfg("dd3d_kitti_dla34_overfit")
    for key, value in cfg_overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    assert cfg.INPUT.RANDOM_FLIP.ENABLED and cfg.INPUT.COLOR_JITTER.ENABLED
    jax_register_datasets(cfg)
    it = iter(JaxTrainDataLoader(cfg))
    try:
        return [next(it) for _ in range(N_BATCHES)]
    finally:
        it.close()


def assert_same_batches(got, want, what):
    shapes, boxes = set(), 0
    for i, ((batch, meta), (jbatch, jmeta)) in enumerate(zip(got, want)):
        assert list(batch) == list(jbatch), f"{what} batch {i}"
        for k, v in jbatch.items():
            assert batch[k].dtype == v.dtype and batch[k].shape == v.shape, f"{what} batch {i} {k}"
            assert batch[k].tobytes() == v.tobytes(), f"{what} batch {i} {k}"
        assert meta == jmeta, f"{what} batch {i} meta"
        assert "color_jitter" in batch
        shapes.add(batch["image"].shape)
        boxes += int(batch["gt_valid"].sum())
    assert len(got) == len(want) == N_BATCHES and boxes > 0
    return shapes


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_one_rank_batches_equal_jax(fixture_root, monkeypatch, sampler):
    o = overrides(fixture_root, sampler)
    shapes = assert_same_batches(loader_batches(o, N_BATCHES), jax_batches(monkeypatch, o, 0, 1), "world 1")
    assert len(shapes) > 1  # the resize bucket changes between batches


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_two_rank_batches_equal_jax(fixture_root, monkeypatch, tmp_path, sampler):
    o = overrides(fixture_root, sampler)
    ranks = run_gloo(loader_batches, 2, o, N_BATCHES, out_dir=tmp_path)
    for rank, got in enumerate(ranks):
        assert_same_batches(got, jax_batches(monkeypatch, o, rank, 2), f"rank {rank} of 2")
    # each rank draws its own samples, at the same canvas each step
    first = [np.asarray(r[0][0]["image"]) for r in ranks]
    assert first[0].shape == first[1].shape and not np.array_equal(first[0], first[1])


def test_process_pool_equals_thread_path(fixture_root):
    threads = loader_batches(overrides(fixture_root, "TrainingSampler"), 2)
    pool = loader_batches(overrides(fixture_root, "TrainingSampler", use_processes=True), 2)
    for (b, m), (pb, pm) in zip(threads, pool):
        assert m == pm and list(b) == list(pb)
        for k in b:
            assert b[k].tobytes() == pb[k].tobytes(), k
