"""Rank bodies of the port's multi-process tests, run in processes spawned by
`tests/torch_port_util.run_gloo`. This module imports torch, numpy and the
port only (no jax), so that a spawned process starts fast.

Each body runs inside a gloo process group that `_child` has joined, and
returns a picklable result that `_child` saves for the parent.
"""
import contextlib
import os
from datetime import timedelta

import torch
import torch.distributed as dist

RENDEZVOUS_TIMEOUT_S = 60


def _child(rank, world, port, out_dir, fn, args, join_group):
    """Entry of a spawned rank: torchrun's environment, the gloo group
    (unless the body joins it itself), the body, its result saved."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), OMP_NUM_THREADS="2")
    torch.set_num_threads(2)
    if join_group:
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world,
                                timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    try:
        result = fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


# --- SyncBN ------------------------------------------------------------------

def syncbn_rank(shards, weights):
    """This rank's shard (N_r, C, H, W) f64 through sync_batch_moments:
    (var, mean), and the gradient of L = sum(w_var * var + w_mean * mean)
    with respect to the shard, each rank backpropagating its share L / world
    as the train step does; with the number of all-reduces issued."""
    from dd3d_tpu_torch.models.layers import sync_batch_moments

    x = torch.from_numpy(shards[dist.get_rank()]).requires_grad_(True)
    before = sync_batch_moments.calls
    var, mean = sync_batch_moments(x)
    loss = (torch.from_numpy(weights[0]) * var + torch.from_numpy(weights[1]) * mean).sum()
    (loss / dist.get_world_size()).backward()
    return {"var": var.detach().numpy(), "mean": mean.detach().numpy(), "grad": x.grad.numpy(),
            "calls": sync_batch_moments.calls - before}


# --- DDP train steps -----------------------------------------------------------

def small_train_cfg(accumulate: int = 1):
    """dd3d_kitti_dla34 cut to a CPU test as tests/test_torch_train.py cuts
    it: FPN 64, 1-conv towers, f32, the stem dW routed (its plain version
    here); lr 1e-3 from step 0 and the gradient clipped to norm 10, as
    scripts/overfit_smoke.py trains (the raw gradient's norm is ~5e3 at
    these weights)."""
    from dd3d_tpu_torch.configs import get_experiment_cfg

    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.PALLAS_STEM_DW = True
    cfg.FE.FPN.OUT_CHANNELS = 64
    cfg.DD3D.FCOS2D.NUM_CLS_CONVS = cfg.DD3D.FCOS2D.NUM_BOX_CONVS = cfg.DD3D.FCOS3D.NUM_CONVS = 1
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS = 0.001, 0
    clip = cfg.SOLVER.CLIP_GRADIENTS
    clip.ENABLED, clip.CLIP_TYPE, clip.CLIP_VALUE = True, "norm", 10.0
    cfg.SOLVER.ACCUMULATE_GRAD_BATCHES = accumulate
    return cfg


def seeded_small_model(cfg, seed=0):
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.training.synthetic import seed_norm_statistics

    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    return seed_norm_statistics(model, torch.Generator().manual_seed(seed + 1))


@contextlib.contextmanager
def float_means_double():
    """Inside, `Tensor.float()` casts to f64 and new float tensors are f64,
    so that the port's explicit f32 casts and constants run in f64 too (as
    tests/test_torch_train.py's f64 oracle does)."""
    default, original = torch.get_default_dtype(), torch.Tensor.float
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self, *args, **kwargs: self.double(*args, **kwargs)
    try:
        yield
    finally:
        torch.Tensor.float = original
        torch.set_default_dtype(default)


def ddp_steps(batches, accumulate: int = 1, f64: bool = False):
    """The small model's train steps on `batches` (one per step, this rank's
    part of each global batch when a group is joined), through
    DistributedDataParallel when it is, in f32 or f64: the losses of each
    step, the gradients and parameters after the last, and the BN running
    stats."""
    from dd3d_tpu_torch.parallel.mesh import wrap_model
    from dd3d_tpu_torch.training.train_loop import create_train_state, to_device
    from dd3d_tpu_torch.training.train_step import make_train_step

    cfg = small_train_cfg(accumulate)
    model = seeded_small_model(cfg)
    if f64:
        cfg.TPU.COMPUTE_DTYPE = "float64"
        model = model.double()
        model.dtype = torch.float64
        trunk = model.backbone.bottom_up
        for m in (trunk.base_layer, *trunk.level0):
            m.weight_grad_plain = True  # the plain dW takes any dtype
    state = create_train_state(cfg, model, "cpu")
    step = make_train_step(cfg, wrap_model(state.model), state.optimizer)
    losses = []
    with float_means_double() if f64 else contextlib.nullcontext():
        for b in batches:
            b = {k: v.double() if v.is_floating_point() else v for k, v in to_device(b, "cpu").items()} if f64 \
                else to_device(b, "cpu")
            losses.append({k: float(v) for k, v in step(b).items()})
    model = state.model
    return {"losses": losses,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))},
            "optimizer_count": state.optimizer.count}


def ddp_rank(global_batches, accumulate: int = 1, f64: bool = False):
    """This rank's half of every global batch through `ddp_steps`."""
    rank, world = dist.get_rank(), dist.get_world_size()
    local = []
    for b in global_batches:
        n = len(b["image"]) // world
        local.append({k: v[rank * n:(rank + 1) * n] for k, v in b.items()})
    return ddp_steps(local, accumulate, f64)


# --- the loader ----------------------------------------------------------------

def loader_batches(cfg_overrides, n_batches: int):
    """The first `n_batches` (batch, meta) of the port's TrainDataLoader,
    at this process's rank, for dd3d_kitti_dla34_overfit with overrides."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.build import TrainDataLoader
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.training.train_loop import close_iterator

    cfg = get_experiment_cfg("dd3d_kitti_dla34_overfit")
    for key, value in cfg_overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    register_datasets(cfg)
    it = iter(TrainDataLoader(cfg))
    try:
        return [next(it) for _ in range(n_batches)]
    finally:
        close_iterator(it)


# --- the CLI -------------------------------------------------------------------

def cli_rank(argv):
    """dd3d_tpu_torch.train.main(argv) on this rank (it joins the group
    from torchrun's environment itself); the run's directory."""
    from dd3d_tpu_torch.train import main

    return main(argv)


# --- evaluation ----------------------------------------------------------------

def seeded_detections(dataset_dicts, seed: int = 0):
    """Per-image detections in the evaluators' input schema (the dicts of
    `unpack_detections`), made from the dataset's ground truth so that AP
    is neither 0 nor 100: each ground-truth box jittered (3D centre by
    ~0.4 m, size by up to 10 %, 2D box by ~3 px; scores 0.5-1), two false
    positives an image at random places and classes (scores 0-0.6), and the
    first image's ground truth missed."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for i, d in enumerate(dataset_dicts):
        annos = [] if i == 0 else d.get("annotations", [])
        n, k = len(annos), 2
        vec = np.asarray([a["bbox3d"] for a in annos], np.float64).reshape(n, 10)
        quat = np.concatenate([vec[:, :4], rng.normal(size=(k, 4))])
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        tvec = np.concatenate([vec[:, 4:7] + rng.normal(0, 0.4, (n, 3)),
                               rng.uniform([-10, 0.5, 10], [10, 2, 50], (k, 3))])
        size = np.concatenate([vec[:, 7:] * rng.uniform(0.9, 1.1, (n, 3)), rng.uniform(0.5, 4, (k, 3))])
        corner = rng.uniform([0, 100], [1100, 300], (k, 2))
        boxes2d = np.concatenate([np.asarray([a["bbox"] for a in annos], np.float64).reshape(n, 4)
                                  + rng.normal(0, 3, (n, 4)),
                                  np.concatenate([corner, corner + rng.uniform(20, 150, (k, 2))], axis=1)])
        scores = np.concatenate([rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 0.6, k)]).astype(np.float32)
        out.append({
            "image_id": d["image_id"], "sample_id": d.get("sample_id"),
            "classes": np.asarray([a["category_id"] for a in annos] + list(rng.randint(0, 5, k)), np.int64),
            "scores": scores, "scores_3d": (scores * rng.uniform(0.5, 1.0, n + k)).astype(np.float32),
            "boxes2d": boxes2d, "quat": quat.astype(np.float32), "tvec": tvec.astype(np.float32),
            "size": size.astype(np.float32)})
    return out


def register_fixture(root: str):
    """The port's KITTI datasets of the fixture at `root`; its train split's
    dataset dicts."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.catalog import DatasetCatalog, register_datasets

    cfg = get_experiment_cfg("dd3d_kitti_dla34_overfit")
    cfg.DATASET_ROOT = root
    register_datasets(cfg)
    return DatasetCatalog.get("kitti_3d_train")


def eval_rank(root: str, rank0_only: bool, out_dir: str):
    """`seeded_detections` of the fixture, this rank's InferenceSampler
    shard of them into the port's KITTI-3D (writing its JSON into
    `out_dir`) and COCO-2D evaluators, then `evaluate` on every rank: the
    results dicts, and the JSON predictions that rank 0 wrote (None on
    the others)."""
    import json

    from dd3d_tpu_torch.data.samplers import InferenceSampler
    from dd3d_tpu_torch.evaluators.coco2d import COCO2DEvaluator
    from dd3d_tpu_torch.evaluators.kitti_3d import KITTI3DEvaluator

    dets = seeded_detections(register_fixture(root))
    shard = [dets[i] for i in InferenceSampler(len(dets), dist.get_rank(), dist.get_world_size())]
    evaluators = [KITTI3DEvaluator("kitti_3d_train", output_dir=out_dir, rank0_only=rank0_only),
                  COCO2DEvaluator("kitti_3d_train")]
    for ev in evaluators:
        ev.process(shard)
    results = [ev.evaluate() for ev in evaluators]
    path = os.path.join(out_dir, "kitti_predictions.json")
    written = None
    if dist.get_rank() == 0:
        with open(path) as f:
            written = json.load(f)
    return {"results": results, "written": written, "n_local": len(shard)}


def failing_eval_cli_rank(argv):
    """dd3d_tpu_torch.train.main(argv) with its periodic test failing on
    this rank: what main raised, as a string (every rank must raise rather
    than skip the evaluators' gather, so that none waits in it)."""
    import dd3d_tpu_torch.train as train_cli

    def do_test(cfg, model, output_dir, step=None):
        raise RuntimeError(f"eval failed at step {step}")

    train_cli.do_test = do_test
    try:
        train_cli.main(argv)
    except RuntimeError as e:
        return str(e)
    return None


def seeded_nusc_detections(dataset_dicts, seed: int = 0):
    """Per-image detections of a nuScenes-style fixture in the evaluators'
    input schema (unpack_detections' dicts with attributes, speeds and the
    camera pose): each ground-truth box jittered (centre by ~0.3 m, size by
    up to 10 %), two false positives an image of random classes, the first
    image's ground truth missed, attributes 0-3 and speeds 0-8 m/s drawn."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for i, d in enumerate(dataset_dicts):
        annos = [] if i == 0 else d.get("annotations", [])
        n, k = len(annos), 2
        vec = np.asarray([a["bbox3d"] for a in annos], np.float64).reshape(n, 10)
        quat = np.concatenate([vec[:, :4], rng.normal(size=(k, 4))])
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        tvec = np.concatenate([vec[:, 4:7] + rng.normal(0, 0.3, (n, 3)), rng.uniform([-8, 0, 8], [8, 2, 40], (k, 3))])
        size = np.concatenate([vec[:, 7:] * rng.uniform(0.9, 1.1, (n, 3)), rng.uniform(0.5, 4, (k, 3))])
        scores = np.concatenate([rng.uniform(0.5, 1.0, n), rng.uniform(0.0, 0.6, k)]).astype(np.float32)
        out.append({
            "image_id": d["image_id"], "sample_id": d.get("sample_id"),
            "classes": np.asarray([a["category_id"] for a in annos] + list(rng.randint(0, 10, k)), np.int64),
            "scores": scores, "scores_3d": scores * np.float32(0.9), "boxes2d": rng.uniform(0, 100, (n + k, 4)),
            "quat": quat.astype(np.float32), "tvec": tvec.astype(np.float32), "size": size.astype(np.float32),
            "attributes": rng.randint(0, 4, n + k), "speeds": rng.uniform(0, 8, n + k).astype(np.float32),
            "pose": d["pose"]})
    return out


def register_nusc_fixture(root: str):
    """The port's datasets of the nuScenes-style fixture at `root` (its JSON
    manifest); the fixture's dataset dicts."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.data.catalog import DatasetCatalog, register_datasets
    from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE

    cfg = get_experiment_cfg("dd3d_nusc_dla34")
    cfg.DATASET_ROOT = root
    register_datasets(cfg)
    return DatasetCatalog.get(NUSC_FIXTURE)


def nusc_eval_rank(root: str, rank0_only: bool, out_dir: str):
    """`seeded_nusc_detections` of the fixture, this rank's
    InferenceGroupSampler shard of them (whole samples of 6 cameras) into
    the port's NuscenesEvaluator, then `evaluate` on every rank: the
    results dict and the submission this rank wrote (None if it wrote
    none)."""
    import json

    from dd3d_tpu_torch.data.samplers import InferenceGroupSampler
    from dd3d_tpu_torch.evaluators.nuscenes import NuscenesEvaluator
    from dd3d_tpu_torch.overfit_smoke import NUSC_FIXTURE

    dets = seeded_nusc_detections(register_nusc_fixture(root))
    shard = [dets[i] for i in InferenceGroupSampler(len(dets), 6, dist.get_rank(), dist.get_world_size())]
    rank_dir = os.path.join(out_dir, f"rank{dist.get_rank()}_eval")
    ev = NuscenesEvaluator(NUSC_FIXTURE, output_dir=rank_dir, rank0_only=rank0_only)
    ev.process(shard)
    results = ev.evaluate()
    path = os.path.join(rank_dir, "nusc_submission.json")
    written = None
    if os.path.exists(path):
        with open(path) as f:
            written = json.load(f)
    return {"results": results, "written": written, "n_local": len(shard)}
