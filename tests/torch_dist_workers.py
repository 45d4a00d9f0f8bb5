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
