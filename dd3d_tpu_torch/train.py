"""Training and evaluation CLI of the port, counterpart of scripts/train.py:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m dd3d_tpu_torch.train +experiments=dd3d_kitti_dla34_overfit \\
        DATASET_ROOT=/path/to/fixture [KEY=VALUE ...] [--device cpu]
    python -m dd3d_tpu_torch.train +experiments=dd3d_kitti_dla34_overfit EVAL_ONLY=True \\
        MODEL.CKPT=<checkpoint directory or .pth> DATASET_ROOT=...

One process a card under torch.distributed.run (NCCL; gloo with
`--device cpu`), or one process alone without it. The flow of
scripts/train.py:46-293: compose the config (experiment delta + dotted-key
overrides), register the datasets, make a timestamped output directory under
OUTPUT_ROOT, build the model, then either
- EVAL_ONLY: load MODEL.CKPT (a checkpoint directory of the port, or a
  reference-named `.pth`/`.pt` state dict), `do_test`, and with
  TEST.AUG.ENABLED the test-time-augmented test after it; or
- `do_train`: the KITTI train loader with this rank's stream
  (data/build.py) into `train()` (training/train_loop.py: DDP with global
  SyncBN, checkpoints, metrics.jsonl, the dataloader drawings under
  VIS.DATALOADER_ENABLED), with `do_test` every TEST.EVAL_PERIOD steps,
  then the final `do_test` on the trained model and, with
  TEST.AUG.ENABLED, the final test-time-augmented test.

`do_test` runs each rank's shard of DATASETS.TEST.NAME through
`inference_on_dataset` (forward, decode, NMS kernel) into the KITTI-3D and
COCO-2D evaluators, draws the predictions of its first 8 images into
`<output_dir>/visualization` (as the JAX package does, whatever
VIS.PREDICTIONS_ENABLED says), logs the results, and appends them to
metrics.jsonl. `do_test(use_tta=True)` runs each rank's shard through
models/tta.DD3DWithTTA in chunks of TEST.IMS_PER_BATCH / world size images;
its results carry the `tta/` prefix.

NuscenesDD3D (the nuScenes experiments) tests whole samples of 6 cameras:
the test loader groups them (InferenceGroupSampler) and the serving function
aggregates each sample's detections on the card (NUSC_SAMPLE_AGGREGATE); the
TTA test aggregates its merged detections on the host.

Not ported: W&B.
"""
import argparse
import ast
import logging
import os
import time

import numpy as np
import torch

from dd3d_tpu_torch.utils import comm

LOG = logging.getLogger("dd3d_tpu_torch.train")


def parse_overrides(pairs, cfg):
    """KEY=VALUE overrides (values parsed as Python literals); the
    `+experiments=NAME` selector is skipped."""
    for pair in pairs:
        if pair.startswith("+experiments="):
            continue
        if "=" not in pair:
            raise ValueError(f"Override must be KEY=VALUE: {pair!r}")
        key, val = pair.split("=", 1)
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = val
    return cfg


def check_unported(cfg) -> None:
    """Raise before anything is built for what the CLI does not have: W&B
    and a remote MODEL.CKPT."""
    from dd3d_tpu_torch.training.checkpoint import REMOTE_PREFIXES

    if cfg.get("WANDB", {}).get("ENABLED", False):
        raise NotImplementedError("WANDB.ENABLED: W&B mirroring is not ported; metrics go to metrics.jsonl")
    ckpt = str(cfg.MODEL.CKPT or "")
    if cfg.EVAL_ONLY and ckpt.startswith(REMOTE_PREFIXES):
        raise NotImplementedError(f"MODEL.CKPT={ckpt}: remote checkpoints are not fetched (no network); give a "
                                  "local .pth/.pt file or a checkpoint directory")


def do_train(cfg, model, output_dir, device):
    """The KITTI train loader (this rank's stream) into `train()`, with the
    periodic test every TEST.EVAL_PERIOD steps. Returns the TrainState."""
    from dd3d_tpu_torch.data.build import build_train_dataloader
    from dd3d_tpu_torch.training.train_loop import train

    loader = build_train_dataloader(cfg)

    def data_iter():
        for batch, _meta in loader:
            yield batch

    def eval_hook(step, state):
        LOG.info("Periodic eval at step %d", step)
        try:
            do_test(cfg, state.model, output_dir, step=step)
        except Exception:
            # logged and training goes on, as scripts/train.py:128-131: where
            # one rank failed, every rank raised here before the evaluators'
            # gather (comm.raise_if_any_rank_failed), so none waits in it
            LOG.exception("Periodic eval failed")

    return train(cfg, data_iter(), model=model, device=device, output_dir=output_dir,
                 eval_hook=eval_hook if int(cfg.TEST.EVAL_PERIOD) > 0 else None)


def do_test(cfg, model, output_dir, step=None, use_tta=False):
    """Evaluate `model` (or a DistributedDataParallel wrapper's module) on
    this rank's shard of DATASETS.TEST.NAME; every rank gets the merged
    results, which are logged and, on rank 0, appended to
    `<output_dir>/metrics.jsonl` at `step`. Each rank draws the predictions
    of its first 8 images into `<output_dir>/visualization`. `use_tta` runs
    the test-time-augmented test instead (`_do_test_tta`). A failure on any
    rank before the evaluators' gather raises on every rank."""
    from dd3d_tpu_torch.data.build import build_test_dataloader
    from dd3d_tpu_torch.evaluators import get_evaluator
    from dd3d_tpu_torch.models.postprocess import inference_on_dataset

    dataset_name = cfg.DATASETS.TEST.NAME
    if use_tta:
        return _do_test_tta(cfg, model, dataset_name, output_dir, step)
    group_size = group_size_of(cfg)
    try:
        loader = build_test_dataloader(cfg, dataset_name=dataset_name, group_size=group_size,
                                       shard_idx=comm.get_rank(), num_shards=comm.get_world_size())
        evaluators = get_evaluator(cfg, dataset_name, output_dir=output_dir)
    except Exception as e:  # join the agreement the other ranks hold in inference_on_dataset
        comm.raise_if_any_rank_failed(e)
    vis_dir = os.path.join(output_dir, "visualization") if output_dir else None
    results = inference_on_dataset(model, cfg, loader, evaluators, visualize_dir=vis_dir, group_size=group_size)
    _log_results(results, output_dir, step)
    return results


def group_size_of(cfg) -> int:
    """Images a sample: NuscenesDD3D's six cameras, else one
    (scripts/train.py:183-197)."""
    return 6 if cfg.MODEL.META_ARCHITECTURE == "NuscenesDD3D" else 1


def _do_test_tta(cfg, model, dataset_name, output_dir, step=None):
    """The test-time-augmented test (scripts/train.py:216-293): this rank's
    shard of the dataset (whole samples of 6 cameras for NuscenesDD3D,
    InferenceGroupSampler), read as uint8 frames in chunks of
    TEST.IMS_PER_BATCH / world size (a multiple of the sample size), through
    DD3DWithTTA.infer_batch, or NuscenesDD3DWithTTA's, whose merged
    detections of each sample then go through the sample aggregation when
    DD3D.INFERENCE.NUSC_SAMPLE_AGGREGATE is set, into the evaluators; the
    results carry the `tta/` prefix. A failure on any rank before the
    evaluators' gather raises on every rank."""
    from dd3d_tpu_torch.evaluators import get_evaluator

    error, evaluators, tta = None, [], None
    try:
        evaluators = get_evaluator(cfg, dataset_name, output_dir=output_dir)
        tta = _process_tta(cfg, model, dataset_name, evaluators)
    except Exception as e:  # this rank's part failed: every rank learns it before the gather
        error = e
    comm.raise_if_any_rank_failed(error)
    results = {}
    for ev in evaluators:
        r = ev.evaluate()
        if r:
            results.update({f"tta/{k}": v for k, v in r.items()})
    LOG.info("TTA canvas buckets (instances): %s; host seconds %s", dict(tta.stats["buckets"]),
             {k: round(v, 3) for k, v in tta.stats["seconds"].items()})
    _log_results(results, output_dir, step)
    return results


def _process_tta(cfg, model, dataset_name, evaluators):
    """This rank's part of `_do_test_tta`: its shard through the TTA model
    into the evaluators' `process`. Returns the TTA model (its stats)."""
    from dd3d_tpu_torch.data.catalog import DatasetCatalog
    from dd3d_tpu_torch.data.imageio import read_image_bgr
    from dd3d_tpu_torch.data.samplers import InferenceGroupSampler, InferenceSampler
    from dd3d_tpu_torch.models.cross_camera import get_group_idxs
    from dd3d_tpu_torch.models.tta import DD3DWithTTA, NuscenesDD3DWithTTA
    from dd3d_tpu_torch.structures.pose import Pose

    nuscenes = cfg.MODEL.META_ARCHITECTURE == "NuscenesDD3D"
    tta = (NuscenesDD3DWithTTA if nuscenes else DD3DWithTTA)(cfg, model)
    for ev in evaluators:
        ev.reset()
    dicts = DatasetCatalog.get(dataset_name)
    group_size = group_size_of(cfg)
    rank, world = comm.get_rank(), comm.get_world_size()
    if group_size > 1:
        sampler = InferenceGroupSampler(len(dicts), group_size, rank, world)
    else:
        sampler = InferenceSampler(len(dicts), rank, world)
    dicts = [dicts[i] for i in sampler]
    chunk_size = max(group_size, int(cfg.TEST.IMS_PER_BATCH) // world)
    chunk_size = max(group_size, (chunk_size // group_size) * group_size)
    aggregate = nuscenes and bool(cfg.DD3D.INFERENCE.get("NUSC_SAMPLE_AGGREGATE", False))
    for c in range(0, len(dicts), chunk_size):
        chunk = dicts[c:c + chunk_size]
        images = [read_image_bgr(d["file_name"]) for d in chunk]
        ks = [np.asarray(d["intrinsics"], np.float64).reshape(3, 3) for d in chunk]
        dets = []
        for d, out in zip(chunk, tta.infer_batch(images, ks)):
            det = {"image_id": d["image_id"], "sample_id": d.get("sample_id"), **out}
            if d.get("pose") is not None:
                det["pose"] = d["pose"]
            dets.append(det)
        per = group_size if nuscenes else len(chunk)  # JAX hands nuScenes dets over a sample at a time
        for g in range(0, len(chunk), per):
            group = dets[g:g + per]
            if aggregate:  # post-hoc 6-camera sample aggregation (nuscenes_dd3d_tta.py:57-73)
                t0 = time.perf_counter()
                group_idxs = get_group_idxs([d.get("sample_id") or "s" for d in group], group_size)
                poses = [Pose(wxyz=d["pose"]["wxyz"], tvec=d["pose"]["tvec"]) if d.get("pose") else Pose()
                         for d in chunk[g:g + group_size]]
                group = tta.aggregate_sample(group, group_idxs, cfg.DD3D.NUM_CLASSES, poses)
                tta.stats["seconds"]["aggregate"] += time.perf_counter() - t0
            for ev in evaluators:
                ev.process(group)
    return tta


def flatten_results(results, prefix="") -> dict:
    """{"kitti_3d": {"kitti_box3d_r40/Car_Easy_0.5": x}} -> {"kitti_3d/kitti_box3d_r40/Car_Easy_0.5": x}."""
    flat = {}
    for k, v in results.items():
        if isinstance(v, dict):
            flat.update(flatten_results(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _log_results(results, output_dir=None, step=None):
    """Log every result (scripts/train.py:203-213); rank 0 appends them to
    `<output_dir>/metrics.jsonl` as one line at `step`."""
    from dd3d_tpu_torch.utils.events import EventStorage

    flat = flatten_results(results)
    for k in sorted(flat):
        LOG.info("%s = %.4f", k, flat[k])
    if output_dir and comm.is_main_process():
        storage = EventStorage(output_dir)
        storage.put_scalars(int(step or 0), **flat)
        storage.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default; the card of LOCAL_RANK), or cpu")
    parser.add_argument("overrides", nargs="*", help="KEY=VALUE config overrides or +experiments=NAME")
    args = parser.parse_intermixed_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    experiment = args.experiment
    for o in args.overrides:
        if o.startswith("+experiments="):
            experiment = o.split("=", 1)[1]

    from dd3d_tpu_torch.configs import get_cfg, get_experiment_cfg
    from dd3d_tpu_torch.data.catalog import register_datasets
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.training.checkpoint import load_weights

    cfg = get_experiment_cfg(experiment) if experiment else get_cfg()
    cfg = parse_overrides(args.overrides, cfg)
    check_unported(cfg)

    device = comm.resolve_device(None if args.device == "cuda" else args.device)
    comm.init_distributed(device)
    try:
        LOG.info("Device %s (rank %d of %d)", device, comm.get_rank(), comm.get_world_size())
        if cfg.SOLVER.get("SYNCBN_USE_LOCAL_WORKERS", False):
            # Reference option (configs/common/optimizer.yaml:66-68): restrict
            # SyncBN stat sync to machine-local process groups. The port's
            # SyncBN all-reduces over the whole group; the flag is accepted
            # for config parity.
            LOG.warning("SOLVER.SYNCBN_USE_LOCAL_WORKERS requested: BN statistics sync over all ranks "
                        "(same training semantics, no local-group restriction).")
        register_datasets(cfg)

        # one directory for all ranks: rank 0's timestamp
        output_dir = comm.broadcast_from_master(
            os.path.join(cfg.OUTPUT_ROOT, experiment or "default", time.strftime("%Y%m%d_%H%M%S")))
        os.makedirs(output_dir, exist_ok=True)
        LOG.info("Output dir: %s", output_dir)

        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        if cfg.EVAL_ONLY:
            step = load_weights(model, cfg.MODEL.CKPT) if cfg.MODEL.CKPT else None
            model = model.to(device)
        else:
            state = do_train(cfg, model, output_dir, device)
            model, step = state.model, state.step
        do_test(cfg, model, output_dir, step=step)
        if cfg.TEST.AUG.ENABLED:  # the final test with TTA, like the reference (scripts/train.py:75-77)
            do_test(cfg, model, output_dir, step=step, use_tta=True)
        return output_dir
    finally:
        comm.cleanup()


if __name__ == "__main__":
    main()
