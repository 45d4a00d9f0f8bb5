"""Training and evaluation CLI of the port, counterpart of scripts/train.py:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m dd3d_tpu_torch.train +experiments=dd3d_kitti_dla34_overfit \\
        DATASET_ROOT=/path/to/fixture TEST.AUG.ENABLED=False [KEY=VALUE ...] [--device cpu]
    python -m dd3d_tpu_torch.train +experiments=dd3d_kitti_dla34_overfit EVAL_ONLY=True \\
        MODEL.CKPT=<checkpoint directory or .pth> TEST.AUG.ENABLED=False DATASET_ROOT=...

One process a card under torch.distributed.run (NCCL; gloo with
`--device cpu`), or one process alone without it. The flow of
scripts/train.py:46-213: compose the config (experiment delta + dotted-key
overrides), register the datasets, make a timestamped output directory under
OUTPUT_ROOT, build the model, then either
- EVAL_ONLY: load MODEL.CKPT (a checkpoint directory of the port, or a
  reference-named `.pth`/`.pt` state dict) and `do_test`; or
- `do_train`: the KITTI train loader with this rank's stream
  (data/build.py) into `train()` (training/train_loop.py: DDP with global
  SyncBN, checkpoints, metrics.jsonl), with `do_test` every TEST.EVAL_PERIOD
  steps, then the final `do_test` on the trained model.

`do_test` runs each rank's shard of DATASETS.TEST.NAME through
`inference_on_dataset` (forward, decode, NMS kernel) into the KITTI-3D and
COCO-2D evaluators, logs the results, and appends them to metrics.jsonl.

Not ported: test-time augmentation (TEST.AUG.ENABLED raises; ROADMAP §1
item 8), the visualizations (the visualizers, ROADMAP §1 item 3: the
dataloader's raises, the predictions' is skipped with a warning) and W&B.
"""
import argparse
import ast
import logging
import os
import time

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
    """Raise before anything is built for what the CLI does not have: the
    dataloader visualization of a training run, W&B, test-time augmentation
    (EVAL_ONLY and the final test after training would run it), and a
    remote MODEL.CKPT."""
    from dd3d_tpu_torch.training.checkpoint import REMOTE_PREFIXES
    from dd3d_tpu_torch.training.train_loop import check_unported_options

    if not cfg.EVAL_ONLY:
        check_unported_options(cfg, int(cfg.SOLVER.MAX_ITER), writes_output=True)
    if cfg.get("WANDB", {}).get("ENABLED", False):
        raise NotImplementedError("WANDB.ENABLED: W&B mirroring is not ported; metrics go to metrics.jsonl")
    if cfg.TEST.AUG.ENABLED:
        run = "EVAL_ONLY=True" if cfg.EVAL_ONLY else "the final test after training"
        raise NotImplementedError(f"TEST.AUG.ENABLED=True: {run} would run test-time augmentation, which is not "
                                  "ported (ROADMAP §1 item 8); set TEST.AUG.ENABLED=False")
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
            if comm.is_distributed():
                raise  # a rank that skips the evaluators' gather would leave the others waiting in it
            LOG.exception("Periodic eval failed")

    return train(cfg, data_iter(), model=model, device=device, output_dir=output_dir,
                 eval_hook=eval_hook if int(cfg.TEST.EVAL_PERIOD) > 0 else None)


def do_test(cfg, model, output_dir, step=None):
    """Evaluate `model` (or a DistributedDataParallel wrapper's module) on
    this rank's shard of DATASETS.TEST.NAME; every rank gets the merged
    results, which are logged and, on rank 0, appended to
    `<output_dir>/metrics.jsonl` at `step`."""
    from dd3d_tpu_torch.data.build import build_test_dataloader
    from dd3d_tpu_torch.evaluators import get_evaluator
    from dd3d_tpu_torch.models.postprocess import inference_on_dataset

    dataset_name = cfg.DATASETS.TEST.NAME
    loader = build_test_dataloader(cfg, dataset_name=dataset_name, shard_idx=comm.get_rank(),
                                   num_shards=comm.get_world_size())
    evaluators = get_evaluator(cfg, dataset_name, output_dir=output_dir)
    if cfg.get("VIS", {}).get("PREDICTIONS_ENABLED", False):
        LOG.warning("VIS.PREDICTIONS_ENABLED: the prediction visualization is not ported (the visualizers, ROADMAP §1 "
                    "item 3); no prediction images are written")
    results = inference_on_dataset(model, cfg, loader, evaluators)
    _log_results(results, output_dir, step)
    return results


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
            do_test(cfg, model.to(device), output_dir, step=step)
            return output_dir
        state = do_train(cfg, model, output_dir, device)
        do_test(cfg, state.model, output_dir, step=state.step)
        return output_dir
    finally:
        comm.cleanup()


if __name__ == "__main__":
    main()
