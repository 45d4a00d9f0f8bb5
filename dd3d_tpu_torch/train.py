"""Training CLI of the port, counterpart of scripts/train.py:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m dd3d_tpu_torch.train +experiments=dd3d_kitti_dla34_overfit \\
        DATASET_ROOT=/path/to/fixture [KEY=VALUE ...] [--device cpu]

One process a card under torch.distributed.run (NCCL; gloo with
`--device cpu`), or one process alone without it. The flow of
scripts/train.py:27-140: compose the config (experiment delta + dotted-key
overrides), register the datasets, make a timestamped output directory under
OUTPUT_ROOT, build the model, and `do_train`: the KITTI train loader with
this rank's stream (data/build.py) into `train()` (training/train_loop.py:
DDP with global SyncBN, checkpoints, metrics.jsonl).

Evaluation is not ported yet (ROADMAP §1 item 3): EVAL_ONLY=True and a
TEST.EVAL_PERIOD inside SOLVER.MAX_ITER raise, and where scripts/train.py
runs its final test this logs a warning and exits 0.
"""
import argparse
import ast
import logging
import os
import time

import torch

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
    """Evaluation and the visualizations are the next slice (ROADMAP §1
    item 3), W&B is not ported: raise before anything is built."""
    from dd3d_tpu_torch.training.train_loop import check_unported_options

    check_unported_options(cfg, int(cfg.SOLVER.MAX_ITER), writes_output=True)
    if cfg.get("WANDB", {}).get("ENABLED", False):
        raise NotImplementedError("WANDB.ENABLED: W&B mirroring is not ported; metrics go to metrics.jsonl")
    if cfg.EVAL_ONLY:
        raise NotImplementedError("EVAL_ONLY=True: evaluation is not ported yet (ROADMAP §1 item 3)")
    if 0 < int(cfg.TEST.EVAL_PERIOD) <= int(cfg.SOLVER.MAX_ITER):
        raise NotImplementedError(
            f"TEST.EVAL_PERIOD={cfg.TEST.EVAL_PERIOD} inside SOLVER.MAX_ITER={cfg.SOLVER.MAX_ITER}: periodic "
            "evaluation is not ported yet (ROADMAP §1 item 3); set TEST.EVAL_PERIOD=0")


def do_train(cfg, model, output_dir, device):
    """The KITTI train loader (this rank's stream) into `train()`."""
    from dd3d_tpu_torch.data.build import build_train_dataloader
    from dd3d_tpu_torch.training.train_loop import train

    loader = build_train_dataloader(cfg)

    def data_iter():
        for batch, _meta in loader:
            yield batch

    return train(cfg, data_iter(), model=model, device=device, output_dir=output_dir)


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
    from dd3d_tpu_torch.utils import comm

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
        do_train(cfg, model, output_dir, device)
        LOG.warning("The final test (do_test) is not ported yet (ROADMAP §1 item 3); checkpoints are in %s/ckpt",
                    output_dir)
        return output_dir
    finally:
        comm.cleanup()


if __name__ == "__main__":
    main()
