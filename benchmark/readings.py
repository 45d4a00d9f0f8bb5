"""The readings that a serving cell's limits are set from: for each seed,
the comparison's numbers of the program (arm `program`) and of the control
(arm `control`), in one process, at the cell's own size, after a short
window at the cell's own load. Not run by the benchmark's runs.

    python3 benchmark/readings.py --workload <cell> --arm program|control|<fault> --seeds 1,2,3 [--seconds 2]

The control is the configuration's "control" block: a precision of the
reference (`harness/serve.reference_producer`: the reference with every
conv of at least `min_ch` input channels fake-quantized at `bits`,
calibrated on the cell's calibration batches), standing in for the served
detections; or `program`, another configuration file whose program path is
the lower precision (bf16's own static int8), served as the cell's program
is. A fault's name (harness/faults.py) reads the program with that fault
underneath. One JSON line a seed.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import faults  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--arm", choices=("program", "control", *faults.FAULTS), required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from harness import serve, spec

    cell = spec.load_cell(args.workload, ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run_cell = cell
        if args.arm == "control" and "program" in cell.config["control"]:
            run_cell = spec.load_cell(args.workload, ROOT)
            run_cell.config = spec.load_config(cell.config["control"]["program"], ROOT)
        s = serve.Serve(run_cell, seed, args.device, fault=faults.FAULTS.get(args.arm))
        control = None
        if args.arm == "control" and "program" not in cell.config["control"]:
            control = cell.config["control"]
        w = s.window(args.seconds, False)
        pool, state_dict = s.pool, s.state_dict
        s.release()
        readings = serve.reference_readings(cell, seed, pool, w.served, state_dict, args.device, control)
        readings.update(workload=args.workload, arm=args.arm, seed=seed, batches=w.batches,
                        seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps(readings), flush=True)
        del s, w, pool, state_dict
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
