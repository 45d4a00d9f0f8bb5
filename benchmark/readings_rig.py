"""The readings that a rig cell's limits are set from: for each seed, the
comparison's numbers (reference/compare_rig.py) of the program (arm
`program`), of the control (arm `control`: the configuration's "control"
block, a precision of the reference standing in for the served
detections), or of the program with a fault of harness/faults_rig.py
underneath (arm: the fault's name); in one process, at the cell's own size,
after a short window at the cell's own load. Not run by the benchmark's
runs.

    python3 benchmark/readings_rig.py --workload <cell> --arm program|control|<fault> --seeds 1,2,3 [--seconds 2]

One JSON line a seed.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import faults_rig  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--arm", choices=("program", "control", *faults_rig.FAULTS), required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from harness import serve_rig, spec

    cell = spec.load_cell(args.workload, ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        s = serve_rig.RigServe(cell, seed, args.device, fault=faults_rig.FAULTS.get(args.arm))
        w = s.window(args.seconds, False)
        pool, state_dict = s.pool, s.state_dict
        s.release()
        control = cell.config["control"] if args.arm == "control" else None
        readings = serve_rig.reference_readings(cell, seed, pool, w.served, state_dict, args.device, control)
        readings.update(workload=args.workload, arm=args.arm, seed=seed, batches=w.batches,
                        correct=all(readings[k] <= v for k, v in cell.limits.items()),
                        seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps(readings), flush=True)
        del s, w, pool, state_dict
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
