"""One run of one benchmark cell of dd3d_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (inputs and weights from the seed, the
program's model, its static int8 calibration where the configuration asks
for it, a warm-up of the cell's shapes) counts as `setup_s`; then the cell's
mode runs for `--seconds`; then the program's state is freed and a seeded
sample of what the window produced is compared with the plain reference.
The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`: each number compared with its limit); the last lines of
standard error repeat the checks. With `--trace 0` the metrics are the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a profiler trace of the window.

Exits non-zero, printing no result, without enough CUDA cards, and when a
module of JAX or of the JAX package is loaded once the window has closed.
"""
import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches():
    """Every build and kernel cache of the run inside the checkout, at fixed
    paths, so that only a checkout's first run builds."""
    out = os.path.join(HERE, "out", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(out, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [HERE, ROOT]
    caches()
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from harness import cellrun, nojax, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # the host's work is the serving loop's; no idle pool spins beside it
    result, check_lines = cellrun.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", _START)
    found = nojax.loaded()
    if found:
        print(f"JAX modules loaded in the process that measured: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
