"""A cell cut to a size the CPU runs in seconds, for the tests: two frames
a batch on a 128x384 canvas, the rest of the cell as BENCHMARK.json has it."""
from harness import spec

TINY = {"batch": 2, "min_size_test": 96, "canvas": [128, 384], "pool": 2, "sample_images": 3, "warmup_batches": 1}


def tiny_cell(name: str, **config):
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, **TINY)
    cell.config = dict(cell.config, **config)
    return cell
