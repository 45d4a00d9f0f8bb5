"""The control of each serving cell comes out not correct: the cell's
configuration names it ("control"), either the reference fake-quantized to
the next precision below the configuration's, or the program's own path in
that precision. On the CPU at a tiny size, and on the card at the cell's
own size on three seeds (`cuda`), where the program on the same seeds comes
out correct."""
import pytest
import torch

from harness import serve, spec
from tiny import tiny_cell

SEEDS = (2 ** 35 + 1, 2 ** 35 + 2, 2 ** 35 + 3)


def control_readings(cell, seed, device, seconds=0.2):
    """(readings of the program, readings of the control) on one seed."""
    ctl = cell.config["control"]
    program = serve.Serve(cell, seed, device)
    w = program.window(seconds, False)
    pool, state_dict = program.pool, program.state_dict
    program.release()
    mine = serve.reference_readings(cell, seed, pool, w.served, state_dict, device)
    if "program" in ctl:
        other = spec.load_cell(cell.name)
        other.traffic = cell.traffic
        other.config = spec.load_config(ctl["program"])
        lower = serve.Serve(other, seed, device)
        w = lower.window(seconds, False)
        lower.release()
        theirs = serve.reference_readings(cell, seed, pool, w.served, state_dict, device)
    else:
        theirs = serve.reference_readings(cell, seed, pool, w.served, state_dict, device, control=ctl)
    return mine, theirs


def fails(cell, readings):
    return any(readings[k] > limit for k, limit in cell.limits.items())


@pytest.mark.parametrize("name", [w["name"] for w in spec._read_json(f"{spec.ROOT}/BENCHMARK.json")["workloads"]])
def test_control_is_not_correct_on_the_cpu(name):
    cell = tiny_cell(name)
    _, theirs = control_readings(cell, SEEDS[0], "cpu")
    assert fails(cell, theirs), theirs


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec._read_json(f"{spec.ROOT}/BENCHMARK.json")["workloads"]])
def test_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size runs only there")
    cell = spec.load_cell(name)
    for seed in SEEDS:
        mine, theirs = control_readings(cell, seed, "cuda", seconds=1.0)
        print(name, seed, {k: (mine[k], theirs[k]) for k in cell.limits})
        assert not fails(cell, mine), (seed, mine)
        assert fails(cell, theirs), (seed, theirs)
