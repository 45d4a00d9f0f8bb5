"""Whole runs of each cell past the harness's look for a card: the program
against the plain reference, which must come out correct; then the timed
path broken underneath, once for each fault a serving cell can have, which
must come out not correct. On the CPU at a tiny size with the program's
activations in f32, and on the card at the cells' own size and precision
(`cuda`)."""
import time

import numpy as np
import pytest
import torch

from harness import cellrun, faults, spec
from tiny import tiny_cell

CELLS = [w for w in spec._read_json(f"{spec.ROOT}/BENCHMARK.json")["workloads"]]
SERVE = [w["name"] for w in CELLS if spec.load_cell(w["name"]).traffic["mode"] == "serve"]
SEED = 2 ** 33 + 17


def run(name, fault=None, seed=SEED):
    cell = tiny_cell(name, dtype="float32")
    return cellrun.run(cell, seed, 0.2, False, "cpu", time.perf_counter(), fault=fault)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' own size and precision run only there")
    return "cuda"


@pytest.mark.parametrize("name", SERVE)
def test_sound_run_is_correct_and_prints_the_contract_line(name):
    result, lines = run(name)
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    cell = spec.load_cell(name)
    assert set(result["metrics"]) == {m.name for m in cell.end_to_end}
    assert set(result["checks"]) == set(cell.limits)
    assert all(np.isfinite(c["value"]) for c in result["checks"].values())
    assert lines[-1].startswith("correct True")


FAULTS = [f for name, f in faults.FAULTS.items() if name not in faults.WITHIN_ROUNDING]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", SERVE)
def test_a_broken_timed_path_is_not_correct(name, fault):
    result, lines = run(name, fault)
    assert not result["correct"], result["checks"]
    assert any(line.endswith("FAIL") for line in lines)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVE)
def test_on_the_card_sound_is_correct_and_each_fault_is_not(name, card):
    """At the cell's own batch, canvas and precision, a short window."""
    cell = spec.load_cell(name)
    sound, _ = cellrun.run(cell, SEED + 1, 2.0, False, card, time.perf_counter())
    assert sound["correct"], sound["checks"]
    for fault in FAULTS:
        result, _ = cellrun.run(spec.load_cell(name), SEED + 1, 2.0, False, card, time.perf_counter(), fault=fault)
        assert not result["correct"], (fault.__name__, result["checks"])
        print(name, fault.__name__, result["checks"])


def test_the_reference_decodes_what_the_program_serves():
    """In f32 the program's detections are the reference's own: the same
    count an image, scores and boxes within rounding."""
    from harness import serve
    from reference import compare, decode, plain

    cell = tiny_cell("kitti_dla34_bf16.serve_b128", dtype="float32")
    s = serve.Serve(cell, SEED, "cpu")
    det = {k: v.numpy() for k, v in s.request(s.pool[0]).items()}
    ref = plain.build(cell.config["model"], "cpu")
    ref.load_state_dict(s.state_dict)
    frames = torch.as_tensor(s.pool[0]["images"])
    levels = decode.dense_levels(plain.forward(ref, frames), torch.as_tensor(s.pool[0]["intrinsics"]),
                                 cell.config["model"]["strides"], cell.config["decode"])
    final = decode.detections(levels, cell.config["decode"])
    served = compare.served_images(det)
    for got, want in zip(served, final):
        assert len(got["cls"]) == len(want["cls"]) > 0
        np.testing.assert_allclose(np.sort(got["score3d"]), np.sort(want["score3d"]), atol=1e-4)
        order_g, order_w = np.argsort(-got["score3d"], kind="stable"), np.argsort(-want["score3d"], kind="stable")
        np.testing.assert_allclose(got["box"][order_g][:10], want["box"][order_w][:10], atol=1e-2)
