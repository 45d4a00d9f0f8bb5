"""Data-parallel training of the port (DistributedDataParallel, global SyncBN,
global loss normalizers; training/train_step.py, parallel/mesh.py) against
one process on the whole batch, on the CPU.

Two gloo ranks, each with half of a fixed global batch of 4, take the steps
of the small model of tests/test_torch_train.py (DLA-34 trunk, FPN 64, 1-conv
towers) at 64x128; one process takes the same steps on the whole batches:
- losses within rtol 1e-5, grad_norm within rtol 1e-4;
- every gradient and updated parameter within 1e-4 of the tensor's largest
  magnitude;
- the BN running statistics within 1e-6 of the tensor's largest magnitude
  (the pooled statistics of layers.combine_moments against one var_mean);
- parameters and BN statistics bit-identical across the two ranks (DDP
  hands every rank the same averaged gradient; SyncBN the same statistics);
- the logged losses equal on both ranks (the global batch's).

Cases: one step in f32; two steps in f64; and SOLVER.ACCUMULATE_GRAD_BATCHES
= 2 over 4 micro-batches in f64 (DDP's no_sync on the first of each pair).
Two f32 steps cannot be held to 1e-4: the second step's gradient amplifies
the rounding of the first update by 1e2-1e4 at these random weights (one
process at 1 and at 6 torch threads lies 0.5 % apart in the stem and DLA
weight gradients after one update of lr 1e-5, 2.5e-5 apart with lr 0), so
the multi-step cases run in f64, where the same amplification stays far
below the bounds and a fault in the reduction still shows at full size.
"""
import numpy as np
import pytest
import torch

from dd3d_tpu_torch.training.synthetic import synthetic_batch
from tests.torch_dist_workers import ddp_rank, ddp_steps
from tests.torch_port_util import run_gloo, torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def global_batches(n, seed=3):
    rng = np.random.RandomState(seed)
    return [synthetic_batch(rng, 4, 64, 128, max_gt=8, max_gt_per_image=4) for _ in range(n)]


def relative_to_largest(got: torch.Tensor, want: torch.Tensor, floor: float) -> float:
    """max |got - want| over the tensor's largest magnitude, floored at
    `floor` (P7's bias gradient is zero up to rounding: train-mode BN
    cancels a uniform shift)."""
    return float((got - want).abs().max() / max(float(want.abs().max()), floor))


def assert_ddp_matches_one_process(one, ranks, accumulate=1):
    """grad_norm (the gradients' tolerance) is compared on the steps that
    apply an update: between two, under no_sync, each rank's gradients are
    its own."""
    for step, (got, want) in enumerate(zip(ranks[0]["losses"], one["losses"])):
        assert want["loss_finite"] == 1.0
        synced = (step + 1) % accumulate == 0
        for k in want:
            if k != "grad_norm" or synced:
                rtol = 1e-4 if k == "grad_norm" else 1e-5
                np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=f"step {step + 1} {k}")
                # the logged losses are the global batch's on every rank
                assert got[k] == ranks[1]["losses"][step][k], f"step {step + 1} {k}"
    assert set(ranks[0]["grads"]) == set(one["grads"])
    for kind in ("grads", "params"):
        floor = 1e-6 * max(float(t.abs().max()) for t in one[kind].values())
        for name, want in one[kind].items():
            err = relative_to_largest(ranks[0][kind][name], want, floor)
            assert err <= 1e-4, f"{kind} {name}: {err:.2e} of its largest magnitude"
    for name, want in one["buffers"].items():
        np.testing.assert_allclose(ranks[0]["buffers"][name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()), err_msg=name)
    for name, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][name]), name
    for name, b in ranks[0]["buffers"].items():
        assert torch.equal(b, ranks[1]["buffers"][name]), name
    assert ranks[0]["optimizer_count"] == one["optimizer_count"]


def test_two_rank_step_equals_one_process_f32(tmp_path):
    batches = global_batches(1)
    one = ddp_steps(batches)
    ranks = run_gloo(ddp_rank, 2, batches, out_dir=tmp_path, timeout_s=300)
    assert one["optimizer_count"] == 1
    assert any(n.startswith("fcos2d_head") for n in one["buffers"])  # the live BNs are compared
    assert_ddp_matches_one_process(one, ranks)


def test_two_rank_steps_equal_one_process_f64(tmp_path):
    batches = global_batches(2)
    one = ddp_steps(batches, f64=True)
    ranks = run_gloo(ddp_rank, 2, batches, 1, True, out_dir=tmp_path, timeout_s=300)
    assert one["optimizer_count"] == 2 and one["params"]["backbone.fpn_output5.weight"].dtype == torch.float64
    assert_ddp_matches_one_process(one, ranks)


def test_two_rank_accumulation_equals_one_process(tmp_path):
    batches = global_batches(4, seed=4)
    one = ddp_steps(batches, accumulate=2, f64=True)
    ranks = run_gloo(ddp_rank, 2, batches, 2, True, out_dir=tmp_path, timeout_s=300)
    assert one["optimizer_count"] == 2
    assert_ddp_matches_one_process(one, ranks, accumulate=2)
