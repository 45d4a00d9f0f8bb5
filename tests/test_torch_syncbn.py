"""Global SyncBN of the port's live BatchNorm (models/layers.py:
`combine_moments`, `sync_batch_moments`) against one var_mean over the
concatenated batch, in f64, forward and backward:

- `combine_moments` alone, in one process, over uneven shards and a shard
  with no values (an empty level on one rank), and with one shard (the
  identity);
- `sync_batch_moments` on two gloo ranks, each with its shard, against the
  single-process statistics of the whole batch and the gradient of a
  weighted sum of them with respect to each shard; one all-reduce a call.

Tolerance 1e-12 relative (f64: the pooled form sums in another order).
"""
import numpy as np
import pytest
import torch

from dd3d_tpu_torch.models.layers import combine_moments
from tests.torch_dist_workers import syncbn_rank
from tests.torch_port_util import run_gloo

C = 5


def shards_of(sizes, seed=0):
    rng = np.random.RandomState(seed)
    # an offset large against the spread: the case where E[x^2] - E[x]^2 cancels
    return [rng.randn(n, C, 3, 4) * 0.5 + 100.0 for n in sizes]


def whole_batch(shards, weights):
    """(var, mean, grads of each shard) from one var_mean on the concatenation."""
    xs = [torch.from_numpy(s).requires_grad_(True) for s in shards]
    var, mean = torch.var_mean(torch.cat(xs), dim=(0, 2, 3), correction=0)
    (torch.from_numpy(weights[0]) * var + torch.from_numpy(weights[1]) * mean).sum().backward()
    return var.detach().numpy(), mean.detach().numpy(), [x.grad.numpy() for x in xs]


def weights_of(seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(C), rng.randn(C)


@pytest.mark.parametrize("sizes", [(2, 3), (4, 0), (0, 1, 5), (3,)])
def test_combine_moments_equals_one_var_mean(sizes):
    shards, weights = shards_of(sizes), weights_of()
    want_var, want_mean, want_grads = whole_batch(shards, weights)
    xs = [torch.from_numpy(s).requires_grad_(True) for s in shards]
    rows = []
    for x in xs:
        if x.shape[0]:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        else:
            var = mean = x.new_zeros(C) + x.sum()
        rows.append(torch.stack([torch.full_like(mean, float(x.numel() // C)), mean, var]))
    var, mean = combine_moments(torch.stack(rows))
    (torch.from_numpy(weights[0]) * var + torch.from_numpy(weights[1]) * mean).sum().backward()
    np.testing.assert_allclose(var.detach().numpy(), want_var, rtol=1e-12)
    np.testing.assert_allclose(mean.detach().numpy(), want_mean, rtol=1e-12)
    for x, g in zip(xs, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-12, atol=1e-15)


def test_combine_moments_of_one_rank_is_the_identity():
    x = torch.from_numpy(shards_of([3])[0]).float()
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    got_var, got_mean = combine_moments(torch.stack([torch.full_like(mean, 36.0), mean, var])[None])
    assert torch.equal(got_var, var) and torch.equal(got_mean, mean)


@pytest.mark.parametrize("sizes", [(2, 3), (3, 0)])
def test_sync_batch_moments_on_two_ranks(tmp_path, sizes):
    """Two gloo ranks; (3, 0) gives rank 1 an empty activation."""
    shards, weights = shards_of(sizes), weights_of()
    want_var, want_mean, want_grads = whole_batch(shards, weights)
    results = run_gloo(syncbn_rank, 2, shards, weights, out_dir=tmp_path)
    for rank, got in enumerate(results):
        np.testing.assert_allclose(got["var"], want_var, rtol=1e-12, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["mean"], want_mean, rtol=1e-12, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["grad"], want_grads[rank], rtol=1e-12, atol=1e-15, err_msg=f"rank {rank}")
        assert got["calls"] == 1
