"""The port's greedy NMS (plain PyTorch suppression, and the CUDA kernel's
wrapper on CPU tensors) against dd3d_tpu/ops/nms.py and the Pallas kernel in
interpret mode. Keep masks must be equal exactly: both sides compute the same
fp32 IoU operations in the same order, and the kernel on the card is held to
the same bits by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.ops import nms as jnms
from dd3d_tpu.ops.pallas_nms import pallas_greedy_nms_batched
from dd3d_tpu_torch.ops import nms as pnms
from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain


def _random_boxes(rng, b, n):
    boxes = rng.rand(b, n, 4).astype(np.float32) * 200
    boxes[..., 2:] = boxes[..., :2] + rng.rand(b, n, 2).astype(np.float32) * 80 + 1
    valid = rng.rand(b, n) > 0.1
    return boxes, valid


def _case(name):
    rng = np.random.RandomState(5)
    if name in ("random-0.5", "random-0.75"):
        boxes, valid = _random_boxes(rng, 2, 128)
        return boxes, valid, float(name.split("-")[1])
    if name == "all-invalid":
        boxes, _ = _random_boxes(rng, 2, 128)
        return boxes, np.zeros((2, 128), bool), 0.5
    if name == "identical":
        boxes = np.broadcast_to(np.array([10, 10, 50, 40], np.float32), (2, 128, 4)).copy()
        valid = np.ones((2, 128), bool)
        valid[1, 0] = False  # the first valid box, not box 0, survives
        return boxes, valid, 0.5
    if name == "n512":
        boxes, valid = _random_boxes(rng, 2, 512)
        return boxes, valid, 0.6
    raise ValueError(name)


@pytest.mark.parametrize("name", ["random-0.5", "random-0.75", "all-invalid", "identical", "n512"])
def test_suppression_matches_jax_and_pallas(name):
    boxes, valid, thr = _case(name)
    keep_port = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    keep_pallas = np.asarray(pallas_greedy_nms_batched(jnp.asarray(boxes), jnp.asarray(valid), thr, interpret=True))
    suppress = jax.jit(lambda bx, v: jnms.greedy_suppress(jnms.pairwise_iou_xyxy(bx, bx), v, thr))
    keep_xla = np.stack([np.asarray(suppress(jnp.asarray(boxes[i]), jnp.asarray(valid[i])))
                         for i in range(boxes.shape[0])])
    np.testing.assert_array_equal(keep_port, keep_xla)
    np.testing.assert_array_equal(keep_port, keep_pallas)
    if name == "identical":
        assert keep_port.sum(axis=1).tolist() == [1, 1] and keep_port[1, 1]
    if name == "all-invalid":
        assert not keep_port.any()


def test_pairwise_iou_bits_match_jax(rng):
    """The IoU matrix itself is bit-identical, which is what makes the keep
    decisions at the threshold agree."""
    a = rng.rand(64, 4).astype(np.float32) * 100
    a[:, 2:] += a[:, :2]
    iou_j = np.asarray(jax.jit(jnms.pairwise_iou_xyxy)(jnp.asarray(a), jnp.asarray(a)))
    iou_p = pnms.pairwise_iou_xyxy(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(iou_p, iou_j)


@pytest.mark.parametrize("assume_sorted", [False, True])
def test_batched_nms_padded_several_classes(assume_sorted):
    """Class-offset trick, POST_NMS_TOPK prefix and the sort, against the JAX
    batched_nms_padded (vmapped over images), with NEG_INF padding."""
    rng = np.random.RandomState(11)
    b, n = 3, 256
    boxes, valid = _random_boxes(rng, b, n)
    scores = (np.round(rng.rand(b, n) * 20) / 20).astype(np.float32)  # many ties: their order must match too
    if assume_sorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, 1)
        boxes = np.take_along_axis(boxes, order[..., None], 1)
    scores = np.where(valid, scores, jnms.NEG_INF).astype(np.float32)
    classes = rng.randint(0, 4, (b, n)).astype(np.int32)

    fn = jax.jit(jax.vmap(lambda bx, s, c: jnms.batched_nms_padded(bx, s, c, 0.5, 40, assume_sorted=assume_sorted)))
    order_j, keep_j = (np.asarray(x) for x in fn(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes)))
    order_p, keep_p = pnms.batched_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                                              torch.from_numpy(classes).long(), 0.5, 40, assume_sorted=assume_sorted)
    np.testing.assert_array_equal(order_p.numpy(), order_j)
    np.testing.assert_array_equal(keep_p.numpy(), keep_j)
    assert keep_j.sum(axis=1).max() == 40  # the prefix cap was exercised


def test_wrapper_takes_plain_path_on_cpu():
    boxes, valid, thr = _case("random-0.5")
    greedy_nms.launches = 0
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    assert torch.equal(greedy_nms(bt, vt, thr), greedy_nms_plain(bt, vt, thr))
    assert greedy_nms.launches == 0  # the counter only counts kernel launches


@pytest.mark.parametrize("bad", ["shape", "dtype", "valid-dtype"])
def test_wrapper_rejects_bad_input(bad):
    boxes = torch.zeros(2, 8, 4)
    valid = torch.ones(2, 8, dtype=torch.bool)
    if bad == "shape":
        boxes = torch.zeros(2, 8, 5)
    elif bad == "dtype":
        boxes = boxes.double()
    else:
        valid = valid.int()
    with pytest.raises((ValueError, TypeError)):
        greedy_nms(boxes, valid, 0.5)

