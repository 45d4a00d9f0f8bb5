"""The port's rotated-box ops (dd3d_tpu_torch/ops/rotated_boxes.py) against
the JAX package's (dd3d_tpu/ops/rotated_boxes.py) and the port's build of
the C++ rotated IoU (evaluators/native.rotated_iou_matrix), on the CPU:

- `pairwise_rotated_iou` within 1e-5 absolute of JAX's and of the C++
  engine's (f64, radians) on seeded boxes that include identical, disjoint,
  contained and 45-degree pairs, also hundreds of metres from the origin;
  batched over images it equals the per-image matrices;
- the BEV conversion of 3D box corners within 1e-5 of JAX's;
- `rotated_nms_padded`: the same order and keep mask as JAX's on seeded
  inputs with no IoU within 1e-4 of the threshold, pads (NEG_INF) and tied
  scores kept in JAX's stable order; `max_outputs` caps as JAX's;
- the CUDA scan's wrapper (`greedy_nms_scan`) runs the plain
  `greedy_suppress` on CPU tensors and checks its inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.ops import rotated_boxes as jrb
from dd3d_tpu.structures.boxes3d import generic_corners as jax_generic_corners
from dd3d_tpu_torch.evaluators.native import rotated_iou_matrix
from dd3d_tpu_torch.ops import rotated_boxes as prb
from dd3d_tpu_torch.ops.nms import NEG_INF, greedy_suppress
from dd3d_tpu_torch.ops.nms_kernel import greedy_nms_scan
from dd3d_tpu_torch.structures.boxes3d import generic_corners
from tests.torch_port_util import torch_threads


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):  # test files run in parallel processes
        yield


IOU_ATOL = 1e-5


def seeded_boxes(seed: int, n: int) -> np.ndarray:
    """(n, 5) f32 boxes [cx, cy, w, l, deg] with the special pairs first:
    identical, disjoint, one inside another, a 45-degree turn of a square,
    the same box turned by 180 degrees; then random ones that overlap often."""
    special = np.float32([
        [0.0, 0.0, 2.0, 4.0, 10.0], [0.0, 0.0, 2.0, 4.0, 10.0],  # identical
        [30.0, 30.0, 1.0, 1.0, 0.0], [-30.0, 30.0, 1.0, 1.0, 0.0],  # disjoint
        [5.0, 5.0, 4.0, 6.0, 20.0], [5.0, 5.0, 1.0, 2.0, 20.0],  # contained
        [-5.0, -5.0, 2.0, 2.0, 0.0], [-5.0, -5.0, 2.0, 2.0, 45.0],  # 45 degrees
        [8.0, -8.0, 2.0, 5.0, 30.0], [8.0, -8.0, 2.0, 5.0, 210.0],  # half a turn
    ])
    rng = np.random.RandomState(seed)
    rand = np.zeros((n - len(special), 5), np.float32)
    rand[:, :2] = rng.randn(len(rand), 2) * 3
    rand[:, 2:4] = rng.rand(len(rand), 2) * 3 + 0.5
    rand[:, 4] = rng.rand(len(rand)) * 360 - 180
    return np.concatenate([special, rand]).astype(np.float32)


def native_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    a64[:, 4], b64[:, 4] = np.radians(a64[:, 4]), np.radians(b64[:, 4])
    return rotated_iou_matrix(a64, b64)


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_rotated_iou_matches_jax_and_the_host_engine(seed):
    a, b = seeded_boxes(seed, 40), seeded_boxes(seed + 10, 33)
    got = prb.pairwise_rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jrb.pairwise_rotated_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (40, 33) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    np.testing.assert_allclose(got, native_iou(a, b), rtol=0, atol=IOU_ATOL)
    # the special pairs: identical 1, disjoint 0, contained 2/24, a square and its 45-degree turn 1/sqrt(2)
    self_iou = prb.pairwise_rotated_iou(torch.from_numpy(a[:10]), torch.from_numpy(a[:10])).numpy()
    assert self_iou[0, 1] == pytest.approx(1.0, abs=IOU_ATOL) and self_iou[2, 3] == 0.0
    assert self_iou[4, 5] == pytest.approx(2.0 / 24.0, abs=IOU_ATOL)
    inter45 = 8.0 * (np.sqrt(2.0) - 1.0)  # the regular octagon of a square and its 45-degree turn
    assert self_iou[6, 7] == pytest.approx(inter45 / (8.0 - inter45), abs=IOU_ATOL)
    assert self_iou[8, 9] == pytest.approx(1.0, abs=IOU_ATOL)


@pytest.mark.parametrize("offset", [100.0, 300.0])
def test_pairwise_rotated_iou_far_from_the_origin(offset):
    """The same boxes hundreds of metres out, as a sample's global frame puts
    them: still within 1e-5 of the host engine's f64 IoU of those inputs."""
    a, b = seeded_boxes(0, 40), seeded_boxes(10, 33)
    a[:, :2] += np.float32([offset, -offset / 2])
    b[:, :2] += np.float32([offset, -offset / 2])
    got = prb.pairwise_rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (got > 0.05).sum() > 50  # pairs that overlap
    np.testing.assert_allclose(got, native_iou(a, b), rtol=0, atol=IOU_ATOL)


def test_pairwise_rotated_iou_batched_equals_per_image():
    boxes = np.stack([seeded_boxes(s, 24) for s in range(3)])
    batched = prb.pairwise_rotated_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    for i in range(3):
        single = prb.pairwise_rotated_iou(torch.from_numpy(boxes[i]), torch.from_numpy(boxes[i])).numpy()
        np.testing.assert_array_equal(batched[i], single)


def test_bev_boxes_of_corners_match_jax():
    rng = np.random.RandomState(3)
    quat = rng.randn(2, 16, 4).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    tvec = (rng.randn(2, 16, 3) * 5 + [0, 0, 20]).astype(np.float32)
    size = (rng.rand(2, 16, 3) * 3 + 0.5).astype(np.float32)
    got = prb.boxes3d_corners_to_bev_boxes(generic_corners(*map(torch.from_numpy, (quat, tvec, size)))).numpy()
    want = np.asarray(jrb.boxes3d_corners_to_bev_boxes(jax_generic_corners(*map(jnp.asarray, (quat, tvec, size)))))
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-4)  # metres at ~20 m
    np.testing.assert_allclose(np.cos(np.radians(got[..., 4] - want[..., 4])), 1.0, atol=1e-6)  # the heading
    np.testing.assert_array_equal(np.asarray(prb.CAMERA_TO_BEV, np.float32), jrb.CAMERA_TO_BEV)
    np.testing.assert_array_equal(np.asarray(prb.VEHICLE_TO_BEV, np.float32), jrb.VEHICLE_TO_BEV)


def nms_case(seed: int, n: int, thr: float):
    """Seeded boxes, scores with ties and NEG_INF pads, 3 classes; redrawn
    until no pairwise IoU lies within 1e-4 of `thr`."""
    rng = np.random.RandomState(seed)
    while True:
        boxes = np.zeros((n, 5), np.float32)
        boxes[:, :2] = rng.randn(n, 2) * 2
        boxes[:, 2:4] = rng.rand(n, 2) * 2 + 1.0
        boxes[:, 4] = rng.rand(n) * 360 - 180
        iou = native_iou(boxes, boxes)
        if not np.any(np.abs(iou - thr) < 1e-4):
            break
    scores = np.round(rng.rand(n), 1).astype(np.float32)  # ties
    scores[rng.rand(n) < 0.15] = NEG_INF  # pads
    classes = rng.randint(0, 3, n).astype(np.int32)
    return boxes, scores, classes


@pytest.mark.parametrize("seed,max_outputs", [(0, 0), (1, 0), (2, 5)])
def test_rotated_nms_padded_matches_jax(seed, max_outputs):
    thr = 0.3
    cases = [nms_case(seed * 10 + i, 48, thr) for i in range(2)]
    boxes, scores, classes = (np.stack(x) for x in zip(*cases))
    order, keep = prb.rotated_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                                         torch.from_numpy(classes), thr, max_outputs=max_outputs)
    for i in range(2):
        order_j, keep_j = jrb.rotated_nms_padded(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                                 jnp.asarray(classes[i]), thr, max_outputs=max_outputs)
        np.testing.assert_array_equal(order[i].numpy(), np.asarray(order_j))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(keep_j))
        kept = int(keep[i].sum())
        assert 0 < kept < int((scores[i] > NEG_INF / 2).sum())  # something kept, something suppressed
        if max_outputs:
            assert kept == max_outputs


def test_scan_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(4)
    iou = torch.from_numpy(rng.rand(3, 70, 70).astype(np.float32))
    valid = torch.from_numpy(rng.rand(3, 70) > 0.1)
    before = greedy_nms_scan.launches
    np.testing.assert_array_equal(greedy_nms_scan(iou, valid, 0.8).numpy(), greedy_suppress(iou, valid, 0.8).numpy())
    assert greedy_nms_scan.launches == before  # nothing launched on the CPU
    with pytest.raises(ValueError, match="need iou"):
        greedy_nms_scan(iou[:, :, :60], valid, 0.5)
    with pytest.raises(TypeError, match="float32"):
        greedy_nms_scan(iou.double(), valid, 0.5)
