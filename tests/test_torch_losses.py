"""The port's training losses (dd3d_tpu_torch/models/{prepare_targets,
fcos2d, fcos3d, dd3d, loss_geometry}.py, ops/losses.py, ops/color_jitter.py)
against the JAX package's, on the CPU in f32, on the cases of
tests/test_loss_parity.py: three images (one with no GT), boxes on
several size-of-interest levels, an overlapping pair for the min-area tie
break, and random head outputs at 128x256.

Targets must be equal (labels, positives and matched indices exactly;
regression targets to 1e-5, the same f32 subtractions), loss scalars within
rtol 1e-5 (f32 sums of ~5000 terms in other orders), and the gradients of
the total loss with respect to every head output within 1e-5 of the largest
one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu.configs import get_experiment_cfg
from dd3d_tpu.models import loss_geometry as jg
from dd3d_tpu.models.dd3d import dd3d_losses as jax_dd3d_losses
from dd3d_tpu.ops import losses as jlosses
from dd3d_tpu.ops.color_jitter import apply_color_jitter as jax_color_jitter
from dd3d_tpu_torch.models import loss_geometry as pg
from dd3d_tpu_torch.models.dd3d import dd3d_losses
from dd3d_tpu_torch.models.prepare_targets import build_location_bases, prepare_targets
from dd3d_tpu_torch.ops import losses as plosses
from dd3d_tpu_torch.ops.color_jitter import apply_color_jitter

from tests.test_loss_parity import STRIDES, _feature_shapes, _jax_batch, _random_outputs, _synthetic_gt

LOSS_KEYS = ("loss_cls", "loss_box2d_reg", "loss_centerness", "loss_box3d_quat", "loss_box3d_proj_ctr",
             "loss_box3d_depth", "loss_box3d_size", "loss_conf3d")


@pytest.fixture(scope="module")
def case():
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    rng = np.random.RandomState(11)
    gt_list, intrinsics = _synthetic_gt(rng, cfg.DD3D.NUM_CLASSES, with_empty_image=True)
    _, jax_out = _random_outputs(rng, len(gt_list), cfg.DD3D.NUM_CLASSES, STRIDES)
    batch_j = _jax_batch(gt_list, intrinsics)

    def total_j(outs):
        losses, targets, _ = jax_dd3d_losses(cfg, outs, batch_j, return_aux=True, strides=STRIDES)
        return sum(losses.values()), (losses, targets)

    (_, (losses_j, targets_j)), grads_j = jax.value_and_grad(total_j, has_aux=True)(jax_out)

    batch_p = {k: torch.from_numpy(np.array(v)) for k, v in batch_j.items()}
    out_p = {k: [torch.from_numpy(np.array(x)).requires_grad_(True) for x in v] for k, v in jax_out.items()}
    losses_p = dd3d_losses(cfg, out_p, batch_p, STRIDES)
    sum(losses_p.values()).backward()
    locs, strs, ranges, _ = build_location_bases(_feature_shapes(STRIDES), STRIDES, cfg.DD3D.SIZES_OF_INTEREST)
    targets_p = prepare_targets(locs, strs, ranges, batch_p["gt_boxes2d"], batch_p["gt_classes"],
                                batch_p["gt_boxes3d"], batch_p["gt_valid"], cfg.DD3D.NUM_CLASSES,
                                cfg.DD3D.FCOS3D.PREPARE_TARGET.CENTER_SAMPLE,
                                cfg.DD3D.FCOS3D.PREPARE_TARGET.POS_RADIUS)
    return dict(losses_j={k: float(v) for k, v in losses_j.items()}, targets_j=jax.tree_util.tree_map(
        np.asarray, targets_j), grads_j=grads_j, losses_p=losses_p, targets_p=targets_p, out_p=out_p)


def test_targets_match(case):
    tj, tp = case["targets_j"], case["targets_p"]
    assert set(tp) == set(tj)
    pos = tj["pos_mask"]
    assert pos.sum() > 20 and not pos[2].any()  # positives, and none in the image without GT
    for k in ("labels", "pos_mask", "target_inds"):
        np.testing.assert_array_equal(tp[k].numpy(), tj[k], err_msg=k)
    for k in ("box2d_reg_targets", "box3d_targets"):
        np.testing.assert_allclose(tp[k].numpy(), tj[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_loss_matches(case, key):
    got, want = float(case["losses_p"][key].detach()), case["losses_j"][key]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)


def test_loss_gradients_match(case):
    for key, levels in case["out_p"].items():
        for lvl, x in enumerate(levels):
            want = np.asarray(case["grads_j"][key][lvl])
            scale = max(np.abs(want).max(), 1e-12)
            np.testing.assert_allclose(x.grad.numpy() / scale, want / scale, atol=1e-5, err_msg=f"{key}[{lvl}]")


def test_first_gt_wins_ties():
    """Two identical GT boxes: every positive location matches the first."""
    locs, strs, ranges, _ = build_location_bases([(16, 32)], [8], [64])
    box = torch.tensor([[[40.0, 30.0, 85.0, 68.0]] * 3])
    valid = torch.tensor([[False, True, True]])
    t = prepare_targets(locs, strs, ranges, box, torch.tensor([[0, 1, 2]]), torch.zeros(1, 3, 10), valid, 5)
    assert t["pos_mask"].any()
    assert (t["target_inds"][t["pos_mask"]] == 1).all() and (t["labels"][t["pos_mask"]] == 1).all()


def _rand(rng, *shape, scale=1.0, offset=0.0):
    return (rng.randn(*shape) * scale + offset).astype(np.float32)


@pytest.mark.parametrize("loc_loss_type", ["giou", "iou", "linear_iou"])
def test_elementwise_losses_match(loc_loss_type):
    """focal, BCE, smooth-L1 and the IoU family in both layouts, elementwise."""
    rng = np.random.RandomState(2)
    logits, targets = _rand(rng, 3, 5, 40, scale=3), (rng.rand(3, 5, 40) > 0.7).astype(np.float32)
    pairs = [
        (plosses.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets)),
         jlosses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets))),
        (plosses.sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(targets)),
         jlosses.optax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(targets))),
    ]
    a, b = _rand(rng, 4, 24, scale=3), _rand(rng, 4, 24, scale=3)
    for beta in (0.0, 0.05):
        pairs.append((plosses.smooth_l1_loss(torch.from_numpy(a), torch.from_numpy(b), beta),
                      jlosses.smooth_l1_loss(jnp.asarray(a), jnp.asarray(b), beta)))
    pred, tgt = np.abs(_rand(rng, 3, 4, 50, scale=30)), np.abs(_rand(rng, 3, 4, 50, scale=30))
    pairs.append((plosses.iou_loss_ltrb_t(torch.from_numpy(pred), torch.from_numpy(tgt), loc_loss_type),
                  jlosses.iou_loss_ltrb_t(jnp.asarray(pred), jnp.asarray(tgt), loc_loss_type)))
    pt, tt = np.ascontiguousarray(pred.transpose(0, 2, 1)), np.ascontiguousarray(tgt.transpose(0, 2, 1))
    pairs.append((plosses.iou_loss_ltrb(torch.from_numpy(pt), torch.from_numpy(tt), loc_loss_type),
                  jlosses.iou_loss_ltrb(jnp.asarray(pt), jnp.asarray(tt), loc_loss_type)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_loss_geometry_matches():
    """quaternion <-> matrix, unproject, allocentric -> egocentric and the
    corners, component-major, on random inputs and at the identity rotation
    (three exact-zero candidates of matrix_to_quaternion)."""
    rng = np.random.RandomState(3)
    b, p = 2, 37
    quat = _rand(rng, b, 4, p)
    quat[:, :, 0] = [1.0, 0, 0, 0]
    ctr = _rand(rng, b, 2, p, scale=100, offset=200)
    depth = np.abs(_rand(rng, b, p, scale=10, offset=20))
    size = np.abs(_rand(rng, b, 3, p, offset=2))
    k = np.array([[[700.0, 0, 300], [0, 690.0, 180], [0, 0, 1]], [[400.0, 0, 128], [0, 420.0, 64], [0, 0, 1]]],
                 np.float32)
    inv_k = np.linalg.inv(k).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    j = jnp.asarray
    pairs = [
        (torch.stack(pg.quaternion_to_matrix_t(t(quat)), 1), jnp.stack(jg.quaternion_to_matrix_t(j(quat)), 1)),
        (pg.matrix_to_quaternion_t(pg.quaternion_to_matrix_t(pg.normalize_rows(t(quat)))),
         jg.matrix_to_quaternion_t(jg.quaternion_to_matrix_t(jg.normalize_rows(j(quat))))),
        (pg.unproject_t(t(ctr), t(inv_k)), jg.unproject_t(j(ctr), j(inv_k))),
        (pg.allocentric_to_egocentric_t(t(quat), t(ctr), t(inv_k)),
         jg.allocentric_to_egocentric_t(j(quat), j(ctr), j(inv_k))),
        (pg.corners_t(t(quat), t(ctr), t(depth), t(size), t(inv_k)),
         jg.corners_t(j(quat), j(ctr), j(depth), j(size), j(inv_k))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_color_jitter_matches():
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)
    factors = rng.uniform(0.6, 1.4, (3, 3)).astype(np.float32)
    factors[0] = 1.0  # identity
    got = apply_color_jitter(torch.from_numpy(images), torch.from_numpy(factors))
    want = np.asarray(jax_color_jitter(jnp.asarray(images), jnp.asarray(factors)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[0].numpy(), images[0].astype(np.float32))
