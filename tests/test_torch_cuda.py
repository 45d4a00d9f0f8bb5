"""Tests of the port that need an NVIDIA card and nvcc (marker `cuda`); they
skip without one. This file imports neither jax nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py sets up jax.)
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KITTI_K = np.array([[721.5, 0, 609.5], [0, 721.5, 172.8], [0, 0, 1]], np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the NMS kernel has no CPU or interpret mode")
    return torch.device("cuda", 0)


def _random_boxes(rng, b, n):
    boxes = rng.rand(b, n, 4).astype(np.float32) * 200
    boxes[..., 2:] = boxes[..., :2] + rng.rand(b, n, 2).astype(np.float32) * 80 + 1
    return boxes, rng.rand(b, n) > 0.1


@pytest.mark.parametrize("b,n", [(8, 512), (3, 300), (1, 2048)])
def test_kernel_matches_plain(card, b, n):
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms, greedy_nms_plain

    boxes, valid = _random_boxes(np.random.RandomState(2), b, n)
    bt, vt = torch.from_numpy(boxes).to(card), torch.from_numpy(valid).to(card)
    for thr in (0.5, 0.75):
        before = greedy_nms.launches
        keep = greedy_nms(bt, vt, thr)
        assert greedy_nms.launches == before + 1
        assert torch.equal(keep, greedy_nms_plain(bt, vt, thr))


def test_kernel_rejects_too_many_boxes(card):
    from dd3d_tpu_torch.ops.nms_kernel import greedy_nms

    with pytest.raises(ValueError, match="maximum"):
        greedy_nms(torch.zeros(1, 4096, 4, device=card), torch.ones(1, 4096, dtype=torch.bool, device=card), 0.5)


def test_slice_on_card_matches_cpu(card):
    """The fp32 slice on the card (TF32 off, NMS through the kernel) against
    the CPU: same valid set; sorted scores within 1e-3 (summation order)."""
    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.models import build_model
    from dd3d_tpu_torch.models.postprocess import get_inference_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    images = (np.random.RandomState(4).rand(2, 128, 256, 3) * 255).astype(np.uint8)
    intrinsics = np.stack([KITTI_K, KITTI_K])
    det_cpu = get_inference_fn(model, cfg)(images, intrinsics)
    det_gpu = get_inference_fn(model.to(card), cfg)(images, intrinsics)
    np.testing.assert_array_equal(det_gpu["valid"].cpu().numpy(), det_cpu["valid"].numpy())
    np.testing.assert_allclose(det_gpu["scores"].cpu().numpy(), det_cpu["scores"].numpy(), atol=1e-3)
