"""The port's DD3D forward (DLA-34 + FPN P3-P7 + FCOS2D/FCOS3D heads) against
the JAX model's `apply` on the same converted weights and uint8 images, at
128x256, batch 2, fp32: all 8 head outputs at all 5 levels.

Tolerance atol = rtol = 1e-4, tighter than the 2e-3 of
tests/test_full_model_parity.py: both sides are fp32 on the CPU and differ
only in the summation order of about 40 stacked convolutions; the observed
worst difference is about 2e-6 on outputs of magnitude up to 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dd3d_tpu_torch.models.dd3d import HEAD_KEYS_2D, HEAD_KEYS_3D

from tests.torch_port_util import both_models, fp32_cfg

HEAD_KEYS = HEAD_KEYS_2D + HEAD_KEYS_3D


@pytest.fixture(scope="module")
def outputs():
    cfg = fp32_cfg()
    jm, variables, pm = both_models(cfg)
    images = (np.random.RandomState(3).rand(2, 128, 256, 3) * 255).astype(np.uint8)
    out_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        out_p = pm(torch.from_numpy(images))
    return out_j, out_p


def test_head_keys_cover_all_outputs(outputs):
    out_j, out_p = outputs
    assert set(out_p) == set(HEAD_KEYS)
    assert set(HEAD_KEYS) <= set(out_j)


@pytest.mark.parametrize("key", HEAD_KEYS)
def test_head_output_matches_jax(outputs, key):
    out_j, out_p = outputs
    assert len(out_p[key]) == len(out_j[key]) == 5
    for lvl, (p, j) in enumerate(zip(out_p[key], out_j[key])):
        np.testing.assert_allclose(p.numpy(), np.asarray(j, np.float32), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{key} level {lvl}")


def test_activations_run_channels_last():
    """NHWC uint8 input -> NCHW modules with channels_last strides, no copy."""
    from dd3d_tpu_torch.models import build_model

    cfg = fp32_cfg()
    model = build_model(cfg)
    x = model.preprocess_image(torch.zeros(1, 128, 128, 3, dtype=torch.uint8))
    assert x.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        feats = model.backbone(x)
    assert all(f.is_contiguous(memory_format=torch.channels_last) for f in feats.values())


@pytest.mark.parametrize("key,value", [("TPU.QUANT_INT8", True), ("FE.BUILDER", "build_dla_fpn_backbone"),
                                       ("DD3D.FCOS3D.PER_LEVEL_PREDICTORS", True)])
def test_unported_config_keys_raise(key, value):
    from dd3d_tpu_torch.models import build_model

    cfg = fp32_cfg()
    node = cfg
    *parents, leaf = key.split(".")
    for p in parents:
        node = node[p]
    node[leaf] = value
    with pytest.raises(NotImplementedError, match=leaf):
        build_model(cfg)


@pytest.mark.parametrize("key", ["S2D_STEM", "PACKED_HEADS", "PACKED_HEADS_TRAIN"])
def test_tpu_layout_rewrites_run_the_plain_path(key):
    """Exact TPU-layout rewrites are accepted and the plain path runs."""
    from dd3d_tpu_torch.models import build_model

    cfg = fp32_cfg()
    cfg.TPU[key] = True
    ref = build_model(fp32_cfg(), generator=torch.Generator().manual_seed(0))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, 128, 128, 3, dtype=torch.uint8)
    with torch.no_grad():
        assert torch.equal(model(x)["logits"][0], ref(x)["logits"][0])
