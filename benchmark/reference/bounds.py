"""The table of peaks and the operations of a conv from its shapes: the
yardstick of every roofline and mfu metric.

Copied from chip_smoke.py (commit 556a2543: `bound_ms`'s peaks and the
operation count of `int8_conv_bound`), taking shapes instead of tensors, so
that a metric reader can count a whole forward from the configuration's
layer shapes. The same whatever implements the op: bytes read once and
written once, operations as the algorithm needs them. The NMS, BEV scan,
grouped-conv and dW bounds come with the readers that need them.
"""

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def conv_out_hw(h: int, w: int, k: int, stride: int, pad: int):
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def conv_ops(x_nchw, w_oihw, stride: int, pad: int) -> int:
    """2 * M * O * K of a (grouped) conv: K = C/g * kh * kw."""
    b, _, h, w = x_nchw
    o, cg, kh, kw = w_oihw
    ho, wo = conv_out_hw(h, w, kh, stride, pad)
    return 2 * b * ho * wo * o * cg * kh * kw
