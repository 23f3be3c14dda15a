"""RoI pooling on fixed-size RoI buffers.

Static-shaped equivalent of the `RoiPool` Fast-RCNN max-pooling op
(ref: lib/roi_pooling_layer/roi_pooling_op.cc + roi_pooling_op_gpu.cu.cc,
wrapper network.py:321-332; used at vgg16_convs.py:177-183 with
pooled 7×7 over conv5_3 (1/16) and conv4_3 (1/8), results summed).

Re-design: the CUDA kernel's per-bin argmax over a dynamic pixel
window is replaced by RoI-Align-style bilinear sampling at a static
2×2 sample grid per bin, max-reduced per bin. This keeps every shape
static, turns the gather into vectorized interpolation, and is
differentiable for free (the reference needs a
hand-written backward scatter over stored argmax indices,
roi_pooling_op_gpu.cu.cc). Bilinear max-sampling is a strict
refinement of RoIPool's quantized max (Mask R-CNN, He et al. 2017);
deviation from the reference's hard quantization is intentional and
documented here.

The RoI format is the reference's 7-column Hough output
[batch, cls, x1, y1, x2, y2, score].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def roi_align(
    features: jnp.ndarray,
    rois: jnp.ndarray,
    *,
    pooled_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    samples_per_bin: int = 2,
) -> jnp.ndarray:
    """features: (B, H, W, C); rois: (R, 7) hough format.

    Returns (R, pooled, pooled, C). Invalid/padded rois simply produce
    garbage rows the caller masks out — no dynamic shapes.
    """
    b, h, w, c = features.shape
    r = rois.shape[0]
    p = pooled_size
    s = samples_per_bin

    batch = jnp.clip(rois[:, 0].astype(jnp.int32), 0, b - 1)
    x1 = rois[:, 2] * spatial_scale
    y1 = rois[:, 3] * spatial_scale
    x2 = rois[:, 4] * spatial_scale
    y2 = rois[:, 5] * spatial_scale
    # match the reference's rounding + min-size-1 bin geometry
    # (roi_pooling_op_gpu.cu.cc: round then max(w,1))
    roi_w = jnp.maximum(x2 - x1, 1.0)
    roi_h = jnp.maximum(y2 - y1, 1.0)

    bin_w = roi_w / p
    bin_h = roi_h / p

    # sample grid: s×s bilinear taps per bin, max-pooled
    ii = (jnp.arange(p * s) + 0.5) / s  # positions in bin units
    sx = x1[:, None] + ii[None, :] * bin_w[:, None]  # (R, p·s)
    sy = y1[:, None] + ii[None, :] * bin_h[:, None]

    sx = jnp.clip(sx, 0.0, w - 1.0)
    sy = jnp.clip(sy, 0.0, h - 1.0)

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)
    ax = (sx - x0)[:, None, :, None]  # (R, 1, p·s, 1)
    ay = (sy - y0)[:, :, None, None]  # (R, p·s, 1, 1)

    def gather(yi, xi):
        # (R, p·s, p·s, C) gather of the 4 bilinear corners; the batch
        # index rides in the gather (no (R, H, W, C) materialization)
        return features[batch[:, None, None], yi[:, :, None], xi[:, None, :]]

    f00 = gather(y0i, x0i)
    f01 = gather(y0i, x1i)
    f10 = gather(y1i, x0i)
    f11 = gather(y1i, x1i)
    interp = (
        f00 * (1 - ay) * (1 - ax)
        + f01 * (1 - ay) * ax
        + f10 * ay * (1 - ax)
        + f11 * ay * ax
    )  # (R, p·s, p·s, C)

    # max over the s×s taps of each bin (RoIPool's max semantics)
    interp = interp.reshape(r, p, s, p, s, c)
    return interp.max(axis=(2, 4))


def _interp_matrix(pos: jnp.ndarray, n: int, dtype) -> jnp.ndarray:
    """Bilinear interpolation matrix: W[r, p, i] = max(0, 1-|pos-i|).

    Row r, sample p reads axis position pos[r, p]; contracting W with
    the feature axis reproduces clamped bilinear sampling exactly
    (positions are pre-clipped to [0, n-1], so the two taps
    floor/floor+1 get weights (1-frac, frac) and everything else 0)."""
    idx = jnp.arange(n, dtype=jnp.float32)
    w = jnp.maximum(0.0, 1.0 - jnp.abs(pos[..., None] - idx))
    return w.astype(dtype)


def roi_align_mxu(
    features: jnp.ndarray,
    rois: jnp.ndarray,
    *,
    pooled_size: int = 7,
    spatial_scale: float = 1.0 / 16.0,
    samples_per_bin: int = 2,
) -> jnp.ndarray:
    """RoI-Align as two dense interpolation matmuls.

    Numerically identical sampling grid to `roi_align` (same positions,
    same clamped bilinear taps, same per-bin max), but expressed as
      S = Wy · F · Wxᵀ
    with Wy (R, p·s, H), Wx (R, p·s, W) bilinear weight matrices and
    the batch one-hot folded into Wy. This replaces the 4-corner
    gather (and its scatter-add backward into the feature map) with
    batched matmuls, forward and backward: ~20 GFLOP per 128 RoIs at
    VGG conv4/5 sizes (the reference's CUDA op has a hand-written
    backward scatter, roi_pooling_op_gpu.cu.cc).
    """
    b, h, w, c = features.shape
    r = rois.shape[0]
    p = pooled_size
    s = samples_per_bin
    dtype = features.dtype

    batch = jnp.clip(rois[:, 0].astype(jnp.int32), 0, b - 1)
    x1 = rois[:, 2] * spatial_scale
    y1 = rois[:, 3] * spatial_scale
    x2 = rois[:, 4] * spatial_scale
    y2 = rois[:, 5] * spatial_scale
    roi_w = jnp.maximum(x2 - x1, 1.0)
    roi_h = jnp.maximum(y2 - y1, 1.0)
    ii = (jnp.arange(p * s) + 0.5) / s
    sx = jnp.clip(x1[:, None] + ii[None, :] * (roi_w / p)[:, None], 0.0, w - 1.0)
    sy = jnp.clip(y1[:, None] + ii[None, :] * (roi_h / p)[:, None], 0.0, h - 1.0)

    wy = _interp_matrix(sy, h, dtype)  # (R, p·s, H)
    wx = _interp_matrix(sx, w, dtype)  # (R, p·s, W)
    # fold the batch one-hot into Wy: (R, p·s, B·H)
    onehot = jax.nn.one_hot(batch, b, dtype=dtype)  # (R, B)
    wyb = (onehot[:, None, :, None] * wy[:, :, None, :]).reshape(r, p * s, b * h)

    # S = Wyb · F · Wxᵀ  — two matmul contractions
    f2 = features.reshape(b * h, w * c)
    t = (wyb.reshape(r * p * s, b * h) @ f2).reshape(r, p * s, w, c)
    pooled = jnp.einsum("rywc,rxw->ryxc", t, wx)

    pooled = pooled.reshape(r, p, s, p, s, c)
    return pooled.max(axis=(2, 4))


def roi_pool_fused(
    conv4: jnp.ndarray,
    conv5: jnp.ndarray,
    rois: jnp.ndarray,
    *,
    pooled_size: int = 7,
    backend: str = "mxu",
) -> jnp.ndarray:
    """The PoseCNN dual-scale pooled feature: pool5(1/16) + pool4(1/8)
    summed (ref: vgg16_convs.py:177-186).

    backend="mxu" (default) uses the matmul formulation — same numbers,
    no gather/scatter; "gather" keeps the indexed-sampling path."""
    align = roi_align_mxu if backend == "mxu" else roi_align
    p5 = align(conv5, rois, pooled_size=pooled_size, spatial_scale=1.0 / 16.0)
    p4 = align(conv4, rois, pooled_size=pooled_size, spatial_scale=1.0 / 8.0)
    return p5 + p4
