"""Graph-level loss functions in JAX.

Semantics match the reference TF losses:
  loss_cross_entropy_single_frame — normalized CE (ref: lib/fcn/train.py:455-465)
  smooth_l1_loss_vertex           — weighted smooth-L1 (ref: train.py:565-574)
  smooth_l1_loss                  — RPN/RCNN box loss (ref: train.py:577-590)
  loss_quaternion                 — quaternion dot loss (ref: train.py:468-475)

All are pure elementwise+reduce — XLA fuses them into adjacent matmuls;
no Pallas needed here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def loss_cross_entropy_single_frame(log_prob: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Normalized cross entropy.

    log_prob: (B, H, W, C) log-softmax scores (the reference feeds the
    'prob' output of log_softmax_high_dimension); labels: (B, H, W, C)
    one-hot weights from hard_label. (ref: train.py:455-465)
    """
    ce = -jnp.sum(labels * log_prob, axis=-1)
    return jnp.sum(ce) / (jnp.sum(labels) + 1e-10)


def smooth_l1_loss_vertex(
    vertex_pred: jnp.ndarray,
    vertex_targets: jnp.ndarray,
    vertex_weights: jnp.ndarray,
    sigma: float = 1.0,
) -> jnp.ndarray:
    """Weighted smooth-L1 over the vertex map (ref: train.py:565-574).

    Note the reference multiplies the weight INSIDE the huber (diff =
    w·(pred−target)), then normalizes by sum(w); we reproduce exactly.
    """
    sigma_2 = sigma**2
    diff = vertex_weights * (vertex_pred - vertex_targets)
    abs_diff = jnp.abs(diff)
    sign = jax.lax.stop_gradient((abs_diff < 1.0 / sigma_2).astype(diff.dtype))
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    return jnp.sum(in_loss) / (jnp.sum(vertex_weights) + 1e-10)


def smooth_l1_loss(
    bbox_pred: jnp.ndarray,
    bbox_targets: jnp.ndarray,
    bbox_inside_weights: jnp.ndarray,
    bbox_outside_weights: jnp.ndarray,
    sigma: float = 1.0,
    reduce_axes=(1,),
) -> jnp.ndarray:
    """Fast-RCNN style box smooth-L1 (ref: train.py:577-590)."""
    sigma_2 = sigma**2
    diff = bbox_inside_weights * (bbox_pred - bbox_targets)
    abs_diff = jnp.abs(diff)
    sign = jax.lax.stop_gradient((abs_diff < 1.0 / sigma_2).astype(diff.dtype))
    in_loss = diff * diff * (sigma_2 / 2.0) * sign + (abs_diff - 0.5 / sigma_2) * (1.0 - sign)
    out_loss = bbox_outside_weights * in_loss
    return jnp.mean(jnp.sum(out_loss, axis=reduce_axes))


def loss_quaternion(
    pose_pred: jnp.ndarray, pose_targets: jnp.ndarray, pose_weights: jnp.ndarray
) -> jnp.ndarray:
    """1 − (q·q̂)² quaternion distance (ref: train.py:468-475)."""
    distances = 1.0 - jnp.square(jnp.sum(pose_pred * pose_targets, axis=1))
    weights = jnp.mean(pose_weights, axis=1)
    return jnp.sum(weights * distances) / (jnp.sum(weights) + 1e-10)


def build_vertex_targets(
    label: jnp.ndarray,  # (B, H, W) int32 GT label map
    centers: jnp.ndarray,  # (B, C, 2) per-class projected center (x, y)
    log_z: jnp.ndarray,  # (B, C) per-class log depth
    center_valid: jnp.ndarray,  # (B, C) bool — class present in image
    weight_inside: float = 10.0,
):
    """Dense vertex regression targets built ON DEVICE from per-class
    scalars (ref: _generate_vertex_targets minibatch.py:517-577 — the
    reference builds these on the host and ships (H, W, 3C) maps
    through the feed queue; shipping (C, 2)+(C,) instead cuts ~160 MB
    of host work + host→device transfer per 480×640×22-class frame,
    and the elementwise build fuses into the loss).

    Returns (targets, weights), each (B, H, W, 3C) float32 — identical
    values to the host path (single-instance-per-class semantics: the
    instance whose class matches the pixel label claims the pixel).
    """
    b, h, w = label.shape
    c = centers.shape[1]
    one_hot = (label[..., None] == jnp.arange(c)[None, None, None, :]).astype(
        jnp.float32
    )  # (B, H, W, C)
    # per-pixel class features via ONE one-hot matmul
    # (per-pixel take_along_axis gathers run on the scalar unit and
    # dominate the step time; a (HW,C)×(C,4) matmul is ~free)
    feats = jnp.stack(
        [centers[..., 0], centers[..., 1], log_z,
         center_valid.astype(jnp.float32)],
        axis=-1,
    )  # (B, C, 4)
    # HIGHEST precision: center coordinates reach ~600 px and a bf16
    # single-pass matmul (a reduced-precision default) would quantize them by ~2 px,
    # breaking the value-identical contract with the host path
    pix = jnp.einsum(
        "bhwc,bcf->bhwf", one_hot, feats, precision=jax.lax.Precision.HIGHEST
    )  # (B, H, W, 4)
    cx, cy, lz, cvalid_f = pix[..., 0], pix[..., 1], pix[..., 2], pix[..., 3]

    xs = jnp.arange(w, dtype=jnp.float32)[None, None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[None, :, None]
    dx = cx - xs
    dy = cy - ys
    norm = jnp.sqrt(dx * dx + dy * dy) + 1e-10
    fg = (label > 0) & (cvalid_f > 0.5)  # (B, H, W)
    dirs = jnp.stack([dx / norm, dy / norm, lz], axis=-1)  # (B, H, W, 3)
    dirs = dirs * fg[..., None]

    targets = (one_hot[..., None] * dirs[..., None, :]).reshape(b, h, w, 3 * c)
    wchan = (one_hot * fg[..., None]) * weight_inside  # (B, H, W, C)
    weights = jnp.broadcast_to(
        wchan[..., None], (b, h, w, c, 3)
    ).reshape(b, h, w, 3 * c)
    return targets, weights


def softmax_cross_entropy_with_logits(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Sparse softmax CE (used by the domain-adaptation head,
    ref: train.py:512-514)."""
    log_p = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(log_p, labels[..., None], axis=-1)[..., 0]
