"""Render-and-compare pose matching loss.

Parity target: the `Matching` custom op (ref: lib/matching_loss/
matching_loss_op.cc + lib/rendering/rendering.cpp — renders the model
at predicted vs GT pose with an OSMesa GL context and compares).

Re-design: the GL rasterizer is replaced by differentiable
soft point splatting — each transformed model point contributes a
Gaussian blob to a low-resolution silhouette map; the loss is a soft
Dice mismatch between the predicted-pose silhouette and the target
mask (GT silhouette or predicted segmentation). Unlike the
reference's renderer (gradient via the op's hand-computed diff), this
is differentiable through the pose by construction, so the same loss
trains the pose head directly (used by the `vgg16_full` variant,
ref: lib/networks/vgg16_full.py with cfg.TRAIN.MATCHING).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from posecnn_tpu.utils.quaternion import quat_to_mat


@partial(jax.jit, static_argnames=("out_h", "out_w"))
def soft_silhouette(
    quat: jnp.ndarray,  # (4,)
    trans: jnp.ndarray,  # (3,)
    points: jnp.ndarray,  # (P, 3)
    k: jnp.ndarray,  # (3, 3) intrinsics scaled to the output resolution
    *,
    out_h: int = 60,
    out_w: int = 80,
    sigma: float = 1.5,
):
    """Differentiable silhouette of the model at (quat, trans):
    max-of-Gaussians splat of projected points → (out_h, out_w) in
    [0, 1]."""
    r = quat_to_mat(quat)
    cam = points @ r.T + trans
    z = jnp.maximum(cam[:, 2], 1e-4)
    u = k[0, 0] * cam[:, 0] / z + k[0, 2]
    v = k[1, 1] * cam[:, 1] / z + k[1, 2]
    xs = jnp.arange(out_w, dtype=jnp.float32)
    ys = jnp.arange(out_h, dtype=jnp.float32)
    # (P, H, W) Gaussians — P is subsampled by callers to keep this
    # small; max over points = soft union
    du = (xs[None, None, :] - u[:, None, None]) ** 2
    dv = (ys[None, :, None] - v[:, None, None]) ** 2
    g = jnp.exp(-(du + dv) / (2.0 * sigma * sigma))
    return jnp.max(g, axis=0)


def matching_loss(
    quat_pred: jnp.ndarray,  # (4,)
    trans_pred: jnp.ndarray,  # (3,)
    target_mask: jnp.ndarray,  # (out_h, out_w) in [0,1]
    points: jnp.ndarray,  # (P, 3) subsampled model points
    k: jnp.ndarray,
    *,
    sigma: float = 1.5,
) -> jnp.ndarray:
    """Soft-IoU mismatch (min/max formulation — exactly 0 for
    identical soft maps, unlike product Dice) between rendered and
    target silhouettes."""
    h, w = target_mask.shape
    sil = soft_silhouette(
        quat_pred, trans_pred, points, k, out_h=h, out_w=w, sigma=sigma
    )
    inter = jnp.sum(jnp.minimum(sil, target_mask))
    union = jnp.sum(jnp.maximum(sil, target_mask))
    return 1.0 - inter / jnp.maximum(union, 1e-10)
