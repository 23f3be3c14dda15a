"""Recurrent-state flow warping (video segmentation path).

JAX equivalent of the `Computeflow` op
(ref: lib/computing_flow_layer/computing_flow_op.cc:66-248): for each
current-frame pixel with depth, backproject with K⁻¹ (meta[9:18]),
transform by pose_live2world (meta[30:42]) into the previous frame's
reference, project with K (meta[0:9]), and average the previous
hidden state/weights over a (2k+1)² neighborhood gated by depth
consistency |Z_prev − Z1| < threshold. Outputs the warped state,
warped weights (clamped at max_weight), and the current frame's
camera-frame point map.

Formulation: the neighborhood loop becomes a static unrolled set
of shifted gathers (vectorized, no scatter); everything else is
elementwise — XLA fuses the whole warp into a couple of kernels.
"""

from __future__ import annotations

import jax.numpy as jnp


def compute_flow(
    state: jnp.ndarray,  # (B, H, W, U) previous hidden state
    weights: jnp.ndarray,  # (B, H, W, U) previous accumulation weights
    points_prev: jnp.ndarray,  # (B, H, W, 3) previous-frame point map
    depth: jnp.ndarray,  # (B, H, W) current depth (meters)
    meta_data: jnp.ndarray,  # (B, 48)
    *,
    kernel_size: int = 3,
    threshold: float = 0.02,
    max_weight: float = 50.0,
):
    """Returns (warped_state, warped_weights, points_current)."""
    b, h, w = depth.shape
    xs = jnp.arange(w, dtype=jnp.float32)[None, None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[None, :, None]

    kinv = meta_data[:, 9:18].reshape(b, 3, 3)
    k = meta_data[:, 0:9].reshape(b, 3, 3)
    live2world = meta_data[:, 30:42].reshape(b, 3, 4)

    # backproject current pixels (ref: .cc "backproject the pixel")
    rx = kinv[:, 0, 0, None, None] * xs + kinv[:, 0, 1, None, None] * ys + kinv[:, 0, 2, None, None]
    ry = kinv[:, 1, 0, None, None] * xs + kinv[:, 1, 1, None, None] * ys + kinv[:, 1, 2, None, None]
    rz = kinv[:, 2, 0, None, None] * xs + kinv[:, 2, 1, None, None] * ys + kinv[:, 2, 2, None, None]
    px_cam = jnp.stack([depth * rx, depth * ry, depth * rz], axis=-1)  # (B,H,W,3)

    # transform into the previous frame's reference
    xyz1 = jnp.einsum("bij,bhwj->bhwi", live2world[:, :, :3], px_cam) + live2world[:, None, None, :, 3]
    # project with K
    proj = jnp.einsum("bij,bhwj->bhwi", k, xyz1)
    u = jnp.round(proj[..., 0] / jnp.maximum(proj[..., 2], 1e-10)).astype(jnp.int32)
    v = jnp.round(proj[..., 1] / jnp.maximum(proj[..., 2], 1e-10)).astype(jnp.int32)

    z_target = xyz1[..., 2]
    has_depth = depth > 1e-6

    acc_state = jnp.zeros_like(state)
    acc_weight = jnp.zeros_like(weights)
    count = jnp.zeros((b, h, w, 1), state.dtype)

    half = kernel_size
    batch_idx = jnp.arange(b)[:, None, None]
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            uu = u + dx
            vv = v + dy
            inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            uc = jnp.clip(uu, 0, w - 1)
            vc = jnp.clip(vv, 0, h - 1)
            z_prev = points_prev[batch_idx, vc, uc, 2]
            ok = inb & has_depth & (jnp.abs(z_prev - z_target) < threshold)
            okf = ok[..., None].astype(state.dtype)
            acc_state = acc_state + state[batch_idx, vc, uc] * okf
            acc_weight = acc_weight + weights[batch_idx, vc, uc] * okf
            count = count + okf

    denom = jnp.maximum(count, 1.0)
    warped_state = acc_state / denom
    # pixels with NO match keep weight 1 (the reference initializes
    # top_weights to 1 and only overwrites on a match,
    # computing_flow_op.cc:175-177) — so unmatched pixels enter the
    # GRU fusion as h' = (u·x + h₀)/(1+u)-style updates, not h' = x
    matched = count > 0
    warped_weights = jnp.where(
        matched, jnp.minimum(acc_weight / denom, max_weight), 1.0
    )
    return warped_state, warped_weights, px_cam
