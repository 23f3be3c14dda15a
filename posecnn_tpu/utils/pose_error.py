"""Pose error metrics (ADD, ADD-S/ADI, reprojection, RE, TE) in JAX.

Semantics match lib/utils/pose_error.py (Hodan et al. ECCVW16 impl):
  add  — mean ‖(Rx+t) − (R̂x+t̂)‖                    (ref: :55-69)
  adi  — mean nearest-neighbor distance (symmetric)  (ref: :71-90)
  reproj — mean 2D reprojection error                (ref: :25-53)
  re / te — geodesic degrees / L2 meters             (ref: :92-117)

Design notes: the reference's cKDTree nearest-neighbor query
becomes a dense pairwise distance computed via a Gram matrix on the
matmul (‖a−b‖² = ‖a‖² − 2a·b + ‖b‖²) — exact, batched, jit-safe. All
functions vmap over leading axes.
"""

from __future__ import annotations

import jax.numpy as jnp

from posecnn_tpu.utils.quaternion import rotation_geodesic_deg
from posecnn_tpu.utils.se3 import transform_points


def add_error(r_est, t_est, r_gt, t_gt, pts):
    """ADD (ref: pose_error.py:55-69). pts: (..., P, 3)."""
    rt_est = jnp.concatenate([r_est, t_est[..., None]], -1)
    rt_gt = jnp.concatenate([r_gt, t_gt[..., None]], -1)
    pe = transform_points(rt_est, pts)
    pg = transform_points(rt_gt, pts)
    return jnp.linalg.norm(pe - pg, axis=-1).mean(-1)


def adi_error(r_est, t_est, r_gt, t_gt, pts):
    """ADD-S (ref: pose_error.py:71-90): for each GT-transformed point,
    distance to nearest estimated-transformed point; kd-tree replaced by
    a Gram-matrix pairwise distance."""
    rt_est = jnp.concatenate([r_est, t_est[..., None]], -1)
    rt_gt = jnp.concatenate([r_gt, t_gt[..., None]], -1)
    pe = transform_points(rt_est, pts)  # (..., P, 3)
    pg = transform_points(rt_gt, pts)
    # pairwise squared distances via Gram matrix (fp32 accumulate)
    gram = jnp.einsum("...ik,...jk->...ij", pg, pe, preferred_element_type=jnp.float32)
    sq = (
        jnp.sum(pg * pg, -1, keepdims=True)
        - 2.0 * gram
        + jnp.sum(pe * pe, -1)[..., None, :]
    )
    nn = jnp.sqrt(jnp.maximum(sq.min(-1), 0.0))
    return nn.mean(-1)


def reproj_error(k, r_est, t_est, r_gt, t_gt, pts):
    """2D reprojection error (ref: pose_error.py:25-53)."""
    rt_est = jnp.concatenate([r_est, t_est[..., None]], -1)
    rt_gt = jnp.concatenate([r_gt, t_gt[..., None]], -1)
    pe = transform_points(rt_est, pts) @ jnp.swapaxes(k, -1, -2)
    pg = transform_points(rt_gt, pts) @ jnp.swapaxes(k, -1, -2)
    uv_e = pe[..., :2] / jnp.maximum(pe[..., 2:3], 1e-10)
    uv_g = pg[..., :2] / jnp.maximum(pg[..., 2:3], 1e-10)
    return jnp.linalg.norm(uv_e - uv_g, axis=-1).mean(-1)


def re(r_est, r_gt):
    """Rotation error in degrees (ref: pose_error.py:92-105)."""
    return rotation_geodesic_deg(r_est, r_gt)


def te(t_est, t_gt):
    """Translation error in meters (ref: pose_error.py:107-117)."""
    return jnp.linalg.norm(t_gt - t_est, axis=-1)


def auc_of_errors(errors, max_threshold: float = 0.1, num_steps: int = 1000):
    """ADD(-S) accuracy-threshold AUC as used for YCB-Video evaluation
    (PoseCNN paper metric; in-repo thresholding at lov.py:484-487).
    errors: 1-D array of per-instance errors (use inf for missed
    detections). Returns AUC in [0, 1]."""
    thresholds = jnp.linspace(0.0, max_threshold, num_steps)
    acc = (errors[None, :] < thresholds[:, None]).mean(-1)
    return jnp.trapezoid(acc, thresholds) / max_threshold
