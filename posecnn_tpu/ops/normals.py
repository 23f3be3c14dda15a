"""Depth → normal map computation.

JAX equivalent of the CUDA normal estimator
(ref: lib/normals/compute_normals.cu, bound via gpu_normals.pyx and
used by the NORMAL input mode, gt_synthesize_layer/minibatch.py:206-223).
The reference bilateral-filters depth then differentiates; here the
cross-product of central-difference tangent vectors on the
backprojected point map gives the same normals, as pure stencil ops
XLA fuses (no kernel needed — this is elementwise work).
"""

from __future__ import annotations

import jax.numpy as jnp


def backproject_depth(depth: jnp.ndarray, fx, fy, px, py) -> jnp.ndarray:
    """depth (..., H, W) meters → point map (..., H, W, 3) camera frame."""
    h, w = depth.shape[-2], depth.shape[-1]
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    x = (xs[None, :] - px) / fx
    y = (ys[:, None] - py) / fy
    return jnp.stack([depth * x, depth * y, depth], axis=-1)


def depth_to_normals(
    depth: jnp.ndarray, fx, fy, px, py, *, depth_eps: float = 1e-6
) -> jnp.ndarray:
    """depth (H, W) → unit normal map (H, W, 3), zeros where invalid.

    Normals point toward the camera (n_z < 0), matching the reference's
    convention for point-plane ICP residuals.
    """
    pts = backproject_depth(depth, fx, fy, px, py)
    # central differences (replicated at borders)
    dx = jnp.gradient(pts, axis=1)
    dy = jnp.gradient(pts, axis=0)
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-10)
    # orient toward camera
    n = jnp.where(n[..., 2:3] > 0, -n, n)
    valid = (depth > depth_eps)[..., None]
    return jnp.where(valid, n, 0.0)
