"""RANSAC center / pose estimation from label + vertex predictions.

JAX re-design of the standalone Ransac3D library
(ref: lib/pose_estimation/ransac3D.cpp:estimatePose/estimateCenter,
Brachmann-style hypothesis sampling + inlier scoring, bound via
ransac.pyx) and the CPU Hough op's RANSAC refinement path
(ref: lib/hough_voting_layer/hough_voting_op.cc:408-516).

Formulation: a FIXED number of hypotheses is sampled and scored
in parallel (vmap) instead of adaptive sequential RANSAC — the
classic trade of control flow for throughput:

  estimate_center — hypotheses are intersections of random pixel-pair
    direction lines; scored by the inlier cone test over all sampled
    pixels; best hypothesis refined by a weighted least-squares
    re-solve over its inliers.
  estimate_pose_3d — hypotheses from random 3-point rigid alignments
    (Kabsch via SVD) between predicted object-frame coordinates and
    backprojected camera points; scored by 3D inlier distance; best
    refined by Kabsch over all inliers.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _line_intersection(p0, d0, p1, d1):
    """Intersection of two 2D lines p + t·d (least-squares via 2×2
    solve); returns (point (2,), ok)."""
    a = jnp.stack([d0, -d1], axis=1)  # (2, 2)
    rhs = p1 - p0
    det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    ok = jnp.abs(det) > 1e-8
    det_safe = jnp.where(ok, det, 1.0)
    t = (rhs[0] * a[1, 1] - rhs[1] * a[0, 1]) / det_safe
    return p0 + t * d0, ok


class CenterEstimate(NamedTuple):
    center: jnp.ndarray  # (2,)
    inliers: jnp.ndarray  # ()
    score: jnp.ndarray  # () inlier fraction


@partial(jax.jit, static_argnames=("num_hypotheses",))
def estimate_center(
    pixels_xy: jnp.ndarray,  # (N, 2) pixel coords of the object class
    directions: jnp.ndarray,  # (N, 2) predicted unit center directions
    valid: jnp.ndarray,  # (N,)
    rng: jax.Array,
    *,
    num_hypotheses: int = 64,
    inlier_threshold: float = 0.9,
) -> CenterEstimate:
    """RANSAC 2D center from direction votes (ref: estimateCenter —
    sample pixel pairs, intersect their lines, count cone inliers)."""
    n = pixels_xy.shape[0]
    r1, r2 = jax.random.split(rng)
    # sample from VALID entries only: padded fixed-shape inputs would
    # otherwise starve the hypothesis pool (valid-first ordering +
    # random position below the valid count)
    order = jnp.argsort(~valid, stable=True)
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    ia = jnp.take(order, jax.random.randint(r1, (num_hypotheses,), 0, n_valid))
    ib = jnp.take(order, jax.random.randint(r2, (num_hypotheses,), 0, n_valid))

    def hyp(i, j):
        c, ok = _line_intersection(
            pixels_xy[i], directions[i], pixels_xy[j], directions[j]
        )
        ok = ok & valid[i] & valid[j]
        d = c[None, :] - pixels_xy  # (N, 2)
        dist = jnp.linalg.norm(d, axis=1) + 1e-10
        cos = jnp.sum(d * directions, axis=1) / dist
        inl = (cos > inlier_threshold) & valid
        return c, jnp.where(ok, jnp.sum(inl), -1)

    centers, scores = jax.vmap(hyp)(ia, ib)
    best = jnp.argmax(scores)
    any_ok = scores[best] >= 0  # all-invalid input → no usable hypothesis
    c_best = centers[best]

    # refinement: weighted LS center over the best hypothesis' inliers
    # (each inlier contributes its direction line; normal equations)
    d = c_best[None, :] - pixels_xy
    dist = jnp.linalg.norm(d, axis=1) + 1e-10
    cos = jnp.sum(d * directions, axis=1) / dist
    w = ((cos > inlier_threshold) & valid).astype(jnp.float32)
    # line through p with direction u: minimize Σ w·((c−p)·n)², n ⟂ u
    nx = -directions[:, 1]
    ny = directions[:, 0]
    a11 = jnp.sum(w * nx * nx)
    a12 = jnp.sum(w * nx * ny)
    a22 = jnp.sum(w * ny * ny)
    b1 = jnp.sum(w * nx * (nx * pixels_xy[:, 0] + ny * pixels_xy[:, 1]))
    b2 = jnp.sum(w * ny * (nx * pixels_xy[:, 0] + ny * pixels_xy[:, 1]))
    a = jnp.array([[a11, a12], [a12, a22]]) + 1e-6 * jnp.eye(2)
    c_ref = jnp.linalg.solve(a, jnp.array([b1, b2]))
    c_out = jnp.where(jnp.sum(w) >= 2, c_ref, c_best)
    return CenterEstimate(
        center=c_out,
        inliers=jnp.where(any_ok, jnp.sum(w), 0.0),
        score=jnp.where(any_ok, jnp.sum(w) / jnp.maximum(jnp.sum(valid), 1), 0.0),
    )


def _kabsch(src, dst, w):
    """Weighted rigid alignment dst ≈ R·src + t (Kabsch/SVD)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-10)
    mu_s = jnp.sum(src * w[:, None], 0) / wsum
    mu_d = jnp.sum(dst * w[:, None], 0) / wsum
    s = src - mu_s
    d = dst - mu_d
    cov = (s * w[:, None]).T @ d  # (3, 3)
    u, _, vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(vt.T @ u.T)
    sgn = jnp.diag(jnp.array([1.0, 1.0, det]))
    r = vt.T @ sgn @ u.T
    t = mu_d - r @ mu_s
    return r, t


class PoseEstimate(NamedTuple):
    rotation: jnp.ndarray  # (3, 3)
    translation: jnp.ndarray  # (3,)
    inliers: jnp.ndarray
    score: jnp.ndarray


@partial(jax.jit, static_argnames=("num_hypotheses", "num_refine"))
def estimate_pose_3d(
    obj_coords: jnp.ndarray,  # (N, 3) predicted object-frame coords
    cam_points: jnp.ndarray,  # (N, 3) backprojected camera points
    valid: jnp.ndarray,  # (N,)
    rng: jax.Array,
    *,
    num_hypotheses: int = 256,
    inlier_threshold: float = 0.02,
    num_refine: int = 2,
) -> PoseEstimate:
    """RANSAC rigid pose from 3D-3D correspondences
    (ref: estimatePose ransac3D.cpp — 3-point hypotheses, inlier
    counting, refinement on inliers)."""
    n = obj_coords.shape[0]
    keys = jax.random.split(rng, num_hypotheses)
    # valid-first ordering: sample hypotheses from valid entries only
    order = jnp.argsort(~valid, stable=True)
    n_valid = jnp.maximum(jnp.sum(valid), 1)

    def hyp(key):
        idx = jnp.take(order, jax.random.randint(key, (3,), 0, n_valid))
        w3 = valid[idx].astype(jnp.float32)
        r, t = _kabsch(obj_coords[idx], cam_points[idx], w3)
        pred = obj_coords @ r.T + t
        err = jnp.linalg.norm(pred - cam_points, axis=1)
        inl = (err < inlier_threshold) & valid
        ok = jnp.sum(w3) == 3
        return r, t, jnp.where(ok, jnp.sum(inl), -1)

    rs, ts, scores = jax.vmap(hyp)(keys)
    best = jnp.argmax(scores)
    any_ok = scores[best] >= 0
    r, t = rs[best], ts[best]

    # iterative refinement on inliers (ref refinement loop)
    def refine(carry, _):
        r, t = carry
        pred = obj_coords @ r.T + t
        err = jnp.linalg.norm(pred - cam_points, axis=1)
        w = ((err < inlier_threshold) & valid).astype(jnp.float32)
        r2, t2 = _kabsch(obj_coords, cam_points, w)
        ok = jnp.sum(w) >= 3
        return (jnp.where(ok, r2, r), jnp.where(ok, t2, t)), None

    (r, t), _ = jax.lax.scan(refine, (r, t), None, length=num_refine)
    pred = obj_coords @ r.T + t
    err = jnp.linalg.norm(pred - cam_points, axis=1)
    inl = ((err < inlier_threshold) & valid).astype(jnp.float32)
    return PoseEstimate(
        rotation=r,
        translation=t,
        inliers=jnp.where(any_ok, jnp.sum(inl), 0.0),
        score=jnp.where(any_ok, jnp.sum(inl) / jnp.maximum(jnp.sum(valid), 1), 0.0),
    )
