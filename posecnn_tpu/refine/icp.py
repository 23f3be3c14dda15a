"""Depth-based pose refinement: batched point-plane Gauss-Newton ICP.

JAX re-design of the reference's test-time `solveICP`
(ref: lib/synthesize/synthesize.cpp:2052-2381): the reference renders
the model at the predicted pose with OpenGL, re-estimates translation
from masked depth, polishes with Nelder-Mead, then refines 8
depth-offset hypotheses with a GPU Gauss-Newton point-plane ICP
(ref: kinect_fusion icp.cu:24-234 solves the 6×6 system via
thrust-reduced J^T J) and scores them with a kd-tree radius-match
fraction (SegICP metric, ref: synthesize.cpp:2312-2355).

Formulation — no renderer, no kd-tree, no host round trips:
  * model "rendering" → direct transformation of the class point
    cloud + projective data association against the backprojected
    depth map (bilinear-sampled point + normal maps);
  * translation re-estimate → masked mean depth offset along the ray;
  * hypothesis sweep → a vmapped axis of 8 depth offsets
    (ref: synthesize.cpp:2204-2272 hypothesis loop);
  * Gauss-Newton → J^T J accumulated as a (P,6)ᵀ(P,6) matmul in full
    float32, 6×6 solve per (object, hypothesis) via jnp.linalg.solve,
    pose update by se3 exponential; lax.scan over iterations;
  * scoring → fraction of model points whose associated observed
    point lies within a radius (projective SegICP stand-in).

Everything vmaps over objects; the whole refiner jits to one XLA
program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from posecnn_tpu.ops.normals import backproject_depth, depth_to_normals
from posecnn_tpu.utils.quaternion import quat_to_mat, mat_to_quat


def _so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (3,) axis-angle → (3,3) rotation, Taylor-safe."""
    theta2 = jnp.sum(w * w)
    theta = jnp.sqrt(theta2 + 1e-20)
    k = jnp.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], w.dtype
    )
    a = jnp.where(theta < 1e-5, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(theta < 1e-5, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    return jnp.eye(3, dtype=w.dtype) + a * k + b * (k @ k)


def _bilinear_sample(img: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """img (H, W, C); u, v (...) pixel coords → (..., C)."""
    h, w = img.shape[:2]
    u = jnp.clip(u, 0.0, w - 1.001)
    v = jnp.clip(v, 0.0, h - 1.001)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    au = (u - u0)[..., None]
    av = (v - v0)[..., None]
    f00 = img[v0, u0]
    f01 = img[v0, u0 + 1]
    f10 = img[v0 + 1, u0]
    f11 = img[v0 + 1, u0 + 1]
    return (
        f00 * (1 - av) * (1 - au)
        + f01 * (1 - av) * au
        + f10 * av * (1 - au)
        + f11 * av * au
    )


class ICPResult(NamedTuple):
    quat: jnp.ndarray  # (4,) refined rotation (wxyz)
    trans: jnp.ndarray  # (3,) refined translation
    score: jnp.ndarray  # () inlier fraction of the winning hypothesis
    hypothesis_scores: jnp.ndarray  # (H,)


def _gn_step(
    rt,
    model_pts,
    obs_pts,
    obs_normals,
    obs_valid,
    damping,
    *,
    max_rot_step: float = 0.1,
    max_trans_step: float = 0.02,
):
    """One damped Gauss-Newton point-plane update with a trust region.

    rt: (3,4); residual r_i = n_i · (q_i − (R p_i + t)) with Jacobian
    rows [p' × n, n] for the twist [ω, v] — the same normal equations
    the reference reduces per-point (ref: icp.cu:24-137).

    Point-plane ICP on a mostly-front-facing surface is gauge
    ill-conditioned (JTJ eigenvalues span ~4-5 decades): Levenberg
    scaling (λ·diag) plus per-step rotation/translation clamps keep
    the weakly-observed twist directions from exploding.
    """
    r, t = rt[:, :3], rt[:, 3]
    p_cam = model_pts @ r.T + t  # (P, 3)
    diff = obs_pts - p_cam
    res = jnp.sum(obs_normals * diff, axis=-1)  # (P,)
    jw = jnp.cross(p_cam, obs_normals)  # (P, 3)
    jac = jnp.concatenate([jw, obs_normals], axis=-1)  # (P, 6)
    wvalid = obs_valid.astype(jnp.float32)
    jw_ = jac * wvalid[:, None]
    # full float32: the 6×6 system spans 4-5 decades (see above), and a
    # TF32 product would keep only ~3 digits of it; P×6 costs nothing
    hi = jax.lax.Precision.HIGHEST
    jtj = jnp.dot(jw_.T, jac, precision=hi)
    jtj = jtj + damping * jnp.diag(jnp.diag(jtj)) + 1e-4 * jnp.eye(6, dtype=jac.dtype)
    jtr = jnp.dot(jw_.T, res, precision=hi)
    delta = jnp.linalg.solve(jtj, jtr)  # (6,)
    # trust region: clamp rotation and translation step magnitudes
    rot_n = jnp.linalg.norm(delta[:3])
    trn_n = jnp.linalg.norm(delta[3:])
    scale = jnp.minimum(
        jnp.minimum(1.0, max_rot_step / jnp.maximum(rot_n, 1e-12)),
        jnp.minimum(1.0, max_trans_step / jnp.maximum(trn_n, 1e-12)),
    )
    delta = delta * scale
    dr = _so3_exp(delta[:3])
    new_r = dr @ r
    new_t = dr @ t + delta[3:]
    return jnp.concatenate([new_r, new_t[:, None]], axis=1)


def _associate(
    rt, model_pts, point_map, normal_map, depth, fx, fy, px, py, max_dist,
    self_visibility: bool = True,
):
    """Projective data association: project model points, sample the
    observed point/normal maps (replaces GL render + kd-tree NN,
    ref: synthesize.cpp:2104-2139).

    Visibility: the reference only matches VISIBLE model points
    (it renders the model with GL); here occluded points — those
    whose own depth lies behind the observed surface at their pixel —
    are culled by a projective depth gate, otherwise back-surface
    points associate with the front surface and bias the point-plane
    normal equations systematically.

    self_visibility applies a coarse per-bucket z-buffer to cull the
    MODEL's own back surface — an object-cloud concern; disable it for
    frame-to-model tracking where the source is a depth frame (every
    pixel visible by construction; the coarse buckets would wrongly
    cull oblique surfaces).
    """
    r, t = rt[:, :3], rt[:, 3]
    p_cam = model_pts @ r.T + t
    z = jnp.maximum(p_cam[:, 2], 1e-6)
    u = fx * p_cam[:, 0] / z + px
    v = fy * p_cam[:, 1] / z + py
    obs_p = _bilinear_sample(point_map, u, v)
    obs_n = _bilinear_sample(normal_map, u, v)
    obs_z = obs_p[:, 2]
    in_img = (u >= 0) & (u < point_map.shape[1] - 1) & (v >= 0) & (v < point_map.shape[0] - 1)
    has_depth = obs_z > 1e-4
    # observed-depth gate: model point near the observed surface along
    # the ray (occluded-by-scene points have p_z >> obs_z)
    near_obs = jnp.abs(p_cam[:, 2] - obs_z) < max_dist
    # SELF-visibility: cull the model's own back surface with a coarse
    # scatter-min z-buffer over the projected bbox — the stand-in for
    # the reference's GL render of the model (synthesize.cpp:2104-2139)
    self_vis = _self_visible(p_cam, u, v) if self_visibility else jnp.ones_like(has_depth)
    close = jnp.linalg.norm(obs_p - p_cam, axis=-1) < max_dist
    n_ok = jnp.linalg.norm(obs_n, axis=-1) > 0.5
    valid = in_img & has_depth & near_obs & self_vis & close & n_ok
    return obs_p, obs_n, valid


def _self_visible(p_cam, u, v, res: int = 48, margin: float = 0.008):
    """Front-surface test: bucket projected points into a res×res grid
    over their bbox, scatter-min depth per bucket, keep points within
    `margin` of their bucket's minimum."""
    z = p_cam[:, 2]
    u0, u1 = jnp.min(u), jnp.max(u) + 1e-3
    v0, v1 = jnp.min(v), jnp.max(v) + 1e-3
    bu = jnp.clip(((u - u0) / (u1 - u0) * res).astype(jnp.int32), 0, res - 1)
    bv = jnp.clip(((v - v0) / (v1 - v0) * res).astype(jnp.int32), 0, res - 1)
    bucket = bv * res + bu
    zbuf = jnp.full((res * res,), jnp.inf, z.dtype).at[bucket].min(z)
    return z < zbuf[bucket] + margin


def refine_pose_icp(
    quat: jnp.ndarray,  # (4,) initial rotation
    trans: jnp.ndarray,  # (3,) initial translation
    model_pts: jnp.ndarray,  # (P, 3)
    depth: jnp.ndarray,  # (H, W) observed depth, meters
    mask: jnp.ndarray,  # (H, W) bool — predicted object mask
    k: jnp.ndarray,  # (3, 3) intrinsics
    *,
    num_iters: int = 8,
    num_hypotheses: int = 8,
    hypothesis_spread: float = 0.04,
    max_assoc_dist: float = 0.02,
    inlier_dist: float = 0.01,
    damping: float = 1e-2,
    rot_perturb: float = 0.0,
) -> ICPResult:
    """Refine one object pose against the depth map (see module doc).

    rot_perturb > 0 additionally sweeps ±rot_perturb-radian rotation
    perturbations about each camera axis (identity + 6 = 7 rotation
    hypotheses crossed with the depth offsets), each GN-refined and
    scored — the derivative-free rotation polish standing in for the
    reference's NLopt Nelder-Mead pose polish
    (ref: synthesize.cpp:2172-2199), and the escape hatch when the
    initial rotation error exceeds the point-plane GN basin."""
    fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    point_map = backproject_depth(depth, fx, fy, px, py)
    normal_map = depth_to_normals(depth, fx, fy, px, py)

    # translation re-estimation from masked depth along the center ray
    # (ref: synthesize.cpp:1969-2027 re-estimates t from masked depth)
    mvalid = mask & (depth > 1e-4)
    wsum = jnp.maximum(jnp.sum(mvalid), 1)
    mean_obs_z = jnp.sum(jnp.where(mvalid, depth, 0.0)) / wsum
    # model half-extent along z: observed surface is the near side, so
    # shift center depth by half the model depth spread
    half_depth = 0.5 * (jnp.max(model_pts[:, 2]) - jnp.min(model_pts[:, 2]))
    est_z = mean_obs_z + half_depth
    t0 = trans * jnp.where(trans[2] > 1e-4, est_z / trans[2], 1.0)
    t0 = jnp.where(jnp.sum(mvalid) > 10, t0, trans)

    r0 = quat_to_mat(quat)

    # hypothesis sweep over depth offsets (ref: 8 offsets, 2204-2272),
    # optionally crossed with rotation perturbations
    offsets = jnp.linspace(-hypothesis_spread, hypothesis_spread, num_hypotheses)
    if rot_perturb > 0.0:
        eye3 = jnp.eye(3, dtype=jnp.float32)
        ws = jnp.concatenate(
            [jnp.zeros((1, 3)), rot_perturb * eye3, -rot_perturb * eye3], axis=0
        )  # (7, 3) axis-angle perturbations
    else:
        ws = jnp.zeros((1, 3))
    nw = ws.shape[0]
    dz_grid = jnp.repeat(offsets, nw)
    w_grid = jnp.tile(ws, (num_hypotheses, 1))

    def run_one(dz, w):
        scale = (t0[2] + dz) / jnp.maximum(t0[2], 1e-6)
        t_h = t0 * jnp.array([1.0, 1.0, 1.0]) * scale
        r_h = _so3_exp(w) @ r0
        rt = jnp.concatenate([r_h, t_h[:, None]], axis=1)

        gates = jnp.full((num_iters,), max_assoc_dist)

        def body(rt, gate):
            obs_p, obs_n, valid = _associate(
                rt, model_pts, point_map, normal_map, depth, fx, fy, px, py, gate
            )
            rt_new = _gn_step(rt, model_pts, obs_p, obs_n, valid, damping)
            # guard: keep previous pose if the solve exploded
            ok = jnp.all(jnp.isfinite(rt_new))
            return jnp.where(ok, rt_new, rt), None

        rt, _ = jax.lax.scan(body, rt, gates)
        # SegICP-style score: fraction of model points with a close
        # observed match (ref: synthesize.cpp:2312-2355)
        obs_p, _, valid = _associate(
            rt, model_pts, point_map, normal_map, depth, fx, fy, px, py, inlier_dist
        )
        score = jnp.mean(valid.astype(jnp.float32))
        return rt, score

    rts, scores = jax.vmap(run_one)(dz_grid, w_grid)
    # tie-break toward the unperturbed rotation: on rotation-ambiguous
    # (near-symmetric) surfaces all rotation hypotheses score within
    # noise of each other — an epsilon penalty ∝ |w| (far below one
    # inlier quantum 1/P) keeps the identity hypothesis winning ties
    # instead of wandering to an arbitrary perturbation
    sel_scores = scores - 1e-5 * jnp.linalg.norm(w_grid, axis=1)
    best = jnp.argmax(sel_scores)
    rt_best = rts[best]
    return ICPResult(
        quat=mat_to_quat(rt_best[:, :3]),
        trans=rt_best[:, 3],
        score=scores[best],
        hypothesis_scores=scores,
    )


@partial(jax.jit, static_argnames=("num_iters", "num_hypotheses", "rot_perturb"))
def icp_refine_batch(
    quats, transs, model_pts_per_obj, depth, masks, k, *, num_iters=8,
    num_hypotheses=8, rot_perturb=0.0,
):
    """vmapped refiner over N objects of one frame.

    quats (N,4), transs (N,3), model_pts_per_obj (N,P,3),
    masks (N,H,W) bool, depth (H,W), k (3,3)."""
    return jax.vmap(
        lambda q, t, pts, m: refine_pose_icp(
            q, t, pts, depth, m, k, num_iters=num_iters,
            num_hypotheses=num_hypotheses, rot_perturb=rot_perturb,
        )
    )(quats, transs, model_pts_per_obj, masks)
