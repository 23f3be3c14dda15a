"""TSDF + semantic-probability fusion with camera tracking ("KinectFusion").

JAX re-design of the reference's KinectFusion subsystem
(ref: lib/kinect_fusion/ — TSDF+probability composite voxels
include/df/voxel/{tsdf,probability,compositeVoxel}.h, depth fusion
src/fusion/fusion.cu, camera-tracking projective point-plane ICP
src/optimization/icp.cu:24-234, raycast prediction src/raycast/
raycast.cu, surface extraction src/marchingCubes/marchingCubes.cu;
python API kfusion.pyx:28-77 feed_data/back_project/solve_pose/
fuse_depth/extract_surface used by the video test loop
lib/fcn/test.py:407-520).

Formulation — every stage is a dense, fixed-shape XLA program:
  fuse      voxel centers → camera projection → truncated SDF running
            average + per-voxel class-probability running average
            (one fused elementwise pass over the G³ grid; replaces the
            scatter-style CUDA kernel with a gather formulation).
  raycast   fixed-step sphere march along each pixel ray through the
            volume (lax.scan over steps, trilinear TSDF sampling),
            emitting depth/point/normal/label maps.
  track     projective point-plane Gauss-Newton of the new depth
            against the raycast maps — the same damped 6×6 GN core as
            refine/icp (ref icp.cu solves the identical system with
            thrust reductions).
  surface   zero-crossing voxel extraction with argmax labels (a
            surfel cloud; replaces marching-cubes triangles — same
            information for label visualization/evaluation).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from posecnn_tpu.ops.normals import backproject_depth, depth_to_normals
from posecnn_tpu.refine.icp import _gn_step


class TSDFVolume(NamedTuple):
    tsdf: jnp.ndarray  # (G, G, G) signed distance (truncated, in τ units)
    weight: jnp.ndarray  # (G, G, G)
    prob: jnp.ndarray  # (G, G, G, C) class probabilities
    origin: jnp.ndarray  # (3,) world position of voxel (0,0,0)
    voxel_size: jnp.ndarray  # () meters


def create_volume(grid_size: int, num_classes: int, origin, voxel_size) -> TSDFVolume:
    g = grid_size
    return TSDFVolume(
        tsdf=jnp.ones((g, g, g), jnp.float32),
        weight=jnp.zeros((g, g, g), jnp.float32),
        prob=jnp.zeros((g, g, g, num_classes), jnp.float32),
        origin=jnp.asarray(origin, jnp.float32),
        voxel_size=jnp.asarray(voxel_size, jnp.float32),
    )


def _voxel_world_coords(vol: TSDFVolume):
    g = vol.tsdf.shape[0]
    idx = jnp.arange(g, dtype=jnp.float32)
    x = vol.origin[0] + idx[:, None, None] * vol.voxel_size
    y = vol.origin[1] + idx[None, :, None] * vol.voxel_size
    z = vol.origin[2] + idx[None, None, :] * vol.voxel_size
    return (
        jnp.broadcast_to(x, (g, g, g)),
        jnp.broadcast_to(y, (g, g, g)),
        jnp.broadcast_to(z, (g, g, g)),
    )


@partial(jax.jit, static_argnames=())
def fuse_frame(
    vol: TSDFVolume,
    depth: jnp.ndarray,  # (H, W)
    label_prob: jnp.ndarray,  # (H, W, C)
    k: jnp.ndarray,  # (3, 3)
    world2cam: jnp.ndarray,  # (3, 4) camera pose
    truncation: float = 0.04,
    max_weight: float = 50.0,
) -> TSDFVolume:
    """TSDF + probability fusion of one RGB-D frame
    (ref: fusion.cu fuseFrame semantics; probability voxel update per
    compositeVoxel tsdf+probability)."""
    h, w = depth.shape
    wx, wy, wz = _voxel_world_coords(vol)
    # world → camera
    cam_x = world2cam[0, 0] * wx + world2cam[0, 1] * wy + world2cam[0, 2] * wz + world2cam[0, 3]
    cam_y = world2cam[1, 0] * wx + world2cam[1, 1] * wy + world2cam[1, 2] * wz + world2cam[1, 3]
    cam_z = world2cam[2, 0] * wx + world2cam[2, 1] * wy + world2cam[2, 2] * wz + world2cam[2, 3]
    z_safe = jnp.maximum(cam_z, 1e-6)
    u = jnp.round(k[0, 0] * cam_x / z_safe + k[0, 2]).astype(jnp.int32)
    v = jnp.round(k[1, 1] * cam_y / z_safe + k[1, 2]).astype(jnp.int32)
    in_img = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (cam_z > 1e-3)
    uc = jnp.clip(u, 0, w - 1)
    vc = jnp.clip(v, 0, h - 1)
    d_obs = depth[vc, uc]
    has_depth = d_obs > 1e-6
    sdf = d_obs - cam_z  # positive in front of the surface
    update = in_img & has_depth & (sdf > -truncation)
    tsdf_new = jnp.clip(sdf / truncation, -1.0, 1.0)

    w_old = vol.weight
    w_upd = update.astype(jnp.float32)
    w_new = jnp.minimum(w_old + w_upd, max_weight)
    denom = jnp.maximum(w_old + w_upd, 1e-10)
    tsdf = jnp.where(update, (vol.tsdf * w_old + tsdf_new) / denom, vol.tsdf)

    p_obs = label_prob[vc, uc]
    prob = jnp.where(
        update[..., None], (vol.prob * w_old[..., None] + p_obs) / denom[..., None], vol.prob
    )
    return vol._replace(tsdf=tsdf, weight=w_new, prob=prob)


def _sample_tsdf(vol: TSDFVolume, pts_world: jnp.ndarray):
    """Trilinear TSDF sample at (..., 3) world points; outside → +1."""
    g = vol.tsdf.shape[0]
    f = (pts_world - vol.origin) / vol.voxel_size
    f0 = jnp.floor(f)
    t = f - f0
    i0 = f0.astype(jnp.int32)
    inb = jnp.all((i0 >= 0) & (i0 < g - 1), axis=-1)
    i0c = jnp.clip(i0, 0, g - 2)

    def at(dx, dy, dz):
        return vol.tsdf[i0c[..., 0] + dx, i0c[..., 1] + dy, i0c[..., 2] + dz]

    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    val = (
        at(0, 0, 0) * (1 - tx) * (1 - ty) * (1 - tz)
        + at(1, 0, 0) * tx * (1 - ty) * (1 - tz)
        + at(0, 1, 0) * (1 - tx) * ty * (1 - tz)
        + at(0, 0, 1) * (1 - tx) * (1 - ty) * tz
        + at(1, 1, 0) * tx * ty * (1 - tz)
        + at(1, 0, 1) * tx * (1 - ty) * tz
        + at(0, 1, 1) * (1 - tx) * ty * tz
        + at(1, 1, 1) * tx * ty * tz
    )
    return jnp.where(inb, val, 1.0)


@partial(jax.jit, static_argnames=("height", "width", "num_steps"))
def raycast(
    vol: TSDFVolume,
    k: jnp.ndarray,
    cam2world: jnp.ndarray,  # (3, 4)
    *,
    height: int,
    width: int,
    near: float = 0.3,
    far: float = 3.0,
    num_steps: int = 192,
):
    """Fixed-step ray march (ref: raycast.cu). Returns (depth, points
    (world), labels) maps; depth 0 where no surface crossing."""
    xs = jnp.arange(width, dtype=jnp.float32)[None, :]
    ys = jnp.arange(height, dtype=jnp.float32)[:, None]
    dir_cam = jnp.stack(
        [
            (xs - k[0, 2]) / k[0, 0] * jnp.ones((height, 1)),
            (ys - k[1, 2]) / k[1, 1] * jnp.ones((1, width)),
            jnp.ones((height, width)),
        ],
        -1,
    )
    dir_world = jnp.einsum("ij,hwj->hwi", cam2world[:, :3], dir_cam)
    origin = cam2world[:, 3]

    step = (far - near) / num_steps
    ts = near + jnp.arange(num_steps, dtype=jnp.float32) * step

    def body(carry, t):
        hit_t, prev_val = carry
        pts = origin + dir_world * t
        val = _sample_tsdf(vol, pts)
        crossed = (prev_val > 0) & (val <= 0) & (hit_t < 0)
        # linear interpolation of the zero crossing
        frac = prev_val / jnp.maximum(prev_val - val, 1e-10)
        t_hit = (t - step) + frac * step
        hit_t = jnp.where(crossed, t_hit, hit_t)
        return (hit_t, val), None

    init = (jnp.full((height, width), -1.0), jnp.ones((height, width)))
    (hit_t, _), _ = jax.lax.scan(body, init, ts)

    hit = hit_t > 0
    t_safe = jnp.where(hit, hit_t, near)
    pts_world = origin + dir_world * t_safe[..., None]
    depth = jnp.where(hit, t_safe * dir_cam[..., 2], 0.0)

    # labels from the probability volume at the hit points
    g = vol.tsdf.shape[0]
    idx = jnp.clip(
        ((pts_world - vol.origin) / vol.voxel_size).astype(jnp.int32), 0, g - 1
    )
    probs = vol.prob[idx[..., 0], idx[..., 1], idx[..., 2]]
    labels = jnp.where(hit, jnp.argmax(probs, -1).astype(jnp.int32), 0)
    return depth, jnp.where(hit[..., None], pts_world, 0.0), labels


@partial(jax.jit, static_argnames=("num_iters",))
def track_camera(
    depth_new: jnp.ndarray,  # (H, W) new frame depth
    model_depth: jnp.ndarray,  # (H, W) predicted depth (raycast or prev)
    k: jnp.ndarray,
    init_cam2model: jnp.ndarray,  # (3, 4) initial relative pose
    *,
    num_iters: int = 10,
    max_points: int = 4096,
    damping: float = 1e-2,
):
    """Frame-to-model camera tracking: point-plane GN of the new
    frame's points against the model depth's point/normal maps
    (ref: icp.cu:24-234 — identical normal equations)."""
    h, w = depth_new.shape
    fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    pts_new = backproject_depth(depth_new, fx, fy, px, py)
    model_pts = backproject_depth(model_depth, fx, fy, px, py)
    model_nrm = depth_to_normals(model_depth, fx, fy, px, py)

    # fixed evenly-strided subsample of the new frame's valid pixels
    stride = max(1, (h * w) // max_points)
    flat = pts_new.reshape(-1, 3)[::stride]
    valid_src = (depth_new.reshape(-1)[::stride] > 1e-6)

    from posecnn_tpu.refine.icp import _associate

    def body(rt, _):
        # self_visibility off: the source is a depth frame (every pixel
        # visible); the coarse object z-buffer would cull oblique
        # surfaces and bias tracking toward near-in-bucket points
        obs_p, obs_n, valid = _associate(
            rt, flat, model_pts, model_nrm, model_depth, fx, fy, px, py, 0.05,
            self_visibility=False,
        )
        rt_new = _gn_step(rt, flat, obs_p, obs_n, valid & valid_src, damping)
        ok = jnp.all(jnp.isfinite(rt_new))
        return jnp.where(ok, rt_new, rt), None

    rt, _ = jax.lax.scan(body, init_cam2model, None, length=num_iters)
    return rt


# --- marching tetrahedra (triangle extraction) ---
#
# Each grid cube is split into 6 tetrahedra around the v0–v6 diagonal;
# each tet emits 0–2 triangles on its iso-crossing edges. 16-case
# tables for a tet are tiny and exact (unlike the 256-case cube table),
# and every shape is static — the static-shape counterpart of the
# reference's marchingCubes.cu (ref: lib/kinect_fusion/src/
# marchingCubes/marchingCubes.cu, weighted-vertex interpolation +
# per-triangle labels).

# cube corner offsets, binary-ordered v0..v7
_CUBE_OFFS = jnp.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    jnp.int32,
)
# 6-tet decomposition around the v0–v6 diagonal
_TETS = jnp.array(
    [
        [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
        [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6],
    ],
    jnp.int32,
)
# tet edges (pairs of local tet-vertex ids) indexed 0..5
_TET_EDGES = jnp.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], jnp.int32
)
# case → up to 2 triangles of edge ids (-1 = unused); bit i of the
# case mask set ⟺ tet vertex i is inside (tsdf < iso). Quad cases are
# split along a diagonal; each quad cycle steps between edges sharing
# a tet face (verified: every adjacent pair shares a face).
_TET_TRI_TABLE = jnp.array(
    [
        [[-1, -1, -1], [-1, -1, -1]],  # 0000
        [[0, 1, 2], [-1, -1, -1]],     # 0001 a
        [[0, 4, 3], [-1, -1, -1]],     # 0010 b
        [[1, 2, 4], [1, 4, 3]],        # 0011 ab
        [[1, 3, 5], [-1, -1, -1]],     # 0100 c
        [[0, 3, 5], [0, 5, 2]],        # 0101 ac
        [[0, 1, 5], [0, 5, 4]],        # 0110 bc
        [[2, 4, 5], [-1, -1, -1]],     # 0111 abc
        [[2, 5, 4], [-1, -1, -1]],     # 1000 d
        [[0, 4, 5], [0, 5, 1]],        # 1001 ad
        [[0, 2, 5], [0, 5, 3]],        # 1010 bd
        [[1, 5, 3], [-1, -1, -1]],     # 1011 abd
        [[1, 2, 4], [1, 4, 3]],        # 1100 cd
        [[0, 4, 3], [-1, -1, -1]],     # 1101 acd
        [[0, 1, 2], [-1, -1, -1]],     # 1110 bcd
        [[-1, -1, -1], [-1, -1, -1]],  # 1111
    ],
    jnp.int32,
)


@partial(jax.jit, static_argnames=("max_triangles",))
def extract_mesh(vol: TSDFVolume, max_triangles: int = 16384, iso: float = 0.0):
    """Marching-tetrahedra triangle mesh from the TSDF volume
    (ref: marchingCubes.cu surface + label extraction — same
    information, tetrahedral cases instead of the 256-entry cube
    table). Each triangle is oriented so its geometric normal points
    along the local TSDF gradient (outward, toward positive TSDF), so
    winding is consistent across the mesh for winding-shaded viewers.

    Returns (tri_verts (T, 3, 3) world coords, tri_labels (T,) int32,
    tri_valid (T,) bool) with T = max_triangles, selected by smallest
    |tsdf| at the owning cube when over budget."""
    g = vol.tsdf.shape[0]
    n = g - 1  # cubes per axis

    def slab(xi):
        # cube corner coords for one x-slab: (8, n, n) indices
        cx = jnp.broadcast_to(
            _CUBE_OFFS[:, 0][:, None, None] + xi, (8, n, n)
        )
        cy = jnp.broadcast_to(
            _CUBE_OFFS[:, 1][:, None, None] + jnp.arange(n)[None, :, None],
            (8, n, n),
        )
        cz = jnp.broadcast_to(
            _CUBE_OFFS[:, 2][:, None, None] + jnp.arange(n)[None, None, :],
            (8, n, n),
        )
        vals = vol.tsdf[cx, cy, cz]  # (8, n, n)
        wts = vol.weight[cx, cy, cz]
        observed = jnp.all(wts > 0, axis=0)  # (n, n)
        corners = jnp.stack([cx, cy, cz], -1).astype(jnp.float32)  # (8,n,n,3)

        tv = vals[_TETS]  # (6, 4, n, n) per-tet corner values
        tc = corners[_TETS]  # (6, 4, n, n, 3)
        inside = tv < iso
        case = (
            inside[:, 0].astype(jnp.int32)
            + 2 * inside[:, 1].astype(jnp.int32)
            + 4 * inside[:, 2].astype(jnp.int32)
            + 8 * inside[:, 3].astype(jnp.int32)
        )  # (6, n, n)

        # all 6 edge interpolations per tet: (6, 6_edges, n, n, 3)
        pa = tc[:, _TET_EDGES[:, 0]]
        pb = tc[:, _TET_EDGES[:, 1]]
        sa = tv[:, _TET_EDGES[:, 0]]
        sb = tv[:, _TET_EDGES[:, 1]]
        # canonicalize edge endpoint order (smaller TSDF value first):
        # adjacent tetrahedra share edges with endpoints in opposite
        # order, and a+f(b−a) vs b+f'(a−b) differ by one ulp — same
        # operands in the same order make shared-edge vertices bitwise
        # identical, so downstream welding is exact
        swap = (sa > sb)[..., None]
        pa, pb = (
            jnp.where(swap, pb, pa),
            jnp.where(swap, pa, pb),
        )
        sa, sb = jnp.minimum(sa, sb), jnp.maximum(sa, sb)
        frac = (iso - sa) / jnp.where(jnp.abs(sb - sa) < 1e-10, 1e-10, sb - sa)
        frac = jnp.clip(frac, 0.0, 1.0)[..., None]
        everts = pa + frac * (pb - pa)  # (6, 6, n, n, 3) in voxel units

        tris_e = _TET_TRI_TABLE[case]  # (6, n, n, 2, 3) edge ids
        tri_ok = tris_e[..., 0] >= 0  # (6, n, n, 2)
        e_safe = jnp.maximum(tris_e, 0)
        # gather triangle vertices: (6, n, n, 2, 3verts, 3xyz)
        everts_t = jnp.moveaxis(everts, 1, -2)  # (6, n, n, 6, 3)
        tri_v = jnp.take_along_axis(
            everts_t[:, :, :, None, :, :],
            e_safe[..., None].repeat(3, -1)[:, :, :, :, :, :],
            axis=4,
        )  # (6, n, n, 2, 3, 3)
        tri_ok = tri_ok & observed[None, :, :, None]
        # selection score: most-central cubes first (min |tsdf| at v0)
        score = -jnp.abs(tv[:, 0])[..., None]  # (6, n, n, 2... broadcast)
        score = jnp.broadcast_to(score, tri_ok.shape)
        flat_v = tri_v.reshape(-1, 3, 3)
        flat_s = jnp.where(tri_ok.reshape(-1), score.reshape(-1), -jnp.inf)
        # top-k PER SLAB bounds peak memory to O(n · per_slab) instead
        # of materializing all 12(g−1)³ candidates (≈7 GB at g=256)
        k_slab = min(per_slab, flat_s.shape[0])
        s_top, i_top = jax.lax.top_k(flat_s, k_slab)
        v_top = flat_v[i_top]
        if k_slab < per_slab:
            pad = per_slab - k_slab
            v_top = jnp.pad(v_top, ((0, pad), (0, 0), (0, 0)))
            s_top = jnp.pad(s_top, (0, pad), constant_values=-jnp.inf)
        return v_top, s_top

    # each slab keeps at most max_triangles candidates — the global
    # top-max_triangles set is a subset of the per-slab top sets
    per_slab = min(max_triangles, 12 * n * n)
    tri_v, score = jax.lax.map(slab, jnp.arange(n))
    tri_v = tri_v.reshape(-1, 3, 3)
    score = score.reshape(-1)
    k_final = min(max_triangles, score.shape[0])
    _, idx = jax.lax.top_k(score, k_final)
    valid = score[idx] > -jnp.inf
    verts_vox = tri_v[idx]  # (k_final, 3, 3) voxel coords
    if k_final < max_triangles:
        pad = max_triangles - k_final
        verts_vox = jnp.pad(verts_vox, ((0, pad), (0, 0), (0, 0)))
        valid = jnp.pad(valid, (0, pad))

    # orient each triangle along the local TSDF gradient: central
    # differences at the centroid voxel give the outward direction
    # (TSDF grows outward); swap v1/v2 where the geometric normal
    # opposes it. Keeps per-face normals consistent mesh-wide.
    cent_i = jnp.clip(jnp.mean(verts_vox, axis=1).astype(jnp.int32), 1, g - 2)
    cx, cy, cz = cent_i[:, 0], cent_i[:, 1], cent_i[:, 2]
    grad = jnp.stack(
        [
            vol.tsdf[cx + 1, cy, cz] - vol.tsdf[cx - 1, cy, cz],
            vol.tsdf[cx, cy + 1, cz] - vol.tsdf[cx, cy - 1, cz],
            vol.tsdf[cx, cy, cz + 1] - vol.tsdf[cx, cy, cz - 1],
        ],
        axis=-1,
    )
    geom_n = jnp.cross(
        verts_vox[:, 1] - verts_vox[:, 0], verts_vox[:, 2] - verts_vox[:, 0]
    )
    flip = (jnp.sum(geom_n * grad, axis=-1) < 0)[:, None, None]
    verts_vox = jnp.where(flip, verts_vox[:, [0, 2, 1]], verts_vox)

    verts = vol.origin + verts_vox * vol.voxel_size

    # per-triangle label: argmax class probability at the centroid voxel
    cent = jnp.clip(
        jnp.mean(verts_vox, axis=1).astype(jnp.int32), 0, g - 1
    )
    labels = jnp.argmax(
        vol.prob[cent[:, 0], cent[:, 1], cent[:, 2]], axis=-1
    ).astype(jnp.int32)
    return verts, labels, valid


def save_mesh_ply(path: str, verts, labels=None, valid=None, weld_tol=None) -> int:
    """Write an extracted triangle mesh as ascii PLY with welded
    vertices (ref: KinectFusion::save_model
    lib/kinect_fusion/kinect_fusion.cpp:592-630 — welded-vertex PLY of
    the marching-cubes surface; exposed as kfusion.save_model,
    kfusion.pyx:76-77). Host-side IO: takes `extract_mesh` output
    ((T,3,3) triangle vertices, per-triangle labels, validity mask),
    welds vertices on quantized keys (extract_mesh canonicalizes the
    shared-edge interpolation order so coincident vertices are bitwise
    equal; the quantized key is a backstop for degenerate iso-touching
    edges), and adds the per-face class label as an extra uint8
    property (the reference carries labels separately through
    extract_surface). Faces are written in natural (0,1,2) order —
    extract_mesh triangles are already oriented outward along the
    TSDF gradient, unlike the reference's unoriented marching-cubes
    output which save_model reverses. When `valid` is None,
    exactly-degenerate faces (all three vertices equal — the padding
    rows of `extract_mesh` output) are dropped. `weld_tol` defaults
    to 1e-5 of the bounding-box diagonal. Returns the face count."""
    import numpy as np

    verts = np.asarray(verts, np.float32)
    labels = None if labels is None else np.asarray(labels)
    if valid is not None:
        keep = np.asarray(valid).astype(bool)
    else:
        # padded invalid rows are all-zero triangles at the origin
        keep = ~np.all(verts == verts[:, :1, :], axis=(1, 2))
    verts = verts[keep]
    labels = None if labels is None else labels[keep]
    flat = verts.reshape(-1, 3)
    if weld_tol is None:
        diag = float(np.linalg.norm(flat.max(0) - flat.min(0))) if len(flat) else 1.0
        weld_tol = max(diag, 1e-12) * 1e-5
    qkeys = np.round(flat / weld_tol).astype(np.int64)
    _, first, inverse = np.unique(
        qkeys, axis=0, return_index=True, return_inverse=True
    )
    unique = flat[first]  # representative (un-quantized) coordinates
    faces = inverse.reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(unique)}\n")
        f.write("property float32 x\nproperty float32 y\nproperty float32 z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uint8 int32 vertex_index\n")
        if labels is not None:
            f.write("property uint8 label\n")
        f.write("end_header\n")
        for v in unique:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for i, face in enumerate(faces):
            # natural order: extract_mesh already orients triangles
            # outward along the TSDF gradient, so writing (0,1,2)
            # preserves outward normals. (The reference reverses to
            # (2,1,0) — kinect_fusion.cpp:592-630 — because ITS
            # marching-cubes output winds the other way; reversing
            # here would undo our orientation.)
            line = f"3 {face[0]} {face[1]} {face[2]}"
            if labels is not None:
                line += f" {int(labels[i])}"
            f.write(line + "\n")
    return len(faces)


def extract_surface(vol: TSDFVolume, threshold: float = 0.2, max_points: int = 65536):
    """Zero-crossing voxel extraction with argmax labels → surfel
    cloud (replaces marching-cubes triangle extraction,
    ref: marchingCubes.cu; same label-surface information)."""
    g = vol.tsdf.shape[0]
    near_surface = (jnp.abs(vol.tsdf) < threshold) & (vol.weight > 0)
    score = jnp.where(near_surface, -jnp.abs(vol.tsdf), -jnp.inf).reshape(-1)
    _, idx = jax.lax.top_k(score, max_points)
    valid = score[idx] > -jnp.inf
    zi = idx % g
    yi = (idx // g) % g
    xi = idx // (g * g)
    pts = vol.origin + jnp.stack([xi, yi, zi], -1).astype(jnp.float32) * vol.voxel_size
    labels = jnp.argmax(vol.prob.reshape(-1, vol.prob.shape[-1])[idx], -1)
    return pts, labels.astype(jnp.int32), valid
