"""Voxel-grid ops: 2D↔3D feature lifting for the 3D/video experiments.

JAX equivalents of the `Backproject`, `Project` and
`Computelabel` custom ops:

  backproject — lift image features + labels into a grid_size³ voxel
    grid: each voxel is placed in world coords (meta voxel step/min,
    meta[42:48]), transformed by pose_world2live (meta[18:30]),
    projected with K (meta[0:9]); pixels in a (2k+1)² window whose
    depth is within `threshold` of the voxel's camera depth are
    averaged; empty voxels keep the previous 3D label and flag 0
    (ref: lib/backprojecting_layer/backprojecting_op.cc:150-245).
  project — inverse: sample voxel features back onto pixels by voxel
    lookup of each pixel's backprojected 3D point
    (ref: lib/projecting_layer/projecting_op.cc).
  compute_label — per-pixel argmax class from the voxel label volume
    at each pixel's voxel (ref: lib/computing_label_layer/
    computing_label_op.cc).

The voxel triple-loop becomes a dense vectorized computation over the
(D, H, W) grid; the pixel-window average is a static unrolled set of
shifted gathers, like ops/flow.py.
"""

from __future__ import annotations

import jax.numpy as jnp


def _voxel_centers(meta, grid_size):
    """(G³, 3) world coords of voxel centers; axis order (d, h, w) →
    (X, Y, Z) per the reference indexing (backprojecting_op.cc:176-179)."""
    g = grid_size
    idx = jnp.arange(g, dtype=jnp.float32)
    d = jnp.repeat(idx, g * g)
    h = jnp.tile(jnp.repeat(idx, g), g)
    w = jnp.tile(idx, g * g)
    x = d * meta[42] + meta[45]
    y = h * meta[43] + meta[46]
    z = w * meta[44] + meta[47]
    return jnp.stack([x, y, z], -1)


def backproject(
    features: jnp.ndarray,  # (B, H, W, C)
    labels: jnp.ndarray,  # (B, H, W, L) one-hot/prob labels
    labels_3d: jnp.ndarray,  # (B, G, G, G, L) previous voxel labels
    depth: jnp.ndarray,  # (B, H, W)
    meta_data: jnp.ndarray,  # (B, 48)
    *,
    grid_size: int = 32,
    kernel_size: int = 1,
    threshold: float = 0.02,
):
    """Returns (voxel_data (B,G,G,G,C), voxel_label (B,G,G,G,L),
    voxel_flag (B,G,G,G,1))."""
    b, height, width, c = features.shape
    l = labels.shape[-1]
    g = grid_size
    n_vox = g * g * g

    def one(feat, lab, lab3d, dep, meta):
        centers = _voxel_centers(meta, g)  # (G³, 3)
        w2l = meta[18:30].reshape(3, 4)
        k = meta[0:9].reshape(3, 3)
        cam = centers @ w2l[:, :3].T + w2l[:, 3]
        proj = cam @ k.T
        px = jnp.round(proj[:, 0] / jnp.maximum(proj[:, 2], 1e-10)).astype(jnp.int32)
        py = jnp.round(proj[:, 1] / jnp.maximum(proj[:, 2], 1e-10)).astype(jnp.int32)
        zvox = cam[:, 2]

        acc_f = jnp.zeros((n_vox, c), features.dtype)
        acc_l = jnp.zeros((n_vox, l), labels.dtype)
        count = jnp.zeros((n_vox, 1), features.dtype)
        for dy in range(-kernel_size, kernel_size + 1):
            for dx in range(-kernel_size, kernel_size + 1):
                uu = px + dx
                vv = py + dy
                inb = (uu >= 0) & (uu < width) & (vv >= 0) & (vv < height)
                uc = jnp.clip(uu, 0, width - 1)
                vc = jnp.clip(vv, 0, height - 1)
                dpix = dep[vc, uc]
                ok = (inb & (jnp.abs(dpix - zvox) < threshold))[:, None].astype(features.dtype)
                acc_f = acc_f + feat[vc, uc] * ok
                acc_l = acc_l + lab[vc, uc] * ok
                count = count + ok
        hit = count > 0
        data = jnp.where(hit, acc_f / jnp.maximum(count, 1.0), 0.0)
        label = jnp.where(hit, acc_l / jnp.maximum(count, 1.0), lab3d.reshape(n_vox, l))
        flag = hit.astype(features.dtype)
        return (
            data.reshape(g, g, g, c),
            label.reshape(g, g, g, l),
            flag.reshape(g, g, g, 1),
        )

    import jax

    return jax.vmap(one)(features, labels, labels_3d, depth, meta_data)


def _pixel_voxel_indices(depth, meta, grid_size):
    """Map each pixel to its voxel (d, h, w) index via backprojection
    + pose_live2world; returns flat indices and validity."""
    h, w = depth.shape
    g = grid_size
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    kinv = meta[9:18].reshape(3, 3)
    l2w = meta[30:42].reshape(3, 4)
    rx = kinv[0, 0] * xs + kinv[0, 1] * ys + kinv[0, 2]
    ry = kinv[1, 0] * xs + kinv[1, 1] * ys + kinv[1, 2]
    rz = kinv[2, 0] * xs + kinv[2, 1] * ys + kinv[2, 2]
    cam = jnp.stack([depth * rx, depth * ry, depth * rz], -1)
    world = jnp.einsum("ij,hwj->hwi", l2w[:, :3], cam) + l2w[:, 3]
    d_idx = jnp.round((world[..., 0] - meta[45]) / jnp.maximum(meta[42], 1e-10)).astype(jnp.int32)
    h_idx = jnp.round((world[..., 1] - meta[46]) / jnp.maximum(meta[43], 1e-10)).astype(jnp.int32)
    w_idx = jnp.round((world[..., 2] - meta[47]) / jnp.maximum(meta[44], 1e-10)).astype(jnp.int32)
    valid = (
        (depth > 1e-6)
        & (d_idx >= 0) & (d_idx < g)
        & (h_idx >= 0) & (h_idx < g)
        & (w_idx >= 0) & (w_idx < g)
    )
    flat = (
        jnp.clip(d_idx, 0, g - 1) * g * g
        + jnp.clip(h_idx, 0, g - 1) * g
        + jnp.clip(w_idx, 0, g - 1)
    )
    return flat, valid


def project(
    voxel_data: jnp.ndarray,  # (B, G, G, G, C)
    depth: jnp.ndarray,  # (B, H, W)
    meta_data: jnp.ndarray,  # (B, 48)
):
    """Sample voxel features at each pixel's voxel
    (ref: lib/projecting_layer/projecting_op.cc)."""
    import jax

    b, g = voxel_data.shape[0], voxel_data.shape[1]
    c = voxel_data.shape[-1]

    def one(vox, dep, meta):
        flat, valid = _pixel_voxel_indices(dep, meta, g)
        sampled = vox.reshape(-1, c)[flat]
        return jnp.where(valid[..., None], sampled, 0.0)

    return jax.vmap(one)(voxel_data, depth, meta_data)


def compute_label(
    voxel_labels: jnp.ndarray,  # (B, G, G, G, L) label probabilities
    depth: jnp.ndarray,  # (B, H, W)
    meta_data: jnp.ndarray,  # (B, 48)
):
    """Per-pixel argmax class from the voxel label volume
    (ref: lib/computing_label_layer/computing_label_op.cc)."""
    probs = project(voxel_labels, depth, meta_data)
    return jnp.argmax(probs, axis=-1).astype(jnp.int32)
