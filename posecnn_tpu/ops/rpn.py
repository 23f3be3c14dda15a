"""Region Proposal Network ops, fully jittable with static shapes.

Parity target: the reference's RPN python layers wrapped in tf.py_func
(ref: lib/rpn_layer/ — snippets.py anchor generation,
proposal_layer.py:15, anchor_target_layer.py:18,
proposal_target_layer.py:17 with per-class pose targets at :98).

Design: the reference's per-step device→host→device py_func round
trips (SURVEY.md §3.5) become pure-JAX top-k + masked NMS + fixed-size
sampling — everything stays on device inside one jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from posecnn_tpu.ops.nms import nms
from posecnn_tpu.utils.bbox import bbox_transform, bbox_transform_inv, box_iou, clip_boxes


def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """Base anchors, numpy (host, build-time) —
    (ref: lib/rpn_layer/generate_anchors.py semantics)."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append(
                [cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1), cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)]
            )
    return np.asarray(anchors, np.float32)


def anchor_grid(height: int, width: int, stride: int, base_anchors: np.ndarray) -> np.ndarray:
    """All shifted anchors (H·W·A, 4), numpy (static per model shape)
    (ref: snippets.py generate_anchors_pre)."""
    sx = np.arange(width) * stride
    sy = np.arange(height) * stride
    sx, sy = np.meshgrid(sx, sy)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = base_anchors[None, :, :] + shifts[:, None, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)


class Proposals(NamedTuple):
    rois: jnp.ndarray  # (N, 5) [batch, x1, y1, x2, y2]
    scores: jnp.ndarray  # (N,)
    valid: jnp.ndarray  # (N,) bool


def proposal_layer(
    rpn_cls_prob: jnp.ndarray,  # (H, W, 2A) softmaxed [bg..., fg...]
    rpn_bbox_pred: jnp.ndarray,  # (H, W, 4A)
    anchors: jnp.ndarray,  # (H·W·A, 4)
    im_height: int,
    im_width: int,
    *,
    batch_index: int = 0,
    pre_nms_topk: int = 2000,
    post_nms_topk: int = 300,
    nms_threshold: float = 0.7,
    min_size: float = 16.0,
) -> Proposals:
    """Proposal generation (ref: proposal_layer.py:15): fg scores →
    top-k → delta decode → clip → size filter → NMS → top post_nms."""
    a = anchors.shape[0] // (rpn_cls_prob.shape[0] * rpn_cls_prob.shape[1])
    fg_scores = rpn_cls_prob[..., a:].reshape(-1)
    deltas = rpn_bbox_pred.reshape(-1, 4)

    k = min(pre_nms_topk, fg_scores.shape[0])
    top_scores, top_idx = jax.lax.top_k(fg_scores, k)
    boxes = bbox_transform_inv(anchors[top_idx], deltas[top_idx])
    boxes = clip_boxes(boxes, im_height, im_width)
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    size_ok = (ws >= min_size) & (hs >= min_size)

    keep = nms(boxes, top_scores, nms_threshold, valid=size_ok)
    # rank kept boxes by score, take post_nms_topk slots
    ranked = jnp.argsort(-jnp.where(keep, top_scores, -jnp.inf))[:post_nms_topk]
    sel_boxes = boxes[ranked]
    sel_scores = top_scores[ranked]
    sel_valid = keep[ranked]
    if ranked.shape[0] < post_nms_topk:
        # fewer anchors than the RoI budget (small feature maps):
        # pad to the fixed slot count with invalid rows
        pad = post_nms_topk - ranked.shape[0]
        sel_boxes = jnp.pad(sel_boxes, ((0, pad), (0, 0)))
        sel_scores = jnp.pad(sel_scores, (0, pad))
        sel_valid = jnp.pad(sel_valid, (0, pad))
    rois = jnp.concatenate(
        [jnp.full((post_nms_topk, 1), float(batch_index)), sel_boxes], axis=1
    )
    return Proposals(rois=rois, scores=sel_scores, valid=sel_valid)


def _random_keep(mask: jnp.ndarray, max_keep, rng: jax.Array) -> jnp.ndarray:
    """Uniformly keep at most max_keep True entries of mask (the
    reference's np.random.choice subsampling, made jittable via a
    noise-key threshold)."""
    noise = jax.random.uniform(rng, mask.shape)
    key = jnp.where(mask, noise, -1.0)
    kth_idx = jnp.clip(max_keep - 1, 0, mask.shape[0] - 1)
    kth = jnp.sort(key)[::-1][kth_idx]
    cut = jnp.where(jnp.sum(mask) > max_keep, kth, -0.5)
    return mask & (key >= cut)


class AnchorTargets(NamedTuple):
    labels: jnp.ndarray  # (N,) 1 fg / 0 bg / -1 ignore
    bbox_targets: jnp.ndarray  # (N, 4)
    bbox_inside_weights: jnp.ndarray  # (N, 4)
    bbox_outside_weights: jnp.ndarray  # (N, 4)


def anchor_target_layer(
    anchors: jnp.ndarray,  # (N, 4)
    gt_boxes: jnp.ndarray,  # (G, 5) [x1,y1,x2,y2,cls]
    gt_valid: jnp.ndarray,  # (G,)
    im_height: int,
    im_width: int,
    rng: jax.Array,
    *,
    positive_overlap: float = 0.7,
    negative_overlap: float = 0.3,
    batch_size: int = 256,
    fg_fraction: float = 0.5,
    clobber_positives: bool = False,
) -> AnchorTargets:
    """RPN training targets (ref: anchor_target_layer.py:18): label
    anchors by IoU, subsample to a fixed batch with random priority
    keys (the reference's np.random.choice disabling becomes top-k on
    noise — deterministic given rng)."""
    n = anchors.shape[0]
    inside = (
        (anchors[:, 0] >= 0)
        & (anchors[:, 1] >= 0)
        & (anchors[:, 2] < im_width)
        & (anchors[:, 3] < im_height)
    )
    ious = box_iou(anchors, gt_boxes[:, :4])  # (N, G)
    ious = jnp.where(gt_valid[None, :], ious, -1.0)
    # restrict to inside-image anchors BEFORE the per-GT argmax — the
    # reference computes overlaps over inside anchors only
    # (anchor_target_layer.py), guaranteeing every GT a positive even
    # at the border where its global best anchor falls outside
    ious_inside = jnp.where(inside[:, None], ious, -1.0)
    max_iou = ious_inside.max(axis=1)
    argmax_gt = ious_inside.argmax(axis=1)

    # anchors with the highest IoU per GT are positive too; max-scatter
    # so padded GTs (routed to index 0) can never clobber a True
    best_per_gt = ious_inside.argmax(axis=0)
    is_best = jnp.zeros((n,), bool).at[jnp.clip(best_per_gt, 0, n - 1)].max(gt_valid)

    labels = jnp.full((n,), -1, jnp.int32)
    if clobber_positives:
        # RPN_CLOBBER_POSITIVES (ref config.py:162): negatives assigned
        # LAST so a below-negative-overlap anchor loses its positive
        # label even if it is some GT's best anchor
        labels = jnp.where(inside & (is_best | (max_iou >= positive_overlap)), 1, labels)
        labels = jnp.where(inside & (max_iou < negative_overlap), 0, labels)
    else:
        labels = jnp.where(inside & (max_iou < negative_overlap), 0, labels)
        labels = jnp.where(inside & (is_best | (max_iou >= positive_overlap)), 1, labels)

    # subsample: keep at most num_fg positives / rest negatives
    num_fg = int(fg_fraction * batch_size)
    r1, r2 = jax.random.split(rng)
    fg_keep = _random_keep(labels == 1, num_fg, r1)
    n_fg = jnp.sum(fg_keep)
    bg_keep = _random_keep(labels == 0, batch_size - n_fg, r2)
    labels = jnp.where((labels == 1) & ~fg_keep, -1, labels)
    labels = jnp.where((labels == 0) & ~bg_keep, -1, labels)

    targets = bbox_transform(anchors, gt_boxes[jnp.clip(argmax_gt, 0, gt_boxes.shape[0] - 1), :4])
    inside_w = jnp.where((labels == 1)[:, None], 1.0, 0.0) * jnp.ones((1, 4))
    n_examples = jnp.maximum(jnp.sum(labels >= 0), 1).astype(jnp.float32)
    outside_w = jnp.where((labels >= 0)[:, None], 1.0 / n_examples, 0.0) * jnp.ones((1, 4))
    return AnchorTargets(labels, targets, inside_w, outside_w)


class ProposalTargets(NamedTuple):
    rois: jnp.ndarray  # (R, 5)
    labels: jnp.ndarray  # (R,)
    bbox_targets: jnp.ndarray  # (R, 4C)
    bbox_inside_weights: jnp.ndarray  # (R, 4C)
    bbox_outside_weights: jnp.ndarray  # (R, 4C)
    pose_targets: jnp.ndarray  # (R, 4C) quaternions
    pose_weights: jnp.ndarray  # (R, 4C)
    valid: jnp.ndarray  # (R,)


def proposal_target_layer(
    proposals: Proposals,
    gt_boxes: jnp.ndarray,  # (G, 5)
    gt_poses: jnp.ndarray,  # (G, 13) hough-format rows (quat at 6:10)
    gt_valid: jnp.ndarray,  # (G,)
    num_classes: int,
    rng: jax.Array,
    *,
    rois_per_image: int = 128,
    fg_fraction: float = 0.25,
    fg_thresh: float = 0.5,
    bg_thresh_hi: float = 0.5,
    bg_thresh_lo: float = 0.0,
    bbox_normalize_means=None,
    bbox_normalize_stds=None,
) -> ProposalTargets:
    """Sample RoIs + per-class box and quaternion targets
    (ref: proposal_target_layer.py:17-170, _compute_pose_targets :98)."""
    # include GT boxes as proposals (ref: cfg.TRAIN.USE_GT semantics)
    g = gt_boxes.shape[0]
    gt_rois = jnp.concatenate([jnp.zeros((g, 1)), gt_boxes[:, :4]], axis=1)
    all_rois = jnp.concatenate([proposals.rois, gt_rois], axis=0)
    all_valid = jnp.concatenate([proposals.valid, gt_valid], axis=0)
    n = all_rois.shape[0]

    ious = box_iou(all_rois[:, 1:5], gt_boxes[:, :4])
    ious = jnp.where(gt_valid[None, :], ious, -1.0)
    max_iou = ious.max(axis=1)
    gt_idx = ious.argmax(axis=1)
    gt_cls = gt_boxes[jnp.clip(gt_idx, 0, g - 1), 4].astype(jnp.int32)

    is_fg = all_valid & (max_iou >= fg_thresh)
    is_bg = all_valid & (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo)

    num_fg = int(fg_fraction * rois_per_image)
    r1, r2 = jax.random.split(rng)
    fg_key = jnp.where(is_fg, jax.random.uniform(r1, (n,)) + 1.0, 0.0)
    bg_key = jnp.where(is_bg, jax.random.uniform(r2, (n,)), -1.0)
    _, fg_sel = jax.lax.top_k(fg_key, num_fg)
    _, bg_sel = jax.lax.top_k(bg_key, rois_per_image - num_fg)
    sel = jnp.concatenate([fg_sel, bg_sel])
    sel_is_fg = jnp.concatenate(
        [is_fg[fg_sel], jnp.zeros((rois_per_image - num_fg,), bool)]
    )
    sel_valid = jnp.concatenate([is_fg[fg_sel], is_bg[bg_sel]])

    rois = all_rois[sel]
    labels = jnp.where(sel_is_fg, gt_cls[sel], 0)
    tgt4 = bbox_transform(rois[:, 1:5], gt_boxes[jnp.clip(gt_idx[sel], 0, g - 1), :4])
    if bbox_normalize_means is not None and bbox_normalize_stds is not None:
        # BBOX_NORMALIZE_TARGETS_PRECOMPUTED (ref config.py:188-199 and
        # proposal_target_layer.py _compute_targets): regression targets
        # standardized by precomputed means/stds; test-time decode must
        # un-normalize (cli/test_net detection branch)
        means = jnp.asarray(bbox_normalize_means, jnp.float32)[None, :]
        stds = jnp.asarray(bbox_normalize_stds, jnp.float32)[None, :]
        tgt4 = (tgt4 - means) / stds
    cols = 4 * labels[:, None] + jnp.arange(4)[None, :]
    r_idx = jnp.arange(rois_per_image)[:, None]
    bbox_targets = jnp.zeros((rois_per_image, 4 * num_classes)).at[r_idx, cols].set(
        tgt4 * sel_is_fg[:, None]
    )
    inside_w = jnp.zeros((rois_per_image, 4 * num_classes)).at[r_idx, cols].set(
        jnp.broadcast_to(sel_is_fg[:, None].astype(jnp.float32), (rois_per_image, 4))
    )
    quats = gt_poses[jnp.clip(gt_idx[sel], 0, g - 1), 6:10]
    pose_targets = jnp.zeros((rois_per_image, 4 * num_classes)).at[r_idx, cols].set(
        quats * sel_is_fg[:, None]
    )
    return ProposalTargets(
        rois=rois,
        labels=labels,
        bbox_targets=bbox_targets,
        bbox_inside_weights=inside_w,
        bbox_outside_weights=inside_w,
        pose_targets=pose_targets,
        pose_weights=inside_w,
        valid=sel_valid,
    )


def estimate_translation_from_box(
    quat: jnp.ndarray,  # (4,) wxyz detection quaternion
    box: jnp.ndarray,  # (4,) [x1, y1, x2, y2]
    points_cls: jnp.ndarray,  # (P, 3) class model points
    k: jnp.ndarray,  # (3, 3) intrinsics
    *,
    d_near: float = 0.1,
    d_far: float = 5.0,
    num_candidates: int = 64,
) -> jnp.ndarray:
    """Detection translation from box size (ref: compute_translations /
    distance_objective lib/fcn/test.py:1639-1692): t = center-ray × d
    where d minimizes the squared difference between the projected
    model bbox at depth d and the detected box.

    The reference runs scalar Nelder-Mead per detection; here a
    log-spaced candidate grid is evaluated in one batched projection
    and refined with a parabolic fit around the argmin — fully
    vectorized/jittable (vmap over detections).
    Returns (3,) translation.
    """
    from posecnn_tpu.utils.quaternion import quat_to_mat

    fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    x = 0.5 * (box[0] + box[2])
    y = 0.5 * (box[1] + box[3])
    width = box[2] - box[0]
    height = box[3] - box[1]
    rx = (x - px) / fx
    ry = (y - py) / fy

    r = quat_to_mat(quat)  # (3, 3)
    pr = points_cls @ r.T  # (P, 3) rotated once; translation varies below

    ds = jnp.exp(
        jnp.linspace(jnp.log(d_near), jnp.log(d_far), num_candidates)
    )  # (D,)
    tx = rx * ds
    ty = ry * ds
    # camera-frame points per candidate: (D, P, 3)
    pc = pr[None, :, :] + jnp.stack([tx, ty, ds], -1)[:, None, :]
    z = jnp.maximum(pc[..., 2], 1e-6)
    u = fx * pc[..., 0] / z + px
    v = fy * pc[..., 1] / z + py
    w_proj = u.max(-1) - u.min(-1)  # (D,)
    h_proj = v.max(-1) - v.min(-1)
    obj = (w_proj - width) ** 2 + (h_proj - height) ** 2  # (D,)

    i = jnp.clip(jnp.argmin(obj), 1, num_candidates - 2)
    # parabolic refine on (log d, obj) around the grid argmin
    l0, l1, l2 = (
        jnp.log(ds[i - 1]),
        jnp.log(ds[i]),
        jnp.log(ds[i + 1]),
    )
    f0, f1, f2 = obj[i - 1], obj[i], obj[i + 1]
    denom = (f0 - 2.0 * f1 + f2)
    step = jnp.where(
        jnp.abs(denom) > 1e-12, 0.5 * (f0 - f2) / denom * (l2 - l1), 0.0
    )
    d_star = jnp.exp(jnp.clip(l1 + step, jnp.log(d_near), jnp.log(d_far)))
    return jnp.stack([rx * d_star, ry * d_star, d_star])
