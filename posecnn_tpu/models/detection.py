"""Faster-RCNN-style detection + pose variant of PoseCNN.

Parity target: the reference's `vgg16_det`
(ref: lib/networks/vgg16_det.py:50-166): VGG trunk → 3×3/512 RPN conv
→ 1×1 cls (2A) + 1×1 bbox (4A) heads → proposals → RoI pooling on
conv5_3 → fc6/fc7 → per-class cls score, box deltas and quaternion
regression. Trained by train_net_det (ref: lib/fcn/train.py:593-653).

Design: the reference's tf.py_func anchor/proposal target layers
(host round trips each step) are the pure-JAX ops in ops/rpn.py; the
whole train graph jits.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from posecnn_tpu.models.vgg16_flax import VGG16Trunk
from posecnn_tpu.ops.roi_align import roi_align
from posecnn_tpu.ops.rpn import (
    AnchorTargets,
    ProposalTargets,
    Proposals,
    anchor_grid,
    anchor_target_layer,
    generate_anchors,
    proposal_layer,
    proposal_target_layer,
)


class DetectionOutputs(NamedTuple):
    rpn_cls_logits: jnp.ndarray  # (B, h, w, 2A)
    rpn_bbox_pred: jnp.ndarray  # (B, h, w, 4A)
    proposals: Proposals
    cls_logits: jnp.ndarray  # (R, C)
    bbox_pred: jnp.ndarray  # (R, 4C)
    poses_pred: jnp.ndarray  # (R, 4C) tanh quaternions
    anchor_targets: Optional[AnchorTargets]
    proposal_targets: Optional[ProposalTargets]


class PoseCNNDet(nn.Module):
    num_classes: int
    anchor_scales: tuple = (8, 16, 32)
    anchor_ratios: tuple = (0.5, 1.0, 2.0)
    feature_stride: int = 16
    fc_dim: int = 4096
    post_nms_topk: int = 128  # proposal slots = RoI budget (static shapes)
    # RPN proposal knobs (ref: config.py:171-177 / 225-231)
    pre_nms_topk: int = 2000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 16.0
    # anchor-target knobs (ref: config.py:156-168)
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    rpn_clobber_positives: bool = False
    rpn_batchsize: int = 256
    rpn_fg_fraction: float = 0.5
    # RoI-sampling knobs (ref: config.py:138-149)
    rois_per_image: int = 0  # TRAIN.BATCH_SIZE (ref :138); 0 = post_nms_topk
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.1  # RoI-sampling BG IoU floor (ref: config.py:149)
    # bbox-target standardization (ref: config.py:188-199); None = off
    bbox_normalize_means: Optional[tuple] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Optional[tuple] = (0.1, 0.1, 0.2, 0.2)
    compute_dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(
        self,
        data: jnp.ndarray,  # (1, H, W, 3) — per-image graph like the ref
        gt_boxes: Optional[jnp.ndarray] = None,  # (G, 5)
        gt_poses: Optional[jnp.ndarray] = None,  # (G, 13)
        gt_valid: Optional[jnp.ndarray] = None,
        *,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> DetectionOutputs:
        b, im_h, im_w, _ = data.shape
        conv4_3, conv5_3 = VGG16Trunk(compute_dtype=self.compute_dtype, name="trunk")(data)
        a = len(self.anchor_scales) * len(self.anchor_ratios)

        rpn = nn.relu(
            nn.Conv(512, (3, 3), padding="SAME", dtype=self.compute_dtype,
                    param_dtype=jnp.float32, name="rpn_conv")(conv5_3)
        )
        rpn_cls = nn.Conv(2 * a, (1, 1), dtype=jnp.float32, param_dtype=jnp.float32,
                          name="rpn_cls_score")(rpn)
        rpn_bbox = nn.Conv(4 * a, (1, 1), dtype=jnp.float32, param_dtype=jnp.float32,
                           name="rpn_bbox_pred")(rpn)

        h, w = rpn_cls.shape[1], rpn_cls.shape[2]
        base = generate_anchors(self.feature_stride, self.anchor_ratios, self.anchor_scales)
        anchors = jnp.asarray(anchor_grid(h, w, self.feature_stride, base))

        # softmax over the (bg, fg) pair per anchor (ref layout)
        cls_resh = rpn_cls.reshape(b, h, w, 2, a)
        cls_prob = jax.nn.softmax(cls_resh, axis=3).reshape(b, h, w, 2 * a)

        proposals = proposal_layer(
            cls_prob[0], rpn_bbox[0], anchors, im_h, im_w,
            pre_nms_topk=self.pre_nms_topk,
            post_nms_topk=self.post_nms_topk,
            nms_threshold=self.rpn_nms_thresh,
            min_size=self.rpn_min_size,
        )

        anchor_targets = None
        proposal_targets = None
        rois = proposals.rois
        if train:
            if gt_boxes is None or rng is None:
                raise ValueError("train mode needs gt_boxes and rng")
            r1, r2 = jax.random.split(rng)
            anchor_targets = anchor_target_layer(
                anchors, gt_boxes, gt_valid, im_h, im_w, r1,
                positive_overlap=self.rpn_positive_overlap,
                negative_overlap=self.rpn_negative_overlap,
                batch_size=self.rpn_batchsize,
                fg_fraction=self.rpn_fg_fraction,
                clobber_positives=self.rpn_clobber_positives,
            )
            proposal_targets = proposal_target_layer(
                proposals, gt_boxes, gt_poses, gt_valid, self.num_classes, r2,
                rois_per_image=self.rois_per_image or self.post_nms_topk,
                fg_fraction=self.fg_fraction,
                fg_thresh=self.fg_thresh,
                bg_thresh_hi=self.bg_thresh_hi,
                bg_thresh_lo=self.bg_thresh_lo,
                bbox_normalize_means=self.bbox_normalize_means,
                bbox_normalize_stds=self.bbox_normalize_stds,
            )
            rois = proposal_targets.rois

        # RoI head on conv5_3 (1/16) — 7-col roi format for roi_align
        rois7 = jnp.concatenate(
            [rois[:, :1], jnp.zeros((rois.shape[0], 1)), rois[:, 1:5],
             jnp.ones((rois.shape[0], 1))], axis=1
        )
        pooled = roi_align(conv5_3, rois7, pooled_size=7, spatial_scale=1.0 / self.feature_stride)
        x = pooled.reshape(pooled.shape[0], -1).astype(self.compute_dtype)
        x = nn.relu(nn.Dense(self.fc_dim, dtype=self.compute_dtype, param_dtype=jnp.float32, name="fc6")(x))
        x = nn.relu(nn.Dense(self.fc_dim, dtype=self.compute_dtype, param_dtype=jnp.float32, name="fc7")(x))
        cls_logits = nn.Dense(self.num_classes, dtype=jnp.float32, param_dtype=jnp.float32, name="cls_score")(x)
        bbox_pred = nn.Dense(4 * self.num_classes, dtype=jnp.float32, param_dtype=jnp.float32, name="bbox_pred")(x)
        poses_pred = jnp.tanh(
            nn.Dense(4 * self.num_classes, dtype=jnp.float32, param_dtype=jnp.float32, name="pose_pred")(x)
        )

        return DetectionOutputs(
            rpn_cls_logits=rpn_cls,
            rpn_bbox_pred=rpn_bbox,
            proposals=proposals,
            cls_logits=cls_logits,
            bbox_pred=bbox_pred,
            poses_pred=poses_pred,
            anchor_targets=anchor_targets,
            proposal_targets=proposal_targets,
        )


def detection_losses(
    out: DetectionOutputs,
    num_classes: int,
    points: Optional[jnp.ndarray] = None,
    symmetry: Optional[jnp.ndarray] = None,
) -> dict:
    """train_net_det loss assembly (ref: lib/fcn/train.py:593-653):
    RPN CE + RPN smooth-L1 + RCNN CE + RCNN smooth-L1 + ADD pose loss
    (the reference's 'loss_pose' graph output, vgg16_det.py:157-166 —
    emitted when points/symmetry are provided)."""
    from posecnn_tpu.ops.losses import smooth_l1_loss

    at = out.anchor_targets
    pt = out.proposal_targets
    a2 = out.rpn_cls_logits.shape[-1] // 2
    logits = out.rpn_cls_logits.reshape(-1, 2, a2)
    logits = jnp.moveaxis(logits, 1, -1).reshape(-1, 2)
    labels = at.labels
    mask = labels >= 0
    log_p = jax.nn.log_softmax(logits, axis=-1)
    picked = jnp.take_along_axis(log_p, jnp.clip(labels, 0, 1)[:, None], axis=1)[:, 0]
    rpn_cls_loss = -jnp.sum(picked * mask) / jnp.maximum(jnp.sum(mask), 1)

    # SUM over anchors, mean over the (single-image) batch — the
    # reference's dim=[1,2,3] on (1,h,w,4A) (train.py:612); the
    # outside weights already carry 1/num_examples, so dividing by
    # h·w·A here would shrink the gradient ~4 orders of magnitude
    rpn_box_loss = smooth_l1_loss(
        out.rpn_bbox_pred.reshape(1, -1),
        at.bbox_targets.reshape(1, -1),
        at.bbox_inside_weights.reshape(1, -1),
        at.bbox_outside_weights.reshape(1, -1),
        sigma=3.0,
    )

    log_pc = jax.nn.log_softmax(out.cls_logits, axis=-1)
    picked_c = jnp.take_along_axis(log_pc, pt.labels[:, None], axis=1)[:, 0]
    vmask = pt.valid.astype(jnp.float32)
    rcnn_cls_loss = -jnp.sum(picked_c * vmask) / jnp.maximum(jnp.sum(vmask), 1)

    rcnn_box_loss = smooth_l1_loss(
        out.bbox_pred, pt.bbox_targets, pt.bbox_inside_weights, pt.bbox_outside_weights
    )
    total = rpn_cls_loss + rpn_box_loss + rcnn_cls_loss + rcnn_box_loss
    metrics = {
        "rpn_cls": rpn_cls_loss,
        "rpn_box": rpn_box_loss,
        "rcnn_cls": rcnn_cls_loss,
        "rcnn_box": rcnn_box_loss,
    }
    if points is not None and symmetry is not None:
        from posecnn_tpu.ops.add_loss import average_distance_loss

        # mask + L2-normalize the tanh quaternions per RoI (ref:
        # vgg16_det.py:161-163 poses_mul → l2_normalize), then ADD loss
        masked = out.poses_pred * pt.pose_weights
        norm = jnp.sqrt(jnp.sum(masked * masked, axis=1, keepdims=True) + 1e-12)
        pose_loss = average_distance_loss(
            masked / norm, pt.pose_targets, pt.pose_weights, points, symmetry,
            num_valid=jnp.sum(pt.valid.astype(jnp.float32)),
        )
        metrics["loss_pose"] = pose_loss
        total = total + pose_loss
    metrics["loss"] = total
    return metrics
