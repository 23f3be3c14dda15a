"""PoseCNN: the flagship 6D pose estimation network.

Plain-JAX re-design of `vgg16_convs`
(ref: lib/networks/vgg16_convs.py:79-212):

  trunk      VGG16 conv1_1..conv5_3                    (ref :80-97)
  seg head   two-scale skip: 1×1 score convs on conv4_3/conv5_3,
             ×2 bilinear up of the conv5 score, sum, dropout,
             ×8 bilinear up, 1×1 → C, log-softmax       (ref :128-146)
  vertex     same skip topology with 128 channels,
             1×1 → 3C linear output                     (ref :151-163)
  hough      ops.hough_voting on argmax labels          (ref :165-173)
  pose head  dual-scale RoI pool (1/16 + 1/8, summed) →
             fc6(4096) → fc7(4096) → fc8(4C) → tanh →
             weight-mask → L2-normalize per class       (ref :175-197)
  adapt      gradient reversal → fc9(256) → fc(2)       (ref :203-212)

Everything is static-shaped (fixed MAX-RoI buffers with validity
masks), bfloat16 compute / fp32 params, dropout as explicit rng, and
the pose head's 25088×4096 matmul is the natural tensor-parallel
sharding candidate (see parallel/mesh.py). Layers and the init/apply
entry points are in models/layers.py; the parameter tree has the
paths flax gave it (`params/VGG16Trunk_0/conv1_1/kernel`, …).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from posecnn_tpu.models.layers import Module, Scope, conv, dense, dropout
from posecnn_tpu.models.vgg16 import VGG16Trunk, bilinear_upsample
from posecnn_tpu.ops.hough_voting import (
    HoughOutputs,
    append_gt_rois,
    hough_voting,
)
from posecnn_tpu.ops.roi_align import roi_pool_fused
from posecnn_tpu.ops.gradient_reversal import gradient_reversal


class PoseCNNOutputs(NamedTuple):
    log_prob: jnp.ndarray  # (B, H, W, C) log-softmax seg scores
    prob: jnp.ndarray  # (B, H, W, C) softmax
    label_2d: jnp.ndarray  # (B, H, W) argmax labels
    vertex_pred: Optional[jnp.ndarray]  # (B, H, W, 3C)
    hough: Optional[HoughOutputs]
    poses_pred: Optional[jnp.ndarray]  # (R, 4C) masked unit quaternions
    poses_tanh: Optional[jnp.ndarray]  # (R, 4C) raw tanh output
    domain_logits: Optional[jnp.ndarray]  # (R, 2)


@dataclass(frozen=True)
class SkipHead(Module):
    """Two-scale FCN skip head (ref: vgg16_convs.py:128-141,151-163)."""

    units: int
    out_channels: int
    relu_scores: bool = True
    name_prefix: str = "score"
    compute_dtype: Any = jnp.bfloat16
    # return the 1/8-resolution map BEFORE the frozen ×8 bilinear
    # upsample (parameters are identical either way; the caller decides
    # whether full resolution is ever materialized)
    return_lowres: bool = False

    def __call__(self, scope: Scope, conv4_3, conv5_3, *, train: bool, dropout_rng=None, keep_prob=1.0):
        act = jax.nn.relu if self.relu_scores else (lambda v: v)
        dt = self.compute_dtype
        s5 = act(conv(scope.child(f"{self.name_prefix}_conv5"), conv5_3, self.units, 1, dt))
        s5_up = bilinear_upsample(s5, 2)
        s4 = act(conv(scope.child(f"{self.name_prefix}_conv4"), conv4_3, self.units, 1, dt))
        # crop to the 1/8 map when H/8 or W/8 is odd (the reference
        # pads inputs to ×16 instead — utils/blob.py pad_im(·,16))
        s5_up = s5_up[:, : s4.shape[1], : s4.shape[2], :]
        added = s4 + s5_up
        if train:
            added = dropout(added, keep_prob, dropout_rng)
        # the reference orders upsample→1×1 conv (vgg16_convs.py:138-141);
        # a 1×1 conv is pointwise-linear and bilinear upsampling is
        # spatially-linear, so they commute EXACTLY — conv first at 1/8
        # resolution, then upsample out_channels instead of `units`
        # channels: ~2× less memory traffic for the 128-ch vertex head
        out = conv(scope.child(f"{self.name_prefix}_out"), added, self.out_channels, 1, dt)
        if self.return_lowres:
            return out
        return bilinear_upsample(out, 8)


@dataclass(frozen=True)
class PoseHead(Module):
    """RoI → quaternion regression head (ref: vgg16_convs.py:175-197)."""

    num_classes: int
    fc_dim: int = 4096  # reference fc6/fc7 width (vgg16_convs.py:188-191)
    compute_dtype: Any = jnp.bfloat16
    # RMS-normalize the flattened pooled features before fc6.
    # Deliberate deviation from the reference: its fc6/fc7 are
    # warm-started from ImageNet VGG weights whose activation scales
    # were tamed by pretraining (ref: lib/networks/network.py:71-107
    # loads vgg16.npy incl. fc6/fc7); no such weights exist in this
    # environment, and with random init the raw pooled conv4+conv5
    # features (std ~50-100 off a mean-subtracted ±100 input) drive
    # fc8 preactivations hundreds deep into tanh saturation — the
    # fp32 gradient is EXACTLY zero and the quaternion branch cannot
    # train at all (r5 single-batch overfit probe: tanh|.|=1.000,
    # g_pose=0.000 at init; the root cause of rotation-at-chance in
    # rounds 2-4). Per-row RMS normalization bounds the fc stack's
    # input scale so tanh starts in its linear regime.
    norm_features: bool = True
    # Quaternion output activation. The reference applies tanh before
    # the weight-mask + L2-normalize (vgg16_convs.py:195-197). Under
    # the ADD loss only the DIRECTION of the 4-vector matters (the
    # normalize divides magnitude out), so nothing in the loss stops
    # |fc8| from growing — and with tanh, unbounded growth means
    # saturation and an EXACTLY-zero fp32 gradient. From random init
    # this is an attractor: the r5 overfit probe hit tanh|.|=1.000 /
    # g_pose=0.000 within 50 iters at every lr/optimizer tried, which
    # is the root cause of rotation never training in rounds 2-4 (the
    # reference escapes it only because its warm-started weights keep
    # preactivations tame). "linear" (default) drops the redundant
    # squash: normalize(masked(x)) has a well-conditioned gradient at
    # every magnitude. "tanh" preserves reference behavior for parity.
    quat_activation: str = "linear"

    def __call__(self, scope: Scope, pooled, poses_weight, *, train: bool, dropout_rng=None, keep_prob=1.0):
        x = pooled.reshape(pooled.shape[0], -1).astype(jnp.float32)
        if self.norm_features:
            x = x * jax.lax.rsqrt(jnp.mean(x * x, axis=1, keepdims=True) + 1e-6)
        x = x.astype(self.compute_dtype)
        rngs = (
            jax.random.split(dropout_rng, 2) if dropout_rng is not None else (None, None)
        )
        x = jax.nn.relu(dense(scope.child("fc6"), x, self.fc_dim, self.compute_dtype))
        if train:
            x = dropout(x, keep_prob, rngs[0])
        x = jax.nn.relu(dense(scope.child("fc7"), x, self.fc_dim, self.compute_dtype))
        if train:
            x = dropout(x, keep_prob, rngs[1])
        x = dense(scope.child("fc8"), x, 4 * self.num_classes, jnp.float32)
        poses_tanh = jnp.tanh(x) if self.quat_activation == "tanh" else x
        # mask to the matched class, L2-normalize over the 4 channels
        # (ref: vgg16_convs.py:195-197 multiply + l2_normalize(dim=1);
        # TF normalizes over the whole 4C row — only 4 entries are
        # nonzero after the weight mask, so per-row == per-quaternion)
        masked = poses_tanh * poses_weight
        # eps inside the sqrt: unmatched RoIs have an all-zero masked
        # row, and d‖x‖/dx at 0 is NaN — sqrt(Σx²+ε) keeps the
        # gradient finite (and 0) there. The denominator floor bounds
        # the 1/‖x‖ gradient amplification of the normalize to ≤100×:
        # with the linear head a weighted row can pass arbitrarily
        # close to zero magnitude mid-training, and the unbounded
        # spike NaN'd the r5 probe within 40 iters (tanh used to
        # hide this by clamping outputs; see quat_activation note)
        norm = jnp.sqrt(jnp.sum(masked * masked, axis=1, keepdims=True) + 1e-12)
        poses_pred = masked / jnp.maximum(norm, 1e-2)
        return poses_pred, poses_tanh


@dataclass(frozen=True)
class DomainHead(Module):
    """Domain-adaptation classifier behind gradient reversal
    (ref: vgg16_convs.py:203-212)."""

    lambda_: float = 0.01
    compute_dtype: Any = jnp.bfloat16

    def __call__(self, scope: Scope, pooled, *, train: bool, dropout_rng=None, keep_prob=1.0):
        x = pooled.reshape(pooled.shape[0], -1)
        x = gradient_reversal(x, self.lambda_)
        x = jax.nn.relu(dense(scope.child("fc9"), x, 256, self.compute_dtype))
        if train:
            x = dropout(x, keep_prob, dropout_rng)
        return dense(scope.child("domain_score"), x, 2, jnp.float32)


@dataclass(frozen=True)
class PoseCNN(Module):
    """Full PoseCNN graph. Call with images and (in training) GT poses.

    Attributes mirror the reference constructor flags
    (ref: vgg16_convs.py:5-29).
    """

    num_classes: int
    num_units: int = 64
    fc_dim: int = 4096
    vertex_reg: bool = True
    pose_reg: bool = True
    adaptation: bool = False
    input_format: str = "COLOR"  # COLOR | RGBD (dual tower)
    threshold_label: float = 1.0
    vote_threshold: float = -1.0
    vote_percentage: float = 0.02
    skip_pixels: int = 10
    hough_num_samples: int = 256
    max_objects: int = 16
    hough_cell_stride: int = 1
    # static pose-head row budget: when >0 and the Hough output has
    # more rows, the top-`max_pose_rois` rows by validity (stable
    # order) are gathered BEFORE RoI pooling, so the fc6/fc7 matmuls
    # and the pooled-feature interpolation run on a compact buffer
    # instead of the padded B·M·9 rows (typically <50% valid). Shapes
    # stay static; excess VALID rows beyond the budget are dropped
    # votes-order — the same truncation the reference's MAX_ROI=128
    # emission cap applies (hough_voting_gpu_op.cc:32). 0 = off.
    max_pose_rois: int = 0
    # prepend one exact GT RoI row per object during training (dense
    # pose-head supervision from iter 0; ops/hough_voting.append_gt_rois)
    gt_pose_rois: bool = False
    # RoI pooling grid for the pose head. The reference pools 7×7
    # (vgg16_convs.py:177-183); over a 1/16-res conv5 map of a 160-px
    # training canvas that is ~1.4 feature texels per bin — a candidate
    # bottleneck for rotation observability (r4 verdict task 3a). 14
    # doubles the angular resolution of the pooled signal at 4× fc6
    # input width.
    pose_pool_size: int = 7
    # pose-head forward-pass semantics (see PoseHead for the full
    # rationale). Threaded here + TrainConfig (+ snapshot metadata,
    # core/checkpoint.py) because both change the computation WITHOUT
    # changing parameter shapes: a checkpoint trained under one
    # setting loads silently under another and evaluates wrong —
    # eval/serve adopt the flags recorded in the checkpoint.
    norm_features: bool = True
    quat_activation: str = "linear"  # "linear" | "tanh" (reference parity)
    compute_dtype: Any = jnp.bfloat16

    def __call__(
        self,
        scope: Scope,
        data: jnp.ndarray,  # (B, H, W, 3) mean-subtracted BGR
        extents: jnp.ndarray,  # (C, 3)
        meta_data: jnp.ndarray,  # (B, 48)
        gt_poses: Optional[jnp.ndarray] = None,  # (G, 13)
        gt_valid: Optional[jnp.ndarray] = None,  # (G,)
        data_p: Optional[jnp.ndarray] = None,  # (B, H, W, 3) depth tower input
        *,
        train: bool = False,
        keep_prob: float = 1.0,
        dropout_rng: Optional[jax.Array] = None,
    ) -> PoseCNNOutputs:
        trunk = VGG16Trunk(compute_dtype=self.compute_dtype)
        trunk_scope = scope.child("VGG16Trunk_0")
        conv4_3, conv5_3 = trunk(trunk_scope, data)
        if self.input_format == "RGBD":
            if data_p is None:
                raise ValueError("RGBD input_format requires data_p")
            # shared-weight second tower (ref: vgg16_convs.py:99-126;
            # weight sharing via scope reuse replaces `_p` aliasing)
            conv4_3_p, conv5_3_p = trunk(trunk_scope, data_p)
            conv4_3 = jnp.concatenate([conv4_3, conv4_3_p], axis=-1)
            conv5_3 = jnp.concatenate([conv5_3, conv5_3_p], axis=-1)

        rngs = (
            jax.random.split(dropout_rng, 4) if dropout_rng is not None else [None] * 4
        )

        # semantic labeling head (ref :128-146)
        score = SkipHead(
            self.num_units,
            self.num_classes,
            relu_scores=True,
            name_prefix="score",
            compute_dtype=self.compute_dtype,
        )(scope.child("seg_head"), conv4_3, conv5_3, train=train, dropout_rng=rngs[0], keep_prob=keep_prob)
        score = score.astype(jnp.float32)
        log_prob = jax.nn.log_softmax(score, axis=-1)
        prob = jax.nn.softmax(score, axis=-1)
        label_2d = jnp.argmax(score, axis=-1).astype(jnp.int32)

        vertex_pred = None
        hough = None
        poses_pred = None
        poses_tanh = None
        domain_logits = None

        if self.vertex_reg:
            # center-direction regression head (ref :151-163). Hough
            # samples the 1/8-res map with the frozen upsample's own
            # bilinear weights (ops/hough_voting vertex_factor) —
            # exactly equal to sampling the upsampled map, but the
            # (H, W, 3C) full-res tensor is only materialized by
            # graphs that consume `vertex_pred` (the training vertex
            # loss, eval vertmap export), never by the serving path.
            vertex_lr = SkipHead(
                128,
                3 * self.num_classes,
                relu_scores=False,
                name_prefix="vertex",
                compute_dtype=self.compute_dtype,
                return_lowres=True,
            )(scope.child("vertex_head"), conv4_3, conv5_3, train=train, dropout_rng=rngs[1], keep_prob=keep_prob)
            vertex_lr = vertex_lr.astype(jnp.float32)
            vertex_pred = bilinear_upsample(vertex_lr, 8)

            hough = hough_voting(
                label_2d,
                vertex_lr,
                extents,
                meta_data,
                gt_poses,
                gt_valid,
                vertex_factor=8,
                is_train=train,
                vote_threshold=self.vote_threshold,
                vote_percentage=self.vote_percentage,
                skip_pixels=self.skip_pixels,
                num_samples=self.hough_num_samples,
                max_objects_per_image=self.max_objects,
                cell_stride=self.hough_cell_stride,
            )

            if self.pose_reg:
                if train and self.gt_pose_rois and gt_poses is not None:
                    hough = append_gt_rois(
                        hough, gt_poses, gt_valid, extents, meta_data,
                        self.num_classes,
                    )
                if 0 < self.max_pose_rois < hough.rois.shape[0]:
                    # compact to the static budget: valid rows first
                    # (argsort of ~valid is stable → original Hough
                    # emission order preserved within each group)
                    order = jnp.argsort(~hough.valid)[: self.max_pose_rois]
                    hough = HoughOutputs(
                        rois=hough.rois[order],
                        poses_init=hough.poses_init[order],
                        poses_target=hough.poses_target[order],
                        poses_weight=hough.poses_weight[order],
                        domains=hough.domains[order],
                        valid=hough.valid[order],
                    )
                pooled = roi_pool_fused(
                    conv4_3, conv5_3, hough.rois,
                    pooled_size=self.pose_pool_size,
                )
                pose_weight = hough.poses_weight if train else _eval_pose_weight(
                    hough, self.num_classes
                )
                poses_pred, poses_tanh = PoseHead(
                    self.num_classes,
                    fc_dim=self.fc_dim,
                    compute_dtype=self.compute_dtype,
                    norm_features=self.norm_features,
                    quat_activation=self.quat_activation,
                )(scope.child("pose_head"), pooled, pose_weight, train=train, dropout_rng=rngs[2], keep_prob=keep_prob)

                if self.adaptation:
                    domain_logits = DomainHead()(
                        scope.child("domain_head"), pooled, train=train, dropout_rng=rngs[3], keep_prob=keep_prob
                    )

        return PoseCNNOutputs(
            log_prob=log_prob,
            prob=prob,
            label_2d=label_2d,
            vertex_pred=vertex_pred,
            hough=hough,
            poses_pred=poses_pred,
            poses_tanh=poses_tanh,
            domain_logits=domain_logits,
        )


def _eval_pose_weight(hough: HoughOutputs, num_classes: int) -> jnp.ndarray:
    """At test time the quaternion is read out of the RoI's own class
    slot (ref: lib/fcn/test.py:206-211 builds poses from the per-class
    fc8 output); emulate the weight mask with the hough class."""
    r = hough.rois.shape[0]
    cls = jnp.clip(hough.rois[:, 1].astype(jnp.int32), 0, num_classes - 1)
    col = 4 * cls[:, None] + jnp.arange(4)[None, :]
    w = jnp.zeros((r, 4 * num_classes), jnp.float32)
    return w.at[jnp.arange(r)[:, None], col].set(1.0)
