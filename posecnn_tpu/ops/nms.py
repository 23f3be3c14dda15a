"""Non-maximum suppression, jittable with fixed shapes.

Replaces both the pure-python NMS (ref: lib/utils/nms.py:3, used by
the test path at lib/fcn/test.py:198) and the CUDA bitmask NMS
(ref: lib/nms/nms_kernel.cu). Design: the sequential
greedy scan becomes a `lax.scan` over score-sorted boxes with a
running suppression mask — O(N²) IoU computed once as a dense matrix
(elementwise), then a linear scan of N steps. No dynamic output
size: returns a keep mask aligned with the input order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from posecnn_tpu.utils.bbox import box_iou


def nms(boxes: jnp.ndarray, scores: jnp.ndarray, threshold: float, valid=None):
    """boxes: (N, 4) xyxy; scores: (N,). Returns bool keep mask (N,).

    Matches the reference's greedy descending-score suppression with
    the +1 area convention (lib/utils/nms.py).
    """
    n = boxes.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    order = jnp.argsort(-jnp.where(valid, scores, -jnp.inf))
    sorted_boxes = boxes[order]
    sorted_valid = valid[order]
    iou = box_iou(sorted_boxes, sorted_boxes)  # (N, N)

    def step(suppressed, i):
        alive = ~suppressed[i] & sorted_valid[i]
        kill = alive & (iou[i] > threshold) & (jnp.arange(n) > i)
        return suppressed | kill, alive

    suppressed, kept_sorted = jax.lax.scan(step, jnp.zeros((n,), bool), jnp.arange(n))
    keep = jnp.zeros((n,), bool).at[order].set(kept_sorted & sorted_valid)
    return keep


def nms_per_class(rois: jnp.ndarray, threshold: float, valid=None):
    """NMS over hough-format rois (R, 7), suppressing only within the
    same (batch, class) pair — the test path applies NMS per frame on
    the hough rois (ref: lib/fcn/test.py:198)."""
    boxes = rois[:, 2:6]
    scores = rois[:, 6]
    n = rois.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    order = jnp.argsort(-jnp.where(valid, scores, -jnp.inf))
    sb = boxes[order]
    sv = valid[order]
    skey = (rois[order, 0].astype(jnp.int32), rois[order, 1].astype(jnp.int32))
    iou = box_iou(sb, sb)
    same = (skey[0][:, None] == skey[0][None, :]) & (skey[1][:, None] == skey[1][None, :])

    def step(suppressed, i):
        alive = ~suppressed[i] & sv[i]
        kill = alive & same[i] & (iou[i] > threshold) & (jnp.arange(n) > i)
        return suppressed | kill, alive

    suppressed, kept_sorted = jax.lax.scan(step, jnp.zeros((n,), bool), jnp.arange(n))
    keep = jnp.zeros((n,), bool).at[order].set(kept_sorted & sv)
    return keep
