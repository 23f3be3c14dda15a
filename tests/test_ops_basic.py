"""Tests for hard_label, losses, gradient_reversal, nms, roi_align
against independent NumPy references (reference semantics documented in
each op's docstring)."""

import jax
import jax.numpy as jnp
import numpy as np

from posecnn_tpu.ops.hard_label import hard_label
from posecnn_tpu.ops.losses import (
    loss_cross_entropy_single_frame,
    loss_quaternion,
    smooth_l1_loss_vertex,
)
from posecnn_tpu.ops.gradient_reversal import gradient_reversal
from posecnn_tpu.ops.nms import nms
from posecnn_tpu.ops.roi_align import roi_align


def np_hard_label(prob, gt, threshold):
    """NumPy mirror of hard_label_op.cc:97-112."""
    b, h, w, c = prob.shape
    out = np.zeros_like(prob)
    for n in range(b):
        for i in range(h):
            for j in range(w):
                g = gt[n, i, j]
                if g != -1 and (g > 0 or prob[n, i, j, g] < threshold):
                    out[n, i, j, g] = 1.0
    return out


def test_hard_label_matches_reference(rng):
    prob = rng.rand(2, 6, 7, 4).astype(np.float32)
    prob /= prob.sum(-1, keepdims=True)
    gt = rng.randint(-1, 4, size=(2, 6, 7)).astype(np.int32)
    out = np.asarray(hard_label(jnp.asarray(prob), jnp.asarray(gt), 0.6))
    np.testing.assert_allclose(out, np_hard_label(prob, gt, 0.6), atol=1e-6)


def test_cross_entropy_normalized(rng):
    logits = rng.randn(2, 4, 4, 5).astype(np.float32)
    log_prob = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    labels = np.zeros((2, 4, 4, 5), np.float32)
    idx = rng.randint(0, 5, (2, 4, 4))
    for n in range(2):
        for i in range(4):
            for j in range(4):
                labels[n, i, j, idx[n, i, j]] = 1.0
    loss = float(loss_cross_entropy_single_frame(jnp.asarray(log_prob), jnp.asarray(labels)))
    expect = -(labels * log_prob).sum() / labels.sum()
    np.testing.assert_allclose(loss, expect, rtol=1e-5)


def test_smooth_l1_vertex_quadratic_and_linear_regions():
    # weight inside the huber (ref train.py:565-574): w·d = 0.5 (quad), 2 (lin)
    pred = jnp.asarray([[0.5, 2.0]])
    target = jnp.zeros((1, 2))
    w = jnp.ones((1, 2))
    loss = float(smooth_l1_loss_vertex(pred, target, w))
    expect = (0.5 * 0.5**2 + (2.0 - 0.5)) / 2.0
    np.testing.assert_allclose(loss, expect, rtol=1e-6)


def test_loss_quaternion_zero_for_identical():
    q = jnp.asarray([[1.0, 0, 0, 0, 0, 0, 0, 0]])
    w = jnp.asarray([[1.0, 1, 1, 1, 0, 0, 0, 0]])
    loss = float(loss_quaternion(q, q, w))
    np.testing.assert_allclose(loss, 0.0, atol=1e-6)


def test_gradient_reversal():
    f = lambda x: jnp.sum(gradient_reversal(x, 0.01) * 3.0)
    g = jax.grad(f)(jnp.ones((4,)))
    np.testing.assert_allclose(np.asarray(g), -0.01 * 3.0 * np.ones(4), rtol=1e-6)
    # forward is identity
    np.testing.assert_allclose(
        np.asarray(gradient_reversal(jnp.arange(4.0), 0.5)), np.arange(4.0)
    )


def np_nms(dets, thresh):
    """NumPy mirror of lib/utils/nms.py py_cpu_nms."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return sorted(keep)


def test_nms_matches_python_reference(rng):
    n = 40
    boxes = np.zeros((n, 4), np.float32)
    boxes[:, 0] = rng.rand(n) * 100
    boxes[:, 1] = rng.rand(n) * 100
    boxes[:, 2] = boxes[:, 0] + rng.rand(n) * 50 + 5
    boxes[:, 3] = boxes[:, 1] + rng.rand(n) * 50 + 5
    scores = rng.rand(n).astype(np.float32)
    keep_mask = np.asarray(nms(jnp.asarray(boxes), jnp.asarray(scores), 0.4))
    ref_keep = np_nms(np.concatenate([boxes, scores[:, None]], 1), 0.4)
    assert sorted(np.where(keep_mask)[0].tolist()) == ref_keep


def test_roi_align_constant_map():
    # a constant feature map must pool to the constant
    feat = jnp.ones((1, 16, 16, 3)) * 5.0
    rois = jnp.asarray([[0, 1, 8.0, 8.0, 64.0, 64.0, 1.0]])  # image coords, 1/8 scale
    out = roi_align(feat, rois, pooled_size=7, spatial_scale=1.0 / 8.0)
    assert out.shape == (1, 7, 7, 3)
    np.testing.assert_allclose(np.asarray(out), 5.0, atol=1e-5)


def test_roi_align_gradient_flows():
    feat = jnp.ones((1, 16, 16, 1))
    rois = jnp.asarray([[0, 1, 0.0, 0.0, 120.0, 120.0, 1.0]])

    def f(x):
        return jnp.sum(roi_align(x, rois, pooled_size=7, spatial_scale=1.0 / 8.0))

    g = jax.grad(f)(feat)
    assert float(jnp.sum(jnp.abs(g))) > 0


def test_roi_align_linear_ramp():
    # bilinear sampling of a linear ramp reproduces the ramp exactly
    h = w = 16
    ramp = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))[None, :, :, None]
    rois = jnp.asarray([[0, 1, 16.0, 16.0, 112.0, 112.0, 1.0]])  # 1/8 scale → [2,14]
    out = roi_align(ramp, rois, pooled_size=4, spatial_scale=1.0 / 8.0, samples_per_bin=2)
    vals = np.asarray(out)[0, 0, :, 0]
    # max of samples within each bin: bins of width 3 px starting at x=2
    # samples at +0.75, +2.25 within the bin → max at 2 + 3k + 2.25
    expect = 2 + 3 * np.arange(4) + 2.25
    np.testing.assert_allclose(vals, expect, atol=1e-5)


def test_roi_align_mxu_matches_gather():
    """The interpolation-matmul formulation must agree with the
    gather formulation exactly — forward and backward — including
    multi-batch RoIs and out-of-range coordinate clamping."""
    from posecnn_tpu.ops.roi_align import roi_align_mxu

    rng = np.random.RandomState(3)
    feats = jnp.asarray(rng.randn(2, 30, 40, 8).astype(np.float32))
    r = 7
    rois = np.zeros((r, 7), np.float32)
    rois[:, 0] = rng.randint(0, 2, r)
    x1 = rng.uniform(-20, 560, r)
    y1 = rng.uniform(-20, 420, r)
    rois[:, 2], rois[:, 3] = x1, y1
    rois[:, 4] = x1 + rng.uniform(4, 160, r)
    rois[:, 5] = y1 + rng.uniform(4, 140, r)
    rois = jnp.asarray(rois)

    for scale in (1 / 16.0, 1 / 8.0):
        a = roi_align(feats, rois, spatial_scale=scale)
        b = roi_align_mxu(feats, rois, spatial_scale=scale)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

    ga = jax.grad(lambda f: jnp.sum(roi_align(f, rois) ** 2))(feats)
    gb = jax.grad(lambda f: jnp.sum(roi_align_mxu(f, rois) ** 2))(feats)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), atol=1e-4)
