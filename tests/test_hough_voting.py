"""Hough voting op: synthetic-scene recovery tests.

We render an analytic scene — a rectangular object mask whose vertex
field points exactly at a chosen center with a known depth — and check
that the op recovers the center, depth, class, and initial translation
(the backprojected ray × depth, ref: hough_voting_gpu_op.cu.cc:400-431),
plus the GT-matching path in training mode.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from posecnn_tpu.ops.hough_voting import hough_voting

H, W = 120, 160
FX = FY = 200.0
PX, PY = W / 2.0, H / 2.0
NUM_CLASSES = 4


def make_meta():
    meta = np.zeros(48, np.float32)
    k = np.array([[FX, 0, PX], [0, FY, PY], [0, 0, 1]], np.float32)
    meta[0:9] = k.flatten()
    meta[9:18] = np.linalg.inv(k).flatten()
    return meta


def make_scene(objects):
    """objects: list of (cls, cx, cy, depth, half_w, half_h)."""
    label = np.zeros((H, W), np.int32)
    vert = np.zeros((H, W, 3 * NUM_CLASSES), np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for cls, cx, cy, depth, hw, hh in objects:
        mask = (np.abs(xs - cx) <= hw) & (np.abs(ys - cy) <= hh)
        dx = cx - xs
        dy = cy - ys
        n = np.sqrt(dx * dx + dy * dy) + 1e-10
        label[mask] = cls
        vert[mask, 3 * cls + 0] = (dx / n)[mask]
        vert[mask, 3 * cls + 1] = (dy / n)[mask]
        vert[mask, 3 * cls + 2] = np.log(depth)
    return label, vert


EXTENTS = np.array(
    [[0, 0, 0], [0.3, 0.3, 0.3], [0.2, 0.25, 0.1], [0.4, 0.2, 0.3]], np.float32
)


def run_hough(label, vert, is_train=False, gt_poses=None, gt_valid=None, **kw):
    defaults = dict(
        label_threshold=100,
        num_samples=128,
        max_classes=3,
        max_objects_per_image=4,
        sample_chunk=8,
    )
    defaults.update(kw)
    return hough_voting(
        jnp.asarray(label[None]),
        jnp.asarray(vert[None]),
        jnp.asarray(EXTENTS),
        jnp.asarray(make_meta()[None]),
        None if gt_poses is None else jnp.asarray(gt_poses),
        None if gt_valid is None else jnp.asarray(gt_valid),
        is_train=is_train,
        **defaults,
    )


def test_single_object_center_and_depth():
    cls, cx, cy, depth = 2, 100.0, 60.0, 1.2
    label, vert = make_scene([(cls, cx, cy, depth, 30, 25)])
    out = run_hough(label, vert)
    valid = np.asarray(out.valid)
    assert valid.sum() == 1
    i = int(np.argmax(valid))
    roi = np.asarray(out.rois)[i]
    pose = np.asarray(out.poses_init)[i]
    assert roi[1] == cls
    # center = box midpoint
    mx, my = (roi[2] + roi[4]) / 2, (roi[3] + roi[5]) / 2
    assert abs(mx - cx) <= 2.0 and abs(my - cy) <= 2.0
    # initial pose: identity quaternion + ray × depth
    np.testing.assert_allclose(pose[:4], [1, 0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(pose[6], depth, rtol=0.02)
    np.testing.assert_allclose(pose[4], (cx - PX) / FX * depth, atol=0.03)
    np.testing.assert_allclose(pose[5], (cy - PY) / FY * depth, atol=0.03)


def test_two_objects_two_classes():
    label, vert = make_scene(
        [(1, 40.0, 40.0, 0.8, 22, 22), (3, 120.0, 80.0, 1.5, 25, 20)]
    )
    out = run_hough(label, vert)
    valid = np.asarray(out.valid)
    rois = np.asarray(out.rois)
    got = sorted(rois[valid, 1].astype(int).tolist())
    assert got == [1, 3]


def test_below_label_threshold_is_dropped():
    # tiny object: fewer pixels than label_threshold → no detection
    label, vert = make_scene([(1, 50.0, 50.0, 1.0, 4, 4)])
    out = run_hough(label, vert)
    assert np.asarray(out.valid).sum() == 0


def test_empty_scene():
    label = np.zeros((H, W), np.int32)
    vert = np.zeros((H, W, 3 * NUM_CLASSES), np.float32)
    out = run_hough(label, vert)
    assert np.asarray(out.valid).sum() == 0


def test_train_mode_emits_9_jittered_rois_and_targets():
    cls, cx, cy, depth = 1, 80.0, 60.0, 1.0
    label, vert = make_scene([(cls, cx, cy, depth, 30, 25)])
    # GT pose row: [batch, cls, ..., quat(6:10), t(10:13)]
    q = np.array([0.8, 0.6, 0.0, 0.0], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([(cx - PX) / FX * depth, (cy - PY) / FY * depth, depth], np.float32)
    gt = np.zeros((2, 13), np.float32)
    gt[0, 0] = 0
    gt[0, 1] = cls
    gt[0, 6:10] = q
    gt[0, 10:13] = t
    out = run_hough(label, vert, is_train=True, gt_poses=gt, gt_valid=np.array([True, False]))
    valid = np.asarray(out.valid)
    assert valid.sum() == 9  # center + 8 jitters (ref .cu.cc:469-554)
    rois = np.asarray(out.rois)[valid]
    # all 9 share class and score; boxes shifted by ±5% of size
    assert np.all(rois[:, 1] == cls)
    w0 = rois[0, 4] - rois[0, 2]
    assert np.allclose(rois[:, 4] - rois[:, 2], w0, atol=1e-3)
    shifts = np.unique(np.round((rois[:, 2] - rois[0, 2]) / (0.05 * w0)).astype(int))
    assert set(shifts.tolist()) == {-1, 0, 1}
    # matched targets carry the GT quaternion in the class slot
    tgt = np.asarray(out.poses_target)[valid]
    wgt = np.asarray(out.poses_weight)[valid]
    np.testing.assert_allclose(tgt[:, 4 * cls : 4 * cls + 4], np.tile(q, (9, 1)), atol=1e-5)
    np.testing.assert_allclose(wgt[:, 4 * cls : 4 * cls + 4], 1.0)
    assert wgt.sum() == 9 * 4  # only the matched class slot is weighted
    assert np.all(np.asarray(out.domains)[valid] == 0)


def test_train_mode_unmatched_gt_gives_zero_weight():
    cls = 1
    label, vert = make_scene([(cls, 80.0, 60.0, 1.0, 30, 25)])
    gt = np.zeros((1, 13), np.float32)
    gt[0, 1] = 3  # different class → no match
    gt[0, 6] = 1.0
    gt[0, 12] = 1.0
    out = run_hough(label, vert, is_train=True, gt_poses=gt, gt_valid=np.array([True]))
    valid = np.asarray(out.valid)
    assert valid.sum() == 9
    assert np.asarray(out.poses_weight)[valid].sum() == 0


def test_multi_instance_mode_vote_threshold():
    # two instances of the same class — single-instance mode merges
    # them; multi-instance (vote_threshold>0) finds both local maxima
    label, vert = make_scene(
        [(1, 40.0, 60.0, 1.0, 18, 18), (1, 120.0, 60.0, 1.0, 18, 18)]
    )
    out = run_hough(label, vert, vote_threshold=5.0, vote_percentage=0.0001)
    valid = np.asarray(out.valid)
    rois = np.asarray(out.rois)[valid]
    assert valid.sum() >= 2
    centers_x = (rois[:, 2] + rois[:, 4]) / 2
    # both true centers must be among the detections (side lobes are
    # allowed here because vote_percentage is disabled; the production
    # default 0.02 + NMS removes them)
    assert np.min(np.abs(centers_x - 40.0)) <= 3.0
    assert np.min(np.abs(centers_x - 120.0)) <= 3.0


def test_cell_stride_speed_mode_close_to_exact():
    cls, cx, cy, depth = 2, 100.0, 60.0, 1.2
    label, vert = make_scene([(cls, cx, cy, depth, 30, 25)])
    out = run_hough(label, vert, cell_stride=2)
    valid = np.asarray(out.valid)
    assert valid.sum() == 1
    roi = np.asarray(out.rois)[np.argmax(valid)]
    mx, my = (roi[2] + roi[4]) / 2, (roi[3] + roi[5]) / 2
    assert abs(mx - cx) <= 3.0 and abs(my - cy) <= 3.0


def test_sample_extraction_matches_compact_then_stride():
    """The two-level block search must pick exactly the
    (⌊j·count/S⌋+1)-th class pixel in scanline order — i.e. identical
    to compacting class pixels then striding (ref: the CUDA
    compaction + `i += skip_pixels` walk, .cu.cc:174-187,269)."""
    import jax.numpy as jnp

    from posecnn_tpu.ops.hough_voting import _prepare_slots

    rng = np.random.RandomState(7)
    h, w, c, s = 67, 93, 6, 32  # odd sizes: exercises block padding
    label = rng.randint(0, c, (h, w)).astype(np.int32)
    vert = rng.randn(h, w, 3 * c).astype(np.float32)
    meta = np.zeros(48, np.float32)
    meta[0], meta[4], meta[2], meta[5] = 100.0, 100.0, w / 2, h / 2
    extents = np.abs(rng.randn(c, 3)).astype(np.float32) * 0.1 + 0.05
    prep = _prepare_slots(
        jnp.asarray(label), jnp.asarray(vert), jnp.asarray(extents),
        jnp.asarray(meta), num_classes=c, label_threshold=5,
        skip_pixels=10, num_samples=s, max_classes=4,
    )
    slot_cls = np.asarray(prep["slot_cls"])
    samp_x = np.asarray(prep["samp_x"])
    samp_y = np.asarray(prep["samp_y"])
    flat = label.reshape(-1)
    for k in range(len(slot_cls)):
        cls = slot_cls[k]
        pix = np.nonzero(flat == cls)[0]
        if len(pix) == 0:
            continue
        expect = pix[(np.arange(s) * len(pix)) // s]
        got = (samp_y[k] * w + samp_x[k]).astype(np.int64)
        np.testing.assert_array_equal(got, expect)


def test_vertex_factor_lowres_equals_fullres_upsample():
    """vertex_factor=f sampling from the pre-upsample map must equal
    running on the frozen-bilinear-upsampled full-res map (the model's
    serving path relies on this exact equivalence)."""
    import jax

    f = 8
    hl, wl = H // f, W // f
    rng = np.random.RandomState(3)
    # a smooth low-res vertex field around a real object so votes are
    # not borderline: constant direction field toward a center + noise
    cls, cx, cy, depth = 2, 100.0, 60.0, 1.2
    label, _ = make_scene([(cls, cx, cy, depth, 30, 25)])
    low = rng.randn(hl, wl, 3 * NUM_CLASSES).astype(np.float32) * 0.01
    ys, xs = np.mgrid[0:hl, 0:wl]
    # direction field evaluated at low-res pixel centers (full-res
    # coords of low-res pixel (i,j) center: (j+0.5)*f-0.5, (i+0.5)*f-0.5)
    fy_c = (ys + 0.5) * f - 0.5
    fx_c = (xs + 0.5) * f - 0.5
    dx = cx - fx_c
    dy = cy - fy_c
    n = np.sqrt(dx * dx + dy * dy) + 1e-10
    low[..., 3 * cls + 0] = dx / n
    low[..., 3 * cls + 1] = dy / n
    low[..., 3 * cls + 2] = np.log(depth)
    full = np.asarray(
        jax.image.resize(
            jnp.asarray(low), (H, W, 3 * NUM_CLASSES), method="linear"
        )
    )

    out_full = run_hough(label, full)
    out_low = hough_voting(
        jnp.asarray(label[None]),
        jnp.asarray(low[None]),
        jnp.asarray(EXTENTS),
        jnp.asarray(make_meta()[None]),
        vertex_factor=f,
        label_threshold=100,
        num_samples=128,
        max_classes=3,
        max_objects_per_image=4,
        sample_chunk=8,
    )
    np.testing.assert_allclose(
        np.asarray(out_low.rois), np.asarray(out_full.rois), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(out_low.poses_init), np.asarray(out_full.poses_init), atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(out_low.valid), np.asarray(out_full.valid)
    )


def test_vertex_factor_multi_instance_mode():
    """Low-res sampling composes with multi-instance local-max mode
    (the model passes vertex_factor=8 regardless of vote_threshold)."""
    import jax

    f = 8
    hl, wl = H // f, W // f
    cls, depth = 2, 1.0
    label = np.zeros((H, W), np.int32)
    low = np.zeros((hl, wl, 3 * NUM_CLASSES), np.float32)
    ys, xs = np.mgrid[0:hl, 0:wl]
    fy_c = (ys + 0.5) * f - 0.5
    fx_c = (xs + 0.5) * f - 0.5
    # two instances of the same class at different centers
    for cx, cy, x0, x1 in ((40.0, 60.0, 10, 70), (120.0, 60.0, 90, 150)):
        mask_full = (np.abs(np.arange(W)[None, :] - cx) <= 28) & (
            np.abs(np.arange(H)[:, None] - cy) <= 25
        )
        label[mask_full] = cls
        region = (np.abs(fx_c - cx) <= 34) & (np.abs(fy_c - cy) <= 31)
        dx = cx - fx_c
        dy = cy - fy_c
        n = np.sqrt(dx * dx + dy * dy) + 1e-10
        low[region, 3 * cls + 0] = (dx / n)[region]
        low[region, 3 * cls + 1] = (dy / n)[region]
        low[region, 3 * cls + 2] = np.log(depth)

    out = hough_voting(
        jnp.asarray(label[None]),
        jnp.asarray(low[None]),
        jnp.asarray(EXTENTS),
        jnp.asarray(make_meta()[None]),
        vertex_factor=f,
        vote_threshold=10.0,
        label_threshold=100,
        num_samples=128,
        max_classes=3,
        max_objects_per_image=4,
        sample_chunk=8,
    )
    valid = np.asarray(out.valid)
    rois = np.asarray(out.rois)
    cx_found = np.array(
        [0.5 * (rois[i, 2] + rois[i, 4]) for i in np.nonzero(valid)[0]]
    )
    # plateau cells can emit extra nearby maxima (the reference does
    # too and relies on downstream NMS) — require each instance found
    # and every candidate near one of the two true centers
    assert valid.sum() >= 2
    assert np.any(np.abs(cx_found - 40.0) < 6)
    assert np.any(np.abs(cx_found - 120.0) < 6)
    assert np.all(
        (np.abs(cx_found - 40.0) < 8) | (np.abs(cx_found - 120.0) < 8)
    )


def test_append_gt_rois_prepends_exact_supervision():
    """GT-RoI injection (cfg.train.gt_pose_rois): prepended rows carry
    the projected GT extent box, the GT quaternion as a weight-1 target
    in the matched-class columns, and respect gt_valid padding."""
    import jax

    from posecnn_tpu.ops.hough_voting import (
        HoughOutputs,
        _gt_projected_boxes,
        append_gt_rois,
    )

    c = 3
    base = HoughOutputs(
        rois=jnp.zeros((5, 7)),
        poses_init=jnp.zeros((5, 7)),
        poses_target=jnp.zeros((5, 4 * c)),
        poses_weight=jnp.zeros((5, 4 * c)),
        domains=jnp.zeros((5,), jnp.int32),
        valid=jnp.zeros((5,), bool),
    )
    meta = np.tile(make_meta()[None], (2, 1))
    q1 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    q2 = np.array([0.0, 0.0, 1.0, 0.0], np.float32)
    gt = np.zeros((3, 13), np.float32)
    gt[0] = [0, 1, 0, 0, 0, 0, *q1, 0.02, -0.01, 0.9]
    gt[1] = [1, 2, 0, 0, 0, 0, *q2, -0.05, 0.03, 1.2]
    # row 2 is padding (gt_valid False)
    gt_valid = np.array([True, True, False])

    out = append_gt_rois(
        base, jnp.asarray(gt), jnp.asarray(gt_valid),
        jnp.asarray(EXTENTS), jnp.asarray(meta), c,
    )
    assert out.rois.shape == (8, 7)
    assert np.array_equal(np.asarray(out.valid), [True, True, False] + [False] * 5)
    rois = np.asarray(out.rois)
    assert rois[0, 0] == 0 and rois[0, 1] == 1
    assert rois[1, 0] == 1 and rois[1, 1] == 2
    exp_box = np.asarray(
        _gt_projected_boxes(
            jnp.asarray(gt[:1]), jnp.asarray(EXTENTS),
            meta[0, 0], meta[0, 4], meta[0, 2], meta[0, 5],
        )
    )[0]
    np.testing.assert_allclose(rois[0, 2:6], exp_box, rtol=1e-5)
    tg = np.asarray(out.poses_target)
    wt = np.asarray(out.poses_weight)
    np.testing.assert_allclose(tg[0, 4:8], q1)
    np.testing.assert_allclose(tg[1, 8:12], q2)
    assert wt[0, 4:8].sum() == 4 and wt[1, 8:12].sum() == 4
    # padding row contributes nothing
    assert tg[2].sum() == 0 and wt[2].sum() == 0
    # init pose: identity rotation at the GT translation
    np.testing.assert_allclose(np.asarray(out.poses_init)[0], [1, 0, 0, 0, 0.02, -0.01, 0.9])
    # original rows follow unchanged
    assert np.all(rois[3:] == 0)
    # gradients stay cut (pure data)
    g = jax.grad(
        lambda q: jnp.sum(
            append_gt_rois(
                base, jnp.asarray(gt).at[0, 6:10].set(q), jnp.asarray(gt_valid),
                jnp.asarray(EXTENTS), jnp.asarray(meta), c,
            ).poses_target
        )
    )(jnp.asarray(q1))
    assert np.all(np.asarray(g) == 0)


# --- scenes checked against their known centres and depths, on the
# dense XLA path and on the GPU's coarse-to-fine kernels (run here in
# Pallas interpret mode) ---

hv = importlib.import_module("posecnn_tpu.ops.hough_voting")


@pytest.fixture(params=["dense", "c2f"])
def vote_path(request, monkeypatch):
    """Single-instance vote path: the dense reduction, or the c2f
    kernels the GPU selects, interpreted on the CPU."""
    if request.param == "c2f":
        monkeypatch.setattr(
            hv, "_kernel_slot_max",
            lambda vote_threshold: functools.partial(hv._slot_max_c2f, interpret=True)
            if vote_threshold <= 0 else None,
        )
    return request.param


def _detections(out, image=0):
    """{class: (centre_x, centre_y, depth)} of the valid rows of one image."""
    valid = np.asarray(out.valid)
    rois = np.asarray(out.rois)
    poses = np.asarray(out.poses_init)
    found = {}
    for i in np.nonzero(valid & (rois[:, 0] == image))[0]:
        cx, cy = (rois[i, 2] + rois[i, 4]) / 2, (rois[i, 3] + rois[i, 5]) / 2
        found[int(rois[i, 1])] = (cx, cy, poses[i, 6])
    return found


def _assert_found(found, objects, tol_px=2.0):
    assert sorted(found) == sorted(o[0] for o in objects)
    for cls, cx, cy, depth, _, _ in objects:
        x, y, d = found[cls]
        assert abs(x - cx) <= tol_px and abs(y - cy) <= tol_px, (cls, x, y)
        np.testing.assert_allclose(d, depth, rtol=0.02)


@pytest.mark.parametrize(
    "objects",
    [
        [(2, 100.0, 60.0, 1.2, 30, 25)],
        [(1, 40.0, 40.0, 0.8, 22, 22), (3, 120.0, 80.0, 1.5, 25, 20)],
        # object at the image corner (window-origin clamping)
        [(2, 3.0, 3.0, 1.0, 10, 10)],
        # three classes, one touching the right edge
        [(1, 30.0, 30.0, 0.9, 15, 15), (2, 150.0, 60.0, 1.3, 12, 20),
         (3, 80.0, 100.0, 1.1, 20, 12)],
    ],
    ids=["one", "two", "corner", "three_edge"],
)
def test_scene_centres_and_depths(vote_path, objects):
    _assert_found(_detections(run_hough(*make_scene(objects))), objects)


def test_scene_small_object_dropped_corner_kept(vote_path):
    # 9×9 px is below label_threshold=100 and is dropped; the corner
    # object is kept with its exact centre
    small, corner = (1, 30.0, 100.0, 2.0, 4, 4), (2, 3.0, 3.0, 1.0, 10, 10)
    out = run_hough(*make_scene([small, corner]))
    _assert_found(_detections(out), [corner])


def test_scene_empty(vote_path):
    label = np.zeros((H, W), np.int32)
    vert = np.zeros((H, W, 3 * NUM_CLASSES), np.float32)
    assert np.asarray(run_hough(label, vert).valid).sum() == 0


def test_scene_train_mode_gt_matching(vote_path):
    obj = (2, 100.0, 60.0, 1.2, 30, 25)
    gt = np.zeros((2, 13), np.float32)
    gt[0, 1] = 2
    gt[0, 6:10] = [0.6, 0.0, 0.8, 0.0]
    gt[0, 10:13] = [(100.0 - PX) / FX * 1.2, 0.0, 1.2]
    label, vert = make_scene([obj])
    out = run_hough(label, vert, is_train=True, gt_poses=gt, gt_valid=np.array([True, False]))
    valid = np.asarray(out.valid)
    assert valid.sum() == 9
    _assert_found(_detections(out), [obj], tol_px=0.05 * 62 + 2.0)
    tgt = np.asarray(out.poses_target)[valid]
    np.testing.assert_allclose(tgt[:, 8:12], np.tile(gt[0, 6:10], (9, 1)), atol=1e-6)
    assert np.asarray(out.poses_weight)[valid].sum() == 9 * 4


def test_scene_batch4(vote_path):
    scenes = [
        [(1, 40.0, 40.0, 0.8, 22, 22)],
        [(2, 100.0, 60.0, 1.2, 30, 25)],
        [(3, 120.0, 80.0, 1.5, 25, 20)],
        [(1, 60.0, 70.0, 1.0, 20, 20), (3, 120.0, 40.0, 1.4, 22, 18)],
    ]
    labels, verts = zip(*(make_scene(s) for s in scenes))
    out = hough_voting(
        jnp.asarray(np.stack(labels)), jnp.asarray(np.stack(verts)),
        jnp.asarray(EXTENTS), jnp.asarray(np.stack([make_meta()] * 4)),
        label_threshold=100, num_samples=128, max_classes=3,
        max_objects_per_image=4,
    )
    for b, objects in enumerate(scenes):
        _assert_found(_detections(out, image=b), objects)


def _centres(out):
    rois = np.asarray(out.rois)[np.asarray(out.valid)]
    return np.stack([(rois[:, 2] + rois[:, 4]) / 2, (rois[:, 3] + rois[:, 5]) / 2], 1)


def _assert_instances(out, centres, tol_px):
    got = _centres(out)
    for tx, ty in centres:
        assert np.min(np.hypot(got[:, 0] - tx, got[:, 1] - ty)) <= tol_px, (tx, ty, got)


def test_multi_instance_same_class_pair():
    objects = [(1, 40.0, 60.0, 1.0, 18, 18), (1, 120.0, 60.0, 1.0, 18, 18)]
    out = run_hough(*make_scene(objects), vote_threshold=5.0, vote_percentage=0.0001)
    _assert_instances(out, [(40.0, 60.0), (120.0, 60.0)], 3.0)


@pytest.mark.parametrize("sep", [13.0, 16.0, 19.0, 22.0])
def test_multi_instance_close_pair(sep):
    """Two same-class instances 13-22 px apart both stay local maxima."""
    objects = [(1, 40.0, 60.0, 1.0, 10, 10), (1, 40.0 + sep, 60.0, 1.0, 10, 10)]
    out = run_hough(*make_scene(objects), vote_threshold=5.0, vote_percentage=0.0001)
    _assert_instances(out, [(40.0, 60.0), (40.0 + sep, 60.0)], 3.0)


def test_multi_instance_mixed_classes_and_corner():
    objects = [
        (1, 30.0, 40.0, 0.9, 16, 16),
        (1, 110.0, 90.0, 1.4, 20, 16),
        (3, 8.0, 8.0, 1.1, 14, 14),
    ]
    out = run_hough(*make_scene(objects), vote_threshold=4.0, vote_percentage=0.0001)
    assert np.asarray(out.valid).sum() >= 3
    _assert_instances(out, [(30.0, 40.0), (110.0, 90.0), (8.0, 8.0)], 4.0)


def test_c2f_kernel_lowers_for_cuda(monkeypatch):
    """The Triton kernels lower, at the serving widths, to Triton IR
    that passes MLIR verification — from any host. What the GPU's
    compiler then makes of it shows only on a card."""
    from jax._src.pallas.triton import pallas_call_registration as registration

    from posecnn_tpu.ops.hough_triton import hough_c2f_max

    lower_module = registration.lowering.lower_jaxpr_to_triton_module
    verified = []

    def lower_and_verify(*args, **kwargs):
        result = lower_module(*args, **kwargs)
        verified.append(result.module.operation.verify())
        return result

    monkeypatch.setattr(registration.lowering, "lower_jaxpr_to_triton_module", lower_and_verify)
    fn = jax.jit(functools.partial(hough_c2f_max, cell_stride=1, grid_h=480, grid_w=640))
    lowered = fn.trace(jnp.zeros((16, 8, 1024)), jnp.zeros((16, 4))).lower(
        lowering_platforms=("cuda",)
    )
    assert "triton" in lowered.as_text()
    assert verified == [True, True]  # coarse pass and refinement windows
