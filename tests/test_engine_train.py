"""End-to-end engine tests: synthetic data → train step → loss
decreases; sharded multi-device step compiles and runs on the virtual
8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from posecnn_tpu.core.config import cfg_from_dict
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator
from posecnn_tpu.engine.train import (
    compute_losses,
    create_train_state,
    make_train_step,
)
from posecnn_tpu.models import PoseCNN
from posecnn_tpu.parallel.mesh import batch_sharding, create_mesh, replicated

C = 4
H, W = 48, 64  # small: CPU-compile time dominates this suite
P_PTS = 32


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    # synthetic class "models": small point clouds
    points = (rng.rand(C, P_PTS, 3).astype(np.float32) - 0.5) * 0.12
    points[0] = 0
    extents = np.abs(points).max(1) * 2.0
    extents[0] = 0
    k = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(
        points, extents, k, width=W, height=H, min_objects=1, max_objects=2,
        t_near=0.6, t_far=1.2, seed=7,
    )
    cfg = cfg_from_dict(
        {
            "train": {
                "num_classes": C,
                "vertex_reg_2d": True,
                "pose_reg": True,
                "ims_per_batch": 2,
                "learning_rate": 0.0005,
                "hough_num_samples": 64,
                "max_rois": 4,
            }
        }
    )
    model = PoseCNN(
        num_classes=C,
        num_units=16,
        fc_dim=64,  # tiny pose head: fc6/fc7@4096 dominate CPU compile
        hough_num_samples=64,
        max_objects=2,
        hough_cell_stride=2,
        compute_dtype=jnp.float32,  # CPU test: avoid slow bf16 emulation
    )
    symmetry = np.zeros(C, np.float32)
    return gen, cfg, model, points, extents, symmetry


def test_synthetic_generator_blobs(setup):
    gen, *_ = setup
    batch = gen.minibatch(2)
    assert batch["data"].shape == (2, H, W, 3)
    assert batch["label"].shape == (2, H, W)
    assert batch["vertex_targets"].shape == (2, H, W, 3 * C)
    assert batch["gt_poses"].shape[1] == 13
    # labeled pixels exist and weights mark exactly those pixels
    lab = batch["label"][0]
    wsum = batch["vertex_weights"][0].sum(-1)
    assert (lab > 0).sum() > 50
    assert np.array_equal(wsum > 0, lab > 0)
    # direction targets are unit vectors on labeled pixels
    ys, xs = np.nonzero(lab > 0)
    cls = lab[ys, xs]
    u = batch["vertex_targets"][0][ys, xs, 3 * cls]
    v = batch["vertex_targets"][0][ys, xs, 3 * cls + 1]
    np.testing.assert_allclose(np.sqrt(u * u + v * v), 1.0, atol=1e-4)
    # depth channel is log z within the sampled range
    d = np.exp(batch["vertex_targets"][0][ys, xs, 3 * cls + 2])
    assert d.min() > 0.4 and d.max() < 1.5


def test_compute_losses_finite(setup):
    gen, cfg, model, points, extents, symmetry = setup
    batch = {k: jnp.asarray(v) for k, v in gen.minibatch(2).items()}
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch, jnp.asarray(extents))
    loss, metrics = compute_losses(
        model, state.params, batch, cfg, jnp.asarray(points), jnp.asarray(extents),
        jnp.asarray(symmetry), dropout_rng=jax.random.PRNGKey(1),
    )
    assert np.isfinite(float(loss))
    for k in ("loss_cls", "loss_vertex", "loss_pose"):
        assert k in metrics and np.isfinite(float(metrics[k]))


def test_compact_feed_matches_float_feed(setup):
    """uint8 feed compression (pipeline.compact_feed →
    train.decompress_feed) is value-preserving: same losses as the
    float32 feed to quantization tolerance, with depth dropped."""
    from posecnn_tpu.data.pipeline import compact_feed

    gen, cfg, model, points, extents, symmetry = setup
    raw = gen.minibatch(2)
    pm = gen.pixel_means
    comp = compact_feed(raw, pm)
    assert comp["data"].dtype == np.uint8
    assert comp["label"].dtype == np.uint8
    assert "depth" not in comp
    fbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    cbatch = {k: jnp.asarray(v) for k, v in comp.items()}
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), cbatch, jnp.asarray(extents))
    args = (jnp.asarray(points), jnp.asarray(extents), jnp.asarray(symmetry))
    lf, mf = compute_losses(model, state.params, fbatch, cfg, *args,
                            dropout_rng=jax.random.PRNGKey(1))
    lc, mc = compute_losses(model, state.params, cbatch, cfg, *args,
                            dropout_rng=jax.random.PRNGKey(1))
    assert np.isfinite(float(lc))
    # ±0.5-intensity quantization on a random-init net: a few percent
    np.testing.assert_allclose(float(lc), float(lf), rtol=0.05, atol=0.02)
    for k in ("loss_cls", "loss_vertex"):
        np.testing.assert_allclose(float(mc[k]), float(mf[k]), rtol=0.08, atol=0.02)


def test_lr_step_offset_aligns_staircase_to_global_step():
    """Resume semantics: optimizer counts reset to 0 (the adam restart
    kick the rotation recipe depends on — r6 forensics) while the lr
    staircase stays honest via train.lr_step_offset."""
    from posecnn_tpu.engine.train import lr_schedule

    base = cfg_from_dict({"train": {
        "learning_rate": 1.0, "stepsize": 30000, "gamma": 0.1,
    }})
    # fresh run: undecayed at 0, decayed at 30k
    np.testing.assert_allclose(float(lr_schedule(base)(0)), 1.0)
    np.testing.assert_allclose(float(lr_schedule(base)(30000)), 0.1, rtol=1e-6)
    # resumed at global step 45k: local count 0 must already be decayed
    res = cfg_from_dict({"train": {
        "learning_rate": 1.0, "stepsize": 30000, "gamma": 0.1,
        "lr_step_offset": 45000,
    }})
    np.testing.assert_allclose(float(lr_schedule(res)(0)), 0.1, rtol=1e-6)
    # and crosses the next boundary at the right GLOBAL iteration
    np.testing.assert_allclose(float(lr_schedule(res)(15000)), 0.01, rtol=1e-6)


def test_fastforward_opt_counts_resumes_lr_schedule():
    """A restored optimizer state fast-forwarded to the global step
    must apply the DECAYED lr, not the init lr (chunked-restart bug:
    opt.init resets the schedule count to 0)."""
    import optax

    from posecnn_tpu.core.config import cfg_from_dict
    from posecnn_tpu.engine.train import create_optimizer, fastforward_opt_counts

    cfg = cfg_from_dict({"train": {
        "optimizer": "momentum", "momentum": 0.0, "learning_rate": 1.0,
        "stepsize": 10, "gamma": 0.1, "weight_reg": 0.0, "grad_clip": 0.0,
    }})
    params = {"w": jnp.ones((2, 2))}
    grads = {"w": jnp.ones((2, 2))}
    opt = create_optimizer(cfg, params)
    fresh = opt.init(params)
    up0, _ = opt.update(grads, fresh, params)
    np.testing.assert_allclose(np.asarray(up0["w"]), -1.0, rtol=1e-6)
    ffwd = fastforward_opt_counts(opt.init(params), 15)
    up1, _ = opt.update(grads, ffwd, params)
    np.testing.assert_allclose(np.asarray(up1["w"]), -0.1, rtol=1e-6)
    # adam states carry (count, mu, nu) — counts fast-forward, moments keep
    acfg = cfg_from_dict({"train": {
        "optimizer": "adam", "learning_rate": 1.0, "stepsize": 10,
        "gamma": 0.1, "weight_reg": 0.0, "grad_clip": 0.0,
    }})
    aopt = create_optimizer(acfg, params)
    affwd = fastforward_opt_counts(aopt.init(params), 25)
    aup, _ = aopt.update(grads, affwd, params)
    # lr at count 25 is 1.0 * 0.1^2; adam normalizes constant grads to ~1
    assert 0.001 < abs(float(np.asarray(aup["w"])[0, 0])) < 0.02


def test_train_step_reduces_loss(setup):
    gen, cfg, model, points, extents, symmetry = setup
    batch = {k: jnp.asarray(v) for k, v in gen.minibatch(2).items()}
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch, jnp.asarray(extents))
    step = make_train_step(
        cfg, model, jnp.asarray(points), jnp.asarray(extents), jnp.asarray(symmetry),
        donate=False,
    )
    rng = jax.random.PRNGKey(0)
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch, rng)
        losses.append(float(metrics["loss"]))
    assert np.all(np.isfinite(losses))
    # overfitting one fixed batch must reduce the loss
    assert losses[-1] < losses[0], losses


def test_sharded_train_step_on_virtual_mesh(setup):
    gen, cfg, model, points, extents, symmetry = setup
    n_dev = len(jax.devices())
    assert n_dev == 8, f"conftest should provide 8 virtual devices, got {n_dev}"
    mesh = create_mesh(num_data=8)
    bs = batch_sharding(mesh)
    rep = replicated(mesh)

    batch_np = gen.minibatch(8)
    batch = {}
    for k, v in batch_np.items():
        # batch-dim arrays shard over 'data'; GT rows are replicated
        sh = bs if v.shape[:1] == (8,) and k not in ("gt_poses", "gt_valid") else rep
        batch[k] = jax.device_put(jnp.asarray(v), sh)

    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch, jnp.asarray(extents))
    state = jax.device_put(state, rep)
    step = make_train_step(
        cfg, model, jnp.asarray(points), jnp.asarray(extents), jnp.asarray(symmetry),
        mesh=mesh, donate=False,
    )
    state2, metrics = step(state, batch, jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["loss"]))
    # params remain replicated; a second step also runs
    _, metrics2 = step(state2, batch, jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics2["loss"]))


def test_data_parallel_step_matches_single_device(setup):
    """DP equivalence (r4 verdict task 8): one train step with the
    batch sharded over 8 devices must match the same step on ONE
    device with the identical batch/state/rng — psum-of-means over
    shards equals the global mean, so only reduction order differs."""
    gen, cfg, model, points, extents, symmetry = setup
    mesh = create_mesh(num_data=8)
    bs = batch_sharding(mesh)
    rep = replicated(mesh)
    batch_np = gen.minibatch(8)
    batch_1dev = {k: jnp.asarray(v) for k, v in batch_np.items()}
    batch_dp = {
        k: jax.device_put(
            jnp.asarray(v),
            bs if v.shape[:1] == (8,) and k not in ("gt_poses", "gt_valid") else rep,
        )
        for k, v in batch_np.items()
    }
    state0 = create_train_state(cfg, model, jax.random.PRNGKey(0), batch_1dev, jnp.asarray(extents))
    rng = jax.random.PRNGKey(3)
    args = (jnp.asarray(points), jnp.asarray(extents), jnp.asarray(symmetry))

    step_1 = make_train_step(cfg, model, *args, donate=False)
    new_1, m_1 = step_1(state0, batch_1dev, rng)

    step_dp = make_train_step(cfg, model, *args, mesh=mesh, donate=False)
    state_dp = jax.device_put(state0, rep)
    new_dp, m_dp = step_dp(state_dp, batch_dp, rng)

    np.testing.assert_allclose(
        float(m_dp["loss"]), float(m_1["loss"]), rtol=2e-4, atol=2e-4
    )
    for key in ("loss_cls", "loss_vertex", "loss_pose"):
        np.testing.assert_allclose(
            float(m_dp[key]), float(m_1[key]), rtol=5e-4, atol=5e-4, err_msg=key
        )
    # updated parameters agree leaf-wise (adam amplifies tiny grad
    # diffs by 1/(sqrt(v)+eps) at step 0, hence the loose-ish atol)
    diffs = jax.tree_util.tree_map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))), new_1.params, new_dp.params
    )
    worst = max(jax.tree_util.tree_leaves(diffs))
    assert worst < 5e-3, f"max param delta {worst}"


def test_matching_loss_path(setup):
    """vgg16_full variant: cfg.train.matching adds the render-and-
    compare loss to the composition."""
    from posecnn_tpu.core.config import cfg_from_dict

    gen, _, model, points, extents, symmetry = setup
    cfg_m = cfg_from_dict(
        {
            "train": {
                "num_classes": C,
                "vertex_reg_2d": True,
                "pose_reg": True,
                "matching": True,
                "ims_per_batch": 2,
            }
        }
    )
    batch = {k: jnp.asarray(v) for k, v in gen.minibatch(2).items()}
    state = create_train_state(cfg_m, model, jax.random.PRNGKey(0), batch, jnp.asarray(extents))
    loss, metrics = compute_losses(
        model, state.params, batch, cfg_m, jnp.asarray(points), jnp.asarray(extents),
        jnp.asarray(symmetry), dropout_rng=jax.random.PRNGKey(1),
    )
    assert "loss_match" in metrics
    assert np.isfinite(float(loss))
    assert np.isfinite(float(metrics["loss_match"]))


def test_tensor_parallel_fc_sharding(setup):
    """shard_fc=True: fc6/fc7 kernels shard over the 'model' axis on a
    4×2 mesh and the train step still runs (DP+TP hybrid)."""
    from posecnn_tpu.parallel.mesh import param_sharding

    gen, cfg, model, points, extents, symmetry = setup
    mesh = create_mesh(num_data=4, num_model=2)
    rep = replicated(mesh)
    bs = batch_sharding(mesh)
    batch_np = gen.minibatch(4)
    batch = {
        k: jax.device_put(
            jnp.asarray(v),
            bs if v.shape[:1] == (4,) and k not in ("gt_poses", "gt_valid") else rep,
        )
        for k, v in batch_np.items()
    }
    state = create_train_state(cfg, model, jax.random.PRNGKey(0), batch, jnp.asarray(extents))
    shardings = param_sharding(mesh, state.params, shard_fc=True)
    # at least the fc6/fc7 kernels get a model-axis sharding
    flat = jax.tree_util.tree_leaves_with_path(shardings)
    from jax.sharding import PartitionSpec as P

    fc_specs = [
        s.spec for path, s in flat
        if any(getattr(p, "key", "") in ("fc6", "fc7") for p in path)
        and len(s.spec) == 2
    ]
    assert any(spec == P(None, "model") for spec in fc_specs)
    params_sharded = jax.device_put(state.params, shardings)
    state = state._replace(params=params_sharded)
    step = make_train_step(
        cfg, model, jnp.asarray(points), jnp.asarray(extents), jnp.asarray(symmetry),
        mesh=mesh, donate=False,
    )
    _, metrics = step(state, batch, jax.random.PRNGKey(0))
    assert np.isfinite(float(metrics["loss"]))


def test_tensor_parallel_step_matches_replicated(setup):
    """TP equivalence: one train step with fc6/fc7 sharded over the
    'model' axis must be numerically equal (tolerance) to the fully
    replicated step — the sharding annotation changes layout, not
    math (GSPMD inserts the all-gathers)."""
    from posecnn_tpu.parallel.mesh import param_sharding

    gen, cfg, model, points, extents, symmetry = setup
    mesh = create_mesh(num_data=4, num_model=2)
    rep = replicated(mesh)
    bs = batch_sharding(mesh)
    batch_np = gen.minibatch(4)
    batch = {
        k: jax.device_put(
            jnp.asarray(v),
            bs if v.shape[:1] == (4,) and k not in ("gt_poses", "gt_valid") else rep,
        )
        for k, v in batch_np.items()
    }
    state0 = create_train_state(cfg, model, jax.random.PRNGKey(0), batch, jnp.asarray(extents))
    step = make_train_step(
        cfg, model, jnp.asarray(points), jnp.asarray(extents), jnp.asarray(symmetry),
        mesh=mesh, donate=False,
    )
    rng = jax.random.PRNGKey(3)

    state_rep = state0._replace(params=jax.device_put(state0.params, rep))
    state_rep = jax.device_put(state_rep, rep)
    new_rep, m_rep = step(state_rep, batch, rng)

    shardings = param_sharding(mesh, state0.params, shard_fc=True)
    state_tp = jax.device_put(state_rep, rep)._replace(
        params=jax.device_put(state0.params, shardings)
    )
    new_tp, m_tp = step(state_tp, batch, rng)

    np.testing.assert_allclose(
        float(m_tp["loss"]), float(m_rep["loss"]), rtol=1e-5, atol=1e-6
    )
    flat_rep = jax.tree_util.tree_leaves_with_path(jax.device_get(new_rep.params))
    flat_tp = {
        jax.tree_util.keystr(p): v
        for p, v in jax.tree_util.tree_leaves_with_path(jax.device_get(new_tp.params))
    }
    checked_fc = 0
    for path, v_rep in flat_rep:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            flat_tp[key], v_rep, rtol=2e-4, atol=1e-6, err_msg=key
        )
        if "fc6" in key or "fc7" in key:
            checked_fc += 1
    assert checked_fc >= 4  # fc6/fc7 kernel+bias actually compared


def test_symsize_curriculum_and_point_rescale(setup):
    """SYMSIZE gates ADD-S (ref: layer.py:101-104) and the loss points
    are rescaled by max(10, 2/max_extent), ×4 for symmetric classes
    once the curriculum enables symmetry (ref: minibatch.py:50-61)."""
    from posecnn_tpu.engine.train import loss_point_scale

    points = np.ones((3, 4, 3), np.float32)
    extents = np.array([[0, 0, 0], [0.1, 0.2, 0.05], [1.0, 0.5, 0.5]], np.float32)
    symmetry = np.array([0.0, 0.0, 1.0], np.float32)

    pts, sym = loss_point_scale(points, extents, symmetry, jnp.asarray(True))
    # class 1: 2/0.2 = 10 (clamped floor also 10); class 2 symmetric:
    # max(2/1.0, 10) = 10, ×4 = 40; class 0 (zero extent): floor 10
    np.testing.assert_allclose(np.asarray(pts)[0], 10.0)
    np.testing.assert_allclose(np.asarray(pts)[1], 10.0)
    np.testing.assert_allclose(np.asarray(pts)[2], 40.0)
    np.testing.assert_allclose(np.asarray(sym), symmetry)

    pts0, sym0 = loss_point_scale(points, extents, symmetry, jnp.asarray(False))
    # pre-curriculum: no 4× upweight, symmetry flags zeroed (plain ADD)
    np.testing.assert_allclose(np.asarray(pts0)[2], 10.0)
    np.testing.assert_allclose(np.asarray(sym0), 0.0)

    # a larger extent drives the weight above the floor: 2/0.1 = 20
    ext_small = np.array([[0, 0, 0], [0.1, 0.05, 0.02], [1.0, 0.5, 0.5]], np.float32)
    pts2, _ = loss_point_scale(points, ext_small, symmetry, jnp.asarray(True))
    np.testing.assert_allclose(np.asarray(pts2)[1], 20.0)


def test_sparse_vertex_feed_matches_dense(setup):
    """Sparse per-class vertex feed (vertex_centers/logz/valid) built
    on device must yield the exact same losses as the host-built dense
    maps (ops/losses.build_vertex_targets equivalence at the engine
    level)."""
    gen, cfg, model, points, extents, symmetry = setup
    rng_np = np.random.RandomState(11)
    gen.rng = np.random.RandomState(21)
    dense = gen.minibatch(2, dense_vertex_targets=True)
    gen.rng = np.random.RandomState(21)  # same scenes
    sparse = gen.minibatch(2, dense_vertex_targets=False)
    assert "vertex_targets" not in sparse
    assert sparse["vertex_centers"].shape == (2, C, 2)
    np.testing.assert_array_equal(dense["label"], sparse["label"])

    params = create_train_state(
        cfg, model, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in dense.items()}, jnp.asarray(extents),
    ).params
    args = (model, params)
    kw = dict(
        cfg=cfg, points=jnp.asarray(points), extents=jnp.asarray(extents),
        symmetry=jnp.asarray(symmetry), dropout_rng=jax.random.PRNGKey(5),
    )
    l_dense, m_dense = compute_losses(
        *args, {k: jnp.asarray(v) for k, v in dense.items()}, **kw
    )
    l_sparse, m_sparse = compute_losses(
        *args, {k: jnp.asarray(v) for k, v in sparse.items()}, **kw
    )
    np.testing.assert_allclose(float(l_dense), float(l_sparse), rtol=1e-5)
    np.testing.assert_allclose(
        float(m_dense["loss_vertex"]), float(m_sparse["loss_vertex"]), rtol=1e-5
    )
