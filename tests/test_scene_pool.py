"""Replay-pool feeder tests (data/synthetic.pooled_minibatch).

The pool exists because scene synthesis on a 2-core host caps the
sample rate at ~batch-2 while the device step is ~free (r5 diagnosis):
device batches of 16+ at the host cost of `fresh` renders per step.
"""

import numpy as np

from posecnn_tpu.data.procedural import colorize_model_library
from posecnn_tpu.data.synthetic import SyntheticSceneGenerator


def _gen(seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(3, 300, 3).astype(np.float32) - 0.5) * 0.1
    pts[0] = 0
    ext = np.abs(pts).max(1) * 2
    cols, nrms = colorize_model_library(pts, orient_detail=True)
    k = np.array([[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]], np.float32)
    return SyntheticSceneGenerator(
        pts, ext, k, width=64, height=64,
        point_colors=cols, point_normals=nrms,
    )


def test_pooled_minibatch_shapes_and_growth():
    g = _gen()
    b1 = g.pooled_minibatch(8, max_gt=32, dense_vertex_targets=False,
                            pool_size=20, fresh=2)
    n0 = len(g._pool)
    assert n0 == 8  # first call seeds the pool with a full batch
    b2 = g.pooled_minibatch(8, max_gt=32, dense_vertex_targets=False,
                            pool_size=20, fresh=2)
    assert len(g._pool) == n0 + 2  # steady state adds `fresh`
    assert b1["data"].shape == (8, 64, 64, 3)
    assert b1["gt_poses"].shape == (32, 13)
    gi = b2["gt_poses"][b2["gt_valid"], 0]
    assert gi.min() >= 0 and gi.max() < 8


def test_pooled_minibatch_bounds_pool_and_decorrelates_draws():
    g = _gen(1)
    for _ in range(30):
        g.pooled_minibatch(4, max_gt=16, dense_vertex_targets=False,
                           pool_size=10, fresh=2)
    assert len(g._pool) <= 10
    # per-draw noise: two draws over the same pool must differ even
    # with fresh=0 (anti scene-fingerprint-memorization)
    a = g.pooled_minibatch(4, max_gt=16, dense_vertex_targets=False,
                           pool_size=10, fresh=0)
    b = g.pooled_minibatch(4, max_gt=16, dense_vertex_targets=False,
                           pool_size=10, fresh=0)
    assert not np.allclose(a["data"], b["data"])


def test_pooled_minibatch_matches_fresh_contract():
    """Pooled batches expose the same keys/dtypes as minibatch() so
    the train step is agnostic to the feeder."""
    g = _gen(2)
    fresh = g.minibatch(2, max_gt=8, dense_vertex_targets=False)
    pooled = g.pooled_minibatch(2, max_gt=8, dense_vertex_targets=False,
                                pool_size=8, fresh=1)
    assert set(fresh) == set(pooled)
    for k in fresh:
        assert fresh[k].shape == pooled[k].shape, k
        assert fresh[k].dtype == pooled[k].dtype, k
