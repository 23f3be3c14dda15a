"""ADD/ADD-S loss vs a direct NumPy mirror of the reference CUDA
kernel (lib/average_distance_loss/average_distance_loss_op_gpu.cu.cc)."""

import jax
import jax.numpy as jnp
import numpy as np

from posecnn_tpu.ops.add_loss import average_distance_loss


def quat_to_mat_np(q):
    s, u, v, w = q
    return np.array(
        [
            [s * s + u * u - v * v - w * w, 2 * (u * v - s * w), 2 * (u * w + s * v)],
            [2 * (u * v + s * w), s * s - u * u + v * v - w * w, 2 * (v * w - s * u)],
            [2 * (u * w - s * v), 2 * (v * w + s * u), s * s - u * u - v * v + w * w],
        ]
    )


def np_add_loss(pred, target, weight, points, symmetry, margin):
    """Mirror of AveragedistanceForward (.cu.cc:35-206) + reductions."""
    n, c4 = pred.shape
    c = c4 // 4
    p = points.shape[1]
    total = 0.0
    for i in range(n):
        cls = -1
        for k in range(c):
            if weight[i, 4 * k] > 0:
                cls = k
                break
        if cls == -1:
            continue
        r_gt = quat_to_mat_np(target[i, 4 * cls : 4 * cls + 4])
        r_pr = quat_to_mat_np(pred[i, 4 * cls : 4 * cls + 4])
        pts = points[cls]
        x1 = pts @ r_pr.T
        x2 = pts @ r_gt.T
        for j in range(p):
            if symmetry[cls] > 0:
                d2 = ((x1[j] - x2) ** 2).sum(1)
                dmin = d2.min()
            else:
                dmin = ((x1[j] - x2[j]) ** 2).sum()
            if dmin >= margin:
                total += (dmin - margin) / (2.0 * n * p)
    return total


def make_quat(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def build_case(rng, n=6, c=3, p=64, sym=(0, 1, 0)):
    points = rng.randn(c, p, 3).astype(np.float32) * 0.1
    pred_q = make_quat(rng, n)
    tgt_q = make_quat(rng, n)
    pred = np.zeros((n, 4 * c), np.float32)
    tgt = np.zeros((n, 4 * c), np.float32)
    wgt = np.zeros((n, 4 * c), np.float32)
    for i in range(n - 1):  # last row left empty (padded RoI)
        cls = rng.randint(0, c)
        pred[i, 4 * cls : 4 * cls + 4] = pred_q[i]
        tgt[i, 4 * cls : 4 * cls + 4] = tgt_q[i]
        wgt[i, 4 * cls : 4 * cls + 4] = 1.0
    return pred, tgt, wgt, points, np.array(sym, np.float32)


def test_add_loss_matches_numpy_reference(rng):
    pred, tgt, wgt, points, sym = build_case(rng)
    loss = float(
        average_distance_loss(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(wgt),
            jnp.asarray(points), jnp.asarray(sym), margin=0.01,
        )
    )
    expect = np_add_loss(pred, tgt, wgt, points, sym, 0.01)
    np.testing.assert_allclose(loss, expect, rtol=2e-4, atol=1e-7)


def test_add_loss_zero_for_perfect_prediction(rng):
    pred, tgt, wgt, points, sym = build_case(rng, sym=(0, 0, 0))
    loss = float(
        average_distance_loss(
            jnp.asarray(tgt), jnp.asarray(tgt), jnp.asarray(wgt),
            jnp.asarray(points), jnp.asarray(sym), margin=0.01,
        )
    )
    assert loss == 0.0  # all distances 0 < margin → hinge kills everything


def test_add_loss_symmetric_less_or_equal(rng):
    pred, tgt, wgt, points, _ = build_case(rng, sym=(0, 0, 0))
    asym = float(
        average_distance_loss(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(wgt),
            jnp.asarray(points), jnp.asarray(np.zeros(3, np.float32)), margin=0.0,
        )
    )
    symm = float(
        average_distance_loss(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(wgt),
            jnp.asarray(points), jnp.asarray(np.ones(3, np.float32)), margin=0.0,
        )
    )
    assert symm <= asym + 1e-6  # nearest-neighbor match can only shrink


def test_add_loss_gradient_matches_numeric(rng):
    """Autodiff gradient == central finite differences of the hinged
    forward — validating the custom-backward-free design against the
    reference's analytic dR/dq backward."""
    pred, tgt, wgt, points, sym = build_case(rng, n=3, c=2, p=16, sym=(0, 1))

    def f(p_):
        return average_distance_loss(
            p_, jnp.asarray(tgt), jnp.asarray(wgt),
            jnp.asarray(points), jnp.asarray(sym), margin=0.001,
        )

    g = np.asarray(jax.grad(f)(jnp.asarray(pred)))
    eps = 1e-4
    for i in range(3):
        for j in range(8):
            dp = pred.copy()
            dp[i, j] += eps
            dm = pred.copy()
            dm[i, j] -= eps
            num = (float(f(jnp.asarray(dp))) - float(f(jnp.asarray(dm)))) / (2 * eps)
            np.testing.assert_allclose(g[i, j], num, rtol=2e-2, atol=1e-5)


def test_add_loss_num_valid_normalization(rng):
    """Padded-slot normalization: with num_valid=k the loss matches the
    reference computed on just the k real rows."""
    pred, tgt, wgt, points, sym = build_case(rng, n=6)
    k = 5  # rows 0..4 are real (build_case pads the last row)
    loss = float(
        average_distance_loss(
            jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(wgt),
            jnp.asarray(points), jnp.asarray(sym), margin=0.01,
            num_valid=jnp.asarray(float(k)),
        )
    )
    expect = np_add_loss(pred[:k], tgt[:k], wgt[:k], points, sym, 0.01)
    np.testing.assert_allclose(loss, expect, rtol=2e-4, atol=1e-7)


def test_add_loss_batched_equals_per_row(rng):
    """The hand-batched formulation (jit(grad(vmap)) miscompile
    workaround, see module docstring) must equal summing independent
    single-row calls — both in value and in gradient."""
    import jax

    pred, tgt, wgt, points, sym = build_case(rng, n=6)
    args = (jnp.asarray(points), jnp.asarray(sym))

    def batched(p):
        return average_distance_loss(
            p, jnp.asarray(tgt), jnp.asarray(wgt), *args,
            margin=0.01, num_valid=jnp.asarray(1.0),
        )

    def per_row(p):
        rows = [
            average_distance_loss(
                p[i : i + 1], jnp.asarray(tgt[i : i + 1]),
                jnp.asarray(wgt[i : i + 1]), *args,
                margin=0.01, num_valid=jnp.asarray(1.0),
            )
            for i in range(p.shape[0])
        ]
        return sum(rows)

    p = jnp.asarray(pred)
    np.testing.assert_allclose(float(batched(p)), float(per_row(p)), rtol=1e-5)
    gb = np.asarray(jax.grad(batched)(p))
    gr = np.asarray(jax.grad(per_row)(p))
    np.testing.assert_allclose(gb, gr, rtol=1e-4, atol=1e-6)
