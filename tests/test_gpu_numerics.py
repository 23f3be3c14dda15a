"""Numerics on the GPU against float32/float64 host references.

These need a card and skip elsewhere. Run them with

  JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_numerics.py

(`chip_smoke.py` runs them in-process). The CPU device is the host
reference: a float32 run of the same JAX code.
"""

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def cpu():
    """The host device; skips the test unless JAX's default backend is
    a GPU and a CPU backend sits beside it."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu)")
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        pytest.skip("needs the CPU backend beside the GPU (JAX_PLATFORMS=cuda,cpu)")


def _sibling(name):
    """A helper module from this directory, loaded by path (a host may
    have an unrelated `tests` package installed)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name + ".py")
    spec = importlib.util.spec_from_file_location(f"_gpu_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _on(device, fn, *args):
    with jax.default_device(device):
        return jax.device_get(jax.jit(fn)(*jax.device_put(args, device)))


def test_add_s_gram_search_matches_numpy(cpu):
    """ADD-S nearest-neighbour search at the training widths (512 model
    points, 128 RoIs, every class symmetric) against the float64 NumPy
    mirror of the reference kernel. Tolerance rtol 1e-4: float32
    rounding of the distances is ~1e-6 relative, so only a changed
    nearest neighbour (a matmul run at reduced precision) can exceed it."""
    from posecnn_tpu.ops.add_loss import average_distance_loss

    ref = _sibling("test_add_loss")

    rng = np.random.RandomState(0)
    n, c, p = 128, 8, 512
    points = rng.randn(c, p, 3).astype(np.float32) * 0.1 * 10.0  # loss-scaled points
    pred = np.zeros((n, 4 * c), np.float32)
    tgt = np.zeros((n, 4 * c), np.float32)
    wgt = np.zeros((n, 4 * c), np.float32)
    qp, qt = ref.make_quat(rng, n), ref.make_quat(rng, n)
    for i in range(n):
        k = i % c
        pred[i, 4 * k:4 * k + 4] = qp[i]
        tgt[i, 4 * k:4 * k + 4] = qt[i]
        wgt[i, 4 * k:4 * k + 4] = 1.0
    sym = np.ones(c, np.float32)

    def loss(pred, tgt, wgt, points, sym):
        return average_distance_loss(pred, tgt, wgt, points, sym, margin=0.01)

    got = float(jax.jit(loss)(pred, tgt, wgt, points, sym))
    want = ref.np_add_loss(pred.astype(np.float64), tgt.astype(np.float64), wgt,
                       points.astype(np.float64), sym, 0.01)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_icp_matches_host_float32(cpu):
    """Batched ICP refinement (8 depth hypotheses × 8 Gauss-Newton
    steps) on the GPU against the same code on the host. The 6×6
    normal equations are pinned to full float32; what remains is their
    conditioning: JᵀJ spans 4-5 decades on a front-facing surface, so
    float32 rounding (6e-8) in another summation order and another LU
    moves the weakly observed twist directions by up to ~1e-3 per
    solve. Tolerance: 5e-3 in the quaternion (0.6°) and 2 mm in the
    translation; TF32 normal equations (1e-3 rounding) would miss both
    by orders of magnitude."""
    from posecnn_tpu.refine.icp import refine_pose_icp

    scene = _sibling("test_icp")

    rng = np.random.RandomState(3)
    pts = scene.make_model(rng)
    t_gt = np.array([0.05, -0.02, 0.9], np.float32)
    depth = scene.render_depth(pts, scene.BASE_Q, t_gt)
    args = (
        np.asarray(scene.BASE_Q, np.float32), t_gt + np.array([0.015, 0.01, 0.03], np.float32),
        pts, depth, depth > 0, scene.K,
    )

    def run(q, t, pts, depth, mask, k):
        res = refine_pose_icp(q, t, pts, depth, mask, k, num_iters=8)
        return res.quat, res.trans

    q_gpu, t_gpu = _on(jax.devices()[0], run, *args)
    q_cpu, t_cpu = _on(cpu, run, *args)
    print("icp gpu-host max|Δq|", np.max(np.abs(q_gpu - q_cpu)),
          "max|Δt| m", np.max(np.abs(t_gpu - t_cpu)))
    np.testing.assert_allclose(q_gpu, q_cpu, atol=5e-3)
    np.testing.assert_allclose(t_gpu, t_cpu, atol=2e-3)


def test_roi_align_matmul_and_gather_match_host(cpu):
    """Both RoI-Align formulations on bf16 conv4/conv5-sized features
    (2 × 60×80×512 and 2 × 30×40×512, 128 RoIs) against the gather
    formulation in float32 on the host. bf16 keeps 8 bits of mantissa,
    so each bilinear weight and product carries ~0.4% relative error:
    tolerance 2% of the feature scale."""
    from posecnn_tpu.ops.roi_align import roi_align, roi_align_mxu

    rng = np.random.RandomState(1)
    r = 128
    rois = np.zeros((r, 7), np.float32)
    rois[:, 0] = rng.randint(0, 2, r)
    x1, y1 = rng.uniform(-20, 600, r), rng.uniform(-20, 440, r)
    rois[:, 2], rois[:, 3] = x1, y1
    rois[:, 4] = x1 + rng.uniform(8, 200, r)
    rois[:, 5] = y1 + rng.uniform(8, 160, r)
    for hw, scale in (((60, 80), 1 / 8.0), ((30, 40), 1 / 16.0)):
        feats = rng.randn(2, *hw, 512).astype(np.float32) * 20.0
        ref = _on(cpu, lambda f, r_: roi_align(f, r_, spatial_scale=scale), feats, rois)
        bf = feats.astype(jnp.bfloat16)
        for fn in (roi_align, roi_align_mxu):
            got = jax.jit(lambda f, r_: fn(f, r_, spatial_scale=scale))(bf, rois)
            err = np.max(np.abs(np.asarray(got, np.float32) - ref))
            assert err <= 0.02 * np.max(np.abs(ref)), (fn.__name__, scale, err)


def _scene(objects, h=480, w=640, num_classes=22):
    """Analytic full-size scene: each object's pixels point exactly at
    its centre with its depth (the layout of tests/test_hough_voting)."""
    label = np.zeros((h, w), np.int32)
    vert = np.zeros((h, w, 3 * num_classes), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for cls, cx, cy, depth, hw, hh in objects:
        mask = (np.abs(xs - cx) <= hw) & (np.abs(ys - cy) <= hh)
        dx, dy = cx - xs, cy - ys
        n = np.sqrt(dx * dx + dy * dy) + 1e-10
        label[mask] = cls
        vert[mask, 3 * cls] = (dx / n)[mask]
        vert[mask, 3 * cls + 1] = (dy / n)[mask]
        vert[mask, 3 * cls + 2] = np.log(depth)
    return label, vert


def test_hough_kernel_matches_dense_path(cpu, monkeypatch):
    """The coarse-to-fine Triton kernels against the dense XLA vote at
    the serving widths (480×640, stride 1, 1024 samples, 8 class
    slots), batch 2, objects from 61 px wide to a whole quarter frame,
    at the image border.
    Both count the same cone tests; vote totals may differ in the last
    float bits (sum order), so boxes are compared at 1e-3 px."""
    hv = importlib.import_module("posecnn_tpu.ops.hough_voting")
    scenes = [
        # the 21×21 px object is below label_threshold (500 px): dropped
        [(1, 120.0, 100.0, 0.8, 60, 50), (5, 400.0, 300.0, 1.4, 40, 30),
         (9, 600.0, 60.0, 1.1, 30, 40), (14, 20.0, 460.0, 2.0, 10, 10)],
        [(3, 320.0, 240.0, 1.0, 120, 90), (21, 500.0, 400.0, 1.6, 25, 25)],
    ]
    labels, verts = zip(*(_scene(s) for s in scenes))
    rng = np.random.RandomState(0)
    extents = np.abs(rng.randn(22, 3)).astype(np.float32) * 0.1 + 0.05
    meta = np.zeros((2, 48), np.float32)
    k = np.array([[1066.8, 0, 313.0], [0, 1067.5, 241.3], [0, 0, 1]], np.float32)
    meta[:, :9] = k.flatten()
    meta[:, 9:18] = np.linalg.inv(k).flatten()
    args = (np.stack(labels), np.stack(verts), extents, meta)

    def run(label, vert, ext, meta):
        out = hv.hough_voting(label, vert, ext, meta, num_samples=1024,
                              max_objects_per_image=16, cell_stride=1)
        return out.rois, out.poses_init, out.valid

    kernel = jax.device_get(jax.jit(run)(*args))
    monkeypatch.setattr(hv, "_kernel_slot_max", lambda vote_threshold: None)
    dense = jax.device_get(jax.jit(run)(*args))
    np.testing.assert_array_equal(kernel[2], dense[2])
    assert kernel[2].sum() == 5
    v = dense[2]
    np.testing.assert_allclose(kernel[0][v], dense[0][v], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(kernel[1][v], dense[1][v], rtol=1e-5, atol=1e-5)
