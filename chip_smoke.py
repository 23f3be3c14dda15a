"""Smoke test of PoseCNN on one NVIDIA GPU, through the user entry points.

  python chip_smoke.py               # one card: serve, train, numerics
  python chip_smoke.py --four-cards  # four cards: sharded train step only

Everything runs in this one process (a JAX process reserves most of
the card's memory, so a second one could not start). Phases, each of
which must pass:

  serve     `cli.serve.main --bench 16` at 480×640, batch 1 and batch 4
            (the micro-batched path), full width: 22 classes, 64 skip
            units, fc 4096, Hough stride 1; prints each latency line.
  train     `cli.train_net.main` on the built-in synthetic generator at
            480×640, batch 2, fc 4096, vertex + pose regression: 3 steps
            with finite losses and a snapshot, then 1 more step after
            `--resume` from that snapshot; prints the step's
            `memory_analysis()` and the device's peak memory.
  numerics  the `gpu`-marked tests (tests/test_gpu_numerics.py), and the
            jit-vs-eager gradient parity of the pose loss.

With --four-cards it runs only the full-width sharded train step on a
data=4 mesh and on a data=2 × model=2 mesh, each against the one-card
step on the same batch and rng.

The card's name and power limit are printed first; the last line is
{"ok": true, "device": {...}} and appears only when every phase
passed. Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def require_gpu():
    """Import JAX on CUDA (the CPU beside it hosts the float32
    references) and return the first GPU, or exit non-zero."""
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    try:
        import jax

        jax.config.update("jax_platforms", "cuda,cpu")
        dev = jax.devices()[0]
    except RuntimeError as exc:  # no CUDA backend
        sys.exit(f"chip_smoke: no GPU: {exc}")
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: no GPU, JAX found {dev.platform}")
    return dev


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(name, t0):
    print(f"== {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)


def run_serve():
    from posecnn_tpu.cli import serve

    for batch in (1, 4):
        t0 = phase(f"serve batch {batch}")
        rc = serve.main([
            "--bench", "16", "--height", "480", "--width", "640",
            "--batch", str(batch), "--port", "0",
        ])
        if rc != 0:
            raise RuntimeError(f"serve --batch {batch} returned {rc}")
        done(f"serve batch {batch}", t0)


def run_train(out_dir):
    import jax
    import numpy as np

    from posecnn_tpu.cli import train_net

    common = [
        "--output", out_dir,
        "--set",
        "train.num_classes=22", "train.ims_per_batch=2",
        "train.syn_height=480", "train.syn_width=640",
        "train.fc_dim=4096", "train.num_units=64",
        "train.vertex_reg_2d=true", "train.pose_reg=true",
        "train.display=1", "train.snapshot_iters=3",
    ]
    t0 = phase("train 3 steps")
    train_net.main(["--iters", "3", *common])
    if not os.path.exists(os.path.join(out_dir, "posecnn_iter_3.npz")):
        raise RuntimeError("train: no snapshot at step 3")
    done("train 3 steps", t0)
    t0 = phase("train --resume 1 step")
    train_net.main(["--iters", "4", "--resume", *common])
    if not os.path.exists(os.path.join(out_dir, "posecnn_iter_4.npz")):
        raise RuntimeError("train --resume: no snapshot at step 4")
    done("train --resume 1 step", t0)

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["iter"] for r in rows] != [1, 2, 3, 4]:
        raise RuntimeError(f"train: logged iterations {[r['iter'] for r in rows]}")
    for r in rows:
        losses = {k: v for k, v in r.items() if k.startswith("loss")}
        if not losses or not all(np.isfinite(v) for v in losses.values()):
            raise RuntimeError(f"train: non-finite losses at iter {r['iter']}: {losses}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"train: device peak_bytes_in_use {stats.get('peak_bytes_in_use')}", flush=True)


def run_numerics():
    import pytest

    t0 = phase("gpu tests")
    rc = pytest.main([
        "-q", "-rP", "-m", "gpu", "-p", "no:cacheprovider",
        "--rootdir", ROOT, os.path.join(ROOT, "tests", "test_gpu_numerics.py"),
    ])
    if rc != 0:
        raise RuntimeError(f"gpu tests failed (pytest exit {rc})")
    done("gpu tests", t0)

    t0 = phase("jit-vs-eager gradient parity")
    gdiff, gref = gradient_parity()
    print(f"jit(grad) vs eager grad: max|diff| {gdiff:.3e}, scale {gref:.3e}", flush=True)
    if not gdiff <= 1e-3 * gref:
        raise RuntimeError("jit(grad) of the pose loss diverges from eager grad")
    done("jit-vs-eager gradient parity", t0)


def gradient_parity():
    """jit(grad) against op-by-op grad of the pose-head output path
    (class mask → L2-normalize → scaled-point hinged ADD loss), the
    composition a compiler once differentiated wrongly under jit while
    every host test passed. Both run the same float32 ops on the card,
    so they differ only by fusion: tolerance 1e-3 of the gradient."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from posecnn_tpu.data.procedural import synthetic_class_library
    from posecnn_tpu.engine.train import loss_point_scale
    from posecnn_tpu.ops.add_loss import average_distance_loss

    c, cls = 22, 3
    lib = synthetic_class_library(c, 512)
    pts, sym = loss_point_scale(
        jnp.asarray(lib.points), jnp.asarray(lib.extents),
        jnp.zeros(c, jnp.float32), jnp.asarray(True),
    )
    rng = np.random.RandomState(7)
    q_t = rng.randn(4)
    q_t /= np.linalg.norm(q_t)
    col = 4 * cls + np.arange(4)
    target = np.zeros((1, 4 * c), np.float32)
    target[0, col] = q_t
    weight = np.zeros((1, 4 * c), np.float32)
    weight[0, col] = 1.0

    def loss(x):
        row = jnp.zeros((1, 4 * c)).at[0, col].set(x)
        masked = row * weight
        norm = jnp.sqrt(jnp.sum(masked * masked, 1, keepdims=True) + 1e-12)
        return average_distance_loss(
            masked / norm, jnp.asarray(target), jnp.asarray(weight), pts, sym * 0,
            margin=0.01, num_valid=jnp.asarray(1.0),
        )

    x = jnp.asarray(rng.randn(4) * 0.3, jnp.float32)
    with jax.disable_jit():
        g_eager = jax.grad(loss)(x)
    g_jit = jax.jit(jax.grad(loss))(x)
    return float(jnp.max(jnp.abs(g_eager - g_jit))), float(jnp.max(jnp.abs(g_eager)))


def run_four_cards():
    """Full-width sharded train step vs one card, on 4 cards."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import sharded_step_parity

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, have {len(jax.devices())}")
    meshes = ((4, 1), (2, 2))
    t0 = phase("sharded train steps")
    update, results = sharded_step_parity(
        meshes, batch=4, num_classes=22, height=480, width=640, fc_dim=4096,
        num_units=64, hough_num_samples=256, max_objects=7, hough_cell_stride=1,
        compute_dtype=jnp.bfloat16,
    )
    print(f"one card, global batch 4: largest parameter update {update:.3e}", flush=True)
    for (num_data, num_model), (loss, dloss, dparam) in zip(meshes, results):
        name = f"data={num_data} x model={num_model}"
        print(f"{name}: loss {loss:.6f}, |Δloss| {dloss:.3e}, max|Δparam| {dparam:.3e}", flush=True)
        # the same bf16 step, its batch split over cards: each card's
        # weight gradient is rounded to bf16's 8-bit mantissa before the
        # cross-card sum, in another order than one card's. The loss (a
        # float32 mean) agrees to 1e-3 relative; a parameter may move by
        # up to a quarter of the largest update differently (4 H100s
        # read 0.7-1.0%, 4 virtual CPU devices 5-7%; a gradient missing
        # a card's share would differ by the whole update)
        if not (dloss <= 1e-3 * max(abs(loss), 1.0) and dparam <= 0.25 * update):
            raise RuntimeError(f"{name}: sharded step differs from one card")
    done("sharded train steps", t0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded train step on 4 cards against one card",
    )
    args = parser.parse_args(argv)

    dev = require_gpu()
    sys.path.insert(0, ROOT)
    from posecnn_tpu.cli.common import gpu_card_line, setup_device

    print(gpu_card_line(), flush=True)
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)
    setup_device()
    import jax

    if args.four_cards:
        run_four_cards()
    else:
        run_serve()
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            run_train(out_dir)
        run_numerics()
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
