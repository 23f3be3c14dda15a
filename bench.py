"""Benchmark: PoseCNN single-frame inference on one GPU.

Prints the card (`nvidia-smi` name and power limit) and the JAX device
first, then ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "hough_ms": N,
   "hough_share": N, ...}

Metric: frames/sec of the full PoseCNN inference graph (VGG16 trunk +
seg + vertex + Hough voting + RoI pose head) at YCB-Video resolution
480×640, 21+1 classes, with the serving path's Hough settings
(cfg.test.hough_num_samples, 16 objects, stride 1) — the reference's
`im_segment_single_frame` hot path (ref: lib/fcn/test.py:113-239,
timed at test.py:1429-1430). Weights are random from a fixed seed and
the input is noise, so every Hough class slot is active: Hough's worst
case.

Timing: each call is synchronized with `block_until_ready`; the median
over ITERS calls after a warm-up is reported. `hough_ms` times
`hough_voting` alone on the graph's own label and vertex maps
(full-resolution vertex map), and `hough_share` divides it by the
graph time. Exits non-zero without printing a result when JAX finds
no GPU.

vs_baseline: the PoseCNN reference runs ~10 fps (0.1 s/frame) on a
V100-class GPU for this path (BASELINE.md); vs_baseline = fps / 10.
"""

import json
import sys
import time

import numpy as np

ITERS = 50


def median_ms(fn, args, iters: int = ITERS, warmup: int = 3) -> float:
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1000.0


def main() -> int:
    from posecnn_tpu.cli.common import gpu_card_line, setup_device

    setup_device()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform}", file=sys.stderr)
        return 1
    print(gpu_card_line(), flush=True)
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}", flush=True)

    from __graft_entry__ import _make_inputs
    from posecnn_tpu.core.config import Config
    from posecnn_tpu.models import PoseCNN
    from posecnn_tpu.ops.hough_voting import hough_voting

    num_classes, height, width = 22, 480, 640
    samples = Config().test.hough_num_samples
    model = PoseCNN(
        num_classes=num_classes,
        num_units=64,
        hough_num_samples=samples,
        max_objects=16,
        hough_cell_stride=1,  # reference-exact Hough resolution
        vote_threshold=-1.0,
    )
    inp = _make_inputs(1, height, width, num_classes)
    params = model.init(
        jax.random.PRNGKey(0), inp["data"], inp["extents"], inp["meta"], train=False
    )

    @jax.jit
    def graph(params, data, extents, meta):
        out = model.apply(params, data, extents, meta, train=False)
        return out.label_2d, out.hough.rois, out.poses_pred

    @jax.jit
    def hough_inputs(params, data, extents, meta):
        out = model.apply(params, data, extents, meta, train=False)
        return out.label_2d, out.vertex_pred

    @jax.jit
    def hough(label, vertex, extents, meta):
        return hough_voting(
            label, vertex, extents, meta, num_samples=samples,
            max_objects_per_image=16, cell_stride=1,
        ).rois

    t0 = time.perf_counter()
    g_args = (params, inp["data"], inp["extents"], inp["meta"])
    jax.block_until_ready(graph(*g_args))
    label, vertex = hough_inputs(*g_args)
    h_args = (label, vertex, inp["extents"], inp["meta"])
    jax.block_until_ready(hough(*h_args))
    compile_s = time.perf_counter() - t0

    graph_ms = median_ms(graph, g_args)
    hough_ms = median_ms(hough, h_args)
    fps = 1000.0 / graph_ms
    print(
        json.dumps(
            {
                "metric": "posecnn_inference_fps_480x640_22cls_b1",
                "value": fps,
                "unit": "frames/sec",
                "graph_ms": graph_ms,
                "hough_ms": hough_ms,
                "hough_share": hough_ms / graph_ms,
                "hough_num_samples": samples,
                "compile_s": compile_s,
                "vs_baseline": fps / 10.0,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
