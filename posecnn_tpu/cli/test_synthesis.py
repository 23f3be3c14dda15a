"""Synthesizer drive: render samples, report stats + throughput.

Equivalent of the reference's synthesizer inspection tools
(ref: tools/test_synthesis.py / test_synthesis_linemod.py /
test_synthesis_sym.py / test_synthesis_yumi.py and their
experiments/scripts/test_synthesis*.sh launchers, which drive
libsynthesizer.render and eyeball the output). Here the drive renders
N scenes from this framework's synthesizer (data/synthetic.py — the
offline replacement for the reference's live OpenGL render thread,
ref tools/train_net.py:304-317) and reports:

  - render throughput (scenes/s, the producer-side budget for the
    input pipeline);
  - per-class object frequency and foreground-pixel statistics;
  - pose-distribution sanity (translation range vs configured
    t_near/t_far, quaternion norm);
  - optional sample images (same artifact set as cli/check_data).

Uses real per-dataset model point clouds when the dataset root exists
(--dataset/--data_root); falls back to random clouds otherwise, so the
tool runs in any environment.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from posecnn_tpu.cli.common import base_parser, load_config, setup_device


def main(argv=None):
    parser = base_parser("Synthetic-scene generator check (ref: tools/test_synthesis*)")
    parser.add_argument("--output", default="output/test_synthesis")
    parser.add_argument("--num_samples", type=int, default=20)
    parser.add_argument("--dataset", default=None, help="registered dataset for real model clouds")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--num_points", type=int, default=512)
    parser.add_argument("--save_images", type=int, default=0, help="write the first N samples as PNGs")
    args = parser.parse_args(argv)
    setup_device(args)
    cfg = load_config(args)

    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator

    w, h = cfg.train.syn_width, cfg.train.syn_height
    points = extents = None
    if args.dataset and args.data_root and os.path.isdir(args.data_root):
        from posecnn_tpu.core.registry import DATASETS

        ds = DATASETS.get(args.dataset)(args.data_root, "train")
        if hasattr(ds, "subsampled_points"):
            points = ds.subsampled_points(args.num_points)
            extents = ds.extents
    if points is None:
        from posecnn_tpu.data.procedural import synthetic_class_library

        c = cfg.train.num_classes
        proc = synthetic_class_library(c, args.num_points)
        points, extents = proc.points, proc.extents
    c = points.shape[0]
    k = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(
        points, extents, k, width=w, height=h, t_near=cfg.train.syn_tnear,
        t_far=cfg.train.syn_tfar, pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
        point_colors=proc.colors, point_normals=proc.normals,
    )

    os.makedirs(args.output, exist_ok=True)
    class_freq = np.zeros(c, np.int64)
    fg_fracs, n_objs, tz_all, qnorm_all = [], [], [], []
    t0 = time.perf_counter()
    for i in range(args.num_samples):
        s = gen.render()
        cls = s.poses[:, 1].astype(int)
        class_freq[cls] += 1
        n_objs.append(len(cls))
        fg_fracs.append(float((s.label > 0).mean()))
        tz_all.extend(s.poses[:, 12].tolist())
        qnorm_all.extend(np.linalg.norm(s.poses[:, 6:10], axis=1).tolist())
        if i < args.save_images:
            from posecnn_tpu.utils.visualize import overlay_label, save_image

            rgb = np.clip(s.image + gen.pixel_means, 0, 255)[:, :, ::-1]
            save_image(os.path.join(args.output, f"{i:03d}-color.png"), rgb)
            save_image(
                os.path.join(args.output, f"{i:03d}-label.png"),
                overlay_label(rgb, s.label, gen.class_colors),
            )
    dt = time.perf_counter() - t0

    tz = np.asarray(tz_all)
    summary = dict(
        num_samples=args.num_samples,
        scenes_per_sec=round(args.num_samples / max(dt, 1e-9), 2),
        mean_objects_per_scene=float(np.mean(n_objs)),
        mean_fg_fraction=float(np.mean(fg_fracs)),
        class_frequency={int(i): int(f) for i, f in enumerate(class_freq) if f},
        tz_range=[float(tz.min()), float(tz.max())] if tz.size else None,
        tz_within_config=bool(
            tz.size and tz.min() >= cfg.train.syn_tnear - 1e-6
            and tz.max() <= cfg.train.syn_tfar + 1e-6
        ),
        max_quat_norm_err=float(np.abs(np.asarray(qnorm_all) - 1).max()) if qnorm_all else None,
    )
    with open(os.path.join(args.output, "synthesis_report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
