"""Render saved pose results over their source images.

Equivalent of the reference's pose-rendering tools
(ref: tools/render_poses.py / render_poses_color.py, which load saved
result .mat files and re-render the estimated poses with the OSMesa
refiner for visual inspection). Here the renderer is the headless
projected-box/point visualizer (utils/visualize.py — this
framework's replacement for the GL pose_refinement renderer,
ref lib/pose_refinement/refinement.cpp), and the inputs are this
framework's saved artifacts:

  - `detections.json` + `<frame>-label.npy` from cli/demo.py, or
  - `results_NNNN.npz` from cli/test_net.py --save_results.

Images come from --images (demo fixture layout `<frame>-color.png`)
or, for npz results, must be supplied in index order.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from posecnn_tpu.cli.common import base_parser, load_config, setup_device


def _load_extents_colors(args, cfg, num_classes):
    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator

    extents = None
    if args.dataset and args.data_root and os.path.isdir(args.data_root):
        from posecnn_tpu.core.registry import DATASETS

        ds = DATASETS.get(args.dataset)(args.data_root, "train")
        if hasattr(ds, "extents"):
            extents = np.asarray(ds.extents, np.float32)
    if extents is None:
        extents = np.full((num_classes, 3), 0.1, np.float32)
        extents[0] = 0
    colors = SyntheticSceneGenerator.make_class_colors(num_classes)
    return extents, colors


def main(argv=None):
    parser = base_parser("Render saved poses over images (ref: tools/render_poses.py)")
    parser.add_argument("--results", required=True, help="demo/test_net output dir")
    parser.add_argument("--images", default=None, help="image dir (demo layout)")
    parser.add_argument("--output", default="output/render_poses")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--num_classes", type=int, default=22)
    parser.add_argument("--fx", type=float, default=1066.778)
    parser.add_argument("--fy", type=float, default=1067.487)
    parser.add_argument("--cx", type=float, default=312.9869)
    parser.add_argument("--cy", type=float, default=241.3109)
    args = parser.parse_args(argv)
    setup_device(args)
    cfg = load_config(args)

    from posecnn_tpu.utils.visualize import (
        draw_detections,
        label_to_color,
        overlay_label,
        save_image,
    )

    os.makedirs(args.output, exist_ok=True)
    k = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]], np.float32)
    written = 0

    det_json = os.path.join(args.results, "detections.json")
    if os.path.exists(det_json):
        # demo-format results
        with open(det_json) as f:
            results = json.load(f)
        nc = max(
            [args.num_classes]
            + [d["class"] + 1 for r in results for d in r["detections"]]
        )
        extents, colors = _load_extents_colors(args, cfg, nc)
        for r in results:
            frame = r["frame"]
            img_path = None
            if args.images:
                img_path = os.path.join(args.images, f"{frame}-color.png")
            if img_path and os.path.exists(img_path):
                from PIL import Image

                rgb = np.asarray(Image.open(img_path).convert("RGB"), np.float32)
            else:
                lab_p = os.path.join(args.results, f"{frame}-label.npy")
                if not os.path.exists(lab_p):
                    continue
                lab = np.load(lab_p)
                rgb = label_to_color(lab, colors).astype(np.float32)
            dets = [
                (d["class"], np.asarray(d["quat_wxyz"], np.float32),
                 np.asarray(d["trans"], np.float32))
                for d in r["detections"]
            ]
            save_image(
                os.path.join(args.output, f"{frame}-poses.png"),
                draw_detections(rgb, dets, extents, k, colors),
            )
            lab_p = os.path.join(args.results, f"{frame}-label.npy")
            if os.path.exists(lab_p):
                save_image(
                    os.path.join(args.output, f"{frame}-label.png"),
                    overlay_label(rgb, np.load(lab_p), colors),
                )
            written += 1
    else:
        # test_net --save_results npz series
        npzs = sorted(glob.glob(os.path.join(args.results, "results_*.npz")))
        img_files = sorted(glob.glob(os.path.join(args.images, "*-color.png"))) if args.images else []
        extents = colors = None
        for i, path in enumerate(npzs):
            z = np.load(path)
            nc = int(z["label"].max()) + 1 if extents is None else extents.shape[0]
            if extents is None:
                extents, colors = _load_extents_colors(args, cfg, max(nc, args.num_classes))
            if i < len(img_files):
                from PIL import Image

                rgb = np.asarray(Image.open(img_files[i]).convert("RGB"), np.float32)
            else:
                rgb = label_to_color(z["label"], colors).astype(np.float32)
            dets = [
                (int(c), z["poses"][j, :4], z["poses"][j, 4:7])
                for j, c in enumerate(z["classes"])
            ]
            save_image(
                os.path.join(args.output, f"{i:04d}-poses.png"),
                draw_detections(rgb, dets, extents, k, colors),
            )
            written += 1
    print(f"wrote {written} pose renderings to {args.output}/")


if __name__ == "__main__":
    main()
