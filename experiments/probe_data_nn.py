"""Data-side rotation observability probe: NN-in-pixel-space oracle.

No training involved — this bounds what ANY learner can extract from
the rendered appearance. Renders N single-object scenes of one class
(same generator/config as the rotation probe), crops each GT box,
resizes to a small canonical patch, and asks: does nearest-neighbor in
raw pixel space recover rotation? Report the mean geodesic error of
the NN's rotation on a held-out split vs the random-rotation chance
level (~126.8 deg for uniform SO(3)).

- NN error well below chance  -> appearance encodes rotation; the
  failure of the trained probes is an optimization/architecture
  problem.
- NN error at chance          -> the rendered appearance does NOT
  determine rotation (paint too weak / aliased / shading-dominated);
  no training recipe can fix that — fix the renderer.

Also dumps a visual contact sheet (same object at stepped rotations
about each axis) to output/probe_nn_sheet.png for eyeballing.

Usage: python experiments/probe_data_nn.py --n 3000 --device cpu
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def resize_patch(img, out=32):
    """Cheap bilinear resize via np interpolation (H,W,3)->(out,out,3)."""
    h, w = img.shape[:2]
    if h < 2 or w < 2:
        return np.zeros((out, out, img.shape[2]), np.float32)
    yi = np.linspace(0, h - 1, out)
    xi = np.linspace(0, w - 1, out)
    y0 = np.floor(yi).astype(int); y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.floor(xi).astype(int); x1 = np.minimum(x0 + 1, w - 1)
    fy = (yi - y0)[:, None, None]
    fx = (xi - x0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx)
    b = img[y0][:, x1] * (1 - fy) * fx
    c = img[y1][:, x0] * fy * (1 - fx)
    d = img[y1][:, x1] * fy * fx
    return (a + b + c + d).astype(np.float32)


def geodesic_deg(q1, q2):
    from posecnn_tpu.utils.quaternion import quat_to_mat_np

    r1, r2 = quat_to_mat_np(q1), quat_to_mat_np(q2)
    cos = (np.trace(r1.T @ r2) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3000)
    ap.add_argument("--holdout", type=int, default=300)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--cls_index", type=int, default=1)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--data_root", default="/root/reference/data/LOV")
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--backgrounds", default="output/bg_pool/*.png")
    ap.add_argument("--out", default="output/probe_data_nn.json")
    ap.add_argument("--paint_version", type=int, default=3)
    ap.add_argument(
        "--quantize", action="store_true",
        help="round-trip each crop through the uint8 compact feed "
        "(pipeline.compact_feed semantics) before NN matching — "
        "isolates whether uint8 quantization costs rotation signal",
    )
    args = ap.parse_args()

    # pure-host probe — no accelerator needed
    import jax

    jax.config.update("jax_platforms", "cpu")

    from posecnn_tpu.core.config import cfg_from_file
    from posecnn_tpu.data.datasets import YCBVideoDataset
    from posecnn_tpu.data.procedural import (
        colorize_model_library,
        load_background_pool,
    )
    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator

    cfg = cfg_from_file("experiments/cfgs/rot_probe.yaml")
    ds = YCBVideoDataset(args.data_root, "train")
    points, extents = ds.points, ds.extents
    point_colors, point_normals = colorize_model_library(
        points, orient_detail=True, paint_version=args.paint_version
    )
    k = np.array(
        [[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]],
        np.float32,
    )
    bg = None
    if args.backgrounds:
        import glob

        bg = load_background_pool(
            sorted(glob.glob(args.backgrounds)),
            size_hw=(args.height, args.width),
        )
    gen = SyntheticSceneGenerator(
        points, extents, k, width=args.width, height=args.height,
        t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
        pixel_means=cfg.pixel_means, seed=args.seed,
        class_whitelist=[args.cls_index],
        point_colors=point_colors, point_normals=point_normals,
        backgrounds=bg,
    )

    patches, quats = [], []
    tries = 0
    while len(patches) < args.n and tries < args.n * 3:
        tries += 1
        b = gen.minibatch(1, dense_vertex_targets=False)
        gt = b["gt_poses"]
        gv = b["gt_valid"]
        img = b["data"][0]  # (H,W,3) mean-subtracted BGR
        if args.quantize:
            pm = np.asarray(cfg.pixel_means, np.float32)
            img = np.clip(img + pm, 0, 255).astype(np.uint8).astype(np.float32) - pm
        for i in range(gt.shape[0]):
            if not gv[i]:
                continue
            # crop the GT projected box (same projection train uses)
            from posecnn_tpu.ops.hough_voting import _gt_projected_boxes
            import jax.numpy as jnp

            box = np.asarray(
                _gt_projected_boxes(
                    jnp.asarray(gt[i : i + 1]), jnp.asarray(extents),
                    k[0, 0], k[1, 1], k[0, 2], k[1, 2],
                )[0]
            )
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            x1 = max(x1, 0); y1 = max(y1, 0)
            x2 = min(x2, args.width); y2 = min(y2, args.height)
            if x2 - x1 < 8 or y2 - y1 < 8:
                continue
            patches.append(resize_patch(img[y1:y2, x1:x2], args.patch))
            quats.append(gt[i, 6:10].copy())
            break
    patches = np.stack(patches)
    quats = np.stack(quats)
    n = len(patches)
    print(f"rendered {n} crops")

    flat = patches.reshape(n, -1)
    flat = flat - flat.mean(axis=1, keepdims=True)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True) + 1e-9

    ho = args.holdout
    train_f, test_f = flat[ho:], flat[:ho]
    train_q, test_q = quats[ho:], quats[:ho]

    # cosine NN via one big matmul
    sims = test_f @ train_f.T
    nn_idx = np.argmax(sims, axis=1)

    rng = np.random.RandomState(0)
    errs_nn, errs_rand = [], []
    for i in range(ho):
        errs_nn.append(geodesic_deg(test_q[i], train_q[nn_idx[i]]))
        errs_rand.append(
            geodesic_deg(test_q[i], train_q[rng.randint(len(train_q))])
        )
    rec = {
        "metric": "data_nn_rotation_oracle",
        "n_train": n - ho,
        "n_test": ho,
        "patch": args.patch,
        "nn_mean_deg": round(float(np.mean(errs_nn)), 1),
        "nn_median_deg": round(float(np.median(errs_nn)), 1),
        "nn_below_45": int(np.sum(np.asarray(errs_nn) < 45.0)),
        "chance_mean_deg": round(float(np.mean(errs_rand)), 1),
    }
    print(json.dumps(rec, indent=1))
    os.makedirs("output", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)

    # contact sheet: the object at stepped rotations about each axis,
    # rendered directly via the generator's splatter (fixed light,
    # fixed translation) — the literal image the paint produces
    from posecnn_tpu.utils.quaternion import quat_to_mat_np

    light = np.array([0.2, -0.3, -0.9], np.float32)
    light /= np.linalg.norm(light)
    tvec = np.array(
        [
            (args.width / 2 - k[0, 2]) / k[0, 0],
            (args.height / 2 - k[1, 2]) / k[1, 1],
            1.0,
        ],
        np.float32,
    )
    sheet_rows = []
    for axis in range(3):
        row = []
        for stepi in range(8):
            ang = stepi * np.pi / 4
            axv = np.zeros(3); axv[axis] = 1.0
            q = np.concatenate(
                [[np.cos(ang / 2)], np.sin(ang / 2) * axv]
            ).astype(np.float32)
            depth = np.full((args.height, args.width), np.inf, np.float32)
            label = np.zeros((args.height, args.width), np.int32)
            image = np.zeros((args.height, args.width, 3), np.float32)
            gen._splat_object(
                args.cls_index, quat_to_mat_np(q), tvec,
                depth, label, image, light,
            )
            row.append(resize_patch(image, 96))
        sheet_rows.append(np.concatenate(row, axis=1))
    sheet = np.concatenate(sheet_rows, axis=0)
    sheet = np.clip(sheet[:, :, ::-1], 0, 255).astype(np.uint8)  # BGR->RGB
    try:
        from PIL import Image

        Image.fromarray(sheet).save("output/probe_nn_sheet.png")
        print("contact sheet -> output/probe_nn_sheet.png")
    except ImportError:
        np.save("output/probe_nn_sheet.npy", sheet)
        print("PIL absent; sheet -> output/probe_nn_sheet.npy")


if __name__ == "__main__":
    main()
