"""Evaluate PoseCNN (ref: tools/test_net.py:90-142 →
lib/fcn/test.py:1154-1467 test_net_single_frame).

Without real dataset frames, --dataset synthetic evaluates on held-out
synthetic scenes (same generator, different seed) — the full
inference + NMS + (optional) ICP + metric pipeline runs end-to-end
and reports seg IoU + ADD/ADD-S AUC + success rates.
"""

from __future__ import annotations

import json
import os

import numpy as np

from posecnn_tpu.cli.common import base_parser, load_config, setup_device


def _eval_backgrounds(args, size_hw):
    """Held-out eval renders with the SAME background-compositing pool
    training used (cli/train_net._load_backgrounds) so the eval
    distribution matches the train distribution; the real-frame demo
    measures the domain gap separately."""
    import glob

    pattern = getattr(args, "backgrounds", None)
    if not pattern:
        return None
    from posecnn_tpu.data.procedural import load_background_pool

    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(
            f"--backgrounds {pattern!r} matched no files; run "
            "`python experiments/gen_backgrounds.py` to build the "
            "procedural pool, or pass --backgrounds '' to eval "
            "without compositing explicitly"
        )
    return load_background_pool(files, size_hw=size_hw)


def main(argv=None):
    parser = base_parser("PoseCNN evaluation (ref: tools/test_net.py)")
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--data_root", default="/root/reference/data/LOV")
    parser.add_argument("--image_set", default="val")
    parser.add_argument(
        "--cls", default="",
        help="LINEMOD object name for --dataset linemod (ape, eggbox, …)",
    )
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--output", default="output/eval")
    parser.add_argument("--num_images", type=int, default=20)
    parser.add_argument("--refine", action="store_true")
    parser.add_argument(
        "--ransac", action="store_true",
        help="re-estimate translation via RANSAC center voting instead "
        "of the Hough maximum (ref: lib/pose_estimation/ransac3D.cpp "
        "estimateCenter path)",
    )
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument(
        "--backgrounds",
        default="",
        help="background compositing pool for synthetic eval frames "
        "(default: none) — keep it the SAME pool training used (mirror of train_net "
        "--backgrounds; r4 evaluated against the 5 demo frames while "
        "training composited the procedural pool, so eval measured a "
        "background domain shift, not model quality). Empty disables",
    )
    parser.add_argument(
        "--instance_matching", action="store_true",
        help="greedy per-instance det/GT matching instead of the "
        "reference's one-detection-per-class assumption "
        "(lov.py:451-516) — for multi-instance scenes",
    )
    parser.add_argument(
        "--save_results", action="store_true",
        help="write per-image results_NNNN.npz (label, rois, poses) — "
        "the reference's per-image .mat artifacts (ref: lov.py:432-439)",
    )
    args = parser.parse_args(argv)
    setup_device(args)
    cfg = load_config(args)
    if cfg.network == "posecnn_det":
        return _detection_eval(args, cfg)

    import jax
    import jax.numpy as jnp

    from posecnn_tpu.core.checkpoint import restore_params
    from posecnn_tpu.data.datasets import YCBVideoDataset
    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator
    from posecnn_tpu.engine.evaluate import PoseEvaluator, extract_detections
    from posecnn_tpu.models import PoseCNN
    from posecnn_tpu.ops.nms import nms_per_class

    c = cfg.train.num_classes
    ds = None
    point_colors = point_normals = None
    # class geometry: real YCB models when available, else synthetic —
    # MUST mirror train_net's resolution exactly or restore() keeps
    # template heads on a class-count mismatch
    lm_diameters = None
    lm_zflip = ()
    lm_k = None
    if args.dataset == "linemod":
        # mirror train_net's 2-class LINEMOD geometry EXACTLY
        from posecnn_tpu.data.datasets import LinemodDataset
        from posecnn_tpu.data.procedural import fill_missing_points

        lm = LinemodDataset(args.data_root, args.image_set, cls=args.cls)
        ci = list(lm.classes).index(args.cls) if args.cls else 1
        from posecnn_tpu.cli.common import data_flags_from_ckpt

        pts_all, cols_all, nrms_all = fill_missing_points(
            lm.points, lm.extents, **data_flags_from_ckpt(cfg, args.ckpt)
        )
        c = 2
        points_full = np.stack([pts_all[0], pts_all[ci]])
        extents = np.stack([lm.extents[0], lm.extents[ci]])
        symmetry = np.asarray([0.0, lm.symmetry[ci]], np.float32)
        point_colors = np.stack([cols_all[0], cols_all[ci]])
        point_normals = np.stack([nrms_all[0], nrms_all[ci]])
        adi_classes = (1,) if lm.symmetry[ci] > 0 else ()
        k = lm.intrinsic_matrix
        lm_k = k
        lm_diameters = np.asarray([0.0, lm.diameters[ci]], np.float32)
        lm_zflip = (1,) if ci in lm.z_flip_classes else ()
        width, height = cfg.train.syn_width, cfg.train.syn_height
    elif args.dataset in ("ycb_video", "lov") or (
        args.dataset == "synthetic"
        and os.path.exists(os.path.join(args.data_root, "models"))
    ):
        ds = YCBVideoDataset(args.data_root, args.image_set)
        c = ds.num_classes
        points_full, extents = ds.points, ds.extents
        symmetry = np.asarray(ds.symmetry)
        # same synthesized appearance as training (xyz-only models)
        from posecnn_tpu.data.procedural import colorize_model_library

        from posecnn_tpu.cli.common import data_flags_from_ckpt

        point_colors, point_normals = colorize_model_library(
            points_full, **data_flags_from_ckpt(cfg, args.ckpt)
        )
        adi_classes = ds.adi_classes
        k = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]], np.float32)
        # real frames are 640×480; synthetic eval mirrors the training
        # resolution (train_net renders at cfg.train.syn_*)
        real_frames = len(ds.image_index) > 0 and os.path.exists(
            ds.frame_prefix(ds.image_index[0]) + "-color.png"
        )
        if real_frames and not cfg.test.synthetic:
            width, height = 640, 480
        else:
            width, height = cfg.train.syn_width, cfg.train.syn_height
    else:
        # canonical procedural library — SAME geometry/texture as
        # training (data/procedural.synthetic_class_library)
        from posecnn_tpu.data.procedural import synthetic_class_library

        proc = synthetic_class_library(c, 2620)
        points_full, extents, symmetry = proc.points, proc.extents, proc.symmetry
        point_colors, point_normals = proc.colors, proc.normals
        adi_classes = tuple(int(i) for i in np.nonzero(proc.symmetry)[0])
        width, height = cfg.train.syn_width, cfg.train.syn_height
        k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]], np.float32)

    # TEST.SCALES_BASE (ref: config.py, test.py _get_image_blob):
    # evaluate at a rescaled resolution; intrinsics scale with pixels
    scale_base = float(cfg.test.scales_base[0]) if cfg.test.scales_base else 1.0
    k_unscaled = k
    if scale_base != 1.0:
        width = int(round(width * scale_base))
        height = int(round(height * scale_base))
        k = k.copy()
        k[:2, :] *= scale_base

    gen = SyntheticSceneGenerator(
        points_full, extents, k, width=width, height=height,
        t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
        pixel_means=cfg.pixel_means, seed=args.seed,
        point_colors=point_colors, point_normals=point_normals,
        backgrounds=_eval_backgrounds(args, (height, width)),
    )
    idxp = np.linspace(0, points_full.shape[1] - 1, cfg.train.add_num_points).astype(int)
    points = points_full[:, idxp]

    rgbd = cfg.input == "RGBD"
    from posecnn_tpu.cli.common import head_flags_from_ckpt

    model = PoseCNN(
        num_classes=c,
        num_units=cfg.train.num_units,
        fc_dim=cfg.train.fc_dim,
        **head_flags_from_ckpt(cfg, args.ckpt),
        compute_dtype=jnp.dtype(cfg.compute_dtype),
        input_format="RGBD" if rgbd else "COLOR",
        hough_num_samples=cfg.test.hough_num_samples,
        skip_pixels=cfg.test.hough_skip_pixels,
        max_objects=8,
        # multi-instance local-max mode when the config gates votes
        # (ref: TEST.VOTING_THRESHOLD, lib/fcn/config.py:216)
        vote_threshold=cfg.test.voting_threshold,
    )
    data0 = jnp.zeros((1, height, width, 3), jnp.float32)
    meta0 = np.zeros((1, 48), np.float32)
    meta0[0, :9] = k.flatten()
    meta0[0, 9:18] = np.linalg.inv(k).flatten()
    meta0 = jnp.asarray(meta0)
    params = model.init(
        jax.random.PRNGKey(cfg.rng_seed), data0, jnp.asarray(extents), meta0,
        data_p=data0 if rgbd else None, train=False,
    )
    if args.ckpt:
        params, step = restore_params(args.ckpt, params)
        print(f"restored checkpoint at step {step}")

    @jax.jit
    def infer(params, data, meta, data_p=None):
        out = model.apply(
            params, data, jnp.asarray(extents), meta, data_p=data_p, train=False
        )
        keep = nms_per_class(out.hough.rois, cfg.test.nms_threshold, out.hough.valid)
        return (
            out.label_2d, out.hough.rois, out.hough.poses_init,
            out.poses_pred, keep, out.vertex_pred,
        )

    use_ransac = args.ransac or cfg.test.ransac

    def ransac_translation(lab, vp, dets, kk, key):
        """Replace each detection's translation with a RANSAC center
        re-estimate from the vertex directions + voted depth (ref:
        ransac3D.cpp estimateCenter; alt path to the Hough maximum)."""
        from posecnn_tpu.refine.ransac import estimate_center

        n_fix = 1024
        out_dets = []
        for di, (cls, q, t) in enumerate(dets):
            ys, xs = np.nonzero(lab == cls)
            if len(ys) < 10:
                out_dets.append((cls, q, t))
                continue
            sel = np.linspace(0, len(ys) - 1, min(len(ys), n_fix)).astype(int)
            m = len(sel)
            px_xy = np.zeros((n_fix, 2), np.float32)
            dirs = np.zeros((n_fix, 2), np.float32)
            valid = np.zeros((n_fix,), bool)
            px_xy[:m] = np.stack([xs[sel], ys[sel]], 1)
            dirs[:m] = vp[ys[sel], xs[sel], 3 * cls : 3 * cls + 2]
            valid[:m] = True
            zs = np.exp(vp[ys[sel], xs[sel], 3 * cls + 2])
            est = estimate_center(
                jnp.asarray(px_xy), jnp.asarray(dirs), jnp.asarray(valid),
                jax.random.fold_in(key, di),
            )
            cxy = np.asarray(est.center)
            z = float(np.median(zs))
            t_new = np.array(
                [
                    (cxy[0] - kk[0, 2]) / kk[0, 0] * z,
                    (cxy[1] - kk[1, 2]) / kk[1, 1] * z,
                    z,
                ],
                np.float32,
            )
            out_dets.append((cls, q, t_new))
        return out_dets

    evaluator = PoseEvaluator(
        num_classes=c, points=points, extents=extents,
        symmetric_classes=tuple(adi_classes),
        instance_matching=args.instance_matching,
        # LINEMOD metrics: 0.1·diameter success + reproj<5px + the
        # eggbox 180°-Z-flip retry (ref: linemod.py:626-830)
        diameters=lm_diameters,
        z_flip_classes=lm_zflip,
        intrinsics=lm_k,
    )

    img_counter = [0]

    def run_one(image_blob, meta, depth_m, gt_label, gts, image_blob_p=None):
        label, rois, poses_init, poses_pred, keep, vertex_pred = infer(
            params, jnp.asarray(image_blob[None]), jnp.asarray(meta[None]),
            jnp.asarray(image_blob_p[None]) if image_blob_p is not None else None,
        )
        dets = extract_detections(rois, poses_init, poses_pred, np.asarray(keep), c)
        if use_ransac and dets:
            dets = ransac_translation(
                np.asarray(label[0]), np.asarray(vertex_pred[0]), dets,
                meta[:9].reshape(3, 3), jax.random.PRNGKey(args.seed),
            )
        if args.save_results:
            os.makedirs(args.output, exist_ok=True)
            np.savez_compressed(
                os.path.join(args.output, f"results_{img_counter[0]:04d}.npz"),
                label=np.asarray(label[0], np.int32),
                rois=np.asarray(rois),
                keep=np.asarray(keep),
                poses=np.asarray([np.concatenate([q, t]) for _, q, t in dets])
                if dets else np.zeros((0, 7), np.float32),
                classes=np.asarray([cls for cls, _, _ in dets], np.int32),
            )
        img_counter[0] += 1
        if args.refine and depth_m is not None:
            from posecnn_tpu.refine.icp import refine_pose_icp

            lab = np.asarray(label[0])
            kk = meta[:9].reshape(3, 3)
            refined = []
            for cls, q, t in dets:
                res = refine_pose_icp(
                    jnp.asarray(q), jnp.asarray(t), jnp.asarray(points[cls]),
                    jnp.asarray(depth_m), jnp.asarray(lab == cls), jnp.asarray(kk),
                    num_iters=cfg.test.icp_iters,
                    num_hypotheses=cfg.test.icp_hypotheses,
                    rot_perturb=cfg.test.icp_rot_perturb,
                )
                refined.append((cls, np.asarray(res.quat), np.asarray(res.trans)))
            dets = refined
        if gt_label is not None:
            evaluator.add_segmentation(gt_label, np.asarray(label[0]))
        evaluator.add_image(dets, gts)

    # TEST.SYNTHETIC forces synthetic-frame evaluation even when real
    # frames exist (ref: lib/fcn/test.py:1169,1195,1212)
    have_real = (
        not cfg.test.synthetic
        and ds is not None
        and len(ds.image_index) > 0
        and os.path.exists(ds.frame_prefix(ds.image_index[0]) + "-color.png")
    )
    if have_real:
        # real-frame eval loop (ref: test_net_single_frame
        # lib/fcn/test.py:1154-1467)
        from posecnn_tpu.data.minibatch import (
            build_image_blobs, build_meta_blob, mat_to_quat_np, _fit_hw,
            resize_bilinear, resize_nearest,
        )

        for index in ds.image_index[: args.num_images]:
            frame = ds.load_frame(index)
            kf = np.array(frame.get("intrinsic_matrix", k_unscaled), np.float32)
            color = frame["color"][..., :3]
            depth_raw = frame.get("depth_raw")
            if scale_base != 1.0:
                color = resize_bilinear(color, scale_base).astype(color.dtype)
                if depth_raw is not None:
                    depth_raw = resize_nearest(depth_raw, scale_base)
                kf = kf.copy()
                kf[:2, :] *= scale_base
            color = _fit_hw(color, height, width)
            if depth_raw is not None:
                depth_raw = _fit_hw(depth_raw.astype(np.float32), height, width)
            factor = float(np.squeeze(frame["meta"].get("factor_depth", 1000.0))) if "meta" in frame else 1000.0
            blob, blob_p = build_image_blobs(
                color, depth_raw, kf, input_mode=cfg.input,
                pixel_means=np.asarray(cfg.pixel_means, np.float32),
                depth_factor=factor,
            )
            depth_m = depth_raw / factor if depth_raw is not None else None
            poses = frame.get("poses")
            gts = []
            if poses is not None:
                if poses.ndim == 2:
                    poses = poses[:, :, None]
                for j, cls in enumerate(frame.get("cls_indexes", [])):
                    gts.append(
                        (int(cls), mat_to_quat_np(poses[:, :3, j]), poses[:, 3, j])
                    )
            gt_label = frame.get("label")
            if gt_label is not None:
                if scale_base != 1.0:
                    gt_label = resize_nearest(np.asarray(gt_label), scale_base)
                gt_label = _fit_hw(gt_label, height, width)
            run_one(blob, build_meta_blob(kf), depth_m, gt_label, gts, blob_p)
    else:
        pm = np.asarray(cfg.pixel_means, np.float32)
        from posecnn_tpu.data.minibatch import normals_from_depth_np

        def syn_depth_blob(d):
            # same blob recipe as training: tile3(depth/max·255) − means
            return np.tile(
                (d / max(float(d.max()), 1e-6) * 255.0)[:, :, None], (1, 1, 3)
            ).astype(np.float32) - pm

        for i in range(args.num_images):
            sample = gen.render()
            gts = [(int(row[1]), row[6:10], row[10:13]) for row in sample.poses]
            blob = sample.image
            blob_p = None
            if rgbd:
                blob_p = syn_depth_blob(sample.depth)
            elif cfg.input == "DEPTH":
                blob = syn_depth_blob(sample.depth)
            elif cfg.input == "NORMAL":
                nmap = normals_from_depth_np(sample.depth, k)
                blob = (127.5 * nmap + 127.5).astype(np.float32) - pm
            run_one(
                blob, np.asarray(meta0[0]), sample.depth, sample.label,
                gts, blob_p,
            )

    summary = evaluator.summarize()
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "eval.json"), "w") as f:
        json.dump(summary, f, indent=2)
    # reference-style per-class report with sample sizes
    # (ref: lib/datasets/lov.py:518-660)
    from posecnn_tpu.engine.evaluate import format_per_class_table

    names = list(getattr(ds, "classes", [])) if ds is not None else None
    print(format_per_class_table(summary, names))
    print(json.dumps({k: v for k, v in summary.items() if k != "per_class"}, indent=2))
    print(f"wrote {args.output}/eval.json")
    return summary


def _detection_eval(args, cfg):
    """Detection-variant evaluation: RPN proposals → RoI head →
    per-class box decode + NMS → AP@0.5
    (ref: test_net_detection lib/fcn/test.py:1472-1690 +
    imdb.evaluate_detections)."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.core.checkpoint import restore_params
    from posecnn_tpu.data.minibatch import label_to_boxes
    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator
    from posecnn_tpu.engine.evaluate import detection_ap
    from posecnn_tpu.models import PoseCNNDet
    from posecnn_tpu.ops.nms import nms
    from posecnn_tpu.utils.bbox import bbox_transform_inv, clip_boxes

    c = cfg.train.num_classes
    width, height = cfg.train.syn_width, cfg.train.syn_height
    from posecnn_tpu.data.procedural import synthetic_class_library

    proc = synthetic_class_library(c, 256)
    points_full, extents = proc.points, proc.extents
    k = np.array([[500.0, 0, width / 2], [0, 500.0, height / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(
        points_full, extents, k, width=width, height=height,
        t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
        pixel_means=cfg.pixel_means, seed=args.seed,
        point_colors=proc.colors, point_normals=proc.normals,
    )

    model = PoseCNNDet(
        num_classes=c,
        anchor_scales=tuple(cfg.anchor_scales),
        anchor_ratios=tuple(cfg.anchor_ratios),
        feature_stride=cfg.feature_stride,
        fc_dim=cfg.train.fc_dim,
        compute_dtype=jnp.dtype(cfg.compute_dtype),
        pre_nms_topk=cfg.test.rpn_pre_nms_top_n,
        post_nms_topk=cfg.test.rpn_post_nms_top_n,
        rpn_nms_thresh=cfg.test.rpn_nms_thresh,
    )
    data0 = jnp.zeros((1, height, width, 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(cfg.rng_seed), data0, train=False)
    if args.ckpt:
        params, step = restore_params(args.ckpt, params)
        print(f"restored checkpoint at step {step}")

    # trained bbox deltas are standardized (BBOX_NORMALIZE_TARGETS_
    # PRECOMPUTED); decode un-normalizes with the same means/stds
    # (ref: test.py im_detect applies stds/means before
    # bbox_transform_inv); TEST.BBOX_REG=False keeps raw proposals
    norm_on = cfg.train.bbox_normalize_targets
    means = np.tile(np.asarray(cfg.train.bbox_normalize_means, np.float32), c)
    stds = np.tile(np.asarray(cfg.train.bbox_normalize_stds, np.float32), c)

    @jax.jit
    def infer(params, data):
        out = model.apply(params, data, train=False)
        scores = jax.nn.softmax(out.cls_logits, axis=-1)  # (R, C)
        deltas = out.bbox_pred
        if norm_on:
            deltas = deltas * stds[None, :] + means[None, :]
        if cfg.test.bbox_reg:
            boxes = bbox_transform_inv(out.proposals.rois[:, 1:5], deltas)
        else:
            boxes = jnp.tile(out.proposals.rois[:, 1:5], (1, c))
        boxes = clip_boxes(boxes, height, width)  # (R, 4C)
        return out.proposals.valid, scores, boxes, out.poses_pred

    from posecnn_tpu.ops.rpn import estimate_translation_from_box

    # detection pose readout (ref: test_net_detection test.py:1591-1619
    # + compute_translations:1639-1664): per-class quaternion slot,
    # translation from the box via the projected-extent depth fit
    @jax.jit
    def det_pose(quat_row, box, cls_points):
        q = quat_row / jnp.maximum(jnp.linalg.norm(quat_row), 1e-12)
        t = estimate_translation_from_box(q, box, cls_points, jnp.asarray(k))
        return q, t

    points_j = jnp.asarray(points_full[:, :: max(1, points_full.shape[1] // 256)])
    from posecnn_tpu.engine.evaluate import PoseEvaluator

    pose_eval = PoseEvaluator(
        num_classes=c, points=points_full, extents=extents,
        instance_matching=True,
    )
    all_dets, all_gts = [], []
    pose_errs = []
    score_thresh = 0.05
    for _ in range(args.num_images):
        sample = gen.render()
        valid, scores, boxes, poses_tanh = infer(
            params, jnp.asarray(sample.image[None])
        )
        valid_np = np.asarray(valid)
        scores_np = np.asarray(scores)
        boxes_np = np.asarray(boxes)
        poses_np = np.asarray(poses_tanh)
        dets = []
        for cls in range(1, c):
            cls_boxes = jnp.asarray(boxes_np[:, 4 * cls : 4 * cls + 4])
            cls_scores = jnp.asarray(scores_np[:, cls])
            keep = np.asarray(
                nms(cls_boxes, cls_scores, cfg.test.nms_threshold, valid=jnp.asarray(valid_np))
            )
            for i in np.nonzero(keep)[0]:
                if scores_np[i, cls] > score_thresh and valid_np[i]:
                    box_i = boxes_np[i, 4 * cls : 4 * cls + 4]
                    q_i, t_i = det_pose(
                        jnp.asarray(poses_np[i, 4 * cls : 4 * cls + 4]),
                        jnp.asarray(box_i), points_j[cls],
                    )
                    dets.append(
                        (cls, float(scores_np[i, cls]), tuple(box_i),
                         np.asarray(q_i), np.asarray(t_i))
                    )
        # translation error vs GT for class-matched detections
        for cls, _, _, _, t_i in dets:
            for j in range(sample.poses.shape[0]):
                if int(sample.poses[j, 1]) == cls:
                    pose_errs.append(
                        float(np.linalg.norm(t_i - sample.poses[j, 10:13]))
                    )
                    break
        # instance-aware 6D pose metrics: the detection variant exists
        # for crowded scenes, so det/GT pairs match per instance, not
        # per class (greedy translation matching)
        pose_eval.add_image(
            [(cls, q_i, t_i) for cls, _, _, q_i, t_i in dets],
            [
                (int(sample.poses[j, 1]), sample.poses[j, 6:10], sample.poses[j, 10:13])
                for j in range(sample.poses.shape[0])
            ],
        )
        all_dets.append([d[:3] for d in dets])
        gt_boxes = label_to_boxes(sample.label, sample.poses[:, 1].astype(np.int64))
        all_gts.append([(int(b[4]), tuple(b[:4])) for b in gt_boxes])

    result = detection_ap(all_dets, all_gts, c, iou_threshold=0.5)
    result["mean_trans_err_m"] = float(np.mean(pose_errs)) if pose_errs else None
    result["pose"] = {
        k_: v for k_, v in pose_eval.summarize().items()
        if k_ in ("add_auc", "adds_auc", "per_class")
    }
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "eval_det.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({"map@0.5": result["map"], "classes": len(result["per_class"])}))
    print(f"wrote {args.output}/eval_det.json")
    return result


if __name__ == "__main__":
    main()
