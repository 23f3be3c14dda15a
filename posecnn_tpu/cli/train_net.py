"""Train PoseCNN (ref: tools/train_net.py:263-334 + train_net
lib/fcn/train.py:478-563).

Run (synthetic data, no real dataset frames needed):
  python -m posecnn_tpu.cli.train_net --cfg experiments/cfgs/synthetic_small.yaml \
      --iters 200 --output output/syn

With real YCB-Video frames on disk:
  python -m posecnn_tpu.cli.train_net --dataset ycb_video \
      --data_root /path/to/LOV --image_set train --cfg experiments/cfgs/lov_color_2d.yaml
"""

from __future__ import annotations

import json
import os

import numpy as np

from posecnn_tpu.cli.common import base_parser, load_config, setup_device


def _make_loggers(args, cfg, max_iters):
    """Shared metrics-jsonl + snapshot plumbing for every network
    family (ref: per-iter loss prints train.py:244-245 + Saver
    snapshots train.py:41-56)."""
    from posecnn_tpu.core.checkpoint import (
        prune_snapshots,
        save_params,
        snapshot_path,
    )

    os.makedirs(args.output, exist_ok=True)
    log_f = open(os.path.join(args.output, "metrics.jsonl"), "a")

    def log_fn(it_num, metrics):
        metrics["iter"] = it_num
        log_f.write(json.dumps(metrics) + "\n")
        log_f.flush()
        line = ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items() if k != "iter")
        print(f"iter {it_num}/{max_iters} " + line, flush=True)

    def snapshot_fn(it_num, params):
        path = snapshot_path(
            args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix, it_num
        )
        save_params(path, params, step=it_num)
        prune_snapshots(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_keep)
        print(f"snapshot → {path}")

    return log_fn, snapshot_fn


def _generic_loop(cfg, state, step, batches, max_iters, log_fn, snapshot_fn, rng):
    """Minimal host loop for the variant train steps (det/seg/video/gan)."""
    import time

    t_start = time.time()
    for it in range(max_iters):
        state, metrics = step(state, next(batches), rng)
        if (it + 1) % cfg.train.display == 0:
            metrics = {k: float(v) for k, v in metrics.items() if getattr(v, "ndim", 0) == 0}
            metrics["s_per_iter"] = (time.time() - t_start) / (it + 1)
            log_fn(it + 1, metrics)
        if (it + 1) % cfg.train.snapshot_iters == 0:
            snapshot_fn(it + 1, state.params)
    return state


def _train_det(args, cfg, gen, c, max_iters, det_symmetry=None):
    """Detection-variant training (ref: train_net_det
    lib/fcn/train.py:593-653; tools/train_net.py with a *_det cfg).
    GT boxes derive from the synthetic label map (the reference reads
    roidb boxes; same information)."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.core.checkpoint import restore_params, save_params, snapshot_path
    from posecnn_tpu.engine.train import TrainState, create_optimizer, make_det_train_step
    from posecnn_tpu.models.detection import PoseCNNDet

    norm_on = cfg.train.bbox_normalize_targets
    model = PoseCNNDet(
        num_classes=c,
        fc_dim=cfg.train.fc_dim,
        compute_dtype=jnp.dtype(cfg.compute_dtype),
        anchor_scales=cfg.anchor_scales,
        anchor_ratios=cfg.anchor_ratios,
        pre_nms_topk=cfg.train.rpn_pre_nms_top_n,
        post_nms_topk=cfg.train.rpn_post_nms_top_n,
        rois_per_image=cfg.train.batch_size,
        rpn_nms_thresh=cfg.train.rpn_nms_thresh,
        rpn_positive_overlap=cfg.train.rpn_positive_overlap,
        rpn_negative_overlap=cfg.train.rpn_negative_overlap,
        rpn_clobber_positives=cfg.train.rpn_clobber_positives,
        rpn_batchsize=cfg.train.rpn_batchsize,
        rpn_fg_fraction=cfg.train.rpn_fg_fraction,
        fg_fraction=cfg.train.fg_fraction,
        fg_thresh=cfg.train.fg_thresh,
        bg_thresh_hi=cfg.train.bg_thresh_hi,
        bg_thresh_lo=cfg.train.bg_thresh_lo,
        bbox_normalize_means=tuple(cfg.train.bbox_normalize_means) if norm_on else None,
        bbox_normalize_stds=tuple(cfg.train.bbox_normalize_stds) if norm_on else None,
    )
    max_gt = 8

    def make_batch():
        s = gen.render()
        gt_boxes = np.zeros((max_gt, 5), np.float32)
        gt_valid = np.zeros(max_gt, bool)
        gt_poses = np.zeros((max_gt, 13), np.float32)
        # box row i and pose row i MUST describe the same object —
        # classes fully occluded by the z-buffered splat have no box
        # and must drop their POSE ROW too (proposal_target_layer
        # indexes gt_poses by the box-row argmax, ops/rpn.py)
        row = 0
        for j in range(s.poses.shape[0]):
            if row >= max_gt:
                break
            cls_j = int(s.poses[j, 1])
            ys, xs = np.nonzero(s.label == cls_j)
            if len(ys) == 0:
                continue
            gt_boxes[row] = [xs.min(), ys.min(), xs.max(), ys.max(), cls_j]
            gt_poses[row] = s.poses[j]
            gt_valid[row] = True
            row += 1
        return {
            "data": jnp.asarray(s.image[None]),
            "gt_boxes": jnp.asarray(gt_boxes),
            "gt_poses": jnp.asarray(gt_poses),
            "gt_valid": jnp.asarray(gt_valid),
        }

    def batches():
        while True:
            yield make_batch()

    it = batches()
    sample = next(it)
    params = model.init(
        jax.random.PRNGKey(cfg.rng_seed), sample["data"], sample["gt_boxes"],
        sample["gt_poses"], sample["gt_valid"], train=True,
        rng=jax.random.PRNGKey(1),
    )
    if args.ckpt:
        params, _ = restore_params(args.ckpt, params)
    opt = create_optimizer(cfg, params)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    # ADD pose loss needs the class model points + symmetry flags
    # (ref: train_net_det's loss_pose, vgg16_det.py:165-166)
    pidx = np.linspace(0, gen.points.shape[1] - 1, cfg.train.add_num_points).astype(int)
    if det_symmetry is None:
        det_symmetry = np.zeros(c, np.float32)
    step = make_det_train_step(
        cfg, model,
        points=jnp.asarray(gen.points[:, pidx]),
        symmetry=jnp.asarray(det_symmetry),
    )
    log_fn, snapshot_fn = _make_loggers(args, cfg, max_iters)
    state = _generic_loop(
        cfg, state, step, it, max_iters, log_fn, snapshot_fn,
        jax.random.PRNGKey(cfg.rng_seed),
    )
    final = snapshot_path(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix, max_iters)
    save_params(final, state.params, step=max_iters)
    print(f"done → {final}")


def _train_seg(args, cfg, gen, c, max_iters):
    """Plain segmentation-backbone training — fcn8 / resnet50_seg
    (ref: train_model lib/fcn/train.py:94-135 on the fcn8_vgg.py /
    resnet50.py graphs)."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.core.checkpoint import restore_params, save_params, snapshot_path
    from posecnn_tpu.engine.train import TrainState, create_optimizer, make_seg_train_step

    kwargs = dict(num_classes=c, compute_dtype=jnp.dtype(cfg.compute_dtype))
    if cfg.network == "fcn8":
        from posecnn_tpu.models.fcn8 import FCN8

        model = FCN8(fc_dim=cfg.train.fc_dim, **kwargs)
    else:
        from posecnn_tpu.models.resnet50 import ResNet50Seg

        model = ResNet50Seg(num_units=cfg.train.num_units, **kwargs)

    def batches():
        while True:
            b = gen.minibatch(cfg.train.ims_per_batch)
            yield {
                "data": jnp.asarray(b["data"]),
                "label": jnp.asarray(b["label"].astype(np.int32)),
            }

    it = batches()
    sample = next(it)
    params = model.init(jax.random.PRNGKey(cfg.rng_seed), sample["data"])
    if args.ckpt:
        params, _ = restore_params(args.ckpt, params)
    opt = create_optimizer(cfg, params)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = make_seg_train_step(cfg, model)
    log_fn, snapshot_fn = _make_loggers(args, cfg, max_iters)
    state = _generic_loop(
        cfg, state, step, it, max_iters, log_fn, snapshot_fn,
        jax.random.PRNGKey(cfg.rng_seed),
    )
    final = snapshot_path(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix, max_iters)
    save_params(final, state.params, step=max_iters)
    print(f"done → {final}")


def _train_video(args, cfg, gen, c, max_iters, ds=None):
    """Recurrent video-net training (ref: the vgg16 multi-frame graph
    vgg16.py:41-166 trained via train_model_vertex; NUM_STEPS unroll
    gt_data_layer/minibatch.py:34-48). With real dataset frames on
    disk, sequences come from get_real_video_minibatch — the
    GtDataLayer real-video path (minibatch.py:20-310)."""
    import jax
    import jax.numpy as jnp

    from posecnn_tpu.core.checkpoint import restore_params, save_params, snapshot_path
    from posecnn_tpu.data.synthetic import SyntheticSequenceGenerator
    from posecnn_tpu.engine.train import TrainState, create_optimizer, make_video_train_step
    from posecnn_tpu.models.recurrent import RecurrentSegNet

    model = RecurrentSegNet(num_classes=c, num_units=cfg.train.num_units)
    seq_gen = SyntheticSequenceGenerator(gen, num_steps=cfg.train.num_steps)

    have_real = ds is not None and len(ds.image_index) > 0 and os.path.exists(
        ds.frame_prefix(ds.image_index[0]) + "-color.png"
    )

    def batches():
        if have_real:
            from posecnn_tpu.data.minibatch import get_real_video_minibatch

            frame0 = ds.load_frame(ds.image_index[0])
            # TRAIN.SCALES_BASE rescale, like the single-frame real
            # path (ref: _get_image_blob minibatch.py:155-175)
            sb = float(cfg.train.scales_base[0]) if cfg.train.scales_base else 1.0
            rh = int(round(frame0["color"].shape[0] * sb))
            rw = int(round(frame0["color"].shape[1] * sb))
            pixel_means = np.asarray(cfg.pixel_means, np.float32)
            data_rng = np.random.RandomState(cfg.rng_seed)
            n_index = len(ds.image_index)
            while True:
                starts = data_rng.randint(0, n_index, cfg.train.ims_per_batch)
                b = get_real_video_minibatch(
                    ds, starts, num_steps=cfg.train.num_steps,
                    height=rh, width=rw,
                    pixel_means=pixel_means, rng=data_rng,
                    chromatic=cfg.train.chromatic, scale=sb,
                )
                yield {
                    "image": jnp.asarray(b["image"]),
                    "depth": jnp.asarray(b["depth"]),
                    "meta": jnp.asarray(b["meta"]),
                    "label": jnp.asarray(b["label"]),
                }
        while True:
            b = seq_gen.minibatch(cfg.train.ims_per_batch)
            yield {
                "image": jnp.asarray(b["image"]),
                "depth": jnp.asarray(b["depth"]),
                "meta": jnp.asarray(b["meta"]),
                "label": jnp.asarray(b["label"].astype(np.int32)),
            }

    it = batches()
    sample = next(it)
    params = model.init(
        jax.random.PRNGKey(cfg.rng_seed), sample["image"], sample["depth"], sample["meta"]
    )
    if args.ckpt:
        params, _ = restore_params(args.ckpt, params)
    opt = create_optimizer(cfg, params)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = make_video_train_step(cfg, model, c)
    log_fn, snapshot_fn = _make_loggers(args, cfg, max_iters)
    state = _generic_loop(
        cfg, state, step, it, max_iters, log_fn, snapshot_fn,
        jax.random.PRNGKey(cfg.rng_seed),
    )
    final = snapshot_path(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix, max_iters)
    save_params(final, state.params, step=max_iters)
    print(f"done → {final}")


def _load_backgrounds(args, size_hw):
    """Real-image compositing pool for the synthetic generator
    (ref: gt_synthesize_layer/minibatch.py:128-160)."""
    import glob

    pattern = getattr(args, "backgrounds", None)
    if not pattern:
        return None
    from posecnn_tpu.data.procedural import load_background_pool

    files = sorted(glob.glob(pattern))
    if not files:
        # a requested-but-empty pool means training silently runs
        # without compositing (advisor r3 finding) — fail fast and say
        # how to build the default pool
        raise FileNotFoundError(
            f"--backgrounds {pattern!r} matched no files; run "
            "`python experiments/gen_backgrounds.py` to build the "
            "procedural pool, or pass --backgrounds '' to disable "
            "compositing explicitly"
        )
    pool = load_background_pool(files, size_hw=size_hw)
    if pool is not None:
        print(f"background compositing pool: {len(pool)} frames")
    return pool


def main(argv=None):
    parser = base_parser("PoseCNN training (ref: tools/train_net.py)")
    parser.add_argument("--dataset", default="synthetic")
    parser.add_argument("--data_root", default="/root/reference/data/LOV")
    parser.add_argument("--image_set", default="train")
    parser.add_argument(
        "--cls", default="",
        help="LINEMOD object name for --dataset linemod (ape, eggbox, …)",
    )
    parser.add_argument("--output", default="output/train")
    parser.add_argument("--iters", type=int, default=0, help="override max_iters")
    parser.add_argument("--ckpt", default=None, help="resume checkpoint")
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the NEWEST snapshot in --output (crash "
        "recovery without naming a file; the reference restores via "
        "an explicit --ckpt only, train.py:109-112)",
    )
    parser.add_argument("--pretrained", default=None, help="vgg16.npy imagenet weights")
    parser.add_argument(
        "--reinit", default=None, metavar="MODULES",
        help="comma-separated top-level param modules (e.g. "
        "'pose_head') to RE-RANDOMIZE after --ckpt/--resume restore — "
        "a young head on a mature trunk. Exists because a head that "
        "has spent tens of k iters pinned at its chance saddle stops "
        "responding to the adam restart kick, while a freshly "
        "initialized head on trained features learns in ~2k iters "
        "(r6 rotation forensics)",
    )
    parser.add_argument(
        "--backgrounds",
        default="",
        help="glob of RGB frames composited behind synthetic renders "
        "(ref: gt_synthesize_layer/minibatch.py:128-160); default: no "
        "compositing. `python experiments/gen_backgrounds.py` builds a "
        "procedural pool under output/bg_pool/ — do NOT point this at the 5 "
        "demo frames (/root/reference/data/demo_images): they are the "
        "held-out eval set and training on them reproduces the r3 "
        "background-memorization regression",
    )
    parser.add_argument("--num_data", type=int, default=-1, help="mesh data-axis size")
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture a jax.profiler trace of the whole run into DIR "
        "(TensorBoard/Perfetto-viewable; use with a small --iters — "
        "the SURVEY §5 tracing equivalent of the reference's Timers)",
    )
    args = parser.parse_args(argv)
    setup_device(args)
    cfg = load_config(args)
    max_iters = args.iters or cfg.train.max_iters

    if args.resume and not args.ckpt:
        import glob
        import re

        pat = re.compile(r"_iter_(\d+)\.npz$")
        snaps = [
            (int(m.group(1)), p)
            for p in glob.glob(os.path.join(args.output, "*_iter_*.npz"))
            if (m := pat.search(p))
        ]
        if snaps:
            args.ckpt = max(snaps)[1]
            print(f"--resume: using {args.ckpt}")
        else:
            print(f"--resume: no snapshots under {args.output}, starting fresh")

    if args.profile:
        from posecnn_tpu.utils.debug import profile_trace

        profile = args.profile
        args.profile = None
        with profile_trace(profile):
            result = main_run(args, cfg, max_iters)
        print(f"profiler trace → {profile}")
        return result
    return main_run(args, cfg, max_iters)


def main_run(args, cfg, max_iters):

    import jax
    import jax.numpy as jnp

    from posecnn_tpu.core.checkpoint import (
        import_vgg16_npy,
        prune_snapshots,
        restore_params,
        save_params,
        snapshot_path,
    )
    from posecnn_tpu.data.datasets import YCBVideoDataset
    from posecnn_tpu.data.procedural import make_procedural_objects
    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator
    from posecnn_tpu.engine.train import TrainState, create_train_state, train_loop
    from posecnn_tpu.models import PoseCNN
    from posecnn_tpu.parallel.mesh import batch_sharding, create_mesh, replicated

    c = cfg.train.num_classes
    ds = None
    point_colors = point_normals = None
    # class geometry: real YCB models when available, else synthetic
    if args.dataset == "linemod":
        # single-object LINEMOD config (ref: tools with linemod_* cfgs
        # → lib/datasets/linemod.py 2-class imdb): background + one
        # object, REAL extents/diameters from the LINEMOD tree, clouds
        # synthesized to those extents when models are absent
        from posecnn_tpu.data.datasets import LinemodDataset
        from posecnn_tpu.data.procedural import fill_missing_points

        lm = LinemodDataset(args.data_root, args.image_set, cls=args.cls)
        ci = list(lm.classes).index(args.cls) if args.cls else 1
        pts_all, cols_all, nrms_all = fill_missing_points(
            lm.points, lm.extents, orient_detail=cfg.train.orient_paint,
            paint_version=cfg.train.paint_version,
        )
        c = 2
        points_full = np.stack([pts_all[0], pts_all[ci]])
        extents = np.stack([lm.extents[0], lm.extents[ci]])
        symmetry = np.asarray([0.0, lm.symmetry[ci]], np.float32)
        point_colors = np.stack([cols_all[0], cols_all[ci]])
        point_normals = np.stack([nrms_all[0], nrms_all[ci]])
        k = lm.intrinsic_matrix
    elif args.dataset in ("ycb_video", "lov") or (
        args.dataset == "synthetic" and os.path.exists(os.path.join(args.data_root, "models"))
    ):
        ds = YCBVideoDataset(args.data_root, args.image_set)
        c = ds.num_classes
        points_full = ds.points
        extents = ds.extents
        symmetry = np.asarray(ds.symmetry)
        # the on-disk models are xyz-only: synthesize deterministic
        # texture + normals so rendered appearance carries rotation
        # (data/procedural.colorize_model_library)
        from posecnn_tpu.data.procedural import colorize_model_library

        point_colors, point_normals = colorize_model_library(
            points_full, orient_detail=cfg.train.orient_paint,
            paint_version=cfg.train.paint_version,
        )
        k = np.array(
            [[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]], np.float32
        )
    else:
        # procedural textured objects (data/procedural.py): surface-
        # sampled asymmetric compositions with per-point texture +
        # normals. The former random-cube clouds were rotation-
        # invariant in appearance, which made the rotation branch
        # unlearnable (round-2 verdict, weakness 1).
        proc = make_procedural_objects(c, 2620, seed=0)
        points_full = proc.points
        extents = proc.extents
        symmetry = proc.symmetry
        point_colors, point_normals = proc.colors, proc.normals
        k = np.array(
            [[500.0, 0, cfg.train.syn_width / 2], [0, 500.0, cfg.train.syn_height / 2], [0, 0, 1]],
            np.float32,
        )

    idx = np.linspace(0, points_full.shape[1] - 1, cfg.train.add_num_points).astype(int)
    points = points_full[:, idx]

    # TRAIN.SCALES_BASE (ref: config.py:109, _get_image_blob
    # minibatch.py:155-175): train at a rescaled resolution — images,
    # labels, centers and intrinsics all scale together (the LINEMOD
    # *_3d configs use 1.5)
    scale_base = float(cfg.train.scales_base[0]) if cfg.train.scales_base else 1.0
    train_h = int(round(cfg.train.syn_height * scale_base))
    train_w = int(round(cfg.train.syn_width * scale_base))
    if scale_base != 1.0:
        k = k.copy()
        k[:2, :] *= scale_base

    # SYN_SAMPLE_POSE (ref config.py:88, synthesize.cpp:412-422) draws
    # from the dataset's real-pose bank (<root>/poses/<cls>.txt);
    # setting it without a dataset is a config error — fail loudly
    # instead of silently falling back to uniform sampling
    pose_bank = None
    if cfg.train.syn_sample_pose:
        if ds is None:
            raise ValueError(
                "train.syn_sample_pose=True requires --dataset "
                "(the pose bank lives at <root>/poses/<cls>.txt)"
            )
        pose_bank = ds.load_pose_bank()

    gen = SyntheticSceneGenerator(
        points_full,
        extents,
        k,
        width=train_w,
        height=train_h,
        t_near=cfg.train.syn_tnear,
        t_far=cfg.train.syn_tfar,
        pixel_means=cfg.pixel_means,
        seed=cfg.rng_seed,
        class_whitelist=(
            [min(cfg.train.syn_class_index, c - 1)]
            if cfg.train.syn_class_index > 0
            else None
        ),
        sample_object=cfg.train.syn_sample_object,
        sample_pose=cfg.train.syn_sample_pose,
        pose_bank=pose_bank,
        point_colors=point_colors,
        point_normals=point_normals,
        backgrounds=_load_backgrounds(args, (train_h, train_w)),
    )

    # network-family dispatch (ref: get_network factory keyed by
    # cfg.NETWORK, lib/networks/factory.py:22-51; train_net vs
    # train_net_det chosen by the tools, tools/train_net.py:330-334)
    if cfg.network == "posecnn_det":
        return _train_det(args, cfg, gen, c, max_iters, det_symmetry=symmetry)
    if cfg.network in ("fcn8", "resnet50_seg"):
        return _train_seg(args, cfg, gen, c, max_iters)
    if cfg.network == "recurrent_seg":
        return _train_video(args, cfg, gen, c, max_iters, ds=ds)
    if cfg.network != "posecnn":
        raise ValueError(f"unknown network family for training: {cfg.network}")

    # mesh + EFFECTIVE batch size first: max_objects must be sized from
    # the rounded batch or the hough output overshoots the max_rois
    # budget by the rounding factor (e.g. 4x on an 8-device mesh with
    # ims_per_batch=2)
    n_dev = len(jax.devices())
    use_mesh = args.num_data != 1 and n_dev > 1
    mesh = create_mesh(num_data=args.num_data if args.num_data > 0 else -1) if use_mesh else None
    batch_size = cfg.train.ims_per_batch
    if mesh is not None:
        ddev = mesh.shape["data"]
        batch_size = max(batch_size, ddev) // ddev * ddev

    model = PoseCNN(
        num_classes=c,
        num_units=cfg.train.num_units,
        fc_dim=cfg.train.fc_dim,
        compute_dtype=jnp.dtype(cfg.compute_dtype),
        vertex_reg=cfg.train.vertex_reg_2d or cfg.train.vertex_reg_3d,
        pose_reg=cfg.train.pose_reg,
        adaptation=cfg.train.adapt,
        input_format="RGBD" if cfg.input == "RGBD" else "COLOR",
        threshold_label=cfg.train.threshold_label,
        vote_threshold=cfg.train.voting_threshold,
        hough_num_samples=cfg.train.hough_num_samples,
        max_objects=max(1, cfg.train.max_rois // max(batch_size, 1) // 9),
        max_pose_rois=cfg.train.max_pose_rois,
        gt_pose_rois=cfg.train.gt_pose_rois,
        pose_pool_size=cfg.train.pose_pool_size,
        norm_features=cfg.train.norm_features,
        quat_activation=cfg.train.quat_activation,
    )

    # real-frame feed when actual dataset frames are on disk; synthetic
    # batches are ratio-interleaved per cfg.train.syn_ratio (ref:
    # GtSynthesizeLayer ratio sampling layer.py:76-113)
    from posecnn_tpu.data.minibatch import get_real_minibatch, normals_from_depth_np
    from posecnn_tpu.data.pipeline import RatioSampler, ShuffledIndexer

    have_real = ds is not None and len(ds.image_index) > 0 and os.path.exists(
        ds.frame_prefix(ds.image_index[0]) + "-color.png"
    )
    data_rng = np.random.RandomState(cfg.rng_seed)
    pixel_means = np.asarray(cfg.pixel_means, np.float32)
    if have_real:
        n_index = len(ds.image_index) * (2 if cfg.train.use_flipped else 1)
        indexer = ShuffledIndexer(
            n_index, seed=cfg.rng_seed,
            process_index=jax.process_index(), process_count=jax.process_count(),
        )
        streams = ["real"] + (["syn"] * (1 if cfg.train.synthesize else 0))
        sampler = RatioSampler(streams, [1, cfg.train.syn_ratio][: len(streams)])
    else:
        sampler = RatioSampler(["syn"], [1])

    # uint8 feed compression only where the step never reads depth:
    # COLOR input, no 3D vertex reg, no matching render-and-compare
    _compact = (
        cfg.train.compact_feed
        and cfg.input == "COLOR"
        and not cfg.train.vertex_reg_3d
        and not cfg.train.matching
        and not cfg.train.gan
    )

    def syn_to_mode(b):
        """Derive DEPTH/RGBD/NORMAL network inputs from the synthetic
        generator's metric depth (ref syn branch minibatch.py:190-241)."""
        if cfg.input == "COLOR":
            if _compact:
                from posecnn_tpu.data.pipeline import compact_feed

                return compact_feed(b, pixel_means)
            return b
        dblob = np.empty(b["depth"].shape + (3,), np.float32)
        for i_im in range(b["depth"].shape[0]):
            d = b["depth"][i_im]
            if cfg.input == "NORMAL":
                nmap = normals_from_depth_np(d, k)
                dblob[i_im] = 127.5 * nmap + 127.5 - pixel_means
            else:
                dblob[i_im] = np.tile(
                    (d / max(float(d.max()), 1e-6) * 255.0)[:, :, None], (1, 1, 3)
                ) - pixel_means
        if cfg.input == "RGBD":
            b["data_p"] = dblob
        else:
            b["data"] = dblob
        return b

    max_gt = 8 * batch_size  # GT rows scale with batch size

    # sparse vertex-target feed (per-class centers instead of dense
    # (H,W,3C) maps; built on device by the train step — 168 → 6 MB
    # per frame). The synthetic and real-frame loaders and the GAN
    # step (discriminator real input) all support it.
    sparse_vertex = cfg.train.vertex_reg_2d or cfg.train.vertex_reg_3d

    def _syn_batch(g):
        if cfg.train.syn_pool_size > 0:
            return g.pooled_minibatch(
                batch_size, max_gt=max_gt,
                dense_vertex_targets=not sparse_vertex,
                pool_size=cfg.train.syn_pool_size,
                fresh=cfg.train.syn_pool_fresh,
            )
        return g.minibatch(
            batch_size, max_gt=max_gt,
            dense_vertex_targets=not sparse_vertex,
        )

    def make_batch():
        if sampler.next_stream() == "real" and have_real:
            return get_real_minibatch(
                ds, indexer.next_batch(batch_size),
                num_classes=c, height=train_h, width=train_w,
                pixel_means=pixel_means, input_mode=cfg.input, rng=data_rng,
                chromatic=cfg.train.chromatic, noise=cfg.train.add_noise,
                use_flipped=cfg.train.use_flipped, max_gt=max_gt,
                scale=scale_base,
                dense_vertex_targets=not sparse_vertex,
            )
        return syn_to_mode(_syn_batch(gen))

    from posecnn_tpu.data.pipeline import Prefetcher, make_sharded_device_put

    device_put = make_sharded_device_put(mesh)
    if not have_real:
        # synthetic-only: overlap host rendering with the device step
        # (replaces the reference's enqueue thread + FIFOQueue(25),
        # train.py:116-121,382-436) — per-worker generator clones keep
        # rng/index state thread-local
        import copy

        def _worker_make_batch(worker_id):
            g2 = copy.deepcopy(gen)
            g2.rng = np.random.RandomState(cfg.rng_seed + 1000 * (worker_id + 1))
            # each worker keeps its own replay pool (thread-local state
            # like the rng)
            return lambda: syn_to_mode(_syn_batch(g2))

        prefetch = Prefetcher(
            make_batch_factory=_worker_make_batch,
            queue_size=8,
            num_workers=2,
            device_put=device_put,
        )
        it = iter(prefetch)
    else:
        # mixed real/synthetic streams share samplers — single producer
        def batches():
            while True:
                yield device_put(make_batch())

        it = batches()
    sample = next(it)

    if cfg.train.gan:
        # adversarial vertex-map training (the vgg16_gan variant,
        # ref: lib/networks/vgg16_gan.py:146-188; the reference ships
        # the graph but no GAN loop — engine/train.make_gan_train_step)
        from posecnn_tpu.core.checkpoint import save_params as _save
        from posecnn_tpu.engine.train import (
            create_gan_train_state,
            make_gan_train_step,
        )
        from posecnn_tpu.models.gan import FeatureDiscriminator

        disc = FeatureDiscriminator()
        gstate = create_gan_train_state(
            cfg, model, disc, jax.random.PRNGKey(cfg.rng_seed), sample,
            jnp.asarray(extents),
        )
        if args.ckpt:
            gparams, step0 = restore_params(args.ckpt, gstate.params)
            gstate = gstate._replace(params=gparams, step=jnp.asarray(step0))
        step = make_gan_train_step(
            cfg, model, disc, jnp.asarray(points), jnp.asarray(extents),
            jnp.asarray(symmetry),
        )
        log_fn, snapshot_fn = _make_loggers(args, cfg, max_iters)
        gstate = _generic_loop(
            cfg, gstate, step, it, max_iters, log_fn, snapshot_fn,
            jax.random.PRNGKey(cfg.rng_seed),
        )
        final = snapshot_path(
            args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix, max_iters
        )
        _save(final, gstate.params, step=max_iters)
        print(f"done → {final}")
        return

    state = create_train_state(cfg, model, jax.random.PRNGKey(cfg.rng_seed), sample, jnp.asarray(extents))
    if args.pretrained:
        state = TrainState(
            params=import_vgg16_npy(args.pretrained, state.params),
            opt_state=state.opt_state,
            step=state.step,
        )
    if args.ckpt:
        import dataclasses

        fresh_params = state.params
        params, step0 = restore_params(args.ckpt, state.params)
        if args.reinit:
            names = [n.strip() for n in args.reinit.split(",") if n.strip()]
            inner = dict(params["params"])
            fresh_inner = fresh_params["params"]
            for name in names:
                if name not in inner:
                    raise ValueError(
                        f"--reinit {name!r}: no such module; have {sorted(inner)}"
                    )
                inner[name] = fresh_inner[name]
                print(f"--reinit: re-randomized '{name}'")
            params = dict(params)
            params["params"] = inner
        # Resume semantics (r6 rotation forensics):
        #   - optimizer state stays FRESH (count 0, zero moments): the
        #     full bias-corrected adam warmup at each resume is the
        #     restart kick the rotation recipe depends on — r5p/r5q
        #     only ever escaped the pose-at-chance plateau immediately
        #     after a restart, and the controlled A/B showed count-0
        #     resumes kick hardest;
        #   - the lr staircase stays honest via lr_step_offset: decay
        #     boundaries align to the GLOBAL step even though the
        #     schedule is evaluated on the pass-local count.
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, lr_step_offset=step0)
        )
        state = TrainState(
            params=params,
            opt_state=state.opt_state,
            step=jnp.asarray(step0, jnp.int32),
        )
    if mesh is not None:
        state = jax.device_put(state, replicated(mesh))

    os.makedirs(args.output, exist_ok=True)
    log_path = os.path.join(args.output, "metrics.jsonl")
    log_f = open(log_path, "a")

    def log_fn(it_num, metrics):
        metrics["iter"] = it_num
        log_f.write(json.dumps(metrics) + "\n")
        log_f.flush()
        line = ", ".join(f"{k}: {v:.4f}" for k, v in metrics.items() if k != "iter")
        print(f"iter {it_num}/{max_iters} " + line, flush=True)

    head_meta = {
        "norm_features": cfg.train.norm_features,
        "quat_activation": cfg.train.quat_activation,
        "orient_paint": cfg.train.orient_paint,
        "paint_version": cfg.train.paint_version,
        "pose_pool_size": cfg.train.pose_pool_size,
        "train_scale_base": float(cfg.train.scales_base[0]) if cfg.train.scales_base else 1.0,
    }

    def snapshot_fn(it_num, st):
        path = snapshot_path(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix, it_num)
        save_params(path, st.params, step=it_num, meta=head_meta)
        prune_snapshots(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_keep)
        print(f"snapshot → {path}")

    state = train_loop(
        cfg, model, state, it,
        jnp.asarray(points), jnp.asarray(extents), jnp.asarray(symmetry),
        max_iters=max_iters, mesh=mesh, log_fn=log_fn, snapshot_fn=snapshot_fn,
    )
    if not have_real:
        prefetch.close()
    # label the final snapshot with the ACTUAL step (a resumed run may
    # have started at or beyond max_iters)
    final_step = int(np.asarray(jax.device_get(state.step)))
    final = snapshot_path(args.output, cfg.train.snapshot_prefix, cfg.train.snapshot_infix, final_step)
    save_params(final, state.params, step=final_step, meta=head_meta)
    print(f"done → {final}")


if __name__ == "__main__":
    main()
