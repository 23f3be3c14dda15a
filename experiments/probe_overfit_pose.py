"""Single-batch pose-overfit probe (round-5 bisection, step 0).

The decisive plumbing-vs-dynamics discriminator the r4 verdict asked
for: fix ONE minibatch (2 images, class-1-only scenes, orient paint,
GT-RoI injection) and train the FULL end-to-end graph on the pose loss
alone. Two images cannot require generalization — if the
features→RoI-pool→fc6/fc7/fc8→ADD-loss path is correctly plumbed, SGD
must be able to memorize image→quaternion and drive the on-batch
rotation error to ~0 within a few hundred iters. If it cannot, at any
reasonable lr, there is a bug (or an optimization pathology such as
tanh saturation) in the path itself, and no amount of probe iters will
fix the flagship.

Reports per log step: pose loss (per-weighted-row scale), mean
geodesic rotation error over the weighted rows, mean |tanh| of the
active quaternion channels (saturation detector), and the pose-head
gradient norm.

Reference context: the reference trains this same head
(lib/networks/vgg16_convs.py:175-197) with fc6/fc7 warm-started from
ImageNet VGG16 (lib/networks/network.py:71-107 weight loading); no
such weights exist in this environment, so the head must train from
random init — this probe tells us whether it CAN.

Usage:
  python experiments/probe_overfit_pose.py --iters 1500 \
      --sweep "momentum:0.001,momentum:0.01,adam:0.0001,adam:0.001"
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--keep_prob", type=float, default=1.0)
    ap.add_argument("--data_root", default="/root/reference/data/LOV")
    ap.add_argument("--cls_index", type=int, default=1)
    ap.add_argument("--device", default="")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--fresh_batches", action="store_true",
                    help="sample a new scene batch every step (tests "
                    "learnability, not just memorization)")
    ap.add_argument("--pool", type=int, default=0,
                    help="replay-pool size: with --fresh_batches, "
                    "render only --pool_fresh new scenes per step and "
                    "fill the batch from a rolling pool (2-core host "
                    "cannot render batch-16 fresh at device speed)")
    ap.add_argument("--pool_fresh", type=int, default=2)
    ap.add_argument("--full_loss", action="store_true",
                    help="train the full seg+vertex+pose composition "
                    "instead of pose-only")
    ap.add_argument(
        "--sweep",
        default="momentum:0.001",
        help="comma list of opt:lr configs run sequentially from the "
        "same init",
    )
    ap.add_argument("--out", default="output/probe_overfit_pose.json")
    ap.add_argument(
        "--qmag_w", type=float, default=0.0,
        help="weight of the (|q_raw|-1)^2 magnitude regularizer on "
        "weighted rows: the ADD loss constrains only direction, so "
        "|fc8| random-walks upward and the L2-normalize's 1/|x| "
        "Jacobian attenuates direction learning (observed |raw| "
        "300-1500 by iter 1000 on fresh batches)",
    )
    ap.add_argument(
        "--assert_below", type=float, default=0.0,
        help="exit nonzero unless every sweep config's min on-batch "
        "rotation error is below this many degrees (per-round guard "
        "mode: the full train path must still memorize rotation)",
    )
    args = ap.parse_args()

    import jax

    if args.device:
        jax.config.update("jax_platforms", args.device)
    import jax.numpy as jnp
    import optax

    from posecnn_tpu.core.config import cfg_from_file
    from posecnn_tpu.data.datasets import YCBVideoDataset
    from posecnn_tpu.data.procedural import colorize_model_library
    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator
    from posecnn_tpu.engine.train import loss_point_scale
    from posecnn_tpu.models import PoseCNN
    from posecnn_tpu.ops.add_loss import average_distance_loss
    from posecnn_tpu.ops.hard_label import hard_label
    from posecnn_tpu.ops.losses import (
        build_vertex_targets,
        loss_cross_entropy_single_frame,
        smooth_l1_loss_vertex,
    )

    cfg = cfg_from_file("experiments/cfgs/rot_probe.yaml")
    ds = YCBVideoDataset(args.data_root, "train")
    c = ds.num_classes
    points_full, extents, symmetry = ds.points, ds.extents, np.asarray(ds.symmetry)
    point_colors, point_normals = colorize_model_library(
        points_full, orient_detail=True
    )
    k = np.array(
        [[1066.778 / 4, 0, args.width / 2], [0, 1067.487 / 4, args.height / 2], [0, 0, 1]],
        np.float32,
    )
    gen = SyntheticSceneGenerator(
        points_full, extents, k, width=args.width, height=args.height,
        t_near=cfg.train.syn_tnear, t_far=cfg.train.syn_tfar,
        pixel_means=cfg.pixel_means, seed=1234,
        class_whitelist=[args.cls_index],
        point_colors=point_colors, point_normals=point_normals,
    )
    idx = np.linspace(0, points_full.shape[1] - 1, cfg.train.add_num_points).astype(int)
    points = points_full[:, idx]

    model = PoseCNN(
        num_classes=c,
        num_units=cfg.train.num_units,
        fc_dim=cfg.train.fc_dim,
        compute_dtype=jnp.bfloat16,
        vertex_reg=True,
        pose_reg=True,
        threshold_label=cfg.train.threshold_label,
        vote_threshold=cfg.train.voting_threshold,
        hough_num_samples=cfg.train.hough_num_samples,
        max_objects=8,
        max_pose_rois=cfg.train.max_pose_rois,
        gt_pose_rois=True,
    )

    def make_batch():
        if args.pool > 0:
            b = gen.pooled_minibatch(
                args.batch, max_gt=max(16, args.batch),
                dense_vertex_targets=False,
                pool_size=args.pool, fresh=args.pool_fresh,
            )
        else:
            b = gen.minibatch(
                args.batch, max_gt=max(16, args.batch),
                dense_vertex_targets=False,
            )
        return {kk: jnp.asarray(v) for kk, v in b.items() if not kk.startswith("_")}

    tb = make_batch()
    extents_j = jnp.asarray(extents)
    pts_eff, sym_eff = loss_point_scale(
        points, extents, symmetry, jnp.asarray(True)
    )

    params0 = model.init(
        jax.random.PRNGKey(0), tb["data"], extents_j, tb["meta"],
        tb.get("gt_poses"), tb.get("gt_valid"), train=False,
    )

    def loss_fn(params, batch, rng):
        out = model.apply(
            params, batch["data"], extents_j, batch["meta"],
            batch.get("gt_poses"), batch.get("gt_valid"),
            train=True, keep_prob=args.keep_prob, dropout_rng=rng,
        )
        w = out.hough.poses_weight
        valid = out.hough.valid
        weighted = (jnp.max(w, axis=1) > 0) & valid
        num_w = jnp.sum(weighted.astype(jnp.float32))
        lp = average_distance_loss(
            out.poses_pred, out.hough.poses_target, w,
            pts_eff, sym_eff, margin=0.01, num_valid=num_w,
        )
        # on-batch geodesic rotation error over weighted rows: both
        # pred and target are zero outside the active 4 channels, so
        # the row dot product IS the quaternion dot product
        dot = jnp.abs(jnp.sum(out.poses_pred * out.hough.poses_target, axis=1))
        ang = 2.0 * jnp.arccos(jnp.clip(dot, 0.0, 1.0)) * 180.0 / jnp.pi
        mean_ang = jnp.sum(jnp.where(weighted, ang, 0.0)) / jnp.maximum(num_w, 1.0)
        # tanh saturation over active channels
        sat = jnp.sum(
            jnp.abs(out.poses_tanh) * w
        ) / jnp.maximum(jnp.sum(w), 1.0)
        total = lp
        if args.qmag_w > 0:
            masked = out.poses_tanh * w
            mag = jnp.sqrt(jnp.sum(masked * masked, axis=1) + 1e-12)
            l_qmag = jnp.sum(
                jnp.where(weighted, (mag - 1.0) ** 2, 0.0)
            ) / jnp.maximum(num_w, 1.0)
            total = total + args.qmag_w * l_qmag
        metrics = {"loss_pose": lp, "rot_err": mean_ang, "tanh_abs": sat,
                   "num_w": num_w}
        if args.full_loss:
            labels_w = hard_label(out.prob, batch["label"], cfg.train.threshold_label)
            l_cls = loss_cross_entropy_single_frame(out.log_prob, labels_w)
            v_t, v_w = build_vertex_targets(
                batch["label"], batch["vertex_centers"], batch["vertex_logz"],
                batch["vertex_valid"], weight_inside=cfg.train.vertex_w_inside,
            )
            l_vert = cfg.train.vertex_w * smooth_l1_loss_vertex(
                out.vertex_pred, v_t, v_w
            )
            total = l_cls + l_vert + cfg.train.pose_w * lp
            metrics["loss_cls"] = l_cls
            metrics["loss_vertex"] = l_vert
        metrics["loss"] = total
        return total, metrics

    def pose_head_grad_norm(grads):
        s = 0.0
        for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
            name = "/".join(str(getattr(p, "key", "")) for p in path)
            if "pose_head" in name:
                s = s + jnp.sum(leaf.astype(jnp.float32) ** 2)
        return jnp.sqrt(s)

    # unit-lr transforms + post-scale: lr rides as a traced scalar so
    # every lr in the sweep reuses ONE compiled step per optimizer
    # family
    txs = {"momentum": optax.sgd(1.0, momentum=0.9), "adam": optax.adam(1.0)}
    steps = {}
    for name, tx in txs.items():

        def _step(params, opt_state, batch, rng, lr, tx=tx):
            (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, batch, rng
            )
            metrics["g_pose"] = pose_head_grad_norm(grads)
            updates, opt_state = tx.update(grads, opt_state, params)
            updates = jax.tree_util.tree_map(lambda u: lr * u, updates)
            params = optax.apply_updates(params, updates)
            return params, opt_state, metrics

        steps[name] = jax.jit(_step)

    results = []
    for spec in args.sweep.split(","):
        opt_name, lr_s = spec.strip().split(":")
        lr = float(lr_s)
        tx = txs[opt_name]
        step = steps[opt_name]
        params = jax.tree_util.tree_map(jnp.copy, params0)
        opt_state = tx.init(params)

        print(f"=== {opt_name} lr={lr} ===", flush=True)
        hist = []
        t0 = time.time()
        ema = None
        for it in range(1, args.iters + 1):
            rng = jax.random.PRNGKey(it)
            batch = make_batch() if args.fresh_batches else tb
            params, opt_state, metrics = step(
                params, opt_state, batch, rng, jnp.float32(lr)
            )
            if args.fresh_batches:
                # per-batch rot_err over 2 fresh images is far too
                # noisy to read a trend from — EMA it (host sync per
                # iter is already paid by make_batch)
                r = float(metrics["rot_err"])
                ema = r if ema is None else 0.98 * ema + 0.02 * r
            if it % args.log_every == 0 or it == 1:
                m = {kk: round(float(v), 4) for kk, v in metrics.items()}
                m["iter"] = it
                if ema is not None:
                    m["rot_err_ema"] = round(ema, 2)
                hist.append(m)
                ema_s = f" ema {ema:.1f}" if ema is not None else ""
                print(
                    f"  it {it}: loss_pose {m['loss_pose']:.4f} "
                    f"rot_err {m['rot_err']:.1f}{ema_s} "
                    f"tanh|.| {m['tanh_abs']:.3f} "
                    f"g_pose {m['g_pose']:.3f} num_w {m['num_w']:.0f} "
                    f"({(time.time()-t0)/it:.3f} s/it)",
                    flush=True,
                )
        results.append({
            "opt": opt_name, "lr": lr, "iters": args.iters,
            "fresh_batches": bool(args.fresh_batches),
            "full_loss": bool(args.full_loss),
            "keep_prob": args.keep_prob,
            "final_rot_err": hist[-1].get("rot_err_ema", hist[-1]["rot_err"]),
            "min_rot_err": min(h.get("rot_err_ema", h["rot_err"]) for h in hist),
            "history": hist,
        })
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(
        [{kk: r[kk] for kk in ("opt", "lr", "final_rot_err", "min_rot_err")}
         for r in results], indent=1))
    if args.assert_below > 0:
        bad = [r for r in results if r["min_rot_err"] >= args.assert_below]
        if bad:
            raise SystemExit(
                f"OVERFIT GUARD FAILED: {len(bad)} config(s) never got "
                f"below {args.assert_below} deg — the pose train path "
                f"has regressed (see PARITY.md r5 root-cause note)"
            )
        print(f"overfit guard ok: all configs < {args.assert_below} deg")


if __name__ == "__main__":
    main()
