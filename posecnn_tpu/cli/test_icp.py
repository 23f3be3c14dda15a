"""ICP-refinement subsystem drive: perturb GT poses, refine, report.

Equivalent of the reference's manual ICP check
(ref: tools/test_icp.py, launched by experiments/scripts/test_icp.sh,
which drives synthesizer.solveICP on sampled poses and inspects the
result visually). Here the drive is quantitative: render a synthetic
RGB-D scene with known ground-truth poses, perturb each pose, run the
batched Gauss-Newton refiner (refine/icp.py — the replacement for
lib/synthesize/synthesize.cpp:2052-2381), and report rotation /
translation error before vs after refinement, plus optional
visualization images.
"""

from __future__ import annotations

import json
import os

import numpy as np

from posecnn_tpu.cli.common import base_parser, load_config, setup_device


def main(argv=None):
    parser = base_parser("ICP pose-refinement subsystem check")
    parser.add_argument("--output", default="output/test_icp")
    parser.add_argument("--num_scenes", type=int, default=2)
    parser.add_argument("--rot_noise_deg", type=float, default=8.0)
    parser.add_argument("--trans_noise", type=float, default=0.03,
                        help="translation perturbation stddev (m)")
    parser.add_argument("--num_iters", type=int, default=8)
    parser.add_argument("--rot_perturb", type=float, default=0.0,
                        help="rotation-hypothesis half-angle (rad); 0 = off")
    parser.add_argument("--visualize", action="store_true")
    args = parser.parse_args(argv)
    setup_device(args)
    cfg = load_config(args)

    import jax
    import jax.numpy as jnp

    from posecnn_tpu.data.synthetic import SyntheticSceneGenerator
    from posecnn_tpu.refine.icp import icp_refine_batch
    from posecnn_tpu.utils.pose_error import re as rot_err, te as trans_err
    from posecnn_tpu.utils.quaternion import quat_to_mat_np, mat_to_quat_np

    c = cfg.train.num_classes
    w, h = cfg.train.syn_width, cfg.train.syn_height
    from posecnn_tpu.data.procedural import synthetic_class_library

    rng = np.random.RandomState(cfg.rng_seed)
    proc = synthetic_class_library(c, 512)
    pts, extents = proc.points, proc.extents
    k = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]], np.float32)
    gen = SyntheticSceneGenerator(
        pts, extents, k, width=w, height=h, t_near=cfg.train.syn_tnear,
        t_far=cfg.train.syn_tfar, pixel_means=cfg.pixel_means, seed=cfg.rng_seed,
        point_colors=proc.colors, point_normals=proc.normals,
    )

    os.makedirs(args.output, exist_ok=True)
    report = []
    for si in range(args.num_scenes):
        s = gen.render()
        objs = [(int(r[1]), r[6:10].astype(np.float32), r[10:13].astype(np.float32))
                for r in s.poses]
        if not objs:
            continue
        # perturb each GT pose (axis-angle rotation noise + gaussian t)
        quats, transs, model_pts, masks = [], [], [], []
        gt = []
        for cls, q, t in objs:
            ax = rng.randn(3)
            ax /= np.linalg.norm(ax) + 1e-12
            ang = np.deg2rad(args.rot_noise_deg) * rng.randn()
            dq = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * ax])
            r_pert = quat_to_mat_np(dq) @ quat_to_mat_np(q)
            q_pert = mat_to_quat_np(r_pert)
            t_pert = t + args.trans_noise * rng.randn(3).astype(np.float32)
            quats.append(q_pert.astype(np.float32))
            transs.append(t_pert.astype(np.float32))
            model_pts.append(pts[cls])
            masks.append(s.label == cls)
            gt.append((cls, q, t))
        res = icp_refine_batch(
            jnp.asarray(np.stack(quats)), jnp.asarray(np.stack(transs)),
            jnp.asarray(np.stack(model_pts)), jnp.asarray(s.depth),
            jnp.asarray(np.stack(masks)), jnp.asarray(k),
            num_iters=args.num_iters,
            rot_perturb=args.rot_perturb,
        )
        for i, (cls, q_gt, t_gt) in enumerate(gt):
            r_gt = quat_to_mat_np(q_gt)
            before = dict(
                re=float(rot_err(quat_to_mat_np(quats[i]), r_gt)),
                te=float(trans_err(transs[i], t_gt)),
            )
            after = dict(
                re=float(rot_err(quat_to_mat_np(np.asarray(res.quat[i])), r_gt)),
                te=float(trans_err(np.asarray(res.trans[i]), t_gt)),
                score=float(res.score[i]),
            )
            report.append(dict(scene=si, cls=cls, before=before, after=after))
            print(
                f"scene {si} cls {cls}: RE {before['re']:.2f}->{after['re']:.2f} deg, "
                f"TE {before['te'] * 100:.2f}->{after['te'] * 100:.2f} cm, "
                f"score {after['score']:.3f}"
            )
        if args.visualize:
            from posecnn_tpu.utils.visualize import draw_detections, save_image

            rgb = np.clip(s.image + gen.pixel_means, 0, 255)[:, :, ::-1]
            dets = [(int(cls), np.asarray(res.quat[i]), np.asarray(res.trans[i]))
                    for i, (cls, _, _) in enumerate(gt)]
            save_image(
                os.path.join(args.output, f"{si:03d}-refined.png"),
                draw_detections(rgb, dets, extents, k, gen.class_colors),
            )

    te_before = np.mean([r["before"]["te"] for r in report]) if report else 0.0
    te_after = np.mean([r["after"]["te"] for r in report]) if report else 0.0
    summary = dict(
        num_objects=len(report),
        mean_te_before_cm=float(te_before * 100),
        mean_te_after_cm=float(te_after * 100),
        objects=report,
    )
    with open(os.path.join(args.output, "icp_report.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "objects"}))


if __name__ == "__main__":
    main()
