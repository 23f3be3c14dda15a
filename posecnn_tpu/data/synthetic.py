"""Synthetic training-scene generator (host-side, no OpenGL).

Replaces the reference's live Pangolin/OpenGL synthesizer thread
(ref: lib/synthesize/synthesize.cpp render path + the render thread
in tools/train_net.py:304-317). Training hosts need no GL stack:
online mesh rasterization is replaced by a point-based software
renderer over the real YCB model point clouds: each object's points
are transformed by a sampled pose, projected with the camera
intrinsics, and splatted with z-buffering — producing label maps,
depth, per-pixel centers and the same training blobs the GL
synthesizer produced (image/label/meta/vertex targets/poses,
ref: tools/train_net.py:185-260).

Pose sampling follows both reference modes
(ref: synthesize.cpp:410-440, gated by TRAIN.SYN_SAMPLE_POSE,
config.py:88 / tools/train_net.py:195):

  uniform (SYN_SAMPLE_POSE=False): uniform rotations via random unit
    quaternions, translations uniform in the camera frustum with
    SYN_TNEAR/SYN_TFAR depth bounds (ref synthesize.cpp:424-440);
  pose-bank (SYN_SAMPLE_POSE=True): draw a random row from the class's
    real-pose bank [quat(4), t(3)] and perturb the quaternion channels
    by ±0.2 and the translation by ±0.1 m (ref synthesize.cpp:412-422).

Both modes enforce the reference's minimum center separation between
scene objects via rejection (ref synthesize.cpp:443-455).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from posecnn_tpu.data.minibatch import (
    build_meta_blob,
    build_pose_blob,
    generate_vertex_targets,
)


class SyntheticSample(NamedTuple):
    image: np.ndarray  # (H, W, 3) float32, mean-subtracted BGR
    label: np.ndarray  # (H, W) int32
    depth: np.ndarray  # (H, W) float32, meters (0 = empty)
    vertex_targets: Optional[np.ndarray]  # (H, W, 3C); None in sparse mode
    vertex_weights: Optional[np.ndarray]  # (H, W, 3C); None in sparse mode
    poses: np.ndarray  # (N, 13)
    meta: np.ndarray  # (48,)
    # sparse vertex-target inputs for the on-device builder
    # (ops/losses.build_vertex_targets): per-class center/log-depth
    vertex_centers: Optional[np.ndarray] = None  # (C, 2)
    vertex_logz: Optional[np.ndarray] = None  # (C,)
    vertex_valid: Optional[np.ndarray] = None  # (C,) bool


# host-side quaternion math lives in utils.quaternion (the generator
# always feeds UNIT quaternions, for which the normalizing
# quat_to_mat_np equals the unnormalized expansion)
from posecnn_tpu.utils.quaternion import (  # noqa: E402
    axis_angle_to_quat_np as _axis_angle_to_quat_np,
    quat_mul_np as _quat_mul_np,
    quat_to_mat_np as _quat_to_mat_np,
)


class SyntheticSceneGenerator:
    """Renders random multi-object scenes from class point clouds."""

    def __init__(
        self,
        points: np.ndarray,  # (C, P, 3) class point clouds (row 0 unused)
        extents: np.ndarray,  # (C, 3)
        intrinsics: np.ndarray,  # (3, 3)
        width: int = 640,
        height: int = 480,
        t_near: float = 0.5,
        t_far: float = 2.0,
        min_objects: int = 3,
        max_objects: int = 5,
        pixel_means: Sequence[float] = (102.9801, 115.9465, 122.7717),
        class_colors: Optional[np.ndarray] = None,
        splat_radius: int = 2,
        seed: int = 0,
        class_whitelist: Optional[Sequence[int]] = None,
        sample_object: bool = True,
        sample_pose: bool = False,
        pose_bank: Optional[Sequence[Optional[np.ndarray]]] = None,
        min_separation: float = 0.2,
        point_colors: Optional[np.ndarray] = None,  # (C, P, 3) RGB 0-255
        point_normals: Optional[np.ndarray] = None,  # (C, P, 3) unit
        backgrounds: Optional[np.ndarray] = None,  # (N, H, W, 3) BGR 0-255
        background_prob: float = 0.8,
    ):
        self.points = points.astype(np.float32)
        self.extents = extents.astype(np.float32)
        self.k = intrinsics.astype(np.float32)
        self.width = width
        self.height = height
        self.t_near = t_near
        self.t_far = t_far
        self.min_objects = min_objects
        self.max_objects = max_objects
        self.pixel_means = np.asarray(pixel_means, np.float32)
        self.num_classes = points.shape[0]
        self.splat_radius = splat_radius
        # restrict synthesized classes (ref: SYN_CLASS_INDEX
        # lib/fcn/config.py:84 — per-object configs render one class)
        self.class_whitelist = (
            np.asarray(sorted(class_whitelist), np.int64)
            if class_whitelist is not None
            else np.arange(1, points.shape[0])
        )
        # SYN_SAMPLE_OBJECT (ref: config.py:87, tools/train_net.py:194):
        # True = sample a random object subset per frame; False =
        # render the whole whitelist every frame (per-object configs)
        self.sample_object = sample_object
        # SYN_SAMPLE_POSE (ref: config.py:88, synthesize.cpp:412-422):
        # True = sample [quat, t] rows from the per-class real-pose
        # bank with ±0.2 quat / ±0.1 m jitter; False = uniform
        self.sample_pose = sample_pose
        self.pose_bank = pose_bank
        if sample_pose and pose_bank is None:
            raise ValueError("sample_pose=True requires a pose_bank")
        self.min_separation = min_separation
        self.rng = np.random.RandomState(seed)
        if class_colors is None:
            class_colors = self.make_class_colors(self.num_classes)
        self.class_colors = class_colors
        # per-point texture + normals (data/procedural.py): when given,
        # objects render with rotation-dependent appearance (procedural
        # texture × Lambertian shading) instead of a flat class color —
        # the data-level requirement for the rotation branch to learn
        # (the reference gets this for free from its textured YCB
        # meshes, lib/synthesize/synthesize.cpp render path)
        self.point_colors = (
            point_colors.astype(np.float32) if point_colors is not None else None
        )
        self.point_normals = (
            point_normals.astype(np.float32) if point_normals is not None else None
        )
        # real-image background compositing pool
        # (ref: gt_synthesize_layer/minibatch.py:128-160)
        self.backgrounds = backgrounds
        self.background_prob = background_prob

    @staticmethod
    def make_class_colors(num_classes: int) -> np.ndarray:
        """Distinct per-class colors (ref datasets assign fixed class
        colors, lov.py:31-37); deterministic hash palette."""
        cc = np.zeros((num_classes, 3), np.float32)
        for c in range(1, num_classes):
            cc[c] = [(c * 53) % 256, (c * 101) % 256, (c * 197) % 256]
        return cc

    def _sample_pose(self, cls: int = 0, prev_trans=()):
        """One pose draw honoring sample_pose mode + the min-separation
        rejection loop (ref synthesize.cpp:404-455; retries bounded)."""
        bank = None
        if self.sample_pose and self.pose_bank is not None:
            bank = self.pose_bank[cls] if cls < len(self.pose_bank) else None
            if bank is not None and len(bank) == 0:
                bank = None
        for _ in range(30):
            if bank is not None:
                row = bank[self.rng.randint(len(bank))]
                q = row[:4] + self.rng.uniform(-0.2, 0.2, 4)
                q /= np.linalg.norm(q) + 1e-12
                t = (row[4:7] + self.rng.uniform(-0.1, 0.1, 3)).astype(np.float32)
            else:
                q = self.rng.randn(4)
                q /= np.linalg.norm(q)
                z = self.rng.uniform(self.t_near, self.t_far)
                # keep the center inside the image with margin
                fx, fy = self.k[0, 0], self.k[1, 1]
                px, py = self.k[0, 2], self.k[1, 2]
                margin = 0.15
                u = self.rng.uniform(margin * self.width, (1 - margin) * self.width)
                v = self.rng.uniform(margin * self.height, (1 - margin) * self.height)
                t = np.array([(u - px) / fx * z, (v - py) / fy * z, z], np.float32)
            if all(
                np.linalg.norm(t - p) >= self.min_separation for p in prev_trans
            ):
                break
        return q.astype(np.float32), t

    def _scene_light(self) -> np.ndarray:
        """Per-scene random light direction (camera frame, unit)."""
        l = self.rng.randn(3).astype(np.float32)
        l[2] = -abs(l[2])  # from the camera half-space toward the scene
        return l / (np.linalg.norm(l) + 1e-12)

    def _splat_object(self, c, rot, t, depth, label, image, light):
        """Project + z-buffer-splat one posed object into the buffers.

        Textured path (point_colors set): per-point RGB = procedural
        texture × Lambertian shade from the rotated normals — the
        appearance model that makes rotation observable. Flat path
        otherwise (class color × depth shade, the round-1 behavior)."""
        h, w = depth.shape
        fx, fy = self.k[0, 0], self.k[1, 1]
        px, py = self.k[0, 2], self.k[1, 2]
        r = self.splat_radius
        if self.point_colors is not None:
            # adaptive splat radius: close objects project point
            # spacings beyond the default splat footprint, leaving
            # gaps the far surface speckles through (rotation-unstable
            # appearance noise). Estimate the projected point spacing
            # from the bbox surface area and widen the splat to cover.
            ext = self.extents[c]
            area = 2.0 * (
                ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0]
            )
            spacing_m = float(np.sqrt(max(area, 1e-8) / self.points.shape[1]))
            spacing_px = spacing_m * float(fx) / max(float(t[2]), 1e-3)
            # cap 7 (was 5): at close range the projected point
            # spacing exceeded the splat footprint and background
            # speckled through the surface — high-frequency noise of
            # the same scale as any fine texture (r5 contact sheet)
            r = int(np.clip(round(1.0 * spacing_px), self.splat_radius, 7))
        pts = self.points[c] @ rot.T + t
        z = pts[:, 2]
        ok = z > 1e-3
        u = np.round(fx * pts[ok, 0] / z[ok] + px).astype(np.int64)
        v = np.round(fy * pts[ok, 1] / z[ok] + py).astype(np.int64)
        zok = z[ok].astype(np.float32)
        from posecnn_tpu.data.native import (
            splat_points_native,
            splat_points_rgb_native,
        )

        if self.point_colors is not None:
            n_cam = (self.point_normals[c] @ rot.T)[ok]
            # ambient 0.55: the former 0.35+0.65 swing gave the random
            # per-scene light a 2.9x brightness range — the same order
            # as any brightness-coded texture, which made orientation
            # unrecoverable from appearance (r5 NN-oracle diagnosis,
            # probe_data_nn.py). Shape shading cues survive at 0.45.
            shade = 0.55 + 0.45 * np.clip(n_cam @ light, 0.0, 1.0)
            rgb = np.clip(
                self.point_colors[c][ok] * shade[:, None], 0.0, 255.0
            ).astype(np.float32)
            if splat_points_rgb_native(
                u.astype(np.int32), v.astype(np.int32), zok, rgb, int(c), r,
                depth, label, image,
            ):
                return
            # NumPy fallback: same two-pass visibility splat as the
            # native kernel (pass 1 min-depth, pass 2 nearest point in
            # the eps visible band wins color/label — no back-surface
            # poke-through speckle)
            eps = 0.01
            for dv in range(-r, r + 1):
                for du in range(-r, r + 1):
                    uu = u + du
                    vv = v + dv
                    inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
                    ui, vi, zi = uu[inb], vv[inb], zok[inb]
                    srt = np.argsort(-zi)
                    ui, vi, zi = ui[srt], vi[srt], zi[srt]
                    closer = zi < depth[vi, ui]
                    ui, vi, zi = ui[closer], vi[closer], zi[closer]
                    depth[vi, ui] = zi
            color_z = np.full_like(depth, 1e30)
            for dv in range(-r, r + 1):
                for du in range(-r, r + 1):
                    uu = u + du
                    vv = v + dv
                    inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
                    ui, vi, zi, ci = uu[inb], vv[inb], zok[inb], rgb[inb]
                    srt = np.argsort(-zi)
                    ui, vi, zi, ci = ui[srt], vi[srt], zi[srt], ci[srt]
                    ok2 = (zi <= depth[vi, ui] + eps) & (zi < color_z[vi, ui])
                    ui, vi, zi, ci = ui[ok2], vi[ok2], zi[ok2], ci[ok2]
                    color_z[vi, ui] = zi
                    label[vi, ui] = c
                    image[vi, ui] = ci
            return
        if not splat_points_native(
            u.astype(np.int32), v.astype(np.int32), zok, int(c), r,
            self.class_colors[c], self.t_far, depth, label, image,
        ):
            for dv in range(-r, r + 1):
                for du in range(-r, r + 1):
                    uu = u + du
                    vv = v + dv
                    inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
                    ui, vi, zi = uu[inb], vv[inb], zok[inb]
                    # z-buffer via sorted last-write-wins: far→near
                    srt = np.argsort(-zi)
                    ui, vi, zi = ui[srt], vi[srt], zi[srt]
                    closer = zi < depth[vi, ui]
                    ui, vi, zi = ui[closer], vi[closer], zi[closer]
                    depth[vi, ui] = zi
                    label[vi, ui] = c
                    shade = np.clip(1.6 - zi / self.t_far, 0.4, 1.3)[:, None]
                    image[vi, ui] = self.class_colors[c][None, :] * shade

    def _fill_background(self, label, image):
        """Paint label-0 pixels: composite a real image from the pool
        with probability background_prob (ref: minibatch.py:128-160),
        else domain-randomization noise."""
        bg = label == 0
        if (
            self.backgrounds is not None
            and len(self.backgrounds)
            and self.rng.rand() < self.background_prob
        ):
            bgim = self.backgrounds[self.rng.randint(len(self.backgrounds))]
            h, w = label.shape
            if bgim.shape[0] >= h and bgim.shape[1] >= w:
                oy = self.rng.randint(bgim.shape[0] - h + 1)
                ox = self.rng.randint(bgim.shape[1] - w + 1)
                crop = bgim[oy : oy + h, ox : ox + w]
            else:  # pool image smaller than the frame: tile
                ry = -(-h // bgim.shape[0])
                rx = -(-w // bgim.shape[1])
                crop = np.tile(bgim, (ry, rx, 1))[:h, :w]
            gain = self.rng.uniform(0.6, 1.1)
            image[bg] = crop[bg] * gain
        else:
            image[bg] = self.rng.uniform(0, 60, size=(int(bg.sum()), 3))

    def render(self, dense_vertex_targets: bool = True) -> SyntheticSample:
        h, w = self.height, self.width
        n_obj = self.rng.randint(self.min_objects, self.max_objects + 1)
        if self.sample_object:
            classes = self.rng.choice(
                self.class_whitelist,
                size=min(n_obj, len(self.class_whitelist)),
                replace=False,
            )
        else:
            classes = self.class_whitelist[: max(self.max_objects, 1)]
        depth = np.full((h, w), np.inf, np.float32)
        label = np.zeros((h, w), np.int32)
        image = np.zeros((h, w, 3), np.float32)

        quats, trans, centers, zs, used = [], [], [], [], []
        fx, fy = self.k[0, 0], self.k[1, 1]
        px, py = self.k[0, 2], self.k[1, 2]
        light = self._scene_light()

        for c in classes:
            q, t = self._sample_pose(int(c), trans)
            rot = _quat_to_mat_np(q)
            self._splat_object(int(c), rot, t, depth, label, image, light)
            quats.append(q)
            trans.append(t)
            centers.append([fx * t[0] / t[2] + px, fy * t[1] / t[2] + py])
            zs.append(t[2])
            used.append(c)

        depth[np.isinf(depth)] = 0.0
        self._fill_background(label, image)

        used = np.asarray(used, np.int64)
        centers = np.asarray(centers, np.float32)
        zs = np.asarray(zs, np.float32)
        if dense_vertex_targets:
            targets, weights = generate_vertex_targets(
                label, used, centers, zs, self.num_classes
            )
        else:
            targets = weights = None
        # per-class sparse form for the on-device target builder
        v_centers = np.zeros((self.num_classes, 2), np.float32)
        v_logz = np.zeros((self.num_classes,), np.float32)
        v_valid = np.zeros((self.num_classes,), bool)
        for i, cc in enumerate(used):
            v_centers[cc] = centers[i]
            v_logz[cc] = np.log(max(float(zs[i]), 1e-6))
            v_valid[cc] = True
        poses = build_pose_blob(
            0, used, np.asarray(quats, np.float32), np.asarray(trans, np.float32), centers
        )
        meta = build_meta_blob(self.k)
        return SyntheticSample(
            image=image - self.pixel_means,
            label=label,
            depth=depth,
            vertex_targets=targets,
            vertex_weights=weights,
            poses=poses,
            meta=meta,
            vertex_centers=v_centers,
            vertex_logz=v_logz,
            vertex_valid=v_valid,
        )

    def minibatch(self, batch_size: int, max_gt: int = 16, dense_vertex_targets: bool = True):
        """Stacked training batch with fixed-size GT padding.

        dense_vertex_targets=False ships per-class vertex_centers /
        vertex_logz / vertex_valid instead of the (H, W, 3C) maps; the
        train step builds the dense targets on device
        (ops/losses.build_vertex_targets) — ~160 MB/frame less host
        work and host→device transfer at 480×640×22 classes."""
        samples = [
            self.render(dense_vertex_targets=dense_vertex_targets)
            for _ in range(batch_size)
        ]
        return self._collate(samples, max_gt, dense_vertex_targets)

    def pooled_minibatch(
        self,
        batch_size: int,
        max_gt: int = 16,
        dense_vertex_targets: bool = True,
        pool_size: int = 512,
        fresh: int = 2,
    ):
        """Replay-pool batch: render only `fresh` NEW scenes per call
        and fill the batch from a rolling pool of recent scenes.

        Extension beyond the reference (its GtSynthesizeLayer renders
        every frame fresh, lib/gt_synthesize_layer/layer.py): this host
        has few cores and CPU-side scene synthesis caps the sample
        rate, while the device step is ~free at small batches — so fresh
        rendering bounds batch size at ~2. From-scratch training is
        sample-starved at batch 2 (the r5 tiny-CNN calibration needed
        ~10^5 sample-presentations before rotation generalized). The
        pool decouples the two: device batches of 16-32 at the host
        cost of `fresh` renders/step. Scenes repeat across nearby
        steps (with different RoI jitter/dropout), which is strictly
        between 'fixed dataset epochs' (the reference's real-image
        mode) and 'every frame fresh'."""
        if not hasattr(self, "_pool"):
            self._pool: list = []
        n_new = fresh if self._pool else batch_size
        for _ in range(n_new):
            self._pool.append(self.render(dense_vertex_targets=dense_vertex_targets))
        if len(self._pool) > pool_size:
            del self._pool[: len(self._pool) - pool_size]
        idx = self.rng.randint(0, len(self._pool), batch_size)
        samples = [self._pool[i] for i in idx]
        batch = self._collate(samples, max_gt, dense_vertex_targets)
        # per-draw gaussian noise decorrelates repeated pool scenes:
        # without it a net memorizes each scene's splat-speckle
        # fingerprint instead of reading the texture (r5 tiny-CNN
        # calibration — train loss 1e-4 in 250 steps, test at chance)
        batch["data"] = batch["data"] + self.rng.randn(
            *batch["data"].shape
        ).astype(np.float32) * 8.0
        return batch

    def _collate(self, samples, max_gt: int, dense_vertex_targets: bool):
        c = self.num_classes
        h, w = self.height, self.width
        batch = {
            "data": np.stack([s.image for s in samples]),
            "label": np.stack([s.label for s in samples]),
            "depth": np.stack([s.depth for s in samples]),
            "meta": np.stack([s.meta for s in samples]),
        }
        if dense_vertex_targets:
            batch["vertex_targets"] = np.stack([s.vertex_targets for s in samples])
            batch["vertex_weights"] = np.stack([s.vertex_weights for s in samples])
        else:
            batch["vertex_centers"] = np.stack([s.vertex_centers for s in samples])
            batch["vertex_logz"] = np.stack([s.vertex_logz for s in samples])
            batch["vertex_valid"] = np.stack([s.vertex_valid for s in samples])
        gt = np.zeros((max_gt, 13), np.float32)
        gt_valid = np.zeros((max_gt,), bool)
        row = 0
        for i, s in enumerate(samples):
            for j in range(s.poses.shape[0]):
                if row >= max_gt:
                    break
                gt[row] = s.poses[j]
                gt[row, 0] = i
                gt_valid[row] = True
                row += 1
        batch["gt_poses"] = gt
        batch["gt_valid"] = gt_valid
        return batch


class SyntheticSequenceGenerator:
    """Multi-frame sequences with camera motion — the video training
    feeder (ref: lib/gt_data_layer/ GtDataLayer, NUM_STEPS-frame
    minibatches minibatch.py:20-310). Objects are fixed in the world;
    the camera orbits slightly per frame; meta carries pose_world2live
    / live2world (meta[18:42]) for the compute_flow warp."""

    def __init__(self, scene_gen: SyntheticSceneGenerator, num_steps: int = 5,
                 cam_step_t: float = 0.01, cam_step_r: float = 0.02):
        self.gen = scene_gen
        self.num_steps = num_steps
        self.cam_step_t = cam_step_t
        self.cam_step_r = cam_step_r

    def render_sequence(self):
        """Returns dict of (T, H, W, ...) arrays + per-frame meta with
        relative camera transforms."""
        g = self.gen
        rng = g.rng
        # base scene (frame 0 camera = world frame)
        base = g.render()
        frames = {"image": [base.image], "label": [base.label],
                  "depth": [base.depth], "meta": [base.meta]}
        # per-frame camera pose: world→live accumulates a small motion
        cam_q = np.array([1.0, 0, 0, 0], np.float32)
        cam_t = np.zeros(3, np.float32)
        n_obj = base.poses.shape[0]
        for _ in range(1, self.num_steps):
            axis = rng.randn(3).astype(np.float32)
            dq = _axis_angle_to_quat_np(
                axis, np.float32(rng.uniform(-self.cam_step_r, self.cam_step_r))
            )
            cam_q = _quat_mul_np(dq, cam_q)
            cam_t = cam_t + rng.uniform(-self.cam_step_t, self.cam_step_t, 3).astype(np.float32)
            r = _quat_to_mat_np(cam_q)
            w2l = np.concatenate([r, cam_t[:, None]], 1).astype(np.float32)
            l2w = np.concatenate([r.T, (-r.T @ cam_t)[:, None]], 1).astype(np.float32)

            # re-render the SAME objects from the new camera via the
            # shared splat path (composed camera∘object rotation keeps
            # texture/shading consistent across the sequence)
            h, w = g.height, g.width
            depth = np.full((h, w), np.inf, np.float32)
            label = np.zeros((h, w), np.int32)
            image = np.zeros((h, w, 3), np.float32)
            light = g._scene_light()

            for i in range(n_obj):
                c = int(base.poses[i, 1])
                rot_obj = _quat_to_mat_np(base.poses[i, 6:10])
                t_obj = base.poses[i, 10:13]
                rot_cam = r @ rot_obj
                t_cam = r @ t_obj + cam_t
                g._splat_object(c, rot_cam, t_cam, depth, label, image, light)
            depth[np.isinf(depth)] = 0.0
            g._fill_background(label, image)
            meta = build_meta_blob(g.k, w2l, l2w)
            frames["image"].append(image - g.pixel_means)
            frames["label"].append(label)
            frames["depth"].append(depth)
            frames["meta"].append(meta)
        return {k: np.stack(v) for k, v in frames.items()}

    def minibatch(self, batch_size: int):
        """(T, B, ...) stacked sequences."""
        seqs = [self.render_sequence() for _ in range(batch_size)]
        return {
            k: np.stack([s[k] for s in seqs], axis=1) for k in seqs[0]
        }
