"""Evaluation: segmentation IoU + 6D pose metrics + AUC aggregation.

Matches the reference evaluators:
  seg IoU       — confusion-histogram diag/union
                  (ref: lib/datasets/lov.py:405-420, imdb.fast_hist
                   lib/datasets/imdb.py:123-126)
  YCB success   — ADD(-S) < 0.1·‖extents‖₂, ADI classes use the
                  symmetric metric (ref: lov.py:484-487,539-541)
  LINEMOD       — ADD(-S) < 0.1·diameter + reproj < 5 px
                  (ref: linemod.py:649-653,731-751)
  AUC           — accuracy-vs-threshold area (PoseCNN paper metric)

Device-side: the per-image pose errors batch through the jitted
ADD/ADI kernels (matmul pairwise distances); host-side: accumulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from posecnn_tpu.utils import pose_error
from posecnn_tpu.utils.quaternion import quat_to_mat


def fast_hist(gt: np.ndarray, pred: np.ndarray, n: int) -> np.ndarray:
    """Confusion histogram (ref: imdb.fast_hist imdb.py:123-126)."""
    k = (gt >= 0) & (gt < n)
    return np.bincount(n * gt[k].astype(int) + pred[k], minlength=n**2).reshape(n, n)


def iou_from_hist(hist: np.ndarray) -> np.ndarray:
    """Per-class IoU (ref: lov.py:412-417)."""
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    return np.diag(hist) / np.maximum(denom, 1e-10)


@jax.jit
def _pose_errors_one(quat_est, t_est, quat_gt, t_gt, pts, k):
    r_est = quat_to_mat(quat_est)
    r_gt = quat_to_mat(quat_gt)
    return (
        pose_error.add_error(r_est, t_est, r_gt, t_gt, pts),
        pose_error.adi_error(r_est, t_est, r_gt, t_gt, pts),
        pose_error.re(r_est, r_gt),
        pose_error.te(t_est, t_gt),
        pose_error.reproj_error(k, r_est, t_est, r_gt, t_gt, pts),
    )


# 180° rotation about the object z axis, for classes with that
# symmetry (LINEMOD eggbox handling, ref: linemod.py:731-751)
_Z_FLIP = np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # wxyz: rot z by π


@dataclass
class PoseEvaluator:
    """Accumulates detections vs GT across images and reports the
    reference's aggregate metrics (ref: lov.py:518-660 evaluation)."""

    num_classes: int
    points: np.ndarray  # (C, P, 3)
    extents: np.ndarray  # (C, 3)
    symmetric_classes: tuple = ()  # class ids evaluated with ADI
    # LINEMOD-style options (ref: linemod.py:626-830)
    z_flip_classes: tuple = ()  # classes with 180° Z ambiguity (eggbox)
    diameters: Optional[np.ndarray] = None  # (C,) for 0.1·d threshold
    intrinsics: Optional[np.ndarray] = None  # (3,3) enables reproj metric
    reproj_threshold_px: float = 5.0
    # greedy per-instance matching (NEW, flag-gated; default stays
    # reference-faithful single-instance-per-class — lov.py:451-516).
    # With True, detections and GTs of the same class are matched
    # greedily by translation distance so multi-instance scenes don't
    # collapse to one detection per class (the detection variant's
    # scenes, ref .cu.cc:335-383 multi-instance Hough mode).
    instance_matching: bool = False
    # per-class accumulators
    errors_add: Dict[int, List[float]] = field(default_factory=dict)
    errors_adi: Dict[int, List[float]] = field(default_factory=dict)
    errors_rot: Dict[int, List[float]] = field(default_factory=dict)
    errors_trans: Dict[int, List[float]] = field(default_factory=dict)
    errors_reproj: Dict[int, List[float]] = field(default_factory=dict)
    num_gt: Dict[int, int] = field(default_factory=dict)
    num_images: int = 0  # images passed through add_image (sample size)
    seg_hist: Optional[np.ndarray] = None

    def __post_init__(self):
        self.seg_hist = np.zeros((self.num_classes, self.num_classes), np.int64)
        if self.intrinsics is None:
            self.intrinsics = np.eye(3, dtype=np.float32)

    def add_segmentation(self, gt_label: np.ndarray, pred_label: np.ndarray):
        self.seg_hist += fast_hist(
            gt_label.flatten(), pred_label.flatten(), self.num_classes
        )

    def _record_miss(self, cls: int):
        for acc in (self.errors_add, self.errors_adi, self.errors_rot,
                    self.errors_trans, self.errors_reproj):
            acc.setdefault(cls, []).append(np.inf)

    def _record_pair(self, cls: int, q_est, t_est, q_gt, t_gt):
        """Compute + accumulate all error metrics for one det/GT pair
        (incl. the 180°-Z-flip retry for z_flip_classes)."""

        def errs(q_gt_use):
            return _pose_errors_one(
                jnp.asarray(q_est, jnp.float32),
                jnp.asarray(t_est, jnp.float32),
                jnp.asarray(np.asarray(q_gt_use), jnp.float32),
                jnp.asarray(np.asarray(t_gt), jnp.float32),
                jnp.asarray(self.points[cls], jnp.float32),
                jnp.asarray(self.intrinsics, jnp.float32),
            )

        add, adi, rot, trans, rp = errs(q_gt)
        if cls in self.z_flip_classes:
            # try the 180°-Z-flipped GT too, keep the better
            # (ref: linemod.py eggbox handling :731-751)
            from posecnn_tpu.utils.quaternion import quat_mul

            q_flip = np.asarray(
                quat_mul(jnp.asarray(np.asarray(q_gt), jnp.float32), jnp.asarray(_Z_FLIP))
            )
            add2, adi2, rot2, trans2, rp2 = errs(q_flip)
            if float(add2) < float(add):
                add, adi, rot, trans, rp = add2, adi2, rot2, trans2, rp2
        self.errors_add.setdefault(cls, []).append(float(add))
        self.errors_adi.setdefault(cls, []).append(float(adi))
        self.errors_rot.setdefault(cls, []).append(float(rot))
        self.errors_trans.setdefault(cls, []).append(float(trans))
        self.errors_reproj.setdefault(cls, []).append(float(rp))

    def add_image(self, detections: list, gts: list):
        """detections: [(cls, quat(4), t(3))]; gts: [(cls, quat, t)].

        Default: each GT is matched to the first detection of its
        class (single-instance-per-class, as the reference eval
        assumes, lov.py:451-516). With instance_matching=True,
        same-class det/GT pairs are matched greedily by translation
        distance (closest pair first, each det used once). Unmatched
        GT counts as infinite error either way."""
        self.num_images += 1
        if not self.instance_matching:
            det_by_cls = {}
            for cls, q, t in detections:
                det_by_cls.setdefault(int(cls), (np.asarray(q), np.asarray(t)))
            for cls, q_gt, t_gt in gts:
                cls = int(cls)
                self.num_gt[cls] = self.num_gt.get(cls, 0) + 1
                if cls not in det_by_cls:
                    self._record_miss(cls)
                    continue
                q_est, t_est = det_by_cls[cls]
                self._record_pair(cls, q_est, t_est, q_gt, t_gt)
            return

        dets_by_cls: Dict[int, list] = {}
        for cls, q, t in detections:
            dets_by_cls.setdefault(int(cls), []).append(
                (np.asarray(q), np.asarray(t, np.float64))
            )
        gts_by_cls: Dict[int, list] = {}
        for cls, q_gt, t_gt in gts:
            gts_by_cls.setdefault(int(cls), []).append(
                (np.asarray(q_gt), np.asarray(t_gt, np.float64))
            )
        for cls, gts_c in gts_by_cls.items():
            self.num_gt[cls] = self.num_gt.get(cls, 0) + len(gts_c)
            dets_c = dets_by_cls.get(cls, [])
            if not dets_c:
                for _ in gts_c:
                    self._record_miss(cls)
                continue
            # greedy closest-translation matching; NaN translations
            # (degenerate box fits) become inf so one bad detection
            # can't abort matching for the whole class
            dist = np.full((len(dets_c), len(gts_c)), np.inf)
            for i, (_, t_d) in enumerate(dets_c):
                for j, (_, t_g) in enumerate(gts_c):
                    dist[i, j] = np.linalg.norm(t_d - t_g)
            dist = np.nan_to_num(dist, nan=np.inf, posinf=np.inf)
            matched_gt = set()
            while True:
                i, j = np.unravel_index(np.argmin(dist), dist.shape)
                if not np.isfinite(dist[i, j]):
                    break
                q_est, t_est = dets_c[i]
                q_gt, t_gt = gts_c[j]
                self._record_pair(cls, q_est, t_est, q_gt, t_gt)
                matched_gt.add(j)
                dist[i, :] = np.inf
                dist[:, j] = np.inf
            for j in range(len(gts_c)):
                if j not in matched_gt:
                    self._record_miss(cls)

    def _metric_errors(self, cls: int) -> List[float]:
        if cls in self.symmetric_classes:
            return self.errors_adi.get(cls, [])
        return self.errors_add.get(cls, [])

    def summarize(self, auc_max: float = 0.1) -> dict:
        # num_images + per-class count ship in every artifact so no
        # accuracy claim is quoted without its sample size (r4 verdict
        # task 3: the n=20 oracle made per-class numbers noise)
        out = {"per_class": {}, "num_images": int(self.num_images)}
        all_err, all_err_s = [], []
        for cls in sorted(self.num_gt):
            errs = np.asarray(self._metric_errors(cls))
            errs_s = np.asarray(self.errors_adi.get(cls, []))
            if errs.size == 0:
                continue
            if self.diameters is not None:
                # LINEMOD: 0.1·object diameter (ref: linemod.py:649-653)
                thresh = 0.1 * float(self.diameters[cls])
            else:
                # YCB: 0.1·‖extents‖₂ (ref: lov.py:484-487)
                thresh = 0.1 * np.linalg.norm(self.extents[cls])
            auc = float(
                pose_error.auc_of_errors(jnp.asarray(errs), max_threshold=auc_max)
            )
            auc_s = float(
                pose_error.auc_of_errors(jnp.asarray(errs_s), max_threshold=auc_max)
            )
            row = {
                "count": int(self.num_gt[cls]),
                "success_rate": float((errs < thresh).mean()),
                "add_auc": auc,
                "adds_auc": auc_s,
                "mean_rot_deg": float(np.mean([e for e in self.errors_rot[cls] if np.isfinite(e)] or [np.inf])),
                "mean_trans_m": float(np.mean([e for e in self.errors_trans[cls] if np.isfinite(e)] or [np.inf])),
            }
            reproj = np.asarray(self.errors_reproj.get(cls, []))
            if reproj.size:
                # reprojection success < 5 px (ref: linemod.py reproj)
                row["reproj_success_rate"] = float(
                    (reproj < self.reproj_threshold_px).mean()
                )
            out["per_class"][cls] = row
            all_err.extend(errs.tolist())
            all_err_s.extend(errs_s.tolist())
        if all_err:
            out["add_auc"] = float(
                pose_error.auc_of_errors(jnp.asarray(np.asarray(all_err)), max_threshold=auc_max)
            )
            out["adds_auc"] = float(
                pose_error.auc_of_errors(jnp.asarray(np.asarray(all_err_s)), max_threshold=auc_max)
            )
        iou = iou_from_hist(self.seg_hist)
        out["seg_iou_per_class"] = iou.tolist()
        observed = self.seg_hist.sum(1) > 0
        out["seg_mean_iou"] = float(iou[observed].mean()) if observed.any() else 0.0
        return out


def format_per_class_table(summary: dict, class_names=None) -> str:
    """Reference-style per-class pose-accuracy report (ref:
    lib/datasets/lov.py:518-660 evaluate_result's per-class printout):
    one row per class with its sample count, ADD(-S) success at the
    0.1-extent/diameter threshold, AUCs, rotation/translation means,
    and reprojection success where recorded. Every number is quoted
    WITH its n (r4 verdict task 3)."""
    rows = []
    head = (
        f"{'class':<22}{'n':>6}{'succ':>8}{'add_auc':>9}{'adds_auc':>10}"
        f"{'rot_deg':>9}{'trans_m':>9}{'reproj':>8}"
    )
    rows.append(head)
    rows.append("-" * len(head))
    for cls, r in sorted(summary.get("per_class", {}).items(), key=lambda kv: int(kv[0])):
        name = (
            class_names[int(cls)]
            if class_names is not None and int(cls) < len(class_names)
            else str(cls)
        )
        rot = r.get("mean_rot_deg", float("inf"))
        trans = r.get("mean_trans_m", float("inf"))
        rp = r.get("reproj_success_rate")
        rows.append(
            f"{name:<22}{r['count']:>6}{r['success_rate']:>8.3f}"
            f"{r['add_auc']:>9.3f}{r['adds_auc']:>10.3f}"
            f"{rot:>9.1f}{trans:>9.3f}"
            + (f"{rp:>8.3f}" if rp is not None else f"{'-':>8}")
        )
    mean_s = np.mean([r["success_rate"] for r in summary.get("per_class", {}).values()] or [0.0])
    rows.append("-" * len(head))
    rows.append(
        f"{'ALL':<22}{summary.get('num_images', 0):>6}{mean_s:>8.3f}"
        f"{summary.get('add_auc', 0.0):>9.3f}{summary.get('adds_auc', 0.0):>10.3f}"
        f"  (n = images; per-class n = GT instances)"
    )
    return "\n".join(rows)


def extract_detections(
    hough_rois, poses_init, poses_pred, valid, num_classes: int, *, with_indices=False
):
    """Convert fixed-shape model outputs into (cls, quat, t) detections:
    translation from the Hough initial pose (backprojected center ray ×
    voted depth), rotation from the regressed per-class quaternion
    (ref: lib/fcn/test.py:206-211 merge of fc8 quats into poses).

    Detections are ordered by vote score descending, so per-class
    first-match consumers (PoseEvaluator.add_image) pick the strongest.
    With with_indices=True each row is (cls, quat, t, roi_index) so
    callers can join back to the roi buffer — do NOT re-zip by
    position, the order differs from the buffer."""
    rois = np.asarray(hough_rois)
    init = np.asarray(poses_init)
    quats = np.asarray(poses_pred)
    valid = np.asarray(valid)
    dets = []
    for i in range(rois.shape[0]):
        if not valid[i]:
            continue
        cls = int(rois[i, 1])
        if quats is not None:
            q = quats[i, 4 * cls : 4 * cls + 4]
            n = np.linalg.norm(q)
            q = q / n if n > 1e-6 else init[i, :4]
        else:
            q = init[i, :4]
        dets.append((cls, q, init[i, 4:7], i))
    dets.sort(key=lambda d: -float(rois[d[3], 6]))
    if with_indices:
        return dets
    return [(c, q, t) for c, q, t, _ in dets]


def detection_ap(
    all_dets: list,
    all_gts: list,
    num_classes: int,
    iou_threshold: float = 0.5,
) -> dict:
    """VOC-style average precision for box detections
    (ref: imdb.evaluate_detections consumers of test_net_detection,
    lib/fcn/test.py:1472-1690 — the reference defers to per-dataset
    evaluators; this is the standard greedy-match AP@IoU).

    all_dets: per image, list of (cls, score, box4 xyxy).
    all_gts:  per image, list of (cls, box4 xyxy).
    Returns {"map": float, "per_class": {cls: ap}}.
    """

    def _iou(a, b):
        ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
        ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
        iw, ih = max(ix2 - ix1, 0.0), max(iy2 - iy1, 0.0)
        inter = iw * ih
        ua = (
            (a[2] - a[0]) * (a[3] - a[1])
            + (b[2] - b[0]) * (b[3] - b[1])
            - inter
        )
        return inter / ua if ua > 0 else 0.0

    per_class = {}
    for c in range(1, num_classes):
        npos = sum(1 for gts in all_gts for g in gts if int(g[0]) == c)
        if npos == 0:
            continue
        rows = []  # (score, image_idx, box)
        for i, dets in enumerate(all_dets):
            for cls, score, box in dets:
                if int(cls) == c:
                    rows.append((float(score), i, np.asarray(box, np.float64)))
        rows.sort(key=lambda r: -r[0])
        matched = [set() for _ in all_gts]
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for r, (score, i, box) in enumerate(rows):
            gts = [
                (j, np.asarray(g[1], np.float64))
                for j, g in enumerate(all_gts[i])
                if int(g[0]) == c
            ]
            best, best_j = 0.0, -1
            for j, gbox in gts:
                ov = _iou(box, gbox)
                if ov > best:
                    best, best_j = ov, j
            if best >= iou_threshold and best_j not in matched[i]:
                tp[r] = 1
                matched[i].add(best_j)
            else:
                fp[r] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-10)
        # precision envelope + area under PR (continuous VOC AP)
        mrec = np.concatenate([[0.0], recall, [1.0]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for k in range(len(mpre) - 2, -1, -1):
            mpre[k] = max(mpre[k], mpre[k + 1])
        idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
        per_class[c] = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    mean_ap = float(np.mean(list(per_class.values()))) if per_class else 0.0
    return {"map": mean_ap, "per_class": per_class}
