"""PoseTrack evaluation: per-joint keypoint AP and MOTA, plus COCO-OKS AP
(port of detectandtrack_tpu/tracking/evaluation.py).

Reference parity: the reference leans on the external `poseval` package
for PoseTrack metrics and pycocotools for COCO-style keypoint AP. This
module implements both protocols from scratch:

PoseTrack protocol (per joint j):
  1. Per frame, predicted poses are matched to GT poses with Hungarian
     assignment on the PCKh distance (joint correct if
     ||pred − gt|| ≤ 0.5 · headSize; pose distance = 1 − matched fraction).
  2. AP_j: score-ranked PR curve over all frames for joint j (a matched,
     within-threshold joint is a TP; unmatched predictions and matched-but-
     far joints are FP; unmatched GT joints are FN). Final mAP = mean AP_j.
  3. MOTA_j = 1 − (FN_j + FP_j + IDSW_j) / nGT_j, ID switches counted on
     the pose-level track id of the matched pair. Final MOTA = mean over
     joints (the PoseTrack convention).

headSize: PoseTrack provides per-person head bounding boxes;
`head_size = 0.6 · diag(head_box)` (MPII convention). When head boxes are
absent we fall back to 0.3 · diag(person box) — flagged in the result dict.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.keypoints import POSETRACK_OKS_SIGMAS, compute_oks
from .native import solve_assignment

PCKH_THRESH = 0.5


@dataclass
class PoseAnnotation:
    """One person in one frame (GT or prediction)."""
    keypoints: np.ndarray                  # (K, 3) x, y, vis/score
    box: Optional[np.ndarray] = None       # (4,) x1y1x2y2
    head_box: Optional[np.ndarray] = None  # (4,)
    track_id: int = -1
    score: float = 1.0


def head_size(ann: PoseAnnotation) -> float:
    if ann.head_box is not None:
        hb = ann.head_box
        return 0.6 * float(np.hypot(hb[2] - hb[0], hb[3] - hb[1]))
    if ann.box is not None:
        b = ann.box
        return 0.3 * float(np.hypot(b[2] - b[0], b[3] - b[1]))
    # Last resort: keypoint extent.
    k = ann.keypoints
    vis = k[:, 2] > 0 if k.shape[1] > 2 else np.ones(len(k), bool)
    if vis.sum() >= 2:
        xs, ys = k[vis, 0], k[vis, 1]
        return max(0.3 * float(np.hypot(xs.max() - xs.min(),
                                        ys.max() - ys.min())), 1.0)
    return 1.0


def _match_frame(gts: Sequence[PoseAnnotation],
                 preds: Sequence[PoseAnnotation]) -> List[Tuple[int, int]]:
    """Hungarian pose-level matching on PCKh distance → [(gt_i, pred_j)]."""
    g, p = len(gts), len(preds)
    if g == 0 or p == 0:
        return []
    cost = np.ones((g, p), np.float64)
    for i, gt in enumerate(gts):
        hs = head_size(gt)
        gk = gt.keypoints
        vis = gk[:, 2] > 0
        if not vis.any():
            continue
        for j, pr in enumerate(preds):
            d = np.linalg.norm(pr.keypoints[:, :2] - gk[:, :2], axis=1)
            ok = (d <= PCKH_THRESH * hs) & vis
            cost[i, j] = 1.0 - ok.sum() / max(vis.sum(), 1)
    gated = np.where(cost < 1.0, cost, 1e6)
    return [(i, j) for i, j in solve_assignment(gated)]


class PosetrackEvaluator:
    """Accumulates frames; computes per-joint AP, mAP, MOTA, MOTP."""

    def __init__(self, num_joints: int = 15):
        self.k = num_joints
        # per-joint prediction records: (score, is_tp)
        self._records: List[List[Tuple[float, bool]]] = [
            [] for _ in range(num_joints)]
        self._n_gt = np.zeros(num_joints, np.int64)
        self._fn = np.zeros(num_joints, np.int64)
        self._fp = np.zeros(num_joints, np.int64)
        self._idsw = np.zeros(num_joints, np.int64)
        self._dist_sum = np.zeros(num_joints, np.float64)
        self._dist_cnt = np.zeros(num_joints, np.int64)
        # gt track id → last matched predicted track id (per video)
        self._last_match: Dict[int, int] = {}
        self.used_head_boxes = True

    def start_video(self):
        """Reset track-continuity state between videos."""
        self._last_match = {}

    def add_frame(self, gts: Sequence[PoseAnnotation],
                  preds: Sequence[PoseAnnotation]):
        pairs = _match_frame(gts, preds)
        matched_gt = {i for i, _ in pairs}
        matched_pred = {j for _, j in pairs}

        for i, gt in enumerate(gts):
            if gt.head_box is None:
                self.used_head_boxes = False
            vis = gt.keypoints[:, 2] > 0
            self._n_gt += vis.astype(np.int64)
            if i not in matched_gt:
                self._fn += vis.astype(np.int64)

        for j, pr in enumerate(preds):
            if j not in matched_pred:
                # Whole pose unmatched: every predicted joint is a FP.
                for jo in range(self.k):
                    self._records[jo].append((pr.score, False))
                self._fp += 1

        for i, j in pairs:
            gt, pr = gts[i], preds[j]
            hs = head_size(gt)
            d = np.linalg.norm(pr.keypoints[:, :2] - gt.keypoints[:, :2],
                               axis=1)
            vis = gt.keypoints[:, 2] > 0
            ok = (d <= PCKH_THRESH * hs) & vis
            for jo in range(self.k):
                self._records[jo].append((pr.score, bool(ok[jo])))
                if vis[jo]:
                    if ok[jo]:
                        self._dist_sum[jo] += d[jo] / max(hs, 1e-6)
                        self._dist_cnt[jo] += 1
                    else:
                        # poseval counts BOTH: the GT joint is missed (FN)
                        # and the predicted joint location is a FP.
                        self._fn[jo] += 1
                        self._fp[jo] += 1
                elif not vis[jo]:
                    # predicted joint against invisible GT joint: FP
                    self._fp[jo] += 1
            # ID switch bookkeeping on pose-level track ids.
            if gt.track_id >= 0 and pr.track_id >= 0:
                prev = self._last_match.get(gt.track_id)
                if prev is not None and prev != pr.track_id:
                    self._idsw += vis.astype(np.int64)
                self._last_match[gt.track_id] = pr.track_id

    # -- metrics ---------------------------------------------------------

    def _ap(self, joint: int) -> float:
        rec = sorted(self._records[joint], key=lambda r: -r[0])
        n_gt = self._n_gt[joint]
        if n_gt == 0:
            return float("nan")
        tp = np.cumsum([r[1] for r in rec]) if rec else np.zeros(0)
        fp = np.cumsum([not r[1] for r in rec]) if rec else np.zeros(0)
        if len(tp) == 0:
            return 0.0
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1)
        # standard VOC-style AP (all-point interpolation)
        mrec = np.concatenate([[0.0], recall, [recall[-1] if len(recall)
                                               else 0.0]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))

    def summarize(self) -> Dict[str, float]:
        aps = np.array([self._ap(j) for j in range(self.k)])
        # A joint with zero GT annotations is excluded (NaN + nanmean),
        # like AP — dividing its FP count by max(n_gt, 1)=1 produced an
        # unbounded negative MOTA term.
        mota_j = np.where(
            self._n_gt > 0,
            1.0 - (self._fn + self._fp + self._idsw)
            / np.maximum(self._n_gt, 1),
            np.nan)
        motp_j = np.where(self._dist_cnt > 0,
                          self._dist_sum / np.maximum(self._dist_cnt, 1),
                          np.nan)
        return {
            "mAP": float(np.nanmean(aps) * 100.0),
            "AP_per_joint": (aps * 100.0).tolist(),
            "MOTA": float(np.nanmean(mota_j) * 100.0),
            "MOTA_per_joint": (mota_j * 100.0).tolist(),
            "MOTP": (float(np.nanmean(motp_j))
                     if np.isfinite(motp_j).any() else float("nan")),
            "num_gt_joints": int(self._n_gt.sum()),
            "fn": int(self._fn.sum()),
            "fp": int(self._fp.sum()),
            "id_switches": int(self._idsw.sum()),
            "used_head_boxes": self.used_head_boxes,
        }


def _summarize_ap(all_scores: List[float], all_matches: List[np.ndarray],
                  n_gt: int, thresholds: np.ndarray) -> Dict[str, float]:
    """Score-ranked matches → COCO 101-point-interpolated AP/AP50/AP75.

    Shared by the box / OKS / mask evaluators (parity: pycocotools
    `COCOeval.accumulate` + `summarize`).
    """
    if n_gt == 0:
        return {"AP": float("nan"), "AP50": float("nan"),
                "AP75": float("nan")}
    order = np.argsort(-np.asarray(all_scores))
    m = (np.stack(all_matches)[order] if all_matches
         else np.zeros((0, len(thresholds))))
    aps = []
    for ti in range(len(thresholds)):
        tp = np.cumsum(m[:, ti])
        fp = np.cumsum(1 - m[:, ti])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1)
        mrec = np.concatenate([[0.0], recall])
        # Sentinel 0 so the backward max sets precision-at-recall-0 to the
        # best achieved precision (pycocotools semantics), not 1.0.
        mpre = np.concatenate([[0.0], precision])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        # Trailing 0 sentinel: recall thresholds above the max achieved
        # recall get precision 0 (pycocotools leaves those entries at 0),
        # not the last achieved precision.
        mpre = np.append(mpre, 0.0)
        # 101-point interpolation (COCO)
        q = np.linspace(0, 1, 101)
        idx = np.searchsorted(mrec, q, side="left")
        aps.append(np.mean(mpre[idx]))
    aps = np.asarray(aps)
    return {
        "AP": float(aps.mean() * 100.0),
        "AP50": float(aps[0] * 100.0),
        "AP75": float(aps[5] * 100.0),
    }


def eval_box_ap(
    preds_by_image: Dict[str, List[Tuple[np.ndarray, float]]],
    gts_by_image: Dict[str, List[np.ndarray]],
    thresholds: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """COCO-style box detection AP (greedy IoU matching).

    Parity: `json_dataset_evaluator.evaluate_boxes` / pycocotools bbox
    iouType: per image, score-ranked predictions greedily take the
    highest-IoU unmatched GT at each threshold; AP averaged over
    IoU .5:.05:.95 with 101-point interpolation.

    preds: {image: [(box(4,), score)]}; gts: {image: [box(4,)]}.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)

    def iou(a, b):
        iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1)
        ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
        inter = iw * ih
        ua = ((a[2] - a[0] + 1) * (a[3] - a[1] + 1)
              + (b[2] - b[0] + 1) * (b[3] - b[1] + 1) - inter)
        return inter / max(ua, 1e-9)

    all_scores: List[float] = []
    all_matches: List[np.ndarray] = []
    n_gt = 0
    images = set(gts_by_image) | set(preds_by_image)
    for img in images:
        gts = gts_by_image.get(img, [])
        preds = sorted(preds_by_image.get(img, []), key=lambda p: -p[1])
        n_gt += len(gts)
        taken = {ti: set() for ti in range(len(thresholds))}
        for box, score in preds:
            all_scores.append(score)
            row = np.zeros(len(thresholds))
            for ti, thr in enumerate(thresholds):
                best, best_g = thr, -1
                for gi, gt in enumerate(gts):
                    if gi in taken[ti]:
                        continue
                    ov = iou(box, gt)
                    if ov >= best:
                        best, best_g = ov, gi
                if best_g >= 0:
                    taken[ti].add(best_g)
                    row[ti] = 1.0
            all_matches.append(row)

    return _summarize_ap(all_scores, all_matches, n_gt, thresholds)


def eval_mask_ap(
    preds_by_image: Dict[str, List[Tuple[np.ndarray, float]]],
    gts_by_image: Dict[str, List[np.ndarray]],
    thresholds: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """COCO-style instance-segmentation AP over full-image boolean masks.

    Parity: `json_dataset_evaluator.evaluate_masks` / pycocotools segm
    iouType. preds: {image: [(mask(H, W) bool, score)]};
    gts: {image: [mask(H, W) bool]}. Paste detector outputs with
    `ops.masks.paste_mask` and rasterize GT polygons with
    `ops.masks.rasterize_polygons` before calling.
    """
    from ..ops.masks import mask_iou_matrix

    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)
    all_scores: List[float] = []
    all_matches: List[np.ndarray] = []
    n_gt = 0
    images = set(gts_by_image) | set(preds_by_image)
    for img in images:
        gts = gts_by_image.get(img, [])
        preds = sorted(preds_by_image.get(img, []), key=lambda p: -p[1])
        n_gt += len(gts)
        iou = (mask_iou_matrix([p[0] for p in preds], list(gts))
               if preds and gts else np.zeros((len(preds), len(gts))))
        taken = {ti: set() for ti in range(len(thresholds))}
        for pi, (_, score) in enumerate(preds):
            all_scores.append(score)
            row = np.zeros(len(thresholds))
            for ti, thr in enumerate(thresholds):
                best, best_g = thr, -1
                for gi in range(len(gts)):
                    if gi in taken[ti]:
                        continue
                    if iou[pi, gi] >= best:
                        best, best_g = iou[pi, gi], gi
                if best_g >= 0:
                    taken[ti].add(best_g)
                    row[ti] = 1.0
            all_matches.append(row)

    return _summarize_ap(all_scores, all_matches, n_gt, thresholds)


def eval_keypoint_ap_oks(
    preds_by_image: Dict[str, List[PoseAnnotation]],
    gts_by_image: Dict[str, List[PoseAnnotation]],
    sigmas: np.ndarray = POSETRACK_OKS_SIGMAS,
    thresholds: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """COCO-style keypoint AP via OKS greedy matching.

    Parity: pycocotools' `COCOeval(iouType="keypoints")` as used by
    `json_dataset_evaluator.evaluate_keypoints`: per image, score-ranked
    predictions greedily take the highest-OKS unmatched GT; AP averaged over
    OKS thresholds .5:.05:.95.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)

    all_scores: List[float] = []
    all_matches: List[np.ndarray] = []   # per prediction: OKS vs matched gt
    n_gt = 0
    # Union of keys: a prediction on an image absent from the GT dict is a
    # false positive, same as the box/mask evaluators.
    images = set(gts_by_image) | set(preds_by_image)
    for img in images:
        gts = gts_by_image.get(img, [])
        preds = sorted(preds_by_image.get(img, []), key=lambda p: -p.score)
        n_gt += len(gts)
        if not gts:
            for p in preds:
                all_scores.append(p.score)
                all_matches.append(np.zeros(len(thresholds)))
            continue
        gt_kps = np.stack([g.keypoints for g in gts])
        areas = np.array([
            (g.box[2] - g.box[0]) * (g.box[3] - g.box[1])
            if g.box is not None else
            max(np.ptp(g.keypoints[:, 0]) * np.ptp(g.keypoints[:, 1]), 1.0)
            for g in gts])
        if preds:
            pred_kps = np.stack([p.keypoints[:, :2] for p in preds])
            oks = compute_oks(pred_kps, gt_kps, areas, sigmas)   # (P, G)
        taken = {t: set() for t in range(len(thresholds))}
        for pi, p in enumerate(preds):
            all_scores.append(p.score)
            row = np.zeros(len(thresholds))
            for ti, thr in enumerate(thresholds):
                best, best_g = thr, -1
                for gi in range(len(gts)):
                    if gi in taken[ti]:
                        continue
                    if oks[pi, gi] >= best:
                        best, best_g = oks[pi, gi], gi
                if best_g >= 0:
                    taken[ti].add(best_g)
                    row[ti] = 1.0
            all_matches.append(row)

    return _summarize_ap(all_scores, all_matches, n_gt, thresholds)


def evaluate_detections(
    dets: Dict[str, List[Dict[str, np.ndarray]]],
    dataset,
    mask_on: bool = False,
) -> Dict[str, float]:
    """Dataset-level PER-FRAME detection metrics, pre-tracking.

    Parity: the reference's `test_engine` ends every `--mode test` run by
    evaluating the pickled detections against the dataset GT
    (`json_dataset_evaluator.evaluate_keypoints` / `evaluate_boxes`
    [/ `evaluate_masks` when MASK_ON], its "datasets eval" step).
    Tracking-protocol metrics can mask a detector regression (e.g. score
    calibration); this scores the detector alone.

    `dets`: {video_id: [frame_dict, ...]} exactly as `run_inference`
    returns (padded slots already filtered to `valid`; boxes in original
    image coordinates). Returns a flat {"box_AP", "box_AP50", "box_AP75",
    "keypoint_AP", ... [, "mask_AP", ...]} dict.
    """
    from ..ops.masks import paste_mask, rasterize_polygons

    box_preds: Dict[str, List[Tuple[np.ndarray, float]]] = {}
    box_gts: Dict[str, List[np.ndarray]] = {}
    kp_preds: Dict[str, List[PoseAnnotation]] = {}
    kp_gts: Dict[str, List[PoseAnnotation]] = {}
    mask_preds: Dict[str, List[Tuple[np.ndarray, float]]] = {}
    mask_gts: Dict[str, List[np.ndarray]] = {}

    for vid, frames in dets.items():
        records = dataset.video_frames(vid)
        for fi, fr in enumerate(frames):
            img = f"{vid}#{fi}"
            rec = records[fi] if fi < len(records) else None
            im_h = int(rec.height) if rec is not None and rec.height else 0
            im_w = int(rec.width) if rec is not None and rec.width else 0

            valid = np.asarray(fr["valid"], bool)
            boxes = np.asarray(fr["boxes"], np.float64)[valid]
            scores = np.asarray(fr["scores"], np.float64)[valid]
            box_preds[img] = [(boxes[d], float(scores[d]))
                              for d in range(len(boxes))]
            if "keypoints" in fr:
                kps = np.asarray(fr["keypoints"], np.float64)[valid]
                kp_preds[img] = [
                    PoseAnnotation(keypoints=kps[d], box=boxes[d],
                                   score=float(scores[d]))
                    for d in range(len(boxes))]
            if mask_on and "masks" in fr and im_h and im_w:
                probs = np.asarray(fr["masks"], np.float32)[valid]
                mask_preds[img] = [
                    (paste_mask(probs[d], boxes[d], im_h, im_w),
                     float(scores[d]))
                    for d in range(len(boxes))]

            gts = dataset.gt_poses(rec) if rec is not None else []
            box_gts[img] = [g["box"] for g in gts]
            kp_gts[img] = [
                PoseAnnotation(keypoints=g["keypoints"], box=g["box"],
                               head_box=g["head_box"])
                for g in gts
                if (g["keypoints"][:, 2] > 0).any()]
            if mask_on and im_h and im_w:
                mask_gts[img] = [
                    rasterize_polygons(g["segmentation"], im_h, im_w)
                    for g in gts if g.get("segmentation")]

    out: Dict[str, float] = {}
    for k, v in eval_box_ap(box_preds, box_gts).items():
        out[f"box_{k}"] = v
    if kp_preds:
        for k, v in eval_keypoint_ap_oks(kp_preds, kp_gts).items():
            out[f"keypoint_{k}"] = v
    if mask_on:
        for k, v in eval_mask_ap(mask_preds, mask_gts).items():
            out[f"mask_{k}"] = v
    return out
