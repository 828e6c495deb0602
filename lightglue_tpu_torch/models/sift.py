"""SIFT on the host (counterpart of lightglue_tpu/models/sift.py; reference
lightglue/sift.py:17-216).

``backend="opencv"``: OpenCV's SIFT per image, as the reference runs it,
with its duplicate filter (``filter_dog_point``) and RootSIFT, padded to a
static keypoint count for the matcher. ``backend="pycolmap*"`` needs the
optional pycolmap and raises ``ImportError`` without it. The DoG scale
space on the device is ``models.sift_device`` (``backend="device"``).
Every backend emits ``scales`` and ``oris`` for the matcher's
scale/orientation-aware positional encoding (reference lightglue.py:
495-501). cv2 and scipy are imported where they are used.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..configs import SIFTConfig
from ..utils import diagnostics


def filter_dog_point(
    points: np.ndarray,
    scales: np.ndarray,
    angles: np.ndarray,
    image_shape,
    nms_radius: int,
    scores: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Drop DoG detections that land on the same pixel as a stronger one,
    then apply radius NMS; returns the kept indices, ascending.

    The reference's rule (sift.py:17-50) on the detections themselves
    instead of image-sized buffers: detections are grouped by their integer
    pixel, each group keeps the rows tied for (largest score, then smallest
    |angle|), and NMS drops a survivor iff a strictly stronger survivor
    lies within Chebyshev distance ``nms_radius``."""
    n = len(points)
    if n == 0:
        return np.zeros((0,), np.int64)
    h, w = image_shape
    cols, rows = np.round(points - 0.5).astype(np.int64).T
    pid = rows * w + cols  # the pixel: the group key
    s = (scales if scores is None else scores).astype(np.float64)
    o_abs = np.abs(angles).astype(np.float64)

    # each group's winner is first under (pid, -score, |angle|); rows tied
    # with it all survive, as the reference's two equality passes keep them
    order = np.lexsort((o_abs, -s, pid))
    pid_o, s_o, a_o = pid[order], s[order], o_abs[order]
    starts = np.ones(n, bool)
    starts[1:] = pid_o[1:] != pid_o[:-1]
    group = np.cumsum(starts) - 1
    win_s = s_o[starts][group]
    win_a = a_o[starts][group]
    keep = np.sort(order[(s_o == win_s) & (a_o == win_a)])

    if nms_radius > 0 and len(keep) > 1:
        from scipy.spatial import cKDTree

        rc = np.stack([rows[keep], cols[keep]], axis=1).astype(np.float64)
        sk = s[keep]
        pairs = cKDTree(rc).query_pairs(r=nms_radius, p=np.inf,
                                        output_type="ndarray")
        dead = np.zeros(len(keep), bool)
        if len(pairs):
            i, j = pairs.T
            np.logical_or.at(dead, i, sk[j] > sk[i])
            np.logical_or.at(dead, j, sk[i] > sk[j])
        keep = keep[~dead]
    return keep


def sift_to_rootsift(x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """L1-normalize, square root, L2-normalize (reference sift.py:53-56)."""
    x = x / np.maximum(np.linalg.norm(x, ord=1, axis=-1, keepdims=True), eps)
    x = np.sqrt(np.clip(x, eps, None))
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)


def run_opencv_sift(features, image: np.ndarray):
    """Detect and describe with a cv2 Feature2D (reference sift.py:59-76):
    (points (x, y), responses, sizes, angles in radians, descriptors)."""
    detections, descriptors = features.detectAndCompute(image, None)
    table = np.array(
        [(k.pt[0], k.pt[1], k.response, k.size, k.angle) for k in detections],
        dtype=np.float32,
    ).reshape(-1, 5)
    return (table[:, 0:2], table[:, 2], table[:, 3], np.radians(table[:, 4]),
            descriptors)


def extract_single_image_pycolmap(
    image: np.ndarray, conf: SIFTConfig
) -> Dict[str, np.ndarray]:
    """One image through pycolmap (reference sift.py:96-126, 140-155);
    ``backend`` picks its device: "pycolmap" (auto), "pycolmap_cpu",
    "pycolmap_cuda". pycolmap is optional; without it this raises the
    reference's ImportError."""
    try:
        import pycolmap
    except ImportError as e:
        raise ImportError(
            "SIFT backend '%s' requires the pycolmap package: install it "
            "with pip or use backend='opencv'/'device'." % conf.backend
        ) from e
    from packaging import version

    if version.parse(pycolmap.__version__) < version.parse("0.5.0"):
        # old pycolmap normalizes L1_ROOT descriptors wrongly (reference
        # sift.py:117-123 warns the same way)
        diagnostics.warn_once(
            "pycolmap-version",
            f"pycolmap {pycolmap.__version__} < 0.5.0 has broken descriptor "
            "normalization; results may differ. Consider upgrading or using "
            "backend='opencv'/'device'.")
    options = {
        "peak_threshold": conf.detection_threshold,
        "edge_threshold": conf.edge_threshold,
        "first_octave": conf.first_octave,
        "num_octaves": conf.num_octaves,
        # pycolmap's L1_ROOT is wrong (reference sift.py:111): L2 here,
        # RootSIFT applied afterwards
        "normalization": pycolmap.Normalization.L2,
        "max_num_features": conf.max_num_keypoints,
    }
    device = "auto" if conf.backend == "pycolmap" else conf.backend[len("pycolmap_"):]
    sift = pycolmap.Sift(options=options, device=device)
    out = sift.extract(image.astype(np.float32))
    if len(out) == 3:  # pycolmap < 0.5 also returned scores
        detections, scores, descriptors = out
        scores = np.abs(scores) * detections[:, 2]
    else:
        detections, descriptors = out
        scores = None
    pred = {
        "keypoints": detections[:, :2].astype(np.float32),
        "scales": detections[:, 2].astype(np.float32),
        "oris": detections[:, 3].astype(np.float32),
        "descriptors": descriptors.astype(np.float32),
    }
    if scores is not None:
        pred["keypoint_scores"] = scores.astype(np.float32)
    # pycolmap may return points outside the image (reference sift.py:170-175)
    h, w = image.shape
    inside = ((pred["keypoints"] + 0.5) < np.array([[w, h]], np.float32)).all(-1)
    pred = {k: v[inside] for k, v in pred.items()}
    if "keypoint_scores" not in pred:
        pred["keypoint_scores"] = pred["scales"].copy()
    return pred


def extract_single_image_opencv(
    image: np.ndarray, conf: SIFTConfig
) -> Dict[str, np.ndarray]:
    """One image through OpenCV's SIFT (reference sift.py:140-196).
    ``image``: (H, W) float in [0, 1]. Returns ragged arrays: keypoints,
    scales, oris, descriptors, keypoint_scores."""
    import cv2

    sift = cv2.SIFT_create(
        contrastThreshold=conf.detection_threshold,
        nfeatures=conf.max_num_keypoints,
        edgeThreshold=conf.edge_threshold,
        nOctaveLayers=conf.num_octaves,
    )
    keypoints, scores, scales, angles, descriptors = run_opencv_sift(
        sift, (image * 255.0).astype(np.uint8))
    if len(keypoints) == 0:
        return {
            "keypoints": np.zeros((0, 2), np.float32),
            "scales": np.zeros((0,), np.float32),
            "oris": np.zeros((0,), np.float32),
            "descriptors": np.zeros((0, 128), np.float32),
            "keypoint_scores": np.zeros((0,), np.float32),
        }
    pred = {
        "keypoints": keypoints,
        "scales": scales,
        "oris": angles,
        "descriptors": descriptors,
        "keypoint_scores": scores,
    }
    if conf.nms_radius is not None:
        keep = filter_dog_point(
            pred["keypoints"], pred["scales"], pred["oris"], image.shape,
            conf.nms_radius, scores=pred["keypoint_scores"])
        pred = {k: v[keep] for k, v in pred.items()}
    k = conf.max_num_keypoints
    if k is not None and len(pred["keypoints"]) > k:
        indices = np.argsort(-pred["keypoint_scores"])[:k]
        pred = {k_: v[indices] for k_, v in pred.items()}
    return pred


def pad_features(pred: Dict[str, np.ndarray], k: int) -> Dict[str, np.ndarray]:
    """One image's ragged prediction padded to k slots, with ``valid``
    (padded scales 1, everything else 0)."""
    n = len(pred["keypoints"])
    out = {}
    valid = np.zeros((k,), bool)
    valid[: min(n, k)] = True
    for key, v in pred.items():
        v = v[:k]
        widths = [(0, k - len(v))] + [(0, 0)] * (v.ndim - 1)
        out[key] = np.pad(v, widths,
                          constant_values=0.0 if key != "scales" else 1.0)
    out["valid"] = valid
    return out
