"""Host-side detection visualization (counterpart of
``proben_tpu/utils/visualizer.py``; reference ``detectron2/utils/visualizer.py``,
drawn with cv2 instead of matplotlib): boxes/labels/masks on the ProbEn path
(``apps/flir.py draw``, the counterpart of ``demo_draw_FLIR.py``), keypoint
skeletons (:693), rotated boxes (:836), dataset-dict GT drawing (:468), and
the text/line/circle/polygon primitives (:755-1030). cv2 is imported in
``Visualizer.__init__``, never when the module is imported. Detection
records may hold tensors on the card: ``draw_instance_predictions`` moves
them to the host once, before it draws."""

from __future__ import annotations

import colorsys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def to_host(record: Dict) -> Dict:
    """A detection record with every tensor value as a numpy array (one copy
    to the host per field, all before any drawing)."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in record.items()}


def _color_for(idx: int) -> tuple:
    """Deterministic distinct colors (reference colormap.py spirit)."""
    hue = (idx * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(hue, 0.9, 1.0)
    return (int(b * 255), int(g * 255), int(r * 255))  # BGR for cv2


class Visualizer:
    """Draw instance predictions on an image.

    image: HWC uint8 BGR (cv2 convention); boxes XYXY in image frame.
    """

    def __init__(self, image: np.ndarray, metadata=None, scale: float = 1.0):
        import cv2

        self._cv2 = cv2
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        if img.ndim == 2 or img.shape[2] == 1:
            img = cv2.cvtColor(img.reshape(img.shape[0], img.shape[1]), cv2.COLOR_GRAY2BGR)
        if scale != 1.0:
            img = cv2.resize(img, None, fx=scale, fy=scale)
        self.img = img.copy()
        self.scale = scale
        self.metadata = metadata

    def _class_name(self, cls: int) -> str:
        names = getattr(self.metadata, "thing_classes", None) if self.metadata else None
        if names and 0 <= cls < len(names):
            return names[cls]
        return str(cls)

    def overlay_instances(
        self,
        boxes: Optional[np.ndarray] = None,
        labels: Optional[Sequence[str]] = None,
        classes: Optional[np.ndarray] = None,
        scores: Optional[np.ndarray] = None,
        thickness: int = 1,
        assigned_colors: Optional[Sequence] = None,
    ) -> "Visualizer":
        cv2 = self._cv2
        if boxes is None or len(boxes) == 0:
            return self
        boxes = np.asarray(boxes, float) * self.scale
        n = len(boxes)
        if labels is None:
            labels = []
            for i in range(n):
                text = self._class_name(int(classes[i])) if classes is not None else ""
                if scores is not None:
                    text = f"{text} {scores[i] * 100:.0f}%".strip()
                labels.append(text)
        for i, box in enumerate(boxes):
            if assigned_colors is not None:
                color = tuple(int(v) for v in assigned_colors[i])
            else:
                color = _color_for(int(classes[i]) if classes is not None else i)
            x1, y1, x2, y2 = [int(round(v)) for v in box]
            cv2.rectangle(self.img, (x1, y1), (x2, y2), color, thickness)
            if labels[i]:
                (tw, th), _ = cv2.getTextSize(labels[i], cv2.FONT_HERSHEY_SIMPLEX, 0.4, 1)
                ty = y1 - 3 if y1 - th - 4 >= 0 else y2 + th + 3
                cv2.rectangle(self.img, (x1, ty - th - 2), (x1 + tw, ty + 2), color, -1)
                cv2.putText(self.img, labels[i], (x1, ty), cv2.FONT_HERSHEY_SIMPLEX,
                            0.4, (0, 0, 0), 1, cv2.LINE_AA)
        return self

    def draw_masks(self, masks: np.ndarray, classes: Optional[np.ndarray] = None,
                   alpha: float = 0.45,
                   assigned_colors: Optional[Sequence] = None) -> "Visualizer":
        """Overlay (N, H, W) boolean masks with per-class colors."""
        for i, m in enumerate(np.asarray(masks)):
            if assigned_colors is not None:
                color = np.asarray(assigned_colors[i], float)
            else:
                color = np.array(_color_for(int(classes[i]) if classes is not None else i))
            region = m.astype(bool)
            self.img[region] = (
                (1 - alpha) * self.img[region] + alpha * color
            ).astype(np.uint8)
        return self

    def draw_keypoints(self, keypoints: np.ndarray, radius: int = 3) -> "Visualizer":
        """Draw (N, K, 3) keypoints (x, y, score/visibility > 0); with
        keypoint metadata each instance is also skeleton-connected."""
        cv2 = self._cv2
        names = getattr(self.metadata, "keypoint_names", None) if self.metadata else None
        rules = (getattr(self.metadata, "keypoint_connection_rules", None)
                 if self.metadata else None)
        for inst in np.asarray(keypoints):
            if names or rules:
                self.draw_and_connect_keypoints(inst)
                continue
            for x, y, v in inst:
                if v > 0:
                    self.draw_circle((x, y), (0, 255, 0), radius)
        return self

    def draw_and_connect_keypoints(self, keypoints: np.ndarray,
                                   threshold: float = 0.05) -> "Visualizer":
        """One instance's (K, 3) keypoints + metadata-driven skeleton lines
        (reference ``visualizer.py:693-749``: circles at visible points,
        ``keypoint_connection_rules`` edges, and the person-specific
        nose->mid-shoulder->mid-hip heuristic)."""
        red = (0, 0, 255)
        names = getattr(self.metadata, "keypoint_names", None) if self.metadata else None
        visible = {}
        for idx, (x, y, prob) in enumerate(np.asarray(keypoints, float)):
            if prob > threshold:
                self.draw_circle((x, y), red)
                if names:
                    visible[names[idx]] = (x, y)
        rules = (getattr(self.metadata, "keypoint_connection_rules", None)
                 if self.metadata else None)
        for kp0, kp1, color in rules or ():
            if kp0 in visible and kp1 in visible:
                # reference colors are RGB; cv2 wants BGR
                self.draw_line(visible[kp0], visible[kp1], tuple(color[::-1]))
        if "left_shoulder" in visible and "right_shoulder" in visible:
            (lsx, lsy), (rsx, rsy) = visible["left_shoulder"], visible["right_shoulder"]
            mid_sh = ((lsx + rsx) / 2, (lsy + rsy) / 2)
            if "nose" in visible:
                self.draw_line(visible["nose"], mid_sh, red)
            if "left_hip" in visible and "right_hip" in visible:
                (lhx, lhy), (rhx, rhy) = visible["left_hip"], visible["right_hip"]
                self.draw_line(((lhx + rhx) / 2, (lhy + rhy) / 2), mid_sh, red)
        return self

    # -- primitives (reference visualizer.py:755-1030, cv2 instead of mpl) --

    def draw_text(self, text: str, position, color=(255, 255, 255),
                  font_scale: float = 0.4) -> "Visualizer":
        x, y = (int(round(v * self.scale)) for v in position)
        self._cv2.putText(self.img, text, (x, y), self._cv2.FONT_HERSHEY_SIMPLEX,
                          font_scale, color, 1, self._cv2.LINE_AA)
        return self

    def draw_line(self, p0, p1, color, thickness: int = 1) -> "Visualizer":
        s = self.scale
        self._cv2.line(
            self.img,
            (int(round(p0[0] * s)), int(round(p0[1] * s))),
            (int(round(p1[0] * s)), int(round(p1[1] * s))),
            tuple(int(v) for v in color), thickness, self._cv2.LINE_AA,
        )
        return self

    def draw_circle(self, center, color, radius: int = 3) -> "Visualizer":
        self._cv2.circle(
            self.img,
            (int(round(center[0] * self.scale)), int(round(center[1] * self.scale))),
            radius, tuple(int(v) for v in color), -1,
        )
        return self

    def draw_polygon(self, segment: np.ndarray, color, alpha: float = 0.5) -> "Visualizer":
        """Filled polygon blend + outline; ``segment`` is (P, 2) xy."""
        cv2 = self._cv2
        pts = (np.asarray(segment, float) * self.scale).round().astype(np.int32)
        overlay = self.img.copy()
        cv2.fillPoly(overlay, [pts], tuple(int(v) for v in color))
        self.img = cv2.addWeighted(overlay, alpha, self.img, 1 - alpha, 0)
        cv2.polylines(self.img, [pts], True, tuple(int(v) for v in color), 1, cv2.LINE_AA)
        return self

    def draw_rotated_box_with_label(self, rotated_box, color=(0, 255, 0),
                                    label: Optional[str] = None,
                                    thickness: int = 1) -> "Visualizer":
        """(cx, cy, w, h, angle-degrees-CCW) box as its 4 rotated edges
        (reference ``visualizer.py:836-888``; same corner math, y-down)."""
        import math

        cx, cy, w, h, angle = (float(v) for v in rotated_box)
        theta = angle * math.pi / 180.0
        c, s = math.cos(theta), math.sin(theta)
        rect = [(-w / 2, h / 2), (-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2)]
        corners = [(s * yy + c * xx + cx, c * yy - s * xx + cy) for (xx, yy) in rect]
        for k in range(4):
            self.draw_line(corners[k], corners[(k + 1) % 4], color, thickness)
        if label:
            self.draw_text(label, corners[1], color)
        return self

    def overlay_rotated_instances(self, boxes: np.ndarray,
                                  labels: Optional[Sequence[str]] = None,
                                  classes: Optional[np.ndarray] = None) -> "Visualizer":
        """(N, 5) rotated boxes, drawn sorted by area like the reference."""
        boxes = np.asarray(boxes, float)
        if len(boxes) == 0:
            return self
        order = np.argsort(-(boxes[:, 2] * boxes[:, 3]))
        for i in order:
            color = _color_for(int(classes[i]) if classes is not None else int(i))
            self.draw_rotated_box_with_label(
                boxes[i], color, labels[i] if labels is not None else None
            )
        return self

    def draw_dataset_dict(self, dic: Dict) -> "Visualizer":
        """Draw one dataset-format dict's annotations (reference
        ``visualizer.py:468-509``): XYWH/XYXY gt boxes, labels with |crowd
        suffix, keypoints when present."""
        annos = dic.get("annotations") or []
        if not annos:
            return self
        boxes = []
        for a in annos:
            b = list(map(float, a["bbox"]))
            # bbox_mode 1 = XYWH_ABS (the COCO loader default), 0 = XYXY_ABS
            if a.get("bbox_mode", 1) == 1:
                b = [b[0], b[1], b[0] + b[2], b[1] + b[3]]
            boxes.append(b)
        classes = np.array([a["category_id"] for a in annos], int)
        labels = [
            f"{self._class_name(int(c))}" + ("|crowd" if a.get("iscrowd", 0) else "")
            for c, a in zip(classes, annos)
        ]
        self.overlay_instances(boxes=np.array(boxes), labels=labels, classes=classes)
        if "keypoints" in annos[0]:
            kp = np.array([a["keypoints"] for a in annos], float).reshape(len(annos), -1, 3)
            self.draw_keypoints(kp)
        return self

    def draw_instance_predictions(self, predictions: Dict) -> "Visualizer":
        """predictions: dict with boxes/scores/classes (+ optional masks (N,H,W),
        keypoints (N,K,3)), numpy arrays (``Predictor.predict_batch``'s
        records) or tensors on any device (moved to the host first)."""
        predictions = to_host(predictions)
        if predictions.get("masks") is not None:
            self.draw_masks(predictions["masks"], predictions.get("classes"))
        out = self.overlay_instances(
            boxes=predictions.get("boxes"),
            classes=predictions.get("classes"),
            scores=predictions.get("scores"),
        )
        if predictions.get("keypoints") is not None:
            self.draw_keypoints(predictions["keypoints"])
        return out

    def get_image(self) -> np.ndarray:
        return self.img

    def save(self, path: str):
        self._cv2.imwrite(path, self.img)


class PaperVisualizer(Visualizer):
    """The reference's ``visualizer_paper.py`` fork: identical drawing with
    FIXED per-class colors for the ProbEn paper figures (its only substantive
    diff vs ``visualizer.py`` is the hardcoded class->color map and label
    suppression)."""

    # reference visualizer_paper.py:341-346 ({0,1,2} -> green/yellow/blue),
    # expressed in this module's BGR convention
    PAPER_COLORS = {0: (0, 255, 0), 1: (0, 255, 255), 2: (255, 0, 0)}

    def overlay_instances(self, boxes=None, labels=None, classes=None,
                          scores=None, thickness: int = 2,
                          assigned_colors=None):
        if assigned_colors is None and classes is not None:
            assigned_colors = [
                self.PAPER_COLORS.get(int(c), _color_for(int(c))) for c in classes
            ]
        if labels is None:
            labels = [""] * (len(boxes) if boxes is not None else 0)
        return super().overlay_instances(
            boxes, labels, classes, scores, thickness, assigned_colors
        )
