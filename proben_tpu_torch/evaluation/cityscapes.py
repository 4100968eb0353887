"""Cityscapes instance-segmentation evaluation (a copy of
``proben_tpu/evaluation/cityscapes.py``; reference
`detectron2/evaluation/cityscapes_evaluation.py`, which writes the official
prediction format and shells out to
``cityscapesscripts.evaluation.evalInstanceLevelSemanticLabeling``).

Two halves, both native:

  * the OFFICIAL prediction format writer (``{stem}_pred.txt`` +
    per-instance mask PNGs) — byte-compatible with what the reference
    produces, so the official script can still be run on the output;
  * a scorer: delegates to ``cityscapesscripts`` when importable, else
    computes mask AP / AP50 natively on the COCOeval machinery with
    mask-RLE IoU (COCO-style matching over IoU 0.5:0.05:0.95 — the same
    metric family; the official script additionally drops sub-minRegionSize
    gt, which the native path exposes via ``min_region_size``).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .cocoeval import COCOEvaluator, EvalParams
from .rle import area as rle_area
from .rle import encode as rle_encode

logger = logging.getLogger(__name__)

# cityscapesscripts.helpers.labels: instance-eval ("hasInstances") classes
# name -> labelId, trainId order kept for thing_classes indexing
CITYSCAPES_THING_CLASSES = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)
CITYSCAPES_NAME2LABELID = {
    "person": 24, "rider": 25, "car": 26, "truck": 27, "bus": 28,
    "train": 31, "motorcycle": 32, "bicycle": 33,
}


class CityscapesInstanceEvaluator:
    """reset/process/evaluate lifecycle (reference
    ``cityscapes_evaluation.py:16``), array-native inputs.

    output_dir: where ``{stem}_pred.txt`` + mask PNGs are written (the
    official format). gt is registered per image via ``add_ground_truth``
    (instance masks + class indices) for the native scorer; when scoring via
    the official script, set ``gt_dir`` to the cityscapes gtFine root
    instead.
    """

    def __init__(
        self,
        output_dir: str,
        thing_classes: Sequence[str] = CITYSCAPES_THING_CLASSES,
        gt_dir: Optional[str] = None,
        min_region_size: int = 100,
    ):
        self._output_dir = output_dir
        self._thing_classes = list(thing_classes)
        self._gt_dir = gt_dir
        self._min_region_size = min_region_size
        self.reset()

    def reset(self):
        os.makedirs(self._output_dir, exist_ok=True)
        self._gts: List[dict] = []
        self._dts: List[dict] = []
        self._image_ids: List[str] = []

    # -- gt registration (native scorer) ------------------------------------

    def add_ground_truth(self, image_stem: str, masks, classes):
        """masks: (N, H, W) binary; classes: indices into thing_classes."""
        if image_stem not in self._image_ids:
            self._image_ids.append(image_stem)
        for m, c in zip(np.asarray(masks), np.asarray(classes)):
            rle = rle_encode(m.astype(np.uint8))
            a = rle_area(rle)
            self._gts.append(
                {
                    "image_id": image_stem,
                    "category_id": int(c),
                    "segmentation": rle,
                    "area": float(a),
                    # official protocol: gt regions below minRegionSizes are
                    # ignored (evalInstanceLevelSemanticLabeling defaults 100)
                    "ignore": int(a < self._min_region_size),
                    "bbox": [0.0, 0.0, 0.0, 0.0],
                }
            )

    # -- predictions ---------------------------------------------------------

    def process(self, image_stem: str, masks, scores, classes):
        """Writes the official files AND records RLEs for native scoring.

        masks: (N, H, W) binary; classes: indices into thing_classes.
        """
        from PIL import Image

        if image_stem not in self._image_ids:
            self._image_ids.append(image_stem)
        masks = np.asarray(masks)
        # the files are named by the stem's base name, as the reference's
        # writer names them: the loader's stems keep the city folder
        # ("frankfurt/frankfurt_000000_000294"), and the official script
        # reads each PNG beside its txt (the JAX copy writes into a city
        # folder it never creates; ROADMAP, section C)
        base = os.path.basename(image_stem)
        pred_txt = os.path.join(self._output_dir, base + "_pred.txt")
        with open(pred_txt, "w") as fout:
            for i, (m, s, c) in enumerate(zip(masks, np.asarray(scores), np.asarray(classes))):
                name = self._thing_classes[int(c)]
                label_id = CITYSCAPES_NAME2LABELID.get(name, int(c))
                png_name = f"{base}_{i}_{name}.png"
                Image.fromarray(m.astype(np.uint8) * 255).save(
                    os.path.join(self._output_dir, png_name)
                )
                fout.write(f"{png_name} {label_id} {float(s)}\n")
                self._dts.append(
                    {
                        "image_id": image_stem,
                        "category_id": int(c),
                        "segmentation": rle_encode(m.astype(np.uint8)),
                        "score": float(s),
                        "bbox": [0.0, 0.0, 0.0, 0.0],
                    }
                )

    # -- scoring --------------------------------------------------------------

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        try:
            import cityscapesscripts.evaluation.evalInstanceLevelSemanticLabeling  # noqa: F401

            if self._gt_dir:
                return self._evaluate_official()
            logger.info("cityscapesscripts present but no gt_dir; native scorer")
        except ImportError:
            pass
        return self._evaluate_native()

    def _evaluate_native(self) -> Dict[str, Dict[str, float]]:
        ev = COCOEvaluator(
            self._gts,
            self._image_ids,
            list(range(len(self._thing_classes))),
            params=EvalParams(max_dets=(1, 10, 100)),
            iou_type="segm",
        )
        summary = ev.evaluate(self._dts)
        res = {"AP": summary["AP"] * 100, "AP50": summary["AP50"] * 100}
        logger.info("cityscapes segm (native): %s", res)
        return {"segm": res}

    def _evaluate_official(self) -> Dict[str, Dict[str, float]]:
        """reference ``cityscapes_evaluation.py:73-114`` (requires the
        cityscapesscripts package + gtFine tree)."""
        os.environ["CITYSCAPES_DATASET"] = os.path.abspath(
            os.path.join(self._gt_dir, "..", "..")
        )
        import cityscapesscripts.evaluation.evalInstanceLevelSemanticLabeling as ce

        ce.args.predictionPath = os.path.abspath(self._output_dir)
        ce.args.predictionWalk = None
        ce.args.JSONOutput = False
        ce.args.colorized = False
        ce.args.gtInstancesFile = os.path.join(self._output_dir, "gtInstances.json")
        gt_list = glob.glob(ce.args.groundTruthSearch)
        if not gt_list:
            raise FileNotFoundError(ce.args.groundTruthSearch)
        pred_list = [ce.getPrediction(gt, ce.args) for gt in gt_list]
        results = ce.evaluateImgLists(pred_list, gt_list, ce.args)["averages"]
        return {
            "segm": {
                "AP": results["allAp"] * 100,
                "AP50": results["allAp50%"] * 100,
            }
        }
