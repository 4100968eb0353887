"""Evaluator dispatch by dataset metadata (counterpart of
``proben_tpu/evaluation/build.py``; the reference's per-project
``build_evaluator`` pattern, e.g. `tools/train_net.py:62-95`): pick the
dataset's evaluator from ``MetadataCatalog.get(name).evaluator_type``.

The FLIR and COCO evaluators speak the ``reset/process(image_id,
boxes_xyxy, scores, classes)/evaluate`` protocol of
``inference_on_dataset``; the KAIST evaluator takes the whole split's
detections (``KAISTEvaluator.evaluate_all_conditions``).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["build_evaluator"]

# evaluator types of the JAX package that the port does not have yet
NOT_PORTED = ("lvis", "pascal_voc", "cityscapes_instance")


def build_evaluator(dataset_name: str, output_dir: Optional[str] = None):
    from ..data import MetadataCatalog

    meta = MetadataCatalog.get(dataset_name)
    etype = meta.get("evaluator_type", "flir")
    if etype == "flir":
        from .flir import FLIREvaluator

        return FLIREvaluator(meta.json_file, output_dir=output_dir)
    if etype == "coco":
        from .coco_io import COCODataset
        from .flir import FLIREvaluator

        # generic COCO bbox evaluation: the FLIR evaluator core without the
        # FLIR class filter/remap (valid_classes are CONTIGUOUS model class
        # indices; process() unmaps them to dataset ids afterwards)
        coco = COCODataset(meta.json_file)
        return FLIREvaluator(
            coco,
            output_dir=output_dir,
            valid_classes=range(len(coco.cats)),
            class_remap={},
        )
    if etype == "kaist":
        from .kaist import KAISTEvaluator

        return KAISTEvaluator(meta.json_file)
    if etype in NOT_PORTED:
        raise NotImplementedError(
            f"evaluator_type={etype!r} (dataset {dataset_name!r}) is not ported yet "
            "(ROADMAP 13: the LVIS, Pascal VOC and Cityscapes evaluators)")
    raise ValueError(
        f"no evaluator registered for evaluator_type={etype!r} "
        f"(dataset {dataset_name!r}); pass one explicitly"
    )
