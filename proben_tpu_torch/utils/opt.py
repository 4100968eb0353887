"""ProbEn demo CLI parser (counterpart of ``proben_tpu/utils/opt.py``, after
the reference ``detectron2/utils/opt.py:3``), on argparse; ``--config``
files are handled via fromfile syntax (``@args.txt``)."""

from __future__ import annotations

import argparse


def config_parser(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(fromfile_prefix_chars="@")
    parser.add_argument("--dataset_path", type=str, default="", help="root of the dataset (contains thermal_8_bit/, RGB/, annotation json)")
    parser.add_argument("--prediction_path", type=str, default="out/", help="folder with saved per-model prediction JSONs")
    parser.add_argument(
        "--fusion_method",
        type=str,
        default="thermal_only",
        choices=["rgb_only", "thermal_only", "early_fusion", "middle_fusion"],
    )
    parser.add_argument("--model_path", type=str, default="", help="checkpoint to load (empty: random weights from seed 0)")
    parser.add_argument("--score_fusion", type=str, default="probEn", choices=["avg", "max", "probEn"])
    parser.add_argument(
        "--box_fusion", type=str, default="v-avg", choices=["avg", "s-avg", "v-avg", "argmax"]
    )
    parser.add_argument("--outfolder", type=str, default="out/")
    parser.add_argument("--dataset_name", type=str, default="FLIR_val")
    return parser.parse_args(argv)
