"""Backward compatibility of configs (counterpart of ``proben_tpu/config/compat.py``,
after the reference ``detectron2/config/compat.py``).

Legacy yaml configs written against older key schemas (VERSION 1) load
through ``upgrade_config``/``downgrade_config``: ``merge_from_file``
downgrades the current defaults to the file's version, merges the (partial)
legacy config, then upgrades the result back to the latest schema — so old
keys land in their renamed locations.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from .config import CfgNode

__all__ = ["upgrade_config", "downgrade_config", "guess_version"]

logger = logging.getLogger(__name__)

LATEST_VERSION = 2


def upgrade_config(cfg: CfgNode, to_version: Optional[int] = None) -> CfgNode:
    """Upgrade a config from cfg.VERSION to ``to_version`` (default latest)."""
    cfg = cfg.clone()
    if to_version is None:
        to_version = LATEST_VERSION
    assert cfg.VERSION <= to_version, f"cannot upgrade v{cfg.VERSION} to v{to_version}"
    for k in range(cfg.VERSION, to_version):
        _CONVERTERS[k + 1].upgrade(cfg)
        cfg.VERSION = k + 1
    return cfg


def downgrade_config(cfg: CfgNode, to_version: int) -> CfgNode:
    """Downgrade to an older version (fills the old schema's key locations;
    reference compat.py:54 notes a general downgrade is only needed to host a
    merge of an old partial yaml)."""
    cfg = cfg.clone()
    assert cfg.VERSION >= to_version, f"cannot downgrade v{cfg.VERSION} to v{to_version}"
    for k in range(cfg.VERSION, to_version, -1):
        _CONVERTERS[k].downgrade(cfg)
        cfg.VERSION = k - 1
    return cfg


def guess_version(cfg: CfgNode, filename: str = "") -> int:
    """Version of a partial config lacking VERSION (reference compat.py:82):
    v1 marker keys are MODEL.WEIGHT / TEST.AUG_ON."""

    def _has(name: str) -> bool:
        cur = cfg
        for n in name.split("."):
            if not isinstance(cur, dict) or n not in cur:
                return False
            cur = cur[n]
        return True

    if _has("MODEL.WEIGHT") or _has("TEST.AUG_ON"):
        logger.warning("config %s has no VERSION; assuming v1", filename)
        return 1
    logger.debug(
        "config %s has no VERSION; assuming latest v%d", filename, LATEST_VERSION
    )
    return LATEST_VERSION


def _rename(cfg: CfgNode, old: str, new: str) -> None:
    """Move ``old`` dotted key to ``new``; missing old keys are skipped
    (legacy configs are partial)."""
    old_keys = old.split(".")
    cur = cfg
    for k in old_keys[:-1]:
        if not isinstance(cur, dict) or k not in cur:
            return
        cur = cur[k]
    if old_keys[-1] not in cur:
        return
    val = cur.pop(old_keys[-1])

    dst = cfg
    for k in new.split(".")[:-1]:
        if k not in dst:
            dst[k] = CfgNode()
        dst = dst[k]
    dst[new.split(".")[-1]] = val


class _RenameConverter:
    RENAME: List[Tuple[str, str]] = []

    @classmethod
    def upgrade(cls, cfg: CfgNode) -> None:
        for old, new in cls.RENAME:
            _rename(cfg, old, new)

    @classmethod
    def downgrade(cls, cfg: CfgNode) -> None:
        for old, new in cls.RENAME[::-1]:
            _rename(cfg, new, old)


class ConverterV1(_RenameConverter):
    """reference compat.py:165."""

    RENAME = [("MODEL.RPN_HEAD.NAME", "MODEL.RPN.HEAD_NAME")]


class ConverterV2(_RenameConverter):
    """The pre-release bulk rename (reference compat.py:169-196), restricted
    to keys in this schema (no PANOPTIC_FPN / legacy RETINANET subtree)."""

    RENAME = [
        ("MODEL.WEIGHT", "MODEL.WEIGHTS"),
        ("MODEL.ROI_HEADS.SCORE_THRESH", "MODEL.ROI_HEADS.SCORE_THRESH_TEST"),
        ("MODEL.ROI_HEADS.NMS", "MODEL.ROI_HEADS.NMS_THRESH_TEST"),
        ("TEST.DETECTIONS_PER_IMG", "TEST.DETECTIONS_PER_IMAGE"),
        ("TEST.AUG_ON", "TEST.AUG.ENABLED"),
        ("TEST.AUG_MIN_SIZES", "TEST.AUG.MIN_SIZES"),
        ("TEST.AUG_MAX_SIZE", "TEST.AUG.MAX_SIZE"),
        ("TEST.AUG_FLIP", "TEST.AUG.FLIP"),
        ("MODEL.RPN.ANCHOR_ASPECT_RATIOS", "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"),
        ("MODEL.RPN.ANCHOR_SIZES", "MODEL.ANCHOR_GENERATOR.SIZES"),
    ]


_CONVERTERS = {1: ConverterV1, 2: ConverterV2}
