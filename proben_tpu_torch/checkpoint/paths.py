"""Checkpoint URL-scheme resolution with a local cache (counterpart of
``proben_tpu/checkpoint/paths.py``, after the reference's fvcore
PathHandlers, `detectron2/checkpoint/catalog.py:92-130`). Supports:

  * ``detectron2://<name>``  -> https://dl.fbaipublicfiles.com/detectron2/<name>
  * ``catalog://<name>``     -> legacy Caffe2 Detectron catalog entries
    (`catalog.py:6-90` ModelCatalog: ImageNetPretrained + COCO baselines)
  * ``http(s)://...``        -> downloaded to the cache
  * anything else            -> local filesystem path, returned as-is

Resolution order for remote schemes: the local cache dir ($PROBEN_CACHE_DIR
or ~/.cache/proben_tpu, keyed by URL path; the JAX package's, so both find
the same files), then a zoo mirror directory ($PROBEN_ZOO_DIR, keyed by the
flattened URL path, by parent dir + basename, or by the bare basename unless
it is a generic ``model_final*``), then a urllib download attempt, which
raises ``FileNotFoundError`` where there is no network.
"""

from __future__ import annotations

import logging
import os
from typing import Optional
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

D2_PREFIX = "detectron2://"
CATALOG_PREFIX = "catalog://"
S3_D2_URL = "https://dl.fbaipublicfiles.com/detectron2/"
S3_C2_URL = "https://dl.fbaipublicfiles.com/detectron"

# legacy Caffe2 catalog (reference catalog.py:20-52); detector-relevant rows
C2_IMAGENET_MODELS = {
    "MSRA/R-50": "ImageNetPretrained/MSRA/R-50.pkl",
    "MSRA/R-101": "ImageNetPretrained/MSRA/R-101.pkl",
    "FAIR/X-101-32x8d": "ImageNetPretrained/20171220/X-101-32x8d.pkl",
}
C2_DETECTRON_PATH_FORMAT = "{prefix}/{url}/output/train/{dataset}/{type}/model_final.pkl"
C2_DATASET_COCO = "coco_2014_train%3Acoco_2014_valminusminival"
C2_DETECTRON_MODELS = {
    "35857197/e2e_faster_rcnn_R-50-C4_1x": "35857197/12_2017_baselines/e2e_faster_rcnn_R-50-C4_1x.yaml.01_33_49.iAX0mXvW",  # noqa: E501
    "35857345/e2e_faster_rcnn_R-50-FPN_1x": "35857345/12_2017_baselines/e2e_faster_rcnn_R-50-FPN_1x.yaml.01_36_30.cUF7QR7I",  # noqa: E501
    "35857890/e2e_faster_rcnn_R-101-FPN_1x": "35857890/12_2017_baselines/e2e_faster_rcnn_R-101-FPN_1x.yaml.01_38_50.sNxI7sX7",  # noqa: E501
}


def catalog_entry_url(name: str) -> str:
    """reference ``ModelCatalog.get`` (catalog.py:54-90)."""
    if name.startswith("ImageNetPretrained/"):
        key = name[len("ImageNetPretrained/"):]
        key = key[:-4] if key.endswith(".pkl") else key
        if key not in C2_IMAGENET_MODELS:
            raise RuntimeError(f"model not present in the catalog: {name}")
        return f"{S3_C2_URL}/{C2_IMAGENET_MODELS[key]}"
    if name.startswith("Caffe2Detectron/COCO/"):
        key = name[len("Caffe2Detectron/COCO/"):]
        model_type = "generalized_rcnn"
        if key not in C2_DETECTRON_MODELS:
            raise RuntimeError(f"model not present in the catalog: {name}")
        return C2_DETECTRON_PATH_FORMAT.format(
            prefix=S3_C2_URL,
            url=C2_DETECTRON_MODELS[key],
            dataset=C2_DATASET_COCO,
            type=model_type,
        )
    raise RuntimeError(f"model not present in the catalog: {name}")


def default_cache_dir() -> str:
    return os.environ.get(
        "PROBEN_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "proben_tpu"),
    )


def _cached_fetch(url: str, cache_dir: Optional[str]) -> str:
    cache_dir = cache_dir or default_cache_dir()
    rel = urlparse(url).path.lstrip("/")
    local = os.path.join(cache_dir, rel)
    if os.path.exists(local):
        return local
    # zoo mirror (offline machines). Keyed first by the whole URL path with
    # separators flattened: every catalog:// Caffe2 COCO baseline ends in
    # model_final.pkl, so a bare-basename key would serve one model's
    # weights for another's. The basename key is a fallback only where it
    # is unambiguous (not a generic model_final.*).
    zoo_dir = os.environ.get("PROBEN_ZOO_DIR", "")
    if zoo_dir:
        flat = rel.replace("/", "__")
        for key in (flat, os.path.join(*rel.split("/")[-2:]).replace("/", "__")):
            mirror = os.path.join(zoo_dir, key)
            if os.path.exists(mirror):
                return mirror
        base = os.path.basename(rel)
        if not base.startswith("model_final"):
            mirror = os.path.join(zoo_dir, base)
            if os.path.exists(mirror):
                return mirror
    os.makedirs(os.path.dirname(local), exist_ok=True)
    import urllib.request

    logger.info("downloading %s -> %s", url, local)
    try:
        tmp = local + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, local)
        return local
    except Exception as e:  # machines without a network land here
        raise FileNotFoundError(
            f"cannot fetch {url} (offline?). Place the file at {local} or in "
            f"$PROBEN_ZOO_DIR as {rel.replace('/', '__')}."
        ) from e


def resolve_checkpoint_path(path: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a MODEL.WEIGHTS value to a local file path."""
    if path.startswith(D2_PREFIX):
        return _cached_fetch(S3_D2_URL + path[len(D2_PREFIX):], cache_dir)
    if path.startswith(CATALOG_PREFIX):
        return _cached_fetch(catalog_entry_url(path[len(CATALOG_PREFIX):]), cache_dir)
    if path.startswith(("http://", "https://")):
        return _cached_fetch(path, cache_dir)
    return path
