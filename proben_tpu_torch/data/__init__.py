from .catalog import DatasetCatalog, MetadataCatalog
from .coco import load_coco_json, register_coco_instances
from .dataset_mapper import DatasetMapper, MapperConfig
from .detection_utils import derive_rgb_path, read_image
from .loader import build_test_loader, collate

__all__ = [
    "DatasetCatalog",
    "DatasetMapper",
    "MapperConfig",
    "MetadataCatalog",
    "build_test_loader",
    "collate",
    "derive_rgb_path",
    "load_coco_json",
    "read_image",
    "register_coco_instances",
]
