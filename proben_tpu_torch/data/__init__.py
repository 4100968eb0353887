from .catalog import DatasetCatalog, MetadataCatalog
from .coco import load_coco_json, register_coco_instances
from .dataset_mapper import DatasetMapper, MapperConfig
from .detection_utils import derive_rgb_path, read_image
from .loader import TrainLoader, build_test_loader, collate, training_index_stream
from .samplers import repeat_factor_index_stream, repeat_factors_from_category_frequency

__all__ = [
    "DatasetCatalog",
    "DatasetMapper",
    "MapperConfig",
    "MetadataCatalog",
    "TrainLoader",
    "build_test_loader",
    "collate",
    "derive_rgb_path",
    "load_coco_json",
    "read_image",
    "register_coco_instances",
    "repeat_factor_index_stream",
    "repeat_factors_from_category_frequency",
    "training_index_stream",
]
