from .builtin import COCO_THING_CLASSES, register_all_builtin
from .catalog import DatasetCatalog, MetadataCatalog
from .cityscapes import load_cityscapes_instances, register_cityscapes_instances
from .coco import load_coco_json, load_sem_seg, register_coco_instances
from .dataset_mapper import DatasetMapper, MapperConfig
from .detection_utils import derive_rgb_path, read_image
from .loader import TrainLoader, build_test_loader, collate, training_index_stream
from .lvis import load_lvis_json, register_lvis_instances
from .pascal_voc import load_voc_instances, register_pascal_voc
from .samplers import repeat_factor_index_stream, repeat_factors_from_category_frequency

__all__ = [
    "COCO_THING_CLASSES",
    "DatasetCatalog",
    "DatasetMapper",
    "MapperConfig",
    "MetadataCatalog",
    "TrainLoader",
    "build_test_loader",
    "collate",
    "derive_rgb_path",
    "load_cityscapes_instances",
    "load_coco_json",
    "load_lvis_json",
    "load_sem_seg",
    "load_voc_instances",
    "read_image",
    "register_all_builtin",
    "register_cityscapes_instances",
    "register_coco_instances",
    "register_lvis_instances",
    "register_pascal_voc",
    "repeat_factor_index_stream",
    "repeat_factors_from_category_frequency",
    "training_index_stream",
]
