from .ckpt import (
    CheckpointManager,
    load_train_state,
    restore_pytree,
    save_pytree,
    train_state_tree,
)
from .from_jax import state_dict_from_jax, state_dict_to_jax
from .paths import catalog_entry_url, resolve_checkpoint_path
from .torch_import import (
    convert_caffe2_names,
    fc1_nchw_to_nhwc_perm,
    import_detectron2_checkpoint,
    load_state_dict,
)

__all__ = [
    "CheckpointManager",
    "catalog_entry_url",
    "convert_caffe2_names",
    "fc1_nchw_to_nhwc_perm",
    "import_detectron2_checkpoint",
    "load_state_dict",
    "load_train_state",
    "resolve_checkpoint_path",
    "restore_pytree",
    "save_pytree",
    "state_dict_from_jax",
    "state_dict_to_jax",
    "train_state_tree",
]
