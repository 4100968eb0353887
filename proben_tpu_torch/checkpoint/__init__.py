from .from_jax import state_dict_from_jax, state_dict_to_jax

__all__ = ["state_dict_from_jax", "state_dict_to_jax"]
