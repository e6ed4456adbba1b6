from .jax_import import diffwave_state_dict_from_jax, state_dict_from_jax

__all__ = ["diffwave_state_dict_from_jax", "state_dict_from_jax"]
