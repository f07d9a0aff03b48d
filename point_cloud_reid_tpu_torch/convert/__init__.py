from .hf_vit import convert_hf_vit_state_dict
from .jax_variables import from_jax_variables, port_key, to_jax_variables

__all__ = ["convert_hf_vit_state_dict", "from_jax_variables", "port_key",
           "to_jax_variables"]
