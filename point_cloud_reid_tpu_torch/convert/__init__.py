from .hf_vit import convert_hf_vit_state_dict, hf_vit_state_dict
from .jax_variables import from_jax_variables, port_key, to_jax_variables
from .torch_checkpoint import (load_image_reference_state_dict,
                               load_reference_state_dict,
                               load_torch_state_dict, reference_state_dict)

__all__ = ["convert_hf_vit_state_dict", "from_jax_variables",
           "hf_vit_state_dict", "load_image_reference_state_dict",
           "load_reference_state_dict", "load_torch_state_dict", "port_key",
           "reference_state_dict", "to_jax_variables"]
