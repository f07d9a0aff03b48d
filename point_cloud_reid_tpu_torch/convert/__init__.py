from .jax_variables import from_jax_variables, port_key, to_jax_variables

__all__ = ["from_jax_variables", "port_key", "to_jax_variables"]
