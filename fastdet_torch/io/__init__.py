from fastdet_torch.io.weights import (from_jax_variables, load_npz_variables,
                                     load_state_dict, to_jax_variables)

__all__ = ["from_jax_variables", "load_npz_variables", "load_state_dict",
           "to_jax_variables"]
