from fastdet_torch.io.checkpoint import (latest_step, load_checkpoint,
                                        save_checkpoint)
from fastdet_torch.io.weights import (from_jax_variables, load_npz_variables,
                                     load_state_dict, merge_variables,
                                     save_npz_variables, to_jax_variables)
from fastdet_torch.io.torch_convert import (convert_state_dict,
                                           convert_torch_checkpoint,
                                           load_torch_weights)

__all__ = ["convert_state_dict", "convert_torch_checkpoint",
           "from_jax_variables", "latest_step", "load_checkpoint",
           "load_npz_variables", "load_state_dict", "load_torch_weights",
           "merge_variables", "save_checkpoint", "save_npz_variables",
           "to_jax_variables"]
