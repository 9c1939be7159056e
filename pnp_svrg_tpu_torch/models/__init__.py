"""CNN denoiser models (DnCNN, SimpleCNN, MMO), their Flax weights and the
conv-operator spectral norm of training."""

from pnp_svrg_tpu_torch.models.convert import (
    flax_variables_from_torch,
    load_flax_npz,
    save_flax_npz,
    torch_state_dict_from_flax,
    u_state_from_flax,
    u_state_to_flax,
)
from pnp_svrg_tpu_torch.models.dncnn import DnCNN, MMOSimpleCNN, flax_init_, model_for_type

__all__ = [
    "DnCNN",
    "MMOSimpleCNN",
    "flax_init_",
    "model_for_type",
    "load_flax_npz",
    "save_flax_npz",
    "torch_state_dict_from_flax",
    "flax_variables_from_torch",
    "u_state_from_flax",
    "u_state_to_flax",
]
