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
from pnp_svrg_tpu_torch.models.spectral_norm import (
    bn_spectral_clamp,
    conv_power_iteration,
    init_u,
    realsn_target,
    spectrally_normalize_kernel,
)

__all__ = [
    "DnCNN",
    "MMOSimpleCNN",
    "flax_init_",
    "model_for_type",
    "conv_power_iteration",
    "spectrally_normalize_kernel",
    "bn_spectral_clamp",
    "realsn_target",
    "init_u",
    "load_flax_npz",
    "save_flax_npz",
    "torch_state_dict_from_flax",
    "flax_variables_from_torch",
    "u_state_from_flax",
    "u_state_to_flax",
]
