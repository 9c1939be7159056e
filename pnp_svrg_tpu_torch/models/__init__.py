"""CNN denoiser models (DnCNN, SimpleCNN, MMO) and their Flax weights."""

from pnp_svrg_tpu_torch.models.convert import load_flax_npz, torch_state_dict_from_flax
from pnp_svrg_tpu_torch.models.dncnn import DnCNN, MMOSimpleCNN, model_for_type

__all__ = ["DnCNN", "MMOSimpleCNN", "model_for_type", "load_flax_npz", "torch_state_dict_from_flax"]
