"""Denoisers: the PnP prior step (BM3D, non-local means, the wavelet
BayesShrink "TV" denoiser and the CNN denoisers)."""

from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams, bm3d_denoise
from pnp_svrg_tpu_torch.denoisers.dncnn import DnCNNDenoiser, MMODenoiser, load_denoiser_params
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser, nlm_denoise
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser

__all__ = [
    "BM3DDenoiser", "BM3DParams", "bm3d_denoise", "DnCNNDenoiser", "MMODenoiser", "NLMDenoiser",
    "nlm_denoise", "TVDenoiser", "load_denoiser_params",
]
