"""The inverse problems: CSMRI, Deblur/SR and phase retrieval."""

from pnp_svrg_tpu_torch.problems.csmri import CSMRI, make_csmri
from pnp_svrg_tpu_torch.problems.deblur import Deblur, make_deblur, make_identity_kernel, make_minimal_kernel
from pnp_svrg_tpu_torch.problems.pr import PhaseRetrieval, make_phase_retrieval, spectral_init

__all__ = [
    "CSMRI",
    "make_csmri",
    "Deblur",
    "make_deblur",
    "make_minimal_kernel",
    "make_identity_kernel",
    "PhaseRetrieval",
    "make_phase_retrieval",
    "spectral_init",
]
