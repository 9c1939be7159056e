"""Problem helpers, batching and the gradient checks."""

from pnp_svrg_tpu_torch.core.checks import GradientCheckError, grad_full_check, grad_stoch_check

__all__ = ["grad_full_check", "grad_stoch_check", "GradientCheckError"]
