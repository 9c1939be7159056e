"""RealSN-DnCNN training in PyTorch.

Port of ``pnp_svrg_tpu/training/train_dncnn.py``: residual-MSE objective
``sum((model(clean + noise) - noise)^2) / (2B)``, Adam with a /10 learning
rate drop at the milestone epoch, fixed-sigma (mode S) or blind per-sample
sigma (mode B) noise, the conv-operator spectral norm inside the forward pass
(the RealSN constraint), per-epoch Set12 validation PSNR/SSIM,
config-guarded checkpoint/resume in the JAX package's on-disk layout, and
JSONL scalar logging.

The model is the port's ``DnCNN`` in training mode (its ``BatchNorm`` moves
the running statistics by Flax's rule); the spectral-norm vectors ``u_state``
are NCHW tensors keyed by Flax's ``Conv_i``. One step: the power iteration on
the raw kernels without grad (advancing ``u_state``), the forward pass with
every kernel scaled by ``target / sigma(u, v)`` (``torch.func.functional_call``
substitutes the scaled kernels, so gradients flow through sigma), the
backward pass and ``torch.optim.Adam``, which is optax's ``adam`` up to the
order of rounding. The convolutions and BatchNorm are cuDNN's on the card;
the JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.models.convert import (
    flax_layers,
    flax_variables_from_torch,
    torch_state_dict_from_flax,
    u_state_from_flax,
    u_state_to_flax,
)
from pnp_svrg_tpu_torch.models.dncnn import DnCNN, flax_init_
from pnp_svrg_tpu_torch.models.spectral_norm import (
    bn_spectral_clamp,
    init_u,
    power_iteration_uv,
    realsn_targets,
    sigma_uv,
)
from pnp_svrg_tpu_torch.ops.metrics import psnr, ssim
from pnp_svrg_tpu_torch.training import data as data_lib
from pnp_svrg_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.adam's defaults


@dataclasses.dataclass
class TrainConfig:
    depth: int = 17
    features: int = 64
    channels: int = 1
    use_bn: bool = True
    lip: float = 0.0  # 0 => no spectral constraint; >0 => RealSN product bound
    adaptive_sigmas: tuple | None = None  # explicit per-conv SN targets; length == depth
    batch_size: int = 128
    epochs: int = 50
    milestone: int = 30  # LR /10 from this epoch on
    lr: float = 1e-3
    mode: str = "S"  # S: fixed sigma, B: blind
    noise_level: float = 40.0  # sigma in /255 units (mode S)
    blind_range: tuple = (0.0, 55.0)
    bn_sn: float = 0.0  # BN spectral-norm target; 0 = off. The RealSN recipe
    # turns it off: clamping BN to 1.0 forbids it from re-amplifying the
    # SN-shrunk conv activations and collapses the net to the zero predictor.
    sn_probe_hw: int = 40
    sn_iters: int = 1
    seed: int = 0

    def as_dict(self) -> dict:
        """The config as ``config.json`` stores it (lists for tuples), equal
        to the JAX package's ``TrainConfig.as_dict``."""
        d = dataclasses.asdict(self)
        d["blind_range"] = list(d["blind_range"])
        if d["adaptive_sigmas"] is not None:
            d["adaptive_sigmas"] = list(d["adaptive_sigmas"])
        return d


def _sn_enabled(cfg: TrainConfig) -> bool:
    return cfg.lip > 0 or cfg.adaptive_sigmas is not None


def new_model(cfg: TrainConfig, generator: torch.Generator | None = None) -> DnCNN:
    """The config's DnCNN with Flax's initial values (on the CPU)."""
    return flax_init_(DnCNN(cfg.channels, cfg.depth, cfg.features, cfg.use_bn), generator)


def init_u_state(model: DnCNN, hw: int, generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """A random unit ``u`` (1, C_out, hw, hw) for each conv, keyed ``Conv_i``,
    on the model's device."""
    dev = next(model.parameters()).device
    return {name: init_u(layer.out_channels, hw, generator).to(dev)
            for name, _, layer in flax_layers(model) if isinstance(layer, nn.Conv2d)}


def sn_pairs(model: DnCNN, u_state: dict, n_iters: int) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """``Conv_i -> (u, v)`` after ``n_iters`` power iterations on each raw
    kernel from ``u_state``, without grad."""
    return {name: power_iteration_uv(layer.weight, u_state[name], n_iters)
            for name, _, layer in flax_layers(model) if isinstance(layer, nn.Conv2d)}


def _sn_effective_params(model: DnCNN, uv: dict, cfg: TrainConfig) -> dict[str, torch.Tensor]:
    """The spectrally normalised parameters the raw ones parametrise, keyed
    by the model's parameter names: every conv kernel scaled by
    ``target / sigma`` with sigma differentiable through the fixed (u, v)
    pair, and with ``bn_sn > 0`` the BatchNorm scales clamped through the
    running variance as it stands before the step.

    This runs in the forward pass, like the reference's pre-hooks. A post-step
    projection is not equivalent: it compounds multiplicative shrinkage into
    the raw parameters every step and collapses the model to the zero
    predictor."""
    targets = realsn_targets(cfg.lip, cfg.depth, cfg.adaptive_sigmas)
    out = {}
    for name, prefix, layer in flax_layers(model):
        if isinstance(layer, nn.Conv2d):
            u, v = uv[name]
            sigma = sigma_uv(layer.weight, u, v)
            target = torch.full_like(sigma, targets[int(name.split("_")[1])])
            out[f"{prefix}.weight"] = layer.weight * (target / sigma)
        elif cfg.bn_sn > 0:
            out[f"{prefix}.weight"], out[f"{prefix}.bias"] = bn_spectral_clamp(
                layer.weight, layer.bias, layer.running_var.detach().clone(), cfg.bn_sn)
    return out


@torch.no_grad()
def effective_variables(model: DnCNN, u_state: dict, cfg: TrainConfig, n_iters: int = 30) -> DnCNN:
    """The effective (normalised) network of the raw training model, as a new
    ``DnCNN`` in eval mode without grad: what evaluation, export and the
    denoiser loaders take. A converged power iteration (``n_iters``) makes
    the per-layer Lipschitz targets hold on the saved weights."""
    eff = DnCNN(model.channels, model.depth, model.features, model.use_bn).to(next(model.parameters()).device)
    eff.load_state_dict(model.state_dict())
    if _sn_enabled(cfg):
        for pname, value in _sn_effective_params(model, sn_pairs(model, u_state, n_iters), cfg).items():
            eff.get_parameter(pname).copy_(value)
    return eff.eval().requires_grad_(False)


def new_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam as optax's ``adam(lr)``: betas 0.9 / 0.999, eps 1e-8."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def train_step(model: DnCNN, optimizer: torch.optim.Optimizer, u_state: dict, noisy: torch.Tensor,
               noise: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """One step on an NCHW (noisy, noise) batch; advances ``u_state`` in place
    and returns the loss (a device scalar, not read back)."""
    model.train()
    overrides = {}
    if _sn_enabled(cfg):
        # Power-iterate u/v once per step outside the gradient (the
        # reference pre-hook's no_grad update).
        uv = sn_pairs(model, u_state, cfg.sn_iters)
        u_state.update({name: u for name, (u, _) in uv.items()})
        overrides = _sn_effective_params(model, uv, cfg)
    optimizer.zero_grad(set_to_none=True)
    out = functional_call(model, overrides, (noisy,))
    loss = torch.sum((out - noise) ** 2) / (2.0 * noisy.shape[0])
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def evaluate(model: DnCNN, val_images: Sequence[np.ndarray], sigma: float, seed: int = 1234):
    """Mean (PSNR, SSIM) of the eval-mode ``model`` denoising each image of
    ``val_images`` (H, W) in order, with noise ``sigma`` times normal draws of
    ``default_rng(seed)``; the denoised image is ``clip(noisy - r, 0, 1)``."""
    if model.training:
        raise ValueError("evaluate takes a model in eval mode (see effective_variables)")
    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    scores = []
    for img in val_images:
        clean = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        noise = torch.from_numpy(rng.standard_normal(clean.shape).astype(np.float32)).to(dev)
        noisy = clean + sigma * noise
        den = torch.clamp(noisy - model(noisy[None, None])[0, 0], 0.0, 1.0)
        scores.append(torch.stack([psnr(clean, den), ssim(clean, den)]))
    vals = torch.stack(scores).cpu().tolist()
    return float(np.mean([v[0] for v in vals])), float(np.mean([v[1] for v in vals]))


def train(
    cfg: TrainConfig,
    exp_dir: str | Path,
    train_dir=data_lib.REFERENCE_TRAIN_DIR,
    val_dir=data_lib.REFERENCE_VAL_DIR,
    max_images: int | None = None,
    max_steps_per_epoch: int | None = None,
    log_every: int = 50,
    verbose: bool = True,
    device=None,
):
    """Training with checkpoint/resume on ``device`` (CUDA unless ``"cpu"``).

    Resumes from ``exp_dir`` when it holds a checkpoint of the same config
    (with a fresh Adam, as the JAX package does), else starts from Flax's
    initial values drawn from a generator seeded ``cfg.seed``. Each epoch
    appends its record to ``scalars.jsonl`` and writes a checkpoint. Returns
    the effective network and the epochs' records."""
    dev = resolve_device(device)
    exp_dir = Path(exp_dir)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = new_model(cfg, gen)
    u_state = init_u_state(model, cfg.sn_probe_hw, gen)
    start_epoch = 0
    ckpt = load_checkpoint(exp_dir, cfg.as_dict())
    if ckpt is not None and "variables" in ckpt:
        model.load_state_dict(torch_state_dict_from_flax(ckpt["variables"], model))
        if "u_state" in ckpt:
            u_state = u_state_from_flax(ckpt["u_state"])
        start_epoch = int(ckpt.get("epoch", 0))
        if verbose:
            print(f"resumed {exp_dir} at epoch {start_epoch}")
    model.to(dev)
    u_state = {name: u.to(dev) for name, u in u_state.items()}

    patches = data_lib.build_patch_dataset(train_dir, max_images=max_images, seed=cfg.seed, device=dev)
    val_images = [data_lib.load_gray(p) for p in sorted(Path(val_dir).glob("*.png"))]
    optimizer = new_optimizer(model, cfg.lr)
    sigma = ((cfg.blind_range[0] / 255.0, cfg.blind_range[1] / 255.0) if cfg.mode == "B"
             else cfg.noise_level / 255.0)

    log_path = exp_dir / "scalars.jsonl"
    exp_dir.mkdir(parents=True, exist_ok=True)
    history = []
    for epoch in range(start_epoch, cfg.epochs):
        lr = cfg.lr / (10.0 if epoch >= cfg.milestone else 1.0)
        for group in optimizer.param_groups:
            group["lr"] = lr
        t0 = time.time()
        losses = []
        for step_i, (noisy, noise) in enumerate(
            data_lib.batches(patches, cfg.batch_size, sigma, seed=cfg.seed + epoch)
        ):
            if max_steps_per_epoch is not None and step_i >= max_steps_per_epoch:
                break
            losses.append(train_step(model, optimizer, u_state, noisy, noise, cfg))
            if verbose and step_i % log_every == 0:
                print(f"epoch {epoch} step {step_i}: loss {float(losses[-1]):.5f}")
        val_sigma = cfg.noise_level / 255.0 if cfg.mode == "S" else 25.0 / 255.0
        # Validation sees the effective (spectrally normalised) network; the
        # raw parameters are only its parametrisation.
        val_psnr, val_ssim = evaluate(effective_variables(model, u_state, cfg), val_images, val_sigma)
        rec = {
            "epoch": epoch,
            "lr": lr,
            "train_loss": float(np.mean(torch.stack(losses).cpu().tolist())) if losses else float("nan"),
            "val_psnr": val_psnr,
            "val_ssim": val_ssim,
            "seconds": time.time() - t0,
        }
        history.append(rec)
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if verbose:
            print(f"epoch {epoch}: {rec}")
        save_checkpoint(exp_dir, {"variables": flax_variables_from_torch(model),
                                  "u_state": u_state_to_flax(u_state), "epoch": epoch + 1}, cfg.as_dict())
    # Callers (export, the denoiser loaders) get the effective network; the
    # checkpoints keep the raw parametrisation for exact resume.
    return effective_variables(model, u_state, cfg), history
