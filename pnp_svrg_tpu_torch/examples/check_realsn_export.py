"""Check an exported RealSN-DnCNN checkpoint and record its validation
metrics: port of ``tools/check_realsn_export.py`` with its arguments.

    python -m pnp_svrg_tpu_torch.examples.check_realsn_export realsn_dncnn_noise5 --lip 0.3 [--cpu]

1. Every conv layer's spectral norm against its per-layer Lipschitz target
   ``lip ** (1 / depth)``: the largest of 3 power iterations (60 steps each)
   on the SAME convolution over a 40 x 40 probe, restart ``r`` of layer
   ``i`` from a ``torch.Generator`` seeded ``100 * i + r``; for the first
   ``--dense-layers`` layers and the last, also the top singular value of
   the layer's dense VALID operator on a ``--dense-probe`` square input
   (:func:`unroll_multi`, numpy; the SVD in float64), which bounds the SAME
   operator's norm from below. A layer more than 5 % over its target, or a product of the layers'
   norms more than 10 % over ``lip``, fails the check.
2. Set12 PSNR and SSIM of the network denoising each image of ``--val-dir``
   (sorted) with noise ``sigma / 255`` drawn from
   ``numpy.random.default_rng(1234)`` in order, as the JAX tool and
   ``training.evaluate`` draw it.

Runs on the CUDA card unless ``--cpu``. The checkpoint is read from
``checkpoints/<name>.npz`` (or ``--checkpoint-dir``); the record goes to
``build/realsn_export/<name>.val.json`` (or ``--out-dir``), never beside the
checkpoint.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from pnp_svrg_tpu_torch.convert import VAL_DIR
from pnp_svrg_tpu_torch.denoisers.dncnn import CHECKPOINT_DIR, flax_model
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.models.convert import load_flax_npz
from pnp_svrg_tpu_torch.models.dncnn import DnCNN
from pnp_svrg_tpu_torch.models.spectral_norm import conv_power_iteration, init_u, realsn_target
from pnp_svrg_tpu_torch.training.data import load_gray
from pnp_svrg_tpu_torch.training.train_dncnn import evaluate

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "realsn_export"
RESTARTS, POWER_ITERS, PROBE_HW, VAL_SEED = 3, 60, 40, 1234
LAYER_SLACK, PRODUCT_SLACK = 1.05, 1.1


def unroll_multi(kernel: np.ndarray, n: int) -> np.ndarray:
    """Dense float64 matrix of the VALID 2-D correlation of an (m, m, cin,
    cout) HWIO kernel on an (n, n, cin) input, rows (cout, out_y, out_x) and
    columns (cin, y, x): the multi-channel form of
    ``training.utils.unroll_kernel``."""
    m, _, cin, cout = kernel.shape
    out_n = n - m + 1
    mat = np.zeros((cout * out_n * out_n, cin * n * n), np.float64)
    for co in range(cout):
        for ci in range(cin):
            k = kernel[:, :, ci, co]
            for oy in range(out_n):
                for ox in range(out_n):
                    r = co * out_n * out_n + oy * out_n + ox
                    base = ci * n * n
                    for j in range(m):
                        mat[r, base + (oy + j) * n + ox : base + (oy + j) * n + ox + m] = k[j]
    return mat


def conv_kernels(variables: dict) -> list[np.ndarray]:
    """The HWIO kernels of ``Conv_0``, ``Conv_1``, ... in layer order."""
    params = variables["params"]
    names = sorted((k for k in params if k.startswith("Conv_")), key=lambda s: int(s.split("_")[1]))
    return [np.asarray(params[n]["kernel"], np.float32) for n in names]


def restart_inits(kernels: list[np.ndarray], device=None) -> list[list[torch.Tensor]]:
    """Per layer, the :data:`RESTARTS` unit start vectors (1, C_out, 40, 40)
    of its power iterations, restart ``r`` of layer ``i`` from a generator
    seeded ``100 * i + r``."""
    dev = resolve_device(device)
    return [[init_u(k.shape[-1], PROBE_HW, torch.Generator(device=dev).manual_seed(100 * i + r), dev)
             for r in range(RESTARTS)] for i, k in enumerate(kernels)]


def layer_sigmas(kernels: list[np.ndarray], inits: list[list[torch.Tensor]]) -> list[float]:
    """Per layer, the largest sigma of its power iterations from ``inits``
    (:data:`POWER_ITERS` steps each) on the device the start vectors lie on."""
    out = []
    for kern, us in zip(kernels, inits):
        weight = torch.as_tensor(kern.transpose(3, 2, 0, 1).copy(), device=us[0].device)  # HWIO -> OIHW
        out.append(max(float(conv_power_iteration(weight, u, POWER_ITERS)[0]) for u in us))
    return out


def dense_sigma(kernel: np.ndarray, probe: int, device=None) -> float:
    """The top singular value of the kernel's dense VALID operator on a
    ``probe`` x ``probe`` input, in float64: numpy's SVD on the CPU (the JAX
    tool's), ``torch.linalg.svdvals`` on the card (numpy's SVD of a
    64-channel layer's 4096 x 6400 matrix holds the host for a minute)."""
    mat = unroll_multi(kernel, probe)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return float(np.linalg.svd(mat, compute_uv=False)[0])
    return float(torch.linalg.svdvals(torch.from_numpy(mat).to(dev))[0])


def check(name: str, lip: float = 0.3, sigma: float | None = None, dense_probe: int = 10,
          dense_layers: int = 3, device=None, checkpoint_dir: Path = CHECKPOINT_DIR,
          val_dir: Path = VAL_DIR, inits=None) -> dict:
    """The two checks on ``checkpoint_dir/<name>.npz``: its record (the JAX
    tool's fields, plus ``ok``, the dense singular values and the failing
    layers). ``inits`` replaces :func:`restart_inits` (the tests inject the
    JAX package's start vectors)."""
    dev = resolve_device(device)
    variables = load_flax_npz(Path(checkpoint_dir) / f"{name}.npz")
    kernels = conv_kernels(variables)
    depth = len(kernels)
    target = realsn_target(lip, depth)
    sigmas = layer_sigmas(kernels, restart_inits(kernels, dev) if inits is None else inits)
    dense = {i: dense_sigma(kernels[i], dense_probe, dev) for i in range(depth)
             if i < dense_layers or i == depth - 1}
    over = sorted({i for i, s in enumerate(sigmas) if s > target * LAYER_SLACK}
                  | {i for i, s in dense.items() if s > target * LAYER_SLACK})
    product = float(np.prod(sigmas))
    noise = float(name.rsplit("noise", 1)[-1]) if sigma is None else sigma
    use_bn = any(k.startswith("BatchNorm") for k in variables["params"])
    features = kernels[0].shape[-1]  # the JAX tool takes the default 64
    model = flax_model(DnCNN(channels=1, depth=depth, features=features, use_bn=use_bn), variables, dev)
    images = [load_gray(p) for p in sorted(Path(val_dir).glob("*.png"))]
    val_psnr, val_ssim = evaluate(model, images, noise / 255.0, seed=VAL_SEED)
    return {
        "val_psnr_db": val_psnr,
        "val_ssim": val_ssim,
        "noisy_input_psnr_db": float(20 * np.log10(255.0 / noise)),
        "val_set": f"{Path(val_dir).name} ({len(images)} images)",
        "noise_sigma": noise,
        "lip": lip,
        "per_layer_sigma": sigmas,
        "per_layer_target": target,
        "lipschitz_product_bound": product,
        "dense_valid_svd": {str(i): s for i, s in dense.items()},
        "layers_over_target": over,
        "ok": not over and product <= lip * PRODUCT_SLACK,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", help="checkpoint name, e.g. realsn_dncnn_noise5")
    ap.add_argument("--lip", type=float, default=0.3)
    ap.add_argument("--sigma", type=float, default=None, help="val noise sigma /255 (default: parsed from name)")
    ap.add_argument("--dense-probe", type=int, default=10)
    ap.add_argument("--dense-layers", type=int, default=3,
                    help="how many layers get the exact dense-SVD cross-check "
                    "(all layers get the power-iteration check)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (else the CUDA card)")
    ap.add_argument("--checkpoint-dir", type=Path, default=CHECKPOINT_DIR)
    ap.add_argument("--val-dir", type=Path, default=VAL_DIR)
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)
    rec = check(args.name, args.lip, args.sigma, args.dense_probe, args.dense_layers,
                "cpu" if args.cpu else None, args.checkpoint_dir, args.val_dir)
    print(f"{args.name}: {len(rec['per_layer_sigma'])} convs, per-layer target {rec['per_layer_target']:.4f} "
          f"(lip={args.lip})")
    for i, s in enumerate(rec["per_layer_sigma"]):
        dense = rec["dense_valid_svd"].get(str(i))
        print(f"  Conv_{i}: sigma={s:.4f}" + (f"  dense-VALID svd={dense:.4f}" if dense is not None else "")
              + ("  <-- EXCEEDS TARGET" if i in rec["layers_over_target"] else ""))
    print(f"product bound: {rec['lipschitz_product_bound']:.5f} (<= lip={args.lip} required)")
    print(f"val ({rec['val_set']}, sigma={rec['noise_sigma']:g}): PSNR {rec['val_psnr_db']:.2f} dB "
          f"(noisy input: {rec['noisy_input_psnr_db']:.2f}), SSIM {rec['val_ssim']:.4f}")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    out = args.out_dir / f"{args.name}.val.json"
    out.write_text(json.dumps(rec, indent=1))
    print(f"wrote {out}")
    if not rec["ok"]:
        raise SystemExit("SPECTRAL NORM TARGETS VIOLATED")
    return rec


if __name__ == "__main__":
    main()
