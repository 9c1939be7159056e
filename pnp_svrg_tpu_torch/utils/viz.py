"""Result visualization and metrics reporting.

Port of ``pnp_svrg_tpu/utils/viz.py``: the reference's L4 layer,
``Utilities.display_results`` (output image + PSNR-vs-time curve +
printed/CSV metrics, reference ``Utilities.py:5-64``) and the ``utils.py``
grid/animation helpers (``show_multiple/show_grid/psnr_display``, reference
``utils.py:8-96``). Tensors come to the host at each function's edge
(``.detach().cpu().numpy()``); matplotlib is imported inside the figure
functions, so headless and batch runs never pay for it (and need not have
it).

The reference's ``display_results`` has a format-string bug that prints the
gradient time in the denoise column (duplicated ``{3}`` field,
``Utilities.py:51-53``); fixed here, as in the JAX package.

The port's loops return batched results (``z`` (B, N), ``psnr_per_iter``
(T, B)); :func:`summarize_results` and :func:`display_results` take one-lane
runs and reshape to ``(problem.h, problem.w)`` as the JAX functions do.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _trace(output: dict) -> np.ndarray:
    """The (T,) float64 PSNR trace of a one-lane run ((T,) or (T, 1))."""
    psnrs = _host(output["psnr_per_iter"]).astype(float)
    return psnrs.reshape(psnrs.shape[0])


def summarize_results(problem, output: dict) -> dict:
    """Metrics dict for one reconstruction run (the data behind the
    reference's printed table)."""
    psnrs = _trace(output)
    return {
        "algo_name": output.get("algo_name", "?"),
        "output_psnr": float(psnrs[-1]),
        "delta_psnr": float(psnrs[-1] - psnrs[0]),
        "gradient_time": float(output.get("gradient_time", float("nan"))),
        "denoise_time": float(output.get("denoise_time", float("nan"))),
        "n_iters": int(len(psnrs) - 1),
    }


def write_metrics_csv(rows: list[dict], path: str | Path) -> None:
    """CSV emitter (reference ``Utilities.py:54-63`` / sweep scripts)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        return
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def display_results(
    problem,
    output: dict,
    save_results: bool = False,
    save_dir: str | Path = "figures",
    show: bool = False,
    color_map: str = "gray",
):
    """Render the output image and the PSNR-vs-cumulative-time curve
    (reference ``Utilities.py:5-64``); returns the summary dict."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    summary = summarize_results(problem, output)
    z = _host(output["z"]).reshape(problem.h, problem.w)
    psnrs = _trace(output)
    times = _host(output.get("time_per_iter", np.arange(len(psnrs)))).astype(float)
    cumt = np.cumsum(times)

    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    axes[0].imshow(z, cmap=color_map, vmin=0, vmax=1)
    axes[0].set_title(f"{summary['algo_name']}: {summary['output_psnr']:.2f} dB")
    axes[0].set_xticks([])
    axes[0].set_yticks([])
    axes[1].plot(cumt, psnrs, marker="o", markevery=max(len(psnrs) // 30, 1))
    axes[1].set_xlabel("time (s)" if "time_per_iter" in output else "iteration")
    axes[1].set_ylabel("PSNR (dB)")
    axes[1].set_title("PSNR vs time")
    fig.tight_layout()

    if save_results:
        out_dir = Path(save_dir) / getattr(problem, "pname", "run")
        out_dir.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_dir / f"{summary['algo_name'].replace(' ', '_')}.png",
                    dpi=150, bbox_inches="tight")
        write_metrics_csv([summary], out_dir / "metrics.csv")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return summary


def plot_training_curves(
    jsonl_path: str | Path,
    out_path: str | Path | None = None,
    show: bool = False,
):
    """Training-dashboard replacement: loss / val-PSNR / val-SSIM / LR curves
    from a training run's ``scalars.jsonl``.

    The reference drives a LIVE matplotlib dashboard from inside its training
    loop (reference ``denoisers/cnn/cnn.py:175-246``); here training emits
    JSONL scalars (``training/train_dncnn.py``) and this renders them
    after-the-fact or mid-run (the file is append-only). Returns the figure.
    """
    import json

    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    recs = [json.loads(l) for l in open(jsonl_path) if l.strip()]  # noqa: E741
    if not recs:
        raise ValueError(f"no records in {jsonl_path}")
    epochs = [r["epoch"] for r in recs]
    fig, axes = plt.subplots(1, 4, figsize=(16, 3.6))
    panels = [
        ("train_loss", "train loss", {"yscale": "log"}),
        ("val_psnr", "val PSNR (dB)", {}),
        ("val_ssim", "val SSIM", {}),
        ("lr", "learning rate", {"yscale": "log"}),
    ]
    for ax, (key, title, opts) in zip(axes, panels):
        ax.plot(epochs, [r.get(key, float("nan")) for r in recs], marker="o")
        ax.set_title(title)
        ax.set_xlabel("epoch")
        if opts.get("yscale"):
            ax.set_yscale(opts["yscale"])
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_path, dpi=130, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig


def show_grid(images, titles=None, ncols=4, color_map="gray", show=False):
    """Grid display helper (reference ``utils.py:show_grid``)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    images = [_host(im) for im in images]
    n = len(images)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(images[i], cmap=color_map, vmin=0, vmax=1)
            if titles:
                ax.set_title(titles[i], fontsize=9)
    fig.tight_layout()
    if show:
        plt.show()
    return fig


def gif(images, path=None, interval: int = 60, html: bool = False):
    """Animation helper (reference ``utils.py:44-65``): turn a sequence of
    (H, W) frames in [0, 1] into an animation.

    * ``path`` given -> write an animated GIF there (PIL writer, no ffmpeg
      dependency) and return the path.
    * ``html=True``  -> additionally return a self-contained HTML animation
      string (matplotlib ``to_jshtml``; the reference's ``to_html5_video``
      needs an ffmpeg binary).
    """
    from PIL import Image

    images = [_host(im) for im in images]
    frames8 = [
        Image.fromarray(
            (np.clip(np.asarray(im, np.float64), 0.0, 1.0) * 255).astype(np.uint8)
        )
        for im in images
    ]
    out_path = None
    if path is not None:
        out_path = Path(path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        frames8[0].save(
            out_path, save_all=True, append_images=frames8[1:],
            duration=interval, loop=0,
        )
    if html:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        fig = plt.figure()
        im = plt.imshow(images[0], cmap="gray", vmin=0, vmax=1)
        plt.axis("off")

        def animate(i):
            im.set_data(images[i])
            return (im,)

        anim = FuncAnimation(
            fig, animate, frames=range(len(images)), interval=interval
        )
        html_str = anim.to_jshtml()
        plt.close(fig)
        return html_str if out_path is None else (out_path, html_str)
    return out_path


def reconstruct_rgb(
    image_rgb,
    algo: str = "svrg",
    denoiser=None,
    sample_prob: float = 0.5,
    snr: float = 30.0,
    seed: int = 0,
    device=None,
    **hp,
):
    """Per-channel CSMRI reconstruction of an RGB image -- the working form
    of the reference's RGB comparison path (``utils.py:66-92``
    ``denoise_rgb``, commented out upstream): one CSMRI problem per channel,
    run as one 3-lane batch through ``parallel.runner.run_batch`` (the
    reference ran three sequential reconstructions), on ``device`` (CUDA
    unless ``"cpu"`` is passed).

    Channel c's problem draws from a generator seeded from ``(seed, c)``
    (``parallel.meas.lane_seed``) and the run's minibatches from ``seed +
    1``, as the JAX function splits ``PRNGKey(seed)`` three ways and runs on
    ``PRNGKey(seed + 1)``. The wavelet "TV" denoiser is the default.

    Returns ``(original, zero_filled_init, reconstruction)`` as (H, W, 3)
    float arrays in [0, 1].
    """
    from pnp_svrg_tpu_torch.core.batched import stack_problems
    from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
    from pnp_svrg_tpu_torch.device import resolve_device
    from pnp_svrg_tpu_torch.parallel.meas import lane_seed
    from pnp_svrg_tpu_torch.parallel.runner import run_batch
    from pnp_svrg_tpu_torch.problems.csmri import make_csmri

    dev = resolve_device(device)
    img = np.asarray(image_rgb, np.float64)
    if img.max() > 1.5:
        img = img / 255.0
    problems = [
        make_csmri(
            img[..., c].astype(np.float32),
            torch.Generator(device=dev).manual_seed(lane_seed(seed, 0, c)),
            sample_prob=sample_prob, snr=snr, device=dev,
        )
        for c in range(3)
    ]
    batched = stack_problems(problems)
    if denoiser is None:
        denoiser = TVDenoiser(sigma_modifier=1.0)
    out = run_batch(algo, batched, denoiser, seed=seed + 1, **hp)
    recon = np.moveaxis(_host(out["image"]), 0, -1)
    init = np.moveaxis(_host(batched.x_init), 0, -1)
    return img, np.clip(init, 0, 1), np.clip(recon, 0, 1)
