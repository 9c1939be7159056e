"""Non-local means: CUDA kernel K3 (``csrc/nlm.cu``) and its plain PyTorch
version.

Replaces the Pallas kernel ``nlm_denoise_pallas`` (``_nlm_kernel``,
``pnp_svrg_tpu/ops/pallas/nlm_kernel.py``), which computes the same function
as ``nlm_denoise`` (``pnp_svrg_tpu/denoisers/nlm.py:38-111``): skimage's
slow-mode NLM re-ordered as a loop over the ``(2d+1)^2`` shifts. For each
shift (dy-major, then dx):

1. square the difference between the reflect-padded image and its shift;
2. box-sum it over the ``p x p`` window (rows ``i..i+p-1`` of the padded
   canvas, so for the even p = 4 image rows ``i-2..i+1``);
3. weight ``exp(-max(dist - 2 sigma^2 p^2, 0) * (1 / (h^2 p^2)))``;
4. zero the weight of candidates outside ``[lo, hi) x [0, W)``;
5. accumulate the weight and the weight times ``x[i+dy, j+dx]``;

and return ``acc / max(wsum, 1e-12)``. The formula is kept in exactly this
form, unguarded: ``h = 0`` gives NaN (the self-shift's ``-0 * inf``), as in
JAX.

The wrapper :func:`nlm_denoise` takes the plain version only for a CPU
tensor; for a CUDA tensor it launches K3 or raises. K3 reads ``h`` and
``sigma`` through device pointers, so the reconstruction loop, whose
``(h, sigma)`` come from a sigma estimate on the card, never waits for it.

:func:`nlm_kernel_name` names the kernel of a call: ``nlm_kernel``, built
for (4, 5); ``nlm_cluster_kernel<P, R>``, compiled for patch 1-11, at every
distance the envelope takes, whose shifts the host splits over the CTAs of
a thread-block cluster and their warps (:func:`cluster_plan`,
:func:`split_chunks`); and for patch 12-31 ``nlm_cluster_rt_kernel<R, G>``,
the same split with the patch size read at run time, sliding box sums and a
64-column canvas where its CTA fits (:func:`rt_plan`). The distance goes
as far as :func:`nlm_distance_limit`. A setting outside the envelope raises
before any launch, naming its bound (:func:`check_nlm_envelope`). The
designs these replaced, ``nlm_any_kernel<P>`` (:data:`PREV_DESIGN`, patch
1-11 at distance 1-15) and ``nlm_rt_serial_kernel<R>``
(:data:`RT_PREV_DESIGN`, every other setting), stay reachable through
:func:`launch` alone, so that a caller can time a call's kernel beside the
design it replaced (:func:`prev_design`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pnp_svrg_tpu_torch.ops.cuda import _build

# The settings K3 takes on the card: (least, most) of each; the distance as
# far as nlm_distance_limit(patch_size). ``nlm_kernel`` is built for (4, 5),
# ``nlm_cluster_kernel<P, R>`` for COMPILED's patch sizes (None: any
# distance the envelope takes), ``nlm_cluster_rt_kernel<R, G>`` takes the
# rest.
NLM_ENVELOPE = {"patch_size": (1, 31), "patch_distance": (1, None)}
COMPILED = {"patch_size": (1, 11), "patch_distance": (1, None)}  # nlm_cluster_kernel's
K3_KERNELS = ("nlm_kernel", "nlm_cluster_kernel", "nlm_cluster_rt_kernel")
# The replaced designs, launched only by name: nlm_any_kernel<P> took patch
# 1-11 at distance 1-15 (ANY_DESIGN_MOST) but (4, 5), nlm_rt_serial_kernel<R>
# every other setting.
PREV_DESIGN, RT_PREV_DESIGN = "nlm_any_kernel", "nlm_rt_serial_kernel"
ANY_DESIGN_MOST = (11, 15)
# The cluster kernels' constants in the source: warps a CTA and CTAs a
# cluster at most, the output rows a thread they are built for, and the
# canvas columns a row group of nlm_cluster_rt_kernel; an SM's shared
# memory and a CTA's at most; and the warps an SM a plan aims at.
CLUSTER_MAX_WARPS, MAX_CLUSTER, THREAD_ROWS, RT_CANVAS = 8, 16, (4, 8), (32, 64)
SM_SMEM = 228 * 1024
_MAX_SMEM = 227 * 1024
PLAN_WARPS_PER_SM = 9
# Warps a tile of nlm_cluster_rt_kernel splits its shifts over at least.
RT_TILE_WARPS = 24


def compiled(patch_size: int, patch_distance: int) -> bool:
    """Whether ``nlm_cluster_kernel<P, R>`` is compiled for this setting's
    patch size (it takes any distance the envelope takes)."""
    lo, hi = COMPILED["patch_size"]
    return lo <= patch_size <= hi and patch_distance >= COMPILED["patch_distance"][0]


def nlm_kernel_name(patch_size: int, patch_distance: int) -> str:
    """The K3 kernel that takes a call: ``nlm_kernel`` at (4, 5),
    ``nlm_cluster_kernel`` at every other patch size up to 11, else
    ``nlm_cluster_rt_kernel``."""
    if (patch_size, patch_distance) == (4, 5):
        return K3_KERNELS[0]
    return K3_KERNELS[1] if compiled(patch_size, patch_distance) else K3_KERNELS[2]


def prev_design(patch_size: int, patch_distance: int) -> str | None:
    """The design the kernel of a call replaced, launchable by name
    (:func:`launch`): :data:`PREV_DESIGN` for patch 1-11 at distance 1-15,
    None at (4, 5), else :data:`RT_PREV_DESIGN`."""
    if (patch_size, patch_distance) == (4, 5):
        return None
    most_p, most_d = ANY_DESIGN_MOST
    return PREV_DESIGN if patch_size <= most_p and patch_distance <= most_d else RT_PREV_DESIGN


def thread_rows(patch_distance: int) -> int:
    """Output rows a thread of ``nlm_cluster_kernel``: 4 where a window has
    at most 25 shifts (distance 1-2), else 8 (:func:`cluster_plan`)."""
    return 4 if patch_distance <= 2 else 8


def cluster_smem(patch_size: int, patch_distance: int, warps: int, rows: int) -> int:
    """Dynamic shared memory of a ``nlm_cluster_kernel`` (or
    ``nlm_rt_serial_kernel``) CTA whose threads own ``rows`` output rows:
    the tile and its one-column shift, then each warp's partial wsum and acc
    planes (2 rows x 32 each)."""
    tile = (2 * rows + patch_size - 1 + 2 * patch_distance) * (32 + 2 * patch_distance)
    return 4 * (2 * tile + 2 * warps * 2 * rows * 32)


def rt_smem(patch_size: int, patch_distance: int, warps: int, rows: int, cols: int) -> int:
    """Dynamic shared memory of a ``nlm_cluster_rt_kernel`` CTA whose threads
    own ``rows`` output rows and whose row groups cover ``cols`` canvas
    columns (32: two row groups a warp; 64: one): the tile and its
    one-column shift, whose bytes then take each warp's partial wsum and
    acc planes (the CTA's 64 rows x 32 / cols x cols each), so the larger
    of the two."""
    cta_rows = rows * 64 // cols
    tile = (cta_rows + patch_size - 1 + 2 * patch_distance) * (cols + 2 * patch_distance)
    return 4 * max(2 * tile, 2 * warps * cta_rows * cols)


def kernel_smem(patch_size: int, patch_distance: int, warps: int, rows: int) -> int:
    """Dynamic shared memory of the CTA of the kernel that takes a setting
    (:func:`nlm_kernel_name`; the cluster kernels), on :func:`rt_canvas`'s
    canvas for the run-time-patch kernel."""
    if compiled(patch_size, patch_distance):
        return cluster_smem(patch_size, patch_distance, warps, rows)
    return rt_smem(patch_size, patch_distance, warps, rows, rt_canvas(patch_size, patch_distance))


def rt_canvas(patch_size: int, patch_distance: int) -> int:
    """Canvas columns of ``nlm_cluster_rt_kernel``'s row groups: 64 (2 G, G =
    32 lanes a row) where that CTA fits one CTA's shared memory at 4 warps,
    else 32 (two row groups a warp, a narrower tile that reaches further)."""
    rows = thread_rows(patch_distance)
    return 64 if rt_smem(patch_size, patch_distance, 4, rows, 64) <= _MAX_SMEM else 32


def cluster_plan(b: int, h: int, w: int, patch_size: int, patch_distance: int, sms: int,
                 warps_per_sm: int) -> tuple:
    """(CTAs a cluster, warps a CTA, output rows a thread) of a
    ``nlm_cluster_kernel`` call on a card of ``sms`` SMs that hold
    ``warps_per_sm`` of its warps each.

    From the plans ``examples/k3_variants.py`` times on the H100: 4 rows a
    thread where a window has at most 25 shifts (distance 1-2: the CTA's
    fixed costs, not its shifts, bound it), else 8; 4, 6 or 8 warps a CTA
    (an odd count leaves an SM's four schedulers unevenly loaded); and
    about :data:`PLAN_WARPS_PER_SM` warps an SM over the whole grid (more
    splits a tile's shifts into more partial sums, and the busiest SMs
    then hold more CTAs than the rest), every warp a shift at least, the
    grid resident at once (ceil(CTAs / SMs) CTAs on an SM, in warps and in
    shared memory). Ties go to a lone CTA (no cluster barrier, no reads
    across CTAs), then to 6 warps, then 4, then 8, then the smaller
    cluster. Where no such plan is resident (many images), one CTA of 4
    warps a tile."""
    rows = thread_rows(patch_distance)
    tiles = -(-w // (33 - patch_size)) * -(-h // (2 * rows)) * b
    return split_plan(tiles, patch_size, patch_distance, rows, 32, sms, warps_per_sm) + (rows,)


def rt_plan(b: int, h: int, w: int, patch_size: int, patch_distance: int, sms: int,
            warps_per_sm: int) -> tuple:
    """(CTAs a cluster, warps a CTA, output rows a thread, canvas columns) of
    a ``nlm_cluster_rt_kernel`` call: :func:`rt_canvas`'s canvas, a CTA's
    tile 64 rows x 32 / cols x (cols + 1 - P) output columns, and the split
    of :func:`cluster_plan` with every tile's shifts over
    :data:`RT_TILE_WARPS` warps at least, whether or not the grid is
    resident at once. From the plans ``examples/k3_variants.py`` times on
    the H100 at (13, 21) and (21, 31): 4 CTAs of 6 warps a tile were the
    fastest of 1, 2, 4 and 8 CTAs of 4, 6 and 8 warps at B = 1 and at B =
    9, where no split keeps the grid of 432 tiles resident at once and
    :func:`cluster_plan`'s fallback, 1 CTA of 4 warps a tile, took 37-38 %
    longer; 8 warps a CTA leave an SM one CTA at the kernel's 133
    registers."""
    rows, cols = thread_rows(patch_distance), rt_canvas(patch_size, patch_distance)
    tiles = -(-w // (cols + 1 - patch_size)) * -(-h // (rows * 64 // cols)) * b
    return split_plan(tiles, patch_size, patch_distance, rows, cols, sms, warps_per_sm,
                      least=RT_TILE_WARPS) + (rows, cols)


def split_plan(tiles: int, patch_size: int, patch_distance: int, rows: int, cols: int, sms: int,
               warps_per_sm: int, least: int = 0) -> tuple:
    """(CTAs a cluster, warps a CTA) for ``tiles`` tiles of a cluster kernel:
    :func:`cluster_plan`'s rule, or with ``least`` warps a tile at least
    (as far as the shifts go), any grid that fits (``nlm_cluster_rt_kernel``)."""
    shifts = (2 * patch_distance + 1) ** 2
    want = min(shifts, max(1, least, round(PLAN_WARPS_PER_SM * sms / tiles)))
    best = None
    for order, warps in enumerate((6, 4, 8)):
        for cluster in range(1, MAX_CLUSTER + 1):
            per_sm = -(-tiles * cluster // sms)
            smem = (rt_smem(patch_size, patch_distance, warps, rows, cols) if least
                    else cluster_smem(patch_size, patch_distance, warps, rows))
            resident = per_sm * warps <= warps_per_sm and per_sm * (smem + 1024) <= SM_SMEM
            if cluster * warps > shifts or smem > _MAX_SMEM or not (resident or least):
                continue
            key = (abs(cluster * warps - want), cluster > 1, order, cluster)
            if best is None or key < best[0]:
                best = (key, (cluster, warps))
    return best[1] if best else (1, 4)


def split_chunks(shifts: int, cluster: int, warps: int) -> list:
    """The shifts (dy-major indices) of each (CTA rank, warp) of a cluster,
    rank-major: chunk c takes ``[c S / n, (c + 1) S / n)`` of S shifts, n =
    cluster x warps, as the kernel does. Its partial sums are added in this
    order: each CTA's warps, then the CTAs."""
    n = cluster * warps
    return [(c * shifts // n, (c + 1) * shifts // n) for c in range(n)]


@functools.lru_cache(maxsize=None)
def nlm_distance_limit(patch_size: int) -> int:
    """The largest distance whose CTA fits one CTA's shared memory at 4
    warps, the fallback plan of :func:`split_plan`: the cluster kernel's
    (:func:`cluster_smem`) for patch 1-11, ``nlm_cluster_rt_kernel``'s on
    its 32-column canvas (:func:`rt_smem`) for patch 12-31."""
    def smem(d):
        if compiled(patch_size, d):
            return cluster_smem(patch_size, d, 4, thread_rows(d))
        return rt_smem(patch_size, d, 4, thread_rows(d), 32)

    d = 1
    while smem(d + 1) <= _MAX_SMEM:
        d += 1
    return d


def check_nlm_envelope(patch_size: int, patch_distance: int) -> None:
    """Raise ValueError, naming the bound, unless K3 takes this patch size
    and distance on the card.

    The bounds that stay, and why:

    * patch_size 1-31: at the largest distances only the 32-column canvas
      fits, whose row groups hold whole windows for 33 - P output columns;
      from P = 32 (one column a CTA) another tiling is needed (not built).
    * patch_distance 1 to :func:`nlm_distance_limit` (P): a CTA stages its
      tile twice (the copy shifted by one column) in one CTA's 227 KB
      (232,448 bytes). For patch 1-11 (the cluster kernel) that is (2 R + P
      - 1 + 2 D) rows of 32 + 2 D f32 each, beside 4 warps' partial planes
      (4 x 2 x 2 R x 32 f32): at P = 1, D = 70 takes 231,040 bytes. For
      patch 12-31 (the run-time kernel on its 32-column canvas) the same
      tile, whose bytes then take the partial planes: at P = 21, D = 68
      takes 2 x 172 x 168 x 4 = 231,168 bytes, D = 69 passes it
      (236,640)."""
    lo, hi = NLM_ENVELOPE["patch_size"]
    if not (isinstance(patch_size, int) and lo <= patch_size <= hi):
        raise ValueError(f"K3 takes patch_size {lo}-{hi} (33 - P whole windows a warp's 32 columns), "
                         f"not {patch_size!r}")
    if not isinstance(patch_distance, int) or patch_distance < 1:
        raise ValueError(f"K3 takes patch_distance 1 or more, not {patch_distance!r}")
    most = nlm_distance_limit(patch_size)
    if patch_distance > most:
        raise ValueError(f"K3 takes patch_distance 1-{most} at patch_size {patch_size} (its CTA's "
                         f"{kernel_smem(patch_size, most, 4, thread_rows(most))} bytes of shared memory "
                         f"of {_MAX_SMEM}), not {patch_distance}")


def _lane_values(v, b: int, device: torch.device, name: str) -> torch.Tensor:
    """Scalar or (B,) ``v`` as a contiguous (B,) float32 tensor on ``device``,
    without reading anything back: a Python number is filled there, a tensor
    must already be there (a copy from the host would wait)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((b,), float(v), dtype=torch.float32, device=device)
    if v.device != device:
        raise ValueError(f"{name} on {v.device} but the image on {device}")
    if v.numel() not in (1, b):
        raise ValueError(f"{name} must be a scalar or ({b},), got {tuple(v.shape)}")
    return v.to(torch.float32).reshape(-1).expand(b).contiguous()


def nlm_denoise_plain(
    image: torch.Tensor, h, sigma, patch_size: int = 4, patch_distance: int = 5,
    row_valid_bounds: tuple | None = None,
) -> torch.Tensor:
    """The plain version of K3 on an (H, W) or (B, H, W) image; ``h`` and
    ``sigma`` are scalars or (B,). ``row_valid_bounds=(lo, hi)`` restricts
    the rows that count as in-image candidates (default ``(0, H)``)."""
    x = image.to(torch.float32)
    single = x.dim() == 2
    if single:
        x = x[None]
    b, hh, ww = x.shape
    pr = patch_size // 2
    d = patch_distance
    p = patch_size
    xp = F.pad(x, (pr, pr, pr, pr), mode="reflect")
    h = _lane_values(h, b, x.device, "h")[:, None, None]
    sigma = _lane_values(sigma, b, x.device, "sigma")[:, None, None]
    inv_h2 = 1.0 / (h * h * p * p)
    offset = 2.0 * sigma * sigma * (p * p)
    row_lo, row_hi = (0, hh) if row_valid_bounds is None else row_valid_bounds
    row = torch.arange(hh, device=x.device)[:, None]
    col = torch.arange(ww, device=x.device)[None, :]

    wsum = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            sq = (xp - torch.roll(xp, (-dy, -dx), dims=(-2, -1))) ** 2
            srow = sum(sq[:, k : k + hh, :] for k in range(p))  # window over rows
            dist = sum(srow[:, :, k : k + ww] for k in range(p))  # then columns
            wgt = torch.exp(-torch.clamp_min(dist - offset, 0.0) * inv_h2)
            valid = (
                (row + dy >= row_lo) & (row + dy < row_hi) & (col + dx >= 0) & (col + dx < ww)
            ).to(x.dtype)
            wgt = wgt * valid
            wsum = wsum + wgt
            acc = acc + wgt * torch.roll(x, (-dy, -dx), dims=(-2, -1))
    out = acc / torch.clamp_min(wsum, 1e-12)
    return out[0] if single else out


ENTRIES = {  # kernel name -> (its entry point in the source, its C argument types)
    K3_KERNELS[0]: ("nlm_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
    K3_KERNELS[1]: ("nlm_cluster_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
    K3_KERNELS[2]: ("nlm_cluster_rt_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    RT_PREV_DESIGN: ("nlm_rt_serial_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
    "limits": ("nlm_cluster_limits", [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2),
}
ENTRIES[PREV_DESIGN] = ENTRIES[K3_KERNELS[0]]  # nlm_launch runs nlm_any_kernel<P> off (4, 5)
# The cluster kernels' plans (launch's ``plan``), and the kernel index
# nlm_cluster_limits asks their occupancy by.
PLANNED = {K3_KERNELS[1]: 0, K3_KERNELS[2]: 1, RT_PREV_DESIGN: 2}


def bind(lib: ctypes.CDLL) -> dict:
    """Kernel name -> its entry point in a library built from
    ``csrc/nlm.cu``, with its argument types set (and ``"limits"``, the
    cluster kernel's occupancy query)."""
    fns = {}
    for name, (entry, argtypes) in ENTRIES.items():
        fn = fns[name] = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return fns


def _lib() -> dict:
    """:func:`bind` of the built library."""
    return bind(_build.load("nlm"))


_LIMITS: dict = {}


def device_plan(fns: dict, device: torch.device, b: int, h: int, w: int, patch_size: int,
                patch_distance: int, kernel: str | None = None) -> tuple:
    """The plan of ``kernel`` (the call's, :func:`nlm_kernel_name`, by
    default) on ``device``: :func:`rt_plan` for ``nlm_cluster_rt_kernel``,
    else :func:`cluster_plan`, from the device's SMs and the kernel's warps an
    SM (asked once a device and instantiation: the kernel, patch size, rows
    a thread and form, which is the canvas of ``nlm_cluster_rt_kernel`` and
    whether ``nlm_cluster_kernel``'s tile passes 64 columns)."""
    kernel = kernel or nlm_kernel_name(patch_size, patch_distance)
    rows = thread_rows(patch_distance)
    rt = kernel == K3_KERNELS[2]
    form = rt_canvas(patch_size, patch_distance) if rt else int(32 + 2 * patch_distance > 64)
    asked = (PLANNED[kernel], patch_size if kernel == K3_KERNELS[1] else 0, rows, form)
    key = (device.index, *asked, id(fns["limits"]))
    if key not in _LIMITS:
        sms, wps = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(fns["limits"](*asked, ctypes.byref(sms), ctypes.byref(wps)),
                         f"nlm_cluster_limits {asked}")
        _LIMITS[key] = (sms.value, wps.value)
    plan = rt_plan if rt else cluster_plan
    return plan(b, h, w, patch_size, patch_distance, *_LIMITS[key])


def launch(kernel: str, fns: dict, x: torch.Tensor, hs: torch.Tensor, ss: torch.Tensor,
           out: torch.Tensor, patch_size: int, patch_distance: int, lo: int, hi: int,
           plan: tuple | None = None) -> None:
    """Launch ``kernel`` through its entry in ``fns`` (:func:`bind`) on the
    current stream: ``x`` and ``out`` (B, H, W) contiguous, ``hs`` and
    ``ss`` (B,), candidate rows ``[lo, hi)``; the cluster kernels on
    ``plan``, :func:`device_plan`'s by default: (cluster, warps, rows),
    and for ``nlm_cluster_rt_kernel`` its canvas columns as well. It checks
    nothing else and counts nothing (:func:`nlm_denoise` does both).
    :data:`PREV_DESIGN` takes patch 1-11 at distance 1-15 but (4, 5), where
    the entry runs ``nlm_kernel``."""
    b, hh, ww = x.shape
    if kernel == PREV_DESIGN and (patch_size, patch_distance) == (4, 5):
        raise ValueError(f"{PREV_DESIGN} does not take (4, 5)")
    args = [x.data_ptr(), hs.data_ptr(), ss.data_ptr(), out.data_ptr(), b, hh, ww, patch_size,
            patch_distance, lo, hi]
    if kernel in PLANNED:
        args += list(plan or device_plan(fns, x.device, b, hh, ww, patch_size, patch_distance, kernel))
    err = fns[kernel](*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"nlm ({kernel}, patch_size={patch_size}, patch_distance={patch_distance})")


def nlm_denoise(
    image: torch.Tensor, h, sigma, patch_size: int = 4, patch_distance: int = 5,
    row_valid_bounds: tuple | None = None,
) -> torch.Tensor:
    """NLM of an (H, W) or (B, H, W) float32 image with per-lane ``h`` and
    ``sigma`` (scalars or (B,) tensors on the image's device).

    A CPU tensor takes the plain version; a CUDA tensor launches the K3
    kernel :func:`nlm_kernel_name` names, which takes :data:`NLM_ENVELOPE`
    and integer row bounds ``0 <= lo <= hi <= H``, and raises outside them.
    Each call counts one in ``nlm_denoise.launches`` and one in
    ``nlm_denoise.by_kernel`` under the kernel's name."""
    if image.dim() not in (2, 3):
        raise ValueError(f"expected an (H, W) or (B, H, W) image, got {tuple(image.shape)}")
    if image.device.type == "cpu":
        return nlm_denoise_plain(image, h, sigma, patch_size, patch_distance, row_valid_bounds)
    if image.device.type != "cuda":
        raise ValueError(f"nlm_denoise runs on cpu or cuda, not {image.device}")
    if image.dtype != torch.float32:
        raise ValueError(f"expected float32, got {image.dtype}")
    check_nlm_envelope(patch_size, patch_distance)
    single = image.dim() == 2
    x = (image[None] if single else image).contiguous()
    b, hh, ww = x.shape
    if min(hh, ww) <= patch_size // 2:
        raise ValueError(f"image {hh}x{ww} too small to reflect-pad by {patch_size // 2}")
    lo, hi = (0, hh) if row_valid_bounds is None else row_valid_bounds
    if not (isinstance(lo, int) and isinstance(hi, int) and 0 <= lo <= hi <= hh):
        raise ValueError(f"row_valid_bounds must be ints with 0 <= lo <= hi <= {hh}, "
                         f"got {row_valid_bounds!r}")
    hs = _lane_values(h, b, x.device, "h")
    ss = _lane_values(sigma, b, x.device, "sigma")
    out = torch.empty_like(x)
    kernel = nlm_kernel_name(patch_size, patch_distance)
    launch(kernel, _lib(), x, hs, ss, out, patch_size, patch_distance, lo, hi)
    nlm_denoise.launches += 1
    nlm_denoise.by_kernel[kernel] += 1
    return out[0] if single else out


nlm_denoise.launches = 0
nlm_denoise.by_kernel = dict.fromkeys(K3_KERNELS, 0)
