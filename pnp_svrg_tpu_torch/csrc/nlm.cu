// K3: non-local means (skimage slow mode, uniform patch weights), per-lane
// (h, sigma), built for patch size P = 4 and patch distance D = 5.
//
// Replaces the Pallas kernel `_nlm_kernel` / `nlm_denoise_pallas` in
// pnp_svrg_tpu/ops/pallas/nlm_kernel.py, and computes the function of
// `nlm_denoise` in pnp_svrg_tpu/denoisers/nlm.py: for every pixel (i, j) and
// every shift (dy, dx) in [-D, D]^2, visited dy-major then dx,
//
//   dist = sum over the P x P window of the reflect-padded canvas at (i, j)
//          of (canvas[i + u, j + v] - canvas[i + dy + u, j + dx + v])^2
//   w    = exp(-max(dist - 2 sigma^2 P^2, 0) * (1 / (h^2 P^2)))
//   w   *= [lo <= i + dy < hi and 0 <= j + dx < W]
//   wsum += w;  acc += w * x[i + dy, j + dx]
//
// and out = acc / max(wsum, 1e-12). The canvas is the image reflect-padded by
// the patch radius P / 2, done here by index reflection at the load; for the even P = 4
// the window covers image rows i-2 .. i+1 (and columns j-2 .. j+1). Rows
// [lo, hi) and columns [0, W) count as in-image candidates. h and sigma are
// read through device pointers, so the host never waits for them. The
// formula is evaluated unguarded: both maxima keep a NaN as jnp.maximum does
// (`max.NaN`), so h = 0 gives NaN everywhere (the self-shift's -0 * inf), as
// in JAX.
//
// Bound on the H100: about 17 f32 operations a (pixel, shift) pair counted
// separably (square 2, box sums 6, weight 5, accumulation 4) at 67 TFLOP/s,
// and one exponential a pair at the MUFU rate (16 a clock on each of 132
// SMs); at the CSMRI + NLM lanes' shapes (1 or 9 lanes of 128 x 128, 121
// shifts) the two terms are about equal, and the image moves in and out once.
// This design's shift loop is about 190 SASS instructions a (warp, shift),
// over 20 a useful pair, so it runs at several times that bound, bounded by
// instruction issue.
//
// Design, against the three costs of the first (one thread per pixel, ~45
// instructions a pair, 4 warps an SM at B = 1):
// 1. Separable patch sums, shared within a shift. A warp covers 32 canvas
//    columns and a strip of kRows = 8 output rows; lane L owns column
//    c = j0 - 2 + L. For each shift it forms the kRows + 3 squared
//    differences of its column once (its own pixels stay in registers across
//    shifts; the candidates come from a shared tile, a warp reading 32
//    neighbouring words of one row), the vertical 4-sums as pair sums
//    (s0 + s1) + (s2 + s3), then the horizontal 4-sum the same way from its
//    neighbours' vertical sums, by two `__shfl_*_sync`: rows summed first,
//    then columns, as in JAX. Lanes 2 .. 30 own a whole window, so a warp
//    writes kOutCols = 29 output columns.
// 2. More warps when B is small. The 121 shifts are split into contiguous
//    dy-major chunks, one per warp of the CTA (kMaxWarps at most); each warp
//    keeps partial (wsum, acc) for its pixels, and the partials are summed
//    in shared memory in warp order, so a result is the same from run to run
//    (for a given shape and card, which fix the warp count). The launch
//    gives a CTA as many warps as keep the whole grid resident at once, from
//    the kernel's registers: 16 at B = 1 (80 CTAs), 4 at B = 9 (720 CTAs) on
//    the H100 at 79 registers. Dynamic shared memory a CTA is the tile and
//    the partials: 4 * (kTileRows * kTileCols + 2 * warps * kRows * 32) B.
// 3. The mask costs no multiply: a candidate outside the image gets a bias
//    of -inf in the exponent's FFMA (exp2(m * k + bias)), which gives 0, or
//    NaN where m * k is NaN, exactly as the plain version's w * 0 does.
//    The weight is exp2 of the argument scaled by log2(e), by
//    `ex2.approx.ftz` (one MUFU instruction, ~2 ulp; results below 2^-126
//    flush to 0, weights far below the self-shift's 1).
//
// Tolerance: the shifts' sums are taken in chunks, the patch sums as pair
// sums, and the weight through exp2 with a folded log2(e), so the kernel is
// not bitwise the plain version; it is held to it at 1e-5 max abs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kP = 4, kD = 5;             // patch size and distance
constexpr int kPR = kP / 2;               // reflect padding
constexpr int kSpan = 2 * kD + 1;         // shifts a row
constexpr int kShifts = kSpan * kSpan;    // 121
constexpr int kRows = 8;                  // output rows a thread owns
constexpr int kWin = kRows + kP - 1;      // canvas rows a thread's windows cover
constexpr int kOutCols = 32 - kP + 1;     // output columns a warp writes (lanes 2..30)
constexpr int kTileRows = kWin + 2 * kD;  // 21
constexpr int kTileCols = 32 + 2 * kD;    // 42
constexpr int kMaxWarps = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int reflect_index(int r, int n, int pad) {
  r = r < -pad ? -pad : (r > n - 1 + pad ? n - 1 + pad : r);  // clamp to the canvas
  if (r < 0) r = -r;
  if (r >= n) r = 2 * (n - 1) - r;
  return r;
}

// max(a, b) that returns NaN if either is NaN, as jnp.maximum does.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One CTA per (lane b, strip of kRows rows from i0, kOutCols columns from
// j0), one warp per chunk of shifts. Dynamic shared memory: the tile, then
// each warp's partial wsum and acc planes.
__global__ void __launch_bounds__(kMaxWarps * 32)
nlm_kernel(const float* __restrict__ x, const float* __restrict__ hs,
           const float* __restrict__ ss, float* __restrict__ out, int H, int W,
           int lo, int hi) {
  extern __shared__ float smem[];
  float(*tile)[kTileCols] = reinterpret_cast<float(*)[kTileCols]>(smem);
  float* part_w = smem + kTileRows * kTileCols;  // [warps][kRows][32]
  const int nwarps = blockDim.x >> 5;
  float* part_a = part_w + nwarps * kRows * 32;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kOutCols;
  const float* img = x + (long long)b * H * W;
  // Tile row t holds image row i0 - kPR - kD + t, column u image column
  // j0 - kPR - kD + u (reflected; clamped past the canvas, where only
  // candidates whose weight is zeroed read).
  for (int e = threadIdx.x; e < kTileRows * kTileCols; e += blockDim.x) {
    const int t = e / kTileCols, u = e % kTileCols;
    const int r = reflect_index(i0 - kPR - kD + t, H, kPR);
    const int q = reflect_index(j0 - kPR - kD + u, W, kPR);
    tile[t][u] = __ldg(img + (long long)r * W + q);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = j0 - kPR + lane;  // this lane's canvas column (output column for lanes 2..30)
  const float hv = __ldg(hs + b), sv = __ldg(ss + b);
  const float inv_h2 = 1.0f / (hv * hv * kP * kP);
  const float offset = 2.0f * sv * sv * (kP * kP);
  const float k = -(inv_h2 * kLog2e);

  float own[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r) own[r] = tile[r + kD][lane + kD];

  float wsum[kRows], acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) wsum[r] = acc[r] = 0.0f;

  // This warp's shifts [q0, q1), in dy-major order.
  const int q0 = warp * kShifts / nwarps, q1 = (warp + 1) * kShifts / nwarps;
  int dy = q0 / kSpan - kD, dx = q0 % kSpan - kD;
  float brow[kRows];  // 0, or -inf where row i0 + r + dy is not a candidate row
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ii = i0 + r + dy;
    brow[r] = (ii >= lo && ii < hi) ? 0.0f : -CUDART_INF_F;
  }
  for (int q = q0; q < q1; ++q) {
    const float bcol = (c + dx >= 0 && c + dx < W) ? 0.0f : -CUDART_INF_F;
    const float* cand = &tile[dy + kD][lane + dx + kD];
    float cv[kWin], pair[kWin - 1];
#pragma unroll
    for (int r = 0; r < kWin; ++r) cv[r] = cand[r * kTileCols];
    float prev = own[0] - cv[0];
    prev *= prev;
#pragma unroll
    for (int r = 0; r + 1 < kWin; ++r) {  // vertical pair sums of the squares
      float e = own[r + 1] - cv[r + 1];
      e *= e;
      pair[r] = prev + e;
      prev = e;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float col = pair[r] + pair[r + 2];                     // rows i-2 .. i+1
      const float hp = col + __shfl_down_sync(0xffffffffu, col, 1);  // columns c, c+1
      const float dist = __shfl_up_sync(0xffffffffu, hp, 2) + hp;    // columns c-2 .. c+1
      const float m = max_keep_nan(dist - offset, 0.0f);
      const float w = exp2_approx(fmaf(m, k, brow[r] + bcol));
      wsum[r] += w;
      acc[r] = fmaf(w, cv[r + kPR], acc[r]);
    }
    if (++dx > kD) {
      dx = -kD;
      ++dy;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int ii = i0 + r + dy;
        brow[r] = (ii >= lo && ii < hi) ? 0.0f : -CUDART_INF_F;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    part_w[(warp * kRows + r) * 32 + lane] = wsum[r];
    part_a[(warp * kRows + r) * 32 + lane] = acc[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * 32; e += blockDim.x) {
    const int r = e >> 5, l = e & 31;
    const int i = i0 + r, j = j0 - kPR + l;
    if (l < kPR || l >= 32 - (kP - 1 - kPR) || i >= H || j >= W) continue;
    float ws = part_w[e], ac = part_a[e];
    for (int s = 1; s < nwarps; ++s) {  // fixed order: the same result every run
      ws += part_w[s * kRows * 32 + e];
      ac += part_a[s * kRows * 32 + e];
    }
    out[(long long)b * H * W + (long long)i * W + j] = ac / max_keep_nan(ws, 1e-12f);
  }
}

// The device's SM count and how many warps of nlm_kernel one SM holds at
// once (registers, and the thread limit); 0 if the query fails.
struct Device {
  int sms = 0, warps_per_sm = 0;
};

Device query_limits(int dev) {
  Device d;
  int regs = 0, threads = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&regs, cudaDevAttrMaxRegistersPerMultiprocessor, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, nlm_kernel) != cudaSuccess)
    return Device{};
  const int regs_per_warp = 32 * ((attr.numRegs + 7) / 8 * 8);  // allocated 8 a thread at a time
  d.warps_per_sm = threads / 32 < regs / regs_per_warp ? threads / 32 : regs / regs_per_warp;
  return d;
}

// query_limits of the current device, asked once a device.
Device device_limits() {
  constexpr int kCached = 64;
  static Device cache[kCached];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return Device{};
  if (dev >= kCached) return query_limits(dev);
  if (cache[dev].sms == 0) cache[dev] = query_limits(dev);
  return cache[dev];
}

// The warps a CTA: as many as keep every CTA of the grid resident at once
// (the busiest SM holds ceil(CTAs / SMs) of them), at most kMaxWarps.
int plan_warps(long long ctas, const Device& d) {
  const long long per_sm = (ctas + d.sms - 1) / d.sms;
  const long long warps = d.warps_per_sm / per_sm;
  return warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : static_cast<int>(warps));
}

}  // namespace

// `x` (B, H, W) f32, `h` and `sigma` (B,) f32 on the device, `out` (B, H, W)
// f32. Built for patch_size 4 and patch_distance 5; rows [lo, hi) count as
// in-image candidates (0 <= lo <= hi <= H). Returns the launch's cudaError_t.
extern "C" int nlm_launch(const float* x, const float* h, const float* sigma,
                          float* out, int B, int H, int W, int patch_size,
                          int patch_distance, int lo, int hi, void* stream) {
  if (patch_size != kP || patch_distance != kD) return cudaErrorInvalidValue;
  if (H <= kPR || W <= kPR) return cudaErrorInvalidValue;
  if (lo < 0 || hi > H || lo > hi || B > 65535) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const Device d = device_limits();
  if (d.sms <= 0 || d.warps_per_sm <= 0) return cudaErrorInvalidDevice;
  const dim3 grid((W + kOutCols - 1) / kOutCols, (H + kRows - 1) / kRows, B);
  const int warps = plan_warps((long long)grid.x * grid.y * grid.z, d);
  const size_t smem = sizeof(float) * (kTileRows * kTileCols + 2 * warps * kRows * 32);
  nlm_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, h, sigma, out, H, W, lo, hi);
  return cudaGetLastError();
}
