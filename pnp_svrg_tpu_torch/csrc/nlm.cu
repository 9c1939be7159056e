// Non-local means (skimage slow mode, uniform patch weights), per-lane (h, sigma).
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
// PR = P / 2; for the even P = 4 the window covers image rows i-2 .. i+1.
// The formula is evaluated unguarded in that order (h = 0 gives NaN, as in
// JAX), both maxima propagate NaN as jnp.maximum does, and the weight uses
// expf, not __expf: the port holds this kernel to its plain version at 1e-5.
//
// Bound on the H100: the exponentials and the arithmetic, about equal. At
// the shapes of the CSMRI + NLM lanes (9 or 1 lanes of 128 x 128) one call
// does 121 exps and about 17 f32 operations (counted separably) per pixel
// and moves only the image in and out once.
//
// Design (simple, right first): one CTA of 32 x 4 threads per (lane, 4-row x
// 32-column output tile), one thread per output pixel. The tile and its halo
// (D + PR = 7 rows/columns before, D + P - 1 - PR = 6 after) are loaded once
// into shared memory, the reflect padding done by index reflection at the
// load; addresses past the canvas are clamped, since only candidates whose
// weight is zeroed read them. Each thread keeps its own P x P patch in
// registers and reads each candidate patch from shared memory (a warp reads
// 32 neighbouring columns of one row: no bank conflicts). h and sigma are
// read through device pointers, so the host never waits for them.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 4;

__device__ __forceinline__ int reflect_index(int r, int n, int pad) {
  r = r < -pad ? -pad : (r > n - 1 + pad ? n - 1 + pad : r);  // clamp to the canvas
  if (r < 0) r = -r;
  if (r >= n) r = 2 * (n - 1) - r;
  return r;
}

// max(v, lo) that keeps a NaN, as jnp.maximum does (fmaxf would drop it).
__device__ __forceinline__ float max_keep_nan(float v, float lo) {
  return v < lo ? lo : v;
}

template <int P, int D>
__global__ void __launch_bounds__(kTileW * kTileH)
nlm_kernel(const float* __restrict__ x, const float* __restrict__ hs,
           const float* __restrict__ ss, float* __restrict__ out, int H, int W,
           int lo, int hi) {
  constexpr int PR = P / 2;
  constexpr int BEFORE = D + PR;
  constexpr int AFTER = D + P - 1 - PR;
  constexpr int SH = kTileH + BEFORE + AFTER;
  constexpr int SW = kTileW + BEFORE + AFTER;
  __shared__ float tile[SH][SW];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const float* img = x + (long long)b * H * W;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int e = tid; e < SH * SW; e += kTileW * kTileH) {
    const int a = e / SW, c = e % SW;
    const int r = reflect_index(i0 - BEFORE + a, H, PR);
    const int q = reflect_index(j0 - BEFORE + c, W, PR);
    tile[a][c] = __ldg(img + (long long)r * W + q);
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= H || j >= W) return;

  const float hv = __ldg(hs + b);
  const float sv = __ldg(ss + b);
  const float inv_h2 = 1.0f / (hv * hv * P * P);
  const float offset = 2.0f * sv * sv * (P * P);

  // Tile coordinates of this pixel's window origin.
  const int oy = ty + BEFORE - PR;
  const int ox = tx + BEFORE - PR;
  float own[P][P];
#pragma unroll
  for (int u = 0; u < P; ++u)
#pragma unroll
    for (int v = 0; v < P; ++v) own[u][v] = tile[oy + u][ox + v];

  float wsum = 0.0f, acc = 0.0f;
  for (int dy = -D; dy <= D; ++dy) {
    const bool row_ok = i + dy >= lo && i + dy < hi;
#pragma unroll
    for (int dx = -D; dx <= D; ++dx) {
      const float valid = (row_ok && j + dx >= 0 && j + dx < W) ? 1.0f : 0.0f;
      const float* cand = &tile[oy + dy][ox + dx];
      float dist = 0.0f;
#pragma unroll
      for (int v = 0; v < P; ++v) {  // rows summed first, then columns, as JAX
        float col = 0.0f;
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const float e = own[u][v] - cand[u * SW + v];
          col += e * e;
        }
        dist += col;
      }
      const float w = expf(-max_keep_nan(dist - offset, 0.0f) * inv_h2) * valid;
      wsum += w;
      acc += w * cand[PR * SW + PR];
    }
  }
  out[(long long)b * H * W + (long long)i * W + j] = acc / max_keep_nan(wsum, 1e-12f);
}

}  // namespace

// `x` (B, H, W) f32, `h` and `sigma` (B,) f32 on the device, `out` (B, H, W)
// f32. Built for patch_size 4 and patch_distance 5; rows [lo, hi) count as
// in-image candidates (0 <= lo <= hi <= H). Returns the launch's cudaError_t.
extern "C" int nlm_launch(const float* x, const float* h, const float* sigma,
                          float* out, int B, int H, int W, int patch_size,
                          int patch_distance, int lo, int hi, void* stream) {
  if (patch_size != 4 || patch_distance != 5) return cudaErrorInvalidValue;
  if (H <= patch_size / 2 || W <= patch_size / 2) return cudaErrorInvalidValue;
  if (lo < 0 || hi > H || lo > hi || B > 65535) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  nlm_kernel<4, 5><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, h, sigma, out, H, W, lo, hi);
  return cudaGetLastError();
}
