// BM3D block matching: patch SSD over a search window + exact top-K.
//
// Replaces the Pallas kernel `_match_kernel` / `bm3d_match_pallas` in
// pnp_svrg_tpu/ops/pallas/bm3d_match.py, and computes the same function as
// the XLA matcher (`_match_distances` + `_top_k_offsets` in
// pnp_svrg_tpu/denoisers/bm3d.py).
//
// For every image b, reference block (r, c) on the reference grid and search
// offset s (ascending index order): the sum over the block x block patch of
// the squared difference between the reference patch and the candidate patch
// at (rows[r] + dy_s, cols[c] + dx_s). A candidate that leaves the image is
// +inf. The K smallest are kept, ascending, ties to the lowest offset index;
// when fewer than K candidates are valid the spare slots hold index 0, which
// is what both JAX matchers return.
//
// Bound on the H100: f32 arithmetic. At the headline shape (13 images of
// 128x128, 31x31 reference blocks, 289 offsets) one call does ~0.7 GFLOP
// (sub, mul, add per patch term) and moves under 2 MB, so the CUDA cores and
// not HBM set the floor.
//
// Design: one thread per reference block, one CTA per (image, 8x8 tile of
// reference blocks). The tile's image region plus a halo of `search` pixels
// on each side is staged once in shared memory (zero outside the image); the
// reference patch sits in registers; each thread walks the offsets in
// ascending order, computes the SSD from shared memory and keeps a sorted
// top-K (distance, index) in registers with strict-< insertion, so a tie
// keeps the earlier offset. Invalid candidates are skipped: +inf never
// enters the list. This first version leaves SMs idle (only ~12.5k threads at
// the headline); splitting the offsets of one reference block across threads
// with a merge is the next step.
//
// Rounding modes (mode argument), matching the two JAX matchers:
//   0  f32:         no rounding.
//   1  bf16_xla:    the image is rounded to bf16 first; the difference and
//                   the square are each rounded to bf16; the sum is f32.
//   2  bf16_pallas: difference and square in f32, the square rounded to
//                   bf16; the sum is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileR = 8;
constexpr int kTileC = 8;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE>
__device__ __forceinline__ float sq_term(float a, float b) {
  if (MODE == 1) {
    const float d = round_bf16(__fsub_rn(a, b));
    return round_bf16(__fmul_rn(d, d));
  } else if (MODE == 2) {
    const float d = __fsub_rn(a, b);
    return round_bf16(__fmul_rn(d, d));
  } else {
    const float d = __fsub_rn(a, b);
    return __fmul_rn(d, d);
  }
}

template <int BLOCK, int K, int MODE>
__global__ void __launch_bounds__(kTileR * kTileC)
bm3d_match_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                  const int* __restrict__ cols, const int* __restrict__ offsets,
                  int* __restrict__ out, int H, int W, int nR, int nC, int S,
                  int search, int smem_h, int smem_w) {
  extern __shared__ float tile[];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileR;
  const int c0 = blockIdx.x * kTileC;
  const int base_r = rows[r0] - search;
  const int base_c = cols[c0] - search;
  const float* x = img + (size_t)b * H * W;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < smem_h * smem_w; i += nthreads) {
    const int yy = base_r + i / smem_w;
    const int xx = base_c + i % smem_w;
    float v = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? x[yy * W + xx] : 0.f;
    if (MODE == 1) v = round_bf16(v);
    tile[i] = v;
  }
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if (r >= nR || c >= nC) return;
  const int ry = rows[r];
  const int rx = cols[c];
  const int ly = ry - base_r;
  const int lx = rx - base_c;

  float ref[BLOCK * BLOCK];
#pragma unroll
  for (int ky = 0; ky < BLOCK; ++ky)
#pragma unroll
    for (int kx = 0; kx < BLOCK; ++kx)
      ref[ky * BLOCK + kx] = tile[(ly + ky) * smem_w + lx + kx];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bd[k] = __int_as_float(0x7f800000);  // +inf
    bi[k] = 0;
  }

  const int last_r = H - BLOCK;
  const int last_c = W - BLOCK;
  for (int s = 0; s < S; ++s) {
    const int dy = __ldg(offsets + 2 * s);
    const int dx = __ldg(offsets + 2 * s + 1);
    const int cy = ry + dy;
    const int cx = rx + dx;
    if (cy < 0 || cy > last_r || cx < 0 || cx > last_c) continue;
    const float* p = tile + (ly + dy) * smem_w + (lx + dx);
    float d = 0.f;
#pragma unroll
    for (int ky = 0; ky < BLOCK; ++ky)
#pragma unroll
      for (int kx = 0; kx < BLOCK; ++kx)
        d = __fadd_rn(d, sq_term<MODE>(ref[ky * BLOCK + kx], p[ky * smem_w + kx]));
    if (!(d < bd[K - 1])) continue;
    // Sorted insertion, all slots updated from the old list: a slot keeps its
    // entry if it is <= d, takes d if its predecessor is <= d, else shifts.
#pragma unroll
    for (int k = K - 1; k > 0; --k) {
      if (bd[k] > d) {
        const bool shift = bd[k - 1] > d;
        bd[k] = shift ? bd[k - 1] : d;
        bi[k] = shift ? bi[k - 1] : s;
      }
    }
    if (bd[0] > d) {
      bd[0] = d;
      bi[0] = s;
    }
  }

  int* o = out + (((size_t)b * nR + r) * nC + c) * K;
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = bi[k];
}

constexpr int kBlock = 8;  // the patch edge and group size this file is built for
constexpr int kK = 16;

template <int MODE>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   const float* img, const int* rows, const int* cols,
                   const int* offsets, int* out, int H, int W, int nR, int nC,
                   int S, int search, int smem_h, int smem_w) {
  auto fn = bm3d_match_kernel<kBlock, kK, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fn<<<grid, block, smem, stream>>>(img, rows, cols, offsets, out, H, W, nR,
                                    nC, S, search, smem_h, smem_w);
  return cudaGetLastError();
}

}  // namespace

// Top-K offset indices for every reference block. `img` (B, H, W) f32,
// `rows` (nR,) / `cols` (nC,) int32 reference coordinates, `offsets` (S, 2)
// int32 (dy, dx) with |dy|, |dx| <= search, `out` (B, nR, nC, K) int32.
// smem_h x smem_w is the largest tile region (host-computed). Returns the
// launch's cudaError_t (0 on success).
extern "C" int bm3d_match_launch(const float* img, const int* rows,
                                 const int* cols, const int* offsets, int* out,
                                 int B, int H, int W, int nR, int nC, int S,
                                 int block_size, int K, int mode, int search,
                                 int smem_h, int smem_w, void* stream) {
  if (block_size != kBlock || K != kK) return cudaErrorInvalidValue;
  const dim3 grid((nC + kTileC - 1) / kTileC, (nR + kTileR - 1) / kTileR, B);
  const dim3 block(kTileC, kTileR);
  const size_t smem = (size_t)smem_h * smem_w * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch<0>(grid, block, smem, st, img, rows, cols, offsets, out, H,
                       W, nR, nC, S, search, smem_h, smem_w);
    case 1:
      return launch<1>(grid, block, smem, st, img, rows, cols, offsets, out, H,
                       W, nR, nC, S, search, smem_h, smem_w);
    case 2:
      return launch<2>(grid, block, smem, st, img, rows, cols, offsets, out, H,
                       W, nR, nC, S, search, smem_h, smem_w);
    default:
      return cudaErrorInvalidValue;
  }
}
