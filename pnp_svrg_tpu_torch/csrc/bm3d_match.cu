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
// 128x128, 31x31 reference blocks, 289 offsets) the direct form does ~0.7
// GFLOP (sub, mul, add per patch term) and the separable form below about a
// third of that, while the call moves under 2 MB, so the CUDA cores and
// shared memory, not HBM, set the floor.
//
// Design: one CTA of kWarps warps per (image, kTileR x kTileC tile of
// reference blocks), in two phases.
//  1. Distances. The tile's image region plus a halo of `search` pixels is
//     staged once in shared memory (zero outside the image, row pitch odd).
//     Offsets are strided across warps, kInFlight at a time (independent
//     chains the warp interleaves). For one offset a warp forms the
//     separable SSD, the form the Pallas kernel uses, over the tile's
//     reference rows: each lane takes 4-wide horizontal sums of squared
//     differences at the tile's distinct half-block column positions (its
//     reference pixels stay in registers across offsets), into a per-warp
//     scratch; then lane (i, j) adds, over the 8 rows of reference row i,
//     the two half sums that make reference column j's 8-wide sum. Adjacent
//     reference blocks overlap by half a block in each direction, so each
//     squared difference of the tile's reference rows is formed once per
//     offset (a host-made column plan also covers a last reference column
//     off the step grid). bf16 rounding is applied to each term before any
//     sum, as `sq_term` says. The results, or +inf for invalid candidates,
//     go to a D[tile refs][offsets] buffer in shared memory.
//  2. Selection. Each warp takes two reference blocks at a time, holds their
//     distances in registers (lane l: offsets l + 32 m) and runs K rounds of
//     a warp-wide argmin over (distance, offset index), compared
//     lexicographically: two warp reductions (`redux.sync`: the least
//     distance, then the least index holding it) find each block's winner,
//     its owning lane drops it, and every lane recomputes its own minimum by
//     a compare tree, without a branch. That reproduces
//     `top_k_offsets_plain` exactly: ascending, ties to the lowest index, and
//     index 0 once only +inf is left.
// 4 x 8 tiles give the headline 416 CTAs of 4 warps, all resident at once
// (50 KB of shared memory each at 289 offsets, 4 a SM). What is left is
// instruction count and latency at 12-16 warps a SM: the bf16 rounding
// instructions of the bf16 modes, the halo rows of each tile and the 16
// dependent rounds of phase 2 (shared-memory bandwidth is not the limit:
// loading a candidate row once for two adjacent offsets made it slower).
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

constexpr int kBlock = 8;  // the patch edge and group size this file is built for
constexpr int kK = 16;
constexpr int kTileR = 4;  // reference-block rows per CTA
constexpr int kTileC = 8;  // reference-block columns per CTA (kTileR * kTileC == 32)
constexpr int kWarps = 4;
constexpr int kInFlight = 2;  // offsets a warp works on at once
constexpr int kRefRows = 20;  // largest reference-row span of a tile + kBlock (step <= 4)
constexpr int kHalf = kBlock / 2;  // a row's horizontal sum is two sums of kHalf terms
constexpr int kMaxCols = kTileC + 2;  // half-block positions of a column tile, at most
constexpr int kPlan = 1 + kMaxCols + 2 * kTileC;  // ints of one column tile's plan
constexpr int kItems = kRefRows * kMaxCols;  // half sums a warp forms per offset, at most
constexpr int kItemPasses = (kItems + 31) / 32;

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

// The least of v[LO..HI) and its slot, the first on ties, by a tree of
// compares (a short dependency chain).
template <int LO, int HI, int PER>
__device__ __forceinline__ void best_of(const float (&v)[PER], float& d, int& m) {
  if constexpr (HI - LO == 1) {
    d = v[LO];
    m = LO;
  } else {
    constexpr int MID = (LO + HI) / 2;
    float d0, d1;
    int m0, m1;
    best_of<LO, MID>(v, d0, m0);
    best_of<MID, HI>(v, d1, m1);
    const bool right = d1 < d0;
    d = right ? d1 : d0;
    m = right ? m1 : m0;
  }
}

// Phase 2 for two reference blocks at once (their rounds are independent,
// so one warp overlaps their latencies): K rounds of a warp argmin over
// (distance, offset index). Lane l holds offsets l + 32 m in registers. A
// null `out` drops that block's result (a tile with an odd count).
template <int PER>
__device__ __forceinline__ void select_top_k(const float* dt0, const float* dt1, int S, int lane,
                                             int* out0, int* out1) {
  const float inf = __int_as_float(0x7f800000);
  float v[2][PER];
  float bd[2];
  int bm[2];
  int mine[2] = {0, 0};
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const bool in = lane + 32 * m < S;
    v[0][m] = in ? dt0[lane + 32 * m] : inf;
    v[1][m] = in ? dt1[lane + 32 * m] : inf;
  }
  best_of<0, PER>(v[0], bd[0], bm[0]);
  best_of<0, PER>(v[1], bd[1], bm[1]);
#pragma unroll 1
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      // Distances are >= 0 or +inf, so their bits order as their values:
      // two warp reductions find the least distance, then its least index.
      const unsigned key = __float_as_uint(bd[q]);
      const unsigned least = __reduce_min_sync(0xffffffffu, key);
      const unsigned idx = (unsigned)(lane + 32 * bm[q]);
      const int ws = (int)__reduce_min_sync(0xffffffffu, key == least ? idx : 0xffffffffu);
      if (lane == k) mine[q] = ws;
      // The owner drops the winner; every lane recomputes its best, without
      // a branch, so the two blocks' rounds stay interleaved.
      const bool own = (ws & 31) == lane;
      const int wm = ws >> 5;
#pragma unroll
      for (int m = 0; m < PER; ++m) v[q][m] = (own && m == wm) ? inf : v[q][m];
      best_of<0, PER>(v[q], bd[q], bm[q]);
    }
  }
  if (lane < kK) {
    if (out0) out0[lane] = mine[0];
    if (out1) out1[lane] = mine[1];
  }
}

template <int MODE, int PER>
__global__ void __launch_bounds__(kWarps * 32, 4)
bm3d_match_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                  const int* __restrict__ cols, const int* __restrict__ offsets,
                  const int* __restrict__ col_plan, int* __restrict__ out, int H, int W,
                  int nR, int nC, int S, int search, int smem_h, int smem_w, int pitch,
                  int d_pitch) {
  extern __shared__ float smem[];
  float* region = smem;                            // smem_h x pitch
  float* dist = region + smem_h * pitch;           // 32 x d_pitch
  float* hsum = dist + kTileR * kTileC * d_pitch;  // kWarps x kInFlight x kItems
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileR;
  const int c0 = blockIdx.x * kTileC;
  const int nr = min(kTileR, nR - r0);
  const int nc = min(kTileC, nC - c0);
  const int base_r = rows[r0] - search;
  const int base_c = cols[c0] - search;
  const float* x = img + (size_t)b * H * W;
  const int tid = threadIdx.x;
  for (int q = tid; q < smem_h * smem_w; q += kWarps * 32) {
    const int yy = base_r + q / smem_w;
    const int xx = base_c + q % smem_w;
    float v = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? x[yy * W + xx] : 0.f;
    if (MODE == 1) v = round_bf16(v);
    region[(q / smem_w) * pitch + q % smem_w] = v;
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float inf = __int_as_float(0x7f800000);

  // Phase 1. The column plan lists the tile's distinct half-block column
  // positions (nb of them, region coordinates) and, for reference column j,
  // the two positions (a_j, b_j) whose half sums make its 8-wide sum.
  // Item it = y * nb + m is the half sum on region row y (from the tile's
  // first reference row) at position m; item p * 32 + lane belongs to the
  // lane, which keeps its reference pixels in registers across offsets.
  const int* plan = col_plan + blockIdx.x * kPlan;
  const int nb = plan[0];
  const int ref_rows = rows[r0 + nr - 1] - rows[r0] + kBlock;  // <= kRefRows (host-checked)
  const int items = ref_rows * nb;
  float ref[kItemPasses][kHalf];
  int addr[kItemPasses];
#pragma unroll
  for (int p = 0; p < kItemPasses; ++p) {
    const int it = min(p * 32 + lane, items - 1);
    const int y = it / nb;
    addr[p] = (search + y) * pitch + plan[1 + it - y * nb];
#pragma unroll
    for (int kx = 0; kx < kHalf; ++kx) ref[p][kx] = region[addr[p] + kx];
  }
  // Lane (i, j) owns reference block (r0 + i, c0 + j) in the vertical sums.
  const int i = lane / kTileC;
  const int j = lane % kTileC;
  const bool owner = i < nr && j < nc;
  const int ry = rows[r0 + min(i, nr - 1)];
  const int rx = cols[c0 + min(j, nc - 1)];
  const int row0 = (ry - rows[r0]) * nb;
  const int qa = plan[1 + kMaxCols + 2 * j];
  const int qb = plan[2 + kMaxCols + 2 * j];
  float* hs = hsum + warp * kInFlight * kItems;
  const int last_r = H - kBlock;
  const int last_c = W - kBlock;
  const int2* offs2 = reinterpret_cast<const int2*>(offsets);
  for (int s0 = warp; s0 < S; s0 += kInFlight * kWarps) {
    int2 o[kInFlight];
    int shift[kInFlight];
#pragma unroll
    for (int f = 0; f < kInFlight; ++f) {
      o[f] = __ldg(offs2 + min(s0 + f * kWarps, S - 1));
      shift[f] = o[f].x * pitch + o[f].y;
    }
#pragma unroll
    for (int p = 0; p < kItemPasses; ++p) {
      if (p * 32 < items && p * 32 + lane < items) {
        float h[kInFlight];
#pragma unroll
        for (int f = 0; f < kInFlight; ++f) {
          const float* cand = region + addr[p] + shift[f];
          h[f] = 0.f;
#pragma unroll
          for (int kx = 0; kx < kHalf; ++kx) h[f] = __fadd_rn(h[f], sq_term<MODE>(ref[p][kx], cand[kx]));
        }
#pragma unroll
        for (int f = 0; f < kInFlight; ++f) hs[f * kItems + p * 32 + lane] = h[f];
      }
    }
    __syncwarp();
    if (owner) {
#pragma unroll
      for (int f = 0; f < kInFlight; ++f) {
        const float* q = hs + f * kItems + row0;
        float d = 0.f;
#pragma unroll
        for (int ky = 0; ky < kBlock; ++ky) d = __fadd_rn(d, __fadd_rn(q[ky * nb + qa], q[ky * nb + qb]));
        const int cy = ry + o[f].x;
        const int cx = rx + o[f].y;
        const bool valid = cy >= 0 && cy <= last_r && cx >= 0 && cx <= last_c;
        if (s0 + f * kWarps < S) dist[lane * d_pitch + s0 + f * kWarps] = valid ? d : inf;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // Phase 2: each warp takes two reference blocks at a time.
  constexpr int kRefs = kTileR * kTileC;
  for (int t0 = 2 * warp; t0 < kRefs; t0 += 2 * kWarps) {
    int* out_t[2];
    const float* dt[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = t0 + q;
      const bool in = t / kTileC < nr && t % kTileC < nc;
      out_t[q] = in ? out + (((size_t)b * nR + r0 + t / kTileC) * nC + c0 + t % kTileC) * kK
                    : nullptr;
      dt[q] = dist + (in ? t : t0) * d_pitch;
    }
    if (out_t[0] || out_t[1]) select_top_k<PER>(dt[0], dt[1], S, lane, out_t[0], out_t[1]);
  }
}

template <int MODE, int PER>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const float* img,
                   const int* rows, const int* cols, const int* offsets, const int* col_plan,
                   int* out, int H, int W, int nR, int nC, int S, int search, int smem_h,
                   int smem_w, int pitch, int d_pitch) {
  auto fn = bm3d_match_kernel<MODE, PER>;
  static size_t granted = 48 * 1024;  // dynamic shared memory opted into so far
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  fn<<<grid, kWarps * 32, smem, stream>>>(img, rows, cols, offsets, col_plan, out, H, W, nR,
                                          nC, S, search, smem_h, smem_w, pitch, d_pitch);
  return cudaGetLastError();
}

// Offsets held per lane in phase 2 (S <= 32 * PER): the smallest that fits.
template <int MODE>
cudaError_t launch_mode(int S, dim3 grid, size_t smem, cudaStream_t st, const float* img,
                        const int* rows, const int* cols, const int* offsets,
                        const int* col_plan, int* out, int H, int W, int nR, int nC,
                        int search, int smem_h, int smem_w, int pitch, int d_pitch) {
#define PNP_LAUNCH(PER)                                                                  \
  if (S <= 32 * PER)                                                                    \
    return launch<MODE, PER>(grid, smem, st, img, rows, cols, offsets, col_plan, out, H, \
                             W, nR, nC, S, search, smem_h, smem_w, pitch, d_pitch);
  PNP_LAUNCH(1)
  PNP_LAUNCH(3)
  PNP_LAUNCH(10)
  PNP_LAUNCH(20)
#undef PNP_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Top-K offset indices for every reference block. `img` (B, H, W) f32,
// `rows` (nR,) / `cols` (nC,) int32 reference coordinates, `offsets` (S, 2)
// int32 (dy, dx) with |dy|, |dx| <= search, `col_plan` (ceil(nC / 8), kPlan)
// int32 column plans, `out` (B, nR, nC, K) int32. smem_h x smem_w is the
// largest tile region, stored with row pitch `pitch` (odd, >= smem_w), and
// `d_pitch` (odd, >= S) the distance buffer's row pitch (host-computed;
// every tile's reference rows span at most kRefRows pixels, S <= 640).
// Returns the launch's cudaError_t (0 on success).
extern "C" int bm3d_match_launch(const float* img, const int* rows, const int* cols,
                                 const int* offsets, const int* col_plan, int* out, int B,
                                 int H, int W, int nR, int nC, int S, int block_size, int K,
                                 int mode, int search, int smem_h, int smem_w, int pitch,
                                 int d_pitch, void* stream) {
  if (block_size != kBlock || K != kK || pitch < smem_w || d_pitch < S || S < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((nC + kTileC - 1) / kTileC, (nR + kTileR - 1) / kTileR, B);
  const size_t smem = sizeof(float) * ((size_t)smem_h * pitch + (size_t)kTileR * kTileC * d_pitch +
                                       (size_t)kWarps * kInFlight * kItems);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_mode<0>(S, grid, smem, st, img, rows, cols, offsets, col_plan, out, H, W,
                            nR, nC, search, smem_h, smem_w, pitch, d_pitch);
    case 1:
      return launch_mode<1>(S, grid, smem, st, img, rows, cols, offsets, col_plan, out, H, W,
                            nR, nC, search, smem_h, smem_w, pitch, d_pitch);
    case 2:
      return launch_mode<2>(S, grid, smem, st, img, rows, cols, offsets, col_plan, out, H, W,
                            nR, nC, search, smem_h, smem_w, pitch, d_pitch);
    default:
      return cudaErrorInvalidValue;
  }
}
