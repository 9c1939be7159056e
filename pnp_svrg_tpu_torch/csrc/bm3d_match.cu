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
// at (rows[r] + dy_s, cols[c] + dx_s). A candidate that leaves the image, or
// whose top row lies outside [cand_lo, cand_hi], is +inf: the row-sharded
// spatial path passes the rows of its halo-extended block that are image
// rows (`row_valid_bounds` of `_match_distances`, bm3d.py:213-219); the
// default (0, H - block) is the image itself. The K smallest are kept, ascending, ties to the lowest offset index;
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
                  int d_pitch, int cand_lo, int cand_hi) {
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
        const bool valid = cy >= cand_lo && cy <= cand_hi && cx >= 0 && cx <= last_c;
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
                   int smem_w, int pitch, int d_pitch, int cand_lo, int cand_hi) {
  auto fn = bm3d_match_kernel<MODE, PER>;
  static size_t granted = 48 * 1024;  // dynamic shared memory opted into so far
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  fn<<<grid, kWarps * 32, smem, stream>>>(img, rows, cols, offsets, col_plan, out, H, W, nR,
                                          nC, S, search, smem_h, smem_w, pitch, d_pitch,
                                          cand_lo, cand_hi);
  return cudaGetLastError();
}

// Offsets held per lane in phase 2 (S <= 32 * PER): the smallest that fits.
template <int MODE>
cudaError_t launch_mode(int S, dim3 grid, size_t smem, cudaStream_t st, const float* img,
                        const int* rows, const int* cols, const int* offsets,
                        const int* col_plan, int* out, int H, int W, int nR, int nC,
                        int search, int smem_h, int smem_w, int pitch, int d_pitch,
                        int cand_lo, int cand_hi) {
#define PNP_LAUNCH(PER)                                                                  \
  if (S <= 32 * PER)                                                                    \
    return launch<MODE, PER>(grid, smem, st, img, rows, cols, offsets, col_plan, out, H, \
                             W, nR, nC, S, search, smem_h, smem_w, pitch, d_pitch, cand_lo, \
                             cand_hi);
  PNP_LAUNCH(1)
  PNP_LAUNCH(3)
  PNP_LAUNCH(10)
  PNP_LAUNCH(20)
#undef PNP_LAUNCH
  return cudaErrorInvalidValue;
}

// ---- Any block, k, grid and window: `bm3d_match_any_kernel` -------------
//
// The kernel above is built for 8 x 8 blocks, 16 matches, a reference grid
// whose half-block column positions fit its column plan (step 4) and at
// most 640 offsets. This one takes any block in [kMinBlock, kMaxBlock], any
// k up to kMaxK, any reference grid and any window (the wrapper bounds
// them), and computes the same function. One CTA of kAnyWarps warps per
// (image, kAnyTileR x kAnyTileC tile of reference blocks) stages the
// tile's region plus a halo of `search` pixels in shared memory, as above;
// then each warp takes one reference block at a time and walks the offsets
// in ascending chunks of 32 x PER, lane l holding offsets l + 32 m:
//  1. Distances in the direct form: the block x block terms in row-major
//     order, each rounded as `sq_term` says, summed one after another
//     (f32 adds, no FMA); each reference pixel is read once (a broadcast)
//     for the lane's PER candidates.
//  2. Merge. The warp keeps a running top-k of (distance, offset index)
//     pairs, entry e in lane e % 32, slot e / 32 (two slots a lane: k <= 64).
//     For each chunk, k rounds of a warp-wide lexicographic argmin over the
//     running entries and the chunk's (two `redux.sync`, as above) rebuild
//     it; the winner's holder drops it. The chunks come in ascending index
//     order and the running entries are the k least of all earlier offsets,
//     so the list after the last chunk is the k least of all, ascending,
//     ties to the lowest index: `top_k_offsets_plain`, with an entry still
//     at +inf written as index 0 (the plain version's fill).
// Nothing grows with the window but the number of chunks: 2,401 offsets
// need no more shared memory or registers than 49. BLOCK = 8 is compiled
// with the block a constant (the reference profile's 16 and 32 matches run
// there); BLOCK = 0 reads it at run time. Bound as above: f32 arithmetic,
// here block^2 x (sub, mul, add) a valid (reference block, offset) pair.

constexpr int kAnyTileR = 4, kAnyTileC = 4;  // reference blocks a CTA
constexpr int kAnyWarps = 4;
constexpr int kMinBlock = 2, kMaxBlock = 16, kMaxK = 64;  // the any-kernel's
constexpr unsigned kInfBits = 0x7f800000u;

// (bk, bi) becomes (k, i) where (k, i) is lexicographically less.
__device__ __forceinline__ void lex_min(unsigned& bk, int& bi, unsigned k, int i) {
  const bool take = k < bk || (k == bk && i < bi);
  bk = take ? k : bk;
  bi = take ? i : bi;
}

template <int MODE, int PER, int BLOCK>
__global__ void __launch_bounds__(kAnyWarps * 32)
bm3d_match_any_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                      const int* __restrict__ cols, const int* __restrict__ offsets,
                      int* __restrict__ out, int H, int W, int nR, int nC, int S, int K,
                      int block_rt, int search, int pitch, int cand_lo, int cand_hi) {
  extern __shared__ float region[];  // region rows x pitch
  const int block = BLOCK > 0 ? BLOCK : block_rt;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kAnyTileR;
  const int c0 = blockIdx.x * kAnyTileC;
  const int nr = min(kAnyTileR, nR - r0);
  const int nc = min(kAnyTileC, nC - c0);
  const int base_r = rows[r0] - search;
  const int base_c = cols[c0] - search;
  const int reg_h = rows[r0 + nr - 1] - rows[r0] + block + 2 * search;
  const int reg_w = cols[c0 + nc - 1] - cols[c0] + block + 2 * search;
  const float* x = img + (size_t)b * H * W;
  for (int q = threadIdx.x; q < reg_h * reg_w; q += kAnyWarps * 32) {
    const int yy = base_r + q / reg_w;
    const int xx = base_c + q % reg_w;
    float v = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? x[yy * W + xx] : 0.f;
    if (MODE == 1) v = round_bf16(v);
    region[(q / reg_w) * pitch + q % reg_w] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int last_c = W - block;
  const int2* offs2 = reinterpret_cast<const int2*>(offsets);
  for (int t = warp; t < nr * nc; t += kAnyWarps) {
    const int ry = rows[r0 + t / nc];
    const int rx = cols[c0 + t % nc];
    const int ref_at = (ry - base_r) * pitch + rx - base_c;
    unsigned tk[2] = {kInfBits, kInfBits};  // the running top-k: (distance bits, index)
    int ti[2] = {0x7fffffff, 0x7fffffff};
    for (int s0 = 0; s0 < S; s0 += 32 * PER) {
      float d[PER];
      int at[PER];
      bool ok[PER];
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int s = s0 + lane + 32 * m;
        const int2 o = __ldg(offs2 + min(s, S - 1));
        const int cy = ry + o.x;
        const int cx = rx + o.y;
        ok[m] = s < S && cy >= cand_lo && cy <= cand_hi && cx >= 0 && cx <= last_c;
        at[m] = ref_at + o.x * pitch + o.y;
        d[m] = 0.f;
      }
#pragma unroll
      for (int ky = 0; ky < block; ++ky) {
#pragma unroll
        for (int kx = 0; kx < block; ++kx) {
          const int off = ky * pitch + kx;
          const float r = region[ref_at + off];
#pragma unroll
          for (int m = 0; m < PER; ++m) d[m] = __fadd_rn(d[m], sq_term<MODE>(r, region[at[m] + off]));
        }
      }
      unsigned key[PER];
#pragma unroll
      for (int m = 0; m < PER; ++m) key[m] = ok[m] ? __float_as_uint(d[m]) : kInfBits;
      // Distances are >= 0 or +inf, so their bits order as their values.
      unsigned nk[2] = {kInfBits, kInfBits};
      int ni[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll 1
      for (int e = 0; e < K; ++e) {
        unsigned bk = tk[0];
        int bi = ti[0];
        lex_min(bk, bi, tk[1], ti[1]);
#pragma unroll
        for (int m = 0; m < PER; ++m) lex_min(bk, bi, key[m], s0 + lane + 32 * m);
        const unsigned least = __reduce_min_sync(0xffffffffu, bk);
        const int win = (int)__reduce_min_sync(0xffffffffu, bk == least ? (unsigned)bi : 0xffffffffu);
        if (lane == (e & 31)) {  // entry e: slot 0 for e < 32, else slot 1
          nk[0] = e < 32 ? least : nk[0];
          ni[0] = e < 32 ? win : ni[0];
          nk[1] = e < 32 ? nk[1] : least;
          ni[1] = e < 32 ? ni[1] : win;
        }
        // The holder drops the winner (an entry already at +inf may be
        // picked again; it is written as index 0 all the same).
#pragma unroll
        for (int q = 0; q < 2; ++q) tk[q] = ti[q] == win ? kInfBits : tk[q];
#pragma unroll
        for (int m = 0; m < PER; ++m) key[m] = s0 + lane + 32 * m == win ? kInfBits : key[m];
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        tk[q] = nk[q];
        ti[q] = ni[q];
      }
    }
    int* o = out + (((size_t)b * nR + r0 + t / nc) * nC + c0 + t % nc) * K;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (lane + 32 * q < K) o[lane + 32 * q] = tk[q] == kInfBits ? 0 : ti[q];
    }
  }
}

template <int MODE, int PER, int BLOCK>
cudaError_t launch_any(dim3 grid, size_t smem, cudaStream_t stream, const float* img,
                       const int* rows, const int* cols, const int* offsets, int* out, int H,
                       int W, int nR, int nC, int S, int K, int block, int search, int pitch,
                       int cand_lo, int cand_hi) {
  auto fn = bm3d_match_any_kernel<MODE, PER, BLOCK>;
  static size_t granted = 48 * 1024;  // dynamic shared memory opted into so far
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  fn<<<grid, kAnyWarps * 32, smem, stream>>>(img, rows, cols, offsets, out, H, W, nR, nC, S, K,
                                             block, search, pitch, cand_lo, cand_hi);
  return cudaGetLastError();
}

// PER = 2 (64 offsets a chunk) for small windows, else 8 (256); the block
// a constant at 8.
template <int MODE>
cudaError_t launch_any_mode(int S, int block, dim3 grid, size_t smem, cudaStream_t st,
                            const float* img, const int* rows, const int* cols,
                            const int* offsets, int* out, int H, int W, int nR, int nC, int K,
                            int search, int pitch, int cand_lo, int cand_hi) {
#define PNP_LAUNCH_ANY(PER, BLOCK)                                                          \
  return launch_any<MODE, PER, BLOCK>(grid, smem, st, img, rows, cols, offsets, out, H, W, nR, \
                                      nC, S, K, block, search, pitch, cand_lo, cand_hi);
  if (S <= 64) {
    if (block == 8) PNP_LAUNCH_ANY(2, 8)
    PNP_LAUNCH_ANY(2, 0)
  }
  if (block == 8) PNP_LAUNCH_ANY(8, 8)
  PNP_LAUNCH_ANY(8, 0)
#undef PNP_LAUNCH_ANY
}

// ---- Block 8 at any reference step: `bm3d_match_tile_kernel` -------------
//
// The first kernel's column plan needs a step-4 grid, its distance buffer
// holds at most 640 offsets and it keeps 16 matches; the any-kernel sums
// every distance directly, block^2 terms a (reference block, offset) pair,
// and rebuilds its top-k by k rounds a chunk. This kernel takes block 8 at
// any strictly ascending reference grid (at any step: past the block a tile
// holds fewer blocks), any window whose region fits shared memory and any
// power-of-two k up to 128 (one, two or four slots a lane), and computes the
// same function in the separable form. A window wider than the image visits
// only the offsets some block can take (|dy| <= H - 8, |dx| <= W - 8: the
// host's reach), and stages only their halo; each keeps its index in the
// full window, so the result is the whole window's. One CTA of kTileWarps warps per (image, tile). A tile is up to
// kTileMax reference blocks (9 x 9 at step 3) whose patches span at most
// kTileSpan rows and columns; host-made plans give each tile's first row
// and column index, its counts and a mask of its reference rows (columns)
// as bits of the span. The tile's span plus a halo of `search` pixels is
// staged in shared memory. The offsets go in chunks of kChunk, each in two
// phases.
//  1. Distances. A warp takes one offset at a time. Lane y holds row y of
//     the span's reference pixels in registers and forms that row's
//     kTileSpan terms against the shifted candidate row, each once,
//     rounded as `sq_term` says. Mode 1 stages the region as bf16 pairs in
//     two alignments, so a pair of candidate columns is one aligned word,
//     and forms its terms two at a time (`sub.rn.bf16x2`, `mul.rn.bf16x2`
//     round as `round_bf16` of the f32 result does, since rounding through
//     f32 is exact for bf16 operands: 24 >= 2 x 8 + 2 bits). A doubling
//     tree gives the 8-wide sum at every column position (pairs, fours,
//     eights: three adds a position); at each reference column (a bit of
//     the tile's column mask, the same for the whole warp) three
//     `shfl.down` steps add the 8 rows below each lane by the same tree, so
//     the lane of each reference row holds its block's distance, a binary
//     tree over its 64 terms (f32 adds, no FMA). That lane writes it, or
//     +inf for an invalid candidate, to D[tile blocks][chunk] in shared
//     memory.
//  2. Selection. A warp takes one block at a time and merges the chunk into
//     the block's running top-k, kept in shared memory between chunks as
//     (distance bits, offset index) pairs compared lexicographically, entry
//     e in lane e % 32, slot e / 32. A ballot finds the chunk's candidates
//     below the k-th entry. If more than k are (as in the first chunk), k
//     rounds of the warp argmin above rebuild the list; else each is
//     inserted in turn after the entries below it, the later entries moving
//     down one place (`shfl`). The offsets are visited in a host-made
//     order, nearest the window's centre first: near offsets tend to match
//     best, so the k-th entry falls early and fewer later candidates get
//     in; the comparisons use each offset's own index, so the result is
//     `top_k_offsets_plain`'s whatever the order: ascending, ties to the
//     lowest index, an entry still at +inf written as index 0.
// The choices were timed on an H100 at the reference profile's shapes
// against variants of this source (`examples/k1_variants.py`): 4 warps a
// CTA, chunks of 32 or 128 offsets, two CTAs an SM (more registers) and
// mode 1's region staged as f32 were each slower at k 16 or k 32, and so
// was visiting the offsets in ascending order (PERF.md). Bound as above: f32 arithmetic (one term a
// pixel and offset, the box sums shared by a tile's blocks); PERF.md gives
// its time beside that bound.

constexpr int kTileSpan = 32;  // rows (one a lane) and columns a tile's patches span, at most
constexpr int kTileCols = kTileSpan - kBlock + 1;  // column positions of an 8-wide sum in the span
constexpr int kTileMax = 81;  // reference blocks a tile, at most
constexpr int kTileWarps = 8;
constexpr int kChunk = 64;  // offsets a chunk
constexpr int kDPitch = kChunk + 1;  // the distance buffer's row pitch (odd)
constexpr unsigned kAllLanes = 0xffffffffu;
// The tile and span kernels: k up to four slots a lane, and blocks up to the
// span (the span kernel's blocks 1 and 17-32 through its run-time phase 1).
constexpr int kSpanMaxK = 128;
constexpr int kSpanMinBlock = 1, kSpanMaxBlock = kTileSpan;

// Two f32 values rounded to bf16 (to nearest even), packed: a low, b high.
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

__device__ __forceinline__ unsigned sub_bf16x2(unsigned a, unsigned b) {
  unsigned r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// `sq_term` of two (reference, candidate) pairs at once: in mode 1 both
// pairs packed bf16 (`r`, `c`; their values are bf16 already), else f32.
template <int MODE>
__device__ __forceinline__ void sq_terms2(unsigned r, unsigned c, float r0, float r1, float c0,
                                          float c1, float& t0, float& t1) {
  unsigned q;
  if (MODE == 0) {
    t0 = sq_term<0>(r0, c0);
    t1 = sq_term<0>(r1, c1);
    return;
  } else if (MODE == 1) {
    const unsigned d = sub_bf16x2(r, c);
    q = mul_bf16x2(d, d);
  } else {
    const float d0 = __fsub_rn(r0, c0), d1 = __fsub_rn(r1, c1);
    q = pack_bf16x2(__fmul_rn(d0, d0), __fmul_rn(d1, d1));
  }
  t0 = __uint_as_float(q << 16);
  t1 = __uint_as_float(q & 0xffff0000u);
}

// The lanes' sum of v over the 8 lanes from each (lane l: lanes l to l + 7;
// lanes past 24 read their own value past lane 31), as a binary tree.
__device__ __forceinline__ float sum8_down(float v) {
  v = __fadd_rn(v, __shfl_down_sync(kAllLanes, v, 1));
  v = __fadd_rn(v, __shfl_down_sync(kAllLanes, v, 2));
  return __fadd_rn(v, __shfl_down_sync(kAllLanes, v, 4));
}

// Entry `slot` of a lane's KS slots (slot < KS).
template <int KS, typename T>
__device__ __forceinline__ T slot_of(const T (&v)[KS], int slot) {
  if constexpr (KS <= 2) {
    return KS == 1 || slot == 0 ? v[0] : v[KS - 1];
  } else {
    T r = v[0];
#pragma unroll
    for (int q = 1; q < KS; ++q) r = slot == q ? v[q] : r;
    return r;
  }
}

// Stages a tile's region for the tile and span kernels: the image `x`
// (H x W) from (ry0 - search, rx0 - search), reg_n rows and columns, 0
// outside the image. Modes 0 and 2 as f32, reg_n x pitch. Mode 1 as bf16
// pairs, twice: pairs[a][row][p] (row pitch pp words) holds columns 2p + a
// and 2p + a + 1, so any two adjacent columns are one aligned word.
template <int MODE>
__device__ __forceinline__ void stage_span_region(const float* x, int H, int W, int ry0, int rx0,
                                                  int search, int reg_n, int pitch, int pp,
                                                  float* region, unsigned* pairs) {
  auto pixel = [&](int yy, int xx) {  // the image, 0 outside it
    return yy >= 0 && yy < H && xx >= 0 && xx < W ? x[yy * W + xx] : 0.f;
  };
  if (MODE == 1) {
    const int half = reg_n / 2;
    for (int q = threadIdx.x; q < reg_n * half; q += kTileWarps * 32) {
      const int r = q / half, p2 = q % half;
      const int yy = ry0 - search + r, xx = rx0 - search + 2 * p2;
      const float v0 = pixel(yy, xx), v1 = pixel(yy, xx + 1);
      const float v2 = 2 * p2 + 2 < reg_n ? pixel(yy, xx + 2) : 0.f;
      pairs[r * pp + p2] = pack_bf16x2(v0, v1);  // round_bf16 of each
      pairs[(reg_n + r) * pp + p2] = pack_bf16x2(v1, v2);
    }
  } else {
    for (int q = threadIdx.x; q < reg_n * reg_n; q += kTileWarps * 32)
      region[(q / reg_n) * pitch + q % reg_n] = pixel(ry0 - search + q / reg_n, rx0 - search + q % reg_n);
  }
}

// Phase 2 of the tile kernel (and of the span kernel at k 32 and 64): each
// warp merges a chunk of distances, D[tile blocks][chunk] in `dist`, into
// its blocks' running top-k (`list_k` / `list_i`, [block][entry]) and, at
// the last chunk, writes the result to `out`. Entries and candidates
// compare lexicographically on (distance bits, offset index): distances are
// >= 0 or +inf, so their bits order as they do, and an invalid candidate
// (+inf) never enters past the ballot. Lane l holds the offset indices of
// the chunk's candidates l + 32 m. A ballot finds the chunk's candidates
// below the k-th entry. If more than k are (as in the first chunk), k
// rounds of a warp argmin rebuild the list; else each is inserted in turn
// after the entries below it, the later entries moving down one place.
template <int KS>
__device__ __forceinline__ void merge_chunk_warps(const float* dist, unsigned* list_k, int* list_i,
                                                  const int* __restrict__ order, int s0, int n_chunk,
                                                  int S, int K, int nt, int nc, bool last, int* out,
                                                  int b, int nR, int nC, int r0, int c0, int lane,
                                                  int warp) {
  const int kq = (K - 1) >> 5, kl = (K - 1) & 31;  // the k-th entry's slot and lane
  constexpr int PER = kChunk / 32;
  int cs[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int c = lane + 32 * m;
    cs[m] = c < n_chunk ? __ldg(order + s0 + c) : S + c;  // past the chunk: an index no offset has
  }
  for (int tb = warp; tb < nt; tb += kTileWarps) {
    unsigned lk[KS];
    int li[KS];
#pragma unroll
    for (int q2 = 0; q2 < KS; ++q2) {
      const int e = lane + 32 * q2;
      lk[q2] = e < K ? list_k[tb * K + e] : kInfBits;
      li[q2] = e < K ? list_i[tb * K + e] : 0x7fffffff;
    }
    unsigned ck[PER], below[PER];
    int n_below = 0;
    const unsigned kth_k = __shfl_sync(kAllLanes, slot_of<KS>(lk, kq), kl);
    const int kth_i = __shfl_sync(kAllLanes, slot_of<KS>(li, kq), kl);
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int c = lane + 32 * m;
      ck[m] = c < n_chunk ? __float_as_uint(dist[tb * kDPitch + c]) : kInfBits;
      below[m] = __ballot_sync(kAllLanes, ck[m] != kInfBits &&
                                              (ck[m] < kth_k || (ck[m] == kth_k && cs[m] < kth_i)));
      n_below += __popc(below[m]);
    }
    if (n_below > K) {
      // k rounds of a warp-wide lexicographic argmin over the entries and
      // the chunk rebuild the list.
      unsigned nk[KS];
      int ni[KS];
#pragma unroll
      for (int q2 = 0; q2 < KS; ++q2) {
        nk[q2] = kInfBits;
        ni[q2] = 0x7fffffff;
      }
#pragma unroll 1
      for (int e = 0; e < K; ++e) {
        unsigned bk = lk[0];
        int bi = li[0];
#pragma unroll
        for (int q2 = 1; q2 < KS; ++q2) lex_min(bk, bi, lk[q2], li[q2]);
#pragma unroll
        for (int m = 0; m < PER; ++m) lex_min(bk, bi, ck[m], cs[m]);
        const unsigned least = __reduce_min_sync(kAllLanes, bk);
        const int win = (int)__reduce_min_sync(kAllLanes, bk == least ? (unsigned)bi : kAllLanes);
        if (lane == (e & 31)) {
#pragma unroll
          for (int q2 = 0; q2 < KS; ++q2) {
            nk[q2] = (e >> 5) == q2 ? least : nk[q2];
            ni[q2] = (e >> 5) == q2 ? win : ni[q2];
          }
        }
#pragma unroll
        for (int q2 = 0; q2 < KS; ++q2) lk[q2] = li[q2] == win ? kInfBits : lk[q2];
#pragma unroll
        for (int m = 0; m < PER; ++m) ck[m] = cs[m] == win ? kInfBits : ck[m];
      }
#pragma unroll
      for (int q2 = 0; q2 < KS; ++q2) {
        lk[q2] = nk[q2];
        li[q2] = ni[q2];
      }
    } else {
      // Insert each candidate after the entries below it, the later
      // entries moving down one place; one that no longer falls among
      // the first k (the k-th entry fell since the ballot) is dropped.
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        unsigned bits = below[m];
        while (bits) {
          const int src = __ffs(bits) - 1;
          bits &= bits - 1;
          const unsigned d = __shfl_sync(kAllLanes, ck[m], src);
          const int s = __shfl_sync(kAllLanes, cs[m], src);
          int pos = 0;
#pragma unroll
          for (int q2 = 0; q2 < KS; ++q2)
            pos += __popc(__ballot_sync(kAllLanes, lane + 32 * q2 < K &&
                                                       (lk[q2] < d || (lk[q2] == d && li[q2] < s))));
          if (pos >= K) continue;
          unsigned uk[KS];
          int ui[KS];
#pragma unroll
          for (int q2 = 0; q2 < KS; ++q2) {
            uk[q2] = __shfl_sync(kAllLanes, lk[q2], (lane + 31) & 31);
            ui[q2] = __shfl_sync(kAllLanes, li[q2], (lane + 31) & 31);
          }
#pragma unroll
          for (int q2 = 0; q2 < KS; ++q2) {
            const int e = lane + 32 * q2;
            // Entry e - 1 is the previous lane's, or the previous slot's last lane's.
            const unsigned pk = q2 > 0 && lane == 0 ? uk[q2 - 1] : uk[q2];
            const int pi = q2 > 0 && lane == 0 ? ui[q2 - 1] : ui[q2];
            lk[q2] = e >= K ? kInfBits : e > pos ? pk : e == pos ? d : lk[q2];
            li[q2] = e >= K ? 0x7fffffff : e > pos ? pi : e == pos ? s : li[q2];
          }
        }
      }
    }
    if (last) {
      const int bi = tb / nc, bj = tb - bi * nc;
      int* o = out + (((size_t)b * nR + r0 + bi) * nC + c0 + bj) * K;
#pragma unroll
      for (int q2 = 0; q2 < KS; ++q2) {
        if (lane + 32 * q2 < K) o[lane + 32 * q2] = lk[q2] == kInfBits ? 0 : li[q2];
      }
    } else if (n_below > 0) {
#pragma unroll
      for (int q2 = 0; q2 < KS; ++q2) {
        const int e = lane + 32 * q2;
        if (e < K) {
          list_k[tb * K + e] = lk[q2];
          list_i[tb * K + e] = li[q2];
        }
      }
    }
  }
}

template <int MODE, int KS>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
bm3d_match_tile_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                       const int* __restrict__ cols, const int* __restrict__ offsets,
                       const int* __restrict__ order, const int* __restrict__ row_tiles,
                       const int* __restrict__ col_tiles,
                       int* __restrict__ out, int H, int W, int nR, int nC, int S, int K,
                       int search, int pitch, int cand_lo, int cand_hi) {
  extern __shared__ float smem[];
  const int reg_n = kTileSpan + 2 * search;  // the staged region's rows and columns (even)
  // The region as `stage_span_region` lays it out: f32 (modes 0, 2) or bf16 pairs (mode 1).
  float* region = smem;
  unsigned* pairs = reinterpret_cast<unsigned*>(smem);
  const int pp = (reg_n / 2) | 1;               // the pairs' row pitch in words (odd)
  float* dist = smem + reg_n * (pitch + 1);     // kTileMax x kDPitch, past either layout
  unsigned* list_k = reinterpret_cast<unsigned*>(dist + kTileMax * kDPitch);  // [block][entry]
  int* list_i = reinterpret_cast<int*>(list_k + kTileMax * K);
  const int r0 = row_tiles[3 * blockIdx.y], nr = row_tiles[3 * blockIdx.y + 1];
  const unsigned rmask = (unsigned)row_tiles[3 * blockIdx.y + 2];
  const int c0 = col_tiles[3 * blockIdx.x], nc = col_tiles[3 * blockIdx.x + 1];
  const unsigned cmask = (unsigned)col_tiles[3 * blockIdx.x + 2];
  const int b = blockIdx.z;
  const int ry0 = rows[r0], rx0 = cols[c0];
  stage_span_region<MODE>(img + (size_t)b * H * W, H, W, ry0, rx0, search, reg_n, pitch, pp, region,
                          pairs);
  const int nt = nr * nc;
  for (int q = threadIdx.x; q < nt * K; q += kTileWarps * 32) {
    list_k[q] = kInfBits;
    list_i[q] = 0x7fffffff;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inf = __int_as_float(kInfBits);
  // Lane y: region row y of the span; if it is a reference row, block row i.
  const bool ref_row = (rmask >> lane) & 1u;
  const int i = __popc(rmask & ((1u << lane) - 1u));
  const float* ref_at = region + (search + lane) * pitch + search;  // modes 0, 2
  // Mode 1: the pair of columns (c, c + 1) of region row y is word c / 2 of
  // row y of layout c % 2.
  auto pair_at = [&](int y, int c) { return pairs + ((c & 1) * reg_n + y) * pp + (c >> 1); };
  const int last_c = W - kBlock;
  const int2* offs2 = reinterpret_cast<const int2*>(offsets);
  for (int s0 = 0; s0 < S; s0 += kChunk) {  // positions in the visiting order
    const int n_chunk = min(kChunk, S - s0);
    // Phase 1: distances. The lane's reference row stays in registers for
    // the chunk (in mode 1 as bf16 pairs: half the registers, and one load
    // a candidate pair).
    float ref[MODE == 1 ? 1 : kTileSpan];
    unsigned ref2[MODE == 1 ? kTileSpan / 2 : 1];
#pragma unroll
    for (int xx = 0; xx < kTileSpan; xx += 2) {
      if (MODE == 1) {
        ref2[xx / 2] = pair_at(search + lane, search)[xx / 2];
      } else {
        ref[xx] = ref_at[xx];
        ref[xx + 1] = ref_at[xx + 1];
      }
    }
    for (int c = warp; c < n_chunk; c += kTileWarps) {
      const int2 o = __ldg(offs2 + s0 + c);
      const float* cand = ref_at + o.x * pitch + o.y;
      const unsigned* cand2 = pair_at(search + lane + o.x, search + o.y);
      float t[kTileSpan];
#pragma unroll
      for (int xx = 0; xx < kTileSpan; xx += 2) {
        if (MODE == 1)
          sq_terms2<1>(ref2[xx / 2], cand2[xx / 2], 0.f, 0.f, 0.f, 0.f, t[xx], t[xx + 1]);
        else
          sq_terms2<MODE>(0u, 0u, ref[xx], ref[xx + 1], cand[xx], cand[xx + 1], t[xx], t[xx + 1]);
      }
      const int cy = ry0 + lane + o.x;
      const bool row_ok = ref_row && cy >= cand_lo && cy <= cand_hi;
      // In place, ascending: t[xx] becomes the sum of 2, then 4, then 8
      // terms from column xx, each level the sum of two of the last.
#pragma unroll
      for (int xx = 0; xx < kTileSpan - 1; ++xx) t[xx] = __fadd_rn(t[xx], t[xx + 1]);
#pragma unroll
      for (int xx = 0; xx < kTileSpan - 3; ++xx) t[xx] = __fadd_rn(t[xx], t[xx + 2]);
#pragma unroll
      for (int xx = 0; xx < kTileCols; ++xx) t[xx] = __fadd_rn(t[xx], t[xx + 4]);
#pragma unroll
      for (int xx = 0; xx < kTileCols; ++xx) {
        if ((cmask >> xx) & 1u) {
          const float v = sum8_down(t[xx]);
          const int j = __popc(cmask & ((1u << xx) - 1u));
          const int cx = rx0 + xx + o.y;
          if (ref_row) dist[(i * nc + j) * kDPitch + c] = row_ok && cx >= 0 && cx <= last_c ? v : inf;
        }
      }
    }
    __syncthreads();

    // Phase 2: each warp merges the chunk into its blocks' running top-k.
    merge_chunk_warps<KS>(dist, list_k, list_i, order, s0, n_chunk, S, K, nt, nc, s0 + kChunk >= S, out,
                          b, nR, nC, r0, c0, lane, warp);
    __syncthreads();
  }
}

template <int MODE, int KS>
cudaError_t launch_tile(dim3 grid, size_t smem, cudaStream_t stream, const float* img,
                        const int* rows, const int* cols, const int* offsets, const int* order,
                        const int* row_tiles, const int* col_tiles, int* out, int H, int W,
                        int nR, int nC, int S, int K, int search, int pitch, int cand_lo,
                        int cand_hi) {
  auto fn = bm3d_match_tile_kernel<MODE, KS>;
  static size_t granted = 48 * 1024;  // dynamic shared memory opted into so far
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  fn<<<grid, kTileWarps * 32, smem, stream>>>(img, rows, cols, offsets, order, row_tiles, col_tiles,
                                              out, H, W, nR, nC, S, K, search, pitch, cand_lo,
                                              cand_hi);
  return cudaGetLastError();
}

// One slot a lane for k <= 32, two for k <= 64, four for k <= 128.
template <int MODE>
cudaError_t launch_tile_mode(dim3 grid, size_t smem, cudaStream_t st, const float* img,
                             const int* rows, const int* cols, const int* offsets,
                             const int* order, const int* row_tiles, const int* col_tiles,
                             int* out, int H, int W, int nR, int nC, int S, int K, int search,
                             int pitch, int cand_lo, int cand_hi) {
  if (K <= 32)
    return launch_tile<MODE, 1>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                                col_tiles, out, H, W, nR, nC, S, K, search, pitch, cand_lo,
                                cand_hi);
  if (K <= 64)
    return launch_tile<MODE, 2>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                                col_tiles, out, H, W, nR, nC, S, K, search, pitch, cand_lo, cand_hi);
  return launch_tile<MODE, 4>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                              col_tiles, out, H, W, nR, nC, S, K, search, pitch, cand_lo, cand_hi);
}

// ---- Every other block: `bm3d_match_span_kernel` ------------------------
//
// Takes every K1 call at a block in [kMinBlock, kMaxBlock] other than 8 on a
// strictly ascending reference grid, the path `bm3d_match_any_kernel` took
// before; the any-kernel, which stood for the Pallas kernel `_match_kernel`
// (pnp_svrg_tpu/ops/pallas/bm3d_match.py:52) on those calls, now takes only
// grids that do not strictly ascend. It computes the same function: any
// power-of-two k up to 128, any window whose tile fits shared memory (the
// host's reach, as the tile kernel's), the three rounding modes, the row
// bounds. Blocks 1 and 17-32 (up to the span: one tile row a lane) take a
// run-time phase 1 (`span_distances_rt`), each sum one term after another. Bound as above: f32 arithmetic in the separable
// form, one term a (pixel, offset) and the box sums shared by the blocks a
// tile holds. The any-kernel paid three costs, and this kernel answers each
// as the block-8 tile kernel does:
//  1. It summed block^2 terms directly for each (block, offset) pair, so
//     overlapping blocks shared nothing (block^2 / step^2 times the work).
//     Here one CTA of kTileWarps warps takes a tile of blocks whose patches
//     span at most kTileSpan rows and columns (the tile kernel's plans and
//     staged region), and a warp takes one offset at a time: lane y forms
//     the kTileSpan rounded terms of span row y once (mode 1 from bf16
//     pairs), then block-wide sums along the row at every column and, at
//     each reference column, block-tall sums down the lanes (`shfl.down`).
//     Both follow one tree that depends only on the block: its binary
//     decomposition, the largest power of two first, each part a doubling
//     tree (6 = 4 + 2: ((t0 + t1) + (t2 + t3)) + (t4 + t5); 8 is the tile
//     kernel's tree), f32 adds, no FMA. The parts below the largest are
//     gathered, lowest first, in a second row of registers as the doubling
//     sums pass their width.
//  2. It rebuilt its running top-k with k rounds of a warp argmin for every
//     chunk of offsets. Here the offsets come in `visit_order` (nearest the
//     window's centre first) in chunks of kChunk. For k <= 8 a thread takes
//     a block and keeps its least (distance bits, offset index) pairs, 4 or
//     8 of them, as sorted 64-bit keys in registers (which order as the
//     pairs do); a candidate below the last enters by a compare-exchange
//     chain, and any other costs one compare. For k 16 to 64 the tile
//     kernel's phase 2 (`merge_chunk_warps`): a warp a block, a ballot of
//     the candidates below the k-th entry. Either gives
//     `top_k_offsets_plain`'s result: ascending, ties to the lowest index,
//     an entry still at +inf written as index 0.
//  3. Its CTAs were 4 x 4 blocks with a warp a block. Here a tile holds as
//     many blocks as the span does, up to `most` (host-made: the distance
//     buffer, most x kDPitch floats, and the top-k lists, 8 bytes an entry,
//     still let three CTAs share an SM; at most one a thread).
// The block is a compile-time constant of phase 1 (a case of a switch in
// the kernel, one for each block), so its trees are straight-line code
// with no branches and no dead terms; the rounding mode (mode 1's packed
// pairs, or f32 with mode 2's rounding of each square at run time) and the
// phase-2 form are the kernel's template argument and run-time branches:
// two kernels in all, not one for each (block, mode, k). The choices were
// timed on an H100 at chip_smoke.py's rows off block 8 against variants
// of this source (`examples/k1_variants.py --part span`, PERF.md): the
// block at run time (one kernel for every block, its trees by branches on
// its bits) spilled and was slower than the any-kernel at three rows;
// merging k <= 8 by a warp, k 16 by a thread, two CTAs an SM, chunks of
// 128, tiles of half the blocks, offsets in ascending order and modes 0
// and 2 holding the reference row in registers were each slower at most
// rows.

__host__ __device__ constexpr int high_bit(int b) { return b >= 16 ? 16 : b >= 8 ? 8 : b >= 4 ? 4 : b >= 2 ? 2 : 1; }

// The blocks' sums along a span row: t[x] becomes the sum of B terms from
// column x (for x + B <= N) by the tree above; at width W (the doubling
// sums t holds), bit W of the block below its largest power of two is
// folded into r first, and after the largest, r is added to it.
template <int B, int W = 1, int N>
__device__ __forceinline__ void row_window_sums(float (&t)[N], float (&r)[N]) {
  constexpr int HB = high_bit(B), REST = B - HB;
  if constexpr (W < HB) {
    if constexpr ((REST & W) != 0) {
      if constexpr ((REST & (W - 1)) == 0) {  // the lowest bit: r starts as t
#pragma unroll
        for (int x = 0; x < N; ++x) r[x] = t[x];
      } else {
#pragma unroll
        for (int x = 0; x + W < N; ++x) r[x] = __fadd_rn(t[x], r[x + W]);
      }
    }
#pragma unroll
    for (int x = 0; x + W < N; ++x) t[x] = __fadd_rn(t[x], t[x + W]);
    row_window_sums<B, 2 * W>(t, r);
  } else if constexpr (REST != 0) {
#pragma unroll
    for (int x = 0; x + HB < N; ++x) t[x] = __fadd_rn(t[x], r[x + HB]);
  }
}

// The same tree down the lanes: lane y gets the sum of v over lanes y to
// y + B - 1 (lanes past 31 read their own value); for B = 8, `sum8_down`.
template <int B, int W = 1>
__device__ __forceinline__ float lane_window_sum(float v, float r = 0.f) {
  constexpr int HB = high_bit(B), REST = B - HB;
  if constexpr (W < HB) {
    if constexpr ((REST & W) != 0) {
      if constexpr ((REST & (W - 1)) == 0)
        r = v;
      else
        r = __fadd_rn(v, __shfl_down_sync(kAllLanes, r, W));
    }
    v = __fadd_rn(v, __shfl_down_sync(kAllLanes, v, W));
    return lane_window_sum<B, 2 * W>(v, r);
  } else if constexpr (REST != 0) {
    return __fadd_rn(v, __shfl_down_sync(kAllLanes, r, HB));
  } else {
    return v;
  }
}

// What phase 1 of a span tile needs besides its block.
struct SpanTile {
  const float* region;    // modes 0, 2: the staged region, reg_n x pitch
  const unsigned* pairs;  // mode 1: bf16 pairs in two layouts, reg_n x pp each
  int reg_n, pp, pitch, search;
  const int2* offsets;  // in the visiting order
  unsigned cmask;       // the tile's reference columns less its first, as bits of the span
  int nc, rx0, ry0, cand_lo, cand_hi, last_c;
  bool ref_row;  // this lane's span row is a reference row,
  int i;         // its block row in the tile
  bool round_sq;  // mode 2: each square rounded to bf16
  float* dist;    // D[tile blocks][chunk], kDPitch floats a row
};

// Phase 1 of the span kernel at block B: the distances of chunk positions
// [s0, s0 + n_chunk) into `dist`, a warp an offset. Mode 1 keeps the lane's
// reference row in registers as bf16 pairs; modes 0 and 2 read it from
// shared memory with each candidate row (32 more registers there spilled,
// and were slower at 5 of 6 rows: PERF.md).
template <bool PAIRS, int B>
__device__ __forceinline__ void span_distances(const SpanTile& p, int s0, int n_chunk, int lane,
                                               int warp) {
  const float inf = __int_as_float(kInfBits);
  const float* ref_at = p.region + (p.search + lane) * p.pitch + p.search;
  auto pair_at = [&](int y, int c) { return p.pairs + ((c & 1) * p.reg_n + y) * p.pp + (c >> 1); };
  unsigned ref2[PAIRS ? kTileSpan / 2 : 1];
  if constexpr (PAIRS) {
#pragma unroll
    for (int xx = 0; xx < kTileSpan; xx += 2) ref2[xx / 2] = pair_at(p.search + lane, p.search)[xx / 2];
  }
  for (int c = warp; c < n_chunk; c += kTileWarps) {
    const int2 o = __ldg(p.offsets + s0 + c);
    float t[kTileSpan], r[kTileSpan];
    if constexpr (PAIRS) {
      const unsigned* cand2 = pair_at(p.search + lane + o.x, p.search + o.y);
#pragma unroll
      for (int xx = 0; xx < kTileSpan; xx += 2)
        sq_terms2<1>(ref2[xx / 2], cand2[xx / 2], 0.f, 0.f, 0.f, 0.f, t[xx], t[xx + 1]);
    } else {
      const float* cand = ref_at + o.x * p.pitch + o.y;
      if (p.round_sq) {
#pragma unroll
        for (int xx = 0; xx < kTileSpan; xx += 2)
          sq_terms2<2>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx], cand[xx + 1], t[xx], t[xx + 1]);
      } else {
#pragma unroll
        for (int xx = 0; xx < kTileSpan; xx += 2)
          sq_terms2<0>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx], cand[xx + 1], t[xx], t[xx + 1]);
      }
    }
    const int cy = p.ry0 + lane + o.x;
    const bool row_ok = p.ref_row && cy >= p.cand_lo && cy <= p.cand_hi;
    row_window_sums<B>(t, r);
#pragma unroll
    for (int xx = 0; xx + B <= kTileSpan; ++xx) {
      if ((p.cmask >> xx) & 1u) {
        const float v = lane_window_sum<B>(t[xx]);
        const int j = __popc(p.cmask & ((1u << xx) - 1u));
        const int cx = p.rx0 + xx + o.y;
        if (p.ref_row) p.dist[(p.i * p.nc + j) * kDPitch + c] = row_ok && cx >= 0 && cx <= p.last_c ? v : inf;
      }
    }
  }
}

// Phase 1 at a block read at run time (1 and 17-32; the blocks 2-16 have a
// compiled body each): the lane's terms as above, then at each reference
// column its block-wide row sum and the block-tall sum down the lanes, each
// one term after another (f32 adds, no FMA). The row sum runs over the
// span's columns with the terms outside the block's window added as 0,
// which leaves every partial sum as it is.
template <bool PAIRS>
__device__ __forceinline__ void span_distances_rt(const SpanTile& p, int block, int s0, int n_chunk, int lane,
                                                  int warp) {
  const float inf = __int_as_float(kInfBits);
  const float* ref_at = p.region + (p.search + lane) * p.pitch + p.search;
  auto pair_at = [&](int y, int c) { return p.pairs + ((c & 1) * p.reg_n + y) * p.pp + (c >> 1); };
  unsigned ref2[PAIRS ? kTileSpan / 2 : 1];
  if constexpr (PAIRS) {
#pragma unroll
    for (int xx = 0; xx < kTileSpan; xx += 2) ref2[xx / 2] = pair_at(p.search + lane, p.search)[xx / 2];
  }
  for (int c = warp; c < n_chunk; c += kTileWarps) {
    const int2 o = __ldg(p.offsets + s0 + c);
    float t[kTileSpan];
    if constexpr (PAIRS) {
      const unsigned* cand2 = pair_at(p.search + lane + o.x, p.search + o.y);
#pragma unroll
      for (int xx = 0; xx < kTileSpan; xx += 2)
        sq_terms2<1>(ref2[xx / 2], cand2[xx / 2], 0.f, 0.f, 0.f, 0.f, t[xx], t[xx + 1]);
    } else {
      const float* cand = ref_at + o.x * p.pitch + o.y;
      if (p.round_sq) {
#pragma unroll
        for (int xx = 0; xx < kTileSpan; xx += 2)
          sq_terms2<2>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx], cand[xx + 1], t[xx], t[xx + 1]);
      } else {
#pragma unroll
        for (int xx = 0; xx < kTileSpan; xx += 2)
          sq_terms2<0>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx], cand[xx + 1], t[xx], t[xx + 1]);
      }
    }
    const int cy = p.ry0 + lane + o.x;
    const bool row_ok = p.ref_row && cy >= p.cand_lo && cy <= p.cand_hi;
#pragma unroll 1
    for (int xx = 0; xx + block <= kTileSpan; ++xx) {
      if ((p.cmask >> xx) & 1u) {
        float v = 0.f;
#pragma unroll
        for (int x = 0; x < kTileSpan; ++x) v = __fadd_rn(v, (unsigned)(x - xx) < (unsigned)block ? t[x] : 0.f);
        float d = v;
        for (int y = 1; y < block; ++y) d = __fadd_rn(d, __shfl_sync(kAllLanes, v, min(lane + y, 31)));
        const int j = __popc(p.cmask & ((1u << xx) - 1u));
        const int cx = p.rx0 + xx + o.y;
        if (p.ref_row) p.dist[(p.i * p.nc + j) * kDPitch + c] = row_ok && cx >= 0 && cx <= p.last_c ? d : inf;
      }
    }
  }
}

// Phase 2 for k <= KL: thread tb merges the chunk into block tb's running
// KL least keys (`list`, [entry][most], kept between chunks) and, at the
// last chunk, writes the first K to `out`.
template <int KL>
__device__ __forceinline__ void merge_chunk_threads(const float* dist, unsigned long long* list,
                                                    const int* chunk_order, int n_chunk, int nt,
                                                    int most, int K, bool last, int* out, int b,
                                                    int nR, int nC, int r0, int c0, int nc) {
  const int tb = threadIdx.x;
  if (tb >= nt) return;
  unsigned long long l[KL];
#pragma unroll
  for (int e = 0; e < KL; ++e) l[e] = list[e * most + tb];
  const float* d = dist + tb * kDPitch;
#pragma unroll 4
  for (int c = 0; c < n_chunk; ++c) {
    unsigned long long v = (unsigned long long)__float_as_uint(d[c]) << 32 | (unsigned)chunk_order[c];
    if (v < l[KL - 1]) {
#pragma unroll
      for (int e = 0; e < KL; ++e) {
        const bool lt = v < l[e];
        const unsigned long long lo = lt ? v : l[e];
        v = lt ? l[e] : v;
        l[e] = lo;
      }
    }
  }
  if (last) {
    const int bi = tb / nc, bj = tb - bi * nc;
    int* o = out + (((size_t)b * nR + r0 + bi) * nC + c0 + bj) * K;
#pragma unroll
    for (int e = 0; e < KL; ++e) {
      if (e < K) o[e] = (unsigned)(l[e] >> 32) >= kInfBits ? 0 : (int)(unsigned)l[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < KL; ++e) list[e * most + tb] = l[e];
  }
}

// Entries of a block's running top-k: 4 or 8 keys for k <= 8 (a thread a
// block), else k (a warp a block).
__host__ __device__ inline int span_entries(int K) { return K <= 4 ? 4 : K <= 8 ? 8 : K; }

// Words of shared memory before the top-k lists (8-byte aligned): the staged
// region, the distance buffer and the chunk's offset indices.
__host__ __device__ inline int span_lists_at(int search, int pitch, int most) {
  return ((kTileSpan + 2 * search) * (pitch + 1) + most * kDPitch + kChunk + 1) & ~1;
}

template <bool PAIRS>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
bm3d_match_span_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                       const int* __restrict__ cols, const int* __restrict__ offsets,
                       const int* __restrict__ order, const int* __restrict__ row_tiles,
                       const int* __restrict__ col_tiles, int* __restrict__ out, int H, int W,
                       int nR, int nC, int S, int K, int block, bool round_sq, int search, int pitch,
                       int most, int cand_lo, int cand_hi) {
  extern __shared__ float smem[];
  const int reg_n = kTileSpan + 2 * search;  // the staged region's rows and columns (even)
  float* region = smem;
  unsigned* pairs = reinterpret_cast<unsigned*>(smem);
  const int pp = (reg_n / 2) | 1;                                    // the pairs' row pitch (odd)
  float* dist = smem + reg_n * (pitch + 1);                          // most x kDPitch
  int* chunk_order = reinterpret_cast<int*>(dist + most * kDPitch);  // kChunk
  float* lists = smem + span_lists_at(search, pitch, most);
  unsigned long long* list = reinterpret_cast<unsigned long long*>(lists);  // k <= 8: [entry][most]
  unsigned* list_k = reinterpret_cast<unsigned*>(lists);                    // else [block][entry]
  int* list_i = reinterpret_cast<int*>(list_k + most * K);
  const int r0 = row_tiles[3 * blockIdx.y], nr = row_tiles[3 * blockIdx.y + 1];
  const unsigned rmask = (unsigned)row_tiles[3 * blockIdx.y + 2];
  const int c0 = col_tiles[3 * blockIdx.x], nc = col_tiles[3 * blockIdx.x + 1];
  const unsigned cmask = (unsigned)col_tiles[3 * blockIdx.x + 2];
  const int b = blockIdx.z;
  const int ry0 = rows[r0], rx0 = cols[c0];
  stage_span_region<PAIRS ? 1 : 0>(img + (size_t)b * H * W, H, W, ry0, rx0, search, reg_n, pitch, pp,
                                   region, pairs);
  const int nt = nr * nc;
  const bool by_threads = K <= 8;
  if (by_threads) {
    for (int q = threadIdx.x; q < span_entries(K) * most; q += kTileWarps * 32) list[q] = ~0ull;
  } else {
    for (int q = threadIdx.x; q < nt * K; q += kTileWarps * 32) {
      list_k[q] = kInfBits;
      list_i[q] = 0x7fffffff;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Lane y: region row y of the span; if it is a reference row, block row i.
  const SpanTile tile{region, pairs, reg_n, pp, pitch, search, reinterpret_cast<const int2*>(offsets),
                      cmask, nc, rx0, ry0, cand_lo, cand_hi, W - block, ((rmask >> lane) & 1u) != 0,
                      __popc(rmask & ((1u << lane) - 1u)), round_sq, dist};
  for (int s0 = 0; s0 < S; s0 += kChunk) {  // positions in the visiting order
    const int n_chunk = min(kChunk, S - s0);
    if (by_threads && (int)threadIdx.x < n_chunk) chunk_order[threadIdx.x] = __ldg(order + s0 + threadIdx.x);
    __syncthreads();
    switch (block) {  // phase 1: distances
#define PNP_SPAN_BLOCK(B) \
  case B:                 \
    span_distances<PAIRS, B>(tile, s0, n_chunk, lane, warp); \
    break;
      PNP_SPAN_BLOCK(2) PNP_SPAN_BLOCK(3) PNP_SPAN_BLOCK(4) PNP_SPAN_BLOCK(5) PNP_SPAN_BLOCK(6)
      PNP_SPAN_BLOCK(7) PNP_SPAN_BLOCK(9) PNP_SPAN_BLOCK(10) PNP_SPAN_BLOCK(11) PNP_SPAN_BLOCK(12)
      PNP_SPAN_BLOCK(13) PNP_SPAN_BLOCK(14) PNP_SPAN_BLOCK(15) PNP_SPAN_BLOCK(16)
#undef PNP_SPAN_BLOCK
      default:  // 1 and 17-32
        span_distances_rt<PAIRS>(tile, block, s0, n_chunk, lane, warp);
    }
    __syncthreads();

    // Phase 2: the chunk into the blocks' running top-k.
    const bool last = s0 + kChunk >= S;
    if (K <= 4)
      merge_chunk_threads<4>(dist, list, chunk_order, n_chunk, nt, most, K, last, out, b, nR, nC, r0, c0, nc);
    else if (K <= 8)
      merge_chunk_threads<8>(dist, list, chunk_order, n_chunk, nt, most, K, last, out, b, nR, nC, r0, c0, nc);
    else if (K <= 32)
      merge_chunk_warps<1>(dist, list_k, list_i, order, s0, n_chunk, S, K, nt, nc, last, out, b, nR, nC, r0,
                           c0, lane, warp);
    else if (K <= 64)
      merge_chunk_warps<2>(dist, list_k, list_i, order, s0, n_chunk, S, K, nt, nc, last, out, b, nR, nC, r0,
                           c0, lane, warp);
    else
      merge_chunk_warps<4>(dist, list_k, list_i, order, s0, n_chunk, S, K, nt, nc, last, out, b, nR, nC, r0,
                           c0, lane, warp);
    __syncthreads();
  }
}

template <bool PAIRS>
cudaError_t launch_span(dim3 grid, size_t smem, cudaStream_t stream, const float* img,
                        const int* rows, const int* cols, const int* offsets, const int* order,
                        const int* row_tiles, const int* col_tiles, int* out, int H, int W,
                        int nR, int nC, int S, int K, int block, bool round_sq, int search, int pitch,
                        int most, int cand_lo, int cand_hi) {
  auto fn = bm3d_match_span_kernel<PAIRS>;
  static size_t granted = 48 * 1024;  // dynamic shared memory opted into so far
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  fn<<<grid, kTileWarps * 32, smem, stream>>>(img, rows, cols, offsets, order, row_tiles, col_tiles,
                                              out, H, W, nR, nC, S, K, block, round_sq, search, pitch,
                                              most, cand_lo, cand_hi);
  return cudaGetLastError();
}

}  // namespace

// Top-K offset indices for every reference block. `img` (B, H, W) f32,
// `rows` (nR,) / `cols` (nC,) int32 reference coordinates, `offsets` (S, 2)
// int32 (dy, dx) with |dy|, |dx| <= search, `col_plan` (ceil(nC / 8), kPlan)
// int32 column plans, `out` (B, nR, nC, K) int32. smem_h x smem_w is the
// largest tile region, stored with row pitch `pitch` (odd, >= smem_w), and
// `d_pitch` (odd, >= S) the distance buffer's row pitch (host-computed;
// every tile's reference rows span at most kRefRows pixels, S <= 640).
// Candidates count only with a top row in [cand_lo, cand_hi] (within
// [0, H - block]; (0, H - block) for the whole image). Returns the launch's
// cudaError_t (0 on success).
extern "C" int bm3d_match_launch(const float* img, const int* rows, const int* cols,
                                 const int* offsets, const int* col_plan, int* out, int B,
                                 int H, int W, int nR, int nC, int S, int block_size, int K,
                                 int mode, int search, int smem_h, int smem_w, int pitch,
                                 int d_pitch, int cand_lo, int cand_hi, void* stream) {
  if (block_size != kBlock || K != kK || pitch < smem_w || d_pitch < S || S < 1 ||
      cand_lo < 0 || cand_hi > H - kBlock)
    return cudaErrorInvalidValue;
  const dim3 grid((nC + kTileC - 1) / kTileC, (nR + kTileR - 1) / kTileR, B);
  const size_t smem = sizeof(float) * ((size_t)smem_h * pitch + (size_t)kTileR * kTileC * d_pitch +
                                       (size_t)kWarps * kInFlight * kItems);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_mode<0>(S, grid, smem, st, img, rows, cols, offsets, col_plan, out, H, W,
                            nR, nC, search, smem_h, smem_w, pitch, d_pitch, cand_lo, cand_hi);
    case 1:
      return launch_mode<1>(S, grid, smem, st, img, rows, cols, offsets, col_plan, out, H, W,
                            nR, nC, search, smem_h, smem_w, pitch, d_pitch, cand_lo, cand_hi);
    case 2:
      return launch_mode<2>(S, grid, smem, st, img, rows, cols, offsets, col_plan, out, H, W,
                            nR, nC, search, smem_h, smem_w, pitch, d_pitch, cand_lo, cand_hi);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same function for any block in [2, 16] and k in [1, 64], any reference
// grid and any window: `rows` (nR,) / `cols` (nC,) int32, `offsets` (S, 2)
// int32 with |dy|, |dx| <= search, `out` (B, nR, nC, K) int32. smem_h x
// `pitch` floats of dynamic shared memory hold the largest tile region
// (host-computed, `pitch` >= its width). Candidates count only with a top
// row in [cand_lo, cand_hi], as above. Returns the launch's cudaError_t.
extern "C" int bm3d_match_any_launch(const float* img, const int* rows, const int* cols,
                                     const int* offsets, int* out, int B, int H, int W, int nR,
                                     int nC, int S, int block_size, int K, int mode, int search,
                                     int smem_h, int pitch, int cand_lo, int cand_hi,
                                     void* stream) {
  if (block_size < kMinBlock || block_size > kMaxBlock || K < 1 || K > kMaxK || S < 1 ||
      nR < 1 || nC < 1 || cand_lo < 0 || cand_hi > H - block_size)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid((nC + kAnyTileC - 1) / kAnyTileC, (nR + kAnyTileR - 1) / kAnyTileR, B);
  const size_t smem = sizeof(float) * (size_t)smem_h * pitch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_any_mode<0>(S, block_size, grid, smem, st, img, rows, cols, offsets, out, H,
                                W, nR, nC, K, search, pitch, cand_lo, cand_hi);
    case 1:
      return launch_any_mode<1>(S, block_size, grid, smem, st, img, rows, cols, offsets, out, H,
                                W, nR, nC, K, search, pitch, cand_lo, cand_hi);
    case 2:
      return launch_any_mode<2>(S, block_size, grid, smem, st, img, rows, cols, offsets, out, H,
                                W, nR, nC, K, search, pitch, cand_lo, cand_hi);
    default:
      return cudaErrorInvalidValue;
  }
}

// Block 8 at any strictly ascending reference grid, k in [1, 128] and any
// window whose region fits shared memory (the host's reckoning): `offsets`
// (S, 2) in the order the kernel visits
// them and `order` (S,) the index of each in the window's ascending order
// (the index a match returns), `row_tiles` (n_row_tiles, 3) / `col_tiles`
// (n_col_tiles, 3) int32, each tile's first index into `rows` / `cols`, its
// count and the mask of its coordinates less the first (bits 0-24; the
// rows' count times the columns' at most kTileMax). `pitch` (odd, at least
// kTileSpan + 2 search) is the staged region's row pitch. The rest as
// above. Returns the launch's cudaError_t.
extern "C" int bm3d_match_tile_launch(const float* img, const int* rows, const int* cols,
                                      const int* offsets, const int* order, const int* row_tiles,
                                      const int* col_tiles, int* out, int B, int H, int W, int nR,
                                      int nC, int n_row_tiles, int n_col_tiles, int S,
                                      int block_size, int K, int mode, int search, int pitch,
                                      int cand_lo, int cand_hi, void* stream) {
  if (block_size != kBlock || K < 1 || K > kSpanMaxK || S < 1 || search < 0 ||
      pitch < kTileSpan + 2 * search || n_row_tiles < 1 || n_col_tiles < 1 || cand_lo < 0 ||
      cand_hi > H - kBlock)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid(n_col_tiles, n_row_tiles, B);
  const size_t smem = sizeof(float) * ((size_t)(kTileSpan + 2 * search) * (pitch + 1) +
                                       (size_t)kTileMax * kDPitch) +
                      2 * sizeof(int) * kTileMax * K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_tile_mode<0>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                                 col_tiles, out, H, W, nR, nC, S, K, search, pitch, cand_lo,
                                 cand_hi);
    case 1:
      return launch_tile_mode<1>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                                 col_tiles, out, H, W, nR, nC, S, K, search, pitch, cand_lo,
                                 cand_hi);
    case 2:
      return launch_tile_mode<2>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                                 col_tiles, out, H, W, nR, nC, S, K, search, pitch, cand_lo,
                                 cand_hi);
    default:
      return cudaErrorInvalidValue;
  }
}

// Any block in [1, 32] but 8 (the tile kernel's) on a strictly ascending
// reference grid, k a power of two in [1, 128] and any window whose tile
// fits shared memory: the tile kernel's arguments, with `block_size` the
// block and `most` the blocks a tile holds at most (in [1, 256]; the
// plans' rows' count times the columns' at most that). Returns the
// launch's cudaError_t.
extern "C" int bm3d_match_span_launch(const float* img, const int* rows, const int* cols,
                                      const int* offsets, const int* order, const int* row_tiles,
                                      const int* col_tiles, int* out, int B, int H, int W, int nR,
                                      int nC, int n_row_tiles, int n_col_tiles, int S,
                                      int block_size, int K, int mode, int search, int pitch,
                                      int most, int cand_lo, int cand_hi, void* stream) {
  if (block_size < kSpanMinBlock || block_size > kSpanMaxBlock || block_size == kBlock || K < 1 || K > kSpanMaxK ||
      S < 1 || mode < 0 || mode > 2 || search < 0 || pitch < kTileSpan + 2 * search ||
      n_row_tiles < 1 || n_col_tiles < 1 || most < 1 || most > kTileWarps * 32 || cand_lo < 0 ||
      cand_hi > H - block_size)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid(n_col_tiles, n_row_tiles, B);
  const size_t smem = sizeof(float) * span_lists_at(search, pitch, most) +
                      sizeof(unsigned long long) * most * span_entries(K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return launch_span<true>(grid, smem, st, img, rows, cols, offsets, order, row_tiles, col_tiles, out,
                             H, W, nR, nC, S, K, block_size, false, search, pitch, most, cand_lo, cand_hi);
  return launch_span<false>(grid, smem, st, img, rows, cols, offsets, order, row_tiles, col_tiles, out, H,
                            W, nR, nC, S, K, block_size, mode == 2, search, pitch, most, cand_lo, cand_hi);
}
