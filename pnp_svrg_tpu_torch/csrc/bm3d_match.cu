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
// power-of-two k up to 128 (one or two slots a lane; k 128 by ranks), and computes the
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
//     lowest index, an entry still at +inf written as index 0. At k 128
//     the candidates below the k-th entry are merged by ranks instead
//     (`merge_chunk_ranks`), on tiles of at most `most` blocks (host-made:
//     as many as let three, or else two, CTAs share an SM, where that is at
//     least half of kTileMax; 81 blocks' lists alone took 82,944 bytes, one
//     CTA an SM).
// The choices were timed on an H100 at the reference profile's shapes
// against variants of this source (`examples/k1_variants.py`): 4 warps a
// CTA, chunks of 32 or 128 offsets, two CTAs an SM (more registers) and
// mode 1's region staged as f32 were each slower at k 16 or k 32, and so
// was visiting the offsets in ascending order (PERF.md). Bound as above: f32 arithmetic (one term a
// pixel and offset, the box sums shared by a tile's blocks); PERF.md gives
// its time beside that bound.
//
// A wide window in parts (`bm3d_match_tile_kernel_parts`, k <= 64; the
// span kernel's `bm3d_match_span_kernel_parts` likewise). The whole region,
// (32 + 2 search)^2 words, leaves one CTA an SM at search 95, and every
// tile visits every offset of the reach, though at 128 px only 0.47 of the
// (tile, offset) pairs are live. Where the whole region would not let three
// CTAs share an SM, the host cuts the reach into parts (`part_plan`): the
// cells of bands of dy and dx cut where some tile's live offsets begin or
// end, split to the width the host's cost model picks, the part nearest the
// window's centre first, each part's offsets in the visiting order. On a
// whole image a part then holds only offsets some block of a tile takes, or
// none of the tile's. The CTA stages its reference span apart
// (`stage_reference`: kTileSpan rows of kRefPitch words) and, for each
// part the tile can take (`part_live`, from its first and last reference
// rows and columns and the part's bounds), the box of pixels that part's
// candidates reach (`stage_part_region`, laid out as `stage_span_region`
// lays out a region: f32, or mode 1's bf16 pairs in two alignments), then
// runs the part's offsets through the same two phases, each candidate
// tested as before; the running top-k lists stay in shared memory across
// parts, and the last chunk of the last part the tile takes writes the
// result. The skip is exact: +inf never passes phase 2's ballot, phase 2
// compares (distance bits, offset index) whatever the order, and a tile
// that takes no part writes index 0 in every slot, the fill. (A test an
// offset as well, inside a live part, was 4.5 % slower at search_widest:
// PERF.md.) The parts path is a template argument of the body (PARTS), so
// the one-part calls keep their code.

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
// A window staged in parts (the tile kernel at k <= 64, the span kernel):
// the tile's reference span staged apart, kTileSpan rows of kRefPitch f32
// words (mode 1: kRefPairPitch bf16 pairs a row), and a host-made table of
// the parts, kPartCols ints a part: its first position in the visiting
// order, its count, dy0, dy1, dx0, dx1.
constexpr int kRefPitch = kTileSpan + 1, kRefPairPitch = kTileSpan / 2 + 1;
constexpr int kRefWords = kTileSpan * kRefPitch;
constexpr int kPartCols = 6;

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

// Stages a tile's reference span apart, for a window staged in parts:
// kTileSpan rows and columns of the image `x` from (ry0, rx0), 0 outside
// the image; f32 at row pitch kRefPitch, or in mode 1 the bf16 pairs of
// columns (2p, 2p + 1) at row pitch kRefPairPitch.
template <int MODE>
__device__ __forceinline__ void stage_reference(const float* x, int H, int W, int ry0, int rx0, float* ref) {
  auto pixel = [&](int yy, int xx) {  // the image, 0 outside it
    return yy >= 0 && yy < H && xx >= 0 && xx < W ? x[yy * W + xx] : 0.f;
  };
  if (MODE == 1) {
    unsigned* pairs = reinterpret_cast<unsigned*>(ref);
    for (int q = threadIdx.x; q < kTileSpan * kTileSpan / 2; q += kTileWarps * 32) {
      const int r = q / (kTileSpan / 2), p2 = q % (kTileSpan / 2);
      pairs[r * kRefPairPitch + p2] = pack_bf16x2(pixel(ry0 + r, rx0 + 2 * p2), pixel(ry0 + r, rx0 + 2 * p2 + 1));
    }
  } else {
    for (int q = threadIdx.x; q < kTileSpan * kTileSpan; q += kTileWarps * 32)
      ref[(q / kTileSpan) * kRefPitch + q % kTileSpan] = pixel(ry0 + q / kTileSpan, rx0 + q % kTileSpan);
  }
}

// Stages one part's box as `stage_span_region` lays out a region: the image
// from (y0, x0), `rows` rows of `cols` (even) columns, 0 outside the image;
// f32 at row pitch `pitch`, or mode 1's bf16 pairs in two alignments, `rows`
// rows of pitch `pp` each.
template <int MODE>
__device__ __forceinline__ void stage_part_region(const float* x, int H, int W, int y0, int x0, int rows, int cols,
                                                  int pitch, int pp, float* region, unsigned* pairs) {
  auto pixel = [&](int yy, int xx) {  // the image, 0 outside it
    return yy >= 0 && yy < H && xx >= 0 && xx < W ? x[yy * W + xx] : 0.f;
  };
  if (MODE == 1) {
    const int half = cols / 2;
    for (int q = threadIdx.x; q < rows * half; q += kTileWarps * 32) {
      const int r = q / half, p2 = q % half;
      const int yy = y0 + r, xx = x0 + 2 * p2;
      const float v0 = pixel(yy, xx), v1 = pixel(yy, xx + 1);
      const float v2 = 2 * p2 + 2 < cols ? pixel(yy, xx + 2) : 0.f;
      pairs[r * pp + p2] = pack_bf16x2(v0, v1);  // round_bf16 of each
      pairs[(rows + r) * pp + p2] = pack_bf16x2(v1, v2);
    }
  } else {
    for (int q = threadIdx.x; q < rows * cols; q += kTileWarps * 32)
      region[(q / cols) * pitch + q % cols] = pixel(y0 + q / cols, x0 + q % cols);
  }
}

// Whether a tile whose reference rows span [ry0, ry1] and columns [rx0,
// rx1] can take some offset of part `pt` (a row of the parts table): some
// row plus some dy of the part in [cand_lo, cand_hi] and some column plus
// some dx in [0, last_c]. A part it cannot take is +inf for every block of
// the tile, so skipping it changes no result (+inf never passes phase 2's
// ballot, and a fill is index 0 whatever was visited).
__device__ __forceinline__ bool part_live(const int* __restrict__ pt, int ry0, int ry1, int rx0, int rx1,
                                          int cand_lo, int cand_hi, int last_c) {
  return ry0 + __ldg(pt + 2) <= cand_hi && ry1 + __ldg(pt + 3) >= cand_lo && rx0 + __ldg(pt + 4) <= last_c &&
         rx1 + __ldg(pt + 5) >= 0;
}

// The last of `n_parts` parts the tile takes (`part_live`), or -1, and
// then writes the whole tile's result: index 0 in every slot (each block
// fills its k with +inf candidates only, as `top_k_offsets_plain` does).
__device__ __forceinline__ int last_live_part(const int* __restrict__ parts, int n_parts, int ry0, int ry1, int rx0,
                                              int rx1, int cand_lo, int cand_hi, int last_c, int* out, int b,
                                              int nR, int nC, int r0, int c0, int nr, int nc, int K) {
  int last = n_parts - 1;
  while (last >= 0 && !part_live(parts + kPartCols * last, ry0, ry1, rx0, rx1, cand_lo, cand_hi, last_c)) --last;
  if (last < 0) {
    for (int q = threadIdx.x; q < nr * nc * K; q += kTileWarps * 32) {
      const int tb = q / K, bi = tb / nc, bj = tb - bi * nc;
      out[(((size_t)b * nR + r0 + bi) * nC + c0 + bj) * K + q % K] = 0;
    }
  }
  return last;
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

// Phase 2 at k 128 (kRankK: the tile and span kernels' four slots a lane),
// by ranks. `merge_chunk_warps<4>` inserted each candidate below the k-th
// entry in turn, 4 ballots, 8 shuffles and 8 selects each, every one
// waiting on the one before; at k 128 the first two chunks insert all their
// candidates and the k-th entry falls slowly, so ~450 insertions a block at
// 1,521 offsets. Here a block's running top-k is kept between chunks as
// 64-bit keys (distance bits << 32 | offset index, which order as the pairs
// do lexicographically; ~0 for an empty entry), [block][entry], entry e in
// lane e % 32, slot e / 32. A warp takes one block at a time: a ballot
// finds the chunk's candidates below the k-th entry (the survivors); each
// survivor's place in the merged list is the count of entries below it (a
// binary search of the list in shared memory) plus the count of survivors
// below it, and each entry's place is its own plus the survivors below it;
// one pass over the survivors, each broadcast to the warp, counts both, its
// steps independent of each other. Then every entry and survivor goes to
// its place at once (the list, or at the last chunk `out`); those past the
// k-th drop out. Keys are distinct (each offset is visited once), so the
// places are too, and the list after the last chunk is
// `top_k_offsets_plain`'s, whatever the visiting order: an entry still
// empty is written as index 0.
constexpr int kRankK = 128;
static_assert(kRankK == 1 << 7, "the binary search below takes 7 steps");

__device__ __forceinline__ void merge_chunk_ranks(const float* dist, unsigned long long* keys,
                                                  const int* __restrict__ order, int s0, int n_chunk,
                                                  int nt, int nc, bool last, int* out, int b, int nR, int nC,
                                                  int r0, int c0, int lane, int warp) {
  constexpr int KS = kRankK / 32, PER = kChunk / 32;
  int cs[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int c = lane + 32 * m;
    cs[m] = c < n_chunk ? __ldg(order + s0 + c) : 0;
  }
  for (int tb = warp; tb < nt; tb += kTileWarps) {
    unsigned long long* list = keys + (size_t)tb * kRankK;
    unsigned long long lk[KS];
#pragma unroll
    for (int q = 0; q < KS; ++q) lk[q] = list[lane + 32 * q];
    const unsigned long long kth = __shfl_sync(kAllLanes, lk[KS - 1], 31);
    unsigned long long ck[PER];
    unsigned below[PER];
    int n_below = 0;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int c = lane + 32 * m;
      const unsigned d = c < n_chunk ? __float_as_uint(dist[tb * kDPitch + c]) : kInfBits;
      ck[m] = (unsigned long long)d << 32 | (unsigned)cs[m];
      below[m] = __ballot_sync(kAllLanes, d != kInfBits && ck[m] < kth);
      n_below += __popc(below[m]);
    }
    if (n_below == 0 && !last) continue;
    // The survivors' places: the entries below each (a lower bound over the
    // list's kRankK sorted keys: the k-th is above every survivor) ...
    int place[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      int lo = 0;
      if ((below[m] >> lane) & 1u) {
#pragma unroll
        for (int lv = 6; lv >= 0; --lv) lo += list[lo + (1 << lv) - 1] < ck[m] ? 1 << lv : 0;  // kRankK = 2^7
      }
      place[m] = lo;
    }
    // ... and the survivors below each survivor and each entry.
    int shift[KS];
#pragma unroll
    for (int q = 0; q < KS; ++q) shift[q] = 0;
#pragma unroll
    for (int m2 = 0; m2 < PER; ++m2) {
      unsigned bits = below[m2];
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const unsigned long long c = __shfl_sync(kAllLanes, ck[m2], src);
#pragma unroll
        for (int q = 0; q < KS; ++q) shift[q] += c < lk[q];
#pragma unroll
        for (int m = 0; m < PER; ++m) place[m] += c < ck[m];
      }
    }
    __syncwarp();  // every lane's search has read the list
    const int bi = tb / nc, bj = tb - bi * nc;
    int* o = out + (((size_t)b * nR + r0 + bi) * nC + c0 + bj) * kRankK;
    auto put = [&](int at, unsigned long long key) {
      if (last)
        o[at] = (unsigned)(key >> 32) >= kInfBits ? 0 : (int)(unsigned)key;
      else
        list[at] = key;
    };
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int at = lane + 32 * q + shift[q];
      if (at < kRankK) put(at, lk[q]);
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      if (((below[m] >> lane) & 1u) && place[m] < kRankK) put(place[m], ck[m]);
    }
    __syncwarp();
  }
}

// The tile kernel's body: KS slots a lane merged by `merge_chunk_warps`
// (the lists [block][entry] for kTileMax blocks), or with RANKS (k 128)
// by `merge_chunk_ranks` (64-bit keys for `most` blocks, past the distance
// buffer's `most` rows). With PARTS the window comes in `n_parts` parts
// (`parts`, kPartCols ints each): the reference span is staged apart
// (`stage_reference`), and for each part the tile can take (`part_live`)
// its box of `part_rows` rows of `pitch` - 1 columns from (ry0 + dy0, rx0 +
// dx0), whose offsets' chunks then run as the whole window's do; `search`
// and `pitch` are the whole region's without.
template <int MODE, int KS, bool RANKS, bool PARTS = false>
__device__ __forceinline__ void tile_kernel_body(const float* __restrict__ img, const int* __restrict__ rows,
                                                 const int* __restrict__ cols, const int* __restrict__ offsets,
                                                 const int* __restrict__ order, const int* __restrict__ row_tiles,
                                                 const int* __restrict__ col_tiles, int* __restrict__ out, int H,
                                                 int W, int nR, int nC, int S, int K, int search, int pitch,
                                                 int cand_lo, int cand_hi, int most,
                                                 const int* __restrict__ parts = nullptr, int n_parts = 0,
                                                 int part_rows = 0) {
  extern __shared__ float smem[];
  const int reg_n = kTileSpan + 2 * search;  // the staged region's rows and columns (even)
  // The region as `stage_span_region` lays it out: f32 (modes 0, 2) or bf16 pairs (mode 1).
  float* region = PARTS ? smem + kRefWords : smem;
  unsigned* pairs = reinterpret_cast<unsigned*>(region);
  const int pp = PARTS ? ((pitch - 1) / 2) | 1 : (reg_n / 2) | 1;  // the pairs' row pitch in words (odd)
  const int lay_n = PARTS ? part_rows : reg_n;                       // the rows of one pairs layout
  const int region_words = PARTS ? kRefWords + part_rows * (pitch + 1) : reg_n * (pitch + 1);
  float* dist = smem + region_words;            // kTileMax (RANKS: most) x kDPitch, past either layout
  unsigned* list_k = reinterpret_cast<unsigned*>(dist + kTileMax * kDPitch);  // [block][entry]
  int* list_i = reinterpret_cast<int*>(list_k + kTileMax * K);
  unsigned long long* keys =  // RANKS: [block][entry], 8-byte aligned
      reinterpret_cast<unsigned long long*>(smem + ((region_words + most * kDPitch + 1) & ~1));
  const int r0 = row_tiles[3 * blockIdx.y], nr = row_tiles[3 * blockIdx.y + 1];
  const unsigned rmask = (unsigned)row_tiles[3 * blockIdx.y + 2];
  const int c0 = col_tiles[3 * blockIdx.x], nc = col_tiles[3 * blockIdx.x + 1];
  const unsigned cmask = (unsigned)col_tiles[3 * blockIdx.x + 2];
  const int b = blockIdx.z;
  const int ry0 = rows[r0], rx0 = cols[c0];
  int last_part = 0;  // PARTS: the last part this tile takes
  if constexpr (PARTS) {
    last_part = last_live_part(parts, n_parts, ry0, ry0 + 31 - __clz(rmask), rx0, rx0 + 31 - __clz(cmask), cand_lo,
                               cand_hi, W - kBlock, out, b, nR, nC, r0, c0, nr, nc, K);
    if (last_part < 0) return;
    stage_reference<MODE>(img + (size_t)b * H * W, H, W, ry0, rx0, smem);
  } else {
    stage_span_region<MODE>(img + (size_t)b * H * W, H, W, ry0, rx0, search, reg_n, pitch, pp, region,
                            pairs);
  }
  const int nt = nr * nc;
  for (int q = threadIdx.x; q < nt * K; q += kTileWarps * 32) {
    if constexpr (RANKS) {
      keys[q] = ~0ull;
    } else {
      list_k[q] = kInfBits;
      list_i[q] = 0x7fffffff;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inf = __int_as_float(kInfBits);
  // Lane y: region row y of the span; if it is a reference row, block row i.
  const bool ref_row = (rmask >> lane) & 1u;
  const int i = __popc(rmask & ((1u << lane) - 1u));
  // The lane's reference row: in the region (modes 0, 2), or staged apart.
  const float* ref_at = PARTS ? smem + lane * kRefPitch : region + (search + lane) * pitch + search;
  // Mode 1: the pair of columns (c, c + 1) of region row y is word c / 2 of
  // row y of layout c % 2.
  auto pair_at = [&](int y, int c) { return pairs + ((c & 1) * lay_n + y) * pp + (c >> 1); };
  const int last_c = W - kBlock;
  const int2* offs2 = reinterpret_cast<const int2*>(offsets);
  // The chunks of positions [s_begin, s_end) of the visiting order, the
  // offset (0, 0) of the span at row sy and column sx of the staged region;
  // with `writes` (the last part the tile takes), the last writes the result.
  auto chunks = [&](int s_begin, int s_end, bool writes, int sy, int sx) {
    const float* cand_at = PARTS ? region + (sy + lane) * pitch + sx : ref_at;
    for (int s0 = s_begin; s0 < s_end; s0 += kChunk) {  // positions in the visiting order
      const int n_chunk = min(kChunk, s_end - s0);
      // Phase 1: distances. The lane's reference row stays in registers for
      // the chunk (in mode 1 as bf16 pairs: half the registers, and one load
      // a candidate pair).
      float ref[MODE == 1 ? 1 : kTileSpan];
      unsigned ref2[MODE == 1 ? kTileSpan / 2 : 1];
#pragma unroll
      for (int xx = 0; xx < kTileSpan; xx += 2) {
        if (MODE == 1 && PARTS) {
          ref2[xx / 2] = reinterpret_cast<const unsigned*>(smem)[lane * kRefPairPitch + xx / 2];
        } else if (MODE == 1) {
          ref2[xx / 2] = pair_at(search + lane, search)[xx / 2];
        } else {
          ref[xx] = ref_at[xx];
          ref[xx + 1] = ref_at[xx + 1];
        }
      }
      for (int c = warp; c < n_chunk; c += kTileWarps) {
        const int2 o = __ldg(offs2 + s0 + c);
        const float* cand = cand_at + o.x * pitch + o.y;
        const unsigned* cand2 = pair_at(sy + lane + o.x, sx + o.y);
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
      const bool last = writes && s0 + kChunk >= s_end;
      if constexpr (RANKS)
        merge_chunk_ranks(dist, keys, order, s0, n_chunk, nt, nc, last, out, b, nR, nC, r0, c0, lane, warp);
      else
        merge_chunk_warps<KS>(dist, list_k, list_i, order, s0, n_chunk, S, K, nt, nc, last, out, b, nR, nC, r0,
                              c0, lane, warp);
      __syncthreads();
    }
  };
  if constexpr (PARTS) {
    const int ry1 = ry0 + 31 - __clz(rmask), rx1 = rx0 + 31 - __clz(cmask);  // the last reference row, column
    for (int q = 0; q <= last_part; ++q) {  // the parts nearest the window's centre first
      const int* pt = parts + kPartCols * q;
      if (!part_live(pt, ry0, ry1, rx0, rx1, cand_lo, cand_hi, last_c)) continue;
      const int first = __ldg(pt), dy0 = __ldg(pt + 2), dx0 = __ldg(pt + 4);
      stage_part_region<MODE>(img + (size_t)b * H * W, H, W, ry0 + dy0, rx0 + dx0, part_rows, pitch - 1, pitch, pp,
                              region, pairs);
      __syncthreads();
      chunks(first, first + __ldg(pt + 1), q == last_part, -dy0, -dx0);
    }
  } else {
    __syncthreads();
    chunks(0, S, true, search, search);
  }
}

// KS = 1, 2: k <= 32, 64; KS = 4: k 128, merged by ranks.
template <int MODE, int KS>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
bm3d_match_tile_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                       const int* __restrict__ cols, const int* __restrict__ offsets,
                       const int* __restrict__ order, const int* __restrict__ row_tiles,
                       const int* __restrict__ col_tiles,
                       int* __restrict__ out, int H, int W, int nR, int nC, int S, int K,
                       int search, int pitch, int cand_lo, int cand_hi, int most) {
  tile_kernel_body<MODE, KS, KS == 4>(img, rows, cols, offsets, order, row_tiles, col_tiles, out, H, W, nR, nC, S,
                                      K, search, pitch, cand_lo, cand_hi, most);
}

// The same kernel with the window staged in parts (k <= 64): the body's
// PARTS instantiation, so that the one-part calls keep their code.
template <int MODE, int KS>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
bm3d_match_tile_kernel_parts(const float* __restrict__ img, const int* __restrict__ rows,
                             const int* __restrict__ cols, const int* __restrict__ offsets,
                             const int* __restrict__ order, const int* __restrict__ row_tiles,
                             const int* __restrict__ col_tiles, int* __restrict__ out, int H, int W, int nR,
                             int nC, int S, int K, int pitch, int cand_lo, int cand_hi,
                             const int* __restrict__ parts, int n_parts, int part_rows) {
  tile_kernel_body<MODE, KS, false, true>(img, rows, cols, offsets, order, row_tiles, col_tiles, out, H, W, nR, nC,
                                          S, K, 0, pitch, cand_lo, cand_hi, kTileMax, parts, n_parts, part_rows);
}

// The design the rank merge replaced at k 128 (four slots a lane, each
// candidate inserted in turn, kTileMax blocks a tile): by name only.
template <int MODE>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
bm3d_match_tile_slots_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                             const int* __restrict__ cols, const int* __restrict__ offsets,
                             const int* __restrict__ order, const int* __restrict__ row_tiles,
                             const int* __restrict__ col_tiles, int* __restrict__ out, int H, int W, int nR,
                             int nC, int S, int K, int search, int pitch, int cand_lo, int cand_hi) {
  tile_kernel_body<MODE, 4, false>(img, rows, cols, offsets, order, row_tiles, col_tiles, out, H, W, nR, nC, S, K,
                                   search, pitch, cand_lo, cand_hi, kTileMax);
}

// Launches the kernel FN with `smem` bytes of dynamic shared memory, opting
// in above 48 KB once for each size it grows to.
template <auto FN, typename... A>
cudaError_t launch_granted(dim3 grid, size_t smem, cudaStream_t stream, A... args) {
  static size_t granted = 48 * 1024;  // dynamic shared memory opted into so far
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(FN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  FN<<<grid, kTileWarps * 32, smem, stream>>>(args...);
  return cudaGetLastError();
}

// One slot a lane for k <= 32, two for k <= 64, the rank merge at k 128;
// with `n_parts` parts (k <= 64), the window staged in parts.
template <int MODE>
cudaError_t launch_tile_mode(dim3 grid, size_t smem, cudaStream_t st, const float* img,
                             const int* rows, const int* cols, const int* offsets,
                             const int* order, const int* row_tiles, const int* col_tiles,
                             int* out, int H, int W, int nR, int nC, int S, int K, int search,
                             int pitch, int cand_lo, int cand_hi, int most, const int* parts, int n_parts,
                             int part_rows) {
  if (n_parts > 0 && K <= 32)
    return launch_granted<bm3d_match_tile_kernel_parts<MODE, 1>>(grid, smem, st, img, rows, cols, offsets, order,
                                                                 row_tiles, col_tiles, out, H, W, nR, nC, S, K,
                                                                 pitch, cand_lo, cand_hi, parts, n_parts, part_rows);
  if (n_parts > 0)
    return launch_granted<bm3d_match_tile_kernel_parts<MODE, 2>>(grid, smem, st, img, rows, cols, offsets, order,
                                                                 row_tiles, col_tiles, out, H, W, nR, nC, S, K,
                                                                 pitch, cand_lo, cand_hi, parts, n_parts, part_rows);
  if (K <= 32)
    return launch_granted<bm3d_match_tile_kernel<MODE, 1>>(grid, smem, st, img, rows, cols, offsets, order,
                                                           row_tiles, col_tiles, out, H, W, nR, nC, S, K, search,
                                                           pitch, cand_lo, cand_hi, most);
  if (K <= 64)
    return launch_granted<bm3d_match_tile_kernel<MODE, 2>>(grid, smem, st, img, rows, cols, offsets, order,
                                                           row_tiles, col_tiles, out, H, W, nR, nC, S, K, search,
                                                           pitch, cand_lo, cand_hi, most);
  return launch_granted<bm3d_match_tile_kernel<MODE, 4>>(grid, smem, st, img, rows, cols, offsets, order,
                                                         row_tiles, col_tiles, out, H, W, nR, nC, S, K, search,
                                                         pitch, cand_lo, cand_hi, most);
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
// bounds. Blocks 2-16 take this kernel; blocks 1 and 17-32 (up to the
// span: one tile row a lane) take `bm3d_match_span_rt_kernel`, the same
// structure with the block read at run time (`span_distances_tree`), and
// block 1 at k up to 8 `bm3d_match_pixel_kernel` (below). Bound as above: f32 arithmetic in the separable
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
//     the candidates below the k-th entry; at k 128 its rank merge
//     (`merge_chunk_ranks`). Each gives `top_k_offsets_plain`'s result:
//     ascending, ties to the lowest index, an entry still at +inf written
//     as index 0.
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
// rows. A window whose region would shrink the tiles (block 4 at search 40:
// 63 blocks, not 143) comes in parts, as the tile kernel's does
// (`bm3d_match_span_kernel_parts`), where the host's cost model finds the
// parts cheaper: the tiles keep a narrow window's blocks. The run-time blocks and the design they replaced live in kernels
// of their own (`PNP_SPAN_KERNEL` below): the tree at a run-time block needs
// more registers than the compiled cases, which keep their bits.

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
  // A window staged in parts: the reference span staged apart, and where
  // offset (0, 0) of the span's first row and column lies in a part's box.
  const float* ref = nullptr;
  int sy = 0, sx = 0;
};

// Phase 1 of the span kernel at block B: the distances of chunk positions
// [s0, s0 + n_chunk) into `dist`, a warp an offset. Mode 1 keeps the lane's
// reference row in registers as bf16 pairs; modes 0 and 2 read it from
// shared memory with each candidate row (32 more registers there spilled,
// and were slower at 5 of 6 rows: PERF.md). With PARTS the reference row is
// the one staged apart and the candidates a part's box.
template <bool PAIRS, int B, bool PARTS = false>
__device__ __forceinline__ void span_distances(const SpanTile& p, int s0, int n_chunk, int lane,
                                               int warp) {
  const float inf = __int_as_float(kInfBits);
  const float* ref_at = PARTS ? p.ref + lane * kRefPitch : p.region + (p.search + lane) * p.pitch + p.search;
  const float* cand_at = PARTS ? p.region + (p.sy + lane) * p.pitch + p.sx : ref_at;
  const int sy = PARTS ? p.sy : p.search, sx = PARTS ? p.sx : p.search;
  auto pair_at = [&](int y, int c) { return p.pairs + ((c & 1) * p.reg_n + y) * p.pp + (c >> 1); };
  unsigned ref2[PAIRS ? kTileSpan / 2 : 1];
  if constexpr (PAIRS) {
#pragma unroll
    for (int xx = 0; xx < kTileSpan; xx += 2) ref2[xx / 2] = PARTS ?
        reinterpret_cast<const unsigned*>(p.ref)[lane * kRefPairPitch + xx / 2] : pair_at(sy + lane, sx)[xx / 2];
  }
  for (int c = warp; c < n_chunk; c += kTileWarps) {
    const int2 o = __ldg(p.offsets + s0 + c);
    float t[kTileSpan], r[kTileSpan];
    if constexpr (PAIRS) {
      const unsigned* cand2 = pair_at(sy + lane + o.x, sx + o.y);
#pragma unroll
      for (int xx = 0; xx < kTileSpan; xx += 2)
        sq_terms2<1>(ref2[xx / 2], cand2[xx / 2], 0.f, 0.f, 0.f, 0.f, t[xx], t[xx + 1]);
    } else {
      const float* cand = cand_at + o.x * p.pitch + o.y;
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

// The lanes' sum of v over lanes y to y + 16 + rest - 1 (lanes past 31 read
// their own value) by `lane_window_sum`'s tree for the block 16 + rest (rest
// in [1, 16], read at run time): doubling sums to 16, the remainder gathered
// from its lowest bit up as the doubling passes each bit's width, each step
// behind a branch the whole warp takes.
__device__ __forceinline__ float lane_window_sum_rt(float v, int rest) {
  float r = 0.f;
#pragma unroll
  for (int lv = 0; lv < 4; ++lv) {  // width w = 2^lv (a level count, so the loop unrolls)
    const int w = 1 << lv;
    if (rest & w) r = (rest & (w - 1)) == 0 ? v : __fadd_rn(v, __shfl_down_sync(kAllLanes, r, w));
    v = __fadd_rn(v, __shfl_down_sync(kAllLanes, v, w));
  }
  if (rest == 16) r = v;
  return __fadd_rn(v, __shfl_down_sync(kAllLanes, r, 16));
}

// The 32-wide pairwise tree in place, widths W to 16: t[0] becomes the
// sum (template recursion, so every index is a constant).
template <int W = 1>
__device__ __forceinline__ void pairwise_sum(float (&t)[kTileSpan]) {
#pragma unroll
  for (int x = 0; x + W < kTileSpan; x += 2 * W) t[x] = __fadd_rn(t[x], t[x + W]);
  if constexpr (2 * W < kTileSpan) pairwise_sum<2 * W>(t);
}

// `row_window_sums` with the remainder `rest` (1-16) read at run time: t
// doubles in place to 16-wide sums; at width W, if bit W of rest is set, r
// (columns 16-31) gathers the W-wide sums ahead of the lower bits' (the
// lowest bit: r starts as t).
template <int W = 1>
__device__ __forceinline__ void row_sums_rt(float (&t)[kTileSpan], float (&r)[kTileSpan - 16], int rest) {
  if (rest & W) {
    const bool first = (rest & (W - 1)) == 0;
#pragma unroll
    for (int x = 16; x < kTileSpan; ++x) {
      if (x + W < kTileSpan)
        r[x - 16] = first ? t[x] : __fadd_rn(t[x], r[x - 16 + W]);
      else if (first)
        r[x - 16] = t[x];
    }
  }
  if constexpr (W < 16) {
#pragma unroll
    for (int x = 0; x + W < kTileSpan; ++x) t[x] = __fadd_rn(t[x], t[x + W]);
    row_sums_rt<2 * W>(t, r, rest);
  }
}

// Phase 1 at a block of 17-32 read at run time, by the compiled blocks'
// tree (`row_window_sums`, `lane_window_sum`): 16 is every such block's
// largest part (32 = 16 + 16), so the doubling to 16 is straight-line code
// and only the remainder rest = block - 16 follows its bits at run time.
// Along the row, a tile with one reference column (the span's first, as
// every tile past step 32 - block has) takes the tree over the span's 32
// terms with those past the block added as 0, which leaves every partial
// sum as it is: 15 selects and 31 adds, depth 5. A tile with more columns
// doubles every column position to 16 in place and gathers the remainder
// in a second row of registers (columns 16-31) by its bits, lowest first;
// each column's sum is then its 16-wide sum plus the remainder 16 columns on.
// Down the lanes, `lane_window_sum_rt`. The same adds in the same order as
// the compiled tree of the block would make (the numpy model in
// tests/test_torch_k1_span.py), f32, no FMA.
// The lane's kTileSpan terms against the candidate row at offset o, as
// `span_distances` forms them (mode 1 from the bf16 pairs `ref2`); the
// pairs of columns past both 16 and `cols` (the columns a caller reads)
// are 0, not formed.
template <bool PAIRS, typename Ref>  // Ref: the pairs in registers, or a pointer into shared memory
__device__ __forceinline__ void span_terms(const SpanTile& p, const Ref& ref2, const float* ref_at, int2 o,
                                           int lane, int cols, float (&t)[kTileSpan]) {
  const unsigned* cand2 = p.pairs + (((p.search + o.y) & 1) * p.reg_n + p.search + lane + o.x) * p.pp +
                          ((p.search + o.y) >> 1);
  const float* cand = ref_at + o.x * p.pitch + o.y;
#pragma unroll
  for (int xx = 0; xx < kTileSpan; xx += 2) {
    if (xx >= 16 && xx >= cols)
      t[xx] = t[xx + 1] = 0.f;
    else if constexpr (PAIRS)
      sq_terms2<1>(ref2[xx / 2], cand2[xx / 2], 0.f, 0.f, 0.f, 0.f, t[xx], t[xx + 1]);
    else if (p.round_sq)
      sq_terms2<2>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx], cand[xx + 1], t[xx], t[xx + 1]);
    else
      sq_terms2<0>(0u, 0u, ref_at[xx], ref_at[xx + 1], cand[xx], cand[xx + 1], t[xx], t[xx + 1]);
  }
}

template <bool PAIRS>
__device__ __forceinline__ void span_distances_tree(const SpanTile& p, int block, int s0, int n_chunk, int lane,
                                                    int warp) {
  const float inf = __int_as_float(kInfBits);
  const int rest = block - 16;
  const bool one_col = p.cmask == 1u;
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
    const int cy = p.ry0 + lane + o.x;
    const bool row_ok = p.ref_row && cy >= p.cand_lo && cy <= p.cand_hi;
    if (one_col) {
      span_terms<PAIRS>(p, ref2, ref_at, o, lane, block, t);
#pragma unroll
      for (int x = 17; x < kTileSpan; x += 2) t[x] = x < block ? t[x] : 0.f;  // a pair the block's edge splits
      pairwise_sum(t);
      const float v = lane_window_sum_rt(t[0], rest);
      const int cx = p.rx0 + o.y;
      if (p.ref_row) p.dist[p.i * p.nc * kDPitch + c] = row_ok && cx >= 0 && cx <= p.last_c ? v : inf;
    } else {
      span_terms<PAIRS>(p, ref2, ref_at, o, lane, kTileSpan, t);  // every column: no branch
      float r[kTileSpan - 16];  // the remainder's sums from columns 16-31
      row_sums_rt(t, r, rest);
#pragma unroll
      for (int xx = 0; xx < 16; ++xx) {
        if (xx + block <= kTileSpan && ((p.cmask >> xx) & 1u)) {
          const float v = lane_window_sum_rt(__fadd_rn(t[xx], r[xx]), rest);
          const int j = __popc(p.cmask & ((1u << xx) - 1u));
          const int cx = p.rx0 + xx + o.y;
          if (p.ref_row) p.dist[(p.i * p.nc + j) * kDPitch + c] = row_ok && cx >= 0 && cx <= p.last_c ? v : inf;
        }
      }
    }
  }
}

// A tile of one block at a block of 17-32 (one reference row and column:
// every tile of a step past 32 - block) with k <= 32, in place of the
// chunks: a chunk's phase 2 there is one warp merging while the other seven
// wait at the barrier. Each warp walks its offsets (c = warp, warp + 8, ...)
// over the whole window, kOneInFlight at a time (independent chains the
// warp interleaves), and keeps their running top-k itself, one 64-bit key
// (distance bits << 32 | offset index) a lane, sorted across the lanes. The
// block's distance: the row's masked 32-wide tree (only the term pairs that
// reach into the block are formed), then the lanes' by a butterfly over
// the lanes with those past the block as 0, the same pairwise tree (each
// add's operands in either order), so every lane holds it. One below the
// k-th key enters by a ballot for its place and one shuffle of the keys
// after it. After the last offset the eight lists go to shared memory
// (over the staged region) and warp 0 takes k rounds of a warp argmin over
// their 256 keys: `top_k_offsets_plain`'s result, as the chunked path
// gives, with no distance buffer, one barrier pair in all and every warp
// busy.
constexpr int kOneInFlight = 2;

template <bool PAIRS>
__device__ __forceinline__ void span_one_block_rt(const SpanTile& p, int block, int S, int K,
                                                  const int* __restrict__ order, float* smem, int* out, int lane,
                                                  int warp) {
  const float* ref_at = p.region + (p.search + lane) * p.pitch + p.search;
  unsigned ref2[PAIRS ? kTileSpan / 2 : 1];
  if constexpr (PAIRS) {
#pragma unroll
    for (int xx = 0; xx < kTileSpan; xx += 2)
      ref2[xx / 2] = p.pairs[((p.search & 1) * p.reg_n + p.search + lane) * p.pp + (p.search >> 1) + xx / 2];
  }
  const bool in_block = lane < block;
  unsigned long long mine = ~0ull, kth = ~0ull;  // this lane's entry of the warp's list, and entry K - 1
  for (int c0 = warp; c0 < S; c0 += kTileWarps * kOneInFlight) {
    float v[kOneInFlight];
    int2 o[kOneInFlight];
#pragma unroll
    for (int f = 0; f < kOneInFlight; ++f) {
      o[f] = __ldg(p.offsets + min(c0 + f * kTileWarps, S - 1));
      float t[kTileSpan];
      span_terms<PAIRS>(p, ref2, ref_at, o[f], lane, block, t);
#pragma unroll
      for (int x = 17; x < kTileSpan; x += 2) t[x] = x < block ? t[x] : 0.f;  // a pair the block's edge splits
      pairwise_sum(t);
      v[f] = in_block ? t[0] : 0.f;
    }
#pragma unroll
    for (int w = 1; w < 32; w *= 2) {  // the butterfly: every lane gets lane 0's pairwise tree
#pragma unroll
      for (int f = 0; f < kOneInFlight; ++f) v[f] = __fadd_rn(v[f], __shfl_xor_sync(kAllLanes, v[f], w));
    }
#pragma unroll
    for (int f = 0; f < kOneInFlight; ++f) {
      const int c = c0 + f * kTileWarps;
      const int cy = p.ry0 + o[f].x, cx = p.rx0 + o[f].y;
      if (c >= S || cy < p.cand_lo || cy > p.cand_hi || cx < 0 || cx > p.last_c) continue;  // the whole warp
      const unsigned long long key = (unsigned long long)__float_as_uint(v[f]) << 32 | (unsigned)__ldg(order + c);
      if (key < kth) {
        const int at = __popc(__ballot_sync(kAllLanes, mine < key));
        const unsigned long long up = __shfl_up_sync(kAllLanes, mine, 1);
        mine = lane > at ? up : lane == at ? key : mine;
        kth = __shfl_sync(kAllLanes, mine, K - 1);
      }
    }
  }
  __syncthreads();  // every warp is done with the region
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem);  // [warp][lane]
  lists[warp * 32 + lane] = mine;
  __syncthreads();
  if (warp != 0) return;
  unsigned long long v[kTileWarps];
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) v[w] = lists[w * 32 + lane];
  unsigned long long res = ~0ull;
#pragma unroll 1
  for (int e = 0; e < K; ++e) {
    unsigned long long best = v[0];
#pragma unroll
    for (int w = 1; w < kTileWarps; ++w) best = v[w] < best ? v[w] : best;
    const unsigned hi = __reduce_min_sync(kAllLanes, (unsigned)(best >> 32));
    const unsigned lo = __reduce_min_sync(kAllLanes, (unsigned)(best >> 32) == hi ? (unsigned)best : ~0u);
    const unsigned long long win = (unsigned long long)hi << 32 | lo;
    res = lane == e ? win : res;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) v[w] = v[w] == win ? ~0ull : v[w];
  }
  if (lane < K) out[lane] = res == ~0ull ? 0 : (int)(unsigned)res;
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
// region (`region_words`), the distance buffer and the chunk's offset indices.
__host__ __device__ inline int span_lists_past(int region_words, int most) {
  return (region_words + most * kDPitch + kChunk + 1) & ~1;
}

// The same for the whole window's region at `search`.
__host__ __device__ inline int span_lists_at(int search, int pitch, int most) {
  return span_lists_past((kTileSpan + 2 * search) * (pitch + 1), most);
}

// The span kernels' phase 1 and phase 2 forms (`span_kernel_body`):
// compiled blocks 2-16 with the rank merge at k 128 (`bm3d_match_span_kernel`),
// the tree at a run-time block 17-32 or block 1 compiled, with the rank merge
// (`bm3d_match_span_rt_kernel`), and the design those replaced, the serial
// run-time phase 1 and the four-slot merge (`bm3d_match_span_serial_kernel`).
enum SpanForm { kSpanCompiled, kSpanRunTime, kSpanSerial };

template <bool PAIRS, SpanForm FORM, bool PARTS = false>
__device__ __forceinline__ void span_kernel_body(const float* __restrict__ img, const int* __restrict__ rows,
                                                 const int* __restrict__ cols, const int* __restrict__ offsets,
                                                 const int* __restrict__ order, const int* __restrict__ row_tiles,
                                                 const int* __restrict__ col_tiles, int* __restrict__ out, int H,
                                                 int W, int nR, int nC, int S, int K, int block, bool round_sq,
                                                 int search, int pitch, int most, int cand_lo, int cand_hi,
                                                 const int* __restrict__ parts = nullptr, int n_parts = 0,
                                                 int part_rows = 0) {
  constexpr bool kRanks = FORM != kSpanSerial;  // k 128 by `merge_chunk_ranks`
  extern __shared__ float smem[];
  const int reg_n = kTileSpan + 2 * search;  // the staged region's rows and columns (even)
  // PARTS: the reference span staged apart (kRefWords), then a part's box.
  float* region = PARTS ? smem + kRefWords : smem;
  unsigned* pairs = reinterpret_cast<unsigned*>(region);
  const int pp = PARTS ? ((pitch - 1) / 2) | 1 : (reg_n / 2) | 1;   // the pairs' row pitch (odd)
  const int region_words = PARTS ? kRefWords + part_rows * (pitch + 1) : reg_n * (pitch + 1);
  float* dist = smem + region_words;                                 // most x kDPitch
  int* chunk_order = reinterpret_cast<int*>(dist + most * kDPitch);  // kChunk
  float* lists = smem + span_lists_past(region_words, most);
  unsigned long long* list = reinterpret_cast<unsigned long long*>(lists);  // k <= 8: [entry][most]
  unsigned long long* keys = list;                                          // k 128, ranks: [block][entry]
  unsigned* list_k = reinterpret_cast<unsigned*>(lists);                    // else [block][entry]
  int* list_i = reinterpret_cast<int*>(list_k + most * K);
  const int r0 = row_tiles[3 * blockIdx.y], nr = row_tiles[3 * blockIdx.y + 1];
  const unsigned rmask = (unsigned)row_tiles[3 * blockIdx.y + 2];
  const int c0 = col_tiles[3 * blockIdx.x], nc = col_tiles[3 * blockIdx.x + 1];
  const unsigned cmask = (unsigned)col_tiles[3 * blockIdx.x + 2];
  const int b = blockIdx.z;
  const int ry0 = rows[r0], rx0 = cols[c0];
  int last_part = 0;  // PARTS: the last part this tile takes
  if constexpr (PARTS) {
    last_part = last_live_part(parts, n_parts, ry0, ry0 + 31 - __clz(rmask), rx0, rx0 + 31 - __clz(cmask), cand_lo,
                               cand_hi, W - block, out, b, nR, nC, r0, c0, nr, nc, K);
    if (last_part < 0) return;
    stage_reference<PAIRS ? 1 : 0>(img + (size_t)b * H * W, H, W, ry0, rx0, smem);
  } else {
    stage_span_region<PAIRS ? 1 : 0>(img + (size_t)b * H * W, H, W, ry0, rx0, search, reg_n, pitch, pp,
                                     region, pairs);
  }
  const int nt = nr * nc;
  const bool by_threads = K <= 8;
  const bool by_ranks = kRanks && K > 64;
  if (by_threads) {
    for (int q = threadIdx.x; q < span_entries(K) * most; q += kTileWarps * 32) list[q] = ~0ull;
  } else if (by_ranks) {
    for (int q = threadIdx.x; q < nt * K; q += kTileWarps * 32) keys[q] = ~0ull;
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
  if constexpr (FORM == kSpanRunTime) {
    if (block > 16 && nt == 1 && K <= 32) {  // a tile of one block: no chunks
      __syncthreads();
      span_one_block_rt<PAIRS>(tile, block, S, K, order, smem, out + (((size_t)b * nR + r0) * nC + c0) * K, lane,
                               warp);
      return;
    }
  }
  // The chunks of positions [s_begin, s_end) of the visiting order on the
  // staged region `p`; with `writes` (the last part the tile takes), the
  // last writes the result.
  auto chunks = [&](int s_begin, int s_end, bool writes, const SpanTile& p) {
    for (int s0 = s_begin; s0 < s_end; s0 += kChunk) {  // positions in the visiting order
      const int n_chunk = min(kChunk, s_end - s0);
      if (by_threads && (int)threadIdx.x < n_chunk) chunk_order[threadIdx.x] = __ldg(order + s0 + threadIdx.x);
      __syncthreads();
      if constexpr (FORM == kSpanRunTime) {  // phase 1: distances
        if (block == 1)
          span_distances<PAIRS, 1>(p, s0, n_chunk, lane, warp);
        else
          span_distances_tree<PAIRS>(p, block, s0, n_chunk, lane, warp);
      } else {
        switch (block) {
#define PNP_SPAN_BLOCK(B) \
  case B:                 \
    span_distances<PAIRS, B, PARTS>(p, s0, n_chunk, lane, warp); \
    break;
          PNP_SPAN_BLOCK(2) PNP_SPAN_BLOCK(3) PNP_SPAN_BLOCK(4) PNP_SPAN_BLOCK(5) PNP_SPAN_BLOCK(6)
          PNP_SPAN_BLOCK(7) PNP_SPAN_BLOCK(9) PNP_SPAN_BLOCK(10) PNP_SPAN_BLOCK(11) PNP_SPAN_BLOCK(12)
          PNP_SPAN_BLOCK(13) PNP_SPAN_BLOCK(14) PNP_SPAN_BLOCK(15) PNP_SPAN_BLOCK(16)
#undef PNP_SPAN_BLOCK
          default:  // 1 and 17-32 (the serial design; the host sends them nowhere else)
            if constexpr (FORM == kSpanSerial) span_distances_rt<PAIRS>(p, block, s0, n_chunk, lane, warp);
        }
      }
      __syncthreads();

      // Phase 2: the chunk into the blocks' running top-k.
      const bool last = writes && s0 + kChunk >= s_end;
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
      else if constexpr (kRanks)
        merge_chunk_ranks(dist, keys, order, s0, n_chunk, nt, nc, last, out, b, nR, nC, r0, c0, lane, warp);
      else
        merge_chunk_warps<4>(dist, list_k, list_i, order, s0, n_chunk, S, K, nt, nc, last, out, b, nR, nC, r0,
                             c0, lane, warp);
      __syncthreads();
    }
  };
  if constexpr (PARTS) {
    const int ry1 = ry0 + 31 - __clz(rmask), rx1 = rx0 + 31 - __clz(cmask);
    for (int q = 0; q <= last_part; ++q) {  // the parts nearest the window's centre first
      const int* pt = parts + kPartCols * q;
      if (!part_live(pt, ry0, ry1, rx0, rx1, cand_lo, cand_hi, W - block)) continue;
      const int first = __ldg(pt), dy0 = __ldg(pt + 2), dx0 = __ldg(pt + 4);
      stage_part_region<PAIRS ? 1 : 0>(img + (size_t)b * H * W, H, W, ry0 + dy0, rx0 + dx0, part_rows, pitch - 1,
                                       pitch, pp, region, pairs);
      SpanTile part = tile;  // its box: the pairs' layouts part_rows rows each
      part.reg_n = part_rows;
      part.ref = smem;
      part.sy = -dy0;
      part.sx = -dx0;
      chunks(first, first + __ldg(pt + 1), q == last_part, part);  // its first barrier follows the staging
    }
  } else {
    chunks(0, S, true, tile);
  }
}

// CTAs an SM the run-time kernel's registers allow (launch bounds).
constexpr int kRtMinCtas = 3;
#define PNP_SPAN_KERNEL(NAME, FORM, CTAS)                                                                      \
  template <bool PAIRS>                                                                                        \
  __global__ void __launch_bounds__(kTileWarps * 32, CTAS)                                                     \
  NAME(const float* __restrict__ img, const int* __restrict__ rows, const int* __restrict__ cols,              \
       const int* __restrict__ offsets, const int* __restrict__ order, const int* __restrict__ row_tiles,      \
       const int* __restrict__ col_tiles, int* __restrict__ out, int H, int W, int nR, int nC, int S, int K,   \
       int block, bool round_sq, int search, int pitch, int most, int cand_lo, int cand_hi) {                  \
    span_kernel_body<PAIRS, FORM>(img, rows, cols, offsets, order, row_tiles, col_tiles, out, H, W, nR, nC, S, \
                                  K, block, round_sq, search, pitch, most, cand_lo, cand_hi);                  \
  }
PNP_SPAN_KERNEL(bm3d_match_span_kernel, kSpanCompiled, 3)
PNP_SPAN_KERNEL(bm3d_match_span_rt_kernel, kSpanRunTime, kRtMinCtas)
PNP_SPAN_KERNEL(bm3d_match_span_serial_kernel, kSpanSerial, 3)
#undef PNP_SPAN_KERNEL

// The span kernel with the window staged in parts: the body's PARTS
// instantiation, so that the one-part calls keep their code.
template <bool PAIRS>
__global__ void __launch_bounds__(kTileWarps * 32, 3)
bm3d_match_span_kernel_parts(const float* __restrict__ img, const int* __restrict__ rows,
                             const int* __restrict__ cols, const int* __restrict__ offsets,
                             const int* __restrict__ order, const int* __restrict__ row_tiles,
                             const int* __restrict__ col_tiles, int* __restrict__ out, int H, int W, int nR, int nC,
                             int S, int K, int block, bool round_sq, int pitch, int most, int cand_lo, int cand_hi,
                             const int* __restrict__ parts, int n_parts, int part_rows) {
  span_kernel_body<PAIRS, kSpanCompiled, true>(img, rows, cols, offsets, order, row_tiles, col_tiles, out, H, W, nR,
                                               nC, S, K, block, round_sq, 0, pitch, most, cand_lo, cand_hi, parts,
                                               n_parts, part_rows);
}

// ---- Block 1 at k <= 8: `bm3d_match_pixel_kernel` ------------------------
//
// At block 1 a distance is one term, so the span kernel's structure wastes
// most of its work there: a warp formed the 32 x 32 terms of a span for
// each offset, of which a tile of at most 256 blocks (16 x 16 at step 1)
// used a quarter, wrote each to the distance buffer and merged it a chunk
// at a time. Here a thread takes one reference pixel of the tile (the span
// kernel's plans, at most a block a thread) and walks every offset in the
// visiting order: one term, rounded as `sq_term` says (the region staged
// as f32, rounded to bf16 in mode 1), checked against the image and the row
// bounds, and kept in the thread's KL least keys (sorted 64-bit keys in
// registers, `merge_chunk_threads`' compare-exchange chain), with no
// distance buffer and no barrier after the staging. A distance is a single
// rounded term, so the result is `top_k_offsets_plain`'s bit for bit in
// every mode. Bound: the image read once (bytes), or one sub, mul and
// compare a (pixel, offset).
template <int MODE, int KL>
__global__ void __launch_bounds__(kTileWarps * 32)
bm3d_match_pixel_kernel(const float* __restrict__ img, const int* __restrict__ rows,
                        const int* __restrict__ cols, const int* __restrict__ offsets,
                        const int* __restrict__ order, const int* __restrict__ row_tiles,
                        const int* __restrict__ col_tiles, int* __restrict__ out, int H, int W, int nR, int nC,
                        int S, int K, int search, int pitch, int cand_lo, int cand_hi) {
  extern __shared__ float region[];  // reg_n x pitch
  const int reg_n = kTileSpan + 2 * search;
  const int r0 = row_tiles[3 * blockIdx.y], nr = row_tiles[3 * blockIdx.y + 1];
  const int c0 = col_tiles[3 * blockIdx.x], nc = col_tiles[3 * blockIdx.x + 1];
  const int b = blockIdx.z;
  const int ry0 = rows[r0], rx0 = cols[c0];
  const float* x = img + (size_t)b * H * W;
  for (int q = threadIdx.x; q < reg_n * reg_n; q += kTileWarps * 32) {
    const int yy = ry0 - search + q / reg_n, xx = rx0 - search + q % reg_n;
    float v = yy >= 0 && yy < H && xx >= 0 && xx < W ? x[yy * W + xx] : 0.f;
    if (MODE == 1) v = round_bf16(v);
    region[(q / reg_n) * pitch + q % reg_n] = v;
  }
  __syncthreads();
  const int tb = threadIdx.x;
  if (tb >= nr * nc) return;
  const int bi = tb / nc, bj = tb - bi * nc;
  const int ry = rows[r0 + bi], rx = cols[c0 + bj];
  const float* ref = region + (ry - ry0 + search) * pitch + rx - rx0 + search;
  const float r = *ref;
  const int2* offs2 = reinterpret_cast<const int2*>(offsets);
  unsigned long long l[KL];
#pragma unroll
  for (int e = 0; e < KL; ++e) l[e] = ~0ull;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const int2 o = __ldg(offs2 + s);
    const int cy = ry + o.x, cx = rx + o.y;
    if (cy < cand_lo || cy > cand_hi || cx < 0 || cx >= W) continue;
    unsigned long long v =
        (unsigned long long)__float_as_uint(sq_term<MODE>(r, ref[o.x * pitch + o.y])) << 32 | (unsigned)__ldg(order + s);
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
  int* o = out + (((size_t)b * nR + r0 + bi) * nC + c0 + bj) * K;
#pragma unroll
  for (int e = 0; e < KL; ++e) {
    if (e < K) o[e] = l[e] == ~0ull ? 0 : (int)(unsigned)l[e];
  }
}

// The span kernels' entries share their arguments: those of the tile
// kernel, with `block_size` the block and `most` the blocks a tile holds at
// most (in [1, 256]; the plans' rows' count times the columns' at most
// that), on a strictly ascending reference grid, k a power of two in [1,
// 128] and any window whose tile fits shared memory. FORM's kernel takes
// the blocks `span_takes` lets through; only `bm3d_match_span_launch`
// takes a window in parts (`n_parts` > 0, as the tile kernel's entry
// does). Each returns the launch's cudaError_t.
enum SpanEntry { kEntryCompiled, kEntryRunTime, kEntrySerial, kEntryPixel };

__host__ inline bool span_takes(SpanEntry form, int block, int K) {
  switch (form) {
    case kEntryCompiled: return block >= 2 && block <= 16 && block != kBlock;
    case kEntryRunTime: return block == 1 || block >= 17;
    case kEntrySerial: return block != kBlock;
    default: return block == 1 && K <= 8;
  }
}

// The kernel of a form, bf16 pairs (mode 1) or f32 (modes 0, 2); only the
// forms a source's entries launch are instantiated.
template <SpanEntry FORM, bool PAIRS>
constexpr auto span_kernel_of() {
  if constexpr (FORM == kEntryCompiled)
    return &bm3d_match_span_kernel<PAIRS>;
  else if constexpr (FORM == kEntryRunTime)
    return &bm3d_match_span_rt_kernel<PAIRS>;
  else
    return &bm3d_match_span_serial_kernel<PAIRS>;
}

template <SpanEntry FORM>
int span_entry(const float* img, const int* rows, const int* cols, const int* offsets, const int* order,
               const int* row_tiles, const int* col_tiles, int* out, const int* parts, int B, int H, int W, int nR,
               int nC, int n_row_tiles, int n_col_tiles, int S, int block_size, int K, int mode, int search,
               int pitch, int most, int cand_lo, int cand_hi, int n_parts, int part_rows, void* stream) {
  if (block_size < kSpanMinBlock || block_size > kSpanMaxBlock || !span_takes(FORM, block_size, K) || K < 1 ||
      K > kSpanMaxK || (K & (K - 1)) != 0 || S < 1 || mode < 0 || mode > 2 || search < 0 ||
      pitch < (n_parts > 0 ? kTileSpan + 1 : kTileSpan + 2 * search) || n_row_tiles < 1 || n_col_tiles < 1 ||
      most < 1 || most > kTileWarps * 32 || cand_lo < 0 || cand_hi > H - block_size || n_parts < 0 ||
      (n_parts > 0 && (FORM != kEntryCompiled || parts == nullptr || part_rows < kTileSpan || pitch % 2 == 0)))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid(n_col_tiles, n_row_tiles, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (FORM == kEntryCompiled) {
    if (n_parts > 0) {
      const size_t smem = sizeof(float) * span_lists_past(kRefWords + part_rows * (pitch + 1), most) +
                          sizeof(unsigned long long) * most * span_entries(K);
      if (mode == 1)
        return launch_granted<bm3d_match_span_kernel_parts<true>>(grid, smem, st, img, rows, cols, offsets, order,
                                                                  row_tiles, col_tiles, out, H, W, nR, nC, S, K,
                                                                  block_size, false, pitch, most, cand_lo, cand_hi,
                                                                  parts, n_parts, part_rows);
      return launch_granted<bm3d_match_span_kernel_parts<false>>(grid, smem, st, img, rows, cols, offsets, order,
                                                                 row_tiles, col_tiles, out, H, W, nR, nC, S, K,
                                                                 block_size, mode == 2, pitch, most, cand_lo,
                                                                 cand_hi, parts, n_parts, part_rows);
    }
  }
  if constexpr (FORM == kEntryPixel) {
    const size_t smem = sizeof(float) * (size_t)(kTileSpan + 2 * search) * pitch;
#define PNP_PIXEL(M, KL)                                                                                        \
  if (mode == M && K <= KL)                                                                                     \
    return launch_granted<bm3d_match_pixel_kernel<M, KL>>(grid, smem, st, img, rows, cols, offsets, order,      \
                                                          row_tiles, col_tiles, out, H, W, nR, nC, S, K, search, \
                                                          pitch, cand_lo, cand_hi);
    PNP_PIXEL(0, 4) PNP_PIXEL(0, 8) PNP_PIXEL(1, 4) PNP_PIXEL(1, 8) PNP_PIXEL(2, 4) PNP_PIXEL(2, 8)
#undef PNP_PIXEL
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = sizeof(float) * span_lists_at(search, pitch, most) +
                        sizeof(unsigned long long) * most * span_entries(K);
    if (mode == 1)
      return launch_granted<span_kernel_of<FORM, true>()>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                                                      col_tiles, out, H, W, nR, nC, S, K, block_size, false, search,
                                                      pitch, most, cand_lo, cand_hi);
    return launch_granted<span_kernel_of<FORM, false>()>(grid, smem, st, img, rows, cols, offsets, order, row_tiles,
                                                  col_tiles, out, H, W, nR, nC, S, K, block_size, mode == 2, search,
                                                  pitch, most, cand_lo, cand_hi);
  }
}

}  // namespace

#define PNP_SPAN_ENTRY(NAME, FORM)                                                                              \
  extern "C" int NAME(const float* img, const int* rows, const int* cols, const int* offsets, const int* order, \
                      const int* row_tiles, const int* col_tiles, int* out, const int* parts, int B, int H, int W, \
                      int nR, int nC, int n_row_tiles, int n_col_tiles, int S, int block_size, int K, int mode,    \
                      int search, int pitch, int most, int cand_lo, int cand_hi, int n_parts, int part_rows,      \
                      void* stream) {                                                                             \
    return span_entry<FORM>(img, rows, cols, offsets, order, row_tiles, col_tiles, out, parts, B, H, W, nR, nC,  \
                            n_row_tiles, n_col_tiles, S, block_size, K, mode, search, pitch, most, cand_lo,       \
                            cand_hi, n_parts, part_rows, stream);                                                 \
  }
#ifndef PNP_K1_REPLACED_DESIGNS  // the kernels K1's calls take

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

// Block 8 at any strictly ascending reference grid, k a power of two in
// [1, 128] and any window whose region fits shared memory (the host's
// reckoning): `offsets` (S, 2) in the order the kernel visits
// them and `order` (S,) the index of each in the window's ascending order
// (the index a match returns), `row_tiles` (n_row_tiles, 3) / `col_tiles`
// (n_col_tiles, 3) int32, each tile's first index into `rows` / `cols`, its
// count and the mask of its coordinates less the first (bits 0-24; the
// rows' count times the columns' at most `most`). `pitch` (odd, at least
// kTileSpan + 2 search) is the staged region's row pitch. `most` (in [1,
// kTileMax]) lays out the rank merge's shared memory at k 128; below it is
// kTileMax. With `n_parts` > 0 (k <= 64) the window comes in parts:
// `parts` (n_parts, kPartCols) int32, each part's offsets together in
// `offsets` / `order`, and `part_rows` x (`pitch` - 1) (odd `pitch`) the box
// a part stages. The rest as above. Returns the launch's cudaError_t.
extern "C" int bm3d_match_tile_launch(const float* img, const int* rows, const int* cols,
                                      const int* offsets, const int* order, const int* row_tiles,
                                      const int* col_tiles, int* out, const int* parts, int B, int H, int W,
                                      int nR, int nC, int n_row_tiles, int n_col_tiles, int S,
                                      int block_size, int K, int mode, int search, int pitch,
                                      int most, int cand_lo, int cand_hi, int n_parts, int part_rows,
                                      void* stream) {
  if (block_size != kBlock || K < 1 || K > kSpanMaxK || (K > 64 && K != kRankK) || S < 1 || search < 0 ||
      pitch < (n_parts > 0 ? kTileSpan + 1 : kTileSpan + 2 * search) || n_row_tiles < 1 || n_col_tiles < 1 ||
      most < 1 || most > kTileMax || (K <= 64 && most != kTileMax) || cand_lo < 0 || cand_hi > H - kBlock ||
      n_parts < 0 || (n_parts > 0 && (K > 64 || parts == nullptr || part_rows < kTileSpan || pitch % 2 == 0)))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid(n_col_tiles, n_row_tiles, B);
  const size_t region = n_parts > 0 ? (size_t)kRefWords + (size_t)part_rows * (pitch + 1)
                                    : (size_t)(kTileSpan + 2 * search) * (pitch + 1);
  const size_t smem = K > 64 ? sizeof(float) * ((region + (size_t)most * kDPitch + 1) & ~(size_t)1) +
                                   sizeof(unsigned long long) * most * K
                             : sizeof(float) * (region + (size_t)kTileMax * kDPitch) + 2 * sizeof(int) * kTileMax * K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define PNP_TILE_MODE(M)                                                                                       \
  case M:                                                                                                      \
    return launch_tile_mode<M>(grid, smem, st, img, rows, cols, offsets, order, row_tiles, col_tiles, out, H, W, \
                               nR, nC, S, K, search, pitch, cand_lo, cand_hi, most, parts, n_parts, part_rows);
    PNP_TILE_MODE(0) PNP_TILE_MODE(1) PNP_TILE_MODE(2)
#undef PNP_TILE_MODE
    default:
      return cudaErrorInvalidValue;
  }
}

// Blocks 2-16 but 8.
PNP_SPAN_ENTRY(bm3d_match_span_launch, kEntryCompiled)
// Blocks 1 and 17-32.
PNP_SPAN_ENTRY(bm3d_match_span_rt_launch, kEntryRunTime)
// Block 1 at k <= 8.
PNP_SPAN_ENTRY(bm3d_match_pixel_launch, kEntryPixel)
#else  // the designs they replaced (csrc/bm3d_match_replaced.cu)

// The tile kernel's design at k 128 before the rank merge (the four-slot
// merge, kTileMax blocks a tile): the tile kernel's arguments without
// `most`, k 128 only. Launched by name only, to time the two on one call.
extern "C" int bm3d_match_tile_slots_launch(const float* img, const int* rows, const int* cols,
                                            const int* offsets, const int* order, const int* row_tiles,
                                            const int* col_tiles, int* out, int B, int H, int W, int nR,
                                            int nC, int n_row_tiles, int n_col_tiles, int S,
                                            int block_size, int K, int mode, int search, int pitch,
                                            int cand_lo, int cand_hi, void* stream) {
  if (block_size != kBlock || K != kSpanMaxK || S < 1 || search < 0 || pitch < kTileSpan + 2 * search ||
      n_row_tiles < 1 || n_col_tiles < 1 || cand_lo < 0 || cand_hi > H - kBlock)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid(n_col_tiles, n_row_tiles, B);
  const size_t smem = sizeof(float) * ((size_t)(kTileSpan + 2 * search) * (pitch + 1) +
                                       (size_t)kTileMax * kDPitch) +
                      2 * sizeof(int) * kTileMax * K;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define PNP_TILE_MODE(M)                                                                                       \
  case M:                                                                                                      \
    return launch_granted<bm3d_match_tile_slots_kernel<M>>(grid, smem, st, img, rows, cols, offsets, order,     \
                                                           row_tiles, col_tiles, out, H, W, nR, nC, S, K, search, \
                                                           pitch, cand_lo, cand_hi);
    PNP_TILE_MODE(0) PNP_TILE_MODE(1) PNP_TILE_MODE(2)
#undef PNP_TILE_MODE
    default:
      return cudaErrorInvalidValue;
  }
}

// Any block 1-32 but 8, the design the three above replaced (the serial
// run-time phase 1, the four-slot merge at k 128): by name only, to time
// them on one call.
PNP_SPAN_ENTRY(bm3d_match_span_serial_launch, kEntrySerial)
#endif
#undef PNP_SPAN_ENTRY
