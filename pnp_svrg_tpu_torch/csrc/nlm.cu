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
//
// Other patch sizes and distances (`nlm_any_kernel<P>`). The kernel above
// is built for P = 4, D = 5. The any-kernel takes P in [1, 11] as a
// template argument (a thread's window rows live in registers) and D in
// [1, 15] at run time, in the same design: a warp covers 32 canvas columns
// and writes the 32 - P + 1 whose windows it holds, the tile is
// (8 + P - 1 + 2D) x (32 + 2D), and the (2D + 1)^2 shifts are split over
// the CTA's warps. Its sums follow the plain version's order: the P
// squared differences of a column one after another, then the P columns
// (by `__shfl_sync` from the lanes that hold them) one after another; the
// weight as above. skimage's defaults (P = 7, D = 11) make 529 shifts and
// 26 output columns a warp. The wrapper no longer launches it on its own:
// it stays for timing against its redesign, `nlm_cluster_kernel<P, R>`,
// which takes every (P, D) but (4, 5).
//
// nlm_cluster_kernel<P, R>. Its bound is the any-kernel's: one exponential
// a valid (pixel, shift) pair at the MUFU rate (at (7, 11), 0.0019 ms for
// one 128 x 128 image). The any-kernel ran far above it for two reasons. At
// one image its 80 CTAs left 52 of the 132 SMs without work; and for each
// (warp, shift) and each of its 8 rows of 26 useful pairs it added a
// column's P squares and its neighbours' P column sums one after another,
// by P shuffles (56 a (warp, shift) at P = 7). The redesign:
// 1. Two columns a lane. Lane j of a half-warp owns canvas columns 2j and
//    2j + 1 and R rows (R = 4 or 8, the host's choice); the half-warps
//    of a warp take rows 0 .. R - 1 and R .. 2R - 1, so a warp covers its
//    CTA's 2R x (33 - P) outputs. A candidate pair is one aligned 8-byte
//    load, from the tile or from a copy of it shifted by one column.
// 2. Doubling trees. A column's P-row box sums are its pair sums, then
//    fours, then eights, each box the ascending power-of-two runs that make
//    up P; across columns the pairs are summed in-lane, pairs of pairs by
//    one shuffle, and a window is a lone odd column, runs of pairs and a
//    lone even column (`window_of`), so P = 7 takes 4 shuffles for a lane's
//    two outputs, P = 11 six: at P = 7, 32 a (warp, shift) for 16 rows of
//    26 useful pairs.
// 3. The weight as one FFMA and a min that keeps NaN: exp2(min(d k -
//    offset k, mask)) with k = -log2(e) / (h^2 P^2) and mask 0 or -inf for a
//    candidate outside [lo, hi) x [0, W), which equals exp(-max(d -
//    offset, 0) / (h^2 P^2)) and keeps h = 0's NaN everywhere.
// 4. The shifts split over a thread-block cluster's CTAs and their warps
//    (`cluster_plan` and `split_chunks` in ops/cuda/nlm.py): each warp sums
//    its dy-major chunk, the CTA its warps in order, and after a cluster
//    barrier each CTA a share of the pixels over the ranks in order,
//    through distributed shared memory; the same bits every run. Each CTA
//    loads only the tile rows its shifts and its own windows read, a warp a
//    row, four rows in flight. A one-CTA cluster is a plain launch and
//    reads no remote memory.
//
// nlm_cluster_rt_kernel<R>. The cluster kernel is compiled for P in [1, 11]
// (its windows are trees of up to three doubling levels) and D in [1, 15]
// (a lane loads two tile columns: pitch <= 62). Every other setting the
// JAX package takes, up to P = 31 and the D whose tile fits one CTA's
// shared memory, runs in the same design with P read at run time and the
// tile loaded a warp a row, its lanes every 32nd column: the same CTAs,
// clusters, chunks of shifts and order of partial sums, but each box sum a
// column's P squares one after another (rows first) and each window its P
// columns one after another (by a shuffle inside the half-warp), the plain
// version's order. A warp's 32 columns hold 33 - P whole windows, so P 32
// needs another tiling (not built). Its bound is the cluster kernel's.

#include <cooperative_groups.h>
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

// Any P in [1, 11] (a template argument) and D >= 1 (at run time); one CTA
// per (lane b, strip of kRows rows from i0, 32 - P + 1 columns from j0).
template <int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
nlm_any_kernel(const float* __restrict__ x, const float* __restrict__ hs,
               const float* __restrict__ ss, float* __restrict__ out, int H, int W, int D,
               int lo, int hi) {
  constexpr int kPad = P / 2;               // reflect padding
  constexpr int kWinP = kRows + P - 1;      // canvas rows a thread's windows cover
  constexpr int kOutColsP = 32 - P + 1;     // output columns a warp writes
  const int span = 2 * D + 1;
  const int shifts = span * span;
  const int tile_rows = kWinP + 2 * D;
  const int tile_cols = 32 + 2 * D;
  extern __shared__ float smem[];
  float* tile = smem;  // tile_rows x tile_cols
  float* part_w = smem + tile_rows * tile_cols;  // [warps][kRows][32]
  const int nwarps = blockDim.x >> 5;
  float* part_a = part_w + nwarps * kRows * 32;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kOutColsP;
  const float* img = x + (long long)b * H * W;
  for (int e = threadIdx.x; e < tile_rows * tile_cols; e += blockDim.x) {
    const int t = e / tile_cols, u = e % tile_cols;
    const int r = reflect_index(i0 - kPad - D + t, H, kPad);
    const int q = reflect_index(j0 - kPad - D + u, W, kPad);
    tile[e] = __ldg(img + (long long)r * W + q);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = j0 - kPad + lane;  // this lane's canvas column
  const float hv = __ldg(hs + b), sv = __ldg(ss + b);
  const float inv_h2 = 1.0f / (hv * hv * P * P);
  const float offset = 2.0f * sv * sv * (P * P);
  const float k = -(inv_h2 * kLog2e);

  float own[kWinP];
#pragma unroll
  for (int r = 0; r < kWinP; ++r) own[r] = tile[(r + D) * tile_cols + lane + D];

  float wsum[kRows], acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) wsum[r] = acc[r] = 0.0f;

  const int q0 = warp * shifts / nwarps, q1 = (warp + 1) * shifts / nwarps;
  int dy = q0 / span - D, dx = q0 % span - D;
  float brow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ii = i0 + r + dy;
    brow[r] = (ii >= lo && ii < hi) ? 0.0f : -CUDART_INF_F;
  }
  for (int q = q0; q < q1; ++q) {
    const float bcol = (c + dx >= 0 && c + dx < W) ? 0.0f : -CUDART_INF_F;
    const float* cand = tile + (dy + D) * tile_cols + lane + dx + D;
    float cv[kWinP], sq[kWinP];
#pragma unroll
    for (int r = 0; r < kWinP; ++r) {
      cv[r] = cand[r * tile_cols];
      const float e = __fsub_rn(own[r], cv[r]);
      sq[r] = __fmul_rn(e, e);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float col = sq[r];  // rows first, one after another
#pragma unroll
      for (int u = 1; u < P; ++u) col = __fadd_rn(col, sq[r + u]);
      float dist = __shfl_sync(0xffffffffu, col, (lane - kPad) & 31);  // then columns
#pragma unroll
      for (int u = 1; u < P; ++u)
        dist = __fadd_rn(dist, __shfl_sync(0xffffffffu, col, (lane - kPad + u) & 31));
      const float m = max_keep_nan(dist - offset, 0.0f);
      const float w = exp2_approx(fmaf(m, k, brow[r] + bcol));
      wsum[r] += w;
      acc[r] = fmaf(w, cv[r + kPad], acc[r]);
    }
    if (++dx > D) {
      dx = -D;
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
    const int i = i0 + r, j = j0 - kPad + l;
    if (l < kPad || l >= kPad + kOutColsP || i >= H || j >= W) continue;
    float ws = part_w[e], ac = part_a[e];
    for (int s = 1; s < nwarps; ++s) {  // fixed order: the same result every run
      ws += part_w[s * kRows * 32 + e];
      ac += part_a[s * kRows * 32 + e];
    }
    out[(long long)b * H * W + (long long)i * W + j] = ac / max_keep_nan(ws, 1e-12f);
  }
}

// ---------------------------------------------------------------------------
// nlm_cluster_kernel<P, R>: every (P, D) but (4, 5) (the design note is at
// the top of this file).
//
// A CTA owns 2 R output rows (R = 4 or 8 rows a thread, the host's choice)
// and 33 - P output columns of one lane. Each warp covers them whole:
// half-warp h takes rows R h .. R h + R - 1, and its lane j the canvas
// columns 2 j and 2 j + 1 of a 32-column strip.
// The CTAs of a thread-block cluster (up to kMaxCluster) split the shifts
// between them, and each CTA between its warps: chunk c = rank * warps +
// warp takes the dy-major shifts [c S / n, (c + 1) S / n) of S, n = cluster
// x warps. Each warp keeps partial (wsum, acc) for its pixels; the CTA sums
// its warps' in warp order, and after a cluster barrier each CTA sums a
// share of the pixels over the cluster's CTAs in rank order through
// distributed shared memory, so the result is the same run after run.
constexpr int kClusterMaxWarps = 8;
constexpr int kMaxCluster = 16;  // past 8: H100's non-portable cluster sizes
// The box sums by doubling trees (the design); false sums each window's
// terms one after another, as nlm_any_kernel does (a variant that
// examples/k3_variants.py times).
constexpr bool kDoublingTree = true;
constexpr int kRowBatch = 4;  // tile rows a warp loads at once

// min(a, b) that returns NaN if either is NaN (min.NaN).
__device__ __forceinline__ float min_keep_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// One term of a window sum over P columns, as the lane holding column 2 j
// sees it: kind 0 is column 2 j' and kind 1 column 2 j' + 1 of lane j' = j
// + off; kind 2 + k is the sum of the 2^k column pairs from lane j'.
struct Piece {
  int kind, off;
};
struct Window {
  Piece p[12];
  int n;
};

// The window of the output at column 2 j + e (e = 0, 1): canvas columns
// 2 j + e - P / 2 .. + P - 1, cut into a lone odd column first, then runs of
// pairs of ascending power-of-two length, then a lone even column; the sum
// adds them in that order.
__host__ __device__ constexpr Window window_of(int P, int e) {
  Window w{};
  int delta = e - P / 2;  // the first column, relative to 2 j
  int cols = P;
  if (delta & 1) {
    w.p[w.n++] = Piece{1, (delta - 1) / 2};
    ++delta;
    --cols;
  }
  int lane = delta / 2;
  const int pairs = cols / 2;
  for (int k = 0; k < 3; ++k) {
    if (pairs & (1 << k)) {
      w.p[w.n++] = Piece{2 + k, lane};
      lane += 1 << k;
    }
  }
  if (cols & 1) w.p[w.n++] = Piece{0, lane};
  return w;
}

// The same window as P single columns, one after another (!kDoublingTree).
__host__ __device__ constexpr Window window_serial(int P, int e) {
  Window w{};
  for (int u = 0; u < P; ++u) {
    const int o = e - P / 2 + u;  // the column, relative to 2 j
    w.p[w.n++] = Piece{o & 1, (o - (o & 1)) / 2};
  }
  return w;
}

// The index of `pc` among the first `n` pieces of `w`, or -1.
__host__ __device__ constexpr int find_piece(const Window& w, int n, Piece pc) {
  for (int i = 0; i < n; ++i)
    if (w.p[i].kind == pc.kind && w.p[i].off == pc.off) return i;
  return -1;
}

// A piece at each of the thread's rows (j: its lane in the half-warp), by
// a shuffle inside the half-warp where it lies in another lane; the rows'
// shuffles are issued together.
template <int R, int kKind, int kOff>
__device__ __forceinline__ void piece(const float (&c0)[R], const float (&c1)[R], const float (&lv)[3][R], int j,
                                      float (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if constexpr (kKind == 0) v[r] = c0[r];
    else if constexpr (kKind == 1) v[r] = c1[r];
    else v[r] = lv[kKind - 2][r];
  }
  if constexpr (kOff != 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __shfl_sync(0xffffffffu, v[r], (j + kOff) & 15, 16);
  }
}

// Window sums of both outputs of the lane at each row, each in its window's
// order; a piece both windows hold is fetched once.
template <int P, int R, int I = 0>
__device__ __forceinline__ void window_sums(const float (&c0)[R], const float (&c1)[R], const float (&lv)[3][R],
                                            int j, float (&f)[12][R], float (&d0)[R], float (&d1)[R]) {
  constexpr Window w0 = kDoublingTree ? window_of(P, 0) : window_serial(P, 0);
  constexpr Window w1 = kDoublingTree ? window_of(P, 1) : window_serial(P, 1);
  if constexpr (I < w0.n) {
    constexpr Piece pc = w0.p[I];
    piece<R, pc.kind, pc.off>(c0, c1, lv, j, f[I]);
#pragma unroll
    for (int r = 0; r < R; ++r) d0[r] = I == 0 ? f[I][r] : __fadd_rn(d0[r], f[I][r]);
    window_sums<P, R, I + 1>(c0, c1, lv, j, f, d0, d1);
  } else if constexpr (I - w0.n < w1.n) {
    constexpr int i = I - w0.n;
    constexpr Piece pc = w1.p[i];
    constexpr int shared = find_piece(w0, w0.n, pc);
    float v[R];
    if constexpr (shared >= 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = f[shared][r];
    } else {
      piece<R, pc.kind, pc.off>(c0, c1, lv, j, v);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) d1[r] = i == 0 ? v[r] : __fadd_rn(d1[r], v[r]);
    window_sums<P, R, I + 1>(c0, c1, lv, j, f, d0, d1);
  }
}

// The P-row box sums of one column at its R output rows from the
// squared differences `sq` of its R + P - 1 window rows: pair sums,
// then sums of four, then of eight (a doubling tree), and each box the
// ascending power-of-two runs that make up P, added in that order.
template <int P, int R>
__device__ __forceinline__ void column_boxes(const float (&sq)[R + P - 1], float (&box)[R]) {
  constexpr int N = R + P - 1;
  constexpr int o1 = P & 1, o2 = o1 + (P & 2), o3 = o2 + (P & 4);
  float v1[N], v2[N], v3[N];  // v_k[r]: rows r .. r + 2^k - 1
  if constexpr (P >= 2) {
#pragma unroll
    for (int r = 0; r + 1 < N; ++r) v1[r] = __fadd_rn(sq[r], sq[r + 1]);
  }
  if constexpr (P >= 4) {
#pragma unroll
    for (int r = 0; r + 3 < N; ++r) v2[r] = __fadd_rn(v1[r], v1[r + 2]);
  }
  if constexpr (P >= 8) {
#pragma unroll
    for (int r = 0; r + 7 < N; ++r) v3[r] = __fadd_rn(v2[r], v2[r + 4]);
  }
  if constexpr (!kDoublingTree) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = sq[r];
#pragma unroll
      for (int u = 1; u < P; ++u) s = __fadd_rn(s, sq[r + u]);
      box[r] = s;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s;
    if constexpr ((P & 1) != 0) s = sq[r];
    if constexpr ((P & 2) != 0) {
      if constexpr ((P & 1) != 0) s = __fadd_rn(s, v1[r + o1]);
      else s = v1[r + o1];
    }
    if constexpr ((P & 4) != 0) {
      if constexpr ((P & 3) != 0) s = __fadd_rn(s, v2[r + o2]);
      else s = v2[r + o2];
    }
    if constexpr ((P & 8) != 0) {
      if constexpr ((P & 7) != 0) s = __fadd_rn(s, v3[r + o3]);
      else s = v3[r + o3];
    }
    box[r] = s;
  }
}

// Dynamic shared memory: the tile (tile_rows x pitch), the tile shifted by
// one column (so that every lane's pair of candidates is one aligned 8-byte
// load), and each warp's partial wsum and acc planes.
template <int P, int R>
__global__ void __launch_bounds__(kClusterMaxWarps * 32)
nlm_cluster_kernel(const float* __restrict__ x, const float* __restrict__ hs,
                   const float* __restrict__ ss, float* __restrict__ out, int H, int W, int D,
                   int lo, int hi, int cluster) {
  constexpr int kPad = P / 2;
  constexpr int kWinP = R + P - 1;       // window rows of a thread's R output rows
  constexpr int kOutColsP = 32 - P + 1;  // output columns a CTA
  constexpr int kClusterRows = 2 * R;    // output rows a CTA
  const int span = 2 * D + 1;
  const int shifts = span * span;
  const int tile_rows = kClusterRows + P - 1 + 2 * D;
  const int pitch = 32 + 2 * D;  // even: 8-byte aligned pairs
  extern __shared__ float2 smem2[];
  float* tile = reinterpret_cast<float*>(smem2);
  float* odd = tile + tile_rows * pitch;  // odd[t][u] = tile[t][u + 1]
  const int nwarps = blockDim.x >> 5;
  float* part_w = odd + tile_rows * pitch;  // [warps][kClusterRows][32]
  float* part_a = part_w + nwarps * kClusterRows * 32;
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kClusterRows;
  const int j0 = (blockIdx.x / cluster) * kOutColsP;
  const float* img = x + (long long)b * H * W;
  // Tile row t holds image row i0 - kPad - D + t, column u image column
  // j0 - kPad - D + u (reflected; clamped past the canvas, where only
  // candidates whose weight is zeroed read).
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The tile rows this CTA reads: its shifts' candidate rows (shift q's
  // start at row q / span) and its own windows' (those of dy = 0).
  const int qa = rank * nwarps * shifts / (cluster * nwarps);
  const int qb = (rank + 1) * nwarps * shifts / (cluster * nwarps);
  const int t_lo = min(qa / span, D), t_hi = max((qb - 1) / span, D) + kClusterRows + P - 1;
  // A warp a row, a lane the columns lane and lane + 32 (pitch <= 62),
  // kRowBatch rows' loads in flight before their stores.
  const int u1 = lane + 32;
  const int qc0 = reflect_index(j0 - kPad - D + lane, W, kPad);
  const int qc1 = u1 < pitch ? reflect_index(j0 - kPad - D + u1, W, kPad) : 0;
  for (int t0 = t_lo + warp; t0 < t_hi; t0 += kRowBatch * nwarps) {
    float v0[kRowBatch], v1[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int t = t0 + i * nwarps;
      if (t < t_hi) {
        const float* row = img + (long long)reflect_index(i0 - kPad - D + t, H, kPad) * W;
        v0[i] = __ldg(row + qc0);
        if (u1 < pitch) v1[i] = __ldg(row + qc1);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int t = t0 + i * nwarps;
      if (t < t_hi) {
        tile[t * pitch + lane] = v0[i];
        if (lane > 0) odd[t * pitch + lane - 1] = v0[i];
        if (u1 < pitch) {
          tile[t * pitch + u1] = v1[i];
          odd[t * pitch + u1 - 1] = v1[i];
        }
      }
    }
  }
  __syncthreads();

  const int half = lane >> 4, j = lane & 15;
  const int c = j0 - kPad + 2 * j;  // the image column of this lane's first canvas column
  const float hv = __ldg(hs + b), sv = __ldg(ss + b);
  const float inv_h2 = 1.0f / (hv * hv * P * P);
  const float offset = 2.0f * sv * sv * (P * P);
  // The exponent max(d - offset, 0) * k (k <= 0) as min(d k - offset k, 0):
  // one FFMA and one min, which also takes the candidate's -inf mask.
  const float k = -(inv_h2 * kLog2e);
  const float c0 = -(offset * k);

  float own0[kWinP], own1[kWinP];
#pragma unroll
  for (int r = 0; r < kWinP; ++r) {
    own0[r] = tile[(r + R * half + D) * pitch + 2 * j + D];
    own1[r] = tile[(r + R * half + D) * pitch + 2 * j + 1 + D];
  }
  float wsum0[R], acc0[R], wsum1[R], acc1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) wsum0[r] = acc0[r] = wsum1[r] = acc1[r] = 0.0f;

  const int chunk = rank * nwarps + warp, chunks = cluster * nwarps;
  const int q0 = chunk * shifts / chunks, q1 = (chunk + 1) * shifts / chunks;
  int dy = q0 / span - D, dx = q0 % span - D;
  const int row0 = i0 + R * half;  // this half-warp's first output row
  float brow[R];  // 0, or -inf where row row0 + r + dy is not a candidate row
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ii = row0 + r + dy;
    brow[r] = (ii >= lo && ii < hi) ? 0.0f : -CUDART_INF_F;
  }
  for (int q = q0; q < q1; ++q) {
    const float bcol0 = (c + dx >= 0 && c + dx < W) ? 0.0f : -CUDART_INF_F;
    const float bcol1 = (c + 1 + dx >= 0 && c + 1 + dx < W) ? 0.0f : -CUDART_INF_F;
    const int col = 2 * j + dx + D;
    const float* cand = ((col & 1) ? odd + col - 1 : tile + col) + (dy + D + R * half) * pitch;
    float sq0[kWinP], sq1[kWinP], cv0[R], cv1[R];
#pragma unroll
    for (int r = 0; r < kWinP; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(cand + r * pitch);
      const float e0 = __fsub_rn(own0[r], v.x), e1 = __fsub_rn(own1[r], v.y);
      sq0[r] = __fmul_rn(e0, e0);
      sq1[r] = __fmul_rn(e1, e1);
      if (r >= kPad && r < kPad + R) {
        cv0[r - kPad] = v.x;
        cv1[r - kPad] = v.y;
      }
    }
    float box0[R], box1[R];
    column_boxes<P, R>(sq0, box0);
    column_boxes<P, R>(sq1, box1);
    // Sums of 1, 2 and 4 column pairs from this lane, at each row.
    float lv[3][R], t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lv[0][r] = __fadd_rn(box0[r], box1[r]);
#pragma unroll
    for (int l = 1; l < 3; ++l) {
      if (!kDoublingTree || P < (2 << l)) break;  // pairs of pairs from P = 4, fours from 8
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = __shfl_down_sync(0xffffffffu, lv[l - 1][r], 1 << (l - 1), 16);
#pragma unroll
      for (int r = 0; r < R; ++r) lv[l][r] = __fadd_rn(lv[l - 1][r], t[r]);
    }
    float f[12][R], d0[R], d1[R];
    window_sums<P, R>(box0, box1, lv, j, f, d0, d1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // The candidate's mask (0 or -inf) is the lesser of its row's and its
      // column's.
      const float w0 = exp2_approx(min_keep_nan(fmaf(d0[r], k, c0), min_keep_nan(brow[r], bcol0)));
      const float w1 = exp2_approx(min_keep_nan(fmaf(d1[r], k, c0), min_keep_nan(brow[r], bcol1)));
      wsum0[r] += w0;
      acc0[r] = fmaf(w0, cv0[r], acc0[r]);
      wsum1[r] += w1;
      acc1[r] = fmaf(w1, cv1[r], acc1[r]);
    }
    if (++dx > D) {
      dx = -D;
      ++dy;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ii = row0 + r + dy;
        brow[r] = (ii >= lo && ii < hi) ? 0.0f : -CUDART_INF_F;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (warp * kClusterRows + R * half + r) * 32 + 2 * j;
    part_w[e] = wsum0[r];
    part_w[e + 1] = wsum1[r];
    part_a[e] = acc0[r];
    part_a[e + 1] = acc1[r];
  }
  __syncthreads();
  // The CTA's sum, in warp order, into warp 0's planes.
  for (int e = threadIdx.x; e < kClusterRows * 32; e += blockDim.x) {
    float ws = part_w[e], ac = part_a[e];
    for (int s = 1; s < nwarps; ++s) {
      ws += part_w[s * kClusterRows * 32 + e];
      ac += part_a[s * kClusterRows * 32 + e];
    }
    part_w[e] = ws;
    part_a[e] = ac;
  }
  if (cluster > 1) cl.sync();
  else __syncthreads();
  // This CTA's share of the pixels, summed over the cluster in rank order
  // (its own shared memory alone where the cluster is one CTA).
  for (int e = rank * blockDim.x + threadIdx.x; e < kClusterRows * 32; e += cluster * blockDim.x) {
    const int r = e >> 5, t = e & 31;
    const int i = i0 + r, jj = j0 - kPad + t;
    if (t < kPad || t >= kPad + kOutColsP || i >= H || jj >= W) continue;
    float ws = part_w[e], ac = part_a[e];
    if (cluster > 1) {  // every rank's partials loaded, then added in rank order
      float wv[kMaxCluster], av[kMaxCluster];
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s) {
        if (s < cluster) {
          wv[s] = *cl.map_shared_rank(part_w + e, s);
          av[s] = *cl.map_shared_rank(part_a + e, s);
        }
      }
      ws = wv[0];
      ac = av[0];
#pragma unroll
      for (int s = 1; s < kMaxCluster; ++s) {
        if (s < cluster) {
          ws += wv[s];
          ac += av[s];
        }
      }
    }
    out[(long long)b * H * W + (long long)i * W + jj] = ac / max_keep_nan(ws, 1e-12f);
  }
  if (cluster > 1) cl.sync();  // no CTA leaves while another reads its shared memory
}

// nlm_cluster_rt_kernel<R>: the cluster kernel's design with the patch size
// P at run time (see the top of this file). The CTA's tile rows are loaded
// a warp a row, the lanes every 32nd column of any pitch.
template <int R>
__global__ void __launch_bounds__(kClusterMaxWarps * 32)
nlm_cluster_rt_kernel(const float* __restrict__ x, const float* __restrict__ hs,
                      const float* __restrict__ ss, float* __restrict__ out, int H, int W, int P, int D,
                      int lo, int hi, int cluster) {
  const int pad = P / 2;
  const int out_cols = 33 - P;          // output columns a CTA
  constexpr int kClusterRows = 2 * R;   // output rows a CTA
  const int span = 2 * D + 1;
  const int shifts = span * span;
  const int tile_rows = kClusterRows + P - 1 + 2 * D;
  const int pitch = 32 + 2 * D;  // even: 8-byte aligned pairs
  extern __shared__ float2 smem2[];
  float* tile = reinterpret_cast<float*>(smem2);
  float* odd = tile + tile_rows * pitch;  // odd[t][u] = tile[t][u + 1]
  const int nwarps = blockDim.x >> 5;
  float* part_w = odd + tile_rows * pitch;  // [warps][kClusterRows][32]
  float* part_a = part_w + nwarps * kClusterRows * 32;
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kClusterRows;
  const int j0 = (blockIdx.x / cluster) * out_cols;
  const float* img = x + (long long)b * H * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qa = rank * nwarps * shifts / (cluster * nwarps);
  const int qb = (rank + 1) * nwarps * shifts / (cluster * nwarps);
  const int t_lo = min(qa / span, D), t_hi = max((qb - 1) / span, D) + kClusterRows + P - 1;
  for (int t = t_lo + warp; t < t_hi; t += nwarps) {
    const float* row = img + (long long)reflect_index(i0 - pad - D + t, H, pad) * W;
    for (int u = lane; u < pitch; u += 32) {
      const float v = __ldg(row + reflect_index(j0 - pad - D + u, W, pad));
      tile[t * pitch + u] = v;
      if (u > 0) odd[t * pitch + u - 1] = v;
    }
  }
  __syncthreads();

  const int half = lane >> 4, j = lane & 15;
  const int c = j0 - pad + 2 * j;  // the image column of this lane's first canvas column
  const float hv = __ldg(hs + b), sv = __ldg(ss + b);
  const float inv_h2 = 1.0f / (hv * hv * P * P);
  const float offset = 2.0f * sv * sv * (P * P);
  const float k = -(inv_h2 * kLog2e);
  const float c0 = -(offset * k);
  const float* own = tile + (R * half + D) * pitch + 2 * j + D;  // own[t * pitch + e]: window row t

  float wsum0[R], acc0[R], wsum1[R], acc1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) wsum0[r] = acc0[r] = wsum1[r] = acc1[r] = 0.0f;

  const int chunk = rank * nwarps + warp, chunks = cluster * nwarps;
  const int q0 = chunk * shifts / chunks, q1 = (chunk + 1) * shifts / chunks;
  int dy = q0 / span - D, dx = q0 % span - D;
  const int row0 = i0 + R * half;
  float brow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ii = row0 + r + dy;
    brow[r] = (ii >= lo && ii < hi) ? 0.0f : -CUDART_INF_F;
  }
  for (int q = q0; q < q1; ++q) {
    const float bcol0 = (c + dx >= 0 && c + dx < W) ? 0.0f : -CUDART_INF_F;
    const float bcol1 = (c + 1 + dx >= 0 && c + 1 + dx < W) ? 0.0f : -CUDART_INF_F;
    const int col = 2 * j + dx + D;
    const float* cand = ((col & 1) ? odd + col - 1 : tile + col) + (dy + D + R * half) * pitch;
    // Each output row's box sums of its two columns, the squares of window
    // rows r .. r + P - 1 one after another.
    float box0[R], box1[R], cv0[R], cv1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) box0[r] = box1[r] = cv0[r] = cv1[r] = 0.0f;
    for (int t = 0; t < R + P - 1; ++t) {
      const float2 v = *reinterpret_cast<const float2*>(cand + t * pitch);
      const float e0 = __fsub_rn(own[t * pitch], v.x), e1 = __fsub_rn(own[t * pitch + 1], v.y);
      const float s0 = __fmul_rn(e0, e0), s1 = __fmul_rn(e1, e1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = t >= r && t < r + P;
        box0[r] = in ? __fadd_rn(box0[r], s0) : box0[r];
        box1[r] = in ? __fadd_rn(box1[r], s1) : box1[r];
        cv0[r] = t == r + pad ? v.x : cv0[r];
        cv1[r] = t == r + pad ? v.y : cv1[r];
      }
    }
    // The windows: canvas columns 2 j - pad + u for output 2 j (u < P) and
    // output 2 j + 1 (0 < u <= P), one after another, each from the lane of
    // the half-warp that holds it.
    float d0[R], d1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) d0[r] = d1[r] = 0.0f;
    for (int u = 0; u <= P; ++u) {
      const int o = u - pad;  // the column, relative to 2 j
      const int src = (j + (o >> 1)) & 15;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = __shfl_sync(0xffffffffu, (o & 1) ? box1[r] : box0[r], src, 16);
        d0[r] = u < P ? __fadd_rn(d0[r], v) : d0[r];
        d1[r] = u > 0 ? __fadd_rn(d1[r], v) : d1[r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w0 = exp2_approx(min_keep_nan(fmaf(d0[r], k, c0), min_keep_nan(brow[r], bcol0)));
      const float w1 = exp2_approx(min_keep_nan(fmaf(d1[r], k, c0), min_keep_nan(brow[r], bcol1)));
      wsum0[r] += w0;
      acc0[r] = fmaf(w0, cv0[r], acc0[r]);
      wsum1[r] += w1;
      acc1[r] = fmaf(w1, cv1[r], acc1[r]);
    }
    if (++dx > D) {
      dx = -D;
      ++dy;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ii = row0 + r + dy;
        brow[r] = (ii >= lo && ii < hi) ? 0.0f : -CUDART_INF_F;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (warp * kClusterRows + R * half + r) * 32 + 2 * j;
    part_w[e] = wsum0[r];
    part_w[e + 1] = wsum1[r];
    part_a[e] = acc0[r];
    part_a[e + 1] = acc1[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kClusterRows * 32; e += blockDim.x) {
    float ws = part_w[e], ac = part_a[e];
    for (int s = 1; s < nwarps; ++s) {
      ws += part_w[s * kClusterRows * 32 + e];
      ac += part_a[s * kClusterRows * 32 + e];
    }
    part_w[e] = ws;
    part_a[e] = ac;
  }
  if (cluster > 1) cl.sync();
  else __syncthreads();
  for (int e = rank * blockDim.x + threadIdx.x; e < kClusterRows * 32; e += cluster * blockDim.x) {
    const int r = e >> 5, t = e & 31;
    const int i = i0 + r, jj = j0 - pad + t;
    if (t < pad || t >= pad + out_cols || i >= H || jj >= W) continue;
    float ws = part_w[e], ac = part_a[e];
    if (cluster > 1) {
      float wv[kMaxCluster], av[kMaxCluster];
#pragma unroll
      for (int s = 0; s < kMaxCluster; ++s) {
        if (s < cluster) {
          wv[s] = *cl.map_shared_rank(part_w + e, s);
          av[s] = *cl.map_shared_rank(part_a + e, s);
        }
      }
      ws = wv[0];
      ac = av[0];
#pragma unroll
      for (int s = 1; s < kMaxCluster; ++s) {
        if (s < cluster) {
          ws += wv[s];
          ac += av[s];
        }
      }
    }
    out[(long long)b * H * W + (long long)i * W + jj] = ac / max_keep_nan(ws, 1e-12f);
  }
  if (cluster > 1) cl.sync();
}

constexpr int kMaxP = 11, kMaxD = 15;  // the any-kernel's envelope
constexpr int kRtMaxP = 31;           // nlm_cluster_rt_kernel's: 33 - P output columns a warp

// Kernel slots: 0 nlm_kernel, P nlm_any_kernel<P>, kMaxP + P
// nlm_cluster_kernel<P, 8> and 2 kMaxP + P nlm_cluster_kernel<P, 4> (P in
// [1, kMaxP]); 3 kMaxP + 1 nlm_cluster_rt_kernel<8>, 3 kMaxP + 2 <4>.
const void* kernel_of(int slot) {
  switch (slot) {
    case 1: return (const void*)nlm_any_kernel<1>;
    case 2: return (const void*)nlm_any_kernel<2>;
    case 3: return (const void*)nlm_any_kernel<3>;
    case 4: return (const void*)nlm_any_kernel<4>;
    case 5: return (const void*)nlm_any_kernel<5>;
    case 6: return (const void*)nlm_any_kernel<6>;
    case 7: return (const void*)nlm_any_kernel<7>;
    case 8: return (const void*)nlm_any_kernel<8>;
    case 9: return (const void*)nlm_any_kernel<9>;
    case 10: return (const void*)nlm_any_kernel<10>;
    case 11: return (const void*)nlm_any_kernel<11>;
    case 12: return (const void*)nlm_cluster_kernel<1, 8>;
    case 13: return (const void*)nlm_cluster_kernel<2, 8>;
    case 14: return (const void*)nlm_cluster_kernel<3, 8>;
    case 15: return (const void*)nlm_cluster_kernel<4, 8>;
    case 16: return (const void*)nlm_cluster_kernel<5, 8>;
    case 17: return (const void*)nlm_cluster_kernel<6, 8>;
    case 18: return (const void*)nlm_cluster_kernel<7, 8>;
    case 19: return (const void*)nlm_cluster_kernel<8, 8>;
    case 20: return (const void*)nlm_cluster_kernel<9, 8>;
    case 21: return (const void*)nlm_cluster_kernel<10, 8>;
    case 22: return (const void*)nlm_cluster_kernel<11, 8>;
    case 23: return (const void*)nlm_cluster_kernel<1, 4>;
    case 24: return (const void*)nlm_cluster_kernel<2, 4>;
    case 25: return (const void*)nlm_cluster_kernel<3, 4>;
    case 26: return (const void*)nlm_cluster_kernel<4, 4>;
    case 27: return (const void*)nlm_cluster_kernel<5, 4>;
    case 28: return (const void*)nlm_cluster_kernel<6, 4>;
    case 29: return (const void*)nlm_cluster_kernel<7, 4>;
    case 30: return (const void*)nlm_cluster_kernel<8, 4>;
    case 31: return (const void*)nlm_cluster_kernel<9, 4>;
    case 32: return (const void*)nlm_cluster_kernel<10, 4>;
    case 33: return (const void*)nlm_cluster_kernel<11, 4>;
    case 34: return (const void*)nlm_cluster_rt_kernel<8>;
    case 35: return (const void*)nlm_cluster_rt_kernel<4>;
    default: return (const void*)nlm_kernel;
  }
}

// The device's SM count and how many warps of kernel_of(slot) one SM holds
// at once (registers, and the thread limit); 0 if the query fails.
struct Device {
  int sms = 0, warps_per_sm = 0;
};

Device query_limits(int dev, int slot) {
  Device d;
  int regs = 0, threads = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&regs, cudaDevAttrMaxRegistersPerMultiprocessor, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel_of(slot)) != cudaSuccess)
    return Device{};
  const int regs_per_warp = 32 * ((attr.numRegs + 7) / 8 * 8);  // allocated 8 a thread at a time
  d.warps_per_sm = threads / 32 < regs / regs_per_warp ? threads / 32 : regs / regs_per_warp;
  return d;
}

// query_limits of the current device, asked once a device and kernel.
Device device_limits(int slot) {
  constexpr int kCached = 64;
  static Device cache[kCached][3 * kMaxP + 3];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return Device{};
  if (dev >= kCached) return query_limits(dev, slot);
  if (cache[dev][slot].sms == 0) cache[dev][slot] = query_limits(dev, slot);
  return cache[dev][slot];
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
// f32; patch_size in [1, 11] and patch_distance in [1, 15] (nlm_kernel for
// (4, 5)); rows [lo, hi) count as in-image candidates (0 <= lo <= hi <= H).
// Returns the launch's cudaError_t.
extern "C" int nlm_launch(const float* x, const float* h, const float* sigma,
                          float* out, int B, int H, int W, int patch_size,
                          int patch_distance, int lo, int hi, void* stream) {
  if (patch_size < 1 || patch_size > kMaxP || patch_distance < 1 || patch_distance > kMaxD)
    return cudaErrorInvalidValue;
  const int pad = patch_size / 2;
  if (H <= pad || W <= pad) return cudaErrorInvalidValue;
  if (lo < 0 || hi > H || lo > hi || B > 65535) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const bool first = patch_size == kP && patch_distance == kD;
  const int slot = first ? 0 : patch_size;
  const Device d = device_limits(slot);
  if (d.sms <= 0 || d.warps_per_sm <= 0) return cudaErrorInvalidDevice;
  const int out_cols = 32 - patch_size + 1;
  const dim3 grid((W + out_cols - 1) / out_cols, (H + kRows - 1) / kRows, B);
  const int warps = plan_warps((long long)grid.x * grid.y * grid.z, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (first) {
    const size_t smem = sizeof(float) * (kTileRows * kTileCols + 2 * warps * kRows * 32);
    nlm_kernel<<<grid, warps * 32, smem, st>>>(x, h, sigma, out, H, W, lo, hi);
    return cudaGetLastError();
  }
  const int tile = (kRows + patch_size - 1 + 2 * patch_distance) * (32 + 2 * patch_distance);
  const size_t smem = sizeof(float) * (tile + 2 * warps * kRows * 32);  // < 48 KB in the envelope
  switch (patch_size) {
#define PNP_NLM_ANY(P)                                                                   \
  case P:                                                                                 \
    nlm_any_kernel<P><<<grid, warps * 32, smem, st>>>(x, h, sigma, out, H, W, patch_distance, \
                                                       lo, hi);                           \
    break;
    PNP_NLM_ANY(1) PNP_NLM_ANY(2) PNP_NLM_ANY(3) PNP_NLM_ANY(4) PNP_NLM_ANY(5) PNP_NLM_ANY(6)
    PNP_NLM_ANY(7) PNP_NLM_ANY(8) PNP_NLM_ANY(9) PNP_NLM_ANY(10) PNP_NLM_ANY(11)
#undef PNP_NLM_ANY
  }
  return cudaGetLastError();
}

// The SMs of the current device and how many warps of nlm_cluster_kernel<P,
// rows> one SM holds at once (registers, and the thread limit), for the
// host's plan of clusters and warps; patch_size 0 asks it of
// nlm_cluster_rt_kernel<rows>. Returns a cudaError_t.
extern "C" int nlm_cluster_limits(int patch_size, int rows, int* sms, int* warps_per_sm) {
  if (patch_size < 0 || patch_size > kMaxP || (rows != 4 && rows != 8)) return cudaErrorInvalidValue;
  const Device d = device_limits(patch_size == 0 ? 3 * kMaxP + (rows == 8 ? 1 : 2)
                                                 : (rows == 8 ? 1 : 2) * kMaxP + patch_size);
  if (d.sms <= 0 || d.warps_per_sm <= 0) return cudaErrorInvalidDevice;
  *sms = d.sms;
  *warps_per_sm = d.warps_per_sm;
  return cudaSuccess;
}

namespace {

// `fn` (a cluster kernel) on `grid` in clusters of `cluster` CTAs along x
// with `args`, `cluster` > 1.
template <typename... Args>
cudaError_t launch_clustered(void (*fn)(Args...), dim3 grid, int warps, int cluster, size_t smem,
                             cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fn, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// nlm_cluster_rt_kernel<R> on `grid` in clusters of `cluster` CTAs along x,
// opted into `smem` bytes.
template <int R>
cudaError_t launch_cluster_rt(dim3 grid, int warps, int cluster, size_t smem, cudaStream_t st,
                              const float* x, const float* h, const float* sigma, float* out, int H,
                              int W, int P, int D, int lo, int hi) {
  static size_t granted = 48 * 1024;
  static bool non_portable = false;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(nlm_cluster_rt_kernel<R>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  if (cluster == 1) {
    nlm_cluster_rt_kernel<R><<<grid, warps * 32, smem, st>>>(x, h, sigma, out, H, W, P, D, lo, hi, 1);
    return cudaGetLastError();
  }
  if (cluster > 8 && !non_portable) {
    const cudaError_t e = cudaFuncSetAttribute(nlm_cluster_rt_kernel<R>,
                                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    non_portable = true;
  }
  return launch_clustered(nlm_cluster_rt_kernel<R>, grid, warps, cluster, smem, st, x, h, sigma, out, H, W,
                          P, D, lo, hi, cluster);
}

// nlm_cluster_kernel<P, R> on `grid` in clusters of `cluster` CTAs along x,
// opted into `smem` bytes.
template <int P, int R>
cudaError_t launch_cluster(dim3 grid, int warps, int cluster, size_t smem, cudaStream_t st,
                           const float* x, const float* h, const float* sigma, float* out, int H,
                           int W, int D, int lo, int hi) {
  static size_t granted = 48 * 1024;
  static bool non_portable = false;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(nlm_cluster_kernel<P, R>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  if (cluster == 1) {  // a plain launch: each CTA its own cluster
    nlm_cluster_kernel<P, R><<<grid, warps * 32, smem, st>>>(x, h, sigma, out, H, W, D, lo, hi, 1);
    return cudaGetLastError();
  }
  if (cluster > 8 && !non_portable) {
    const cudaError_t e = cudaFuncSetAttribute(nlm_cluster_kernel<P, R>,
                                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    non_portable = true;
  }
  return launch_clustered(nlm_cluster_kernel<P, R>, grid, warps, cluster, smem, st, x, h, sigma, out, H, W, D,
                          lo, hi, cluster);
}

}  // namespace

// nlm_cluster_kernel: the arguments of nlm_launch (any patch_size in [1,
// 11], patch_distance in [1, 15]) and the host's plan: `cluster` CTAs (1-16)
// split each tile's shifts, each of `warps` warps (1-8) whose threads own
// `rows` (4 or 8) output rows. Returns the launch's cudaError_t.
extern "C" int nlm_cluster_launch(const float* x, const float* h, const float* sigma, float* out,
                                  int B, int H, int W, int patch_size, int patch_distance, int lo,
                                  int hi, int cluster, int warps, int rows, void* stream) {
  if (patch_size < 1 || patch_size > kMaxP || patch_distance < 1 || patch_distance > kMaxD)
    return cudaErrorInvalidValue;
  const int pad = patch_size / 2;
  if (H <= pad || W <= pad) return cudaErrorInvalidValue;
  if (lo < 0 || hi > H || lo > hi || B > 65535) return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || warps < 1 || warps > kClusterMaxWarps ||
      (rows != 4 && rows != 8))
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const int out_cols = 32 - patch_size + 1;
  const dim3 grid(((W + out_cols - 1) / out_cols) * cluster, (H + 2 * rows - 1) / (2 * rows), B);
  const int tile = (2 * rows + patch_size - 1 + 2 * patch_distance) * (32 + 2 * patch_distance);
  const size_t smem = sizeof(float) * (2 * tile + 2 * warps * 2 * rows * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (patch_size * 2 + (rows == 8)) {
#define PNP_NLM_CLUSTER(P)                                                                          \
  case 2 * P:                                                                                        \
    return launch_cluster<P, 4>(grid, warps, cluster, smem, st, x, h, sigma, out, H, W, patch_distance, \
                                lo, hi);                                                             \
  case 2 * P + 1:                                                                                    \
    return launch_cluster<P, 8>(grid, warps, cluster, smem, st, x, h, sigma, out, H, W, patch_distance, \
                                lo, hi);
    PNP_NLM_CLUSTER(1) PNP_NLM_CLUSTER(2) PNP_NLM_CLUSTER(3) PNP_NLM_CLUSTER(4) PNP_NLM_CLUSTER(5)
    PNP_NLM_CLUSTER(6) PNP_NLM_CLUSTER(7) PNP_NLM_CLUSTER(8) PNP_NLM_CLUSTER(9) PNP_NLM_CLUSTER(10)
    PNP_NLM_CLUSTER(11)
#undef PNP_NLM_CLUSTER
  }
  return cudaErrorInvalidValue;
}

// nlm_cluster_rt_kernel: the arguments of nlm_cluster_launch, for
// patch_size in [1, 31] and patch_distance >= 1 (every setting
// nlm_cluster_kernel is not compiled for; the host checks that the tile
// fits shared memory). Returns the launch's cudaError_t.
extern "C" int nlm_cluster_rt_launch(const float* x, const float* h, const float* sigma, float* out,
                                     int B, int H, int W, int patch_size, int patch_distance, int lo,
                                     int hi, int cluster, int warps, int rows, void* stream) {
  if (patch_size < 1 || patch_size > kRtMaxP || patch_distance < 1) return cudaErrorInvalidValue;
  const int pad = patch_size / 2;
  if (H <= pad || W <= pad) return cudaErrorInvalidValue;
  if (lo < 0 || hi > H || lo > hi || B > 65535) return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || warps < 1 || warps > kClusterMaxWarps ||
      (rows != 4 && rows != 8))
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const int out_cols = 33 - patch_size;
  const dim3 grid(((W + out_cols - 1) / out_cols) * cluster, (H + 2 * rows - 1) / (2 * rows), B);
  const long long tile = (long long)(2 * rows + patch_size - 1 + 2 * patch_distance) * (32 + 2 * patch_distance);
  const size_t smem = sizeof(float) * (2 * tile + 2 * warps * 2 * rows * 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 8)
    return launch_cluster_rt<8>(grid, warps, cluster, smem, st, x, h, sigma, out, H, W, patch_size,
                                patch_distance, lo, hi);
  return launch_cluster_rt<4>(grid, warps, cluster, smem, st, x, h, sigma, out, H, W, patch_size,
                              patch_distance, lo, hi);
}
