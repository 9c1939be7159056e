// BM3D aggregation, fused: the patch scatter-add and the unfold-add in one
// pass from group estimates to the (num, den) images, in a fixed summation
// order.
//
// Replaces the Pallas kernel `_scatter_kernel` / `bm3d_scatter_pallas` in
// pnp_svrg_tpu/ops/pallas/bm3d_scatter.py together with the static unfold-add
// `_unfold_table` that follows it in `_aggregate`
// (pnp_svrg_tpu/denoisers/bm3d.py). For every image b, group g (one per
// reference block, G = nR * nC) and member k (K per group, p = g * K + k)
// whose patch sits at row idx[b, p] = py * ww + px of the patch-position
// table (ww = W - block + 1):
//
//   wk       = wgt[b, g] * kaiser                  (block * block values)
//   num[b, py + ky, px + kx] += est[b, p, ky * block + kx] * wk[ky, kx]
//   den[b, py + ky, px + kx] += wk[ky, kx]
//
// which is `_unfold_table(scatter(idx, [est * wk | wk]))` without the
// (B, hh * ww, 2 * block * block) table: wk is formed first and then
// est * wk, in the JAX order, so each term rounds as it does there.
//
// Bound on the H100: HBM bytes. At the headline shape (13 images of 128x128,
// 15376 members of 64 f32 each) one call must read ~51 MB of estimates and
// ~1 MB of indices and weights and write 1.7 MB of planes; there is no
// arithmetic to speak of (~0.016 ms at 3.35 TB/s).
//
// Design, two launches on one stream. (1) `bm3d_aggregate_kernel`: one CTA
// of kWarps warps per (image, kTileR x kTileC tile of reference blocks).
// `_gather_groups` clips member coordinates to [0, H - block], so every
// member of the tile lands inside a footprint of at most fh x fw pixels
// whose origin (tile_oy, tile_ox) the host computes (for search 8 and a
// 2 x 2 tile of step-4 blocks, 28 x 28 pixels). Each warp holds its own
// numerator and denominator planes of that footprint in shared memory and
// streams its share of the tile's members in a fixed order (64 f32 a
// member, read as two coalesced 128-byte rows, kUnroll members in flight);
// it adds one member at a time with plain read-modify-writes, which cannot
// collide because a patch's 64 pixels are distinct and no other warp writes
// those planes. After one barrier the CTA sums its warps' planes in a fixed
// order and stores the whole fh x fw footprint, zeros included, with plain
// stores into its own slot of a scratch buffer (image, tile row, tile
// column). (2) `bm3d_aggregate_fold_kernel`: one thread an output pixel sums
// the footprints that cover it in ascending (tile row, tile column) order
// (the host lists the covering tile rows and columns of every pixel row and
// column) and stores num and den. No float atomic is left, so the result
// depends on the inputs alone: two calls give the same bits. The scratch
// (at the headline shape 3328 tiles x 2 x 28 x 28 f32, 20.9 MB) is written
// and read once, from the 50 MB L2 for the most part.
//
// The fold comes in two forms with the same order of adds, so the same
// bits. Over many pixels (the headline's 13 images) it streams: a thread
// adds as it loads, few registers, every SM full of warps. Over few (one
// image), too few warps are resident to hide L2's latency that way, so each
// thread issues all of its up to kMaxCover x kMaxCover loads before its
// first add, at a cost in registers that pays only there (PERF.md). The
// launch picks the form by the pixel count (kFewPixels;
// `python -m pnp_svrg_tpu_torch.examples.k2_variants` times both forms at
// every size). A single launch, in which the CTA that completes the count
// of a cell of the image folds that cell, was slower at every size: the
// fold's registers, held by the whole kernel, cut the tiles' occupancy.
//
// A member outside its tile's footprint (the BM3D geometry never makes one)
// is not added by (1); the CTA marks its image in `overflow` with this
// call's `epoch` (a plain store; the wrapper counts calls, so no flag needs
// clearing), and (2) then adds, after the footprints, every such member
// that covers the pixel, in ascending member order. Any row in
// [0, hh * ww) so gives the right sum, still in a fixed order (a scan of all
// the image's members a pixel: slow, and never taken by BM3D). A member
// whose row lies outside that range is dropped (the wrapper's docstring
// says so).
//
// Why no shared-memory atomics: sm_90a has no native shared-memory f32 add.
// An atomicAdd on a shared float compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), and a first version of this kernel that
// added into one pair of planes per CTA that way was about twice as slow
// (PERF.md).
// Small tiles keep the private planes small (4 x 2 x 28 x 28 f32, 25 KB a
// CTA) and give the headline 3328 CTAs of 4 warps (each warp 16 of the
// tile's 64 members: at B = 1 four warps ran the 128 px call in 0.0107 ms
// against two warps' 0.0144 on an H100, `examples/k2_variants.py`); the
// row is decoded without an integer division.
//
// The tile kernel is a template on (BLOCK, KK): lane l owns the patch values
// l + 32 q (q < ceil(block^2 / 32)), with fewer members in flight where a
// patch needs more registers. It is compiled with (block, K) constant at (8,
// 16), the headline's (lane l owns (ky, kx) and (ky + 4, kx), eight members
// in flight), and at (8, 32), the reference profile's Wiener stage. Both
// have the same tiles, warps, private planes and order of adds. The fold
// reads (block, K) at run time: they feed only its out-of-footprint scan.
// Footprints grow with the search window and the step (49 x 49 pixels at
// step 3, search 19), so a pixel may be covered by more than kMaxCover tiles
// an axis; the fold then takes its streaming form, by rule, in the same
// order of adds.
//
// Every other call (block 1-32, K 1-128): `bm3d_aggregate_packed_kernel<Q>`.
// Its bound is the same (bytes: at the golden oracle's block 4, step 2,
// search 3, K 4 and 13 images of 128 x 128, 13.2 MB of estimates and 1.7
// MB of planes, 0.0048 ms). The first design for these calls,
// `bm3d_aggregate_kernel<0, 0>` (the template with block and K read at run
// time, on 2 x 2 tiles), lost to one `index_add_` there: with 4 x 4 patches
// a CTA of 4 warps held 16 members on 12 x 12 footprints, so 13,312 CTAs
// each zeroed, summed and stored planes larger than the members they held
// (15.3 MB of scratch against 13.2 MB of estimates), and half of every
// warp's lanes sat idle on 16-value patches. The packed kernel answers
// both. (1) Lane groups: where block^2 <= 16 a warp's lanes form 32 /
// block^2 groups of block^2 lanes (8 groups at block 2, 2 at block 4), each
// adding its own members into its own pair of planes, so every lane works
// and no two lanes of an instruction add to one pixel; a CTA sums its
// groups' planes in a fixed order (warp, then group). Q (values a lane) is
// a template argument, 1-8, and sizes the registers; a lane's values of a
// whole-warp member (Q > 1) are at compile-time strides. (2) The tile shape
// is the host's (`packed_plan` in ops/cuda/bm3d_aggregate.py, read at run
// time with the warps and groups): one warp where lanes are grouped, else
// two, and the smallest square tile, 2 x 2 at least, whose members give each
// warp 1,024 values to add; more members per footprint, few CTAs' planes to
// zero and sum, and enough small CTAs in flight (k2_variants.py times tile
// edges 2-12 with 1, 2 and 4 warps). The fold is the template with the tile
// shape read at run time (kTR = 0), in the same order of adds. Each call
// stays bit for bit the same from run to run (no float atomic), exact on
// dyadic values, and holds the out-of-footprint scan and the dropping of
// rows outside the table. Past block 16 (more than 8 x 32 values a member)
// Q = 0 reads the values a lane at run time: a warp takes one member at a
// time and its lane j the values j + 32 q, in the same tiles, planes and
// order of adds (member order within a plane). Grids with gaps between
// blocks (a step past the block) leave pixels no member covers: no tile's
// footprint holds them, so the fold writes 0 to both planes there, as the
// plain version's sums of nothing are.
//
// The calls where staged footprints lose (`aggregate_plan` in
// ops/cuda/bm3d_aggregate.py names them: one-pixel or sparse members, blocks
// past 16, windows far wider than the step): `bm3d_aggregate_gather_kernel`,
// output-stationary, with no footprint, scratch plane or fold. Its bound is
// the same (bytes). Two launches. (1) `bm3d_aggregate_index_kernel` builds a
// per-call member index: each image's members bucketed by patch position
// (row `py * ww + px`), a CSR of B * (hh * ww + 1) offsets and the member ids
// of each bucket in ascending order. One CTA per (image, run of table rows)
// reads the image's rows once (16-byte loads), counts its own rows in shared
// memory (integer atomics) and keeps their members there, scans the counts,
// fills its buckets and sorts each by member id (an entry's rank is the
// number of smaller ids in its bucket), so the index does not depend on the
// order in which the fill's atomics land. A run whose members pass the CTA's
// shared memory fills and sorts through global scratch instead, same result.
// Rows outside [0, hh * ww) enter no bucket: they are dropped. (2) The
// gather kernel: one CTA per (image, tile of output pixels). From block 3 on
// (R = 1) a warp owns 8 columns x 4 rows, a lane a pixel with its sums in
// registers: the warp stages the offsets of every bucket whose patch
// overlaps them (a few rows of the CSR) in its shared memory and walks those
// buckets' members as one list in ascending (py, px, member id), 32 entries
// a window (the next window's ids in flight), U members a batch: for each
// member the lanes its patch covers load their values (a patch row's
// contiguous floats a lane row), form wk = wgt * kaiser and then est * wk,
// and add. At blocks 1-2 (R = 0) a thread owns one pixel and walks its own b
// x b buckets in the same order (a one-pixel member has no patch row to
// share). Every pixel so sums its terms in ascending patch position, then
// member id, whatever lies where: no float atomic, no out-of-footprint scan,
// and pixels no member covers get 0. A member overlapping several warps'
// tiles is read by each (from L2 for the most part). At the wide windows
// the walk is bound by its instructions and by its heaviest warps (the
// walks' loads: `walk_load` in examples/k2_variants.py), not by the
// estimates' bytes (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kTileR = 2;  // reference-block rows per CTA
constexpr int kTileC = 2;  // reference-block columns per CTA
constexpr int kWarps = 4;  // each with private planes
constexpr int kUnroll = 8;  // members each warp has in flight (at most)
constexpr int kFoldThreads = 256;
constexpr int kMaxCover = 6;  // the fold's covering tiles an axis, loaded at once
constexpr long long kFewPixels = 1 << 17;  // fold all at once up to this many pixels
constexpr int kPackedMaxWarps = 8;  // the packed kernel's warps a CTA, at most
constexpr int kIndexMaxThreads = 1024;  // the index kernel's threads a CTA, at most
constexpr int kIndexUnroll = 4;  // rows each index thread has in flight (an int4)
constexpr int kGatherMaxWarps = 16;  // the gather kernel's warps a CTA, at most

// Whether a block x block member at (py, px) lies inside the fh x fw
// footprint at (oy, ox).
__device__ __forceinline__ bool in_footprint(int py, int px, int oy, int ox, int fh, int fw,
                                             int block) {
  const int ly = py - oy;
  const int lx = px - ox;
  return ly >= 0 && lx >= 0 && ly + block <= fh && lx + block <= fw;
}

// (BLOCK, KK = 0: `block_rt`, `k_rt`.)
template <int BLOCK, int KK>
__global__ void __launch_bounds__(kWarps * 32)
bm3d_aggregate_kernel(const int* __restrict__ idx, const float* __restrict__ est,
                      const float* __restrict__ wgt, const float* __restrict__ kaiser,
                      const int* __restrict__ tile_oy, const int* __restrict__ tile_ox,
                      float* __restrict__ scratch, int* __restrict__ overflow, int epoch,
                      int H, int W, int nR, int nC, int fh, int fw, int block_rt, int k_rt) {
  constexpr int kQ = BLOCK > 0 ? (BLOCK * BLOCK + 31) / 32 : 8;  // values a lane, at most
  constexpr int kInFlight = kQ <= 2 ? kUnroll : (kQ <= 4 ? 4 : 2);
  const int block = BLOCK > 0 ? BLOCK : block_rt;
  const int K = KK > 0 ? KK : k_rt;
  const int bb = block * block;
  extern __shared__ float planes[];  // kWarps x (num, den) x fh x fw
  const int plane = fh * fw;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTileR;
  const int c0 = blockIdx.x * kTileC;
  const int nr = min(kTileR, nR - r0);
  const int nc = min(kTileC, nC - c0);
  const int oy = tile_oy[blockIdx.y];
  const int ox = tile_ox[blockIdx.x];
  const int tid = threadIdx.x;
  for (int q = tid; q < 2 * kWarps * plane; q += kWarps * 32) planes[q] = 0.f;
  __syncthreads();

  const int ww = W - block + 1;
  const int n_rows = (H - block + 1) * ww;
  const float inv_ww = 1.f / (float)ww;
  const long long G = (long long)nR * nC;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* s_num = planes + warp * 2 * plane;
  float* s_den = s_num + plane;
  // Lane owns patch values v = lane + 32 q: (ky, kx) = (v / block, v % block),
  // none where v >= block^2 (at[q] < 0). Where block^2 is a compiled multiple
  // of 32 (kFull) every lane owns kQ values and the tests go: ptxas schedules
  // the (8, 16) tiles faster without them (`lane_tests` in
  // examples/k2_variants.py; PERF.md).
  constexpr bool kFull = BLOCK > 0 && BLOCK * BLOCK % 32 == 0;
  int at[kQ];
  float kai[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int v = lane + 32 * q;
    at[q] = (kFull || v < bb) ? (v / block) * fw + v % block : -1;
    kai[q] = (kFull || v < bb) ? __ldg(kaiser + v) : 0.f;
  }

  // Member slot m: reference block t = m / K of the tile, member m % K.
  const int slots = kTileR * kTileC * K;
  for (int m0 = warp; m0 < slots; m0 += kWarps * kInFlight) {
    int row[kInFlight];
    float w[kInFlight], e[kInFlight][kQ];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int m = m0 + u * kWarps;
      const int t = m / K;
      const int i = t / kTileC;
      const int j = t % kTileC;
      row[u] = -1;
      if (m < slots && i < nr && j < nc) {
        const long long g = (long long)b * G + (r0 + i) * nC + c0 + j;
        const long long p = g * K + m % K;
        row[u] = __ldg(idx + p);
        w[u] = __ldg(wgt + g);
#pragma unroll
        for (int q = 0; q < kQ; ++q) e[u][q] = (kFull || at[q] >= 0) ? __ldg(est + p * bb + lane + 32 * q) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (row[u] < 0 || row[u] >= n_rows) continue;
      // row = py * ww + px, decoded without an integer division.
      int py = (int)(((float)row[u] + 0.5f) * inv_ww);
      int px = row[u] - py * ww;
      if (px < 0) {
        --py;
        px += ww;
      } else if (px >= ww) {
        ++py;
        px -= ww;
      }
      if (!in_footprint(py, px, oy, ox, fh, fw, block)) {
        overflow[b] = epoch;  // the fold adds this member
        continue;
      }
      // The warp's own planes and one member at a time: the pixels of a
      // patch are distinct, so plain read-modify-writes do not collide.
      const int a = (py - oy) * fw + px - ox;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (!kFull && at[q] < 0) continue;
        const float wk = __fmul_rn(w[u], kai[q]);
        s_num[a + at[q]] += __fmul_rn(e[u][q], wk);
        s_den[a + at[q]] += wk;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Sum the warps' planes in a fixed order into this tile's scratch slot.
  float* out = scratch + (((long long)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 2 * plane;
  for (int q = tid; q < plane; q += kWarps * 32) {
    float n = 0.f, d = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      n += planes[v * 2 * plane + q];
      d += planes[v * 2 * plane + plane + q];
    }
    out[q] = n;
    out[plane + q] = d;
  }
}

// The packed tile kernel: every call but (8, 16) and (8, 32). One CTA of
// `blockDim.x / 32` warps per (image, tile_r x tile_c tile of reference
// blocks, the host's choice); each warp's lanes form `groups` groups of
// 32 / groups lanes, and each group holds its own numerator and denominator
// planes of the tile's footprint, so no two lanes add to one pixel in the
// same instruction. Q: patch values a lane (1 wherever groups > 1).
template <int Q>
__global__ void __launch_bounds__(kPackedMaxWarps * 32)
bm3d_aggregate_packed_kernel(const int* __restrict__ idx, const float* __restrict__ est,
                             const float* __restrict__ wgt, const float* __restrict__ kaiser,
                             const int* __restrict__ tile_oy, const int* __restrict__ tile_ox,
                             float* __restrict__ scratch, int* __restrict__ overflow, int epoch,
                             int H, int W, int nR, int nC, int fh, int fw, int block, int k_shift,
                             int tile_r, int tile_c, int groups) {
  constexpr int kInFlight = Q <= 2 ? kUnroll : 4;
  const int bb = block * block;
  const int lanes = Q > 1 ? 32 : 32 / groups;  // lanes a member (a whole warp where Q > 1)
  const int n_planes = (blockDim.x >> 5) * groups;
  extern __shared__ float planes[];  // n_planes x (num, den) x fh x fw
  const int plane = fh * fw;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * tile_r;
  const int c0 = blockIdx.x * tile_c;
  const int nr = min(tile_r, nR - r0);
  const int nc = min(tile_c, nC - c0);
  const int oy = tile_oy[blockIdx.y];
  const int ox = tile_ox[blockIdx.x];
  const int tid = threadIdx.x;
  for (int q = tid; q < 2 * n_planes * plane; q += blockDim.x) planes[q] = 0.f;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = Q > 1 ? 0 : lane / lanes;  // lanes past groups * lanes sit idle
  const int j = lane - grp * lanes;
  const bool busy = grp < groups;
  // Lane j of a group owns patch values v = j + lanes * q.
  int at[Q];
  float kai[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int v = j + lanes * q;
    const bool own = busy && v < bb;
    at[q] = own ? (v / block) * fw + v % block : -1;
    kai[q] = own ? __ldg(kaiser + v) : 0.f;
  }
  float* s_num = planes + (warp * groups + (busy ? grp : 0)) * 2 * plane;
  float* s_den = s_num + plane;

  const int ww = W - block + 1;
  const int n_rows = (H - block + 1) * ww;
  const float inv_ww = 1.f / (float)ww;
  // The tile's members, tile row by tile row: row i's nc * K members are
  // contiguous in est. Member m of the tile goes to group m % n_planes of
  // the CTA (warp-major), the groups of a step taking consecutive members.
  const int run = nc << k_shift;
  const int total = nr * run;
  const float inv_run = 1.f / (float)run;
  const long long first_group = (long long)b * nR * nC;
  for (int m0 = warp * groups; m0 < total; m0 += n_planes * kInFlight) {
    int row[kInFlight];
    float w[kInFlight], e[kInFlight][Q];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int m = m0 + u * n_planes + grp;
      row[u] = -1;
      if (busy && m < total) {
        int i = (int)(((float)m + 0.5f) * inv_run);  // m = i * run + rest, without a division
        int rest = m - i * run;
        if (rest < 0) {
          --i;
          rest += run;
        } else if (rest >= run) {
          ++i;
          rest -= run;
        }
        const long long p = ((first_group + (long long)(r0 + i) * nC + c0) << k_shift) + rest;
        row[u] = __ldg(idx + p);
        w[u] = __ldg(wgt + (p >> k_shift));
#pragma unroll
        for (int q = 0; q < Q; ++q) e[u][q] = at[q] >= 0 ? __ldg(est + p * bb + j + lanes * q) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      bool add = row[u] >= 0 && row[u] < n_rows;
      int a = 0;
      if (add) {
        int py = (int)(((float)row[u] + 0.5f) * inv_ww);  // row = py * ww + px
        int px = row[u] - py * ww;
        if (px < 0) {
          --py;
          px += ww;
        } else if (px >= ww) {
          ++py;
          px -= ww;
        }
        if (in_footprint(py, px, oy, ox, fh, fw, block)) {
          a = (py - oy) * fw + px - ox;
        } else {
          overflow[b] = epoch;  // the fold adds this member
          add = false;
        }
      }
      if (add) {  // the group's own planes, one member at a time
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (at[q] < 0) continue;
          const float wk = __fmul_rn(w[u], kai[q]);
          s_num[a + at[q]] += __fmul_rn(e[u][q], wk);
          s_den[a + at[q]] += wk;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Sum the groups' planes in a fixed order (warp, then group) into this
  // tile's scratch slot.
  float* out = scratch + (((long long)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 2 * plane;
  for (int q = tid; q < plane; q += blockDim.x) {
    float n = 0.f, d = 0.f;
    for (int v = 0; v < n_planes; ++v) {
      n += planes[v * 2 * plane + q];
      d += planes[v * 2 * plane + plane + q];
    }
    out[q] = n;
    out[plane + q] = d;
  }
}

// The packed kernel with the values a lane read at run time (Q = 0), for
// blocks past 16: one warp a member at a time, lane j its values j + 32 q,
// the tile's members shared out over the CTA's warps as above (one lane
// group a warp), each warp its own pair of planes.
template <>
__global__ void __launch_bounds__(kPackedMaxWarps * 32)
bm3d_aggregate_packed_kernel<0>(const int* __restrict__ idx, const float* __restrict__ est,
                                const float* __restrict__ wgt, const float* __restrict__ kaiser,
                                const int* __restrict__ tile_oy, const int* __restrict__ tile_ox,
                                float* __restrict__ scratch, int* __restrict__ overflow, int epoch,
                                int H, int W, int nR, int nC, int fh, int fw, int block, int k_shift,
                                int tile_r, int tile_c, int groups) {
  const int bb = block * block;
  const int n_planes = blockDim.x >> 5;
  extern __shared__ float planes[];  // n_planes x (num, den) x fh x fw
  const int plane = fh * fw;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * tile_r;
  const int c0 = blockIdx.x * tile_c;
  const int nr = min(tile_r, nR - r0);
  const int nc = min(tile_c, nC - c0);
  const int oy = tile_oy[blockIdx.y];
  const int ox = tile_ox[blockIdx.x];
  const int tid = threadIdx.x;
  for (int q = tid; q < 2 * n_planes * plane; q += blockDim.x) planes[q] = 0.f;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* s_num = planes + warp * 2 * plane;
  float* s_den = s_num + plane;
  const int ww = W - block + 1;
  const int n_rows = (H - block + 1) * ww;
  const int run = nc << k_shift;
  const int total = nr * run;
  const long long first_group = (long long)b * nR * nC;
  for (int m = warp; m < total; m += n_planes) {
    const int i = m / run, rest = m - (m / run) * run;
    const long long p = ((first_group + (long long)(r0 + i) * nC + c0) << k_shift) + rest;
    const int row = __ldg(idx + p);
    if (row < 0 || row >= n_rows) continue;
    const int py = row / ww, px = row - (row / ww) * ww;
    if (!in_footprint(py, px, oy, ox, fh, fw, block)) {
      if (lane == 0) overflow[b] = epoch;  // the fold adds this member
      continue;
    }
    const float w = __ldg(wgt + (p >> k_shift));
    const int a = (py - oy) * fw + px - ox;
    for (int v = lane; v < bb; v += 32) {
      const int ky = v / block, kx = v - (v / block) * block;
      const float wk = __fmul_rn(w, __ldg(kaiser + v));
      s_num[a + ky * fw + kx] += __fmul_rn(__ldg(est + p * bb + v), wk);
      s_den[a + ky * fw + kx] += wk;
    }
    __syncwarp();
  }
  __syncthreads();

  float* out = scratch + (((long long)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 2 * plane;
  for (int q = tid; q < plane; q += blockDim.x) {
    float n = 0.f, d = 0.f;
    for (int v = 0; v < n_planes; ++v) {
      n += planes[v * 2 * plane + q];
      d += planes[v * 2 * plane + plane + q];
    }
    out[q] = n;
    out[plane + q] = d;
  }
}

// Pixel (y, x)'s sum over the footprints that cover it, in ascending (tile
// row, tile column) order, from its image's footprints `scratch`. With
// kAllAtOnce (and up to kMaxCover tiles an axis) every load is issued
// before the first add, so the loads overlap; else each add follows its
// load.
template <bool kAllAtOnce>
__device__ __forceinline__ void fold_pixel(const float* __restrict__ scratch, const int* tile_oy,
                                           const int* tile_ox, const int* cover_y,
                                           const int* cover_x, int y, int x, int n_tx, int plane,
                                           int fw, float& n, float& d) {
  const int ty0 = __ldg(cover_y + 2 * y);
  const int ny = __ldg(cover_y + 2 * y + 1) - ty0 + 1;
  const int tx0 = __ldg(cover_x + 2 * x);
  const int nx = __ldg(cover_x + 2 * x + 1) - tx0 + 1;
  n = 0.f;
  d = 0.f;
  if (kAllAtOnce && ny <= kMaxCover && nx <= kMaxCover) {
    int row[kMaxCover], col[kMaxCover];
#pragma unroll
    for (int i = 0; i < kMaxCover; ++i) {
      row[i] = i < ny ? (ty0 + i) * n_tx * 2 * plane + (y - __ldg(tile_oy + ty0 + i)) * fw : 0;
      col[i] = i < nx ? (tx0 + i) * 2 * plane + x - __ldg(tile_ox + tx0 + i) : 0;
    }
    float vn[kMaxCover][kMaxCover], vd[kMaxCover][kMaxCover];
#pragma unroll
    for (int i = 0; i < kMaxCover; ++i) {
#pragma unroll
      for (int j = 0; j < kMaxCover; ++j) {
        if (i < ny && j < nx) {
          vn[i][j] = __ldg(scratch + row[i] + col[j]);
          vd[i][j] = __ldg(scratch + row[i] + col[j] + plane);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxCover; ++i) {
#pragma unroll
      for (int j = 0; j < kMaxCover; ++j) {
        if (i < ny && j < nx) {
          n += vn[i][j];
          d += vd[i][j];
        }
      }
    }
    return;
  }
  for (int ty = ty0; ty < ty0 + ny; ++ty) {
    const int r = ty * n_tx * 2 * plane + (y - __ldg(tile_oy + ty)) * fw + x;
    for (int tx = tx0; tx < tx0 + nx; ++tx) {
      const float* q = scratch + r + tx * 2 * plane - __ldg(tile_ox + tx);
      n += __ldg(q);
      d += __ldg(q + plane);
    }
  }
}

// One thread an output pixel: the covering footprints in ascending (tile
// row, tile column) order, then, if the image overflowed in this call, its
// members outside their footprints in ascending member order. The tiles are
// kTR x kTC reference blocks (2 x 2 for `bm3d_aggregate_kernel`), or
// `tile_r` x `tile_c` read at run time where kTR = 0 (the packed kernel's,
// whose `n_ty` x `n_tx` tiles an image the host counts).
template <bool kAllAtOnce, int kTR, int kTC>
__global__ void __launch_bounds__(kFoldThreads)
bm3d_aggregate_fold_kernel(const float* __restrict__ scratch, const int* __restrict__ tile_oy,
                           const int* __restrict__ tile_ox, const int* __restrict__ cover_y,
                           const int* __restrict__ cover_x, const int* __restrict__ overflow,
                           int epoch, const int* __restrict__ idx, const float* __restrict__ est,
                           const float* __restrict__ wgt, const float* __restrict__ kaiser,
                           float* __restrict__ num, float* __restrict__ den, int B, int H, int W,
                           int nR, int nC, int fh, int fw, int block, int K, int tile_r_rt,
                           int tile_c_rt, int n_ty_rt, int n_tx_rt) {
  const long long i = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= (long long)B * H * W) return;
  const int tile_r = kTR > 0 ? kTR : tile_r_rt;
  const int tile_c = kTC > 0 ? kTC : tile_c_rt;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int b = (int)(i / ((long long)H * W));
  const int n_ty = kTR > 0 ? (nR + kTR - 1) / kTR : n_ty_rt;
  const int n_tx = kTC > 0 ? (nC + kTC - 1) / kTC : n_tx_rt;
  const int plane = fh * fw;
  float n, d;
  fold_pixel<kAllAtOnce>(scratch + (long long)b * n_ty * n_tx * 2 * plane, tile_oy, tile_ox, cover_y, cover_x,
             y, x, n_tx, plane, fw, n, d);
  if (overflow[b] == epoch) {
    const int ww = W - block + 1;
    const int n_rows = (H - block + 1) * ww;
    const long long G = (long long)nR * nC;
    for (long long p = 0; p < G * K; ++p) {
      const int r = __ldg(idx + b * G * K + p);
      if (r < 0 || r >= n_rows) continue;
      const int py = r / ww;
      const int px = r - py * ww;
      if (y < py || y >= py + block || x < px || x >= px + block) continue;
      const long long g = p / K;
      const int gr = (int)(g / nC);
      const int gc = (int)(g % nC);
      if (in_footprint(py, px, tile_oy[gr / tile_r], tile_ox[gc / tile_c], fh, fw, block)) continue;
      const int k = (y - py) * block + x - px;
      const float wk = __fmul_rn(__ldg(wgt + b * G + g), __ldg(kaiser + k));
      n += __fmul_rn(__ldg(est + (b * G * K + p) * (block * block) + k), wk);
      d += wk;
    }
  }
  num[i] = n;
  den[i] = d;
}

// The tile kernel of (BLOCK, KK), opted into `smem` bytes of shared memory.
template <int BLOCK, int KK>
cudaError_t launch_tiles(dim3 grid, size_t smem, cudaStream_t s, const int* idx, const float* est,
                         const float* wgt, const float* kaiser, const int* tile_oy,
                         const int* tile_ox, float* scratch, int* overflow, int epoch, int H,
                         int W, int nR, int nC, int fh, int fw, int block, int K) {
  static size_t granted = 48 * 1024;  // opted into so far
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(bm3d_aggregate_kernel<BLOCK, KK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  bm3d_aggregate_kernel<BLOCK, KK><<<grid, kWarps * 32, smem, s>>>(
      idx, est, wgt, kaiser, tile_oy, tile_ox, scratch, overflow, epoch, H, W, nR, nC, fh, fw, block, K);
  return cudaGetLastError();
}

// The packed kernel of Q values a lane, opted into `smem` bytes.
template <int Q>
cudaError_t launch_packed(dim3 grid, int warps, size_t smem, cudaStream_t s, const int* idx,
                          const float* est, const float* wgt, const float* kaiser,
                          const int* tile_oy, const int* tile_ox, float* scratch, int* overflow,
                          int epoch, int H, int W, int nR, int nC, int fh, int fw, int block,
                          int k_shift, int tile_r, int tile_c, int groups) {
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(bm3d_aggregate_packed_kernel<Q>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  bm3d_aggregate_packed_kernel<Q><<<grid, warps * 32, smem, s>>>(
      idx, est, wgt, kaiser, tile_oy, tile_ox, scratch, overflow, epoch, H, W, nR, nC, fh, fw, block,
      k_shift, tile_r, tile_c, groups);
  return cudaGetLastError();
}

// The CTA's sum of one int a thread (`warp_sums`: 33 ints of shared memory).
__device__ int cta_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

// Exclusive scan of s[0, n) in place by the CTA (each thread a contiguous
// run of ceil(n / blockDim.x) entries); returns the total.
__device__ int cta_exclusive_scan(int* s, int n, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + (int)blockDim.x - 1) / (int)blockDim.x;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += s[i];
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, vi, o);
      if (lane >= o) vi += u;
    }
    warp_sums[lane] = vi - v;
    if (lane == 31) warp_sums[32] = vi;
  }
  __syncthreads();
  int run = warp_sums[warp] + inc - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = s[i];
    s[i] = run;
    run += c;
  }
  const int total = warp_sums[32];
  __syncthreads();
  return total;
}

// The index kernel's sort of one run's filled rows (members sp, rows less
// r0 sr, `total` of them; start: each row's first slot, then the end) into
// `ids` from `first` on: an entry's place in its row is the number of
// smaller ids there (an image's ids are distinct). Called on shared or on
// global memory, each call site its own.
__device__ __forceinline__ void sort_run(const int* sp, const int* sr, const int* start, int first, int total,
                                         int* __restrict__ ids) {
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const int v = sp[j], row = sr[j];
    const int s = start[row] - first, e = start[row + 1] - first;
    int rank = 0;
    for (int q = s; q < e; ++q) rank += sp[q] < v;
    ids[first + s + rank] = v;
  }
}

// The gather form's member index, for image blockIdx.y and its run of table
// rows [r0, r0 + rn), r0 = blockIdx.x * chunk_rows: the CSR offsets of those
// rows (positions in `ids`, image b's entries from b * P on; the last run
// also writes the image's end) and each row's member ids in ascending
// order. The CTA reads the image's rows once (the next batch's loads in
// flight over this one's counting); up to `cap` members of its run stay in
// shared memory, where they are filled into their rows and sorted; a run
// with more goes through `any_ids` / `any_rows` (B * P ints each) instead,
// with the same result.
__global__ void __launch_bounds__(kIndexMaxThreads)
bm3d_aggregate_index_kernel(const int* __restrict__ idx, int* __restrict__ offsets, int* __restrict__ ids,
                            int* any_ids, int* any_rows, int P, int nrows, int chunk_rows, int cap) {
  extern __shared__ int sm[];
  int* start = sm;                    // chunk_rows + 1: each row's first slot, then the run's end
  int* cur = start + chunk_rows + 1;  // chunk_rows: the counts, then the fill's cursors
  int* warp_sums = cur + chunk_rows;  // 33
  int* n_list = warp_sums + 33;       // 1: members of the run
  int* list_p = n_list + 1;           // cap: the run's members, in arrival order
  int* list_r = list_p + cap;         // cap: their rows less r0
  int* slot_p = list_r + cap;         // cap: the filled rows' members
  int* slot_r = slot_p + cap;         // cap: their rows less r0
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * chunk_rows;
  const int rn = min(chunk_rows, nrows - r0);
  const int* rows = idx + (long long)b * P;
  for (int i = tid; i < rn; i += nt) cur[i] = 0;
  if (tid == 0) *n_list = 0;
  __syncthreads();

  // Count the run's rows, keep its members, count the members of earlier
  // rows: each row less r0, which is the run's if below rn. A thread takes
  // kIndexUnroll consecutive members a batch (one 16-byte load where the
  // image's rows are so aligned), the next batch in flight.
  const bool vec = (P & 3) == 0 && (reinterpret_cast<unsigned long long>(idx) & 15) == 0;
  auto load = [&](int p, int* r) {
    if (vec && p + kIndexUnroll <= P) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(rows + p));
      r[0] = v.x;
      r[1] = v.y;
      r[2] = v.z;
      r[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < kIndexUnroll; ++u) r[u] = p + u < P ? __ldg(rows + p + u) : -1;
    }
  };
  int below = 0;
  int r[kIndexUnroll];
  load(tid * kIndexUnroll, r);
  for (int p0 = 0; p0 < P; p0 += nt * kIndexUnroll) {
    const int p1 = p0 + tid * kIndexUnroll;
    int next[kIndexUnroll];
    load(p1 + nt * kIndexUnroll, next);
    bool any = false;
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u) {
      below += (unsigned)r[u] < (unsigned)r0;
      r[u] = (int)((unsigned)r[u] - (unsigned)r0);
      any |= (unsigned)r[u] < (unsigned)rn;
    }
    if (__any_sync(0xffffffffu, any)) {
      int mine = 0;
#pragma unroll
      for (int u = 0; u < kIndexUnroll; ++u) mine += (unsigned)r[u] < (unsigned)rn;
      int inc = mine;  // the warp's members of the run before this lane's, and all
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      int at = 0;
      if (lane == 31) at = atomicAdd(n_list, inc);
      at = __shfl_sync(0xffffffffu, at, 31) + inc - mine;
#pragma unroll
      for (int u = 0; u < kIndexUnroll; ++u) {
        if ((unsigned)r[u] < (unsigned)rn) {
          atomicAdd(&cur[r[u]], 1);
          if (at < cap) {
            list_p[at] = p1 + u;
            list_r[at] = r[u];
          }
          ++at;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u) r[u] = next[u];
  }
  const int first = b * P + cta_sum(below, warp_sums);
  for (int i = tid; i < rn; i += nt) start[i] = cur[i];
  __syncthreads();
  const int total = cta_exclusive_scan(start, rn, warp_sums);
  int* off = offsets + (long long)b * (nrows + 1) + r0;
  for (int i = tid; i < rn; i += nt) {
    start[i] += first;
    off[i] = start[i];
    cur[i] = 0;
  }
  if (tid == 0) {
    start[rn] = first + total;
    if (r0 + rn == nrows) off[rn] = first + total;
  }
  __syncthreads();

  // Fill each row of the run with its members, in any order, then sort
  // each by member id: in shared memory where the run's members fit, else
  // through global scratch.
  if (total <= cap) {
    for (int i = tid; i < total; i += nt) {
      const int row = list_r[i];
      const int at = start[row] - first + atomicAdd(&cur[row], 1);
      slot_p[at] = list_p[i];
      slot_r[at] = row;
    }
    __syncthreads();
    sort_run(slot_p, slot_r, start, first, total, ids);
  } else {
    int* sp = any_ids + first;
    int* sr = any_rows + first;
    for (int p = tid; p < P; p += nt) {
      const int row = (int)((unsigned)__ldg(rows + p) - (unsigned)r0);
      if ((unsigned)row < (unsigned)rn) {
        const int at = start[row] - first + atomicAdd(&cur[row], 1);
        sp[at] = p;
        sr[at] = row;
      }
    }
    __syncthreads();
    sort_run(sp, sr, start, first, total, ids);
  }
}

// A walking warp's staged ints in the gather kernel: its bucket offsets
// (the patch rows of its 4R rows by its 8 columns and one past) and its
// patch rows' first entries.
__host__ __device__ constexpr int gather_stage_ints(int r, int block) {
  return (4 * r + block - 1) * (block + 9) + 1;
}

// The gather form's sums: one CTA per (image blockIdx.z, tile of output
// pixels), every pixel's terms in ascending (patch position, member id)
// from the index (`offsets`, `ids`), written straight to num and den. R > 0:
// each warp 8 columns x 4R rows (`wx` warps across a CTA), lane l column
// l % 8 and rows l / 8 + 4i (i < R), one walk a warp; R = 0: 32 columns x 1
// row a warp, one walk a thread. U: members a walking warp has in flight.
template <int R, int U>
__global__ void __launch_bounds__(kGatherMaxWarps * 32)
bm3d_aggregate_gather_kernel(const float* __restrict__ est, const float* __restrict__ wgt,
                             const float* __restrict__ kaiser, const int* __restrict__ offsets,
                             const int* __restrict__ ids, float* __restrict__ num, float* __restrict__ den,
                             int H, int W, int P, int G, int block, int k_shift, int wx) {
  extern __shared__ float s_kai[];  // block^2, then (R > 0) each warp's staged offsets
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bb = block * block;
  for (int i = tid; i < bb; i += blockDim.x) s_kai[i] = __ldg(kaiser + i);
  __syncthreads();
  const int b = blockIdx.z;
  const int hh = H - block + 1, ww = W - block + 1;
  const int* off = offsets + (long long)b * (hh * ww + 1);
  const float* est_b = est + (long long)b * P * bb;
  const float* wgt_b = wgt + (long long)b * G;
  const long long plane = (long long)b * H * W;

  if constexpr (R == 0) {
    const int x = blockIdx.x * 32 + lane;
    const int y = blockIdx.y * (blockDim.x >> 5) + warp;
    if (x >= W || y >= H) return;
    float n = 0.f, d = 0.f;
    const int px_lo = max(0, x - block + 1), px_hi = min(x, ww - 1);
    for (int py = max(0, y - block + 1); py <= min(y, hh - 1); ++py) {
      const int* row_off = off + py * ww;
      int s = __ldg(row_off + px_lo);
      for (int px = px_lo; px <= px_hi; ++px) {
        const int e = __ldg(row_off + px + 1);
        const int k = (y - py) * block + x - px;
        const float kai = s_kai[k];
        for (; s < e; s += 2) {  // two members in flight, in ascending id
          const bool two = s + 1 < e;
          const int m0 = __ldg(ids + s);
          const int m1 = two ? __ldg(ids + s + 1) : m0;
          const float w0 = __ldg(wgt_b + (m0 >> k_shift)), v0 = __ldg(est_b + (long long)m0 * bb + k);
          const float w1 = __ldg(wgt_b + (m1 >> k_shift)), v1 = __ldg(est_b + (long long)m1 * bb + k);
          const float wk0 = __fmul_rn(w0, kai);
          n += __fmul_rn(v0, wk0);
          d += wk0;
          if (two) {
            const float wk1 = __fmul_rn(w1, kai);
            n += __fmul_rn(v1, wk1);
            d += wk1;
          }
        }
        s = e;
      }
    }
    num[plane + (long long)y * W + x] = n;
    den[plane + (long long)y * W + x] = d;
  } else {
    const int sx = (blockIdx.x * wx + warp % wx) * 8;
    const int sy = (blockIdx.y * ((int)(blockDim.x >> 5) / wx) + warp / wx) * (4 * R);
    if (sx >= W || sy >= H) return;  // a whole warp's tile
    const int x = sx + (lane & 7);
    const int y0 = sy + (lane >> 3);
    float n[R], d[R];
    int c[R];  // pixel i's (y, x) as y * block + x: its patch value k = c - (py * block + px)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      n[i] = 0.f;
      d[i] = 0.f;
      c[i] = (y0 + 4 * i) * block + x;
    }
    const int px_lo = max(0, sx - block + 1), px_hi = min(sx + 7, ww - 1);
    const int py_lo = max(0, sy - block + 1), py_hi = min(sy + 4 * R - 1, hh - 1);
    // The offsets of the warp's buckets (patch rows py_lo..py_hi, columns
    // px_lo..px_hi and one past) staged at once in its own shared memory,
    // and each patch row's first entry in the warp's walk (rp).
    const int ncol = px_hi - px_lo + 2, nrow = py_hi - py_lo + 1;
    int* so = reinterpret_cast<int*>(s_kai + bb) + warp * gather_stage_ints(R, block);
    int* rp = so + nrow * ncol;
    for (int i = lane; i < nrow * ncol; i += 32) {
      const int r = i / ncol;
      so[i] = __ldg(off + (py_lo + r) * ww + px_lo + i - r * ncol);
    }
    __syncwarp();
    int carry = 0;
    for (int r0 = 0; r0 < nrow; r0 += 32) {  // a warp's exclusive scan of the rows' entries
      const int r = r0 + lane;
      const int cr = r < nrow ? so[r * ncol + ncol - 1] - so[r * ncol] : 0;
      int inc = cr;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      if (r < nrow) rp[r] = carry + inc - cr;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) rp[nrow] = carry;
    __syncwarp();
    const int total = rp[nrow];
    // The walk's entry t: its patch row (the last row starting at or before
    // it), its place in the index and its bucket column (the first bucket
    // of that row ending past it).
    auto entry = [&](int t, int& r, int& q, int& px) {
      int lo = 0, hi = nrow - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (rp[mid] <= t) lo = mid;
        else hi = mid - 1;
      }
      r = lo;
      const int* row = so + r * ncol;
      q = row[0] + t - rp[r];
      int a = 0, z = ncol - 2;
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (row[mid + 1] > q) z = mid;
        else a = mid + 1;
      }
      px = px_lo + a;
    };
    // The walk in ascending (py, px, member id), 32 entries a window (lane
    // j holding entry j's id and bucket), U a batch; the next window's ids
    // in flight over this one's members.
    int r_, q_, px_;
    entry(lane, r_, q_, px_);
    int id = lane < total ? __ldg(ids + q_) : 0;
    for (int w0 = 0; w0 < total; w0 += 32) {
      const int cnt = min(32, total - w0);
      const int pyq = py_lo + r_, pxq = px_;
      int id2 = 0;
      if (w0 + 32 + lane < total) {
        entry(w0 + 32 + lane, r_, q_, px_);
        id2 = __ldg(ids + q_);
      }
      for (int t0 = 0; t0 < cnt; t0 += U) {
        float ev[U][R], wv[U];
        int kk[U][R];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + u;
          const int m = __shfl_sync(0xffffffffu, id, t & 31);
          const int px = __shfl_sync(0xffffffffu, pxq, t & 31);
          const int py = __shfl_sync(0xffffffffu, pyq, t & 31);
          const bool okx = t < cnt && (unsigned)(x - px) < (unsigned)block;
          wv[u] = okx ? __ldg(wgt_b + (m >> k_shift)) : 0.f;
          const int k0 = py * block + px;
          const float* src = est_b + (long long)m * bb - k0;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const bool ok = okx && (unsigned)(y0 + 4 * i - py) < (unsigned)block;
            kk[u][i] = ok ? c[i] - k0 : -1;
            ev[u][i] = ok ? __ldg(src + c[i]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if (kk[u][i] < 0) continue;
            const float wk = __fmul_rn(wv[u], s_kai[kk[u][i]]);
            n[i] += __fmul_rn(ev[u][i], wk);
            d[i] += wk;
          }
        }
      }
      id = id2;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int y = y0 + 4 * i;
      if (y < H && x < W) {
        num[plane + (long long)y * W + x] = n[i];
        den[plane + (long long)y * W + x] = d[i];
      }
    }
  }
}

// The gather kernel of R pixel rows a lane and U members in flight, opted
// into its shared memory:
// the Kaiser window, and with R > 0 each warp's staged bucket offsets and
// its patch rows' first entries.
template <int R, int U>
cudaError_t launch_gather(dim3 grid, int threads, cudaStream_t s, const float* est, const float* wgt,
                          const float* kaiser, const int* offsets, const int* ids, float* num, float* den,
                          int H, int W, int P, int G, int block, int k_shift, int wx) {
  const size_t smem = (block * block + (R > 0 ? (threads / 32) * gather_stage_ints(R, block) : 0)) * 4;
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(bm3d_aggregate_gather_kernel<R, U>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  bm3d_aggregate_gather_kernel<R, U><<<grid, threads, smem, s>>>(est, wgt, kaiser, offsets, ids, num, den, H, W, P,
                                                               G, block, k_shift, wx);
  return cudaGetLastError();
}

}  // namespace

// `idx` (B, P) int32 patch-position rows, `est` (B, P, block^2) f32, `wgt`
// (B, nR * nC) f32 with P = nR * nC * K (block in [2, 16], K in [1, 64]),
// `kaiser` (block^2,) f32; `tile_oy`
// (ceil(nR / 2),) and `tile_ox` (ceil(nC / 2),) int32 footprint origins and
// fh x fw the largest footprint (host-computed); `cover_y` (H, 2) and
// `cover_x` (W, 2) int32 the first and last tile row (column) whose
// footprint covers each pixel row (column); `scratch` f32 of at least
// B * ceil(nR / 2) * ceil(nC / 2) * 2 * fh * fw, `overflow` (B,) int32 and
// `epoch` a value `overflow` has never held (the wrapper counts calls);
// `num`/`den` (B, H, W) f32, every pixel written. Returns the first
// launch error (cudaError_t, 0 on success). Off (8, 16) and (8, 32) it
// runs `<0, 0>`, the replaced design, which the wrapper launches only by
// name, for timing it against the packed kernel on one call.
extern "C" int bm3d_aggregate_launch(const int* idx, const float* est, const float* wgt,
                                     const float* kaiser, const int* tile_oy,
                                     const int* tile_ox, const int* cover_y, const int* cover_x,
                                     float* scratch, int* overflow, int epoch, float* num,
                                     float* den, int B, int H, int W, int nR, int nC, int K,
                                     int block_size, int fh, int fw, void* stream) {
  if (block_size < 2 || block_size > 16 || K < 1 || K > 64 || fh < block_size || fw < block_size)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nR > 0 && nC > 0) {
    const size_t smem = 2 * (size_t)kWarps * fh * fw * sizeof(float);
    const dim3 grid((nC + kTileC - 1) / kTileC, (nR + kTileR - 1) / kTileR, B);
    const auto tiles = block_size == 8 && K == 16   ? launch_tiles<8, 16>
                       : block_size == 8 && K == 32 ? launch_tiles<8, 32>
                                                    : launch_tiles<0, 0>;
    const cudaError_t e = tiles(grid, smem, s, idx, est, wgt, kaiser, tile_oy, tile_ox, scratch,
                                overflow, epoch, H, W, nR, nC, fh, fw, block_size, K);
    if (e != cudaSuccess) return e;
  }
  const long long pixels = (long long)B * H * W;
  const unsigned fold_blocks = (unsigned)((pixels + kFoldThreads - 1) / kFoldThreads);
  const auto fold = pixels <= kFewPixels ? bm3d_aggregate_fold_kernel<true, kTileR, kTileC>
                                         : bm3d_aggregate_fold_kernel<false, kTileR, kTileC>;
  fold<<<fold_blocks, kFoldThreads, 0, s>>>(scratch, tile_oy, tile_ox, cover_y, cover_x, overflow,
                                            epoch, idx, est, wgt, kaiser, num, den, B, H, W, nR,
                                            nC, fh, fw, block_size, K, kTileR, kTileC, 0, 0);
  return cudaGetLastError();
}

// The packed kernel and its fold: the arguments of bm3d_aggregate_launch,
// with the tile footprints (`tile_oy`, `tile_ox`, `cover_y`, `cover_x`, fh
// x fw) those of `tile_r` x `tile_c` tiles (the host's plan), `warps` (1-8)
// a CTA and `groups` (1-32) lane groups a warp, each of 32 / groups >=
// block^2 lanes where groups > 1; `scratch` of at least B * ceil(nR /
// tile_r) * ceil(nC / tile_c) * 2 * fh * fw f32; block in [1, 32], K a
// power of two in [1, 128].
extern "C" int bm3d_aggregate_packed_launch(const int* idx, const float* est, const float* wgt,
                                            const float* kaiser, const int* tile_oy,
                                            const int* tile_ox, const int* cover_y,
                                            const int* cover_x, float* scratch, int* overflow,
                                            int epoch, float* num, float* den, int B, int H, int W,
                                            int nR, int nC, int K, int block_size, int fh, int fw,
                                            int tile_r, int tile_c, int warps, int groups,
                                            void* stream) {
  const int bb = block_size * block_size;
  int k_shift = 0;
  while ((1 << k_shift) < K) ++k_shift;
  if (block_size < 1 || block_size > 32 || K < 1 || K > 128 || (1 << k_shift) != K ||
      fh < block_size || fw < block_size || tile_r < 1 || tile_c < 1 || warps < 1 ||
      warps > kPackedMaxWarps || groups < 1 || groups > 32 || (groups > 1 && 32 / groups < bb) ||
      (bb > 8 * 32 && groups != 1))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nR > 0 && nC > 0) {
    const size_t smem = 2 * (size_t)warps * groups * fh * fw * sizeof(float);
    const dim3 grid((nC + tile_c - 1) / tile_c, (nR + tile_r - 1) / tile_r, B);
    const int q = groups > 1 ? 1 : (bb + 31) / 32;
    const auto tiles = q > 8    ? launch_packed<0>  // values a lane at run time
                       : q == 1 ? launch_packed<1>
                       : q == 2 ? launch_packed<2>
                       : q == 3 ? launch_packed<3>
                       : q == 4 ? launch_packed<4>
                       : q == 5 ? launch_packed<5>
                       : q == 6 ? launch_packed<6>
                       : q == 7 ? launch_packed<7>
                                : launch_packed<8>;
    const cudaError_t e = tiles(grid, warps, smem, s, idx, est, wgt, kaiser, tile_oy, tile_ox, scratch,
                                overflow, epoch, H, W, nR, nC, fh, fw, block_size, k_shift, tile_r,
                                tile_c, groups);
    if (e != cudaSuccess) return e;
  }
  const long long pixels = (long long)B * H * W;
  const unsigned fold_blocks = (unsigned)((pixels + kFoldThreads - 1) / kFoldThreads);
  const auto fold = pixels <= kFewPixels ? bm3d_aggregate_fold_kernel<true, 0, 0>
                                         : bm3d_aggregate_fold_kernel<false, 0, 0>;
  fold<<<fold_blocks, kFoldThreads, 0, s>>>(scratch, tile_oy, tile_ox, cover_y, cover_x, overflow,
                                            epoch, idx, est, wgt, kaiser, num, den, B, H, W, nR,
                                            nC, fh, fw, block_size, K, tile_r, tile_c,
                                            (nR + tile_r - 1) / tile_r, (nC + tile_c - 1) / tile_c);
  return cudaGetLastError();
}

// The gather form: `bm3d_aggregate_index_kernel` (the member index), then
// `bm3d_aggregate_gather_kernel<rows>`. `idx`, `est`, `wgt`, `kaiser`, `num`,
// `den`, B, H, W, nR, nC, K and block as for bm3d_aggregate_packed_launch;
// `offsets` B * ((H - block + 1) * (W - block + 1) + 1) ints, `ids`,
// `any_ids` and `any_rows` B * nR * nC * K ints each (the index, and the
// scratch of runs past `cap`); `chunk_rows` table rows an index CTA, `cap`
// members it keeps in shared memory, `index_threads` (32-1024, a multiple
// of 32) its threads; `rows` (0 or 1) pixel rows a lane, `unroll` (4 or 8)
// members a walking warp has in flight,
// `warps` (1-16) a gather CTA, `wx` of them across (rows 1).
extern "C" int bm3d_aggregate_gather_launch(const int* idx, const float* est, const float* wgt,
                                            const float* kaiser, int* offsets, int* ids, int* any_ids,
                                            int* any_rows, float* num, float* den, int B, int H, int W,
                                            int nR, int nC, int K, int block_size, int chunk_rows, int cap,
                                            int index_threads, int rows, int unroll, int warps, int wx,
                                            void* stream) {
  int k_shift = 0;
  while ((1 << k_shift) < K) ++k_shift;
  const size_t smem = (size_t)(2 * chunk_rows + 35 + 4 * (size_t)cap) * sizeof(int);
  if (block_size < 1 || block_size > 32 || block_size > H || block_size > W || K < 1 || K > 128 ||
      (1 << k_shift) != K || chunk_rows < 1 || cap < 0 || smem > 227 * 1024 || index_threads < 32 ||
      index_threads > kIndexMaxThreads || index_threads % 32 != 0 || rows < 0 || rows > 1 ||
      (rows == 1 && unroll != 4 && unroll != 8) || warps < 1 ||
      warps > kGatherMaxWarps || wx < 1 || warps % wx != 0)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nrows = (H - block_size + 1) * (W - block_size + 1);
  const int G = nR * nC, P = G * K;
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(bm3d_aggregate_index_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  bm3d_aggregate_index_kernel<<<dim3((nrows + chunk_rows - 1) / chunk_rows, B), index_threads, smem, s>>>(
      idx, offsets, ids, any_ids, any_rows, P, nrows, chunk_rows, cap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (rows == 0) {
    const dim3 grid((W + 31) / 32, (H + warps - 1) / warps, B);
    return launch_gather<0, 1>(grid, warps * 32, s, est, wgt, kaiser, offsets, ids, num, den, H, W, P, G,
                               block_size, k_shift, 1);
  }
  const int tile_h = 4 * (warps / wx);
  const dim3 grid((W + 8 * wx - 1) / (8 * wx), (H + tile_h - 1) / tile_h, B);
  return (unroll == 4 ? launch_gather<1, 4> : launch_gather<1, 8>)(grid, warps * 32, s, est, wgt, kaiser, offsets,
                                                                    ids, num, den, H, W, P, G, block_size, k_shift,
                                                                    wx);
}
