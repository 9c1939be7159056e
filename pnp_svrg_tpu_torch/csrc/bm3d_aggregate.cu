// BM3D aggregation, fused: the patch scatter-add and the unfold-add in one
// pass from group estimates to the (num, den) images.
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
// Design: one CTA of kWarps warps per (image, kTileR x kTileC tile of
// reference blocks). `_gather_groups` clips member coordinates to
// [0, H - block], so every member of the tile lands inside a footprint of at
// most fh x fw pixels whose origin (tile_oy, tile_ox) the host computes (for
// search 8 and a 2 x 2 tile of step-4 blocks, 28 x 28 pixels). Each warp
// holds its own numerator and denominator planes of that footprint in shared
// memory and streams its share of the tile's members (64 f32 a member, read
// as two coalesced 128-byte rows, kUnroll members in flight); it adds one
// member at a time with plain read-modify-writes, which cannot collide
// because a patch's 64 pixels are distinct and no other warp writes those
// planes. After one barrier the CTA sums its warps' planes in a fixed order
// and flushes the footprint into the zeroed global planes with reductions
// whose result is unused (RED). Only the borders of neighbouring footprints
// overlap, so the image planes travel to HBM a few times at most and the
// estimates are read exactly once. A member outside the footprint (the BM3D
// geometry never makes one) is added straight into the global planes, so any
// row in [0, hh * ww) gives the right sum; a member whose row lies outside
// that range is dropped (the wrapper's docstring says so).
//
// Why no shared-memory atomics: sm_90a has no native shared-memory f32 add.
// An atomicAdd on a shared float compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), and a first version of this kernel that
// added into one pair of planes per CTA that way was about twice as slow
// (PERF.md).
// Small tiles keep the private planes small (2 x 2 x 28 x 28 f32, 12.5 KB a
// CTA) and give the headline 3328 CTAs of 2 warps; the row is decoded
// without an integer division.
//
// The global reductions reorder the sums from run to run: the result agrees
// with an ordered sum to f32 rounding, not bit for bit (exactly where every
// term and partial sum is representable, as with dyadic inputs).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 8;  // the patch edge this file is built for
constexpr int kK = 16;     // and the group size
constexpr int kTileR = 2;  // reference-block rows per CTA
constexpr int kTileC = 2;  // reference-block columns per CTA
constexpr int kWarps = 2;  // each with private planes
constexpr int kUnroll = 8;  // members each warp has in flight

__global__ void __launch_bounds__(kWarps * 32)
bm3d_aggregate_kernel(const int* __restrict__ idx, const float* __restrict__ est,
                      const float* __restrict__ wgt, const float* __restrict__ kaiser,
                      const int* __restrict__ tile_oy, const int* __restrict__ tile_ox,
                      float* __restrict__ num, float* __restrict__ den, int H, int W,
                      int nR, int nC, int fh, int fw) {
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

  constexpr int kBB = kBlock * kBlock;
  const int ww = W - kBlock + 1;
  const int n_rows = (H - kBlock + 1) * ww;
  const float inv_ww = 1.f / (float)ww;
  const long long G = (long long)nR * nC;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* s_num = planes + warp * 2 * plane;
  float* s_den = s_num + plane;
  // Lane owns patch values lane and lane + 32: (ky, kx) and (ky + 4, kx).
  const int ky = lane / kBlock;
  const int kx = lane % kBlock;
  const float kai0 = __ldg(kaiser + lane);
  const float kai1 = __ldg(kaiser + lane + 32);
  float* gnum = num + (long long)b * H * W;
  float* gden = den + (long long)b * H * W;

  // Member slot m: reference block t = m / kK of the tile, member m % kK.
  constexpr int kSlots = kTileR * kTileC * kK;
  for (int m0 = warp; m0 < kSlots; m0 += kWarps * kUnroll) {
    int row[kUnroll];
    float w[kUnroll], e0[kUnroll], e1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int m = m0 + u * kWarps;
      const int t = m / kK;
      const int i = t / kTileC;
      const int j = t % kTileC;
      row[u] = -1;
      if (m < kSlots && i < nr && j < nc) {
        const long long g = (long long)b * G + (r0 + i) * nC + c0 + j;
        const long long p = g * kK + m % kK;
        row[u] = __ldg(idx + p);
        w[u] = __ldg(wgt + g);
        e0[u] = __ldg(est + p * kBB + lane);
        e1[u] = __ldg(est + p * kBB + lane + 32);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
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
      const float wk0 = __fmul_rn(w[u], kai0);
      const float wk1 = __fmul_rn(w[u], kai1);
      const float n0 = __fmul_rn(e0[u], wk0);
      const float n1 = __fmul_rn(e1[u], wk1);
      const int ly = py - oy;
      const int lx = px - ox;
      if (ly >= 0 && lx >= 0 && ly + kBlock <= fh && lx + kBlock <= fw) {
        // The warp's own planes and one member at a time: the 64 pixels of
        // a patch are distinct, so plain read-modify-writes do not collide.
        const int a0 = (ly + ky) * fw + lx + kx;
        const int a1 = a0 + 4 * fw;
        s_num[a0] += n0;
        s_den[a0] += wk0;
        s_num[a1] += n1;
        s_den[a1] += wk1;
        __syncwarp();
      } else {
        const int a0 = (py + ky) * W + px + kx;
        const int a1 = a0 + 4 * W;
        atomicAdd(gnum + a0, n0);
        atomicAdd(gden + a0, wk0);
        atomicAdd(gnum + a1, n1);
        atomicAdd(gden + a1, wk1);
      }
    }
  }
  __syncthreads();

  // Sum the warps' planes in a fixed order and flush the footprint.
  const int fh_t = min(fh, H - oy);
  const int fw_t = min(fw, W - ox);
  for (int y = warp; y < fh_t; y += kWarps) {
    for (int x = lane; x < fw_t; x += 32) {
      const int q = y * fw + x;
      float n = 0.f, d = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        n += planes[v * 2 * plane + q];
        d += planes[v * 2 * plane + plane + q];
      }
      if (n == 0.f && d == 0.f) continue;
      atomicAdd(gnum + (oy + y) * W + ox + x, n);
      atomicAdd(gden + (oy + y) * W + ox + x, d);
    }
  }
}

}  // namespace

// `idx` (B, P) int32 patch-position rows, `est` (B, P, 64) f32, `wgt`
// (B, nR * nC) f32 with P = nR * nC * 16, `kaiser` (64,) f32; `tile_oy`
// (ceil(nR / 2),) and `tile_ox` (ceil(nC / 2),) int32 footprint origins and
// fh x fw the largest footprint (host-computed); `num`/`den` (B, H, W) f32,
// zeroed by the caller. Returns the launch's cudaError_t (0 on success).
extern "C" int bm3d_aggregate_launch(const int* idx, const float* est, const float* wgt,
                                     const float* kaiser, const int* tile_oy,
                                     const int* tile_ox, float* num, float* den, int B,
                                     int H, int W, int nR, int nC, int K, int block_size,
                                     int fh, int fw, void* stream) {
  if (block_size != kBlock || K != kK || fh < kBlock || fw < kBlock) return cudaErrorInvalidValue;
  if (B == 0 || nR == 0 || nC == 0 || K == 0) return cudaSuccess;
  const size_t smem = 2 * (size_t)kWarps * fh * fw * sizeof(float);
  static size_t granted = 48 * 1024;  // dynamic shared memory opted into so far
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        bm3d_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  const dim3 grid((nC + kTileC - 1) / kTileC, (nR + kTileR - 1) / kTileR, B);
  bm3d_aggregate_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, est, wgt, kaiser, tile_oy, tile_ox, num, den, H, W, nR, nC, fh, fw);
  return cudaGetLastError();
}
