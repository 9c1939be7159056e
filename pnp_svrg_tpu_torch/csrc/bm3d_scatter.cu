// BM3D aggregation scatter: per-image row scatter-add into a table.
//
// Replaces the Pallas kernel `_scatter_kernel` / `bm3d_scatter_pallas` in
// pnp_svrg_tpu/ops/pallas/bm3d_scatter.py, and computes the function that
// `_aggregate` in pnp_svrg_tpu/denoisers/bm3d.py forms with `.at[].add`:
//
//   table[b, idx[b, p], :] += upd[b, p, :]
//
// Rows from different reference blocks land on the same table row, so the
// additions collide.
//
// Bound on the H100: HBM bytes. At the headline shape (13 images, 15376
// update rows of 128 f32 each, a 14641-row table per image) one call reads
// ~102 MB of updates and writes ~97 MB of table, with no arithmetic to speak
// of.
//
// Design: the wrapper zero-fills the table (torch.zeros). One warp owns one
// update row; its 32 lanes read the row as float4 (coalesced, 16 B a lane)
// and add each value into the table with atomicAdd, which the hardware
// performs in L2, so collisions need no ordering and the table travels to
// HBM about once. f32 atomics make the summation order change from run to
// run: the result agrees with an ordered sum to f32 rounding, not bit for
// bit. A row index outside [0, T) is skipped; built with
// -DPNP_DEBUG_BOUNDS it traps instead.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bm3d_scatter_kernel(const int* __restrict__ idx, const float4* __restrict__ upd,
                    float* __restrict__ table, long long n_rows, long long P,
                    int w4, long long T) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int dst = __ldg(idx + row);
  if (dst < 0 || dst >= T) {
#ifdef PNP_DEBUG_BOUNDS
    __trap();
#endif
    return;
  }
  const long long b = row / P;
  float* trow = table + (b * T + dst) * (long long)(4 * w4);
  const float4* urow = upd + row * w4;
  for (int j = lane; j < w4; j += 32) {
    const float4 u = __ldg(urow + j);
    atomicAdd(trow + 4 * j + 0, u.x);
    atomicAdd(trow + 4 * j + 1, u.y);
    atomicAdd(trow + 4 * j + 2, u.z);
    atomicAdd(trow + 4 * j + 3, u.w);
  }
}

}  // namespace

// `idx` (B, P) int32 rows in [0, T), `upd` (B, P, W) f32 with W % 4 == 0 and
// 16-byte alignment, `table` (B, T, W) f32, zeroed by the caller. Returns the
// launch's cudaError_t (0 on success).
extern "C" int bm3d_scatter_launch(const int* idx, const float* upd,
                                   float* table, long long B, long long P,
                                   int W, long long T, void* stream) {
  if (W % 4 != 0) return cudaErrorInvalidValue;
  const long long n_rows = B * P;
  if (n_rows == 0) return cudaSuccess;
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bm3d_scatter_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      idx, reinterpret_cast<const float4*>(upd), table, n_rows, P, W / 4, T);
  return cudaGetLastError();
}
