// Flagstat over host-pretransposed plane tiles (K2) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel libflagstats_tpu/ops/pallas_kernels.py
// `_run_kernel(pre=True)` (the pallas_call at :403; the packed-row body
// at :244-253), reached through stream_sums_pallas_pre /
// flagstat_pallas_pre (:492-546): the device tier of the streaming
// pipeline. It computes what that kernel computes: the same per-stream
// sums, in the same stream order, as K1 (flagstat_kernels.cu) over the
// words the tiles came from, in flagstat mode (29 streams) or report
// mode (21 streams).
//
// Input: a contiguous (G, R, 8, 128) uint32 tensor, R = 32 (every
// row), 24 (PACKED_ROWS_FULL) or 20 (PACKED_ROWS_REPORT). Element
// (g, r, s, l) is one 32-word bit plane of original row rows[r]; at each
// of a group's 1,024 (s, l) positions, plane j of the first 32 words is
// original row 15 - j and of the other 32 words row 31 - j
// (bitslice.first_half_row / second_half_row). The kernel is templated
// on mode and R, so the original -> packed slot map is a compile-time
// table; (mode, R) pairs other than (flagstat, 32), (flagstat, 24),
// (report, 32) and (report, 20) are refused.
//
// Bound on this card. There is no transpose: per 64 words a thread does
// ~16 boolean ops per 32-word plane set and at most 58 __popc (29
// streams x 2 halves), against reads of 1.5 / 1.25 / 2 bytes per word
// for R = 24 / 20 / 32 (report mode on 32-row tiles reads only its 20
// rows). At the H100 SXM's nominal 3.35 TB/s that is 2.23e12 /
// 2.68e12 / 1.68e12 words/s. __popc issues at 16 per clock per SM, a
// quarter of the integer rate: at 1.98 GHz on 132 SMs the popcounts
// alone allow ~4.6e12 words/s and, with the boolean ops, the integer
// pipes ~3.5e12, so the read should bound every layout, the 20-row one
// most narrowly (1.3x). It does: on an H100 80GB HBM3 at 700 W the
// kernel reads the 824,541,892-word column's tiles at 3.02 TB/s in both
// packed layouts (0.41 ms for 24 rows, 0.34 ms for 20), the rate K1
// reaches on raw words.
//
// Design, and why.
// * Loads: thread t of a 256-thread block takes four consecutive
//   positions 4t..4t+3 of a group as one 16-byte uint4 per row, so each
//   warp load is 512 contiguous bytes of one row. A thread loads one
//   half (12 planes, 10 in report mode) at a time: 12 independent
//   16-byte loads in flight per thread, and ~48 registers of planes
//   beside the 29 tallies.
// * Count: one __popc per stream plane, through the transform K1 uses
//   (flagstat_common.cuh). No Harley-Seal tree, for K1's reason.
// * No sequential grid: a block takes one group per turn of a
//   grid-stride loop; tallies stay in registers and meet, as in K1, in
//   a warp shuffle, a shared sum and one 64-bit atomicAdd per stream per
//   block. Zero tiles count nothing, so no group count is padded.
// * Rows no stream of the mode reads (j = 12..15; in report mode also
//   j = 4, 5) are never loaded, so 32-row tiles cost what packed ones do
//   in bytes read, but strided.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"

namespace {

using namespace lfs;

constexpr int kThreads = 256;  // one thread per 4 of a group's 1,024 positions
constexpr int kRowVecs = 256;  // 16-byte vectors per plane row of a group

// Whether R-row tiles carry original row o (plane j = 15 - (o & 15)):
// all rows, the planes 0-11 the transform reads, or those without 4, 5.
__host__ __device__ constexpr bool shipped(int rows, int o) {
  const int j = 15 - (o & 15);
  return rows == 32 || (j < 12 && (rows == 24 || (j != 4 && j != 5)));
}

// Slot of original row o in R-row tiles, or -1: the packed order is
// sorted by original row (pallas_kernels.PACKED_ROWS_*).
__host__ __device__ constexpr int row_slot(int rows, int o) {
  int s = 0;
  for (int k = 0; k < o; ++k) s += shipped(rows, k);
  return shipped(rows, o) ? s : -1;
}

static_assert(row_slot(24, 31) == 23 && row_slot(24, 4) == 0 && row_slot(24, 20) == 12,
              "PACKED_ROWS_FULL is rows 4-15 and 20-31");
static_assert(row_slot(20, 31) == 19 && row_slot(20, 10) == -1 && row_slot(20, 12) == 6,
              "PACKED_ROWS_REPORT is PACKED_ROWS_FULL without rows 10, 11, 26, 27");

// Plane j of the current half is read by some stream of the mode.
__host__ __device__ constexpr bool needed(int mode, int j) {
  return j < 12 && (mode != kReport || (j != 4 && j != 5));
}

template <int MODE, int R>
__global__ void __launch_bounds__(kThreads)
    stream_sums_pre_kernel(const uint4* __restrict__ planes, int64_t groups,
                           unsigned long long* __restrict__ out) {
  constexpr int NS = Streams<MODE>::n;
  __shared__ unsigned long long block_sum[NS];
  for (int s = threadIdx.x; s < NS; s += kThreads) block_sum[s] = 0;

  uint32_t cnt[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) cnt[s] = 0;

  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const uint4* tile = planes + g * R * kRowVecs + threadIdx.x;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 v[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int slot = row_slot(R, (half ? 31 : 15) - j);
        v[j] = needed(MODE, j) && slot >= 0 ? __ldg(tile + slot * kRowVecs)
                                            : make_uint4(0u, 0u, 0u, 0u);
      }
      uint32_t p[16];
#pragma unroll
      for (int j = 12; j < 16; ++j) p[j] = 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int j = 0; j < 12; ++j)
          p[j] = c == 0 ? v[j].x : c == 1 ? v[j].y : c == 2 ? v[j].z : v[j].w;
        count_planes<MODE>(p, cnt);
      }
    }
  }
  flush_counts<NS, kThreads>(cnt, block_sum, out);
}

// The grid cache's entries of K2's four (mode, rows) kernels.
Grid g_grids[4] = {
    {"pre", 32, (const void*)stream_sums_pre_kernel<kFlagstat, 32>, kThreads},
    {"pre", 24, (const void*)stream_sums_pre_kernel<kFlagstat, 24>, kThreads},
    {"pre_report", 32, (const void*)stream_sums_pre_kernel<kReport, 32>, kThreads},
    {"pre_report", 20, (const void*)stream_sums_pre_kernel<kReport, 20>, kThreads},
};
[[maybe_unused]] const bool g_enrolled = enroll(g_grids);

template <int MODE, int R>
cudaError_t launch_pre(Grid& g, int device, const void* planes, int64_t groups,
                       unsigned long long* out, int blocks, int zero, cudaStream_t stream) {
  if (zero) {
    const cudaError_t z = cudaMemsetAsync(out, 0, Streams<MODE>::n * sizeof(*out), stream);
    if (z != cudaSuccess) return z;
  }
  if (groups <= 0) return cudaSuccess;  // a 0-block launch is an error
  if (reinterpret_cast<uintptr_t>(planes) % 16) return cudaErrorInvalidValue;
  return enqueue(g, device, groups, blocks, stream, stream_sums_pre_kernel<MODE, R>,
                 static_cast<const uint4*>(planes), groups, out);
}

}  // namespace

extern "C" {

// Adds the per-stream counts of `groups` (rows, 8, 128) uint32 plane
// tiles at `planes` into out (int64[Streams<mode>::n]), on `stream` of
// `device` (made current for the call); with zero != 0 a
// cudaMemsetAsync on `stream` zeroes out first (also for groups = 0,
// which launches nothing). planes must be 16-byte aligned. blocks > 0 is
// the most blocks the grid gets (a sweep's knob); 0 gives it one wave at
// most, which is the groups one wave covers (a block takes one group per
// turn of its loop). Returns a cudaError_t (cudaErrorInvalidValue for a
// (mode, rows) pair with no kernel).
int lfs_stream_sums_pre(int device, int mode, int rows, const void* planes, long long groups,
                        void* out, int blocks, int zero, void* stream) {
  DeviceScope scope(device);
  if (scope.status != cudaSuccess) return scope.status;
  auto* o = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == kFlagstat && rows == 32)
    return launch_pre<kFlagstat, 32>(g_grids[0], device, planes, groups, o, blocks, zero, s);
  if (mode == kFlagstat && rows == 24)
    return launch_pre<kFlagstat, 24>(g_grids[1], device, planes, groups, o, blocks, zero, s);
  if (mode == kReport && rows == 32)
    return launch_pre<kReport, 32>(g_grids[2], device, planes, groups, o, blocks, zero, s);
  if (mode == kReport && rows == 20)
    return launch_pre<kReport, 20>(g_grids[3], device, planes, groups, o, blocks, zero, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
