// Shared by the bit-sliced kernels for NVIDIA Hopper (sm_90a):
// flagstat_kernels.cu (raw uint16 words, in-register transpose) and
// flagstat_pre_kernels.cu (host-pretransposed plane tiles). Both count
// the same streams in the same order: the stream set of each mode, the
// plane-space flagstat transform with one __popc per counted plane, the
// block's flush of per-thread tallies and the one-wave occupancy query
// live here once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lfs {

enum Mode { kFlagstat = 0, kReport = 1, kPospopcnt = 2 };

template <int MODE>
struct Streams {
  static constexpr int n = MODE == kFlagstat ? 29 : MODE == kReport ? 21 : 16;
};

// bitslice.REPORT_BITS = (0, 2, 6, 7, 8, 9, 10, 11, 12, 13, 14)
__host__ __device__ constexpr int report_bit(int i) {
  return i == 0 ? 0 : i == 1 ? 2 : i + 4;
}

// Count one 32-word plane set: p[j] is the plane of input bit j. The
// flagstat modes read p[0..11] only; report mode never reads p[4], p[5].
template <int MODE>
__device__ __forceinline__ void count_planes(const uint32_t (&p)[16],
                                             uint32_t (&cnt)[Streams<MODE>::n]) {
  if constexpr (MODE == kPospopcnt) {
#pragma unroll
    for (int j = 0; j < 16; ++j) cnt[j] += __popc(p[j]);
  } else {
    // bitslice.transform_planes
    const uint32_t secsup = p[8] | p[11];
    const uint32_t inpair = p[0] & ~secsup;
    const uint32_t supc = p[11] & ~p[8];
    const uint32_t im = inpair & ~p[2];
    const uint32_t t13 = im & p[3];
    const uint32_t t[15] = {
        inpair,     p[1] & inpair, p[2],        p[3] & inpair, p[4] & inpair,
        p[5] & inpair, p[6] & inpair, p[7] & inpair, p[8],   p[9],
        p[10],      supc,          im & p[1],   t13,           im ^ t13};
    const uint32_t q = t[9];
    if constexpr (MODE == kFlagstat) {
#pragma unroll
      for (int k = 0; k < 15; ++k) {
        cnt[k] += __popc(t[k]);
        if (k != 9) cnt[15 + k - (k > 9)] += __popc(t[k] & q);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 11; ++i) {
        const int k = report_bit(i);
        cnt[i] += __popc(t[k]);
        if (k != 9) cnt[11 + i - (k > 9)] += __popc(t[k] & q);
      }
    }
  }
}

// Add every thread's tallies into out (int64[NS], zeroed by the caller):
// a warp-shuffle sum, a shared-memory sum per block, then one 64-bit
// atomicAdd per stream per block. Integer atomics are exact in any
// order. block_sum[NS] is shared memory the block zeroed before its
// main loop; every thread of the block calls this once.
template <int NS, int THREADS>
__device__ __forceinline__ void flush_counts(const uint32_t (&cnt)[NS],
                                             unsigned long long* block_sum,
                                             unsigned long long* out) {
  __syncthreads();  // block_sum zeroed
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    unsigned long long v = cnt[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0 && v) atomicAdd(&block_sum[s], v);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < NS; s += THREADS)
    if (block_sum[s]) atomicAdd(&out[s], block_sum[s]);
}

// The most blocks of `kernel`, launched with `threads` threads and no
// dynamic shared memory, resident at once on the current device: one
// wave (SMs times resident blocks per SM).
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int threads, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *blocks = sms * per_sm;
  return e;
}

}  // namespace lfs
