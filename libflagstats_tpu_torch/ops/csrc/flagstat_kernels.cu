// Bit-sliced flagstat and positional popcount for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel libflagstats_tpu/ops/pallas_kernels.py
// `_make_kernel` / `_run_kernel` (the one pallas_call at :403) in its
// three modes over raw uint16 input: "flagstat" (29 streams),
// "flagstat_report" (21 streams) and "pospopcnt" (16 raw bit streams).
// One kernel, templated on the mode. It computes what the TPU kernel
// computes: for each counted stream, the number of words whose
// transformed word has that bit set, C streams over all words and F
// streams over QC-fail words, in the stream order of
// bitslice.C_STREAMS + F_STREAMS (or the REPORT_* order), so that the
// host's _sums_to_streams lays them out exactly as the TPU path does.
//
// Bound on this card. The kernel reads 2 bytes per word once; at the
// H100 SXM's nominal 3.35 TB/s that is 1.675e12 words/s. The ALU work is
// per 64 words per thread: the masked-swap transpose (at most 64 swaps
// of ~5 ops; the compiler drops the swaps whose rows no stream reads,
// which is bitslice.pruned_pairs done by dead-code elimination), the
// plane-space transform (~16 ops per 32 words) and one __popc per
// stream plane (58 in flagstat mode). __popc issues at a quarter of the
// integer rate, so flagstat mode could be bound by the popcounts. It is
// not: on an H100 80GB HBM3 at 700 W the kernel reads 824,541,892 words
// at 3.06 TB/s, and at 64Mi words the three modes (16 to 58 popcounts
// per 32 words) take the same time within 5%. The read bounds it.
//
// Design, and why.
// * Transpose: a per-thread 32 x 32 register transpose (the
//   TRANSPOSE_STAGES network, j=16 stage elided). Each thread holds 32
//   uint32 registers = 64 words. The alternative, __ballot_sync of each
//   bit across a warp, costs a ballot, a shift, a mask and a select per
//   plane per 32 words on every lane (~1.5 warp instructions per word),
//   which is several times the ALU budget the read bound leaves; the
//   register network costs ~0.2 warp instructions per word.
// * No Harley-Seal tree: the TPU kernel carries v1..v8 across grid
//   steps because its VPU popcount was dear; here __popc is one
//   instruction and a direct popcount per plane keeps the state to one
//   32-bit tally per stream (29 registers) beside the 32 rows, so
//   nothing spills. Whether a CSA tree pays on Hopper is open.
// * No sequential grid: blocks run in any order. Each warp walks 2048-word
//   tiles in a grid-stride loop and keeps its tallies in registers; at
//   the end a warp-shuffle sum, a shared-memory sum per block and one
//   64-bit atomicAdd per stream per block land in the output, which the
//   launcher zeroes first or which holds earlier pieces' sums.
//   Integer atomics are exact in any order.
// * Loads: lane L of a warp reads 16-byte vectors L, L+32, ... of its
//   tile, so each warp load instruction covers 512 contiguous bytes.
//   Which 64 words land in a thread does not matter: counting is
//   order-free as long as every word sits in exactly one 16-bit field.
// * Ragged edges: the kernel addresses the 16-byte-aligned base below
//   the tensor's first word and masks [skip, end) itself. A tile wholly
//   inside takes the vector path; the (at most two) tiles cut by the
//   head or the tail load word by word inside the range and zeros
//   outside. A zero word counts nothing, so no host padding is needed.
// * Input bits 12-15: the flagstat modes never read the planes of bits
//   12-15 (flags.INPUT_MASK); pospopcnt counts all 16.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"

namespace {

using namespace lfs;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegs = 32;                        // uint32 registers per thread
constexpr int kTileWords = 32 * 2 * kRegs;       // 2048 words per warp tile
constexpr int kTileVecs = kTileWords / 8;        // 16-byte vectors per tile

// bitslice.TRANSPOSE_STAGES: after it, bit j of one 32-word plane sits in
// row 15 - j and of the other in row 31 - j.
__device__ __forceinline__ void transpose32(uint32_t (&a)[kRegs]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = 8 >> s;
    const uint32_t m = s == 0   ? 0x00FF00FFu
                       : s == 1 ? 0x0F0F0F0Fu
                       : s == 2 ? 0x33333333u
                                : 0x55555555u;
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      if (k & j) continue;
      const uint32_t t = (a[k] ^ (a[k + j] >> j)) & m;
      a[k] ^= t;
      a[k + j] ^= t << j;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    stream_sums_kernel(const uint16_t* __restrict__ base, int64_t skip,
                       int64_t end, int64_t tiles,
                       unsigned long long* __restrict__ out) {
  constexpr int NS = Streams<MODE>::n;
  __shared__ unsigned long long block_sum[NS];
  for (int s = threadIdx.x; s < NS; s += kThreads) block_sum[s] = 0;

  uint32_t cnt[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) cnt[s] = 0;

  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (int64_t)gridDim.x * kWarps;
  const uint4* base4 = reinterpret_cast<const uint4*>(base);
  for (int64_t tile = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += nwarps) {
    const int64_t first = tile * kTileWords;
    uint32_t a[kRegs];
    if (first >= skip && first + kTileWords <= end) {
      const uint4* src = base4 + tile * kTileVecs + lane;
#pragma unroll
      for (int i = 0; i < kRegs / 4; ++i) {
        const uint4 v = __ldg(src + i * 32);
        a[4 * i] = v.x;
        a[4 * i + 1] = v.y;
        a[4 * i + 2] = v.z;
        a[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRegs; ++k) {
        // the same word of the tile the vector path would put here
        const int64_t w = first + (int64_t)((k / 4) * 32 + lane) * 8 + (k % 4) * 2;
        const uint32_t lo = (w >= skip && w < end) ? base[w] : 0u;
        const uint32_t hi = (w + 1 >= skip && w + 1 < end) ? base[w + 1] : 0u;
        a[k] = lo | (hi << 16);
      }
    }
    transpose32(a);
    uint32_t p[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) p[j] = a[15 - j];
    count_planes<MODE>(p, cnt);
#pragma unroll
    for (int j = 0; j < 16; ++j) p[j] = a[31 - j];
    count_planes<MODE>(p, cnt);
  }
  flush_counts<NS, kThreads>(cnt, block_sum, out);
}

template <int MODE>
cudaError_t wave_blocks(int* blocks) {
  return lfs::wave_blocks(stream_sums_kernel<MODE>, kThreads, blocks);
}

template <int MODE>
cudaError_t launch(const void* x, int64_t n, unsigned long long* out, int blocks, int zero,
                   cudaStream_t stream) {
  if (zero) {
    const cudaError_t z = cudaMemsetAsync(out, 0, Streams<MODE>::n * sizeof(*out), stream);
    if (z != cudaSuccess) return z;
  }
  if (n <= 0) return cudaSuccess;  // a 0-block launch is an error
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const uintptr_t aligned = addr & ~uintptr_t(15);
  const int64_t skip = (int64_t)(addr - aligned) / 2;
  const int64_t end = skip + n;
  const int64_t tiles = (end + kTileWords - 1) / kTileWords;
  int wave = 0;
  cudaError_t e = wave_blocks<MODE>(&wave);
  if (e != cudaSuccess) return e;
  if (wave < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = (tiles + kWarps - 1) / kWarps;
  const int64_t cap = blocks > 0 ? blocks : wave;
  const int grid = (int)(want < cap ? want : cap);
  stream_sums_kernel<MODE><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const uint16_t*>(aligned), skip, end, tiles, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Adds the per-stream counts of the n uint16 words at x into out
// (int64[Streams<mode>::n]), on `stream`; with zero != 0 a
// cudaMemsetAsync on `stream` zeroes out first (also for n = 0, which
// launches nothing). x must be 2-byte aligned. blocks > 0 is the most
// blocks the grid gets (a sweep's knob); 0 gives it one wave at most.
// Returns a cudaError_t.
int lfs_stream_sums(int mode, const void* x, long long n, void* out, int blocks, int zero,
                    void* stream) {
  auto* o = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFlagstat: return launch<kFlagstat>(x, n, o, blocks, zero, s);
    case kReport: return launch<kReport>(x, n, o, blocks, zero, s);
    case kPospopcnt: return launch<kPospopcnt>(x, n, o, blocks, zero, s);
    default: return cudaErrorInvalidValue;
  }
}

// The most blocks one launch of `mode` runs on the current device (one
// wave: SMs times resident blocks per SM). Returns a cudaError_t.
int lfs_wave_blocks(int mode, int* blocks) {
  switch (mode) {
    case kFlagstat: return wave_blocks<kFlagstat>(blocks);
    case kReport: return wave_blocks<kReport>(blocks);
    case kPospopcnt: return wave_blocks<kPospopcnt>(blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Words one warp tile covers; a wave of `blocks` blocks covers
// blocks * lfs_words_per_block() words before its grid-stride loop turns.
int lfs_words_per_block(void) { return kWarps * kTileWords; }

}  // extern "C"
