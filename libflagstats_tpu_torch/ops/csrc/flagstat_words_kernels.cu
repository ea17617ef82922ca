// Word-space flagstat for NVIDIA Hopper (sm_90a): K6.
//
// Replaces the TPU kernel libflagstats_tpu/ops/pallas_kernels.py
// `_make_words_kernel` / `_run_words_kernel` (the pallas_call at :928),
// reached through `stream_sums_words` and `flagstat_pallas_words`. It
// computes what that kernel computes, with no bit transpose: for each
// transformed bit k < 15, the number of 16-bit words whose transformed
// word has bit k set, once over QC-pass words (P[k]) and once over
// QC-fail words (F[k]). The output is int64[30], P[0..14] then
// F[0..14]; the wrapper forms (C[k], F[k]) = (P[k] + F[k], F[k]).
// Transformed bit 15 is always 0, so it is not counted.
//
// Algorithm (the TPU kernel's, per thread):
// * Mask-select transform in word space: SWAR on the two 16-bit fields
//   of a 32-bit lane (`_transform_words_packed`, :819-844), splitting
//   each lane into its pass and fail words.
// * Two Harley-Seal carry-save trees (pass and fail strata), v1/v2/v4/v8
//   each, fed 16 lanes per body; each body's sixteens word is peeled bit
//   by bit with shift+mask into packed 16-bit half accumulators, one
//   uint32 per (stratum, bit) holding two per-field subcounts.
// * At the end the v1..v8 residuals are peeled with weights 1, 2, 4, 8.
//
// Packed-half bound. A sixteens peel adds 16 to a field per body (weight
// 16, as the TPU kernel's `peel(sixteens, base, 4)`), so a field holds
// at most 16 * b after b bodies, and 16 * 4095 = 65,520 <= 0xFFFF. So
// each thread flushes its packed halves into 32-bit tallies every
// kFlushBodies = 4095 bodies (131,040 words), before any field can wrap.
// The residual peel goes straight into the tallies. (The TPU kernel
// bounds the same halves by chunking calls at _WORDS_MAX_STEPS = 1536
// grid steps, :919-927; here no call needs chunking.) A thread's 32-bit
// tallies count at most the words it reads, far below 2^32 for any call
// within ops.dispatch.DEVICE_WORD_CAP.
//
// Bound on this card. The kernel reads 2 bytes per word once (3.35 TB/s
// nominal on the H100 SXM). Its ALU work is ~17 integer operations per
// word (transform ~12, CSA trees ~2, peels ~3), far more than K1's
// bit-sliced ~2, so it may well be bound by the integer pipes and not by
// the read; PERF.md holds its measured time beside K1's.
//
// Design, and why.
// * No sequential grid: the TPU kernel carries v1..v8 in VMEM scratch
//   across ordered grid steps. Here each thread carries its own trees
//   and packed halves across the turns of a grid-stride loop (counting
//   is order-free), and blocks meet in one 64-bit atomicAdd per stream
//   (flagstat_common.cuh flush_counts).
// * Loads: a block turn covers 8192 words; thread t takes the uint4
//   vectors t, t + 256, t + 512, t + 768 of it (16 lanes = one HS-16
//   body), so every warp load covers 512 contiguous bytes and each
//   thread has four 16-byte loads in flight.
// * Ragged edges: the kernel addresses the 16-byte-aligned base below
//   the tensor's first word and masks [skip, end) itself. A vector wholly
//   inside takes the vector load; a vector cut by the head or the tail
//   loads word by word inside the range and zeros outside. Zero words
//   count nothing, so the host pads nothing.
// * `blocks` (tests only) caps the grid, so a test can give one thread
//   far more than kFlushBodies bodies and check the flush on the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                      // uint4 loads per thread per turn
constexpr int kLanes = 4 * kVecs;             // 16 lanes: one HS-16 body
constexpr int kTileVecs = kThreads * kVecs;   // vectors per block turn
constexpr int kTileWords = kTileVecs * 8;     // 8192 words per block turn
constexpr int kBits = 15;                     // transformed bits 0-14
constexpr int kStreams = 2 * kBits;           // pass bits, then fail bits
constexpr int kFlushBodies = 4095;            // see "Packed-half bound"
constexpr uint32_t kOne = 0x00010001u;        // bit 0 of each 16-bit field
constexpr uint32_t kKeepAlways = 0x0704u;     // flags.KEEP_ALWAYS
constexpr int kQcfail = 9;                    // flags.FQCFAIL_OFF

// _transform_words_packed: two FLAG words per lane -> (pass, fail)
// transformed words. Every op stays within its 16-bit field.
__device__ __forceinline__ void transform(uint32_t x, uint32_t& tp, uint32_t& tf) {
  x &= 0x0FFF0FFFu;  // drop input bits 12-15
  const uint32_t sec = (x >> 8) & kOne;
  const uint32_t sup = (x >> 11) & kOne;
  const uint32_t inpair = x & kOne & (sec ^ kOne) & (sup ^ kOne);
  const uint32_t supc = sup & (sec ^ kOne);
  const uint32_t im = inpair & (((x >> 2) & kOne) ^ kOne);  // inpair & mapped
  const uint32_t b12 = im & (x >> 1) & kOne;
  const uint32_t b13 = im & (x >> 3) & kOne;
  const uint32_t b14 = im ^ b13;
  const uint32_t keep = ((inpair << 8) - inpair) | (kKeepAlways * kOne);
  const uint32_t t = (x & keep) | (supc << 11) | (b12 << 12) | (b13 << 13) | (b14 << 14);
  const uint32_t q = (x >> kQcfail) & kOne;
  tf = t & ((q << 16) - q);  // 0xFFFF per QC-fail field
  tp = t ^ tf;
}

// Carry-save full adder: v <- sum of v + a + b per bit; returns the carry.
__device__ __forceinline__ uint32_t csa(uint32_t& v, uint32_t a, uint32_t b) {
  const uint32_t va = v ^ a;
  const uint32_t carry = (v & a) | (b & va);
  v = va ^ b;
  return carry;
}

// One HS-16 body (pallas_kernels.py:887-903): 16 lanes into v1/v2/v4/v8;
// returns the sixteens word.
__device__ __forceinline__ uint32_t hs16(uint32_t (&v)[4], const uint32_t (&d)[kLanes]) {
  uint32_t twosA = csa(v[0], d[0], d[1]);
  uint32_t twosB = csa(v[0], d[2], d[3]);
  uint32_t foursA = csa(v[1], twosA, twosB);
  twosA = csa(v[0], d[4], d[5]);
  twosB = csa(v[0], d[6], d[7]);
  uint32_t foursB = csa(v[1], twosA, twosB);
  const uint32_t eightsA = csa(v[2], foursA, foursB);
  twosA = csa(v[0], d[8], d[9]);
  twosB = csa(v[0], d[10], d[11]);
  foursA = csa(v[1], twosA, twosB);
  twosA = csa(v[0], d[12], d[13]);
  twosB = csa(v[0], d[14], d[15]);
  foursB = csa(v[1], twosA, twosB);
  const uint32_t eightsB = csa(v[2], foursA, foursB);
  return csa(v[3], eightsA, eightsB);
}

// Add 16 to field f of packed[base + k] for each field f of s with bit k
// set (the TPU kernel's peel at weight 2^4).
__device__ __forceinline__ void peel16(uint32_t s, uint32_t (&packed)[kStreams], int base) {
#pragma unroll
  for (int k = 0; k < kBits; ++k) packed[base + k] += ((s >> k) & kOne) << 4;
}

__device__ __forceinline__ void flush_packed(uint32_t (&packed)[kStreams],
                                             uint32_t (&cnt)[kStreams]) {
#pragma unroll
  for (int s = 0; s < kStreams; ++s) {
    cnt[s] += (packed[s] & 0xFFFFu) + (packed[s] >> 16);
    packed[s] = 0;
  }
}

// Words [first, first + 8) as one vector: in-range words read one by
// one, the rest zero.
__device__ __forceinline__ uint4 load_masked(const uint16_t* __restrict__ base, int64_t first,
                                             int64_t skip, int64_t end) {
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t i = first + j;
    w[j] = (i >= skip && i < end) ? base[i] : 0u;
  }
  return make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16), w[4] | (w[5] << 16),
                    w[6] | (w[7] << 16));
}

__global__ void __launch_bounds__(kThreads)
    stream_sums_words_kernel(const uint16_t* __restrict__ base, int64_t skip, int64_t end,
                             int64_t tiles, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long block_sum[kStreams];
  for (int s = threadIdx.x; s < kStreams; s += kThreads) block_sum[s] = 0;

  uint32_t cnt[kStreams], packed[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) cnt[s] = packed[s] = 0;
  uint32_t vp[4] = {0, 0, 0, 0}, vf[4] = {0, 0, 0, 0};
  int bodies = 0;

  const uint4* base4 = reinterpret_cast<const uint4*>(base);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    uint32_t tp[kLanes], tf[kLanes];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int64_t vec = tile * kTileVecs + i * kThreads + threadIdx.x;
      const int64_t first = vec * 8;
      const uint4 v = (first >= skip && first + 8 <= end) ? __ldg(base4 + vec)
                                                          : load_masked(base, first, skip, end);
      transform(v.x, tp[4 * i], tf[4 * i]);
      transform(v.y, tp[4 * i + 1], tf[4 * i + 1]);
      transform(v.z, tp[4 * i + 2], tf[4 * i + 2]);
      transform(v.w, tp[4 * i + 3], tf[4 * i + 3]);
    }
    peel16(hs16(vp, tp), packed, 0);
    peel16(hs16(vf, tf), packed, kBits);
    if (++bodies == kFlushBodies) {
      flush_packed(packed, cnt);
      bodies = 0;
    }
  }
  flush_packed(packed, cnt);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int k = 0; k < kBits; ++k) {
      cnt[k] += (((vp[w] >> k) & 1u) + ((vp[w] >> (16 + k)) & 1u)) << w;
      cnt[kBits + k] += (((vf[w] >> k) & 1u) + ((vf[w] >> (16 + k)) & 1u)) << w;
    }
  }
  lfs::flush_counts<kStreams, kThreads>(cnt, block_sum, out);
}

}  // namespace

extern "C" {

// Adds the pass/fail bit counts of the n uint16 words at x into out
// (int64[30], zeroed by the caller), on `stream`. x must be 2-byte
// aligned. blocks > 0 is the most blocks the grid gets (a sweep's knob,
// and the tests' way to run one thread far past a flush); 0 gives it one
// wave at most.
// Returns a cudaError_t.
int lfs_stream_sums_words(const void* x, long long n, void* out, int blocks, void* stream) {
  if (n <= 0) return cudaSuccess;  // a 0-block launch is an error
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const uintptr_t aligned = addr & ~uintptr_t(15);
  const int64_t skip = (int64_t)(addr - aligned) / 2;
  const int64_t end = skip + n;
  const int64_t tiles = (end + kTileWords - 1) / kTileWords;
  int wave = 0;
  cudaError_t e = lfs::wave_blocks(stream_sums_words_kernel, kThreads, &wave);
  if (e != cudaSuccess) return e;
  if (wave < 1) return cudaErrorInvalidConfiguration;
  const int64_t cap = blocks > 0 ? blocks : wave;
  const int grid = (int)(tiles < cap ? tiles : cap);
  stream_sums_words_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint16_t*>(aligned), skip, end, tiles,
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

// The most blocks one launch runs on the current device (one wave).
// Returns a cudaError_t.
int lfs_words_wave_blocks(int* blocks) {
  return lfs::wave_blocks(stream_sums_words_kernel, kThreads, blocks);
}

// Words one block covers per turn of its grid-stride loop.
int lfs_words_block_words(void) { return kTileWords; }

// Bodies (turns) between a thread's flushes of its packed halves.
int lfs_words_flush_bodies(void) { return kFlushBodies; }

}  // extern "C"
