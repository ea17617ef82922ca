// Word-space flagstat for NVIDIA Hopper (sm_90a): K6.
//
// Replaces the TPU kernel libflagstats_tpu/ops/pallas_kernels.py
// `_make_words_kernel` / `_run_words_kernel` (:847-947, the pallas_call
// at :928), reached through `stream_sums_words` and
// `flagstat_pallas_words`. It computes what that kernel computes, with no
// bit transpose: for each transformed bit k < 15, the number of 16-bit
// words whose transformed word has bit k set, once over QC-pass words
// (P[k]) and once over QC-fail words (F[k]). The output is int64[30],
// P[0..14] then F[0..14]; the epilogue (flagstat_epilogue.cu, or the
// plain version on the CPU) forms (C[k], F[k]) = (P[k] + F[k], F[k]).
// Transformed bit 15 is always 0, so it is not counted.
//
// What bounds it on this card. The kernel reads 2 bytes per word once
// (3.35 TB/s nominal on the H100 SXM). The TPU kernel's SWAR transform
// (`_transform_words_packed`, :819-844) costs ~14 integer operations a
// word after LOP3 fusion, its two trees ~2 and its bit-by-bit peel of
// every sixteens word ~3: ~20 a word, which at the cc 9.0 rate of 64 per
// clock per SM is twice the read's time (PERF.md). This design cuts the
// issue to ~5 a word, so the read bounds it again:
// * The transform is one table lookup. The transformed word depends on
//   input bits 0-11 only (bits 12-15 are dropped; QC-fail is bit 9), so
//   each block builds a 4096-entry uint32 table in shared memory (16 KiB)
//   in its prologue, from the same SWAR `transform()` (no host table can
//   drift from it): entry i is the transformed word of i in the low half
//   when i is a QC-pass word, in the high half when it is a QC-fail word.
//   A word then costs a mask, an address and one shared load.
// * One carry-save tree over pass|fail lanes. A table entry is one 32-bit
//   CSA lane holding one word's pass bits (low field) and fail bits (high
//   field), so one HS-16 tree (v1, v2, v4, v8) counts both strata, and
//   the packed half accumulators drop from 30 to 15 registers.
// * A second carry-save level. Each turn's two sixteens words go into a
//   second tree (w16, w32, w64, w128) spread over 8 turns: the carries
//   climb one level more on every 2nd, 4th and 8th turn, and the 256s
//   word is peeled into the packed halves once every 8 turns (16
//   bodies). Every thread of a block runs the same turns, so these
//   branches never diverge.
//
// Packed-half bound. A 256s peel adds 256 to a field per 16 bodies, so
// after p peels a field holds at most 256 * p, and 256 * 255 = 65,280 <=
// 0xFFFF < 256 * 256: the bound is tight at 255 peels (a stream in which
// every word sets one transformed bit of one stratum reaches it). Each
// thread flushes its packed halves into the block's 64-bit sums every
// kFlushBodies = 255 * 16 = 4080 bodies (2040 turns, 65,280 words). At
// the end at most 254 peels are unflushed, and the residuals v1..v8,
// w16..w128 and the pending carries (weights 32, 64, 128) add at most 15
// + 240 + 224 = 479 more: 254 * 256 + 479 = 65,503 <= 0xFFFF, so they
// are peeled into the halves before the last flush. (The TPU kernel
// bounds its halves by chunking calls at _WORDS_MAX_STEPS = 1536 grid
// steps, :919-927; here no call needs chunking.)
//
// Layout and the rest of the design.
// * No sequential grid: the TPU kernel carries v1..v8 in VMEM scratch
//   across ordered grid steps. Here each thread carries its trees and
//   packed halves across the turns of a grid-stride loop (counting is
//   order-free), and blocks meet in one 64-bit atomicAdd per stream.
// * Loads: a block turn covers 8192 words; thread t takes the uint4
//   vectors t, t + 256, t + 512, t + 768 of it (32 lanes = two HS-16
//   bodies), so every warp load covers 512 contiguous bytes and each
//   thread has four 16-byte loads in flight.
// * Ragged edges: the kernel addresses the 16-byte-aligned base below
//   the tensor's first word and masks [skip, end) itself. A turn wholly
//   inside takes the vector loads; a turn cut by the head or the tail
//   loads word by word inside the range and zeros outside. Zero words
//   look up entry 0, which is 0, so the host pads nothing.
// * Bank conflicts: a lookup's bank is the word's low 5 bits. Distinct
//   words of a warp in one bank serialise; equal words broadcast.
// * `blocks` (tests only) caps the grid, so a test can give one thread
//   far more than kFlushBodies bodies and check the flush on the card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                      // uint4 loads per thread per turn
constexpr int kLanes = 16;                    // lanes per HS-16 body
constexpr int kTileVecs = kThreads * kVecs;   // vectors per block turn
constexpr int kTileWords = kTileVecs * 8;     // 8192 words per block turn
constexpr int kBits = 15;                     // transformed bits 0-14
constexpr int kStreams = 2 * kBits;           // pass bits, then fail bits
constexpr int kTable = 4096;                  // entries: input bits 0-11
constexpr int kFlushPeels = 255;              // see "Packed-half bound"
constexpr int kFlushBodies = kFlushPeels * 16;
constexpr uint32_t kOne = 0x00010001u;        // bit 0 of each 16-bit field
constexpr uint32_t kKeepAlways = 0x0704u;     // flags.KEEP_ALWAYS
constexpr int kQcfail = 9;                    // flags.FQCFAIL_OFF

// _transform_words_packed: two FLAG words per lane -> (pass, fail)
// transformed words. Every op stays within its 16-bit field. Runs only
// in the prologue that builds the table.
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
__device__ __forceinline__ uint32_t hs16(uint32_t (&v)[4], const uint32_t* d) {
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

// Add 2^log2w to field f of packed[k] for each field f of s with bit k set.
__device__ __forceinline__ void peel(uint32_t s, int log2w, uint32_t (&packed)[kBits]) {
#pragma unroll
  for (int k = 0; k < kBits; ++k) packed[k] += ((s >> k) & kOne) << log2w;
}

// Add every thread's packed halves into block_sum (pass bit k at k, fail
// bit k at kBits + k) and zero them: a warp-shuffle sum, then one shared
// 64-bit atomicAdd per stream per warp. Every thread of the block calls
// it at the same turn (the turn count is the block's), so the shuffles
// see full warps.
__device__ __forceinline__ void flush_packed(uint32_t (&packed)[kBits],
                                             unsigned long long* block_sum) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kBits; ++k) {
    uint32_t lo = packed[k] & 0xFFFFu, hi = packed[k] >> 16;  // 32 * 0xFFFF < 2^32
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo += __shfl_down_sync(0xFFFFFFFFu, lo, off);
      hi += __shfl_down_sync(0xFFFFFFFFu, hi, off);
    }
    if (lane == 0) {
      if (lo) atomicAdd(&block_sum[k], (unsigned long long)lo);
      if (hi) atomicAdd(&block_sum[kBits + k], (unsigned long long)hi);
    }
    packed[k] = 0;
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

// The table entries of the two words of a 32-bit lane: a byte offset
// from input bits 0-11 of each half (a shift and a mask), then one LDS.
__device__ __forceinline__ void lookup(const char* table, uint32_t x, uint32_t* d) {
  d[0] = *reinterpret_cast<const uint32_t*>(table + ((x << 2) & 0x3FFCu));
  d[1] = *reinterpret_cast<const uint32_t*>(table + ((x >> 14) & 0x3FFCu));
}

__device__ __forceinline__ void lookup8(const char* table, uint4 q, uint32_t* d) {
  lookup(table, q.x, d);
  lookup(table, q.y, d + 2);
  lookup(table, q.z, d + 4);
  lookup(table, q.w, d + 6);
}

__global__ void __launch_bounds__(kThreads)
    stream_sums_words_kernel(const uint16_t* __restrict__ base, int64_t skip, int64_t end,
                             int64_t tiles, unsigned long long* __restrict__ out) {
  __shared__ uint2 table_pairs[kTable / 2];
  __shared__ unsigned long long block_sum[kStreams];
  // prologue: entries 2p and 2p + 1 from one SWAR transform of the pair,
  // 8 pairs a thread, each warp storing 256 contiguous bytes
  for (int p = threadIdx.x; p < kTable / 2; p += kThreads) {
    uint32_t tp, tf;
    transform(uint32_t(2 * p) | (uint32_t(2 * p + 1) << 16), tp, tf);
    table_pairs[p] = make_uint2((tp & 0xFFFFu) | (tf << 16), (tp >> 16) | (tf & 0xFFFF0000u));
  }
  for (int s = threadIdx.x; s < kStreams; s += kThreads) block_sum[s] = 0;
  __syncthreads();  // before any thread reads the table; no thread returns early
  const char* table = reinterpret_cast<const char*>(table_pairs);

  uint32_t packed[kBits];
#pragma unroll
  for (int k = 0; k < kBits; ++k) packed[k] = 0;
  uint32_t v[4] = {0, 0, 0, 0}, w[4] = {0, 0, 0, 0}, pend[3] = {0, 0, 0};
  uint32_t turn = 0;
  int peels = 0;

  const uint4* base4 = reinterpret_cast<const uint4*>(base);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++turn) {
    const int64_t first = tile * kTileWords;
    uint4 q[kVecs];
    if (first >= skip && first + kTileWords <= end) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i)
        q[i] = __ldg(base4 + tile * kTileVecs + i * kThreads + threadIdx.x);
    } else {
#pragma unroll
      for (int i = 0; i < kVecs; ++i)
        q[i] = load_masked(base, (tile * kTileVecs + i * kThreads + threadIdx.x) * 8, skip, end);
    }
    uint32_t d[2 * kLanes];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) lookup8(table, q[i], d + 8 * i);
    const uint32_t s0 = hs16(v, d);
    const uint32_t s1 = hs16(v, d + kLanes);
    // level 2: an HS-16 body over the sixteens words of 8 turns
    const uint32_t c32 = csa(w[0], s0, s1);
    if (turn & 1) {
      const uint32_t c64 = csa(w[1], pend[0], c32);
      if (turn & 2) {
        const uint32_t c128 = csa(w[2], pend[1], c64);
        if (turn & 4) {
          peel(csa(w[3], pend[2], c128), 8, packed);
          if (++peels == kFlushPeels) {
            flush_packed(packed, block_sum);
            peels = 0;
          }
        } else {
          pend[2] = c128;
        }
      } else {
        pend[1] = c64;
      }
    } else {
      pend[0] = c32;
    }
  }
  // residuals: the trees with their weights, and the carries still
  // pending after `turn` turns (see "Packed-half bound")
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    peel(v[j], j, packed);
    peel(w[j], 4 + j, packed);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (turn & (1u << j)) peel(pend[j], 5 + j, packed);
  flush_packed(packed, block_sum);
  __syncthreads();
  for (int s = threadIdx.x; s < kStreams; s += kThreads)
    if (block_sum[s]) atomicAdd(&out[s], block_sum[s]);
}

// K6's entry in the grid cache.
lfs::Grid g_grids[1] = {{"words", 0, (const void*)stream_sums_words_kernel, kThreads}};
[[maybe_unused]] const bool g_enrolled = lfs::enroll(g_grids);

}  // namespace

extern "C" {

// Adds the pass/fail bit counts of the n uint16 words at x into out
// (int64[30]), on `stream` of `device` (made current for the call); with
// zero != 0 a cudaMemsetAsync on `stream` zeroes out first (also for
// n = 0, which launches nothing). x must be 2-byte aligned. blocks > 0
// is the most blocks the grid gets (a sweep's knob, and the tests' way
// to run one thread far past a flush); 0 gives it one wave at most.
// Returns a cudaError_t.
int lfs_stream_sums_words(int device, const void* x, long long n, void* out, int blocks,
                          int zero, void* stream) {
  lfs::DeviceScope scope(device);
  if (scope.status != cudaSuccess) return scope.status;
  auto s = static_cast<cudaStream_t>(stream);
  if (zero) {
    const cudaError_t z = cudaMemsetAsync(out, 0, kStreams * sizeof(unsigned long long), s);
    if (z != cudaSuccess) return z;
  }
  if (n <= 0) return cudaSuccess;  // a 0-block launch is an error
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const uintptr_t aligned = addr & ~uintptr_t(15);
  const int64_t skip = (int64_t)(addr - aligned) / 2;
  const int64_t end = skip + n;
  const int64_t tiles = (end + kTileWords - 1) / kTileWords;
  return lfs::enqueue(g_grids[0], device, tiles, blocks, s, stream_sums_words_kernel,
                      reinterpret_cast<const uint16_t*>(aligned), skip, end, tiles,
                      static_cast<unsigned long long*>(out));
}

// Words one block covers per turn of its grid-stride loop.
int lfs_words_block_words(void) { return kTileWords; }

// HS-16 bodies (16 words each; a turn is two) between a thread's
// flushes of its packed halves.
int lfs_words_flush_bodies(void) { return kFlushBodies; }

}  // extern "C"
