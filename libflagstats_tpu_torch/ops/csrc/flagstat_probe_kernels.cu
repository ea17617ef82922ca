// The measurement kernels for NVIDIA Hopper (sm_90a): the read roofline
// (K4), the three stage probes of the stage decomposition (K7) and the
// plane-row fold of the packed-layout probe (K8).
//
// Replaces these TPU kernels of libflagstats_tpu/ops/pallas_kernels.py:
// * read_xor: `read_xor_pallas` (pallas_call :605, body
//   `_make_roof_kernel` :573), the read roofline of the benchmark
//   harness;
// * transpose_xor: `transpose_xor_pallas` (pallas_call :723, body :678);
// * transform_xor: `transform_xor_pallas_pre` (pallas_call :790, body
//   :739);
// * stream_sums_raw: `stream_sums_pallas_raw` (modes "flagstat_raw" and
//   "flagstat_raw@N", through the pallas_call at :403);
// * fold_xor: `make_fold.<locals>.fold` of tools/packed_probe.py
//   (pallas_call :72, body :56-68), the read kernel of the packed-layout
//   probe: the xor of every uint32 of the chosen rows of plane tiles.
// Each computes what the TPU function computes, on any length it takes.
//
// The register pairing. The TPU functions over uint16 words view the
// zero-padded stream as (G, 32, 16, 128) tiles and pair sublanes 2s and
// 2s+1 into one uint32: register k at (s, l) of group g is
// word[g][k][2s][l] | word[g][k][2s+1][l] << 16. Zero words are xor- and
// count-neutral, so no padding is materialised: words past n read as 0.
//
// Bound on this card. read_xor reads 2 bytes per word and does ~1 xor
// per 4 words: at the H100 SXM's nominal 3.35 TB/s it is bound by the
// read, which is what makes it the roofline. The probes at repeat 1 read
// the same bytes (transpose_xor 2 bytes per word; transform_xor and
// stream_sums_raw 4 bytes per word of 32-row tiles, of which they load
// 24 and 30 rows) and add their stage's integer work: ~5 operations per
// word for the pruned transpose, ~1 for the transform and ~3 for the
// count (29 __popc, adds and xors per 32 words). `repeat` runs the stage that many times on data it chains,
// so at a large enough repeat each probe is bound by its integer work,
// and the difference of two repeats is that work's time. fold_xor reads
// 4 KiB per chosen row per group and does one xor per 4 bytes: the bytes
// of the chosen rows bound it, and the rows it leaves out cost nothing
// only if they are really never loaded, which is what the probe asks.
//
// Design, and why.
// * read_xor: a grid-stride loop over the 16-byte vectors wholly inside
//   the stream, four loads in flight per thread. A vector never straddles
//   a 128-word row (an aligned start), so its 4 uint32 fold into the
//   even-row or the odd-row accumulator; per-word folding handles a
//   misaligned start, and the < 8 words at each edge load one by one.
//   The digest's low half is the xor of the words at index i with
//   (i >> 7) & 1 == 0, its high half of the others.
// * transpose_xor: one thread per (g, s, l) position, so a warp takes 32
//   consecutive lanes of one (k, sublane) and reads whole 32-byte
//   sectors; the 32 registers go through bitslice.pruned_pairs()
//   (not the full network, and not K1's dead-code-pruned copy) `repeat`
//   times, each rep on the last one's rows, then the NEEDED_ROWS fold.
// * transform_xor: one thread per position, 24 coalesced uint32 planes
//   (12 per half); `repeat` times t = transform_planes(p), p = t[0..11];
//   then the fold of the 15 C planes and the 14 F planes ANDed with q.
//   The transform is idempotent on the planes it feeds back (t(t(p))
//   = t(p) on t[0..11]), so nvcc may fold unrolled reps into one; each
//   rep's planes are xored with a kernel argument that is 0 at run time
//   and opaque to the compiler (the xor fuses with the and into a LOP3).
// * stream_sums_raw: K2's body over 32-row tiles (a thread takes four
//   positions as one uint4 per row) with the transform deleted: plane k
//   counted with __popc into C-stream k and, for k != 9, F-stream k.
//   Rep r counts the planes xored with r * z1, z1 a kernel argument that
//   is 0 at run time, so no rep can be hoisted (cnt += repeat * popc) or
//   share its popcounts with another rep's or with its own F count. An
//   empty asm barrier does not do this (it is gone before ptxas runs),
//   nor does a fixed xor (x ^ z ^ z repeats once the loop is unrolled):
//   with either, the probe's time stayed flat in repeat on the H100.
// * fold_xor: the TPU kernel carries an (8, 128) digest from grid step
//   to grid step, 8 groups a step; blocks here run in no order, so
//   nothing is carried and there is no step depth. A block takes one
//   (group, chosen row) pair per load, one uint4 per thread (a row is 256
//   uint4, the block's 256 threads), four pairs in flight per turn of its
//   grid-stride loop. The row set is a run-time bit mask over the tile's
//   rows, expanded once per block into a shared table; a row outside it
//   is never addressed, and rows are whole 4 KiB, so no sector of an
//   unread row is fetched. Any group count is taken; an empty mask or no
//   group launches nothing.
// * Blocks meet as in K1: a warp shuffle, a shared fold or sum, and one
//   atomic per block (atomicXor into a zeroed uint32, atomicAdd into the
//   zeroed int64 sums).
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"

namespace {

using namespace lfs;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // read_xor: vector loads in flight per thread
constexpr int kGroupWords = 65536;         // words per register group
constexpr int kPositions = 1024;           // (s, l) positions per group
constexpr int kRowVecs = 256;              // 16-byte vectors per plane row of a group

// bitslice.pruned_pairs(): bit k of stage s's mask marks the swap pair
// (k, k + j), j = 8 >> s, that reaches a row of NEEDED_ROWS
// (tests/test_torch_probe_sources.py holds these to the Python table).
__host__ __device__ constexpr uint32_t pruned_mask(int s) {
  return s == 0 ? 0x00FF00FFu : s == 1 ? 0x0F0F0F0Fu : s == 2 ? 0x33303330u : 0x55505550u;
}
// bitslice.NEEDED_ROWS: rows 4-15 and 20-31
constexpr uint32_t kNeededRows = 0xFFF0FFF0u;

__device__ __forceinline__ uint32_t fold16(uint32_t a) { return (a ^ (a >> 16)) & 0xFFFFu; }

// ---- K4: read_xor ----

__device__ __forceinline__ void fold_word(uint32_t w, int64_t i, uint32_t& even, uint32_t& odd) {
  if ((i >> 7) & 1) odd ^= w; else even ^= w;
}

// Fold the 8 words of one vector; i0 is the stream index of its first.
__device__ __forceinline__ void fold_vec(const uint4 v, int64_t i0, uint32_t& even, uint32_t& odd) {
  if (((i0 ^ (i0 + 7)) >> 7) == 0) {
    fold_word(v.x ^ v.y ^ v.z ^ v.w, i0, even, odd);
  } else {  // a misaligned start: the vector straddles two rows
    const uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) fold_word((c[j >> 1] >> (16 * (j & 1))) & 0xFFFFu, i0 + j, even, odd);
  }
}

// base: the 16-byte aligned address at or below the stream; the stream
// is words [skip, end) of it. Vectors [vfirst, vlast) lie wholly inside.
__global__ void __launch_bounds__(kThreads)
    read_xor_kernel(const uint16_t* __restrict__ base, int64_t skip, int64_t end,
                    unsigned int* __restrict__ out) {
  uint32_t even = 0, odd = 0;
  const uint4* base4 = reinterpret_cast<const uint4*>(base);
  const int64_t vfirst = (skip + 7) / 8, vlast = end / 8;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t v = vfirst + tid;
  for (; v + (kUnroll - 1) * stride < vlast; v += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(base4 + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fold_vec(r[u], 8 * (v + u * stride) - skip, even, odd);
  }
  for (; v < vlast; v += stride) fold_vec(__ldg(base4 + v), 8 * v - skip, even, odd);
  // the edge words: head [skip, hend) and tail [tstart, end), < 8 each
  const int64_t hend = 8 * vfirst < end ? 8 * vfirst : end;
  const int64_t tstart = 8 * vlast > hend ? 8 * vlast : hend;
  if (tid < 16) {
    const int64_t p = tid < 8 ? skip + tid : tstart + tid - 8;
    if (p < (tid < 8 ? hend : end)) fold_word(base[p], p - skip, even, odd);
  }
  flush_xor<kThreads>(fold16(even) | (fold16(odd) << 16), out);
}

// ---- K7b: transpose_xor ----

// bitslice.TRANSPOSE_STAGES through the pruned pairs only.
__device__ __forceinline__ void transpose_pruned(uint32_t (&a)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = 8 >> s;
    const uint32_t m = s == 0 ? 0x00FF00FFu : s == 1 ? 0x0F0F0F0Fu : s == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (!((pruned_mask(s) >> k) & 1u)) continue;
      const uint32_t t = (a[k] ^ (a[k + j] >> j)) & m;
      a[k] ^= t;
      a[k + j] ^= t << j;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    transpose_xor_kernel(const uint16_t* __restrict__ x, int64_t n, int64_t positions,
                         int repeat, unsigned int* __restrict__ out) {
  uint32_t acc = 0;
  for (int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x; q < positions;
       q += (int64_t)gridDim.x * kThreads) {
    // register k's low word: word[g][k][2s][l], its high word 128 later
    const int64_t w0 = (q >> 10) * kGroupWords + ((q >> 7) & 7) * 256 + (q & 127);
    uint32_t a[32];
    if (w0 + 31 * 2048 + 128 < n) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        a[k] = __ldg(x + w0 + k * 2048) | ((uint32_t)__ldg(x + w0 + k * 2048 + 128) << 16);
    } else {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int64_t w = w0 + k * 2048;
        a[k] = (w < n ? (uint32_t)x[w] : 0u) | ((w + 128 < n ? (uint32_t)x[w + 128] : 0u) << 16);
      }
    }
    for (int r = 0; r < repeat; ++r) transpose_pruned(a);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if ((kNeededRows >> k) & 1u) acc ^= a[k];
  }
  flush_xor<kThreads>(acc, out);
}

// ---- K7c: transform_xor ----

__global__ void __launch_bounds__(kThreads)
    transform_xor_kernel(const uint32_t* __restrict__ planes, int64_t positions, int repeat,
                         uint32_t z, unsigned int* __restrict__ out) {
  uint32_t acc = 0;
  for (int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x; q < positions;
       q += (int64_t)gridDim.x * kThreads) {
    const uint32_t* tile = planes + (q >> 10) * 32 * kPositions + (q & (kPositions - 1));
    uint32_t p[2][12];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 12; ++j) p[half][j] = __ldg(tile + ((half ? 31 : 15) - j) * kPositions);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t t[15];
      for (int r = 0; r < repeat; ++r) {
        transform_planes(p[half], t);
#pragma unroll
        for (int j = 0; j < 12; ++j) p[half][j] = t[j] ^ z;
      }
      const uint32_t qc = t[9];  // the QC-fail plane
#pragma unroll
      for (int k = 0; k < 15; ++k) acc ^= t[k];                  // C_STREAMS
#pragma unroll
      for (int k = 0; k < 15; ++k) acc ^= k == 9 ? 0u : t[k] & qc;  // F_STREAMS
    }
  }
  flush_xor<kThreads>(acc, out);
}

// ---- K7a: stream_sums_raw ----

// z1 and z2 are 0 (the launcher passes them), but the compiler cannot
// know that. Rep r counts the planes xored with zr = r * z1 (C streams)
// and zr ^ z2 (F streams): to the compiler a new value at every rep and
// for each count, so no rep's popcounts can be hoisted, shared or folded
// with another's, and the counts are exact.
__global__ void __launch_bounds__(kThreads)
    stream_sums_raw_kernel(const uint4* __restrict__ planes, int64_t groups, int repeat,
                           uint32_t z1, uint32_t z2, unsigned long long* __restrict__ out) {
  constexpr int NS = 29;  // 15 C streams, then F_STREAMS (planes 0-14 but 9)
  __shared__ unsigned long long block_sum[NS];
  for (int s = threadIdx.x; s < NS; s += kThreads) block_sum[s] = 0;

  uint32_t cnt[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) cnt[s] = 0;

  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const uint4* tile = planes + g * 32 * kRowVecs + threadIdx.x;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 v[15];
#pragma unroll
      for (int j = 0; j < 15; ++j) v[j] = __ldg(tile + ((half ? 31 : 15) - j) * kRowVecs);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t p[15];
#pragma unroll
        for (int j = 0; j < 15; ++j)
          p[j] = c == 0 ? v[j].x : c == 1 ? v[j].y : c == 2 ? v[j].z : v[j].w;
        uint32_t zr = 0;
        for (int r = 0; r < repeat; ++r) {
          zr += z1;
          const uint32_t zf = zr ^ z2;
#pragma unroll
          for (int k = 0; k < 15; ++k) cnt[k] += __popc(p[k] ^ zr);
#pragma unroll
          for (int i = 0; i < 14; ++i) cnt[15 + i] += __popc(p[i + (i >= 9)] ^ zf);
        }
      }
    }
  }
  flush_counts<NS, kThreads>(cnt, block_sum, out);
}

// ---- K8: fold_xor ----

// The xor of every uint32 of the rows in `mask` (bit r = row r of the
// tile's nrows rows) of `groups` plane tiles. sel[j] is the j-th chosen
// row; pair p is (group p / nsel, row sel[p % nsel]).
__device__ __forceinline__ uint4 load_pair(const uint4* planes, const int* sel, int nsel,
                                           int nrows, int64_t p) {
  return __ldg(planes + ((p / nsel) * nrows + sel[p % nsel]) * kRowVecs + threadIdx.x);
}

__device__ __forceinline__ void xor_into(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

__global__ void __launch_bounds__(kThreads)
    fold_xor_kernel(const uint4* __restrict__ planes, int64_t groups, int nrows, uint32_t mask,
                    unsigned int* __restrict__ out) {
  __shared__ int sel[32];
  if (threadIdx.x < 32 && ((mask >> threadIdx.x) & 1u))
    sel[__popc(mask & ((1u << threadIdx.x) - 1u))] = threadIdx.x;
  __syncthreads();
  const int nsel = __popc(mask);
  const int64_t pairs = groups * nsel;
  const int64_t stride = gridDim.x;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  int64_t p = blockIdx.x;
  for (; p + (kUnroll - 1) * stride < pairs; p += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = load_pair(planes, sel, nsel, nrows, p + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xor_into(acc, r[u]);
  }
  for (; p < pairs; p += stride) xor_into(acc, load_pair(planes, sel, nsel, nrows, p));
  flush_xor<kThreads>(acc.x ^ acc.y ^ acc.z ^ acc.w, out);
}

template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int64_t want, int* grid) {
  int blocks = 0;
  cudaError_t e = wave_blocks(kernel, kThreads, &blocks);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  *grid = (int)(want < 1 ? 1 : want < blocks ? want : blocks);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Xors the K4 digest of the n uint16 words at x into *out (uint32,
// zeroed by the caller), on `stream`. x must be 2-byte aligned. Returns
// a cudaError_t.
int lfs_read_xor(const void* x, long long n, void* out, void* stream) {
  if (n <= 0) return cudaSuccess;  // a 0-block launch is an error
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const uintptr_t aligned = addr & ~uintptr_t(15);
  const int64_t skip = (int64_t)(addr - aligned) / 2;
  const int64_t vectors = (skip + n) / 8 - (skip + 7) / 8;
  int grid = 0;
  cudaError_t e = grid_for(read_xor_kernel, (vectors + kThreads - 1) / kThreads, &grid);
  if (e != cudaSuccess) return e;
  read_xor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint16_t*>(aligned), skip, skip + n, static_cast<unsigned int*>(out));
  return cudaGetLastError();
}

// Xors the transpose probe's digest of the n words at x, `repeat` chained
// pruned transposes, into *out (uint32, zeroed by the caller).
int lfs_transpose_xor(const void* x, long long n, int repeat, void* out, void* stream) {
  if (n <= 0 || repeat < 1) return n <= 0 ? cudaSuccess : cudaErrorInvalidValue;
  const int64_t positions = (n + kGroupWords - 1) / kGroupWords * kPositions;
  int grid = 0;
  cudaError_t e = grid_for(transpose_xor_kernel, (positions + kThreads - 1) / kThreads, &grid);
  if (e != cudaSuccess) return e;
  transpose_xor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), n, positions, repeat, static_cast<unsigned int*>(out));
  return cudaGetLastError();
}

// Xors the transform probe's digest of `groups` (32, 8, 128) uint32 plane
// tiles at planes (4-byte aligned), `repeat` chained transforms, into
// *out (uint32, zeroed by the caller).
int lfs_transform_xor(const void* planes, long long groups, int repeat, void* out, void* stream) {
  if (groups <= 0 || repeat < 1) return groups <= 0 ? cudaSuccess : cudaErrorInvalidValue;
  const int64_t positions = groups * kPositions;
  int grid = 0;
  cudaError_t e = grid_for(transform_xor_kernel, (positions + kThreads - 1) / kThreads, &grid);
  if (e != cudaSuccess) return e;
  transform_xor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), positions, repeat, 0u,
      static_cast<unsigned int*>(out));
  return cudaGetLastError();
}

// Adds the count probe's 29 stream sums of `groups` (32, 8, 128) uint32
// plane tiles at planes (16-byte aligned), each counted `repeat` times,
// into out (int64[>= 29], zeroed by the caller).
int lfs_stream_sums_raw(const void* planes, long long groups, int repeat, void* out,
                        void* stream) {
  if (groups <= 0 || repeat < 1) return groups <= 0 ? cudaSuccess : cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(planes) % 16) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = grid_for(stream_sums_raw_kernel, groups, &grid);
  if (e != cudaSuccess) return e;
  stream_sums_raw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(planes), groups, repeat, 0u, 0u,
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

// Xors the fold of the rows in `mask` of `groups` (nrows, 8, 128) uint32
// plane tiles at planes (16-byte aligned; nrows <= 32, mask within it)
// into *out (uint32, zeroed by the caller).
int lfs_fold_xor(const void* planes, long long groups, int nrows, unsigned int mask, void* out,
                 void* stream) {
  if (nrows < 1 || nrows > 32 || (nrows < 32 && (mask >> nrows))) return cudaErrorInvalidValue;
  if (groups <= 0 || mask == 0) return cudaSuccess;  // a 0-block launch is an error
  if (reinterpret_cast<uintptr_t>(planes) % 16) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = grid_for(fold_xor_kernel, groups * __builtin_popcount(mask), &grid);
  if (e != cudaSuccess) return e;
  fold_xor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(planes), groups, nrows, mask, static_cast<unsigned int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
