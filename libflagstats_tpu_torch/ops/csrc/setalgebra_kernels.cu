// Set-algebra population counts over bitmaps for NVIDIA Hopper (sm_90a).
//
// Replaces the device tier of libflagstats_tpu/ops/setalgebra.py
// (`_jit_unary`, `_jit_binary`, :29-46): `lax.population_count` + `sum`
// on uint32 lanes, which XLA fuses into one pass. That is no Pallas
// kernel; this one is written by hand because PyTorch has no popcount
// operator and the plain SWAR version makes about ten passes over the
// bitmap. It computes sum(popcount(f(a, b))) over two buffers of equal
// size, f = a & b (intersect), a | b (union), a & ~b (diff), and
// sum(popcount(a)) (popcnt): the four operations of `lfs_setop_count` of
// the host library (io/csrc/flagstats_host.cpp), with its op ids.
//
// Bound on this card. It reads every byte of a (and of b) once and does
// one __popc per 4 bytes. __popc issues at 16 per clock per SM: on 132
// SMs at 1.98 GHz that is 4.18e12 lanes/s, 16.7 TB/s of input, five
// times the H100 SXM's nominal 3.35 TB/s of device memory. The read
// bounds it.
//
// Design, and why.
// * Loads: a grid-stride loop over the 16-byte vectors of the bitmaps,
//   four in flight per thread and buffer, neighbouring threads on
//   neighbouring vectors. The buffers are 4-byte aligned lanes. Where a
//   and b start at the same offset within 16 bytes, the lanes before the
//   first aligned vector and after the last load one by one; where they
//   do not, no vector is aligned in both and every lane loads alone
//   (still coalesced, 4 bytes a thread).
// * The tally is 64 bits from the thread up: a turn's at most 1,024 bits
//   go into a 32-bit sum and from there into the thread's 64-bit tally,
//   then a warp shuffle, a shared sum and one 64-bit atomicAdd per block
//   into the zeroed output. The JAX package reduces in int32 and so cuts
//   a bitmap into chunks of 2^25 lanes (`_CHUNK_LANES`, setalgebra.py
//   :49-69: an unchunked reduce went negative at 2^31 set bits); nothing
//   here can wrap below 2^64 bits, so no call is chunked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vector loads in flight per thread and buffer

// the host library's op ids (ops/native_host.SETOP_IDS)
enum Op { kIntersect = 0, kUnion = 1, kDiff = 2, kPopcnt = 3 };

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  return OP == kIntersect ? a & b : OP == kUnion ? a | b : OP == kDiff ? a & ~b : a;
}

template <int OP>
__device__ __forceinline__ uint32_t popc4(const uint4 a, const uint4 b) {
  return __popc(combine<OP>(a.x, b.x)) + __popc(combine<OP>(a.y, b.y)) +
         __popc(combine<OP>(a.z, b.z)) + __popc(combine<OP>(a.w, b.w));
}

// Lanes [head, head + 4 * vecs) of a and b are 16-byte aligned vectors;
// the other lanes, [0, head) and [head + 4 * vecs, n), load one by one.
template <int OP>
__global__ void __launch_bounds__(kThreads)
    setop_count_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, int64_t n,
                       int64_t head, int64_t vecs, unsigned long long* __restrict__ out) {
  unsigned long long tally = 0;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const uint4* a4 = reinterpret_cast<const uint4*>(a + head);
  const uint4* b4 = reinterpret_cast<const uint4*>(OP == kPopcnt ? a + head : b + head);
  int64_t v = tid;
  for (; v + (kUnroll - 1) * stride < vecs; v += kUnroll * stride) {
    uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ra[u] = __ldg(a4 + v + u * stride);
      rb[u] = OP == kPopcnt ? ra[u] : __ldg(b4 + v + u * stride);
    }
    uint32_t turn = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) turn += popc4<OP>(ra[u], rb[u]);
    tally += turn;
  }
  for (; v < vecs; v += stride) {
    const uint4 ra = __ldg(a4 + v);
    tally += popc4<OP>(ra, OP == kPopcnt ? ra : __ldg(b4 + v));
  }
  const int64_t singles = n - 4 * vecs;
  for (int64_t i = tid; i < singles; i += stride) {
    const int64_t lane = i < head ? i : i + 4 * vecs;
    tally += __popc(combine<OP>(a[lane], OP == kPopcnt ? 0u : b[lane]));
  }

  // the block's sum: a warp shuffle, a shared sum, one atomic per block
  __shared__ unsigned long long warp_sum[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) tally += __shfl_down_sync(0xFFFFFFFFu, tally, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = tally;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    if (total) atomicAdd(out, total);
  }
}

// The grid cache's entries of the four ops, indexed by Op.
lfs::Grid g_grids[4] = {
    {"setop", kIntersect, (const void*)setop_count_kernel<kIntersect>, kThreads},
    {"setop", kUnion, (const void*)setop_count_kernel<kUnion>, kThreads},
    {"setop", kDiff, (const void*)setop_count_kernel<kDiff>, kThreads},
    {"setop", kPopcnt, (const void*)setop_count_kernel<kPopcnt>, kThreads},
};
[[maybe_unused]] const bool g_enrolled = lfs::enroll(g_grids);

template <int OP>
cudaError_t launch(int device, const void* a, const void* b, int64_t n, unsigned long long* out,
                   cudaStream_t stream) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = OP == kPopcnt ? pa : reinterpret_cast<uintptr_t>(b);
  if (pa % 4 || pb % 4 || (OP != kPopcnt && b == nullptr)) return cudaErrorInvalidValue;
  int64_t head = n, vecs = 0;  // every lane alone, unless a and b align together
  if (pa % 16 == pb % 16) {
    head = (int64_t)((16 - pa % 16) % 16) / 4;
    if (head > n) head = n;
    vecs = (n - head) / 4;
  }
  const int64_t work = vecs > n - 4 * vecs ? vecs : n - 4 * vecs;
  return lfs::enqueue(g_grids[OP], device, (work + kThreads - 1) / kThreads, 0, stream,
                      setop_count_kernel<OP>, static_cast<const uint32_t*>(a),
                      static_cast<const uint32_t*>(b), n, head, vecs, out);
}

}  // namespace

extern "C" {

// Adds sum(popcount(f(a, b))) over the n uint32 lanes at a and b (4-byte
// aligned; b is not read for op 3) into *out (uint64, zeroed by the
// caller), on `stream` of `device` (made current for the call). op: 0
// a & b, 1 a | b, 2 a & ~b, 3 a. Returns a cudaError_t.
int lfs_setop_count_cuda(int device, int op, const void* a, const void* b, long long n,
                         void* out, void* stream) {
  if (n <= 0) return cudaSuccess;  // a 0-block launch is an error
  lfs::DeviceScope scope(device);
  if (scope.status != cudaSuccess) return scope.status;
  auto* o = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kIntersect: return launch<kIntersect>(device, a, b, n, o, s);
    case kUnion: return launch<kUnion>(device, a, b, n, o, s);
    case kDiff: return launch<kDiff>(device, a, b, n, o, s);
    case kPopcnt: return launch<kPopcnt>(device, a, b, n, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
