// The framed stream's LZ4 decode on the card, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX stream decodes its frames on the host
// (libflagstats_tpu/io/stream.py, through the native library's
// lfs_decode_stream). It was added because on an H100 the host's eight
// cores decoding a report's frames were the stream's pace while the card
// idled (PERF.md §5): the card decodes, the host only copies compressed
// bytes.
//
// What it computes. Each frame of the framed format is one LZ4 block
// (io/codec.py). A table row per frame gives its compressed bytes'
// offset and length, its output's offset and its raw length. The kernel
// decodes every frame of the launch into its [out, out + raw_len) and
// writes one int32 a frame: the bytes decoded, or -1. The rules, the
// bounds checks and the result are those of the host's clean-room
// decoder (io/csrc/flagstats_io.cpp lfs_lz4_decompress_own): for any
// bytes it reads only inside the frame's compressed range and writes only
// inside its output range; a short but well-formed block reports its
// shorter length, which the caller compares with raw_len.
//
// Bound on this card. The bytes are small: 824.6 MB read and 1.65 GB
// written for the NA12878 column's 1,611 frames, 0.74 ms at 3.35 TB/s.
// The work is not: a frame is ~159k sequences of ~6.4 output bytes
// (0.22 literal bytes and 6.21 match bytes each, LZ4-fast acceleration
// 2), and each sequence's place in the compressed stream depends on the
// lengths of the one before it. So a frame is a serial chain of ~159k
// short parse steps, and the kernel's time is the length of that chain
// times the latency of a step, over the frames that run at once.
//
// Design, and why (each step measured on an H100 80GB HBM3, PERF.md §6).
// * One warp a frame, one frame a block, a launch's frames resident at
//   once (1,611 frames are ~12 blocks an SM of the 17 its 12 KiB of
//   shared memory allow): the chains run side by side, and a launch
//   takes about one frame's chain whatever its frame count. The
//   alternative, a frame's whole 64 KiB window in shared memory, fits
//   three frames an SM: 1,611 frames would take five rounds of the chain.
// * The chain is cut to one load a step. A batch of up to 32 sequences
//   is parsed in two passes. Pass one walks the starts: a sequence with
//   no length extension and a match ends 3 + its literal count after its
//   token, so a step is a load of the token from 4 KiB of the compressed
//   bytes staged in shared memory and two adds; lane j keeps the j-th
//   start, and the walk stops at an extension or the end of the block.
//   Pass two decodes each lane's sequence at once, with the host
//   decoder's checks, and a warp scan of the output lengths places them;
//   the batch keeps its sequences up to the first one that fails.
// * The batch's bytes are made in an 8 KiB ring of the output in shared
//   memory, then written to device memory lane after lane. Each lane
//   copies its literals and, when the match reads only bytes before the
//   batch, its match: from the ring when the batch leaves them there,
//   else from device memory (offsets past ~8 KiB, ~1 match in 10). The
//   matches that read the batch's own bytes (~1 in 20) then go in
//   sequence order, each by the whole warp: byte i of a match of offset
//   o is byte (i mod o) of the o bytes before it, all written by then,
//   so the overlapped case needs no byte-serial loop. A literal run or
//   match longer than 32 bytes ends the batch's shared part and is copied
//   by the whole warp straight to device memory, its last 8 KiB to the
//   ring too.
// * Memory order within the warp is __syncwarp's: between the batch's
//   rounds and between batches. The compressed bytes are read through
//   the read-only path; the output, which the warp reads back, is not.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBatch = 32;  // sequences parsed before a round of copies: one a lane
constexpr int kShort = 32;  // longest literal run or match copied in a batch's round
constexpr uint32_t kWindow = 4096;  // compressed bytes a warp stages in shared memory
constexpr uint32_t kRing = 8192;    // output bytes a warp keeps in shared memory
constexpr uint32_t kMask = kRing - 1;

// One row of the frame table (int64[4]): where the frame's compressed
// bytes lie, their length, where its output lies, its raw length.
struct Frame {
  long long src, len, out, raw;
};

// An LZ4 length extension at in[ip]: adds bytes while they are 255.
// False when it runs past the input.
__device__ __forceinline__ bool extend(const uint8_t* __restrict__ in, uint32_t in_len,
                                       uint32_t& ip, uint64_t& len) {
  uint32_t b;
  do {
    if (ip >= in_len) return false;
    b = __ldg(in + ip++);
    len += b;
  } while (b == 255);
  return true;
}

// Output bytes [d, d + n), n <= kShort, into the ring from read(i), all
// loads before any store.
template <typename Read>
__device__ __forceinline__ void to_ring(uint8_t* ring, uint32_t d, uint32_t n, Read read) {
#pragma unroll
  for (uint32_t c = 0; c < kShort; c += 8) {
    if (c >= n) break;
    uint8_t v[8];
#pragma unroll
    for (uint32_t i = 0; i < 8; ++i)
      if (c + i < n) v[i] = read(c + i);
#pragma unroll
    for (uint32_t i = 0; i < 8; ++i)
      if (c + i < n) ring[(d + c + i) & kMask] = v[i];
  }
}

__global__ void __launch_bounds__(32, 16)
    lz4_decode_kernel(const uint8_t* __restrict__ comp, long long comp_shift,
                      const Frame* __restrict__ table, int first, uint8_t* out_base,
                      long long out_shift, int* __restrict__ status) {
  __shared__ uint8_t staged[kWindow];
  __shared__ uint8_t ring[kRing];
  const int f = first + blockIdx.x;
  const Frame fr = table[f];
  const uint8_t* __restrict__ in = comp + (fr.src - comp_shift);
  const uint32_t in_len = (uint32_t)fr.len;
  uint8_t* out = out_base + (fr.out - out_shift);
  const uint32_t cap = (uint32_t)fr.raw;
  const int lane = threadIdx.x;
  // compressed byte p: from the staged window [base, base + kWindow) when
  // it holds it, else from device memory
  uint32_t base = 0;
  bool filled = false;
  auto byte = [&](uint32_t p) -> uint32_t {
    return p - base < kWindow ? staged[p - base] : __ldg(in + p);
  };

  uint32_t ip = 0, op = 0;
  bool ok = true;
  while (ok && ip < in_len) {
    // the window holds the next batch's walk: 32 steps of at most 18
    // bytes, the ones past the walk's end too
    if (!filled || ip + kBatch * 18 > base + kWindow) {
      __syncwarp();
      base = ip;
      for (uint32_t i = lane; i < kWindow && ip + i < in_len; i += 32)
        staged[i] = __ldg(in + ip + i);
      __syncwarp();
      filled = true;
    }
    // pass one: the starts of up to 32 sequences, one load a step. A
    // sequence with no extension and a match ends 3 + its literal count
    // after its token; the walk stops at the first that may not (an
    // extension, or the end of the block). The chain of steps is the
    // load and two adds: the steps go on past the walk's end (inside the
    // window, reading what they may) and only the walk's own are kept
    uint32_t my_s = 0, my_t = 0, q = ip - base;
    const uint32_t q_end = in_len - base;
    int n = 0;
    bool walk = true;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const uint32_t t = staged[q];
      if (walk && lane == k) my_s = base + q, my_t = t;
      n += walk;
      q += 3 + (t >> 4);
      walk = walk && t < 0xF0 && (t & 15) != 15 && q < q_end;
    }
    // pass two: each lane its sequence, as the host's decoder reads one
    const bool mine = lane < n;
    bool bad = false;
    uint32_t lit_src = 0, end = 0, m_off = 1;
    uint64_t lit = 0, ml = 0;
    if (mine) {
      uint32_t p = my_s + 1;
      lit = my_t >> 4;
      if (lit == 15) bad = !extend(in, in_len, p, lit);
      if (!bad && lit > in_len - p) bad = true;
      lit_src = p;
      if (!bad) {
        p += (uint32_t)lit;
        if (p < in_len) {  // else the last sequence: literals only
          if (in_len - p < 2) {
            bad = true;
          } else {
            m_off = byte(p) | (byte(p + 1) << 8);
            p += 2;
            ml = (my_t & 15) + 4;
            if ((my_t & 15) == 15) bad = !extend(in, in_len, p, ml);
          }
        }
      }
      end = p;
    }
    // the batch's output: an exclusive scan of each sequence's bytes (a
    // length past the output is bad, and counts 0)
    if (lit > cap || ml > cap) bad = true;
    const uint64_t bytes = mine && !bad ? lit + ml : 0;
    uint64_t incl = bytes;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const uint32_t ld = op + (uint32_t)(incl - bytes), md = ld + (uint32_t)lit;
    if (mine && !bad && (op + incl > cap || (ml && (m_off == 0 || m_off > md)))) bad = true;
    // the batch keeps its sequences up to the first bad one, and copies
    // them in shared memory up to the first long one
    const unsigned bad_lanes = __ballot_sync(kFull, mine && bad);
    const int keep = bad_lanes ? __ffs(bad_lanes) - 1 : n;
    if (bad_lanes) ok = false;
    const unsigned long_lanes =
        __ballot_sync(kFull, lane < keep && (lit > kShort || ml > kShort));
    const int near = long_lanes ? __ffs(long_lanes) - 1 : keep;
    const uint32_t start = op;
    const uint32_t stop = near ? op + (uint32_t)__shfl_sync(kFull, incl, near - 1) : op;

    // round one: each lane's literals, and its match when the match reads
    // only bytes written before the batch: from the ring when the batch
    // leaves them there, else from device memory
    const bool in_round = lane < near;
    const uint32_t lit_len = in_round ? (uint32_t)lit : 0, m_len = in_round ? (uint32_t)ml : 0;
    const uint32_t from = md - m_off;
    const bool later = m_len && from + (m_len < m_off ? m_len : m_off) > start;
    if (lit_len) to_ring(ring, ld, lit_len, [&](uint32_t i) { return byte(lit_src + i); });
    if (m_len && !later) {
      uint32_t r = 0;  // i mod m_off, kept by counting
      auto cyc = [&]() {
        const uint32_t at = r;
        r = r + 1 == m_off ? 0 : r + 1;
        return at;
      };
      if (from + kRing >= stop)
        to_ring(ring, md, m_len, [&](uint32_t) { return ring[(from + cyc()) & kMask]; });
      else
        to_ring(ring, md, m_len, [&](uint32_t) { return out[from + cyc()]; });
    }
    __syncwarp();
    // the matches that read the batch's own bytes, in sequence order, the
    // warp together: byte i of a match of offset o is byte (i mod o) of
    // the o bytes before it, all written by now
    for (unsigned left = __ballot_sync(kFull, later); left; left &= left - 1) {
      const int k = __ffs(left) - 1;
      const uint32_t d = __shfl_sync(kFull, md, k);
      const uint32_t o = __shfl_sync(kFull, m_off, k);
      const uint32_t len = __shfl_sync(kFull, m_len, k);
      if (lane < len) ring[(d + lane) & kMask] = ring[(d - o + (lane < o ? lane : lane % o)) & kMask];
      __syncwarp();
    }
    // the batch's bytes to device memory, lane after lane
    for (uint32_t i = start + lane; i < stop; i += 32) out[i] = ring[i & kMask];
    __syncwarp();
    if (near == keep) {
      if (keep > 0) {
        ip = __shfl_sync(kFull, end, keep - 1);
        op = stop;
      }
      continue;
    }
    // the first long sequence, the warp together, straight to device
    // memory, its last kRing bytes also to the ring
    const uint32_t src = __shfl_sync(kFull, lit_src, near);
    const uint32_t d = __shfl_sync(kFull, ld, near);
    const uint32_t o = __shfl_sync(kFull, m_off, near);
    const uint32_t nl = (uint32_t)__shfl_sync(kFull, lit, near);
    const uint32_t nm = (uint32_t)__shfl_sync(kFull, ml, near);
    const uint32_t tail = d + nl + nm - (nl + nm < kRing ? nl + nm : kRing);
    for (uint32_t i = lane; i < nl; i += 32) {
      const uint8_t b = __ldg(in + src + i);
      out[d + i] = b;
      if (d + i >= tail) ring[(d + i) & kMask] = b;
    }
    __syncwarp();
    for (uint32_t i = lane; i < nm; i += 32) {
      const uint8_t b = out[d + nl - o + (i < o ? i : i % o)];
      out[d + nl + i] = b;
      if (d + nl + i >= tail) ring[(d + nl + i) & kMask] = b;
    }
    __syncwarp();
    ip = __shfl_sync(kFull, end, near);
    op = d + nl + nm;
  }
  if (lane == 0) status[f] = ok ? (int)op : -1;
}

}  // namespace

extern "C" {

// Decodes frames [first, first + count) of the frame table `table`
// (int64[4] a row: src, len, out, raw; see Frame) on `stream` of `device`
// (made current for the call), one block of one warp a frame: frame f's
// compressed bytes are comp[src - comp_shift, + len) and its output
// out[out - out_shift, + raw), and status[f] gets the bytes it decoded,
// or -1. count <= 0 launches nothing. Returns a cudaError_t.
int lfs_lz4_decode(int device, const void* comp, long long comp_shift, const void* table,
                   int first, int count, void* out, long long out_shift, void* status,
                   void* stream) {
  lfs::DeviceScope scope(device);
  if (scope.status != cudaSuccess) return scope.status;
  if (count <= 0) return cudaSuccess;  // a 0-block launch is an error
  // shared memory before L1: a block takes 12 KiB of it, and all of a
  // launch's frames should be resident at once
  const cudaError_t e = cudaFuncSetAttribute(
      lz4_decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  lz4_decode_kernel<<<count, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), comp_shift, static_cast<const Frame*>(table), first,
      static_cast<uint8_t*>(out), out_shift, static_cast<int*>(status));
  return cudaGetLastError();
}

}  // extern "C"
