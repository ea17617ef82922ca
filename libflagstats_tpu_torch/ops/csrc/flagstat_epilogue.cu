// The epilogue of a count on the card, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU path the same step is two jnp
// scatters and a few elementwise ops that XLA fuses into the kernel's
// program (pallas_kernels._sums_to_streams, xla_ops.assemble_counters).
// In eager PyTorch those were a chain of small device ops (two
// index_put_ scatters, each copying a host index list to the card with a
// blocking pageable copy, fills, a subtract, a clone, a cat) and a
// pageable readback: three host-device synchronisations and about twelve
// device operations for one kernel's 29 numbers (PERF.md). This kernel
// does the whole step in one launch.
//
// What it computes. The count kernels (K1/K3 flagstat_kernels.cu, K2
// flagstat_pre_kernels.cu, K6 flagstat_words_kernels.cu) add their raw
// per-stream sums into an int64 accumulator, each in its own stream
// order. A map, passed by value, says for each FLAG bit k where C[k] (the
// words whose transformed word has bit k set) and F[k] (the same over
// QC-fail words) lie in it: C[k] = acc[c[k]] + acc[c2[k]], F[k] =
// acc[f[k]], a negative index reading 0. Python builds the map once per
// mode from ops/bitslice.py's stream orders, the one source of them.
// Form 0 writes (C[16], F[16]); form 1 writes the 32 counters as
// torch_ops.assemble_counters defines them: pass[k] = C[k] - F[k],
// fail[k] = F[k], except at the QC-fail bit q, where pass[q] = n - C[q]
// and fail[q] = C[q], n being the true word count (a 64-bit argument).
//
// Bound: it reads at most 30 and writes 32 int64 values, one block of 32
// threads; its cost is one launch. With `host` set, the 32 results are
// copied with cudaMemcpyAsync into that (pinned) host buffer and `done`
// is recorded after the copy, so the caller synchronises once, on that
// event, and reads the counters.
//
// The merge-epilogue kernel ends a count sharded over cards
// (parallel/sharded.py, lfs_sharded_merge): the other cards' accumulators
// lie as rows of one buffer on card 0, and each entry the map reads is
// summed over card 0's accumulator and the rows before the same
// arithmetic, so the merge and the epilogue are one launch (it reads at
// most 30 entries of each of k accumulators).
#include <cuda_runtime.h>
#include <stdint.h>

#include "flagstat_common.cuh"
#include "flagstat_epilogue.cuh"

namespace {

// One FLAG bit k of the epilogue: C[k] = read(c[k]) + read(c2[k]) and
// F[k] = read(f[k]), `read` giving an accumulator entry (0 for index -1),
// written in the form `counters` asks for.
template <class Read>
__device__ __forceinline__ void epilogue_bit(int k, Read read, long long* __restrict__ out,
                                             const EpilogueMap& m, long long n, int counters) {
  const long long c = read(m.c[k]) + read(m.c2[k]);
  const long long f = read(m.f[k]);
  if (!counters) {
    out[k] = c;
    out[16 + k] = f;
  } else if (k == m.qc) {
    out[k] = n - c;
    out[16 + k] = c;
  } else {
    out[k] = c - f;
    out[16 + k] = f;
  }
}

__global__ void epilogue_kernel(const long long* __restrict__ acc, long long* __restrict__ out,
                                EpilogueMap m, long long n, int counters) {
  const int k = threadIdx.x;
  if (k >= 16) return;
  epilogue_bit(k, [acc](int i) { return i >= 0 ? acc[i] : 0LL; }, out, m, n, counters);
}

// The merge of a sharded count and its epilogue in one launch: each
// entry the map reads is card 0's accumulator `acc` plus the same entry
// of each of the `peers` rows (the other cards' sums, `stride` apart),
// and the 32 counters of n words are written from those totals.
__global__ void merge_epilogue_kernel(const long long* __restrict__ acc,
                                      const long long* __restrict__ rows, int peers, int stride,
                                      long long* __restrict__ out, EpilogueMap m, long long n) {
  const int k = threadIdx.x;
  if (k >= 16) return;
  auto total = [=](int i) {
    if (i < 0) return 0LL;
    long long v = acc[i];
    for (int p = 0; p < peers; ++p) v += rows[(long long)p * stride + i];
    return v;
  };
  epilogue_bit(k, total, out, m, n, 1);
}

}  // namespace

extern "C" {

// Enqueues on `stream` of `device` (made current for the call) the
// epilogue of the accumulator `acc` into `out` (int64[32] on the device):
// (C[16], F[16]) when counters == 0, else the 32 counters of n words.
// When `host` is not NULL, then copies `out` into it (int64[32],
// pinned), and when `done` (a cudaEvent_t) is not NULL, records it last.
// Returns a cudaError_t.
int lfs_epilogue(int device, const void* acc, void* out, EpilogueMap map, long long n,
                 int counters, void* host, void* done, void* stream) {
  lfs::DeviceScope scope(device);
  if (scope.status != cudaSuccess) return scope.status;
  auto s = static_cast<cudaStream_t>(stream);
  epilogue_kernel<<<1, 32, 0, s>>>(static_cast<const long long*>(acc),
                                    static_cast<long long*>(out), map, n, counters);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && host)
    e = cudaMemcpyAsync(host, out, 32 * sizeof(long long), cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess && done) e = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  return e;
}

// The end of a sharded count on `device`, card 0 (made current for the
// call), enqueued on its `stream`: a wait on each of the `peers` events
// (each recorded on another card after its sums' copy into `rows`), one
// launch of the merge-epilogue kernel, which adds card 0's accumulator
// `acc` and the rows (int64[peers][stride]) and writes the 32 counters of
// n words into `out` (int64[32] on the device), the copy of `out` into
// `host` (pinned int64[32]) and the record of the event `done`. Nothing
// waits: the caller synchronises on `done`. Returns a cudaError_t.
int lfs_sharded_merge(int device, const void* acc, const void* rows, int peers, int stride,
                      EpilogueMap map, long long n, void* out, void* host,
                      void* const* events, void* done, void* stream) {
  lfs::DeviceScope scope(device);
  if (scope.status != cudaSuccess) return scope.status;
  auto s = static_cast<cudaStream_t>(stream);
  for (int p = 0; p < peers; ++p) {
    const cudaError_t e = cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(events[p]), 0);
    if (e != cudaSuccess) return e;
  }
  merge_epilogue_kernel<<<1, 32, 0, s>>>(static_cast<const long long*>(acc),
                                          static_cast<const long long*>(rows), peers, stride,
                                          static_cast<long long*>(out), map, n);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(host, out, 32 * sizeof(long long), cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess) e = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  return e;
}

}  // extern "C"
