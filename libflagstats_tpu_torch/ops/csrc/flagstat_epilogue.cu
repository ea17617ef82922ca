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
#include <cuda_runtime.h>
#include <stdint.h>

// One mode's map from the accumulator to (C[k], F[k]); -1 reads 0.
struct EpilogueMap {
  int8_t c[16];
  int8_t c2[16];
  int8_t f[16];
  int8_t qc;  // the QC-fail bit (flags.FQCFAIL_OFF)
};

namespace {

__global__ void epilogue_kernel(const long long* __restrict__ acc, long long* __restrict__ out,
                                EpilogueMap m, long long n, int counters) {
  const int k = threadIdx.x;
  if (k >= 16) return;
  const long long c = (m.c[k] >= 0 ? acc[m.c[k]] : 0) + (m.c2[k] >= 0 ? acc[m.c2[k]] : 0);
  const long long f = m.f[k] >= 0 ? acc[m.f[k]] : 0;
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

}  // namespace

extern "C" {

// Enqueues on `stream` the epilogue of the accumulator `acc` into `out`
// (int64[32] on the device): (C[16], F[16]) when counters == 0, else the
// 32 counters of n words. When `host` is not NULL, then copies `out` into
// it (int64[32], pinned), and when `done` (a cudaEvent_t) is not NULL,
// records it last. Returns a cudaError_t.
int lfs_epilogue(const void* acc, void* out, EpilogueMap map, long long n, int counters,
                 void* host, void* done, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  epilogue_kernel<<<1, 32, 0, s>>>(static_cast<const long long*>(acc),
                                    static_cast<long long*>(out), map, n, counters);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && host)
    e = cudaMemcpyAsync(host, out, 32 * sizeof(long long), cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess && done) e = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  return e;
}

}  // extern "C"
