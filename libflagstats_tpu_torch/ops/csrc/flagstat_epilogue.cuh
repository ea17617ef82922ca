// The epilogue's map and launcher (flagstat_epilogue.cu), shared with
// the one-call count of flagstat_kernels.cu, which enqueues the epilogue
// after K1.
#pragma once

#include <stdint.h>

// One mode's map from the accumulator to (C[k], F[k]); -1 reads 0.
struct EpilogueMap {
  int8_t c[16];
  int8_t c2[16];
  int8_t f[16];
  int8_t qc;  // the QC-fail bit (flags.FQCFAIL_OFF)
};

extern "C" int lfs_epilogue(int device, const void* acc, void* out, EpilogueMap map,
                            long long n, int counters, void* host, void* done, void* stream);
