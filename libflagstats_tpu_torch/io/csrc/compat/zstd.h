/* Declarations of the four libzstd calls the native host library makes
 * (libflagstats_tpu/io/native/flagstats_io.cpp, lfs_zstd_*), for hosts
 * that carry the runtime library libzstd.so.1 but not its development
 * header. io/native_lib.py puts this directory on the include path, and
 * links -l:libzstd.so.1, only when a probe compile of the system
 * <zstd.h> fails. The signatures are libzstd's stable public API
 * (ZSTD_VERSION_MAJOR 1). */
#ifndef LFS_COMPAT_ZSTD_H
#define LFS_COMPAT_ZSTD_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif /* LFS_COMPAT_ZSTD_H */
