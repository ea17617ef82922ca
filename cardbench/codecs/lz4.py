"""The codec ``lz4``: the system ``liblz4.so.1`` through ctypes,
``LZ4_compress_fast`` with the frames spec's ``level`` as its
acceleration.

A codec module gives ``Codec(level)`` with ``compress(addr, n)``, the
payload of ``n`` raw bytes at address ``addr``, and ``decompress(payload,
raw_len)``."""
from __future__ import annotations

import ctypes


class Codec:
    def __init__(self, level: int):
        self.level = level
        lib = ctypes.CDLL("liblz4.so.1")
        lib.LZ4_compress_fast.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.LZ4_compress_fast.restype = ctypes.c_int
        lib.LZ4_decompress_safe.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int, ctypes.c_int]
        lib.LZ4_decompress_safe.restype = ctypes.c_int
        self.lib = lib

    def compress(self, addr: int, n: int) -> bytes:
        cap = n + n // 255 + 16            # LZ4_compressBound
        buf = ctypes.create_string_buffer(cap)
        m = self.lib.LZ4_compress_fast(addr, buf, n, cap, self.level)
        if m <= 0:
            raise RuntimeError("LZ4_compress_fast failed")
        return buf.raw[:m]

    def decompress(self, payload: bytes, raw_len: int) -> bytes:
        out = ctypes.create_string_buffer(raw_len)
        if self.lib.LZ4_decompress_safe(payload, out, len(payload), raw_len) != raw_len:
            raise ValueError("frame does not decode to its raw length")
        return out.raw

