// BGZF container helpers shared by the BAM walker (bam_reader.cpp) and
// the BGZF-SAM fast path (sam_reader.cpp): member-chain scan off the
// mmapped file (no inflate needed — each gzip member carries its total
// size in the 'BC' extra subfield and its raw size in the ISIZE
// footer) and single-member raw-DEFLATE inflate.
//
// SAM/BAM spec v1.6 layout facts are documented in io/bamio.py.
// Internal linkage (static): each TU carries its own copy; no ABI.
#ifndef LFS_BGZF_H_
#define LFS_BGZF_H_

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

// libdeflate, when present, decodes whole-buffer DEFLATE 2.5x faster
// than zlib on this host (measured on realistic-payload BGZF members:
// 885 vs 352 MB/s/core — BGZF members are <= 64 KiB whole-buffer
// payloads with the exact raw size known from ISIZE, libdeflate's
// ideal case). The build adds -ldeflate when the header exists; zlib
// remains the portable fallback.
#if defined(__has_include) && !defined(LFS_NO_LIBDEFLATE)
#if __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define LFS_HAVE_LIBDEFLATE 1
#endif
#endif

namespace lfs_bgzf {

struct Member {
    int64_t comp_off;   // offset of the DEFLATE payload in the file
    int64_t comp_len;
    int64_t raw_len;    // ISIZE (uncompressed payload size)
};

// Scan the BGZF member chain. Returns 0, or a negative error
// (-2 truncated, -3 not BGZF / malformed).
inline int scan_members(const uint8_t* d, int64_t n,
                        std::vector<Member>& out) {
    int64_t off = 0;
    while (off < n) {
        if (n - off < 18) return -2;                   // truncated header
        if (d[off] != 0x1F || d[off + 1] != 0x8B || d[off + 2] != 8 ||
            !(d[off + 3] & 4))
            return -3;                                 // not BGZF
        uint16_t xlen;
        std::memcpy(&xlen, d + off + 10, 2);
        if (n - off < 12 + xlen + 8) return -2;
        // find the BC subfield inside the extra area
        int64_t x = off + 12, xend = x + xlen;
        int64_t bsize = -1;
        while (x + 4 <= xend) {
            uint16_t slen;
            std::memcpy(&slen, d + x + 2, 2);
            if (d[x] == 'B' && d[x + 1] == 'C' && slen == 2) {
                uint16_t bs;
                std::memcpy(&bs, d + x + 4, 2);
                bsize = (int64_t)bs + 1;
                break;
            }
            x += 4 + slen;
        }
        if (bsize < 12 + xlen + 8) return -3;          // no/invalid BC
        if (off + bsize > n) return -2;                // truncated member
        uint32_t isize;
        std::memcpy(&isize, d + off + bsize - 4, 4);
        if (isize > 65536u) return -3;                 // spec cap
        Member m;
        m.comp_off = off + 12 + xlen;
        m.comp_len = bsize - 12 - xlen - 8;
        m.raw_len = isize;
        out.push_back(m);
        off += bsize;
    }
    return 0;
}

// Inflate one member's raw-DEFLATE payload. Returns 0 or -4.
inline int inflate_member(const uint8_t* src, int64_t comp_len,
                          uint8_t* dst, int64_t raw_len) {
#ifdef LFS_HAVE_LIBDEFLATE
    // one decompressor per thread, reused across members and FREED at
    // thread exit via RAII — the walkers spawn fresh pool threads per
    // call, so a bare thread_local pointer leaks one ~11 KB
    // decompressor per walker thread (ASan-caught: 144 MB across the
    // fuzz corpus)
    struct LdHolder {
        libdeflate_decompressor* d = libdeflate_alloc_decompressor();
        ~LdHolder() {
            if (d) libdeflate_free_decompressor(d);
        }
    };
    static thread_local LdHolder ld;
    if (ld.d != nullptr) {
        size_t actual = 0;
        libdeflate_result rc = libdeflate_deflate_decompress(
            ld.d, src, (size_t)comp_len, dst, (size_t)raw_len, &actual);
        if (rc != LIBDEFLATE_SUCCESS || (int64_t)actual != raw_len)
            return -4;
        return 0;
    }
    // allocation failure: fall through to zlib
#endif
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return -4;
    zs.next_in = const_cast<Bytef*>(src);
    zs.avail_in = (uInt)comp_len;
    zs.next_out = dst;
    zs.avail_out = (uInt)raw_len;
    int rc = inflate(&zs, Z_FINISH);
    int64_t got = (int64_t)zs.total_out;
    inflateEnd(&zs);
    if (rc != Z_STREAM_END || got != raw_len) return -4;
    return 0;
}

// Ring-pipeline member walk shared by the BAM and BGZF-SAM walkers
// (round 4): a PERSISTENT inflate pool fills an in-order ring of
// member buffers that the calling thread consumes — no per-window
// thread spawn/join and no lockstep barrier between inflate and the
// (inherently sequential) walk. The previous double-buffered window
// scheme spawned ~one pool per 3 MB and barriered the two sides
// against each other; measured on the realistic-payload NA12878/4 BAM
// it left ~30% of 4 cores idle (32.2 s vs ~22 s of component cost —
// ring: 27-31 s). Memory stays O(ring) = O(threads) * 64 KiB.
//
// ``consume(p, len)`` is called once per member IN MEMBER ORDER on the
// calling thread; it returns 0 to continue or a negative error to
// abort. Returns 0, the first inflate error, or the first consume
// error.
template <class Consume>
inline int ring_walk(const uint8_t* data, const std::vector<Member>& members,
                     int64_t m_start, int64_t m_stop, int32_t threads,
                     Consume&& consume) {
    const int64_t n_range = m_stop - m_start;
    if (n_range <= 0) return 0;
    if (threads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        threads = hw ? (int32_t)hw : 1;
    }
    // ring depth: enough run-ahead to ride out walk/inflate rate
    // wobble without unbounded memory
    const size_t ring = (size_t)std::min<int64_t>(
        std::max<int64_t>((int64_t)threads * 16, 64), n_range);
    std::vector<std::vector<uint8_t>> bufs(ring);
    // slot states: 0 = empty, 1 = ready, negative = inflate error
    std::vector<std::atomic<int>> state(ring);
    for (auto& s : state) s.store(0, std::memory_order_relaxed);
    std::atomic<int64_t> next(0);     // next range index a worker claims
    std::atomic<int64_t> walked(0);   // range indices fully consumed
    std::atomic<bool> stop(false);

    auto inflater = [&]() {
        for (;;) {
            if (stop.load(std::memory_order_acquire)) return;
            int64_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= n_range) return;
            // backpressure: slot i%ring is free once index i-ring is
            // walked (the walk clears state before advancing walked,
            // so walked >= i-ring+1 implies this slot is empty)
            int spins = 0;
            while (i - walked.load(std::memory_order_acquire) >=
                   (int64_t)ring) {
                if (stop.load(std::memory_order_relaxed)) return;
                if (++spins < 64) {
                    std::this_thread::yield();
                } else {
                    std::this_thread::sleep_for(
                        std::chrono::microseconds(100));
                }
            }
            // abort-path slot-collision guard: the shutdown bump below
            // releases EVERY slot's backpressure at once, so a worker
            // woken by it must not write a slot another in-flight
            // worker may own — stop is stored BEFORE the bump, and the
            // acquire read of `walked` above makes it visible here
            if (stop.load(std::memory_order_relaxed)) return;
            const Member& m = members[(size_t)(m_start + i)];
            const size_t slot = (size_t)(i % ring);
            int rc = 0;
            if (m.raw_len > 0) {
                bufs[slot].resize((size_t)m.raw_len);
                rc = inflate_member(data + m.comp_off, m.comp_len,
                                    bufs[slot].data(), m.raw_len);
            } else {
                bufs[slot].clear();
            }
            state[slot].store(rc != 0 ? rc : 1, std::memory_order_release);
        }
    };

    int nt = (int)std::min<int64_t>(threads, n_range);
    std::vector<std::thread> pool;
    pool.reserve((size_t)nt);
    for (int t = 0; t < nt; t++) pool.emplace_back(inflater);

    int err = 0;
    for (int64_t i = 0; i < n_range; i++) {
        const size_t slot = (size_t)(i % ring);
        int s, spins = 0;
        while ((s = state[slot].load(std::memory_order_acquire)) == 0) {
            if (++spins < 64) {
                std::this_thread::yield();
            } else {
                std::this_thread::sleep_for(std::chrono::microseconds(100));
            }
        }
        if (s < 0) {
            err = s;
            break;
        }
        err = consume(bufs[slot].data(), (int64_t)bufs[slot].size());
        state[slot].store(0, std::memory_order_release);
        walked.store(i + 1, std::memory_order_release);
        if (err) break;
    }
    // ordering matters: stop FIRST, then the walked bump that releases
    // all backpressure — workers re-check stop after their acquire
    // read of walked, so no two can claim the same ring slot
    stop.store(true, std::memory_order_release);
    walked.store(n_range + (int64_t)ring, std::memory_order_release);
    for (auto& th : pool) th.join();
    return err;
}

}  // namespace lfs_bgzf

#endif  // LFS_BGZF_H_
