// Fused CRAM 3.0 subset walk+count (round 5): the native twin of
// io/cramio.py's seek-walk reader — parse containers, decode ONLY the
// flag-bearing series (BF/CF/MF, EXTERNAL encoding, raw/gzip/rANS-4x8
// order-0 blocks), reconstruct BAM FLAGs, and feed the accumulating
// host counting kernel. The FLAG column never materializes whole;
// memory stays O(largest container's needed blocks). Containers are
// independent, so a thread pool strip-mines them with an atomic index
// (same pattern as the framed-stream decode pool, flagstats_io.cpp).
//
// Subset contract and refusal semantics MIRROR the Python reader
// (cramio.py module docstring): unsupported encodings/codecs and
// within-slice mate linking return errors, never guesses; every
// container-header and every READ block is CRC32-gated; skipped
// blocks' CRCs are necessarily unverified. The Python reader is the
// differential oracle (tests/test_cramio.py native-vs-python legs).
//
// Entry point:
//   lfs_cram_flagstat(data, n, flags[32], threads, *n_records_out)
//     -> 0 or a negative error (-2 truncated/corrupt, -3 unsupported
//        subset feature, -4 decompression failure)

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

#include <zlib.h>

#include "bgzf.h"

extern "C" {
int64_t lfs_flagstat_u16(const uint16_t* data, int64_t n, uint64_t* flags,
                         int accumulate);
int64_t lfs_rans4x8_decompress(const uint8_t* src, int64_t n,
                               uint8_t* dst, int64_t cap);
}

namespace {

struct Cur {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    uint8_t u8() {
        if (p < end) return *p++;
        ok = false;
        return 0;
    }
    // itf8 (CRAM §2.3); 5-byte form uses the low nibble of the last byte
    int32_t itf8() {
        uint8_t b0 = u8();
        uint32_t v;
        if (b0 < 0x80) return (int32_t)b0;
        if (b0 < 0xC0) { v = (uint32_t)(b0 & 0x3F) << 8 | u8(); }
        else if (b0 < 0xE0) {
            v = (uint32_t)(b0 & 0x1F) << 16;
            v |= (uint32_t)u8() << 8; v |= u8();
        } else if (b0 < 0xF0) {
            v = (uint32_t)(b0 & 0x0F) << 24;
            v |= (uint32_t)u8() << 16; v |= (uint32_t)u8() << 8; v |= u8();
        } else {
            v = (uint32_t)(b0 & 0x0F) << 28;
            v |= (uint32_t)u8() << 20; v |= (uint32_t)u8() << 12;
            v |= (uint32_t)u8() << 4; v |= (uint32_t)(u8() & 0x0F);
        }
        return (int32_t)v;
    }
    int64_t ltf8() {
        uint8_t b0 = u8();
        int extra = 0;
        for (uint8_t m = 0x80; extra < 8 && (b0 & m); m >>= 1) ++extra;
        uint64_t v = (extra == 8) ? 0 : (uint64_t)(b0 & (0xFF >> extra));
        for (int i = 0; i < extra; ++i) v = (v << 8) | u8();
        return (int64_t)v;
    }
    uint32_t u32le() {
        uint32_t a = u8(), b = u8(), c = u8(), d = u8();
        return a | b << 8 | c << 16 | d << 24;
    }
    bool skip(int64_t n) {
        if (n < 0 || n > end - p) { ok = false; return false; }
        p += n;
        return true;
    }
};

constexpr uint8_t kRaw = 0, kGzip = 1, kRans = 4;
constexpr uint8_t kCtFileHeader = 0, kCtCompHeader = 1, kCtSliceHeader = 2;
constexpr uint8_t kCtExternal = 4;
constexpr int32_t kEncExternal = 1;
constexpr int64_t kCfDetached = 0x2, kCfMateDown = 0x4;

struct ContainerRef {
    const uint8_t* body;
    int64_t body_len;
    int64_t n_records;
    int32_t n_blocks;
};

struct Block {
    uint8_t method, ctype;
    int32_t id;
    const uint8_t* hdr_start;
    const uint8_t* comp;
    int64_t comp_len, raw_len;
    uint32_t crc;
};

// parse one block's header and advance past its payload WITHOUT
// touching the payload bytes — the columnar-IO contract of the Python
// seek-walk: unneeded blocks (seq/qual-class externals, core) never
// fault their pages in. Callers CRC-verify (verify_block) every block
// they actually consume; skipped blocks stay unverified by design.
int parse_block(Cur& c, Block& b) {
    b.hdr_start = c.p;
    b.method = c.u8();
    b.ctype = c.u8();
    b.id = c.itf8();
    b.comp_len = c.itf8();
    b.raw_len = c.itf8();
    if (!c.ok || b.comp_len < 0 || b.raw_len < 0) return -2;
    if (b.comp_len > c.end - c.p) return -2;
    b.comp = c.p;
    c.p += b.comp_len;
    b.crc = c.u32le();
    if (!c.ok) return -2;
    return 0;
}

bool verify_block(const Block& b) {
    return crc32(0, b.hdr_start,
                 (uInt)(b.comp - b.hdr_start) + (uInt)b.comp_len) == b.crc;
}

// gzip-wrapped DEFLATE -> dst (libdeflate fast path via inflate_member)
int inflate_gzip(const uint8_t* src, int64_t n, uint8_t* dst,
                 int64_t raw_len) {
    if (n < 18 || src[0] != 0x1f || src[1] != 0x8b || src[2] != 8)
        return -4;
    uint8_t flg = src[3];
    int64_t off = 10;
    if (flg & 4) {                       // FEXTRA
        if (off + 2 > n) return -4;
        off += 2 + (src[off] | src[off + 1] << 8);
    }
    for (int f = 3; f >= 2; --f) {       // FNAME(8), FCOMMENT(16): NUL-term
        if (flg & (1 << f)) {
            while (off < n && src[off]) ++off;
            ++off;
        }
    }
    if (flg & 2) off += 2;               // FHCRC
    if (off >= n || n - off < 8) return -4;
    int rc = lfs_bgzf::inflate_member(src + off, n - off - 8, dst, raw_len);
    if (rc != 0) return -4;
    if (crc32(0, dst, (uInt)raw_len)
        != (uint32_t)(src[n - 8] | src[n - 7] << 8 | src[n - 6] << 16
                      | (uint32_t)src[n - 5] << 24))
        return -4;
    return 0;
}

int decompress_block(const Block& b, std::vector<uint8_t>& out) {
    try {
        out.resize((size_t)b.raw_len);
    } catch (const std::bad_alloc&) {
        return -4;
    }
    if (b.method == kRaw) {
        if (b.comp_len != b.raw_len) return -2;
        std::memcpy(out.data(), b.comp, (size_t)b.raw_len);
        return 0;
    }
    if (b.method == kGzip)
        return inflate_gzip(b.comp, b.comp_len, out.data(), b.raw_len);
    if (b.method == kRans) {
        int64_t got = lfs_rans4x8_decompress(b.comp, b.comp_len,
                                             out.data(), b.raw_len);
        if (got == -3) return -3;        // order-1: unsupported subset
        return got == b.raw_len ? 0 : -4;
    }
    return -3;                           // bzip2/lzma: unsupported subset
}

// compression-header content -> BF/CF/MF external content ids
int parse_encoding_map(const std::vector<uint8_t>& data, int32_t ids[3]) {
    Cur c{data.data(), data.data() + data.size()};
    int32_t psize = c.itf8();            // preservation map: skip by size
    if (!c.ok || psize < 0 || !c.skip(psize)) return -2;
    int32_t dsize = c.itf8();
    if (!c.ok || dsize < 0 || dsize > c.end - c.p) return -2;
    const uint8_t* dend = c.p + dsize;
    int32_t n = c.itf8();
    if (!c.ok || n < 0) return -2;
    ids[0] = ids[1] = ids[2] = -1;
    for (int32_t i = 0; i < n; ++i) {
        if (c.p + 2 > dend) return -2;
        char k0 = (char)c.u8(), k1 = (char)c.u8();
        int32_t codec = c.itf8();
        int32_t plen = c.itf8();
        if (!c.ok || plen < 0 || c.p + plen > dend) return -2;
        const uint8_t* pend = c.p + plen;
        int which = -1;
        if (k0 == 'B' && k1 == 'F') which = 0;
        else if (k0 == 'C' && k1 == 'F') which = 1;
        else if (k0 == 'M' && k1 == 'F') which = 2;
        if (which >= 0) {
            if (codec != kEncExternal) return -3;   // subset: EXTERNAL only
            Cur pc{c.p, pend};
            ids[which] = pc.itf8();
            if (!pc.ok) return -2;
        }
        c.p = pend;
    }
    return (ids[0] >= 0 && ids[1] >= 0) ? 0 : -2;   // BF+CF required
}

// decode exactly n itf8 values into out; returns 0 / -2
int itf8_stream(const std::vector<uint8_t>& raw, int64_t n,
                std::vector<int32_t>& out) {
    out.resize((size_t)n);
    Cur c{raw.data(), raw.data() + raw.size()};
    for (int64_t i = 0; i < n; ++i) {
        out[(size_t)i] = c.itf8();
        if (!c.ok) return -2;
    }
    return c.p == c.end ? 0 : -2;        // trailing bytes = malformed
}

// one data container -> local counters; returns 0 or negative error
int count_container(const ContainerRef& cref, uint64_t* flags) {
    Cur c{cref.body, cref.body + cref.body_len};
    Block b;
    if (parse_block(c, b) != 0 || !verify_block(b)) return -2;
    if (b.ctype != kCtCompHeader) return -2;
    std::vector<uint8_t> chdr;
    int rc = decompress_block(b, chdr);
    if (rc != 0) return rc;
    int32_t ids[3];
    rc = parse_encoding_map(chdr, ids);
    if (rc != 0) return rc;

    int64_t n_rec_slices = 0;
    std::vector<uint8_t> bf_raw, cf_raw, mf_raw, tmp;
    bool have_bf = false, have_cf = false, have_mf = false;
    for (int32_t i = 1; i < cref.n_blocks; ++i) {
        if (parse_block(c, b) != 0) return -2;
        if (b.ctype == kCtSliceHeader) {
            if (!verify_block(b)) return -2;
            if (decompress_block(b, tmp) != 0) return -2;
            Cur sc{tmp.data(), tmp.data() + tmp.size()};
            sc.itf8(); sc.itf8(); sc.itf8();        // ref id, start, span
            int32_t nr = sc.itf8();
            if (!sc.ok || nr < 0) return -2;
            n_rec_slices += nr;
        } else if (b.ctype == kCtExternal &&
                   (b.id == ids[0] || b.id == ids[1] || b.id == ids[2])) {
            if (!verify_block(b)) return -2;
            std::vector<uint8_t>& dst =
                b.id == ids[0] ? bf_raw : b.id == ids[1] ? cf_raw : mf_raw;
            bool& have =
                b.id == ids[0] ? have_bf : b.id == ids[1] ? have_cf
                                                          : have_mf;
            if (!have) {
                rc = decompress_block(b, dst);
                if (rc != 0) return rc;
                have = true;
            } else {                      // multi-slice: append in order
                std::vector<uint8_t> part;
                rc = decompress_block(b, part);
                if (rc != 0) return rc;
                dst.insert(dst.end(), part.begin(), part.end());
            }
        }
        // other externals / core: parse_block already skipped the bytes
    }
    if (n_rec_slices != cref.n_records) return -2;
    if (!have_bf || !have_cf) return -2;

    std::vector<int32_t> bf, cf, mf;
    if (itf8_stream(bf_raw, cref.n_records, bf) != 0) return -2;
    if (itf8_stream(cf_raw, cref.n_records, cf) != 0) return -2;
    int64_t n_detached = 0;
    for (int64_t i = 0; i < cref.n_records; ++i) {
        if (cf[(size_t)i] & kCfDetached) ++n_detached;
        else if (cf[(size_t)i] & kCfMateDown) return -3;  // subset refusal
    }
    if (n_detached) {
        if (!have_mf) return -2;
        if (itf8_stream(mf_raw, n_detached, mf) != 0) return -2;
    }

    // reconstruct FLAGs chunk-wise and feed the accumulating kernel
    constexpr int64_t kChunk = 1 << 20;
    std::vector<uint16_t> buf((size_t)std::min<int64_t>(kChunk,
                                                        cref.n_records));
    int64_t mi = 0, fill = 0;
    for (int64_t i = 0; i < cref.n_records; ++i) {
        uint32_t v = (uint32_t)bf[(size_t)i];
        if (v > 0xFFFF) return -2;
        if (cf[(size_t)i] & kCfDetached) {
            int32_t m = mf[(size_t)mi++];
            v |= (m & 1) ? 0x20u : 0;    // mate negative strand
            v |= (m & 2) ? 0x8u : 0;     // mate unmapped
        }
        buf[(size_t)fill++] = (uint16_t)v;
        if (fill == (int64_t)buf.size()) {
            lfs_flagstat_u16(buf.data(), fill, flags, 1);
            fill = 0;
        }
    }
    if (fill) lfs_flagstat_u16(buf.data(), fill, flags, 1);
    return 0;
}

}  // namespace

extern "C" {

// Count data containers [lo, hi) — hi < 0 means "to the end". The
// multihost shard primitive (parallel/multihost.flagstat_multihost_cram):
// containers are independent, so per-range counters sum exactly.
int64_t lfs_cram_flagstat_range(const uint8_t* data, int64_t n_bytes,
                                int64_t lo, int64_t hi,
                                uint64_t* flags, int32_t threads,
                                int64_t* n_records_out) {
    if (n_bytes < 26 || std::memcmp(data, "CRAM", 4) != 0) return -2;
    if (data[4] != 3 || data[5] != 0) return -3;   // 3.0 only
    Cur c{data + 26, data + n_bytes};

    // pass 1: enumerate data containers (header-only walk, CRC-gated)
    std::vector<ContainerRef> refs;
    bool first = true;
    int64_t total_records = 0;
    while (c.p < c.end) {
        const uint8_t* hstart = c.p;
        if (c.end - c.p < 4) return -2;
        int32_t length;
        std::memcpy(&length, c.p, 4);
        c.p += 4;
        if (length < 0) return -2;
        c.itf8(); c.itf8(); c.itf8();              // ref id, start, span
        int32_t n_records = c.itf8();
        c.ltf8(); c.ltf8();                        // counter, bases
        int32_t n_blocks = c.itf8();
        int32_t n_land = c.itf8();
        if (!c.ok || n_records < 0 || n_blocks < 0 || n_land < 0 ||
            n_land > c.end - c.p)
            return -2;
        for (int32_t i = 0; i < n_land; ++i) c.itf8();
        uint32_t crc = c.u32le();
        if (!c.ok) return -2;
        if (crc32(0, hstart, (uInt)(c.p - 4 - hstart)) != crc) return -2;
        if (length > c.end - c.p) return -2;
        const uint8_t* body = c.p;
        c.p += length;
        if (first) {
            first = false;
            Cur bc{body, body + length};
            Block b;
            if (parse_block(bc, b) != 0 || !verify_block(b)) return -2;
            if (b.ctype == kCtFileHeader) continue;
            return -2;                   // first container must be the header
        }
        if (n_records == 0) continue;    // EOF container or empty
        refs.push_back({body, length, n_records, n_blocks});
    }
    if (lo < 0 || (hi >= 0 && hi < lo)) return -2;
    if (hi < 0 || hi > (int64_t)refs.size()) hi = (int64_t)refs.size();
    if (lo > (int64_t)refs.size()) lo = (int64_t)refs.size();
    refs.erase(refs.begin() + (std::ptrdiff_t)hi, refs.end());
    refs.erase(refs.begin(), refs.begin() + (std::ptrdiff_t)lo);
    for (const ContainerRef& r : refs) total_records += r.n_records;

    // pass 2: count containers on a thread pool (independent units)
    int nt = threads > 0 ? threads
                         : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if ((size_t)nt > refs.size()) nt = (int)refs.size();
    if (nt < 1) nt = 1;
    std::atomic<size_t> next{0};
    std::atomic<int> err{0};
    std::vector<std::vector<uint64_t>> locals(
        (size_t)nt, std::vector<uint64_t>(32, 0));
    auto worker = [&](int t) {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= refs.size() || err.load(std::memory_order_relaxed))
                return;
            int rc = count_container(refs[i],
                                     locals[(size_t)t].data());
            if (rc != 0) err.store(rc);
        }
    };
    if (nt <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        pool.reserve((size_t)nt);
        for (int t = 0; t < nt; ++t) pool.emplace_back(worker, t);
        for (auto& th : pool) th.join();
    }
    if (int e = err.load()) return e;
    for (int t = 0; t < nt; ++t)
        for (int k = 0; k < 32; ++k) flags[k] += locals[(size_t)t][k];
    if (n_records_out) *n_records_out = total_records;
    return 0;
}

int64_t lfs_cram_flagstat(const uint8_t* data, int64_t n_bytes,
                          uint64_t* flags, int32_t threads,
                          int64_t* n_records_out) {
    return lfs_cram_flagstat_range(data, n_bytes, 0, -1, flags, threads,
                                   n_records_out);
}

}  // extern "C"
