// FLAG column of a range of CRAM data containers: the column twin of
// the fused range walker lfs_cram_flagstat_range (cram_reader.cpp), for
// the card route of io/cramio.py (read_cram_flags, flagstat_cram_range
// and, through them, flagstat_file and the CRAM leg of multihost).
//
// The walker's block parsing, CRC gating and decoding are internal to
// its translation unit (an anonymous namespace), and its file is kept
// byte-identical to the JAX package's. So this file includes the copy
// into a translation unit of its own, beside flag_columns.cpp in the
// column readers' shared object (io/native_lib.py load_columns()): each
// copy's anonymous namespace stays in its own unit.
//
// Two passes, as in the walker. Pass 1 is the walker's header-only walk
// (the same CRC gating, return codes and acceptance of a file cut at a
// container boundary). Pass 2 decodes the containers on a thread pool;
// container i writes its FLAG words straight to out + offset[i], the
// prefix sum of the pass-1 record counts, so the column is written once,
// in place, with nothing to stitch.
//
// Entry points:
//   lfs_cram_range_records(data, n, lo, hi, *n_containers_out)
//     -> the record count of data containers [lo, hi) (hi < 0: to the
//        end), from their headers alone, or a negative error
//   lfs_cram_flags_range(data, n, lo, hi, out, cap, threads, *n_out)
//     -> 0, writing the column to out[0..*n_out), or a negative error:
//        -2 truncated/corrupt, -3 unsupported subset feature, -4
//        decompression failure, -5 cap below the record count

#include "cram_reader.cpp"

namespace {

// Pass 1 of lfs_cram_flagstat_range: the data containers [lo, hi) of
// the file, from a header-only walk. Returns 0 or a negative error.
int data_containers(const uint8_t* data, int64_t n_bytes, int64_t lo,
                    int64_t hi, std::vector<ContainerRef>& refs) {
    if (n_bytes < 26 || std::memcmp(data, "CRAM", 4) != 0) return -2;
    if (data[4] != 3 || data[5] != 0) return -3;   // 3.0 only
    Cur c{data + 26, data + n_bytes};
    bool first = true;
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
    return 0;
}

// Column twin of count_container: the same block walk, CRC gating, BF
// range check, CF 0x4 refusal and MF rebuild of 0x20 / 0x8 for detached
// records, with each FLAG word written to out[i] in place of the
// accumulating count. Returns 0 or a negative error.
int column_container(const ContainerRef& cref, uint16_t* out) {
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

    int64_t mi = 0;
    for (int64_t i = 0; i < cref.n_records; ++i) {
        uint32_t v = (uint32_t)bf[(size_t)i];
        if (v > 0xFFFF) return -2;
        if (cf[(size_t)i] & kCfDetached) {
            int32_t m = mf[(size_t)mi++];
            v |= (m & 1) ? 0x20u : 0;    // mate negative strand
            v |= (m & 2) ? 0x8u : 0;     // mate unmapped
        }
        out[i] = (uint16_t)v;
    }
    return 0;
}

}  // namespace

extern "C" {

// Records in data containers [lo, hi) (hi < 0: to the end), the exact
// length of their column, from pass 1 alone; the container count goes
// to *n_containers_out. Returns the record count or a negative error
// (those of lfs_cram_flagstat_range's pass 1).
int64_t lfs_cram_range_records(const uint8_t* data, int64_t n_bytes,
                               int64_t lo, int64_t hi,
                               int64_t* n_containers_out) {
    std::vector<ContainerRef> refs;
    int rc = data_containers(data, n_bytes, lo, hi, refs);
    if (rc != 0) return rc;
    int64_t total = 0;
    for (const ContainerRef& r : refs) total += r.n_records;
    if (n_containers_out) *n_containers_out = (int64_t)refs.size();
    return total;
}

// FLAG column of data containers [lo, hi) (hi < 0: to the end) into
// out[0..cap), containers decoded on `threads` threads (<= 0: one per
// hardware thread). Returns 0 with the record count in *n_out, or a
// negative error: the fused range walker's, or -5 when cap is below the
// record count. On an error out holds no column.
int64_t lfs_cram_flags_range(const uint8_t* data, int64_t n_bytes,
                             int64_t lo, int64_t hi, uint16_t* out,
                             int64_t cap, int32_t threads, int64_t* n_out) {
    std::vector<ContainerRef> refs;
    int rc = data_containers(data, n_bytes, lo, hi, refs);
    if (rc != 0) return rc;
    std::vector<int64_t> offset(refs.size() + 1, 0);
    for (size_t i = 0; i < refs.size(); ++i)
        offset[i + 1] = offset[i] + refs[i].n_records;
    if (offset.back() > cap) return -5;

    int nt = threads > 0 ? threads
                         : (int)std::thread::hardware_concurrency();
    if ((size_t)nt > refs.size()) nt = (int)refs.size();
    if (nt < 1) nt = 1;
    std::atomic<size_t> next{0};
    std::atomic<int> err{0};
    auto worker = [&]() {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= refs.size() || err.load(std::memory_order_relaxed))
                return;
            int e = column_container(refs[i], out + offset[i]);
            if (e != 0) err.store(e);
        }
    };
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve((size_t)nt);
        for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    if (int e = err.load()) return e;
    if (n_out) *n_out = offset.back();
    return 0;
}

}  // extern "C"
