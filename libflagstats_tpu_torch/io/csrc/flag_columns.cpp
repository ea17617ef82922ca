// FLAG-column readers over one range of a BAM or a BGZF SAM: the column
// twins of the readers' fused range walkers, for the card route of the
// multihost legs (parallel/multihost.py) and io/bamio.py /
// io/samio.py's range readers.
//
// The readers' range machinery is internal to their translation units
// (static functions, an anonymous namespace), and their files are kept
// byte-identical to the JAX package's. So this file includes both
// copies into one translation unit of its own and builds into a shared
// object of its own (io/native_lib.py load_columns()): it redefines the
// copies' extern "C" symbols, so it cannot be linked with the readers'
// object.
//
// Both functions write uint16 FLAG words to out[0..cap) in record order
// and return the count, or a negative error; the concatenation of the
// columns over ranges that tile a file is the file's FLAG column.
//
// Bounds for cap (lfs_bam_flags_range_bound, lfs_bgzf_sam_range_bound):
// a BAM record is at least kMinRecord (37) bytes, so a range of B
// inflated bytes starts at most B / 37 + 1 records; a flag-yielding SAM
// line is at least 2 bytes ("0\n"), so members of R raw bytes start at
// most R / 2 + 1 counted lines (a line that spills past the range end
// is the range's; one that starts before it is not).

#include "bam_reader.cpp"
#include "sam_reader.cpp"

namespace {

// Column twin of bam_parallel_range (bam_reader.cpp): the same resync,
// shards, seam check, outer chain endpoints and return codes; each
// shard's parser grows a vector of its own through on_full in place of
// draining into lfs_flagstat_u16, and the shards are stitched in order.
int64_t bam_column_range(const uint8_t* data, int64_t n_bytes,
                         int64_t byte_lo, int64_t byte_hi, uint16_t* out,
                         int64_t cap, int64_t* start_out, int64_t* end_out,
                         int32_t threads) {
    std::vector<Member> members;
    int src = scan_members(data, n_bytes, members);
    if (src != 0) return src;
    std::vector<int64_t> pref(members.size() + 1, 0);
    for (size_t i = 0; i < members.size(); i++)
        pref[i + 1] = pref[i] + members[i].raw_len;
    const int64_t total_bytes = pref.back();
    if (threads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        threads = hw ? (int32_t)hw : 1;
    }

    Cursor head(data, members, pref);
    int64_t g0 = parse_header_end(head, total_bytes);
    if (g0 < 0) return g0;
    const bool whole_file = byte_lo < 0 && byte_hi < 0;
    if (byte_hi < 0 || byte_hi > total_bytes) byte_hi = total_bytes;
    const bool from_start = byte_lo < 0 || byte_lo <= g0;
    if (from_start) byte_lo = g0;
    if (byte_lo > byte_hi) {
        if (from_start && byte_hi <= g0) {   // a range inside the header
            if (start_out) *start_out = g0;
            if (end_out) *end_out = g0;
            return 0;
        }
        return -8;
    }
    const int64_t span = byte_hi - byte_lo;

    struct Shard {
        int64_t start = -1, end = -1;
        int rc = 0;
        std::vector<uint16_t> flags;
    };

    auto attempt = [&](int64_t shards, std::vector<Shard>& res) -> bool {
        res.assign((size_t)shards, Shard());
        std::vector<int64_t> bounds((size_t)shards + 1);
        for (int64_t s = 0; s <= shards; s++)
            bounds[(size_t)s] = byte_lo + span * s / shards;

        std::atomic<int64_t> next_shard(0);
        auto worker = [&]() {
            Cursor c(data, members, pref);
            for (;;) {
                int64_t s = next_shard.fetch_add(1);
                if (s >= shards) return;
                Shard& r = res[(size_t)s];
                if (s == 0 && from_start) {
                    r.start = g0;
                } else {
                    int64_t hi = std::min<int64_t>(
                        bounds[(size_t)s] + (4 << 20),
                        bounds[(size_t)s + 1]);
                    r.start = resync(c, bounds[(size_t)s], hi, total_bytes);
                    if (r.start < 0 || c.bad) {
                        r.rc = -9;   // resync failed
                        continue;
                    }
                }
                r.flags.resize(1 << 16);
                Parser parser;
                parser.out = r.flags.data();
                parser.cap = (int64_t)r.flags.size();
                parser.on_full = [&]() {   // full: double the shard's column
                    r.flags.resize(r.flags.size() * 2);
                    parser.out = r.flags.data();
                    parser.cap = (int64_t)r.flags.size();
                    return 0;
                };
                r.rc = walk_range(c, r.start, bounds[(size_t)s + 1],
                                  total_bytes, parser, &r.end);
                r.flags.resize(r.rc == 0 ? (size_t)parser.count : 0);
            }
        };
        int nw = (int)std::min<int64_t>(threads, shards);
        std::vector<std::thread> pool;
        pool.reserve((size_t)nw);
        for (int t = 0; t < nw; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();

        for (int64_t s = 0; s < shards; s++) {   // every seam must match
            if (res[(size_t)s].rc != 0) return false;
            if (s + 1 < shards &&
                res[(size_t)s].end != res[(size_t)s + 1].start)
                return false;
        }
        return true;
    };

    // the authoritative sequential column walk for the whole-file
    // fallbacks (bam_parallel_range's lfs_bam_flagstat)
    auto sequential = [&]() -> int64_t {
        int64_t n = lfs_bam_flags(data, n_bytes, out, cap, threads);
        if (n < 0) return n;
        if (start_out) *start_out = g0;
        if (end_out) *end_out = total_bytes;
        return n;
    };

    if (threads < 2 && whole_file)
        return lfs_bam_flags(data, n_bytes, out, cap, threads);
    int64_t shards = std::min<int64_t>((int64_t)threads * 3,
                                       span / (16 << 20) + 1);
    std::vector<Shard> res;
    bool ok = shards >= 2 && attempt(shards, res);
    if (!ok && !whole_file) ok = attempt(1, res);
    if (!ok) return whole_file ? sequential() : -9;
    if (whole_file && res.back().end != total_bytes) return sequential();

    int64_t count = 0;
    for (const Shard& r : res) count += (int64_t)r.flags.size();
    if (count > cap) return -5;
    int64_t at = 0;
    for (const Shard& r : res) {
        if (!r.flags.empty())
            std::memcpy(out + at, r.flags.data(),
                        r.flags.size() * sizeof(uint16_t));
        at += (int64_t)r.flags.size();
    }
    if (start_out) *start_out = res.front().start;
    if (end_out) *end_out = res.back().end;
    return count;
}

// Inflated bytes of members [m_start, m_stop) (m_stop < 0: to the end),
// or a negative error (-6 not BGZF, -8 invalid range).
int64_t member_range_bytes(const uint8_t* data, int64_t n_bytes,
                           int64_t m_start, int64_t m_stop) {
    std::vector<Member> members;
    int rc = scan_members(data, n_bytes, members);
    if (rc == -3) return -6;
    if (rc != 0) return rc;
    if (m_stop < 0) m_stop = (int64_t)members.size();
    if (m_start < 0 || m_start > m_stop || m_stop > (int64_t)members.size())
        return -8;
    int64_t raw = 0;
    for (int64_t m = m_start; m < m_stop; m++) raw += members[(size_t)m].raw_len;
    return raw;
}

}  // namespace

extern "C" {

// FLAG column of BAM inflated-byte range [byte_lo, byte_hi): the column
// twin of lfs_bam_flagstat_byte_range (byte_lo < 0: the header end;
// byte_hi < 0: the end; both < 0: the whole file with its sequential
// fallback). Reports the outer chain endpoints as that function does.
// Returns the record count, -9 when the range cannot be entered (the
// caller falls back), -5 when cap is too small, or a hard error.
int64_t lfs_bam_flags_byte_range(const uint8_t* data, int64_t n_bytes,
                                 int64_t byte_lo, int64_t byte_hi,
                                 uint16_t* out, int64_t cap,
                                 int64_t* start_out, int64_t* end_out,
                                 int32_t threads) {
    return bam_column_range(data, n_bytes, byte_lo, byte_hi, out, cap,
                            start_out, end_out, threads);
}

// A cap for lfs_bam_flags_byte_range over [byte_lo, byte_hi) (clamped
// as there), or a negative error of the member scan.
int64_t lfs_bam_flags_range_bound(const uint8_t* data, int64_t n_bytes,
                                  int64_t byte_lo, int64_t byte_hi) {
    std::vector<Member> members;
    int rc = scan_members(data, n_bytes, members);
    if (rc != 0) return rc;
    int64_t total = 0;
    for (const Member& m : members) total += m.raw_len;
    if (byte_hi < 0 || byte_hi > total) byte_hi = total;
    if (byte_lo < 0) byte_lo = 0;
    return byte_hi > byte_lo ? (byte_hi - byte_lo) / kMinRecord + 1 : 1;
}

// FLAG column of the lines owned by BGZF SAM members [m_start, m_stop)
// (m_stop < 0: to the end): bgzf_sam_walk in column mode, the column
// twin of lfs_bgzf_sam_flagstat_range, with the same line ownership at
// the range edges and the same errors (-5 when cap is too small, -6 not
// BGZF, -8 invalid range).
int64_t lfs_bgzf_sam_flags_range(const uint8_t* data, int64_t n_bytes,
                                 int64_t m_start, int64_t m_stop,
                                 uint16_t* out, int64_t cap,
                                 int32_t threads) {
    return bgzf_sam_walk(data, n_bytes, out, cap, nullptr, threads, 0,
                         m_start, m_stop);
}

// A cap for lfs_bgzf_sam_flags_range over [m_start, m_stop), or its
// negative error.
int64_t lfs_bgzf_sam_range_bound(const uint8_t* data, int64_t n_bytes,
                                 int64_t m_start, int64_t m_stop) {
    int64_t raw = member_range_bytes(data, n_bytes, m_start, m_stop);
    return raw < 0 ? raw : raw / 2 + 1;
}

}  // extern "C"
