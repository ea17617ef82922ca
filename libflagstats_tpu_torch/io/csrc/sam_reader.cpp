// SAM-text FLAG-column parser (native fast path of io/samio.py).
//
// Completes the ingest matrix: the reference's documented workflow is
// `samtools view <bam> | cut -f2 | utility` (reference README.md:56) —
// i.e. it consumes SAM text only after two external tools reduce it to
// a bare FLAG column. Here `flagstat file.sam[.gz]` parses the FLAG
// field (column 2) straight out of SAM lines, so the framework covers
// .sam/.sam.gz alongside .bam (bam_reader.cpp) and raw/framed columns.
//
// Parse contract (strict on what it counts, lenient on what it skips):
//   * lines starting with '@' are headers (SAM QNAME cannot start with
//     '@': spec regex [!-?A-~] excludes 0x40), skipped;
//   * empty lines are skipped;
//   * otherwise column 2 must be 1+ ASCII digits valued <= 65535,
//     delimited by tabs (or line end) -> one FLAG word;
//   * a line with NO tab must itself be a bare FLAG integer — this is
//     the `samtools view | cut -f2` single-column shape the reference's
//     `utility` consumes (reference README.md:56), so one text parser
//     covers both SAM and extracted-column input;
//   * '\r\n' line endings tolerated; a final line without '\n' too.
// Any other shape is a hard error (-3): a count must never be built
// from a misparsed stream.
//
// Parallelism: byte ranges aligned to line starts parse independently
// into thread-local vectors (order preserved by range order), then one
// ordered concatenation into the caller's buffer. Record discovery in
// text is just memchr, so unlike BAM (variable-length binary records,
// bam_reader.cpp phase C) the walk itself parallelizes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "bgzf.h"

extern "C" int64_t lfs_flagstat_u16(const uint16_t* data, int64_t n,
                                    uint64_t* flags, int n_threads);

namespace {

// Parse [p, end) (starting at a line boundary) into out.
// Returns 0 or -3 (malformed).
int parse_range(const uint8_t* p, const uint8_t* end,
                std::vector<uint16_t>& out) {
    while (p < end) {
        const uint8_t* nl =
            (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
        const uint8_t* le = nl ? nl : end;
        if (le > p && le[-1] == '\r') --le;           // \r\n
        if (le == p || *p == '@') {                   // empty / header
            p = nl ? nl + 1 : end;
            continue;
        }
        const uint8_t* t =
            (const uint8_t*)memchr(p, '\t', (size_t)(le - p));
        t = t ? t + 1 : p;        // tabless line: bare FLAG integer
        uint32_t v = 0;
        const uint8_t* s = t;
        while (t < le && *t >= '0' && *t <= '9') {
            v = v * 10 + (uint32_t)(*t - '0');
            if (v > 65535u) return -3;                // FLAG is uint16
            ++t;
        }
        if (t == s) return -3;                        // empty/non-numeric
        if (t < le && *t != '\t') return -3;          // junk after digits
        out.push_back((uint16_t)v);
        p = nl ? nl + 1 : end;
    }
    return 0;
}

}  // namespace

extern "C" {

// Upper bound on the number of records (for output allocation): the
// number of lines. One memchr-speed pass; headers only over-reserve.
int64_t lfs_sam_bound(const uint8_t* data, int64_t n_bytes) {
    int64_t lines = 0, off = 0;
    while (off < n_bytes) {
        const uint8_t* nl = (const uint8_t*)memchr(
            data + off, '\n', (size_t)(n_bytes - off));
        if (!nl) { ++lines; break; }                  // final unterminated
        ++lines;
        off = (nl - data) + 1;
    }
    return lines;
}

// Extract the FLAG column from SAM text. Returns the number of flags
// written, or a negative error (-3 malformed, -5 capacity exceeded).
int64_t lfs_sam_flags(const uint8_t* data, int64_t n_bytes, uint16_t* out,
                      int64_t cap, int32_t threads) {
    if (n_bytes == 0) return 0;
    if (threads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        threads = hw ? (int32_t)hw : 1;
    }
    // >=4 MiB of text per range; tiny inputs parse on one thread
    int64_t nt = std::min<int64_t>(threads,
                                   std::max<int64_t>(1, n_bytes >> 22));
    std::vector<int64_t> start((size_t)nt + 1);
    start[0] = 0;
    start[(size_t)nt] = n_bytes;
    for (int64_t r = 1; r < nt; ++r) {
        int64_t pos = r * (n_bytes / nt);
        if (pos < start[(size_t)r - 1]) pos = start[(size_t)r - 1];
        const uint8_t* nl = (const uint8_t*)memchr(
            data + pos, '\n', (size_t)(n_bytes - pos));
        start[(size_t)r] = nl ? (nl - data) + 1 : n_bytes;
    }

    std::vector<std::vector<uint16_t>> parts((size_t)nt);
    std::vector<int> rcs((size_t)nt, 0);
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        for (;;) {
            int64_t r = next.fetch_add(1);
            if (r >= nt) return;
            rcs[(size_t)r] = parse_range(data + start[(size_t)r],
                                         data + start[(size_t)r + 1],
                                         parts[(size_t)r]);
        }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < nt; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();

    int64_t count = 0;
    for (int64_t r = 0; r < nt; ++r) {
        if (rcs[(size_t)r] != 0) return rcs[(size_t)r];
        const auto& v = parts[(size_t)r];
        if (count + (int64_t)v.size() > cap) return -5;
        if (!v.empty())
            std::memcpy(out + count, v.data(), v.size() * sizeof(uint16_t));
        count += (int64_t)v.size();
    }
    return count;
}

// Fused plain-text SAM flagstat: byte ranges (line-aligned) parse in
// parallel, each thread draining its parse buffer into THREAD-LOCAL
// counters every ~4Mi flags (the per-flush derived pass-total sums
// exactly, and counter vectors merge by plain summation), so the FLAG
// column never materializes — the .sam twin of lfs_bam_flagstat.
// Returns the record count, or a negative error (-3 malformed,
// -7 counting kernel failure).
int64_t lfs_sam_flagstat(const uint8_t* data, int64_t n_bytes,
                         uint64_t* counters, int32_t threads,
                         int64_t chunk_flags) {
    if (n_bytes == 0) return 0;
    if (threads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        threads = hw ? (int32_t)hw : 1;
    }
    const size_t kFlush = (size_t)(chunk_flags > 0 ? chunk_flags
                                                   : int64_t(1) << 22);
    int64_t nt = std::min<int64_t>(threads,
                                   std::max<int64_t>(1, n_bytes >> 22));
    std::vector<int64_t> start((size_t)nt + 1);
    start[0] = 0;
    start[(size_t)nt] = n_bytes;
    for (int64_t r = 1; r < nt; ++r) {
        int64_t pos = r * (n_bytes / nt);
        if (pos < start[(size_t)r - 1]) pos = start[(size_t)r - 1];
        const uint8_t* nl = (const uint8_t*)memchr(
            data + pos, '\n', (size_t)(n_bytes - pos));
        start[(size_t)r] = nl ? (nl - data) + 1 : n_bytes;
    }

    std::vector<std::vector<uint64_t>> local((size_t)nt,
                                             std::vector<uint64_t>(32, 0));
    std::vector<int64_t> counts((size_t)nt, 0);
    std::vector<int> rcs((size_t)nt, 0);
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        std::vector<uint16_t> buf;
        for (;;) {
            int64_t r = next.fetch_add(1);
            if (r >= nt) return;
            const uint8_t* p = data + start[(size_t)r];
            const uint8_t* end = data + start[(size_t)r + 1];
            buf.clear();
            // parse line by line in sub-slices so buf stays bounded:
            // cut the range at the first '\n' past each kFlush worth
            while (p < end && rcs[(size_t)r] == 0) {
                // a parse slice of ~kFlush lines minimum kFlush bytes
                const uint8_t* slice_end = p + (int64_t)kFlush < end
                    ? p + (int64_t)kFlush : end;
                if (slice_end < end) {
                    const uint8_t* nl = (const uint8_t*)memchr(
                        slice_end, '\n', (size_t)(end - slice_end));
                    slice_end = nl ? nl + 1 : end;
                }
                rcs[(size_t)r] = parse_range(p, slice_end, buf);
                if (rcs[(size_t)r]) break;
                if (!buf.empty()) {
                    if (lfs_flagstat_u16(buf.data(), (int64_t)buf.size(),
                                         local[(size_t)r].data(), 1)) {
                        rcs[(size_t)r] = -7;
                        break;
                    }
                    counts[(size_t)r] += (int64_t)buf.size();
                    buf.clear();
                }
                p = slice_end;
            }
        }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < nt; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();

    int64_t total = 0;
    for (int64_t r = 0; r < nt; ++r) {
        if (rcs[(size_t)r] != 0) return rcs[(size_t)r];
        for (int k = 0; k < 32; ++k) counters[k] += local[(size_t)r][k];
        total += counts[(size_t)r];
    }
    return total;
}

// BGZF-compressed SAM (`bgzip file.sam` — the standard pipeline shape):
// members inflate in PARALLEL (double-buffered windows, exactly the
// BAM walker's scheme, bam_reader.cpp) while the main thread parses the
// previous window's text with partial lines carried across member
// boundaries. The whole decompressed stream never materializes.
// Two modes: column mode (counters == nullptr) writes flags to
// out[0..cap); fused mode drains the parse buffer into the
// accumulating host counting kernel every ~4Mi flags, so neither the
// text nor the column ever materializes (O(window + chunk) memory).
// Member-range sharding (m_start/m_stop; m_stop < 0 = end): a shard
// owns every line whose first byte lies in its members' decompressed
// byte range. Locally decidable: if the last decompressed byte BEFORE
// the range is '\n', the range begins at a line start (no skip);
// otherwise the head partial line belongs to the previous shard (skip
// through the first '\n'). A line spilling past the range end is
// finished by reading into the following members (each shard inflates
// at most one extra member at the head and the spill at the tail), so
// P shards over one .sam.gz count every line exactly once — the
// text-split discipline of distributed line readers, applied to BGZF
// members. Returns the flag count, or a negative error (-2 truncated,
// -3 malformed SAM, -4 inflate failure, -5 capacity exceeded,
// -6 not BGZF — callers fall back to a generic gzip stream path,
// -7 counting kernel failure, -8 invalid member range).
static int64_t bgzf_sam_walk(const uint8_t* data, int64_t n_bytes,
                             uint16_t* out, int64_t cap,
                             uint64_t* counters, int32_t threads,
                             int64_t chunk_flags,
                             int64_t m_start, int64_t m_stop) {
    std::vector<lfs_bgzf::Member> members;
    int src = lfs_bgzf::scan_members(data, n_bytes, members);
    if (src == -3) return -6;       // plain gzip / not BGZF: caller falls back
    if (src != 0) return src;
    if (m_stop < 0) m_stop = (int64_t)members.size();
    if (m_start < 0 || m_start > m_stop ||
        m_stop > (int64_t)members.size())
        return -8;
    const int64_t n_members = (int64_t)members.size();

    // head line-boundary probe: does the shard start mid-line?
    bool skipping = false;
    if (m_start > 0) {
        int64_t j = m_start - 1;
        while (j >= 0 && members[(size_t)j].raw_len == 0) --j;
        if (j >= 0) {
            std::vector<uint8_t> tmp((size_t)members[(size_t)j].raw_len);
            if (lfs_bgzf::inflate_member(
                    data + members[(size_t)j].comp_off,
                    members[(size_t)j].comp_len, tmp.data(),
                    (int64_t)tmp.size()) != 0)
                return -4;
            skipping = tmp.back() != '\n';
        }
    }

    std::vector<uint16_t> acc;      // parsed flags, in stream order
    std::vector<uint8_t> carry;     // partial trailing line
    int perr = 0;
    int64_t total = 0;              // fused mode: flags already counted
    // column mode: cap is enforced INCREMENTALLY (not post-hoc) — a
    // tiny cap must bound both the work and acc's memory, like
    // lfs_sam_flags and the BAM walker's per-record check. Fused mode
    // drains acc into the counting kernel instead.
    const size_t kFlush = (size_t)(chunk_flags > 0 ? chunk_flags
                                                    : int64_t(1) << 22);
    auto check_cap = [&]() {
        if (perr) return;
        if (counters) {
            if (acc.size() < kFlush) return;
            if (lfs_flagstat_u16(acc.data(), (int64_t)acc.size(),
                                 counters, 1)) { perr = -7; return; }
            total += (int64_t)acc.size();
            acc.clear();
        } else if ((int64_t)acc.size() > cap) {
            perr = -5;
        }
    };
    auto parse_buf = [&](const uint8_t* p, int64_t len) {
        if (perr || len == 0) return;
        if (skipping) {
            // head bytes through the first '\n' belong to the previous
            // shard (it reads into our members to finish its line)
            const uint8_t* nl =
                (const uint8_t*)memchr(p, '\n', (size_t)len);
            if (!nl) return;
            len -= (nl + 1) - p;
            p = nl + 1;
            skipping = false;
            if (len == 0) return;
        }
        const uint8_t* end = p + len;
        if (!carry.empty()) {
            const uint8_t* nl =
                (const uint8_t*)memchr(p, '\n', (size_t)len);
            if (!nl) {                       // still no line end: keep carrying
                carry.insert(carry.end(), p, end);
                return;
            }
            carry.insert(carry.end(), p, nl + 1);
            perr = parse_range(carry.data(), carry.data() + carry.size(),
                               acc);
            carry.clear();
            check_cap();
            if (perr) return;
            p = nl + 1;
        }
        // parse the whole-line body directly; hold the unterminated tail
        const uint8_t* last = end;
        while (last > p && last[-1] != '\n') --last;
        perr = parse_range(p, last, acc);
        if (!perr && last < end) carry.assign(last, end);
        check_cap();
    };
    // stream the range through the shared ring pipeline (bgzf.h):
    // persistent inflate pool, in-order parse on this thread
    int werr = lfs_bgzf::ring_walk(
        data, members, m_start, m_stop, threads,
        [&](const uint8_t* p, int64_t len) {
            parse_buf(p, len);
            return perr;
        });
    if (werr && werr != perr) return werr;   // inflate-side failure
    // tail spill: a line crossing the range end is ours (its first byte
    // is in-range) — read following members until its '\n'
    for (int64_t j = m_stop;
         j < n_members && !perr && !carry.empty(); ++j) {
        const lfs_bgzf::Member& m = members[(size_t)j];
        if (m.raw_len == 0) continue;
        std::vector<uint8_t> tmp((size_t)m.raw_len);
        if (lfs_bgzf::inflate_member(data + m.comp_off, m.comp_len,
                                     tmp.data(), (int64_t)tmp.size()) != 0)
            return -4;
        const uint8_t* nl = (const uint8_t*)memchr(tmp.data(), '\n',
                                                   tmp.size());
        int64_t take = nl ? (nl - tmp.data() + 1) : (int64_t)tmp.size();
        parse_buf(tmp.data(), take);
        if (nl) break;
    }
    if (!perr && !carry.empty()) {           // final unterminated line
        perr = parse_range(carry.data(), carry.data() + carry.size(), acc);
        check_cap();
    }
    if (perr) return perr;
    if (counters) {                          // fused mode: final drain
        if (!acc.empty()) {
            if (lfs_flagstat_u16(acc.data(), (int64_t)acc.size(),
                                 counters, 1))
                return -7;
            total += (int64_t)acc.size();
        }
        return total;
    }
    if (!acc.empty())
        std::memcpy(out, acc.data(), acc.size() * sizeof(uint16_t));
    return (int64_t)acc.size();
}

int64_t lfs_bgzf_sam_flags(const uint8_t* data, int64_t n_bytes,
                           uint16_t* out, int64_t cap, int32_t threads) {
    return bgzf_sam_walk(data, n_bytes, out, cap, nullptr, threads, 0,
                         0, -1);
}

// Fused BGZF-SAM flagstat: parallel inflate -> line parse -> counting
// kernel, O(window + chunk) memory at any file size (the .sam.gz twin
// of lfs_bam_flagstat). Returns the record count or a negative error.
int64_t lfs_bgzf_sam_flagstat(const uint8_t* data, int64_t n_bytes,
                              uint64_t* counters, int32_t threads,
                              int64_t chunk_flags) {
    return bgzf_sam_walk(data, n_bytes, nullptr, 0, counters, threads,
                         chunk_flags, 0, -1);
}

// Number of BGZF members (the shard unit for member-range counting).
// Negative error; -6 if not BGZF.
int64_t lfs_bgzf_members(const uint8_t* data, int64_t n_bytes) {
    std::vector<lfs_bgzf::Member> members;
    int rc = lfs_bgzf::scan_members(data, n_bytes, members);
    if (rc == -3) return -6;
    if (rc != 0) return rc;
    return (int64_t)members.size();
}

// Fused flagstat over one member range [m_start, m_stop) of a BGZF SAM
// — the multi-process shard unit: each process counts its range, only
// 32 uint64 counters cross processes, and line ownership at range
// boundaries is exact (see bgzf_sam_walk). Returns the shard's record
// count or a negative error.
int64_t lfs_bgzf_sam_flagstat_range(const uint8_t* data, int64_t n_bytes,
                                    int64_t m_start, int64_t m_stop,
                                    uint64_t* counters, int32_t threads,
                                    int64_t chunk_flags) {
    return bgzf_sam_walk(data, n_bytes, nullptr, 0, counters, threads,
                         chunk_flags, m_start, m_stop);
}

// Total decompressed size of a BGZF chain (output-allocation bound for
// lfs_bgzf_sam_flags callers: <= one flag per text line, and a line is
// >= 4 bytes — "q\t0\n"). Negative error; -6 if not BGZF.
int64_t lfs_bgzf_raw_size(const uint8_t* data, int64_t n_bytes) {
    std::vector<lfs_bgzf::Member> members;
    int rc = lfs_bgzf::scan_members(data, n_bytes, members);
    if (rc == -3) return -6;
    if (rc != 0) return rc;
    int64_t raw = 0;
    for (const auto& m : members) raw += m.raw_len;
    return raw;
}

}  // extern "C"
