// BAM/BGZF FLAG-column walker (native fast path of io/bamio.py).
//
// Beyond-reference capability: the reference consumes a pre-extracted
// FLAG column and leans on samtools for the BAM itself (reference
// README.md:56); this walker reads the BAM container directly so the
// framework's `flagstat file.bam` is self-sufficient. Design:
//
//   phase A  scan BGZF member headers off the mmapped file (no inflate:
//            each gzip member carries its total size in the 'BC' extra
//            subfield and its uncompressed size in the ISIZE footer) —
//            this yields an independent work list;
//   phase B  inflate members in PARALLEL (raw DEFLATE, bounded window
//            of in-flight buffers) — BGZF blocks are independent, which
//            is the same block-parallelism samtools itself uses;
//   phase C  a sequential incremental parser walks the decompressed
//            byte stream in member order (records are variable-length,
//            so record discovery is inherently sequential — but it is
//            ~2 loads + a bounds check per record, GB/s-class) and
//            extracts the uint16 FLAG at offset 14 of each record body.
//
// SAM/BAM spec v1.6 layout facts are documented in io/bamio.py.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include "bgzf.h"

extern "C" int64_t lfs_flagstat_u16(const uint16_t* data, int64_t n,
                                    uint64_t* flags, int n_threads);

namespace {

using lfs_bgzf::Member;
using lfs_bgzf::inflate_member;
using lfs_bgzf::scan_members;

constexpr int64_t kMinRecord = 37;  // block_size(4) + fixed(32) + name(>=1)

// Incremental BAM parser over an in-order sequence of byte chunks.
struct Parser {
    enum State {
        MAGIC,      // need 8: "BAM\1" + l_text
        SKIP_TEXT,
        NREF,       // need 4
        LNAME,      // need 4 (per ref)
        SKIP_NAME,  // l_name + 4 (l_ref)
        REC_SIZE,   // need 4
        REC_HEAD,   // need 16 of the record body (flag at 14..15)
        SKIP_REC,   // rest of the record
        FAILED,
    };
    State state = MAGIC;
    uint8_t pend[16];
    int pend_len = 0;
    int64_t skip = 0;
    int64_t nref_left = 0;
    int64_t rec_body = 0;
    uint16_t* out;
    int64_t cap;
    int64_t count = 0;
    int err = 0;
    // Fused-counting hook: when out fills, consume out[0..count) and
    // reset count (return 0) — lets a bounded chunk buffer stand in for
    // the whole column (lfs_bam_flagstat). Absent -> cap is hard (-5).
    std::function<int()> on_full;

    void fail(int e) { state = FAILED; err = e; }

    // true iff a slot is free after (possibly) draining via on_full
    bool make_room() {
        if (count < cap) return true;
        if (!on_full) { fail(-5); return false; }
        int rc = on_full();
        if (rc) { fail(rc); return false; }
        if (count >= cap) { fail(-5); return false; }
        return true;
    }

    // gather `need` bytes into pend across chunk boundaries; returns
    // true when pend holds `need` bytes (and resets pend_len)
    bool gather(const uint8_t*& p, const uint8_t* end, int need) {
        int take = (int)((end - p) < (need - pend_len) ? (end - p)
                                                       : (need - pend_len));
        std::memcpy(pend + pend_len, p, take);
        pend_len += take;
        p += take;
        if (pend_len < need) return false;
        pend_len = 0;
        return true;
    }

    void feed(const uint8_t* p, int64_t len) {
        const uint8_t* end = p + len;
        while (p < end && state != FAILED) {
            switch (state) {
            case MAGIC: {
                if (!gather(p, end, 8)) return;
                if (std::memcmp(pend, "BAM\x01", 4) != 0) return fail(-3);
                int32_t l_text;
                std::memcpy(&l_text, pend + 4, 4);
                if (l_text < 0) return fail(-3);
                skip = l_text;
                state = SKIP_TEXT;
                break;
            }
            case SKIP_TEXT: {
                int64_t take = end - p < skip ? end - p : skip;
                p += take;
                skip -= take;
                if (skip == 0) state = NREF;
                break;
            }
            case NREF: {
                if (!gather(p, end, 4)) return;
                int32_t n_ref;
                std::memcpy(&n_ref, pend, 4);
                if (n_ref < 0) return fail(-3);
                nref_left = n_ref;
                state = nref_left ? LNAME : REC_SIZE;
                break;
            }
            case LNAME: {
                if (!gather(p, end, 4)) return;
                int32_t l_name;
                std::memcpy(&l_name, pend, 4);
                if (l_name < 0) return fail(-3);
                skip = (int64_t)l_name + 4;
                state = SKIP_NAME;
                break;
            }
            case SKIP_NAME: {
                int64_t take = end - p < skip ? end - p : skip;
                p += take;
                skip -= take;
                if (skip == 0) state = --nref_left ? LNAME : REC_SIZE;
                break;
            }
            case REC_SIZE: {
                // fast path: whole records inside this chunk walk in a
                // tight loop (~2 loads + a jump per record) — the state
                // machine below only handles chunk-boundary crossings
                if (pend_len == 0) {
                    while (end - p >= 20) {
                        int32_t bs;
                        std::memcpy(&bs, p, 4);
                        if (bs < 33) return fail(-3);
                        if (end - p < 4 + (int64_t)bs) break;
                        if (!make_room()) return;
                        uint16_t flag;
                        std::memcpy(&flag, p + 4 + 14, 2);
                        out[count++] = flag;
                        p += 4 + (int64_t)bs;
                    }
                    if (p >= end) return;
                }
                if (!gather(p, end, 4)) return;
                int32_t bs;
                std::memcpy(&bs, pend, 4);
                if (bs < 33) return fail(-3);  // fixed 32 + name >= 1
                rec_body = bs;
                state = REC_HEAD;
                break;
            }
            case REC_HEAD: {
                if (!gather(p, end, 16)) return;
                if (!make_room()) return;
                uint16_t flag;
                std::memcpy(&flag, pend + 14, 2);
                out[count++] = flag;
                skip = rec_body - 16;
                state = SKIP_REC;
                break;
            }
            case SKIP_REC: {
                int64_t take = end - p < skip ? end - p : skip;
                p += take;
                skip -= take;
                if (skip == 0) state = REC_SIZE;
                break;
            }
            case FAILED:
                return;
            }
        }
    }

    // true iff the stream may legally end here (no partial anything)
    bool clean_end() const {
        return state == REC_SIZE && pend_len == 0 && err == 0;
    }
};

// ---------------------------------------------------------------------------
// Range-parallel BAM walking (round 4). BAM records are self-delimited
// (block_size chain) with no resync marker, so unlike BGZF-SAM there is
// no authoritative way to enter the record stream mid-file. The walk —
// not the inflate — is the serial bottleneck post-libdeflate, so this
// implements the classic indexed-BAM trick WITHOUT an index, exactly:
//
//   1. split the inflated byte span into S shard ranges;
//   2. each shard RESYNCS at its range start: the first offset whose
//      K=4-record chain passes strict structural validation
//      (block_size bounds, l_read_name NUL placement, mandatory-field
//      fit — a heuristic);
//   3. each shard walks from its sync point to the FIRST record
//      boundary >= its range end (finishing the crossing record by
//      exact-size feeds into the following bytes) and reports where it
//      actually landed;
//   4. the orchestrator verifies ARRIVAL-EXACTNESS: shard i's landing
//      offset must equal shard i+1's sync point, and the last shard
//      must land exactly at EOF. A false resync cannot survive this
//      check (shard i's walk follows the true chain, so a sync point
//      not on the true chain is never landed on exactly); any mismatch
//      or failed resync falls back to the sequential walk. Counting is
//      therefore integer-exact UNCONDITIONALLY — the heuristic only
//      gates the parallel fast path, never the result.
// ---------------------------------------------------------------------------

// Forward byte reader over the member chain with a small inflate cache
// (resync validation reads a few dozen bytes at arbitrary offsets).
struct Cursor {
    const uint8_t* data;
    const std::vector<Member>& members;
    const std::vector<int64_t>& pref;   // pref[i] = inflated offset of
    //                                     member i's start; pref[n] = total
    static constexpr int kCache = 8;
    int64_t idx[kCache];
    std::vector<uint8_t> cbuf[kCache];
    int evict = 0;
    bool bad = false;                   // sticky inflate failure

    Cursor(const uint8_t* d, const std::vector<Member>& m,
           const std::vector<int64_t>& p)
        : data(d), members(m), pref(p) {
        for (int k = 0; k < kCache; k++) idx[k] = -1;
    }

    const std::vector<uint8_t>* member_buf(int64_t m) {
        for (int k = 0; k < kCache; k++)
            if (idx[k] == m) return &cbuf[k];
        int slot = evict++ % kCache;
        const Member& mm = members[(size_t)m];
        cbuf[slot].resize((size_t)mm.raw_len);
        if (mm.raw_len > 0 &&
            inflate_member(data + mm.comp_off, mm.comp_len,
                           cbuf[slot].data(), mm.raw_len) != 0) {
            bad = true;
            idx[slot] = -1;
            return nullptr;
        }
        idx[slot] = m;
        return &cbuf[slot];
    }

    // member index containing inflated offset off (skipping empties)
    int64_t member_at(int64_t off) const {
        return (int64_t)(std::upper_bound(pref.begin(), pref.end() - 1,
                                          off) - pref.begin()) - 1;
    }

    bool read(int64_t off, uint8_t* dst, int64_t len) {
        if (off < 0 || len < 0 || off + len > pref.back()) return false;
        int64_t m = member_at(off);
        while (len > 0) {
            while (members[(size_t)m].raw_len == 0) ++m;
            const std::vector<uint8_t>* b = member_buf(m);
            if (b == nullptr) return false;
            int64_t local = off - pref[(size_t)m];
            int64_t take = std::min<int64_t>((int64_t)b->size() - local, len);
            std::memcpy(dst, b->data() + local, (size_t)take);
            dst += take;
            off += take;
            len -= take;
            ++m;
        }
        return true;
    }
};

constexpr int64_t kMaxBlockSize = (int64_t)1 << 26;   // 64 MiB: generous
//   even for ultra-long reads; bounds the resync validator

// strict structural validation of a K-record chain at inflated offset o
bool validate_chain(Cursor& c, int64_t o, int64_t total, int k = 4) {
    for (int i = 0; i < k; i++) {
        if (o == total) return i > 0;   // clean EOF inside the chain
        uint8_t h[32];
        if (!c.read(o, h, 4)) return false;
        int32_t bs;
        std::memcpy(&bs, h, 4);
        if (bs < 33 || (int64_t)bs > kMaxBlockSize) return false;
        if (o + 4 + (int64_t)bs > total) return false;
        if (!c.read(o + 4, h, 32)) return false;
        uint8_t l_name = h[8];
        uint16_t n_cigar;
        std::memcpy(&n_cigar, h + 12, 2);
        int32_t l_seq;
        std::memcpy(&l_seq, h + 16, 4);
        if (l_name < 1 || l_seq < 0) return false;
        int64_t need = 32 + (int64_t)l_name + 4 * (int64_t)n_cigar +
                       ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq;
        if (need > (int64_t)bs) return false;
        uint8_t nul;
        if (!c.read(o + 4 + 32 + (int64_t)l_name - 1, &nul, 1) || nul != 0)
            return false;
        o += 4 + (int64_t)bs;
    }
    return true;
}

// first offset in [lo, hi) whose chain validates; -1 if none. Aborts
// on the cursor's sticky inflate-failure flag — without this, one
// uninflatable member inside the window would re-run its failing
// inflate for every scanned candidate offset (review finding r4).
//
// Work bound (ADVICE r04 #4): the scan is bounded by BYTES (the 4 MiB
// window) but each candidate surviving the cheap block-size test costs
// several cursor reads in validate_chain. On degenerate/adversarial
// inflated content the cheap test rarely rejects (~1.6% of random
// 4-byte ints land in [33, 64Mi]), so a 4 MiB window can deep-validate
// ~65k candidates and the parallel path can run slower than sequential
// without ever failing. Cap the deep validations; tripping the cap
// returns -1, which the callers already treat as "resync failed" and
// fall back to attempt(1)/the sequential walker (arrival-exactness is
// unaffected — this only bounds wasted work on non-BAM-shaped bytes).
// Budget sizing: genuine content deep-validates ~1.6% of the bytes
// scanned before the true record start (<= one record length), so 65536
// covers records up to the full 4 MiB scan window with margin, while
// crafted everywhere-plausible content drops from ~4M deep validations
// to 65k (~64x less wasted work before the sequential fallback).
int64_t resync(Cursor& c, int64_t lo, int64_t hi, int64_t total) {
    int64_t deep_budget = 65536;
    for (int64_t o = lo; o < hi; o++) {
        uint8_t h[4];
        if (o + 4 > total || !c.read(o, h, 4)) {
            if (c.bad) return -1;
            continue;
        }
        int32_t bs;
        std::memcpy(&bs, h, 4);
        if (bs < 33 || (int64_t)bs > kMaxBlockSize ||
            o + 4 + (int64_t)bs > total)
            continue;                      // cheap reject: one cached read
        if (--deep_budget < 0) return -1;  // work bound tripped
        if (validate_chain(c, o, total)) return o;
        if (c.bad) return -1;
    }
    return -1;
}

// walk records from inflated offset `start` to the first record
// boundary >= `limit` (exact-size spill feeds finish the crossing
// record); parser must arrive in REC_SIZE state. Returns 0 or a
// negative error; *end_out = the boundary actually reached.
int walk_range(Cursor& c, int64_t start, int64_t limit, int64_t total,
               Parser& parser, int64_t* end_out) {
    parser.state = Parser::REC_SIZE;
    int64_t o = start;
    if (limit > total) limit = total;
    // bulk: feed whole member slices clipped to limit
    while (o < limit && !parser.err) {
        int64_t m = c.member_at(o);
        while (c.members[(size_t)m].raw_len == 0) ++m;
        const std::vector<uint8_t>* b = c.member_buf(m);
        if (b == nullptr) return -4;
        int64_t local = o - c.pref[(size_t)m];
        int64_t take = std::min<int64_t>((int64_t)b->size() - local,
                                         limit - o);
        parser.feed(b->data() + local, take);
        o += take;
    }
    if (parser.err) return parser.err;
    // spill: finish the crossing record with exact-size feeds so the
    // fast path can never run past the boundary into the next record
    uint8_t tmp[4096];
    while (!(parser.state == Parser::REC_SIZE && parser.pend_len == 0)) {
        int64_t need;
        if (parser.state == Parser::SKIP_REC) {
            need = parser.skip;
        } else if (parser.state == Parser::REC_HEAD) {
            need = 16 - parser.pend_len;
        } else if (parser.state == Parser::REC_SIZE) {
            need = 4 - parser.pend_len;
        } else {
            return -3;
        }
        while (need > 0) {
            int64_t take = std::min<int64_t>(need, (int64_t)sizeof(tmp));
            if (o + take > total) return -2;   // truncated mid-record
            if (!c.read(o, tmp, take)) return -4;
            parser.feed(tmp, take);
            if (parser.err) return parser.err;
            o += take;
            need -= take;
        }
    }
    *end_out = o;
    return 0;
}

// header end: inflated offset of the first alignment record
int64_t parse_header_end(Cursor& c, int64_t total) {
    uint8_t h[8];
    if (!c.read(0, h, 8)) return -2;
    if (std::memcmp(h, "BAM\x01", 4) != 0) return -3;
    int32_t l_text;
    std::memcpy(&l_text, h + 4, 4);
    if (l_text < 0) return -3;
    int64_t o = 8 + (int64_t)l_text;
    if (!c.read(o, h, 4)) return -2;
    int32_t n_ref;
    std::memcpy(&n_ref, h, 4);
    if (n_ref < 0) return -3;
    o += 4;
    for (int32_t i = 0; i < n_ref; i++) {
        if (!c.read(o, h, 4)) return -2;
        int32_t l_name;
        std::memcpy(&l_name, h, 4);
        if (l_name < 0) return -3;
        o += 4 + (int64_t)l_name + 4;
    }
    if (o > total) return -2;
    return o;
}

// Shared walk driver: scan the member chain, then stream the members
// through lfs_bgzf::ring_walk (persistent inflate pool + in-order
// consume; see bgzf.h for the round-4 rationale and measurements).
// Returns 0 or a negative error (inflate failures, the parser's own
// error, truncated EOF).
int walk_bam(const uint8_t* data, int64_t n_bytes, Parser& parser,
             int32_t threads) {
    std::vector<Member> members;
    int rc = scan_members(data, n_bytes, members);
    if (rc != 0) return rc;
    int err = lfs_bgzf::ring_walk(
        data, members, 0, (int64_t)members.size(), threads,
        [&](const uint8_t* p, int64_t len) {
            if (len > 0) parser.feed(p, len);
            return parser.err;
        });
    if (err) return err;
    if (parser.err) return parser.err;
    if (!parser.clean_end()) return -2;  // mid-record EOF: truncated
    return 0;
}

}  // namespace

extern "C" {

// Upper bound on the number of records (for output allocation): scans
// only the BGZF headers. Returns the bound, or a negative error.
int64_t lfs_bam_bound(const uint8_t* data, int64_t n_bytes) {
    std::vector<Member> members;
    int rc = scan_members(data, n_bytes, members);
    if (rc != 0) return rc;
    int64_t raw = 0;
    for (const Member& m : members) raw += m.raw_len;
    return raw / kMinRecord + 1;
}

// Extract the FLAG column. Returns the number of flags written, or a
// negative error (-2 truncated, -3 malformed, -4 inflate failure,
// -5 output capacity exceeded).
int64_t lfs_bam_flags(const uint8_t* data, int64_t n_bytes, uint16_t* out,
                      int64_t cap, int32_t threads) {
    Parser parser;
    parser.out = out;
    parser.cap = cap;
    int rc = walk_bam(data, n_bytes, parser, threads);
    if (rc != 0) return rc;
    return parser.count;
}

// Fused walk+count: the FLAG column never materializes — records drain
// through a bounded chunk buffer into the accumulating host counting
// kernel (flagstats_host.cpp lfs_flagstat_u16; the derived pass-total
// is += n_chunk - fail_chunk per flush, exact under summation by the
// block-accumulate contract, reference: flagstats.cpp:311-332). Memory
// stays O(inflate window + chunk) at any BAM size. Returns the record
// count, or a negative error (-7: counting kernel failure).
int64_t lfs_bam_flagstat(const uint8_t* data, int64_t n_bytes,
                         uint64_t* counters, int32_t threads,
                         int64_t chunk_flags) {
    if (chunk_flags <= 0) chunk_flags = 1 << 22;   // 4Mi flags = 8 MB
    std::vector<uint16_t> chunk((size_t)chunk_flags);
    Parser parser;
    parser.out = chunk.data();
    parser.cap = (int64_t)chunk.size();
    int64_t total = 0;
    parser.on_full = [&]() {
        if (lfs_flagstat_u16(parser.out, parser.count, counters, 1))
            return -7;
        total += parser.count;
        parser.count = 0;
        return 0;
    };
    int rc = walk_bam(data, n_bytes, parser, threads);
    if (rc != 0) return rc;
    if (parser.count) {
        if (lfs_flagstat_u16(parser.out, parser.count, counters, 1))
            return -7;
        total += parser.count;
    }
    return total;
}

// Shared shard engine for the range-parallel walk: count records in
// inflated-byte range [byte_lo, byte_hi) of the record stream, split
// into internal shards, chain-verified internally. byte_lo < 0 means
// "the authoritative record start" (header end — no resync heuristic
// at the outer start); byte_hi < 0 means EOF. Reports the OUTER chain
// endpoints in *start_out/*end_out so a caller stitching multiple
// ranges (the multi-host BAM leg) can verify arrival-exactness across
// ranges exactly like the internal check. Returns the record count,
// -9 when resync failed / internal verification failed irrecoverably,
// or a hard error. Internal mismatches retry the whole range as ONE
// shard (whose endpoints the caller still verifies); only the
// full-file case (byte_lo < 0 && byte_hi < 0) may fall back to the
// authoritative sequential walker.
static int64_t bam_parallel_range(const uint8_t* data, int64_t n_bytes,
                                  int64_t byte_lo, int64_t byte_hi,
                                  uint64_t* counters, int64_t* start_out,
                                  int64_t* end_out, int32_t threads,
                                  int64_t chunk_flags) {
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
        if (from_start && byte_hi <= g0) {
            // the whole range sits inside the header: an EMPTY shard
            // whose chain endpoints are both the authoritative record
            // start — the NEXT shard (byte_lo <= g0 too) also clamps
            // to g0, so the cross-shard verification still stitches.
            // Returning -8 here crashed multihost runs on small files
            // / many ranks (review finding r1).
            if (start_out) *start_out = g0;
            if (end_out) *end_out = g0;
            return 0;
        }
        return -8;
    }

    const int64_t span = byte_hi - byte_lo;
    if (chunk_flags <= 0) chunk_flags = 1 << 20;   // 1Mi flags per shard

    struct ShardResult {
        int64_t start = -1, end = -1, count = 0;
        int rc = 0;
        uint64_t counters[32] = {0};
    };

    // one attempt at a given shard count; shards == 1 is the
    // no-internal-seam retry
    auto attempt = [&](int64_t shards, ShardResult* out_res) -> bool {
        std::vector<ShardResult> res((size_t)shards);
        std::vector<int64_t> bounds((size_t)shards + 1);
        for (int64_t s = 0; s <= shards; s++)
            bounds[(size_t)s] = byte_lo + span * s / shards;

        std::atomic<int64_t> next_shard(0);
        auto worker = [&]() {
            Cursor c(data, members, pref);
            std::vector<uint16_t> chunk((size_t)chunk_flags);
            for (;;) {
                int64_t s = next_shard.fetch_add(1);
                if (s >= shards) return;
                ShardResult& r = res[(size_t)s];
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
                Parser parser;
                parser.out = chunk.data();
                parser.cap = (int64_t)chunk.size();
                parser.on_full = [&]() {
                    if (lfs_flagstat_u16(parser.out, parser.count,
                                         r.counters, 1))
                        return -7;
                    r.count += parser.count;
                    parser.count = 0;
                    return 0;
                };
                r.rc = walk_range(c, r.start, bounds[(size_t)s + 1],
                                  total_bytes, parser, &r.end);
                if (r.rc == 0 && parser.count) {
                    if (lfs_flagstat_u16(parser.out, parser.count,
                                         r.counters, 1))
                        r.rc = -7;
                    else
                        r.count += parser.count;
                }
            }
        };
        int nw = (int)std::min<int64_t>(threads, shards);
        std::vector<std::thread> pool;
        pool.reserve((size_t)nw);
        for (int t = 0; t < nw; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();

        // internal arrival-exactness: every seam must match
        bool ok = true;
        for (int64_t s = 0; s < shards && ok; s++) {
            if (res[(size_t)s].rc != 0) ok = false;
            if (s + 1 < shards &&
                res[(size_t)s].end != res[(size_t)s + 1].start)
                ok = false;
        }
        if (!ok) return false;
        // stitch into one result
        ShardResult& agg = *out_res;
        agg = ShardResult();
        agg.start = res[0].start;
        agg.end = res[(size_t)shards - 1].end;
        agg.rc = 0;
        for (int64_t s = 0; s < shards; s++) {
            agg.count += res[(size_t)s].count;
            for (int i = 0; i < 32; i++)
                agg.counters[i] += res[(size_t)s].counters[i];
        }
        return true;
    };

    // shards: ~3 per worker for load balance, each >= 16 MiB so the
    // resync scan window (4 MiB) stays well inside a shard. A single
    // worker gains nothing from sharding (its Cursor inflates inline),
    // so the whole-file threads<2 case delegates to the ring-pipeline
    // sequential walker, which still overlaps inflate with the walk.
    if (threads < 2 && whole_file)
        return lfs_bam_flagstat(data, n_bytes, counters, threads,
                                chunk_flags);
    int64_t shards = std::min<int64_t>((int64_t)threads * 3,
                                       span / (16 << 20) + 1);
    ShardResult agg;
    bool ok = shards >= 2 && attempt(shards, &agg);
    if (!ok && !whole_file)
        ok = attempt(1, &agg);   // seamless single-shard retry for a
        //                          mid-file range (no authoritative
        //                          fallback exists there)
    if (!ok) {
        if (whole_file) {
            // authoritative fallback: the ring-pipeline sequential
            // walker (parallel inflate) — NOT attempt(1), whose
            // single Cursor inflates serially on the walking thread
            // (review finding r5)
            int64_t n = lfs_bam_flagstat(data, n_bytes, counters, threads,
                                         chunk_flags);
            if (n < 0) return n;
            if (start_out) *start_out = g0;
            if (end_out) *end_out = total_bytes;
            return n;
        }
        return -9;
    }
    if (whole_file && agg.end != total_bytes) {
        // the chain must end exactly at EOF for the full-file contract
        int64_t n = lfs_bam_flagstat(data, n_bytes, counters, threads,
                                     chunk_flags);
        if (n < 0) return n;
        if (start_out) *start_out = g0;
        if (end_out) *end_out = total_bytes;
        return n;
    }
    for (int i = 0; i < 32; i++) counters[i] += agg.counters[i];
    if (start_out) *start_out = agg.start;
    if (end_out) *end_out = agg.end;
    return agg.count;
}

// Range-parallel fused BAM flagstat (round 4; see the resync /
// arrival-exactness block comment above): S shards resync + walk + are
// chain-verified; on ANY resync failure or arrival mismatch the result
// is recomputed by the sequential walker, so counters are
// integer-exact unconditionally. Same contract as lfs_bam_flagstat.
int64_t lfs_bam_flagstat_parallel(const uint8_t* data, int64_t n_bytes,
                                  uint64_t* counters, int32_t threads,
                                  int64_t chunk_flags) {
    return bam_parallel_range(data, n_bytes, -1, -1, counters, nullptr,
                              nullptr, threads, chunk_flags);
}

// One inflated-byte range of a BAM for multi-host sharding: resyncs at
// byte_lo (authoritative header end when byte_lo <= header end), walks
// to the first record boundary >= byte_hi, reports the chain endpoints
// for the caller's cross-shard verification. Returns the record count,
// -9 when the range could not be entered (caller must fall back), or a
// hard error. *start_out/*end_out are inflated-stream offsets.
int64_t lfs_bam_flagstat_byte_range(const uint8_t* data, int64_t n_bytes,
                                    int64_t byte_lo, int64_t byte_hi,
                                    uint64_t* counters, int64_t* start_out,
                                    int64_t* end_out, int32_t threads,
                                    int64_t chunk_flags) {
    return bam_parallel_range(data, n_bytes, byte_lo, byte_hi, counters,
                              start_out, end_out, threads, chunk_flags);
}

// (lfs_bgzf_raw_size — the inflated-byte shard space scan — already
//  ships from sam_reader.cpp and serves the BAM leg too)

}  // extern "C"
