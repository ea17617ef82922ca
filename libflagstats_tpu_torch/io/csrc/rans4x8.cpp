// rANS 4x8 codec (CRAM 3.0 §13 "rANS codec", order-0) — clean-room
// implementation of the published format: Duda's range asymmetric
// numeral system, 4 interleaved 32-bit states renormalizing a byte at
// a time against one shared stream, 12-bit normalized frequencies
// (total 4096), and the CRAM spec's RLE'd frequency-table layout.
//
// Stream layout ('\x00'|order byte, u32le compressed-remainder size,
// u32le uncompressed size, frequency table, 4 u32le initial states,
// byte stream):
//   order 0 only here; order 1 (256 contexts) is detected and refused
//   by the reader with a clear error (documented subset —
//   io/cramio.py module docstring).
//
// Entry points (C ABI, ctypes-bound):
//   lfs_rans4x8_compress(src, n, dst, cap)   -> bytes written or -1
//   lfs_rans4x8_size(src, n)                 -> declared raw size or -1
//   lfs_rans4x8_decompress(src, n, dst, cap) -> bytes written or <0
// Decoder hardening: every table/stream read is bounds-checked, the
// frequency table must sum to 4096, and output is capped — hostile
// input errors, never overruns (fuzzed in tests/test_cramio.py and
// the ASan harness).

#include <cstdint>
#include <cstring>
#include <new>

namespace {

constexpr uint32_t kTotFreq = 4096;       // 12-bit normalized total
constexpr uint32_t kRansLow = 1u << 23;   // renormalization threshold

struct Writer {
    uint8_t* p;
    uint8_t* end;
    bool ok = true;
    void put(uint8_t b) {
        if (p < end) *p++ = b; else ok = false;
    }
    void put_u32(uint32_t v) {
        put(v & 0xFF); put((v >> 8) & 0xFF);
        put((v >> 16) & 0xFF); put((v >> 24) & 0xFF);
    }
};

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;
    uint8_t get() {
        if (p < end) return *p++;
        ok = false;
        return 0;
    }
    uint32_t get_u32() {
        uint32_t a = get(), b = get(), c = get(), d = get();
        return a | (b << 8) | (c << 16) | (d << 24);
    }
};

// normalize counts to sum kTotFreq, every present symbol >= 1
void normalize_freqs(const uint64_t* cnt, uint64_t n, uint32_t* F) {
    if (n == 0) return;
    uint64_t total = 0;
    for (int i = 0; i < 256; ++i) total += cnt[i];
    uint32_t sum = 0;
    int last = -1;
    for (int i = 0; i < 256; ++i) {
        if (!cnt[i]) { F[i] = 0; continue; }
        uint32_t f = (uint32_t)((cnt[i] * (uint64_t)kTotFreq) / total);
        if (f == 0) f = 1;
        F[i] = f;
        sum += f;
        last = i;
    }
    // fix rounding drift on the most frequent symbol (keeps all >= 1)
    int big = last;
    for (int i = 0; i < 256; ++i)
        if (F[i] > F[big]) big = i;
    int32_t drift = (int32_t)kTotFreq - (int32_t)sum;
    if ((int32_t)F[big] + drift < 1) return;  // pathological; caller fails
    F[big] = (uint32_t)((int32_t)F[big] + drift);
}

// CRAM spec frequency-table serialization: ascending symbols, RLE for
// runs of consecutive present symbols, 1-or-2-byte frequencies
// (values >= 128 as 0x80|hi, lo), 0x00 terminator.
void write_freq_table(Writer& w, const uint32_t* F) {
    int rle = 0;
    for (int j = 0; j < 256; ++j) {
        if (!F[j]) continue;
        if (rle) {
            --rle;
        } else {
            w.put((uint8_t)j);
            if (j > 0 && F[j - 1]) {
                int run = 0;
                while (j + 1 + run < 256 && F[j + 1 + run]) ++run;
                w.put((uint8_t)run);
                rle = run;
            }
        }
        if (F[j] < 128) {
            w.put((uint8_t)F[j]);
        } else {
            w.put((uint8_t)(0x80 | (F[j] >> 8)));
            w.put((uint8_t)(F[j] & 0xFF));
        }
    }
    w.put(0);
}

bool read_freq_table(Reader& r, uint32_t* F) {
    std::memset(F, 0, 256 * sizeof(uint32_t));
    int rle = 0;
    int j = r.get();
    uint32_t sum = 0;
    while (r.ok) {
        if (j < 0 || j > 255) return false;
        uint32_t f = r.get();
        if (f >= 0x80) f = ((f & 0x7F) << 8) | r.get();
        if (!r.ok || f == 0 || f > kTotFreq) return false;
        if (F[j]) return false;            // duplicate symbol
        F[j] = f;
        sum += f;
        if (sum > kTotFreq) return false;
        if (rle) {
            --rle;
            ++j;
        } else {
            int nj = r.get();
            if (!r.ok) return false;
            if (nj == 0) break;            // terminator
            if (nj == j + 1) {             // start of a consecutive run
                rle = r.get();
                j = nj;
            } else {
                j = nj;
            }
        }
    }
    return r.ok && sum == kTotFreq;
}

}  // namespace

extern "C" {

int64_t lfs_rans4x8_bound(int64_t n) {
    // worst case: incompressible data still costs ~ n * 12/8 bits? No —
    // rANS with 12-bit freqs on uniform bytes emits ~n bytes + tables;
    // a safe bound mirrors the frequency-table + state overhead with
    // 5% headroom.
    return n + (n >> 4) + 1024;
}

int64_t lfs_rans4x8_compress(const uint8_t* src, int64_t n,
                             uint8_t* dst, int64_t cap) {
    if (n < 0 || n > 0xFFFFFFFFll || cap < 16) return -1;
    Writer w{dst, dst + cap};
    w.put(0);                      // order 0
    uint8_t* size_at = w.p;
    w.put_u32(0);                  // compressed-remainder size (patched)
    w.put_u32((uint32_t)n);
    if (n == 0) {
        if (!w.ok) return -1;
        return w.p - dst;
    }

    uint64_t cnt[256] = {0};
    for (int64_t i = 0; i < n; ++i) cnt[src[i]]++;
    uint32_t F[256];
    normalize_freqs(cnt, (uint64_t)n, F);
    uint32_t C[257];               // cumulative
    C[0] = 0;
    for (int i = 0; i < 256; ++i) C[i + 1] = C[i] + F[i];
    if (C[256] != kTotFreq) return -1;
    write_freq_table(w, F);
    if (!w.ok) return -1;

    // encode back-to-front into a scratch tail, 4 interleaved states;
    // symbol i belongs to state i & 3
    int64_t scratch_cap = lfs_rans4x8_bound(n);
    uint8_t* tail = new (std::nothrow) uint8_t[(size_t)scratch_cap];
    if (!tail) return -1;
    uint8_t* tp = tail + scratch_cap;      // grows downward
    uint32_t R[4] = {kRansLow, kRansLow, kRansLow, kRansLow};
    bool ok = true;
    for (int64_t i = n - 1; i >= 0; --i) {
        uint32_t& st = R[i & 3];
        uint32_t f = F[src[i]], c = C[src[i]];
        // renormalize before encode: st must stay < f * (kRansLow>>12)*256
        uint32_t max_st = ((kRansLow >> 12) << 8) * f;
        while (st >= max_st) {
            if (tp == tail) { ok = false; break; }
            *--tp = (uint8_t)(st & 0xFF);
            st >>= 8;
        }
        if (!ok) break;
        st = ((st / f) << 12) + (st % f) + c;
    }
    if (ok) {
        // flush states 3..0 little-endian, so ascending memory reads
        // [R0 le][R1 le][R2 le][R3 le] and the decoder pulls 0..3 first
        for (int j = 3; j >= 0; --j) {
            for (int k = 3; k >= 0; --k) {
                if (tp == tail) { ok = false; break; }
                *--tp = (uint8_t)((R[j] >> (8 * k)) & 0xFF);
            }
            if (!ok) break;
        }
    }
    int64_t stream_len = (tail + scratch_cap) - tp;
    if (ok) {
        for (int64_t i = 0; i < stream_len; ++i) w.put(tp[i]);
        ok = w.ok;
    }
    delete[] tail;
    if (!ok) return -1;
    uint32_t remainder = (uint32_t)((w.p - size_at) - 8);
    size_at[0] = remainder & 0xFF;
    size_at[1] = (remainder >> 8) & 0xFF;
    size_at[2] = (remainder >> 16) & 0xFF;
    size_at[3] = (remainder >> 24) & 0xFF;
    return w.p - dst;
}

int64_t lfs_rans4x8_size(const uint8_t* src, int64_t n) {
    if (n < 9) return -1;
    return (int64_t)src[5] | ((int64_t)src[6] << 8) |
           ((int64_t)src[7] << 16) | ((int64_t)src[8] << 24);
}

int64_t lfs_rans4x8_decompress(const uint8_t* src, int64_t n,
                               uint8_t* dst, int64_t cap) {
    if (n < 9) return -2;
    if (src[0] == 1) return -3;        // order-1: documented unsupported
    if (src[0] != 0) return -2;
    Reader r{src + 1, src + n};
    uint32_t remainder = r.get_u32();
    uint32_t raw = r.get_u32();
    if (!r.ok || raw > (uint64_t)cap) return -2;
    if ((int64_t)remainder + 9 > n) return -2;  // truncated vs declared
    r.end = src + 9 + remainder;       // stream may not read past decl.
    if (raw == 0) return 0;

    uint32_t F[256];
    if (!read_freq_table(r, F)) return -2;
    uint32_t C[257];
    C[0] = 0;
    for (int i = 0; i < 256; ++i) C[i + 1] = C[i] + F[i];
    // cum -> symbol lookup (4096 entries)
    uint8_t cum2sym[kTotFreq];
    for (int s = 0; s < 256; ++s)
        for (uint32_t c = C[s]; c < C[s + 1]; ++c) cum2sym[c] = (uint8_t)s;

    uint32_t R[4];
    for (int j = 0; j < 4; ++j) {
        R[j] = r.get_u32();              // states flushed little-endian
        if (R[j] < kRansLow) return -2;  // invalid initial state
    }
    if (!r.ok) return -2;
    for (uint32_t i = 0; i < raw; ++i) {
        uint32_t& st = R[i & 3];
        uint32_t c = st & (kTotFreq - 1);
        uint8_t s = cum2sym[c];
        dst[i] = s;
        st = F[s] * (st >> 12) + c - C[s];
        while (st < kRansLow) {
            if (r.p >= r.end) return -2;  // stream exhausted mid-decode
            st = (st << 8) | *r.p++;
        }
    }
    return (int64_t)raw;
}

}  // extern "C"
