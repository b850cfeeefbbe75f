// Native SAM batch formatter (reference output layer, SURVEY.md §1 L5).
//
// The per-record Python path (pipeline/mapper.py map_stream: per-read
// decode + f-string assembly + per-hit locate) was the remaining host cost
// of runs with SAM output on.  This formats one BATCH of records in a
// single call: the caller passes vectorized per-hit arrays (read index,
// flag, contig, position, mapq, cigar, score, weight) and per-read (codes,
// quals, names; names, contig names and cigars as UTF-8 bytes with byte
// offsets); output is one contiguous buffer, byte-identical to the UTF-8
// encoding of io/sam.py record()/unmapped_record().  XS:f / XP:f are
// Python's format(x, '.4f') / format(x, '.6f'): correctly rounded, ties to
// even on the exact binary value, as printf's "%.4f" / "%.6f" are.  An
// exact integer formatter writes every finite |x| < 1e9 (put_fixed);
// snprintf writes the rest and they are counted.  No write passes out_cap:
// each record's room is checked before it, every snprintf's return after.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

const char BASES[6] = {'A', 'C', 'G', 'T', 'N', 'N'};
const int8_t COMP[6] = {3, 2, 1, 0, 4, 4};

inline char* put_str(char* p, const char* s, int64_t n) {
    std::memcpy(p, s, (size_t)n);
    return p + n;
}

inline char* put_u(char* p, int64_t v) {
    // non-negative decimal
    char tmp[24];
    int n = 0;
    if (v == 0) tmp[n++] = '0';
    while (v > 0) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
    while (n > 0) *p++ = tmp[--n];
    return p;
}

const uint64_t POW10[7] = {1, 10, 100, 1000, 10000, 100000, 1000000};

// x as "%.<PREC>f" writes it, for finite |x| < 1e9: at most 1 + 10 + 1 +
// PREC bytes (just under 1e9 may round up to it).  x = m / 2^s exactly,
// so x * 10^PREC = m * 10^PREC / 2^s: m * 10^PREC < 2^73 fits 128 bits,
// the quotient (at most 1e15) 64.  The quotient is rounded half to even
// on the remainder; the sign comes from the sign bit, so -0.0 and small
// negatives give "-0.0000".
template <int PREC>
inline char* put_fixed(char* p, double x) {
    uint64_t bits;
    std::memcpy(&bits, &x, sizeof bits);
    if (bits >> 63) *p++ = '-';
    const int be = (int)((bits >> 52) & 0x7ff);
    uint64_t m = bits & ((1ull << 52) - 1);
    int s = 1074;                                   // subnormal or zero
    if (be) { m |= 1ull << 52; s = 1075 - be; }     // |x| < 2^30: s >= 23
    uint64_t n = 0;
    if (s < 100) {          // else x * 10^PREC < 2^-27 rounds to 0
        const unsigned __int128 v = (unsigned __int128)m * POW10[PREC];
        const unsigned __int128 one = 1;
        const unsigned __int128 r = v & ((one << s) - 1);
        const unsigned __int128 half = one << (s - 1);
        n = (uint64_t)(v >> s);
        if (r > half || (r == half && (n & 1))) ++n;
    }
    p = put_u(p, (int64_t)(n / POW10[PREC]));
    *p++ = '.';
    uint64_t f = n % POW10[PREC];
    for (int i = PREC - 1; i >= 0; --i) {
        p[i] = (char)('0' + f % 10);
        f /= 10;
    }
    return p + PREC;
}

// "<tag><x as %.<PREC>f>", tag 6 bytes ("\tXS:f:"); nullptr if it would
// pass end.  One byte is always left after it, for the record's '\n'.
template <int PREC>
inline char* put_float_tag(char* p, char* end, const char* tag, double x,
                           int64_t* n_slow) {
    if (end - p < 6 + 13 + PREC) return nullptr;
    p = put_str(p, tag, 6);
    if (std::fabs(x) < 1e9) return put_fixed<PREC>(p, x);  // NaN: false
    ++*n_slow;
    const int r = std::snprintf(p, (size_t)(end - p), "%.*f", PREC, x);
    if (r < 0 || r >= end - p) return nullptr;
    return p + r;
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 if out_cap would be exceeded; *n_slow is
// set to the XS:f / XP:f fields written by snprintf (non-finite, or
// |x| >= 1e9).
int64_t format_sam_batch(
    const int8_t* codes, const int16_t* quals, const int32_t* lens,
    int32_t B, int32_t Lmax,
    const char* names, const int64_t* name_off,        // [B+1]
    const char* rnames, const int64_t* rname_off,      // [ncontig+1]
    const int32_t* hit_read,                           // [Nh] ascending
    const int32_t* hit_flag,                           // [Nh]
    const int32_t* hit_rname,                          // [Nh]
    const int64_t* hit_pos,                            // [Nh] 0-based
    const int32_t* hit_mapq,                           // [Nh]
    const char* cigars, const int64_t* cigar_off,      // [Nh+1]; empty =>
                                                       //   "<len>M"
    const int32_t* hit_score,                          // [Nh]
    const double* hit_xs,                              // [Nh]
    const double* hit_weight,                          // [Nh]
    int64_t Nh,
    const uint8_t* unmapped,                           // [B]
    const uint8_t* skip,                               // [B] emit nothing
    int64_t* n_slow,
    char* out, int64_t out_cap) {
    char* p = out;
    char* end = out + out_cap;
    *n_slow = 0;
    // per-read forward/reverse seq + qual scratch
    thread_local char *fseq = nullptr, *rseq = nullptr,
                      *fq = nullptr, *rq = nullptr;
    thread_local int64_t cap = 0;
    if (cap < Lmax) {
        delete[] fseq; delete[] rseq; delete[] fq; delete[] rq;
        fseq = new char[Lmax]; rseq = new char[Lmax];
        fq = new char[Lmax]; rq = new char[Lmax];
        cap = Lmax;
    }
    int64_t h = 0;
    for (int32_t b = 0; b < B; ++b) {
        if (skip && skip[b]) {
            while (h < Nh && hit_read[h] == b) ++h;   // defensive
            continue;
        }
        const int32_t L = lens[b];
        const int8_t* c = codes + (int64_t)b * Lmax;
        const int16_t* q = quals + (int64_t)b * Lmax;
        for (int32_t i = 0; i < L; ++i) {
            fseq[i] = BASES[c[i] < 0 || c[i] > 5 ? 4 : c[i]];
            fq[i] = (char)(33 + q[i]);
        }
        bool have_rc = false;
        const char* name = names + name_off[b];
        const int64_t name_n = name_off[b + 1] - name_off[b];
        if (unmapped[b]) {
            // qname\t4\t*\t0\t0\t*\t*\t0\t0\tseq\tqual\n
            if (p + name_n + 2 * L + 32 > end) return -1;
            p = put_str(p, name, name_n);
            p = put_str(p, "\t4\t*\t0\t0\t*\t*\t0\t0\t", 17);
            p = put_str(p, fseq, L);
            *p++ = '\t';
            p = put_str(p, fq, L);
            *p++ = '\n';
            continue;
        }
        for (; h < Nh && hit_read[h] == b; ++h) {
            const int32_t flag = hit_flag[h];
            const char* rn = rnames + rname_off[hit_rname[h]];
            const int64_t rn_n = rname_off[hit_rname[h] + 1]
                - rname_off[hit_rname[h]];
            const int64_t ci_n = cigar_off[h + 1] - cigar_off[h];
            if (p + name_n + rn_n + ci_n + 2 * L + 128 > end) return -1;
            p = put_str(p, name, name_n);
            *p++ = '\t';
            p = put_u(p, flag);
            *p++ = '\t';
            p = put_str(p, rn, rn_n);
            *p++ = '\t';
            p = put_u(p, hit_pos[h] + 1);
            *p++ = '\t';
            p = put_u(p, hit_mapq[h]);
            *p++ = '\t';
            if (ci_n) {
                p = put_str(p, cigars + cigar_off[h], ci_n);
            } else {
                p = put_u(p, L);
                *p++ = 'M';
            }
            p = put_str(p, "\t*\t0\t0\t", 7);
            if (flag & 16) {
                if (!have_rc) {
                    for (int32_t i = 0; i < L; ++i) {
                        rseq[i] = BASES[(int)COMP[
                            c[L - 1 - i] < 0 || c[L - 1 - i] > 5
                            ? 4 : c[L - 1 - i]]];
                        rq[i] = fq[L - 1 - i];
                    }
                    have_rc = true;
                }
                p = put_str(p, rseq, L);
                *p++ = '\t';
                p = put_str(p, rq, L);
            } else {
                p = put_str(p, fseq, L);
                *p++ = '\t';
                p = put_str(p, fq, L);
            }
            p = put_str(p, "\tAS:i:", 6);
            if (hit_score[h] < 0) {
                *p++ = '-';
                p = put_u(p, -(int64_t)hit_score[h]);
            } else {
                p = put_u(p, hit_score[h]);
            }
            p = put_float_tag<4>(p, end, "\tXS:f:", hit_xs[h], n_slow);
            if (p) p = put_float_tag<6>(p, end, "\tXP:f:", hit_weight[h],
                                        n_slow);
            if (!p) return -1;
            *p++ = '\n';
        }
    }
    return p - out;
}

}  // extern "C"

extern "C" {

// SGR lines "name\tpos\tcov(%.4f)\n" for one contig's nonzero positions.
// Returns bytes written, or -1 on capacity overflow.
int64_t format_sgr(const char* name, int64_t name_n,
                   const int64_t* pos,      // [N] 1-based positions
                   const double* val,       // [N]
                   int64_t N, char* out, int64_t out_cap) {
    char* p = out;
    char* end = out + out_cap;
    for (int64_t i = 0; i < N; ++i) {
        if (p + name_n + 48 > end) return -1;
        p = put_str(p, name, name_n);
        *p++ = '\t';
        p = put_u(p, pos[i]);
        const int r = std::snprintf(p, (size_t)(end - p), "\t%.4f\n", val[i]);
        if (r < 0 || r >= end - p) return -1;
        p += r;
    }
    return p - out;
}

}  // extern "C"
