// Native SAM batch formatter (reference output layer, SURVEY.md §1 L5).
//
// The per-record Python path (pipeline/mapper.py map_stream: per-read
// decode + f-string assembly + per-hit locate) was the remaining host cost
// of runs with SAM output on.  This formats one BATCH of records in a
// single call: the caller passes vectorized per-hit arrays (read index,
// flag, contig, position, mapq, cigar, score, weight) and per-read (codes,
// quals, names; names, contig names and cigars as UTF-8 bytes with byte
// offsets); output is one contiguous buffer, byte-identical to the UTF-8
// encoding of io/sam.py record()/unmapped_record() (printf "%.4f"/"%.6f"
// and Python's format(x, '.4f') are both correctly rounded, so the float
// fields agree bit-for-bit; property-tested in tests/test_native.py).  No
// write passes out_cap: every snprintf's return is checked.

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

}  // namespace

extern "C" {

// Returns bytes written, or -1 if out_cap would be exceeded.
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
    char* out, int64_t out_cap) {
    char* p = out;
    char* end = out + out_cap;
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
            const int r = std::snprintf(p, (size_t)(end - p),
                                        "\tXS:f:%.4f\tXP:f:%.6f\n",
                                        hit_xs[h], hit_weight[h]);
            if (r < 0 || r >= end - p) return -1;
            p += r;
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
