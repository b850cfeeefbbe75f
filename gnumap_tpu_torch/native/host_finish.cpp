// Native host-side finisher: exact integer NW traceback.
//
// The device computes scores for every (read, candidate) pair; the few
// retained winners need a traceback for SAM CIGARs (SURVEY.md §7 "rescoring
// winners" design).  The NumPy oracle is too slow for that and would cap
// end-to-end throughput; this C++ routine replicates oracle.nw_align
// bit-for-bit (same int64 fixed-point recurrences, same NEG_INF clamping,
// same prefix-max Iy unrolling, same tie-breaks).
//
// Reference analog: ScoredSeq::align + traceback (SURVEY.md §3.3 [REPO?]).
//
// Built by gnumap_tpu_torch/_build.py (build_host): g++ -O3 -shared, no
// dependencies.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

thread_local std::vector<int64_t> g_m, g_ix, g_iy;

inline int64_t max3(int64_t a, int64_t b, int64_t c) {
    int64_t m = a > b ? a : b;
    return m > c ? m : c;
}

}  // namespace

extern "C" {

// Fills cigar_out with an RLE CIGAR string (M/I/D ops).  Returns the
// alignment score; *pos_in_window = first consumed genome column - 1,
// *ref_len = genome bases consumed.  Semantics frozen by oracle.nw_align.
// band_off/band_w: [FROZEN v3] DP band (config.MapperConfig.band) — for
// row i, columns j >= 1 outside [i - band_off, i - band_off + band_w - 1]
// are exactly neg_inf.  band_w <= 0 disables banding.
int64_t nw_traceback(const int32_t* emis,   // [L][5] row-major
                     const int8_t* window,  // [W] codes 0..4
                     int32_t L, int32_t W,
                     int64_t open_q, int64_t ext_q, int64_t neg_inf,
                     int32_t band_off, int32_t band_w,
                     char* cigar_out, int32_t cigar_cap,
                     int32_t* pos_in_window, int32_t* ref_len) {
    const int64_t stride = W + 1;
    const size_t cells = (size_t)(L + 1) * stride;
    if (g_m.size() < cells) {
        g_m.resize(cells);
        g_ix.resize(cells);
        g_iy.resize(cells);
    }
    int64_t* M = g_m.data();
    int64_t* Ix = g_ix.data();
    int64_t* Iy = g_iy.data();

    for (int64_t j = 0; j <= W; ++j) {
        M[j] = 0;               // M[0][j] = 0 (fitting alignment, free start)
        Ix[j] = neg_inf;
        Iy[j] = neg_inf;
    }
    for (int32_t i = 1; i <= L; ++i) {
        const int64_t* Mp = M + (int64_t)(i - 1) * stride;
        const int64_t* Ixp = Ix + (int64_t)(i - 1) * stride;
        const int64_t* Iyp = Iy + (int64_t)(i - 1) * stride;
        int64_t* Mi = M + (int64_t)i * stride;
        int64_t* Ixi = Ix + (int64_t)i * stride;
        int64_t* Iyi = Iy + (int64_t)i * stride;
        const int32_t* erow = emis + (int64_t)(i - 1) * 5;

        Mi[0] = neg_inf;
        Ixi[0] = Mp[0] - open_q > Ixp[0] - ext_q ? Mp[0] - open_q
                                                 : Ixp[0] - ext_q;
        if (Ixi[0] < neg_inf) Ixi[0] = neg_inf;
        Iyi[0] = neg_inf;
        // prefix-max running value pm = max_{k<=j-1}(M[i][k] + k*ext)
        int64_t pm = Mi[0];     // k = 0 term (j will start at 1)
        const int64_t blo = (int64_t)i - band_off;
        const int64_t bhi = blo + band_w - 1;
        for (int64_t j = 1; j <= W; ++j) {
            const bool off_band = band_w > 0 && (j < blo || j > bhi);
            const int64_t e = erow[window[j - 1]];
            int64_t m = e + max3(Mp[j - 1], Ixp[j - 1], Iyp[j - 1]);
            // M masked before the pm update so the Iy chain only sources
            // in-band columns (mirrors the banded oracle/kernel order)
            Mi[j] = (off_band || m < neg_inf) ? neg_inf : m;
            int64_t ix = Mp[j] - open_q > Ixp[j] - ext_q ? Mp[j] - open_q
                                                         : Ixp[j] - ext_q;
            Ixi[j] = (off_band || ix < neg_inf) ? neg_inf : ix;
            int64_t iy = pm - open_q - (j - 1) * ext_q;
            Iyi[j] = (off_band || iy < neg_inf) ? neg_inf : iy;
            const int64_t cand = Mi[j] + j * ext_q;
            if (cand > pm) pm = cand;
        }
    }

    // final: max over j of max(M[L][j], Ix[L][j]); smallest j on ties
    const int64_t* ML = M + (int64_t)L * stride;
    const int64_t* IxL = Ix + (int64_t)L * stride;
    int64_t best = neg_inf - 1;
    int64_t bestj = 0;
    for (int64_t j = 0; j <= W; ++j) {
        int64_t v = ML[j] > IxL[j] ? ML[j] : IxL[j];
        if (v > best) { best = v; bestj = j; }
    }

    // traceback (state preference M > Ix > Iy, frozen)
    int64_t i = L, j = bestj;
    int state = (ML[j] >= IxL[j]) ? 0 : 1;
    std::vector<char> ops;
    ops.reserve(L + 16);
    while (i > 0) {
        const int64_t* Mi = M + i * stride;
        const int64_t* Mp = M + (i - 1) * stride;
        const int64_t* Ixp = Ix + (i - 1) * stride;
        const int64_t* Iyp = Iy + (i - 1) * stride;
        const int64_t* Iyi = Iy + i * stride;
        if (state == 0) {                       // M: consumed read + genome
            ops.push_back('M');
            int64_t a = Mp[j - 1], b = Ixp[j - 1], c = Iyp[j - 1];
            int64_t m = max3(a, b, c);
            state = (a == m) ? 0 : (b == m ? 1 : 2);
            --i; --j;
        } else if (state == 1) {                // Ix: consumed read only
            ops.push_back('I');
            if (j == 0) { --i; continue; }      // column-0 ramp stays Ix
            if (Mp[j] - open_q >= Ixp[j] - ext_q) state = 0;
            --i;
        } else {                                // Iy: consumed genome only
            ops.push_back('D');
            if (Mi[j - 1] - open_q >= Iyi[j - 1] - ext_q) state = 0;
            --j;
        }
    }

    // RLE encode (ops are reversed; encode from the back)
    int32_t out = 0, rl = 0;
    int64_t n = (int64_t)ops.size();
    for (int64_t k = n - 1; k >= 0;) {
        char op = ops[k];
        int32_t run = 0;
        while (k >= 0 && ops[k] == op) { ++run; --k; }
        char buf[16];
        int len = snprintf(buf, sizeof buf, "%d%c", run, op);
        if (out + len >= cigar_cap) break;
        memcpy(cigar_out + out, buf, len);
        out += len;
        if (op == 'M' || op == 'D') rl += run;
    }
    cigar_out[out] = '\0';
    *pos_in_window = (int32_t)j;
    *ref_len = rl;
    return best;
}

// Integer emission table: pwm[L][4] x S[4][5] -> emis[L][5] (exact int64
// accumulate narrowed to int32; mirrors scoring.emission_int).
void emission_int(const int32_t* pwm, const int32_t* S, int32_t L,
                  int32_t* out) {
    for (int32_t i = 0; i < L; ++i) {
        const int32_t* p = pwm + (int64_t)i * 4;
        for (int32_t g = 0; g < 5; ++g) {
            int64_t acc = 0;
            for (int32_t b = 0; b < 4; ++b)
                acc += (int64_t)p[b] * S[b * 5 + g];
            out[(int64_t)i * 5 + g] = (int32_t)acc;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched finisher: emission + window + traceback for H retained hits in
// parallel worker threads (the reference's pthread worker analog for the
// host tail).  Semantics identical to the per-hit path above.
// ---------------------------------------------------------------------------

#include <thread>
#include <atomic>

namespace {

// core DP+traceback shared by nw_traceback and the batch path
int64_t nw_core(const int32_t* emis, const int8_t* window, int32_t L,
                int32_t W, int64_t open_q, int64_t ext_q, int64_t neg_inf,
                int32_t band_off, int32_t band_w,
                char* cigar_out, int32_t cigar_cap, int32_t* pos_in_window,
                int32_t* ref_len);

}  // namespace

extern "C" {

// strand[h]: 0='+', 1='-'.  genome codes int8 (N=4); window rule:
// ws = floor((cand - slack)/8)*8, width W; OOB -> N.
void finish_hits(const int32_t* pwm,      // [B][Lmax][4]
                 const int32_t* lens,     // [B]
                 const int8_t* genome, int64_t G,
                 const int32_t* S_plus, const int32_t* S_minus,  // [4][5]
                 const int32_t* read_idx, const int8_t* strand,
                 const int32_t* cand, int32_t H,
                 int32_t Lmax, int32_t W, int32_t slack,
                 int64_t open_q, int64_t ext_q, int64_t neg_inf,
                 int32_t band_off, int32_t band_w,
                 int64_t* out_score, int32_t* out_pos,
                 int32_t* out_ref_len, char* out_cigar,
                 int32_t cigar_stride, int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int32_t> next(0);
    auto worker = [&]() {
        std::vector<int32_t> emis((size_t)Lmax * 5);
        std::vector<int8_t> window(W);
        for (;;) {
            int32_t h = next.fetch_add(1);
            if (h >= H) break;
            const int32_t b = read_idx[h];
            const int32_t L = lens[b];
            const int32_t* p = pwm + (int64_t)b * Lmax * 4;
            const int32_t* S = strand[h] ? S_minus : S_plus;
            // emission rows; '-' strand uses the reverse-complemented PWM:
            // rc_pwm[i][base] = pwm[L-1-i][3-base]
            for (int32_t i = 0; i < L; ++i) {
                const int32_t* prow = strand[h]
                    ? p + (int64_t)(L - 1 - i) * 4 : p + (int64_t)i * 4;
                for (int32_t g = 0; g < 5; ++g) {
                    int64_t acc = 0;
                    for (int32_t bb = 0; bb < 4; ++bb) {
                        int32_t pv = strand[h] ? prow[3 - bb] : prow[bb];
                        acc += (int64_t)pv * S[bb * 5 + g];
                    }
                    emis[(size_t)i * 5 + g] = (int32_t)acc;
                }
            }
            // window (frozen rule, floor division for negatives)
            int64_t t = (int64_t)cand[h] - slack;
            int64_t ws = (t >= 0 ? t / 8 : ((t - 7) / 8)) * 8;
            for (int32_t j = 0; j < W; ++j) {
                int64_t gp = ws + j;
                window[j] = (gp >= 0 && gp < G) ? genome[gp] : (int8_t)4;
            }
            int32_t piw = 0, rl = 0;
            out_score[h] = nw_core(emis.data(), window.data(), L, W,
                                   open_q, ext_q, neg_inf, band_off, band_w,
                                   out_cigar + (int64_t)h * cigar_stride,
                                   cigar_stride, &piw, &rl);
            out_pos[h] = (int32_t)(ws + piw);
            out_ref_len[h] = rl;
        }
    };
    std::vector<std::thread> threads;
    for (int32_t k = 1; k < n_threads; ++k) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
}

}  // extern "C"

namespace {

int64_t nw_core(const int32_t* emis, const int8_t* window, int32_t L,
                int32_t W, int64_t open_q, int64_t ext_q, int64_t neg_inf,
                int32_t band_off, int32_t band_w,
                char* cigar_out, int32_t cigar_cap, int32_t* pos_in_window,
                int32_t* ref_len) {
    return nw_traceback(emis, window, L, W, open_q, ext_q, neg_inf,
                        band_off, band_w,
                        cigar_out, cigar_cap, pos_in_window, ref_len);
}

}  // namespace

// ---------------------------------------------------------------------------
// Ordered float64 coverage / SNP-tally scatter (GNUMAP-SNP, SURVEY.md §2).
// Bit-identical to the NumPy np.add.at path in pipeline.mapper
// (_scatter_coverage/_scatter_tallies): same hit order, same doubles, same
// skip-of-out-of-range (adding +0.0 is an IEEE identity) — at memory speed
// instead of np.ufunc.at speed (~100x).
// ---------------------------------------------------------------------------

extern "C" {

void scatter_coverage(const int64_t* pos, const int64_t* rl,
                      const double* w, int64_t H,
                      double* cov, int64_t G) {
    for (int64_t h = 0; h < H; ++h) {
        const double wh = w[h];
        int64_t lo = pos[h], hi = pos[h] + rl[h];
        if (lo < 0) lo = 0;
        if (hi > G) hi = G;
        for (int64_t j = lo; j < hi; ++j) cov[j] += wh;
    }
}

// cigars: H zero-terminated strings at cigar_stride bytes; empty string =
// pure match of lens[b] bases.  pwm: [B][Lmax][4] int32; minus hits use the
// reverse-complemented PWM rows of [0, len).
void scatter_tallies(const int32_t* pwm, const int32_t* lens, int32_t Lmax,
                     const int32_t* b_idx, const int8_t* minus,
                     const int64_t* pos, const double* w, int64_t H,
                     const char* cigars, int32_t cigar_stride,
                     double* tallies, int64_t G, double pwm_scale) {
    for (int64_t h = 0; h < H; ++h) {
        const int32_t b = b_idx[h];
        const int32_t L = lens[b];
        const int32_t* p = pwm + (int64_t)b * Lmax * 4;
        const bool mn = minus[h] != 0;
        const double wh = w[h];
        const char* cg = cigars + (int64_t)h * cigar_stride;
        int64_t gp = pos[h];
        int32_t i = 0;
        char pure[16];
        if (!*cg) { snprintf(pure, sizeof pure, "%dM", L); cg = pure; }
        while (*cg) {
            int32_t num = 0;
            while (*cg >= '0' && *cg <= '9') num = num * 10 + (*cg++ - '0');
            const char op = *cg++;
            if (op == 'M') {
                for (int32_t k = 0; k < num; ++k, ++gp, ++i) {
                    if (gp < 0 || gp >= G) continue;
                    double* t = tallies + gp * 4;
                    for (int32_t base = 0; base < 4; ++base) {
                        const int32_t pv = mn
                            ? p[(int64_t)(L - 1 - i) * 4 + (3 - base)]
                            : p[(int64_t)i * 4 + base];
                        t[base] += (double)pv / pwm_scale * wh;
                    }
                }
            } else if (op == 'D') {
                gp += num;
            } else if (op == 'I') {
                i += num;
            }
        }
    }
}

}  // extern "C"
