// SA-IS suffix-array construction (linear time) for the FM-index build.
//
// Native analog of index/fm.py::suffix_array (numpy prefix-doubling,
// O(n log^2 n)) — same output, ~linear time, so chr21-scale FM builds take
// seconds instead of minutes.  Reference context: the GNUMAP BWT index
// variant ("GenomeBwt", SURVEY.md §2) whose index build is likewise native
// C++.
//
// Input: base codes (int8, values 0..4); the function appends the unique
// smallest sentinel internally and writes the suffix array of
// (codes + sentinel), length n + 1, with sa[0] = n.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline bool is_lms(const std::vector<uint8_t>& t, int32_t i) {
    return i > 0 && t[i] && !t[i - 1];
}

// Nong/Zhang/Chan SA-IS over an int alphabet [0, K); s[n-1] must be the
// unique smallest symbol (the sentinel).
void sais_core(const int32_t* s, int32_t* sa, int32_t n, int32_t K) {
    std::vector<uint8_t> t(n);          // 1 = S-type, 0 = L-type
    t[n - 1] = 1;
    for (int32_t i = n - 2; i >= 0; --i)
        t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;

    std::vector<int32_t> bkt(K);
    auto get_buckets = [&](bool end) {
        std::fill(bkt.begin(), bkt.end(), 0);
        for (int32_t i = 0; i < n; ++i) bkt[s[i]]++;
        int32_t sum = 0;
        for (int32_t c = 0; c < K; ++c) {
            sum += bkt[c];
            bkt[c] = end ? sum : sum - bkt[c];
        }
    };
    auto induce = [&]() {
        get_buckets(false);             // induce L from heads
        for (int32_t i = 0; i < n; ++i) {
            int32_t j = sa[i] - 1;
            if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
        }
        get_buckets(true);              // induce S from tails
        for (int32_t i = n - 1; i >= 0; --i) {
            int32_t j = sa[i] - 1;
            if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
        }
    };

    // stage 1: bucket the LMS suffixes, induce-sort LMS substrings
    std::fill(sa, sa + n, -1);
    get_buckets(true);
    for (int32_t i = 1; i < n; ++i)
        if (is_lms(t, i)) sa[--bkt[s[i]]] = i;
    induce();

    int32_t n1 = 0;
    for (int32_t i = 0; i < n; ++i)
        if (sa[i] > 0 && is_lms(t, sa[i])) sa[n1++] = sa[i];

    // name the sorted LMS substrings in sa[n1..n)
    std::fill(sa + n1, sa + n, -1);
    int32_t name = 0, prev = -1;
    for (int32_t i = 0; i < n1; ++i) {
        int32_t pos = sa[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (int32_t d = 0;; ++d) {
                if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (is_lms(t, pos + d) || is_lms(t, prev + d)))
                    break;              // both LMS (types matched) -> equal
            }
        }
        if (diff) {
            ++name;
            prev = pos;
        }
        sa[n1 + pos / 2] = name - 1;
    }
    std::vector<int32_t> s1(n1);
    for (int32_t i = n - 1, j = n1 - 1; i >= n1; --i)
        if (sa[i] >= 0) s1[j--] = sa[i];

    // stage 2: order the LMS suffixes
    std::vector<int32_t> sa1(n1);
    if (name < n1) {
        sais_core(s1.data(), sa1.data(), n1, name);
    } else {
        for (int32_t i = 0; i < n1; ++i) sa1[s1[i]] = i;
    }

    // stage 3: induce the full order from the sorted LMS suffixes
    std::vector<int32_t> lms;
    lms.reserve(n1);
    for (int32_t i = 1; i < n; ++i)
        if (is_lms(t, i)) lms.push_back(i);
    std::fill(sa, sa + n, -1);
    get_buckets(true);
    for (int32_t i = n1 - 1; i >= 0; --i) {
        int32_t j = lms[sa1[i]];
        sa[--bkt[s[j]]] = j;
    }
    induce();
}

}  // namespace

extern "C" void suffix_array_sais(const int8_t* codes, int32_t n,
                                  int32_t* sa_out) {
    std::vector<int32_t> s(n + 1);
    for (int32_t i = 0; i < n; ++i) s[i] = codes[i] + 1;  // symbols 1..5
    s[n] = 0;                                             // sentinel
    sais_core(s.data(), sa_out, n + 1, 6);
}
