// Native core of the de-novo gene finder (gecco_tpu_torch.orf.scan).
//
// The reference gets its gene-calling speed from Prodigal's C engine via
// pyrodigal (SURVEY.md §2.2); this package keeps the model fitting in
// Python/numpy and implements the loops over nucleotides and candidates
// here: six-frame ORF candidate enumeration, each candidate's start codon
// and RBS bin, in-frame hexamer scoring and the selection DP.  Bound via
// ctypes (gecco_tpu_torch/orf/_native.py) with a pure
// Python fallback — both implementations are tested for equality.
//
// Build: g++ on first use, by gecco_tpu_torch/orf/_native.py::ensure_built
// (produces gecco_tpu_torch/_build/liborfscan_<hash>.so).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kStart = 1;  // candidate flag bits
constexpr int kPartialBegin = 2;
constexpr int kPartialEnd = 4;

inline bool is_stop(const int8_t* c) {
    // TAA TAG TGA with A=0 C=1 G=2 T=3
    if (c[0] != 3) return false;
    if (c[1] == 0 && (c[2] == 0 || c[2] == 2)) return true;  // TAA, TAG
    if (c[1] == 2 && c[2] == 0) return true;                 // TGA
    return false;
}

inline bool is_start(const int8_t* c) {
    // ATG GTG TTG
    return c[1] == 3 && c[2] == 2 && (c[0] == 0 || c[0] == 2 || c[0] == 3);
}

// The RBS motifs in precedence order (scan._RBS_MOTIFS), 4 bits a base
// from the first base up: code + 1, so A = 1 and G = 3 (0 is an unknown
// base, which no motif holds).
constexpr int kMotifs = 6;
constexpr uint64_t kMotif[kMotifs] = {
    0x331331,  // AGGAGG
    0x33133,   // GGAGG
    0x31331,   // AGGAG
    0x3133,    // GGAG
    0x1331,    // AGGA
    0x3313,    // GAGG
};
constexpr int kMotifLen[kMotifs] = {6, 5, 5, 4, 4, 4};
constexpr int kRbsFar = 15;   // the window is [start - 15, start - 4)
constexpr int kRbsNear = 4;

}  // namespace

extern "C" {

// Enumerate candidate genes on one strand.
//
// codes:     strand-oriented 2-bit encoding (A=0 C=1 G=2 T=3, -1 unknown)
// min_gene:  minimum gene length in nucleotides (stop included)
// max_starts: cap of alternative starts kept per stop-free region
// out_*:     preallocated arrays of capacity max_out
// returns the number of candidates written (or -1 on overflow).
int orfscan_candidates(
    const int8_t* codes, int n, int min_gene, int max_starts,
    int32_t* out_start, int32_t* out_end, uint8_t* out_flags, int max_out) {
    int count = 0;
    for (int frame = 0; frame < 3; ++frame) {
        int region_begin = frame;
        for (int i = frame; i + 2 < n + 3; i += 3) {
            bool at_end = i + 2 >= n;
            bool stop = !at_end && is_stop(codes + i);
            if (!stop && !at_end) continue;
            int region_end = at_end ? (n - (n - frame) % 3) : i;  // stop-free codons in [region_begin, region_end)
            int gene_end = stop ? region_end + 3 : region_end;
            bool partial_end = !stop;
            if (region_end - region_begin >= min_gene - 3) {
                int emitted = 0;
                // leading partial gene when the region touches the contig begin
                if (region_begin == frame) {
                    int s = region_begin;
                    if (gene_end - s >= min_gene && emitted < max_starts) {
                        if (count >= max_out) return -1;
                        uint8_t flags = 0;
                        if (!is_start(codes + s)) flags |= kPartialBegin;
                        if (partial_end) flags |= kPartialEnd;
                        out_start[count] = s;
                        out_end[count] = gene_end;
                        out_flags[count] = flags;
                        ++count;
                        ++emitted;
                    }
                }
                for (int s = region_begin; s + 2 < region_end && emitted < max_starts; s += 3) {
                    if (!is_start(codes + s)) continue;
                    if (s == region_begin && region_begin == frame) continue;  // already emitted
                    if (gene_end - s < min_gene) continue;
                    if (count >= max_out) return -1;
                    uint8_t flags = partial_end ? kPartialEnd : 0;
                    out_start[count] = s;
                    out_end[count] = gene_end;
                    out_flags[count] = flags;
                    ++count;
                    ++emitted;
                }
            }
            region_begin = region_end + (stop ? 3 : 0);
            if (at_end) break;
        }
    }
    return count;
}

// Accumulate in-frame hexamer counts over [begin, end) spans.
void orfscan_hexamer_counts(
    const int8_t* codes, int n,
    const int32_t* begins, const int32_t* ends, int nspans,
    double* counts4096) {
    for (int s = 0; s < nspans; ++s) {
        int begin = begins[s];
        int end = ends[s];
        if (end > n) end = n;
        for (int i = begin; i + 5 < end; i += 3) {
            int h = 0;
            bool ok = true;
            for (int k = 0; k < 6; ++k) {
                int8_t c = codes[i + k];
                if (c < 0) { ok = false; break; }
                h = (h << 2) | c;
            }
            if (ok) counts4096[h] += 1.0;
        }
    }
}

// Sum in-frame hexamer log-odds per candidate span [start, end).
void orfscan_score(
    const int8_t* codes, int n, const double* log_odds,
    const int32_t* starts, const int32_t* ends, int ncand,
    double* out_scores) {
    for (int c = 0; c < ncand; ++c) {
        double total = 0.0;
        int begin = starts[c];
        int end = ends[c];
        if (end > n) end = n;
        for (int i = begin; i + 5 < end; i += 3) {
            int h = 0;
            bool ok = true;
            for (int k = 0; k < 6; ++k) {
                int8_t b = codes[i + k];
                if (b < 0) { ok = false; break; }
                h = (h << 2) | b;
            }
            if (ok) total += log_odds[h];
        }
        out_scores[c] = total;
    }
}

// Start codon class and RBS bin of each candidate.
//
// codon: 0 ATG, 1 GTG, 2 TTG, 3 any other, -1 for a partial begin.
// rbs:   the first motif, in kMotif order, that occurs anywhere inside
//        [max(0, start - 15), max(0, start - 4)); -1 when none does.
void orfscan_annotate(
    const int8_t* codes, int n, const int32_t* starts, const uint8_t* flags,
    int ncand, int8_t* out_codon, int8_t* out_rbs) {
    for (int c = 0; c < ncand; ++c) {
        const int s = starts[c];
        int8_t codon = -1;
        if (!(flags[c] & kPartialBegin)) {
            const int8_t* x = codes + s;
            codon = 3;
            if (x[1] == 3 && x[2] == 2) {
                if (x[0] == 0) codon = 0;
                else if (x[0] == 2) codon = 1;
                else if (x[0] == 3) codon = 2;
            }
        }
        out_codon[c] = codon;
        const int lo = std::max(0, s - kRbsFar);
        const int width = std::max(0, s - kRbsNear) - lo;   // at most 11 bases
        uint64_t window = 0;
        for (int k = 0; k < width; ++k)
            window |= static_cast<uint64_t>(codes[lo + k] + 1) << (4 * k);
        int8_t rbs = -1;
        for (int b = 0; b < kMotifs; ++b) {
            const int len = kMotifLen[b];
            const uint64_t mask = (uint64_t{1} << (4 * len)) - 1;
            bool found = false;
            for (int p = 0; p + len <= width; ++p)
                found |= ((window >> (4 * p)) & mask) == kMotif[b];
            if (found) { rbs = static_cast<int8_t>(b); break; }
        }
        out_rbs[c] = rbs;
    }
}

// Max-weight compatible subset of candidates (ScanFinder._select).
//
// Candidates scoring above `floor` are stably sorted by end; candidate i
// may follow any candidate ending at or before start_i + max_overlap.
// best[i] is the best total of the first i, take[i] the total when i is
// taken; the traceback and its exact equality tests are Python's.  Only
// additions and comparisons touch the scores, so the totals are those of
// the Python loop bit for bit (no -ffast-math).  Writes the selected
// candidates' indices, in order of end, to out; returns their count.
int orfscan_select(
    const int32_t* starts, const int32_t* ends, const double* scores, int ncand,
    double floor, int max_overlap, int32_t* out) {
    std::vector<int32_t> order;
    order.reserve(ncand);
    for (int c = 0; c < ncand; ++c)
        if (scores[c] > floor) order.push_back(c);
    std::stable_sort(order.begin(), order.end(),
                     [ends](int32_t a, int32_t b) { return ends[a] < ends[b]; });
    const int m = static_cast<int>(order.size());
    if (m == 0) return 0;
    std::vector<int32_t> sorted_ends(m);
    for (int i = 0; i < m; ++i) sorted_ends[i] = ends[order[i]];
    std::vector<double> best(m + 1, 0.0), take(m, 0.0);
    std::vector<int> parent(m, -1);
    for (int i = 0; i < m; ++i) {
        const int32_t limit = starts[order[i]] + max_overlap;
        const int j = static_cast<int>(
            std::upper_bound(sorted_ends.begin(), sorted_ends.begin() + i, limit)
            - sorted_ends.begin());
        take[i] = best[j] + scores[order[i]];
        parent[i] = j;
        best[i + 1] = take[i] > best[i] ? take[i] : best[i];
    }
    int count = 0;
    int i = m;
    while (i > 0) {
        if (best[i] == best[i - 1] && take[i - 1] < best[i]) {
            --i;
            continue;
        }
        if (take[i - 1] == best[i]) {
            out[count++] = order[i - 1];
            i = parent[i - 1];
        } else {
            --i;
        }
    }
    std::reverse(out, out + count);
    return count;
}

}  // extern "C"
