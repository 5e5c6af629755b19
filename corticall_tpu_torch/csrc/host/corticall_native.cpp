// corticall_tpu native core: k-mer counting / canonicalization / sort-reduce.
//
// The host-side heavy lifting behind graph construction (the role McCortex's
// C code plays for the reference pipeline, cromwell/wdl/Simulate.wdl:620-666):
// 2-bit pack every window of every read, canonicalize, sort, and reduce to
// (unique canonical kmer, coverage, in-edge mask, out-edge mask) —
// feeding the same struct-of-arrays the numpy path produces, several times
// faster on large read sets.
//
// C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

struct Entry {
    uint64_t hi, lo;     // canonical kmer, right-aligned (hi = most significant)
    uint8_t in_mask, out_mask;
};

inline bool entry_less(const Entry& a, const Entry& b) {
    if (a.hi != b.hi) return a.hi < b.hi;
    return a.lo < b.lo;
}

inline bool entry_eq(const Entry& a, const Entry& b) {
    return a.hi == b.hi && a.lo == b.lo;
}

// base codes: A=0 C=1 G=2 T=3, 0xFF invalid
inline void build_lut(uint8_t* lut) {
    memset(lut, 0xFF, 256);
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
}

}  // namespace

extern "C" {

// Count kmers over concatenated sequences.
//   bases:      concatenated sequence bytes (ASCII)
//   offsets:    nseqs+1 offsets into bases
//   k:          kmer size (<= 64)
// Outputs (malloc'd; caller frees via ct_free):
//   out_hi/out_lo: canonical kmer halves  (N entries)
//   out_cov:       coverage               (N entries, saturating uint32)
//   out_in/out_out: edge base masks       (N entries)
// Returns N (number of unique canonical kmers), or -1 on error.
int64_t ct_count_kmers(const uint8_t* bases, const int64_t* offsets,
                       int64_t nseqs, int32_t k,
                       uint64_t** out_hi, uint64_t** out_lo,
                       uint32_t** out_cov, uint8_t** out_in,
                       uint8_t** out_out) {
    if (k <= 0 || k > 64) return -1;
    uint8_t lut[256];
    build_lut(lut);

    const int shift_top = 2 * (k - 1);          // position of the first base
    const bool one_word = k <= 32;
    // masks for the (up to) 128-bit packed value
    const uint64_t lo_mask = (k >= 32) ? ~0ULL
                                       : ((1ULL << (2 * k)) - 1);
    const uint64_t hi_mask = (k <= 32) ? 0ULL
                            : ((k == 64) ? ~0ULL : ((1ULL << (2 * (k - 32))) - 1));

    std::vector<Entry> entries;
    entries.reserve(1 << 20);

    for (int64_t s = 0; s < nseqs; s++) {
        const uint8_t* seq = bases + offsets[s];
        const int64_t len = offsets[s + 1] - offsets[s];
        if (len < k) continue;

        // split at invalid bases
        int64_t start = 0;
        while (start <= len - k) {
            // find the next valid run [start, end)
            int64_t end = start;
            while (end < len && lut[seq[end]] != 0xFF) end++;
            if (end - start >= k) {
                // rolling pack over the run
                uint64_t fhi = 0, flo = 0;          // forward, right-aligned
                uint64_t rhi = 0, rlo = 0;          // reverse complement
                for (int64_t i = start; i < end; i++) {
                    const uint64_t b = lut[seq[i]];
                    // forward: shift left 2, append b
                    fhi = ((fhi << 2) | (flo >> 62)) & hi_mask;
                    flo = (flo << 2) | b;
                    if (one_word) flo &= lo_mask;
                    // reverse: shift right 2, prepend (3-b) at the top
                    rlo = (rlo >> 2) | (rhi << 62);
                    rhi >>= 2;
                    const uint64_t cb = 3 - b;
                    if (shift_top >= 64) rhi |= cb << (shift_top - 64);
                    else rlo |= cb << shift_top;
                    if (one_word) { rlo &= lo_mask; rhi = 0; }
                    else { rhi &= hi_mask; }

                    const int64_t pos = i - start + 1;
                    if (pos >= k) {
                        const bool fwd_canon =
                            one_word ? (flo <= rlo)
                                     : (fhi != rhi ? fhi < rhi : flo <= rlo);
                        Entry e;
                        e.hi = fwd_canon ? fhi : rhi;
                        e.lo = fwd_canon ? flo : rlo;
                        e.in_mask = 0;
                        e.out_mask = 0;
                        // prev/next bases in read orientation
                        const int64_t wstart = i - k + 1;
                        const int has_prev = wstart > start;
                        const int has_next = i + 1 < end;
                        const uint64_t pb = has_prev ? lut[seq[wstart - 1]] : 0;
                        const uint64_t nb = has_next ? lut[seq[i + 1]] : 0;
                        if (fwd_canon) {
                            if (has_prev) e.in_mask |= (uint8_t)(1u << pb);
                            if (has_next) e.out_mask |= (uint8_t)(1u << nb);
                        } else {
                            if (has_next) e.in_mask |= (uint8_t)(1u << (3 - nb));
                            if (has_prev) e.out_mask |= (uint8_t)(1u << (3 - pb));
                        }
                        entries.push_back(e);
                    }
                }
            }
            // advance past the invalid byte
            start = end + 1;
            if (end >= len) break;
        }
    }

    std::sort(entries.begin(), entries.end(), entry_less);

    // reduce
    int64_t n = 0;
    const int64_t total = (int64_t)entries.size();
    for (int64_t i = 0; i < total;) {
        int64_t j = i + 1;
        while (j < total && entry_eq(entries[i], entries[j])) j++;
        n++;
        i = j;
    }

    uint64_t* hi = (uint64_t*)malloc(sizeof(uint64_t) * (n ? n : 1));
    uint64_t* lo = (uint64_t*)malloc(sizeof(uint64_t) * (n ? n : 1));
    uint32_t* cov = (uint32_t*)malloc(sizeof(uint32_t) * (n ? n : 1));
    uint8_t* im = (uint8_t*)malloc(n ? n : 1);
    uint8_t* om = (uint8_t*)malloc(n ? n : 1);
    if (!hi || !lo || !cov || !im || !om) return -1;

    int64_t w = 0;
    for (int64_t i = 0; i < total;) {
        int64_t j = i;
        uint64_t c = 0;
        uint8_t mi = 0, mo = 0;
        while (j < total && entry_eq(entries[i], entries[j])) {
            c++;
            mi |= entries[j].in_mask;
            mo |= entries[j].out_mask;
            j++;
        }
        hi[w] = entries[i].hi;
        lo[w] = entries[i].lo;
        cov[w] = (uint32_t)(c > 0xFFFFFFFFULL ? 0xFFFFFFFFULL : c);
        im[w] = mi;
        om[w] = mo;
        w++;
        i = j;
    }

    *out_hi = hi;
    *out_lo = lo;
    *out_cov = cov;
    *out_in = im;
    *out_out = om;
    return n;
}

// Affine-gap Gotoh DP fill (EDNAFULL 5/-4, gap 10+0.5k), exact twin of the
// numpy wavefront in models/sw.py::_gotoh — same init, same tie-breaking
// (gap-extend wins only on strictly greater), same local clamp-to-zero with
// traceback code 3.  Traceback itself stays in Python (it walks one path).
int ct_gotoh_fill(const char* q, int64_t n, const char* s, int64_t m, int local,
                  double* H, int8_t* tbH, int8_t* tbE, int8_t* tbF) {
    const double MATCH = 5.0, MISMATCH = -4.0, GO = 10.0, GE = 0.5;
    const double NEG = -1e30;
    auto code = [](char c) -> int {
        switch (c) {
            case 'A': case 'a': return 0;
            case 'C': case 'c': return 1;
            case 'G': case 'g': return 2;
            case 'T': case 't': return 3;
        }
        return 4;
    };
    const int64_t W = m + 1;
    // the downstream traceback reads only H and the tb matrices; E and F are
    // kept as a rolling row (F) and a running scalar (E) to halve memory
    // traffic — the fill is bandwidth-bound
    double* Fprev = (double*)malloc(sizeof(double) * W);
    for (int64_t j = 0; j <= m; j++) Fprev[j] = NEG;

    // boundaries (row 0 / column 0) — the interior is written by the main loop
    for (int64_t j = 0; j <= m; j++) { tbH[j] = 0; tbE[j] = 0; tbF[j] = 0; }
    for (int64_t i = 1; i <= n; i++) {
        tbH[i * W] = 0; tbE[i * W] = 0; tbF[i * W] = 0;
    }
    if (local) {
        for (int64_t j = 0; j <= m; j++) H[j] = 0.0;
        for (int64_t i = 1; i <= n; i++) H[i * W] = 0.0;
    } else {
        H[0] = 0.0;
        for (int64_t j = 1; j <= m; j++) {
            H[j] = -(GO + GE * (double)j);
            tbH[j] = 1;
            tbE[j] = j > 1 ? 1 : 0;
        }
        for (int64_t i = 1; i <= n; i++) {
            H[i * W] = -(GO + GE * (double)i);
            tbH[i * W] = 2;
            tbF[i * W] = i > 1 ? 1 : 0;
        }
    }
    for (int64_t i = 1; i <= n; i++) {
        const int qc = code(q[i - 1]);
        double e = NEG;  // E[i][0]
        double h_left = H[i * W];
        for (int64_t j = 1; j <= m; j++) {
            const int scd = code(s[j - 1]);
            const double sub = (qc == scd && qc < 4) ? MATCH : MISMATCH;
            const double e_open = h_left - (GO + GE);
            const double e_ext = e - GE;
            e = e_open >= e_ext ? e_open : e_ext;
            tbE[i * W + j] = e_ext > e_open ? 1 : 0;
            const double f_open = H[(i - 1) * W + j] - (GO + GE);
            const double f_ext = (i == 1 ? NEG : Fprev[j]) - GE;
            const double f = f_open >= f_ext ? f_open : f_ext;
            Fprev[j] = f;
            tbF[i * W + j] = f_ext > f_open ? 1 : 0;
            const double diag = H[(i - 1) * W + (j - 1)] + sub;
            double best = diag;
            int8_t tb = 0;
            if (e > best) { best = e; tb = 1; }
            if (f > best) { best = f; tb = 2; }
            if (local && best < 0) { best = 0.0; tb = 3; }
            H[i * W + j] = best;
            tbH[i * W + j] = tb;
            h_left = best;
        }
    }
    free(Fprev);
    return 0;
}

// K-way merge of sorted key runs into the sorted unique union.
//   hi/lo:    concatenated run keys (each run sorted ascending by (hi, lo))
//   offsets:  nruns+1 boundaries into hi/lo
// Outputs (malloc'd, caller frees via ct_free):
//   out_hi/out_lo: union keys (return value = count)
//   out_idx:       for every input key (concatenated order) its index in the
//                  union — the scatter map for per-run payload columns.
// The linear multi-way merge replaces the host sort in `join` (the reference
// merges graphs via CortexCollection / Join, CortexCollection.java:34-63):
// O(total * log(nruns)) with no comparison-sort constant.
int64_t ct_merge_runs(const uint64_t* hi, const uint64_t* lo,
                      const int64_t* offsets, int64_t nruns,
                      uint64_t** out_hi, uint64_t** out_lo,
                      int64_t** out_idx) {
    const int64_t total = offsets[nruns];
    uint64_t* uhi = (uint64_t*)malloc(sizeof(uint64_t) * (total ? total : 1));
    uint64_t* ulo = (uint64_t*)malloc(sizeof(uint64_t) * (total ? total : 1));
    int64_t* idx = (int64_t*)malloc(sizeof(int64_t) * (total ? total : 1));
    if (!uhi || !ulo || !idx) return -1;

    std::vector<int64_t> cur(nruns);
    for (int64_t r = 0; r < nruns; r++) cur[r] = offsets[r];

    // binary heap of (key, run); run index breaks ties so equal keys pop in
    // run order (irrelevant to the result, deterministic regardless)
    struct Node { uint64_t hi, lo; int64_t run; };
    auto node_gt = [](const Node& a, const Node& b) {
        if (a.hi != b.hi) return a.hi > b.hi;
        if (a.lo != b.lo) return a.lo > b.lo;
        return a.run > b.run;
    };
    std::vector<Node> heap;
    heap.reserve(nruns);
    for (int64_t r = 0; r < nruns; r++)
        if (cur[r] < offsets[r + 1])
            heap.push_back({hi[cur[r]], lo[cur[r]], r});
    std::make_heap(heap.begin(), heap.end(), node_gt);

    int64_t n = 0;
    bool have_prev = false;
    uint64_t phi = 0, plo = 0;
    while (!heap.empty()) {
        std::pop_heap(heap.begin(), heap.end(), node_gt);
        Node t = heap.back();
        heap.pop_back();
        if (!have_prev || t.hi != phi || t.lo != plo) {
            uhi[n] = t.hi;
            ulo[n] = t.lo;
            phi = t.hi; plo = t.lo;
            have_prev = true;
            n++;
        }
        idx[cur[t.run]] = n - 1;
        cur[t.run]++;
        if (cur[t.run] < offsets[t.run + 1]) {
            heap.push_back({hi[cur[t.run]], lo[cur[t.run]], t.run});
            std::push_heap(heap.begin(), heap.end(), node_gt);
        }
    }
    *out_hi = uhi;
    *out_lo = ulo;
    *out_idx = idx;
    return n;
}

// ---------------------------------------------------------------------------
// Batched de Bruijn walks over an open-addressing (canonical kmer -> edge
// byte) table: the host twin of ops/cuckoo.py walk_forward_spec with the
// exact device semantics (single-successor advance, Brent cycle flagging,
// -1 padding) so walk.replay_walk decodes both streams identically.
// Replaces the one-vertex-at-a-time reference cursor
// (TraversalEngine.java:241-319 over CortexGraph.findRecord binary search).

struct WalkSlot {           // one cache line covers ~2.6 slots: a probe is
    uint64_t hi, lo;        // one memory access, not four (hi/lo/edge/used
    uint8_t edge, used;     // were separate arrays before)
    uint8_t pad[6];
};

struct WalkTable {
    std::vector<WalkSlot> slots;
    uint64_t mask;
    int32_t k;
};

namespace {

inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33; x *= 0xFF51AFD7ED558CCDULL;
    x ^= x >> 33; x *= 0xC4CEB9FE1A85EC53ULL;
    x ^= x >> 33;
    return x;
}

}  // namespace

void* ct_walk_table_build(const uint64_t* khi, const uint64_t* klo,
                          const uint8_t* edges, int64_t n, int32_t k) {
    WalkTable* t = new WalkTable();
    uint64_t cap = 16;
    while (cap < (uint64_t)(n * 2 + 1)) cap <<= 1;
    t->slots.assign(cap, WalkSlot{0, 0, 0, 0, {0}});
    t->mask = cap - 1;
    t->k = k;
    for (int64_t i = 0; i < n; i++) {
        uint64_t h = mix64(khi[i] ^ mix64(klo[i])) & t->mask;
        while (t->slots[h].used) h = (h + 1) & t->mask;
        WalkSlot& s = t->slots[h];
        s.used = 1;
        s.hi = khi[i];
        s.lo = klo[i];
        s.edge = edges[i];
    }
    return t;
}

void ct_walk_table_free(void* p) { delete (WalkTable*)p; }

void ct_walk(void* table, const uint64_t* seed_hi, const uint64_t* seed_lo,
             int64_t b, int32_t max_steps,
             int8_t* out_bases /* [b * max_steps] */, uint8_t* out_cycled,
             int32_t* out_steps) {
    const WalkTable* t = (const WalkTable*)table;
    const int32_t k = t->k;
    const int shift_top = 2 * (k - 1);
    const bool one_word = k <= 32;
    const uint64_t lo_mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const uint64_t hi_mask = (k <= 32) ? 0ULL
                            : ((k == 64) ? ~0ULL : ((1ULL << (2 * (k - 32))) - 1));

    // Walks advance in interleaved blocks so the BW probe loads per round
    // are independent — the out-of-order window overlaps their cache misses,
    // where a per-walk loop would serialize one miss per step.
    constexpr int BW = 16;
    struct WState {
        uint64_t fhi, flo, rhi, rlo, saved_hi, saved_lo;
        int64_t power, lam;
        int32_t steps;
        uint8_t cycled, done;
    };

    for (int64_t blk = 0; blk < b; blk += BW) {
        const int nw = (int)(b - blk < BW ? b - blk : BW);
        WState st[BW];
        for (int w = 0; w < nw; w++) {
            WState& s = st[w];
            s.fhi = seed_hi[blk + w];
            s.flo = seed_lo[blk + w];
            // build the rc of the seed once; afterwards both orientations
            // update incrementally per step
            uint64_t rhi = 0, rlo = 0;
            for (int32_t i = 0; i < k; i++) {
                const int sh = 2 * i;
                const uint64_t base =
                    (sh >= 64 ? (s.fhi >> (sh - 64)) : (s.flo >> sh)) & 3ULL;
                rhi = (rhi << 2) | (rlo >> 62);
                rlo = (rlo << 2) | (3 - base);
            }
            rhi &= hi_mask;
            if (one_word) { rlo &= lo_mask; rhi = 0; }
            s.rhi = rhi; s.rlo = rlo;
            s.saved_hi = s.fhi; s.saved_lo = s.flo;
            s.power = 1; s.lam = 0; s.steps = 0; s.cycled = 0; s.done = 0;
        }

        int remaining = nw;
        while (remaining > 0) {
            // phase 1: compute every live walk's probe start (independent)
            uint64_t hs[BW], chis[BW], clos[BW];
            bool flip[BW];
            for (int w = 0; w < nw; w++) {
                const WState& s = st[w];
                if (s.done) continue;
                const bool flipped = one_word ? (s.rlo < s.flo)
                                   : (s.rhi != s.fhi ? s.rhi < s.fhi
                                                     : s.rlo < s.flo);
                chis[w] = flipped ? s.rhi : s.fhi;
                clos[w] = flipped ? s.rlo : s.flo;
                flip[w] = flipped;
                hs[w] = mix64(chis[w] ^ mix64(clos[w])) & t->mask;
                __builtin_prefetch(&t->slots[hs[w]], 0, 1);
            }
            // phase 2: probe + advance
            for (int w = 0; w < nw; w++) {
                WState& s = st[w];
                if (s.done) continue;
                uint64_t h = hs[w];
                const uint64_t chi = chis[w], clo = clos[w];
                uint8_t e = 0;
                bool found = false;
                while (t->slots[h].used) {
                    const WalkSlot& sl = t->slots[h];
                    if (sl.hi == chi && sl.lo == clo) {
                        e = sl.edge;
                        found = true;
                        break;
                    }
                    h = (h + 1) & t->mask;
                }
                const uint8_t next_mask = flip[w] ? (e >> 4) : (e & 0xF);
                if (!found || next_mask == 0 ||
                    (next_mask & (next_mask - 1))) {
                    s.done = 1; remaining--; continue;
                }
                int base = 0;
                while (!((next_mask >> base) & 1)) base++;
                const uint64_t nfhi = ((s.fhi << 2) | (s.flo >> 62)) & hi_mask;
                uint64_t nflo = (s.flo << 2) | (uint64_t)base;
                if (one_word) nflo &= lo_mask;
                const uint64_t nf_hi = one_word ? 0 : nfhi;
                // Brent: stop (flag cycle, emit nothing) when the successor
                // is the anchor
                if (nf_hi == s.saved_hi && nflo == s.saved_lo) {
                    s.cycled = 1; s.done = 1; remaining--; continue;
                }
                uint64_t nrlo = (s.rlo >> 2) | (s.rhi << 62);
                uint64_t nrhi = s.rhi >> 2;
                const uint64_t cb = 3 - (uint64_t)base;
                if (shift_top >= 64) nrhi |= cb << (shift_top - 64);
                else nrlo |= cb << shift_top;
                if (one_word) { nrlo &= lo_mask; nrhi = 0; }
                else { nrhi &= hi_mask; }

                out_bases[(blk + w) * (int64_t)max_steps + s.steps] =
                    (int8_t)base;
                s.steps++;
                s.fhi = nf_hi; s.flo = nflo; s.rhi = nrhi; s.rlo = nrlo;
                if (s.power == s.lam) {
                    s.saved_hi = s.fhi; s.saved_lo = s.flo;
                    s.power *= 2;
                    s.lam = 0;
                }
                s.lam++;
                if (s.steps >= max_steps) { s.done = 1; remaining--; }
            }
        }
        for (int w = 0; w < nw; w++) {
            int8_t* bases = out_bases + (blk + w) * (int64_t)max_steps;
            for (int32_t i = st[w].steps; i < max_steps; i++) bases[i] = -1;
            out_cycled[blk + w] = st[w].cycled;
            out_steps[blk + w] = st[w].steps;
        }
    }
}

void ct_free(void* p) { free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Edge inference / restriction (`mccortex inferedges`): per color, set an
// edge bit wherever both adjacent kmers exist (mode 0) or clear bits pointing
// at absent kmers (mode 1, used after cleaning).  Twin of the numpy loop in
// build.py::infer_edges (8 full-graph binary-search sweeps there; one
// open-addressing probe per candidate edge here).

extern "C" {

void ct_infer_edges(const uint64_t* khi, const uint64_t* klo,
                    const uint8_t* present, uint8_t* edges,
                    int64_t n, int32_t k, int32_t mode) {
    if (k <= 0 || k > 64 || n == 0) return;
    const int shift_top = 2 * (k - 1);
    const bool one_word = k <= 32;
    const uint64_t lo_mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const uint64_t hi_mask = (k <= 32) ? 0ULL
                            : ((k == 64) ? ~0ULL : ((1ULL << (2 * (k - 32))) - 1));

    // index table at ~0.66 load: (hi, lo, idx), idx == UINT32_MAX empty
    struct IdxSlot { uint64_t hi, lo; uint32_t idx; };
    uint64_t cap = 16;
    while (cap < (uint64_t)(n + n / 2 + 1)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<IdxSlot> slots(cap, IdxSlot{0, 0, 0xFFFFFFFFu});
    for (int64_t i = 0; i < n; i++) {
        uint64_t h = mix64(khi[i] ^ mix64(klo[i])) & mask;
        while (slots[h].idx != 0xFFFFFFFFu) h = (h + 1) & mask;
        slots[h] = IdxSlot{khi[i], klo[i], (uint32_t)i};
    }
    auto lookup = [&](uint64_t hi, uint64_t lo) -> int64_t {
        uint64_t h = mix64(hi ^ mix64(lo)) & mask;
        while (slots[h].idx != 0xFFFFFFFFu) {
            if (slots[h].hi == hi && slots[h].lo == lo)
                return (int64_t)slots[h].idx;
            h = (h + 1) & mask;
        }
        return -1;
    };
    static const uint8_t REV4[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                                     1, 9, 5, 13, 3, 11, 7, 15};

    for (int64_t i = 0; i < n; i++) {
        const uint8_t e = edges[i];
        if (!present[i]) {
            if (mode == 1) edges[i] = 0;
            continue;
        }
        const uint8_t out_mask0 = (uint8_t)(e & 0xF);
        const uint8_t in_mask0 = REV4[e >> 4];       // prev-base mask
        // rc of the record kmer, computed once
        const uint64_t fhi = khi[i], flo = klo[i];
        uint64_t rhi = 0, rlo = 0;
        for (int32_t t = 0; t < k; t++) {
            const int sh = 2 * t;
            const uint64_t b = (sh >= 64 ? (fhi >> (sh - 64)) : (flo >> sh)) & 3ULL;
            rhi = (rhi << 2) | (rlo >> 62);
            rlo = (rlo << 2) | (3 - b);
        }
        rhi &= hi_mask;
        if (one_word) { rlo &= lo_mask; rhi = 0; }

        uint8_t out_new = 0, in_new = 0;
        for (int b = 0; b < 4; b++) {
            const bool check_out = mode == 0 || ((out_mask0 >> b) & 1);
            const bool check_in = mode == 0 || ((in_mask0 >> b) & 1);
            if (check_out) {
                // successor: shift left, append b; rc: shift right, prepend 3-b
                uint64_t shi = ((fhi << 2) | (flo >> 62)) & hi_mask;
                uint64_t slo = (flo << 2) | (uint64_t)b;
                if (one_word) { slo &= lo_mask; shi = 0; }
                uint64_t srlo = (rlo >> 2) | (rhi << 62);
                uint64_t srhi = rhi >> 2;
                const uint64_t cb = 3 - (uint64_t)b;
                if (shift_top >= 64) srhi |= cb << (shift_top - 64);
                else srlo |= cb << shift_top;
                if (one_word) { srlo &= lo_mask; srhi = 0; }
                else { srhi &= hi_mask; }
                const bool fwd = one_word ? (slo <= srlo)
                               : (shi != srhi ? shi < srhi : slo <= srlo);
                const int64_t j = lookup(fwd ? shi : srhi, fwd ? slo : srlo);
                if (j >= 0 && present[j]) out_new |= (uint8_t)(1u << b);
            }
            if (check_in) {
                // predecessor: shift right, prepend b at the top
                uint64_t plo = (flo >> 2) | (fhi << 62);
                uint64_t phi = fhi >> 2;
                if (shift_top >= 64) phi |= ((uint64_t)b) << (shift_top - 64);
                else plo |= ((uint64_t)b) << shift_top;
                if (one_word) { plo &= lo_mask; phi = 0; }
                else { phi &= hi_mask; }
                uint64_t prhi = ((rhi << 2) | (rlo >> 62)) & hi_mask;
                uint64_t prlo = (rlo << 2) | (3 - (uint64_t)b);
                if (one_word) { prlo &= lo_mask; prhi = 0; }
                const bool fwd = one_word ? (plo <= prlo)
                               : (phi != prhi ? phi < prhi : plo <= prlo);
                const int64_t j = lookup(fwd ? phi : prhi, fwd ? plo : prlo);
                if (j >= 0 && present[j]) in_new |= (uint8_t)(1u << b);
            }
        }
        uint8_t inferred = (uint8_t)((REV4[in_new] << 4) | out_new);
        edges[i] = mode == 1 ? (uint8_t)(e & inferred)
                             : (uint8_t)(e | inferred);
    }
}

// Unitig decomposition: union-find over unambiguous adjacencies (out-degree 1
// from a record's orientation AND in-degree 1 into the successor's
// orientation).  Twin of `mccortex clean`'s unitig model (the reference WDL
// runs `mccortex63 clean -B 2`, Simulate.wdl:620-666: auto coverage threshold
// over UNITIGS, not kmers): every maximal single-path chain gets one root id
// in out_root so the caller can threshold whole unitigs by their mean
// coverage.
void ct_unitig_roots(const uint64_t* khi, const uint64_t* klo,
                     const uint8_t* edges, int64_t n, int32_t k,
                     int64_t* out_root) {
    if (n == 0) return;
    const int shift_top = 2 * (k - 1);
    const bool one_word = k <= 32;
    const uint64_t lo_mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const uint64_t hi_mask = (k <= 32) ? 0ULL
                            : ((k == 64) ? ~0ULL : ((1ULL << (2 * (k - 32))) - 1));

    struct IdxSlot { uint64_t hi, lo; uint32_t idx; };
    uint64_t cap = 16;
    while (cap < (uint64_t)(n + n / 2 + 1)) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<IdxSlot> slots(cap, IdxSlot{0, 0, 0xFFFFFFFFu});
    for (int64_t i = 0; i < n; i++) {
        uint64_t h = mix64(khi[i] ^ mix64(klo[i])) & mask;
        while (slots[h].idx != 0xFFFFFFFFu) h = (h + 1) & mask;
        slots[h] = IdxSlot{khi[i], klo[i], (uint32_t)i};
    }
    auto lookup = [&](uint64_t hi, uint64_t lo) -> int64_t {
        uint64_t h = mix64(hi ^ mix64(lo)) & mask;
        while (slots[h].idx != 0xFFFFFFFFu) {
            if (slots[h].hi == hi && slots[h].lo == lo)
                return (int64_t)slots[h].idx;
            h = (h + 1) & mask;
        }
        return -1;
    };

    std::vector<int64_t> up(n);
    for (int64_t i = 0; i < n; i++) up[i] = i;
    auto find = [&](int64_t x) {
        while (up[x] != x) { up[x] = up[up[x]]; x = up[x]; }
        return x;
    };

    for (int64_t i = 0; i < n; i++) {
        const uint8_t e = edges[i];
        const uint64_t fhi = khi[i], flo = klo[i];
        // rc of the record kmer, computed once
        uint64_t rhi = 0, rlo = 0;
        for (int32_t t = 0; t < k; t++) {
            const int sh = 2 * t;
            const uint64_t b = (sh >= 64 ? (fhi >> (sh - 64)) : (flo >> sh)) & 3ULL;
            rhi = (rhi << 2) | (rlo >> 62);
            rlo = (rlo << 2) | (3 - b);
        }
        rhi &= hi_mask;
        if (one_word) { rlo &= lo_mask; rhi = 0; }

        for (int flip = 0; flip < 2; flip++) {
            const uint8_t nm = flip ? (uint8_t)(e >> 4) : (uint8_t)(e & 0xF);
            if (!nm || (nm & (nm - 1))) continue;     // out-degree != 1
            int b = 0;
            while (!((nm >> b) & 1)) b++;
            // walk kmer = flip ? rc : fwd; successor = shift-append b
            const uint64_t whi = flip ? rhi : fhi;
            const uint64_t wlo = flip ? rlo : flo;
            const uint64_t vhi = flip ? fhi : rhi;    // rc of walk kmer
            const uint64_t vlo = flip ? flo : rlo;
            uint64_t shi = ((whi << 2) | (wlo >> 62)) & hi_mask;
            uint64_t slo = (wlo << 2) | (uint64_t)b;
            if (one_word) { slo &= lo_mask; shi = 0; }
            uint64_t srlo = (vlo >> 2) | (vhi << 62);
            uint64_t srhi = vhi >> 2;
            const uint64_t cb = 3 - (uint64_t)b;
            if (shift_top >= 64) srhi |= cb << (shift_top - 64);
            else srlo |= cb << shift_top;
            if (one_word) { srlo &= lo_mask; srhi = 0; }
            else { srhi &= hi_mask; }
            const bool sflip = one_word ? (srlo < slo)
                             : (srhi != shi ? srhi < shi : srlo < slo);
            const int64_t j = lookup(sflip ? srhi : shi, sflip ? srlo : slo);
            if (j < 0) continue;
            const uint8_t ej = edges[j];
            const uint8_t back = sflip ? (uint8_t)(ej & 0xF)
                                       : (uint8_t)(ej >> 4);
            if (back && !(back & (back - 1))) {       // in-degree 1: same unitig
                const int64_t ra = find(i), rb = find(j);
                if (ra != rb) up[rb] = ra;
            }
        }
    }
    for (int64_t i = 0; i < n; i++) out_root[i] = find(i);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host linked walker: exact McCortex link-following with an UNBOUNDED link
// store (twin of traversal/linkstore.py == LinkStore.java:58-144 and the
// engine cursor TraversalEngine.java:241-279).  This is the correctness
// oracle at native speed: no per-walk capacity caps, no XLA compile — the
// production path for small seed batches and for device-cap overflow replay.

namespace {

struct LWSlot { uint64_t hi, lo; int64_t idx; };

struct LinksWalkTable {
    std::vector<LWSlot> slots;
    uint64_t mask;
    int32_t k;
    std::vector<uint8_t> edges;    // combined edge byte per record
    std::vector<int64_t> loff;     // n+1 CSR into records
    std::vector<uint8_t> lfw;      // P
    std::vector<int64_t> choff;    // P+1 CSR into pool
    std::vector<uint8_t> pool;     // junction-choice codes 0..3
};

struct LSElement { int32_t age, pos; };

struct LSGroup {
    const uint8_t* junc;           // pool pointer (forward walks: identity)
    int32_t len;
    std::vector<LSElement> els;    // empty == dead group
};

struct Key128 {
    uint64_t hi, lo;
    bool operator==(const Key128& o) const { return hi == o.hi && lo == o.lo; }
};
struct Key128Hash {
    size_t operator()(const Key128& x) const {
        return (size_t)mix64(x.hi ^ mix64(x.lo));
    }
};

// Exact single-step cursor (TraversalEngine.java:241-279 + LinkStore.java:
// 58-144): seek resets link store + seen set and computes the single next
// base by degree; advance() moves one step, feeding the link store and
// resolving junctions by oldest-agreement link choice.  Shared by the
// batched chain walker (ct_walk_links_host) and the DFS probes
// (ct_dfs_dest).
struct LinkCursor {
    const LinksWalkTable* t;
    int32_t k, shift_top;
    bool one_word;
    uint64_t lo_mask, hi_mask;
    uint64_t fhi, flo, rhi, rlo;   // cursor kmer, walk orientation + rc
    int next_base;                 // -1 == no single advance
    bool initialized;
    int32_t junctions;             // link-resolved junction advances
    std::vector<LSGroup> groups;
    std::unordered_set<Key128, Key128Hash> seen;

    explicit LinkCursor(const LinksWalkTable* tt)
        : t(tt), k(tt->k), shift_top(2 * (tt->k - 1)), one_word(tt->k <= 32),
          lo_mask((tt->k >= 32) ? ~0ULL : ((1ULL << (2 * tt->k)) - 1)),
          hi_mask((tt->k <= 32) ? 0ULL
                  : ((tt->k == 64) ? ~0ULL
                                   : ((1ULL << (2 * (tt->k - 32))) - 1))),
          fhi(0), flo(0), rhi(0), rlo(0), next_base(-1), initialized(false),
          junctions(0) {}

    int64_t lookup(uint64_t chi, uint64_t clo) const {
        uint64_t h = mix64(chi ^ mix64(clo)) & t->mask;
        while (t->slots[h].idx >= 0) {
            if (t->slots[h].hi == chi && t->slots[h].lo == clo)
                return t->slots[h].idx;
            h = (h + 1) & t->mask;
        }
        return -1;
    }

    void compute_rc() {
        uint64_t xhi = 0, xlo = 0;
        for (int32_t i = 0; i < k; i++) {
            const int sh = 2 * i;
            const uint64_t base =
                (sh >= 64 ? (fhi >> (sh - 64)) : (flo >> sh)) & 3ULL;
            xhi = (xhi << 2) | (xlo >> 62);
            xlo = (xlo << 2) | (3 - base);
        }
        rhi = xhi & hi_mask;
        rlo = xlo;
        if (one_word) { rlo &= lo_mask; rhi = 0; }
    }

    // out-edge mask of an arbitrary kmer given walk orientation + its rc
    uint8_t next_mask_of(uint64_t xfhi, uint64_t xflo,
                         uint64_t xrhi, uint64_t xrlo) const {
        const bool flipped = one_word ? (xrlo < xflo)
                           : (xrhi != xfhi ? xrhi < xfhi : xrlo < xflo);
        const int64_t idx = lookup(flipped ? xrhi : xfhi,
                                   flipped ? xrlo : xflo);
        const uint8_t e = idx >= 0 ? t->edges[idx] : 0;
        return flipped ? (uint8_t)(e >> 4) : (uint8_t)(e & 0xF);
    }

    void seek(uint64_t shi, uint64_t slo) {
        fhi = shi; flo = slo;
        compute_rc();
        groups.clear();
        seen.clear();
        initialized = false;
        junctions = 0;
        const uint8_t nm = next_mask_of(fhi, flo, rhi, rlo);
        next_base = -1;
        if (nm && !(nm & (nm - 1))) {
            next_base = 0;
            while (!((nm >> next_base) & 1)) next_base++;
        }
    }

    bool has_next() const { return next_base >= 0; }

    bool store_active() const {
        for (const LSGroup& g : groups) if (!g.els.empty()) return true;
        return false;
    }
    int num_new_paths() const {
        int n2 = 0;
        for (const LSGroup& g : groups)
            for (const LSElement& e : g.els) if (e.age == 0) n2++;
        return n2;
    }
    void increment_ages() {
        for (LSGroup& g : groups)
            for (LSElement& e : g.els) e.age++;
    }

    // add links of the kmer (walk orientation) — linkstore.py::add with
    // go_forward=True: keep records with (not flipped) == rec.fw, junction
    // codes untransformed
    void add_links(uint64_t wfhi, uint64_t wflo,
                   uint64_t wrhi, uint64_t wrlo) {
        const bool flipped = one_word ? (wrlo < wflo)
                           : (wrhi != wfhi ? wrhi < wfhi : wrlo < wflo);
        const uint64_t chi = flipped ? wrhi : wfhi;
        const uint64_t clo = flipped ? wrlo : wflo;
        const int64_t idx = lookup(chi, clo);
        if (idx < 0) return;
        for (int64_t r = t->loff[idx]; r < t->loff[idx + 1]; r++) {
            if (((uint8_t)(!flipped)) != t->lfw[r]) continue;
            const uint8_t* junc = t->pool.data() + t->choff[r];
            const int32_t len = (int32_t)(t->choff[r + 1] - t->choff[r]);
            // group by junction string, insertion-ordered; dead groups are
            // skipped so a re-added key lands at the end (matching Python
            // dict delete-then-setdefault)
            bool found = false;
            for (LSGroup& g : groups) {
                if (!g.els.empty() && g.len == len
                    && memcmp(g.junc, junc, (size_t)len) == 0) {
                    g.els.push_back(LSElement{0, 0});
                    found = true;
                    break;
                }
            }
            if (!found) {
                groups.push_back(LSGroup{junc, len, {LSElement{0, 0}}});
            }
        }
    }

    // oldest-agreement junction choice + consume; -1 when ambiguous or
    // store empty (linkstore.py::next_junction_choice/_consume)
    int next_junction_choice() {
        int32_t max_age = -1;
        for (const LSGroup& g : groups)
            for (const LSElement& e : g.els)
                if (e.age > max_age) max_age = e.age;
        if (max_age < 0) return -1;
        int agree_char = -2;
        const LSGroup* first_oldest_group = nullptr;
        for (const LSGroup& g : groups) {
            for (const LSElement& e : g.els) {
                if (e.age != max_age || e.pos >= g.len) continue;
                if (!first_oldest_group) first_oldest_group = &g;
                const int c = g.junc[e.pos];
                if (agree_char == -2) agree_char = c;
                else if (agree_char != c) return -1;
            }
        }
        if (!first_oldest_group || agree_char < 0) return -1;
        // the emitted char comes from the LAST element of the chosen
        // junction list (LinkStore.java:128-131); at most one live group per
        // junction string, and the first oldest element lives in it
        const LSGroup& cg = *first_oldest_group;
        const int choice = cg.junc[cg.els.back().pos];
        for (LSGroup& g : groups) {
            std::vector<LSElement> keep;
            for (LSElement& e : g.els) {
                if (e.pos + 1 >= g.len || g.junc[e.pos] != (uint8_t)choice)
                    continue;
                e.pos++;
                keep.push_back(e);
            }
            g.els.swap(keep);
        }
        return choice;
    }

    // Move one step (requires has_next()); returns the base advanced over
    // and leaves the cursor at the new kmer with next_base set for the
    // following step (TraversalEngine.next semantics).
    int advance() {
        const int base = next_base;
        if (!initialized) { add_links(fhi, flo, rhi, rlo); initialized = true; }
        uint64_t nfhi = ((fhi << 2) | (flo >> 62)) & hi_mask;
        uint64_t nflo = (flo << 2) | (uint64_t)base;
        if (one_word) { nflo &= lo_mask; nfhi = 0; }
        uint64_t nrlo = (rlo >> 2) | (rhi << 62);
        uint64_t nrhi = rhi >> 2;
        const uint64_t cb = 3 - (uint64_t)base;
        if (shift_top >= 64) nrhi |= cb << (shift_top - 64);
        else nrlo |= cb << shift_top;
        if (one_word) { nrlo &= lo_mask; nrhi = 0; }
        else { nrhi &= hi_mask; }

        add_links(nfhi, nflo, nrhi, nrlo);     // _update_link_store
        fhi = nfhi; flo = nflo; rhi = nrhi; rlo = nrlo;

        const uint8_t nm = next_mask_of(fhi, flo, rhi, rlo);
        const int deg = __builtin_popcount(nm);
        next_base = -1;
        if (deg == 1) {
            int nb = 0;
            while (!((nm >> nb) & 1)) nb++;
            uint64_t phi = ((fhi << 2) | (flo >> 62)) & hi_mask;
            uint64_t plo = (flo << 2) | (uint64_t)nb;
            if (one_word) { plo &= lo_mask; phi = 0; }
            Key128 key{phi, plo};
            if (!seen.count(key) || store_active()) {
                next_base = nb;
                seen.insert(key);
            }
        } else if (deg > 1) {
            const int choice = next_junction_choice();
            if (choice >= 0 && ((nm >> choice) & 1)) {
                next_base = choice;
                junctions++;
            }
            increment_ages();
        }
        if (num_new_paths() > 0) increment_ages();
        return base;
    }
};

}  // namespace

extern "C" {

void* ct_links_walker_build(const uint64_t* khi, const uint64_t* klo,
                            const uint8_t* edges, int64_t n, int32_t k,
                            const int64_t* loff, const uint8_t* lfw,
                            const int64_t* choff, int64_t nrecs,
                            const uint8_t* chpool, int64_t pool_len) {
    LinksWalkTable* t = new LinksWalkTable();
    uint64_t cap = 16;
    while (cap < (uint64_t)(n + n / 2 + 1)) cap <<= 1;
    t->slots.assign(cap, LWSlot{0, 0, -1});
    t->mask = cap - 1;
    t->k = k;
    for (int64_t i = 0; i < n; i++) {
        uint64_t h = mix64(khi[i] ^ mix64(klo[i])) & t->mask;
        while (t->slots[h].idx >= 0) h = (h + 1) & t->mask;
        t->slots[h] = LWSlot{khi[i], klo[i], i};
    }
    t->edges.assign(edges, edges + n);
    t->loff.assign(loff, loff + n + 1);
    t->lfw.assign(lfw, lfw + (nrecs ? nrecs : 0));
    t->choff.assign(choff, choff + nrecs + 1);
    t->pool.assign(chpool, chpool + pool_len);
    return t;
}

void ct_links_walker_free(void* p) { delete (LinksWalkTable*)p; }

// Forward walks with link following; reverse = walk from the revcomp seed.
// out_bases: int8[b * max_steps] (-1 padded); out_junctions counts junction
// advances resolved by a link choice.
void ct_walk_links_host(void* handle, const uint64_t* shi, const uint64_t* slo,
                        int64_t b, int32_t max_steps,
                        int8_t* out_bases, int32_t* out_steps,
                        int32_t* out_junctions) {
    const LinksWalkTable* t = (const LinksWalkTable*)handle;
    LinkCursor cur(t);
    for (int64_t wi = 0; wi < b; wi++) {
        int8_t* bases = out_bases + wi * (int64_t)max_steps;
        for (int32_t i = 0; i < max_steps; i++) bases[i] = -1;
        cur.seek(shi[wi], slo[wi]);
        int32_t steps = 0;
        while (cur.has_next() && steps < max_steps) {
            bases[steps] = (int8_t)cur.advance();
            steps++;
        }
        out_steps[wi] = steps;
        out_junctions[wi] = cur.junctions;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched DFS probes with DestinationStopper semantics — the closeGaps hot
// path (Call.java:2232-2263): exact twin of traversal/engine.py::_dfs_branch
// (TraversalEngine.java:355-481) with stopping.DestinationStopper — junction
// budget decays exponentially with accumulated graph size; a probe succeeds
// on reaching the sink kmer.  REVERSE probes are run by the caller as
// forward probes from the revcomp seed (the equivalence the batched chain
// walker already relies on).

namespace {

struct KOps {
    const LinksWalkTable* t;
    int32_t k, shift_top;
    bool one_word;
    uint64_t lo_mask, hi_mask;
    explicit KOps(const LinksWalkTable* tt)
        : t(tt), k(tt->k), shift_top(2 * (tt->k - 1)), one_word(tt->k <= 32),
          lo_mask((tt->k >= 32) ? ~0ULL : ((1ULL << (2 * tt->k)) - 1)),
          hi_mask((tt->k <= 32) ? 0ULL
                  : ((tt->k == 64) ? ~0ULL
                                   : ((1ULL << (2 * (tt->k - 32))) - 1))) {}

    int64_t lookup(uint64_t chi, uint64_t clo) const {
        uint64_t h = mix64(chi ^ mix64(clo)) & t->mask;
        while (t->slots[h].idx >= 0) {
            if (t->slots[h].hi == chi && t->slots[h].lo == clo)
                return t->slots[h].idx;
            h = (h + 1) & t->mask;
        }
        return -1;
    }

    void rc_of(uint64_t fh, uint64_t fl, uint64_t& rh, uint64_t& rl) const {
        uint64_t xhi = 0, xlo = 0;
        for (int32_t i = 0; i < k; i++) {
            const int sh = 2 * i;
            const uint64_t base =
                (sh >= 64 ? (fh >> (sh - 64)) : (fl >> sh)) & 3ULL;
            xhi = (xhi << 2) | (xlo >> 62);
            xlo = (xlo << 2) | (3 - base);
        }
        rh = xhi & hi_mask;
        rl = xlo;
        if (one_word) { rl &= lo_mask; rh = 0; }
    }

    uint8_t next_mask(uint64_t fh, uint64_t fl) const {
        uint64_t rh, rl;
        rc_of(fh, fl, rh, rl);
        const bool flipped = one_word ? (rl < fl)
                           : (rh != fh ? rh < fh : rl < fl);
        const int64_t idx = lookup(flipped ? rh : fh, flipped ? rl : fl);
        const uint8_t e = idx >= 0 ? t->edges[idx] : 0;
        return flipped ? (uint8_t)(e >> 4) : (uint8_t)(e & 0xF);
    }

    void shift(uint64_t fh, uint64_t fl, int base,
               uint64_t& nh, uint64_t& nl) const {
        nh = ((fh << 2) | (fl >> 62)) & hi_mask;
        nl = (fl << 2) | (uint64_t)base;
        if (one_word) { nl &= lo_mask; nh = 0; }
    }
};

struct VKey {
    uint64_t hi, lo;
    int32_t copy;
    bool operator==(const VKey& o) const {
        return hi == o.hi && lo == o.lo && copy == o.copy;
    }
};
struct VKeyHash {
    size_t operator()(const VKey& v) const {
        return (size_t)mix64(v.hi ^ mix64(v.lo ^ (uint64_t)(uint32_t)v.copy));
    }
};

struct BranchGraph {
    std::unordered_set<VKey, VKeyHash> verts;
    std::vector<std::pair<VKey, VKey>> edges;   // may repeat; Python dedups
    void connect(const VKey& u, const VKey& v) {
        verts.insert(u);
        verts.insert(v);
        edges.emplace_back(u, v);
    }
};

// One DFS branch (engine._dfs_branch, FORWARD).  `visited` is copied per
// branch like the Python set(visited_old); sibling mutations do not leak.
bool dfs_dest_branch(const LinksWalkTable* t, const KOps& ops, VKey cv,
                     int64_t graph_size, int32_t jd,
                     const std::unordered_set<VKey, VKeyHash>& visited_old,
                     uint64_t sink_hi, uint64_t sink_lo, int64_t max_branch,
                     bool use_links, BranchGraph& g) {
    std::unordered_set<VKey, VKeyHash> visited(visited_old);
    LinkCursor cur(t);
    if (use_links) cur.seek(cv.hi, cv.lo);
    bool sticky_succ = false;
    while (true) {
        VKey avs[4];
        int n_avs = 0;
        if (use_links && cur.has_next()) {
            cur.advance();
            int32_t copy = 0;
            while (visited.count(VKey{cur.fhi, cur.flo, copy})) copy++;
            avs[n_avs++] = VKey{cur.fhi, cur.flo, copy};
        } else {
            // raw next neighbors of cv (copy 0) minus visited; base order
            // 0..3 == the dfs sorted-by-kmer child order (shared stem)
            const uint8_t nm = ops.next_mask(cv.hi, cv.lo);
            for (int bb = 0; bb < 4; bb++) {
                if (!((nm >> bb) & 1)) continue;
                VKey nk;
                nk.copy = 0;
                ops.shift(cv.hi, cv.lo, bb, nk.hi, nk.lo);
                if (!visited.count(nk)) avs[n_avs++] = nk;
            }
        }
        const bool prev_visited = visited.count(cv) != 0;
        visited.insert(cv);
        bool going = false;
        if (!prev_visited) {
            const bool succ = (cv.hi == sink_hi && cv.lo == sink_lo);
            const int64_t gs = graph_size + (int64_t)g.verts.size();
            const int64_t jlimit =
                1 + (int64_t)ceil(5.0 * exp(-0.0001 * (double)gs));
            const bool failed = (int64_t)jd > jlimit
                || (int64_t)g.verts.size() > max_branch;
            sticky_succ = succ;
            going = !succ && !failed;
        }
        if (going) {
            if (n_avs == 1) {
                g.connect(cv, avs[0]);
                cv = avs[0];
                continue;
            }
            bool child_ok = false;
            for (int i = 0; i < n_avs; i++) {
                BranchGraph child;
                if (dfs_dest_branch(t, ops, avs[i],
                                    graph_size + (int64_t)g.verts.size(),
                                    jd + 1, visited, sink_hi, sink_lo,
                                    max_branch, use_links, child)) {
                    child.connect(cv, avs[i]);
                    for (const VKey& v : child.verts) g.verts.insert(v);
                    for (auto& e : child.edges) g.edges.push_back(e);
                    child_ok = true;
                }
            }
            return child_ok || (cv.hi == sink_hi && cv.lo == sink_lo);
        }
        return sticky_succ;
    }
}

}  // namespace

extern "C" {

// Batched DestinationStopper DFS probes.  sources/sinks: walk-orientation
// packed kmers (b probes); REVERSE probes are passed pre-revcomped by the
// wrapper.  out_success: uint8[b] (caller-allocated).  Edge outputs are
// malloc'd (caller frees each via ct_free): eoff int64[b+1] CSR over edges,
// u*/v* uint64[E] + int32[E].  Returns E or -1 on allocation failure.
int64_t ct_dfs_dest(void* handle, const uint64_t* shi, const uint64_t* slo,
                    const uint64_t* sink_hi, const uint64_t* sink_lo,
                    int64_t b, int64_t max_branch, int32_t use_links,
                    uint8_t* out_success, int64_t** eoff_out,
                    uint64_t** uhi_out, uint64_t** ulo_out,
                    int32_t** ucopy_out, uint64_t** vhi_out,
                    uint64_t** vlo_out, int32_t** vcopy_out) {
    const LinksWalkTable* t = (const LinksWalkTable*)handle;
    KOps ops(t);
    std::vector<int64_t> eoff(b + 1, 0);
    std::vector<uint64_t> uhi, ulo, vhi, vlo;
    std::vector<int32_t> ucopy, vcopy;
    for (int64_t i = 0; i < b; i++) {
        BranchGraph g;
        std::unordered_set<VKey, VKeyHash> visited;
        VKey src{shi[i], slo[i], 0};
        const bool ok = dfs_dest_branch(t, ops, src, 0, 0, visited,
                                        sink_hi[i], sink_lo[i], max_branch,
                                        use_links != 0, g);
        out_success[i] = ok ? 1 : 0;
        if (ok) {
            for (auto& e : g.edges) {
                uhi.push_back(e.first.hi);
                ulo.push_back(e.first.lo);
                ucopy.push_back(e.first.copy);
                vhi.push_back(e.second.hi);
                vlo.push_back(e.second.lo);
                vcopy.push_back(e.second.copy);
            }
        }
        eoff[i + 1] = (int64_t)uhi.size();
    }
    const int64_t E = (int64_t)uhi.size();
    auto dup = [](const void* src_p, size_t nbytes) -> void* {
        void* p = malloc(nbytes ? nbytes : 1);
        if (p && nbytes) memcpy(p, src_p, nbytes);
        return p;
    };
    *eoff_out = (int64_t*)dup(eoff.data(), (size_t)(b + 1) * 8);
    *uhi_out = (uint64_t*)dup(uhi.data(), (size_t)E * 8);
    *ulo_out = (uint64_t*)dup(ulo.data(), (size_t)E * 8);
    *ucopy_out = (int32_t*)dup(ucopy.data(), (size_t)E * 4);
    *vhi_out = (uint64_t*)dup(vhi.data(), (size_t)E * 8);
    *vlo_out = (uint64_t*)dup(vlo.data(), (size_t)E * 8);
    *vcopy_out = (int32_t*)dup(vcopy.data(), (size_t)E * 4);
    if (!*eoff_out || !*uhi_out || !*ulo_out || !*ucopy_out
        || !*vhi_out || !*vlo_out || !*vcopy_out)
        return -1;
    return E;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native read threading (`mccortex thread`, cromwell/wdl/Simulate.wdl:666-713):
// exact twin of the numpy scan in build.py::thread_reads.  Every read is
// scanned in both orientations; within each connected present run, each
// out-branching kmer whose read successor exists contributes its followed
// base to the choice string of the kmer preceding every earlier in-branching
// position (TempLinksAssembler.java:29-72 semantics).  Events are deduped
// natively; Python only converts unique keys to strings.

namespace {

struct ThreadEvent {
    uint64_t hi, lo;      // canonical key kmer
    int64_t coff;         // offset into the choice pool
    int32_t clen;         // choice count
    uint8_t fw;           // 1 when the key kmer's read orientation == canonical
};

struct ThreadWorkerOut {
    std::vector<ThreadEvent> events;
    std::vector<uint8_t> pool;   // junction choice bases, ASCII
};

inline int popcount4(uint8_t m) { return __builtin_popcount(m & 0xF); }

// scan one oriented code sequence (codes 0-3 valid, >=4 invalid)
void thread_scan_codes(const WalkTable* t, const uint8_t* codes, int64_t len,
                       int32_t k, ThreadWorkerOut& out) {
    const int shift_top = 2 * (k - 1);
    const bool one_word = k <= 32;
    const uint64_t lo_mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const uint64_t hi_mask = (k <= 32) ? 0ULL
                            : ((k == 64) ? ~0ULL : ((1ULL << (2 * (k - 32))) - 1));
    static const char* BASE = "ACGT";

    int64_t start = 0;
    std::vector<uint64_t> chi, clo;
    std::vector<uint8_t> flip, eb, found;
    while (start <= len - k) {
        int64_t end = start;
        while (end < len && codes[end] <= 3) end++;
        if (end - start >= k) {
            const int64_t m = end - start - k + 1;
            chi.assign(m, 0); clo.assign(m, 0);
            flip.assign(m, 0); eb.assign(m, 0); found.assign(m, 0);
            uint64_t fhi = 0, flo = 0, rhi = 0, rlo = 0;
            for (int64_t i = start; i < end; i++) {
                const uint64_t b = codes[i];
                fhi = ((fhi << 2) | (flo >> 62)) & hi_mask;
                flo = (flo << 2) | b;
                if (one_word) flo &= lo_mask;
                rlo = (rlo >> 2) | (rhi << 62);
                rhi >>= 2;
                const uint64_t cb = 3 - b;
                if (shift_top >= 64) rhi |= cb << (shift_top - 64);
                else rlo |= cb << shift_top;
                if (one_word) { rlo &= lo_mask; rhi = 0; }
                else { rhi &= hi_mask; }
                const int64_t pos = i - start + 1;
                if (pos < k) continue;
                const int64_t p = pos - k;
                // canonicalization matches kmer.canonicalize_codes: forward
                // wins ties (flip only when rc is strictly smaller)
                const bool flipped = one_word ? (rlo < flo)
                                   : (rhi != fhi ? rhi < fhi : rlo < flo);
                const uint64_t khi = flipped ? rhi : fhi;
                const uint64_t klo = flipped ? rlo : flo;
                chi[p] = khi; clo[p] = klo; flip[p] = flipped;
                uint64_t h = mix64(khi ^ mix64(klo)) & t->mask;
                while (t->slots[h].used) {
                    const WalkSlot& sl = t->slots[h];
                    if (sl.hi == khi && sl.lo == klo) {
                        eb[p] = sl.edge;
                        found[p] = 1;
                        break;
                    }
                    h = (h + 1) & t->mask;
                }
            }
            // runs of edge-connected present windows; junction + in-branch
            // events per run (build.py::thread_reads phase 2)
            int64_t p = 0;
            std::vector<int64_t> jpos;
            std::vector<int64_t> ibr;
            while (p < m) {
                if (!found[p]) { p++; continue; }
                const int64_t rs = p;
                jpos.clear(); ibr.clear();
                const int64_t pool0 = (int64_t)out.pool.size();
                while (true) {
                    const uint8_t e = eb[p];
                    const uint8_t next_mask = flip[p] ? (uint8_t)(e >> 4)
                                                      : (uint8_t)(e & 0xF);
                    const uint8_t in_nib = flip[p] ? (uint8_t)(e & 0xF)
                                                   : (uint8_t)(e >> 4);
                    if (p > rs && popcount4(in_nib) > 1) ibr.push_back(p);
                    bool conn = false;
                    if (p + 1 < m && found[p + 1]) {
                        const uint8_t nb = codes[start + p + k];
                        if ((next_mask >> nb) & 1) {
                            conn = true;
                            if (popcount4(next_mask) > 1) {
                                jpos.push_back(p);
                                out.pool.push_back((uint8_t)BASE[nb]);
                            }
                        }
                    }
                    if (!conn) break;
                    p++;
                }
                p++;
                const int64_t nj = (int64_t)jpos.size();
                for (int64_t ib : ibr) {
                    const int64_t q = ib - 1;
                    // first junction at position >= q
                    int64_t lb = (int64_t)(std::lower_bound(jpos.begin(),
                                           jpos.end(), q) - jpos.begin());
                    if (lb >= nj) continue;
                    ThreadEvent ev;
                    ev.hi = chi[q]; ev.lo = clo[q];
                    ev.coff = pool0 + lb;
                    ev.clen = (int32_t)(nj - lb);
                    ev.fw = flip[q] ? 0 : 1;
                    out.events.push_back(ev);
                }
            }
        }
        start = end + 1;
        if (end >= len) break;
    }
}

}  // namespace

extern "C" {

// table: from ct_walk_table_build over (kmer, per-color edge byte) pairs of
// records with coverage > 0 in the threading color.
// Returns the number of UNIQUE (key kmer, orientation, choices) events.
int64_t ct_thread_scan(void* table, const uint8_t* bases,
                       const int64_t* offsets, int64_t nseqs, int32_t k,
                       uint64_t** out_key_hi, uint64_t** out_key_lo,
                       uint8_t** out_fw, int64_t** out_choff,
                       uint8_t** out_choices) {
    if (k <= 0 || k > 64) return -1;
    const WalkTable* t = (const WalkTable*)table;
    uint8_t lut[256];
    build_lut(lut);

    ThreadWorkerOut out;
    std::vector<uint8_t> fcodes, rcodes;
    for (int64_t s = 0; s < nseqs; s++) {
        const uint8_t* seq = bases + offsets[s];
        const int64_t len = offsets[s + 1] - offsets[s];
        if (len < k) continue;
        fcodes.resize(len);
        rcodes.resize(len);
        for (int64_t i = 0; i < len; i++) {
            const uint8_t c = lut[seq[i]];
            fcodes[i] = c;
            rcodes[len - 1 - i] = (c == 0xFF) ? 0xFF : (uint8_t)(3 - c);
        }
        thread_scan_codes(t, fcodes.data(), len, k, out);
        thread_scan_codes(t, rcodes.data(), len, k, out);
    }

    // dedup: sort by (key, fw, choices lexicographic) — the order Python's
    // sorted() gives (False < True, string compare), so grouped records come
    // out already in emission order
    const uint8_t* pool = out.pool.data();
    std::sort(out.events.begin(), out.events.end(),
              [pool](const ThreadEvent& a, const ThreadEvent& b) {
        if (a.hi != b.hi) return a.hi < b.hi;
        if (a.lo != b.lo) return a.lo < b.lo;
        if (a.fw != b.fw) return a.fw < b.fw;
        const int32_t n = a.clen < b.clen ? a.clen : b.clen;
        const int c = memcmp(pool + a.coff, pool + b.coff, (size_t)n);
        if (c != 0) return c < 0;
        return a.clen < b.clen;
    });
    auto ev_eq = [pool](const ThreadEvent& a, const ThreadEvent& b) {
        return a.hi == b.hi && a.lo == b.lo && a.fw == b.fw &&
               a.clen == b.clen &&
               memcmp(pool + a.coff, pool + b.coff, (size_t)a.clen) == 0;
    };

    int64_t n = 0, total_choices = 0;
    const int64_t ne = (int64_t)out.events.size();
    for (int64_t i = 0; i < ne;) {
        int64_t j = i + 1;
        while (j < ne && ev_eq(out.events[i], out.events[j])) j++;
        n++;
        total_choices += out.events[i].clen;
        i = j;
    }

    uint64_t* khi = (uint64_t*)malloc(sizeof(uint64_t) * (n ? n : 1));
    uint64_t* klo = (uint64_t*)malloc(sizeof(uint64_t) * (n ? n : 1));
    uint8_t* fw = (uint8_t*)malloc(n ? n : 1);
    int64_t* choff = (int64_t*)malloc(sizeof(int64_t) * (n + 1));
    uint8_t* choices = (uint8_t*)malloc(total_choices ? total_choices : 1);
    if (!khi || !klo || !fw || !choff || !choices) return -1;

    int64_t w = 0, coff = 0;
    choff[0] = 0;
    for (int64_t i = 0; i < ne;) {
        int64_t j = i + 1;
        while (j < ne && ev_eq(out.events[i], out.events[j])) j++;
        const ThreadEvent& e = out.events[i];
        khi[w] = e.hi; klo[w] = e.lo; fw[w] = e.fw;
        memcpy(choices + coff, pool + e.coff, (size_t)e.clen);
        coff += e.clen;
        choff[w + 1] = coff;
        w++;
        i = j;
    }

    *out_key_hi = khi;
    *out_key_lo = klo;
    *out_fw = fw;
    *out_choff = choff;
    *out_choices = choices;
    return n;
}

}  // extern "C"
