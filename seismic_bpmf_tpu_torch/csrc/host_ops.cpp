// Host-side sequential kernels for seismic_bpmf_tpu.
//
// These are the order-dependent scans that do not map to the TPU's data-
// parallel model (SURVEY.md section 7 "hard parts" #4) and therefore run on
// the host, but are too slow in Python over multi-million-sample series:
//
//   - select_cc_indexes: detection triggering on a CC series (order-
//     dependent clearing of weaker neighbors), behavior-compatible with
//     BPMF/libc.c:441-485.
//   - dedup_detections: sequential nearest-pair dedup of above-threshold
//     indexes (BPMF/similarity_search.py:240-251 semantics).
//   - flag_multiples: time-sorted multi-detection dedup used for catalog
//     assembly (BPMF/dataset.py:5218-5284 semantics).
//   - find_similar_moveouts_{closest,smallest}: redundant source-grid
//     detection (BPMF/libc.c:55-387 semantics) with nth_element/partial
//     sorts instead of selection sort.
//
// Built with: make -C csrc  (or python setup.py build_ext)

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Detection triggering on a CC series.
// selection[i] = 1 iff cc[i] > threshold[i] and cc[i] is >= every cc[j] in
// the trailing window; weaker earlier selections are cleared as the scan
// advances (first-scan semantics of the reference C kernel).
// ---------------------------------------------------------------------------
void select_cc_indexes(
    const float* cc,
    const float* threshold,
    int64_t search_win,
    int64_t n_corr,
    int32_t* selection
) {
    for (int64_t i = 0; i < n_corr; ++i) {
        selection[i] = cc[i] > threshold[i] ? 1 : 0;
        int64_t start = i <= search_win ? 0 : i - search_win;
        for (int64_t j = start; j < i; ++j) {
            if (cc[j] > cc[i]) {
                selection[i] = 0;
                break;
            }
            selection[j] = 0;
        }
    }
}

// ---------------------------------------------------------------------------
// Sequential dedup of candidate indexes: while two consecutive kept
// candidates are closer than search_win, drop the one with lower cc.
// keep[] is an in/out mask over the candidates array.
// ---------------------------------------------------------------------------
void dedup_detections(
    const int64_t* candidates,
    const float* cc,
    int64_t n_candidates,
    int64_t search_win,
    int32_t* keep
) {
    std::fill(keep, keep + n_candidates, 1);
    int64_t prev = -1;
    for (int64_t i = 0; i < n_candidates; ++i) {
        if (prev < 0) { prev = i; continue; }
        if (candidates[i] - candidates[prev] < search_win) {
            if (cc[candidates[i]] > cc[candidates[prev]]) {
                keep[prev] = 0;
                prev = i;
            } else {
                keep[i] = 0;
            }
        } else {
            prev = i;
        }
    }
}

// ---------------------------------------------------------------------------
// Multi-detection dedup over a time-sorted catalog.  Events i and j are the
// same physical event when |t_j - t_i| <= dt AND (same template, or
// distance(tid_i, tid_j) <= dist_max, or cc(tid_i, tid_j) >= cc_min); among
// a chained group the detection with the largest metric wins.
// dist / ccm are (n_tid x n_tid) row-major lookups by template index.
// ---------------------------------------------------------------------------
void flag_multiples(
    const double* times,
    const int64_t* tid_idx,
    const float* metric,
    int64_t n_events,
    const float* dist,
    const float* ccm,
    int64_t n_tid,
    double dt_criterion,
    float dist_criterion,
    float cc_criterion,
    int32_t* unique_flag
) {
    std::fill(unique_flag, unique_flag + n_events, 1);
    int64_t i = 0;
    std::vector<int64_t> group;
    while (i < n_events) {
        group.clear();
        group.push_back(i);
        int64_t j = i + 1;
        while (j < n_events && times[j] - times[group.back()] <= dt_criterion) {
            int64_t a = tid_idx[group.front()];
            int64_t b = tid_idx[j];
            bool close = (a == b);
            if (!close && a >= 0 && b >= 0 && a < n_tid && b < n_tid) {
                if (dist && dist[a * n_tid + b] <= dist_criterion) close = true;
                if (!close && ccm && ccm[a * n_tid + b] >= cc_criterion)
                    close = true;
            }
            if (close) group.push_back(j);
            ++j;
        }
        if (group.size() > 1) {
            int64_t best = group[0];
            for (int64_t g : group)
                if (metric[g] > metric[best]) best = g;
            for (int64_t g : group)
                if (g != best) unique_flag[g] = 0;
        }
        i = group.back() + 1;
    }
}

// ---------------------------------------------------------------------------
// Redundant source-grid detection.  For every earlier non-redundant source
// n1, later sources whose summed squared moveout difference over k stations
// falls below k*threshold^2 are marked redundant.  Two passes (geographic
// cells, then global) like the reference; method selects which k stations:
//   closest:  the k stations with the smallest moveouts at n1 (the lower
//             station index first among equal moveouts)
//   smallest: the k smallest squared differences per pair
// ---------------------------------------------------------------------------
static void sweep_pairs(
    const float* mv,
    int64_t n_src,
    int64_t n_sta,
    int64_t k,
    float thr2,
    bool closest,
    const int64_t* order,   // candidate source indexes, ascending
    int64_t n_order,
    int32_t* redundant
) {
    std::vector<int64_t> sel(n_sta);
    std::vector<float> d2(n_sta);
    for (int64_t a = 0; a < n_order; ++a) {
        int64_t n1 = order[a];
        if (redundant[n1]) continue;
        const float* m1 = mv + n1 * n_sta;
        if (closest) {
            // ties broken by station index, as a stable argsort breaks
            // them (the NumPy version's order)
            std::iota(sel.begin(), sel.end(), 0);
            std::partial_sort(
                sel.begin(), sel.begin() + k, sel.end(),
                [&](int64_t x, int64_t y) {
                    return m1[x] < m1[y] || (m1[x] == m1[y] && x < y);
                });
        }
        for (int64_t b = a + 1; b < n_order; ++b) {
            int64_t n2 = order[b];
            if (redundant[n2]) continue;
            const float* m2 = mv + n2 * n_sta;
            float dt2 = 0.f;
            if (closest) {
                for (int64_t s = 0; s < k; ++s) {
                    float d = m1[sel[s]] - m2[sel[s]];
                    dt2 += d * d;
                }
            } else {
                for (int64_t s = 0; s < n_sta; ++s) {
                    float d = m1[s] - m2[s];
                    d2[s] = d * d;
                }
                std::nth_element(d2.begin(), d2.begin() + k - 1, d2.end());
                for (int64_t s = 0; s < k; ++s) dt2 += d2[s];
            }
            if (dt2 < thr2) redundant[n2] = 1;
        }
    }
}

void find_similar_moveouts(
    const float* moveouts,
    const float* src_lon,
    const float* src_lat,
    const float* cell_lon,
    const float* cell_lat,
    float threshold,
    int64_t n_src,
    int64_t n_sta,
    int64_t n_cells_lon,
    int64_t n_cells_lat,
    int64_t k,
    int32_t closest_method,
    int32_t* redundant
) {
    float thr2 = static_cast<float>(k) * threshold * threshold;
    std::fill(redundant, redundant + n_src, 0);
    std::vector<int64_t> order;
    order.reserve(n_src);
    // pass 1: cell-local
    for (int64_t ci = 0; ci < n_cells_lon; ++ci) {
        for (int64_t cj = 0; cj < n_cells_lat; ++cj) {
            order.clear();
            for (int64_t s = 0; s < n_src; ++s) {
                if (src_lon[s] >= cell_lon[ci] && src_lon[s] < cell_lon[ci + 1]
                    && src_lat[s] >= cell_lat[cj]
                    && src_lat[s] < cell_lat[cj + 1])
                    order.push_back(s);
            }
            if (order.size() > 1)
                sweep_pairs(moveouts, n_src, n_sta, k, thr2,
                            closest_method != 0, order.data(),
                            static_cast<int64_t>(order.size()), redundant);
        }
    }
    // pass 2: global
    order.resize(n_src);
    std::iota(order.begin(), order.end(), 0);
    sweep_pairs(moveouts, n_src, n_sta, k, thr2, closest_method != 0,
                order.data(), n_src, redundant);
}

}  // extern "C"
