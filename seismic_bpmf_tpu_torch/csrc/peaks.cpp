// Greedy minimum-distance suppression of detect_peaks (ops.picks).
//
// The peaks are visited tallest first, in an order the caller gives (numpy's
// argsort of the heights, reversed, whose ties the tests pin); a visited peak
// that is still kept deletes every peak within mpd samples of it (with kpsh,
// only the lower ones) and stays kept itself.  The peaks are held in
// position order, so a kept peak's neighbours are the contiguous run around
// it, and the scan walks outward from it.  Without kpsh the kept peaks are
// more than mpd apart, so each peak is walked over by at most two of them;
// with kpsh only kept peaks of equal height share a window.  The NumPy
// version is ops.reference.peak_suppression.
//
// Built by seismic_bpmf_tpu_torch._build.load_host("peaks").

#include <cstdint>

extern "C" {

// pos: the n peak positions, ascending; xpos: their heights; order: the
// visiting order, indexes into pos; keep: out, 1 where a peak is kept.
void peak_suppression(
    const int64_t* pos,
    const double* xpos,
    const int64_t* order,
    int64_t n,
    int64_t mpd,
    int32_t kpsh,
    uint8_t* keep
) {
    for (int64_t i = 0; i < n; ++i) keep[i] = 1;
    for (int64_t k = 0; k < n; ++k) {
        const int64_t r = order[k];
        if (!keep[r]) continue;
        const int64_t p = pos[r];
        const double h = xpos[r];
        for (int64_t j = r - 1; j >= 0 && p - pos[j] <= mpd; --j) {
            if (!kpsh || xpos[j] < h) keep[j] = 0;
        }
        for (int64_t j = r + 1; j < n && pos[j] - p <= mpd; ++j) {
            if (!kpsh || xpos[j] < h) keep[j] = 0;
        }
    }
}

}  // extern "C"
