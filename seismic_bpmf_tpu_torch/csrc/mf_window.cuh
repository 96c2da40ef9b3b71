// The matched-filter kernels' normalization, shared by csrc/mf.cu and
// csrc/mf_split.cu: y(p) = rsqrt(r2 - r1^2 / L)
// from the L-sample window sums r1, r2 of a staged f32 data span, 0 where
// the window variance is <= 1e-10 (so zero-filled gaps give CC = 0).

#pragma once

// Fills y_s[0, n_y) for every window start of the span in shared memory;
// sample i of the span is d_s[Skew::at(i)].  The sums are local f32 L-sums
// (no global prefix sum: r2 - r1^2 / L would cancel over a 2 M-sample
// scan), summed as YG-sample partials in s1_s, s2_s (n_y + L each) so that
// each sample is read ~YG + L / YG times instead of L times (YG = 1:
// direct).  Every thread of the block calls it, after the span is staged
// and synchronized; y_s is synchronized on return, y(p) at
// y_s[YSkew::at(p)].
template <int YG, typename Skew, typename YSkew = Skew>
__device__ __forceinline__ void mf_window_y(const float* d_s, float* s1_s,
                                            float* s2_s, float* y_s,
                                            int n_y, int L, int tid,
                                            int n_threads)
{
    const int n_grp = L / YG;                        // whole partials in L
    const int n_s = n_y + (n_grp - 1) * YG;
    const float inv_l = 1.0f / (float)L;
    for (int p = tid; p < n_s; p += n_threads) {
        float u1 = 0.0f, u2 = 0.0f;
#pragma unroll
        for (int k = 0; k < YG; ++k) {
            const float v = d_s[Skew::at(p + k)];
            u1 += v;
            u2 = fmaf(v, v, u2);
        }
        s1_s[p] = u1;
        s2_s[p] = u2;
    }
    __syncthreads();
    for (int p = tid; p < n_y; p += n_threads) {
        float r1 = 0.0f, r2 = 0.0f;
        for (int m = 0; m < n_grp; ++m) {
            r1 += s1_s[p + m * YG];
            r2 += s2_s[p + m * YG];
        }
        for (int j = n_grp * YG; j < L; ++j) {
            const float v = d_s[Skew::at(p + j)];
            r1 += v;
            r2 = fmaf(v, v, r2);
        }
        const float var = r2 - r1 * r1 * inv_l;
        y_s[YSkew::at(p)] = (var > 1e-10f) ? rsqrtf(fabsf(var) + 1e-30f) : 0.0f;
    }
    __syncthreads();
}

// a staged span stored as it is
struct MfwFlat {
    __device__ static __forceinline__ int at(int i) { return i; }
};

// Floats of shared memory one block of `mf_prepass_block` needs.
__host__ __device__ inline int mf_prepass_floats(int PP, int L)
{
    return 4 * PP + 3 * L + 16;
}

// One block of a day's pre-pass (the split kernels' `*_prepass`): stages
// the window starts [p0, p0 + PP) of one padded channel row `drow` and the
// L + 16 samples after them (zeros at and past ext), computes y of each
// start with `mf_window_y`, and calls put(i, v, y) for every start i with
// p0 + i < ext_al, v the f32 sample at p0 + i.  y at p reads the samples
// from p on only, in the same partial order wherever the span starts, so
// it has the bits a per-span computation gives.  `smem` holds
// `mf_prepass_floats(PP, L)` floats.
template <int YG, int PP, int THREADS, typename Put>
__device__ __forceinline__ void mf_prepass_block(
    const float* __restrict__ drow, long long ext, long long ext_al,
    long long p0, int L, float* smem, const Put& put)
{
    float* d_s = smem;                                 // PP + L + 16
    float* s1 = d_s + PP + L + 16;                     // PP + L each
    float* s2 = s1 + PP + L;
    float* y_s = s2 + PP + L;                          // PP
    for (int i = threadIdx.x; i < PP + L + 16; i += THREADS) {
        const long long gi = p0 + i;
        d_s[i] = gi < ext ? drow[gi] : 0.0f;
    }
    __syncthreads();
    mf_window_y<YG, MfwFlat>(d_s, s1, s2, y_s, PP, L, threadIdx.x, THREADS);
    for (int i = threadIdx.x; i < PP && p0 + i < ext_al; i += THREADS)
        put(i, d_s[i], y_s[i]);
}
