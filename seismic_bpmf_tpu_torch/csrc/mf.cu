// Fused normalized, network-summed matched filter (CUDA C++, sm_90a).
//
// Replaces the TPU kernel `seismic_bpmf_tpu/ops/pallas_mf.py::_mf_kernel`
// (its `high` twin `_mf_kernel_split` is csrc/mf_split.cu).  Same
// semantics as `ops.reference.matched_filter(network_sum=True)`:
//
//   out[t, b] = sum_c mask(t, c, b) * y_c(b + mv[c, t]) *
//               sum_j f[c, t, j] * d_c(b + mv[c, t] + j)
//
// with f the demeaned, weight-over-norm scaled template rows, d the padded
// data, y_c(p) = rsqrt(r2 - r1^2 / L) from the L-sample window sums r1, r2
// at padded position p (0 where the window variance is <= 1e-10, which is
// how zero-filled gaps give CC = 0), and mask = p in [lo_p, hi_p], i.e.
// the template's window lies inside the unpadded data.
//
// What bounds it on an H100: operations.  One day of the main path is
// 128 templates x 30 channels x 200 taps x 2.16 M lags = 1.66e12 FMAs,
// against ~1.4 GB of data in and CC out, so the f32 FMA rate (67 TFLOP/s,
// 33.5 T FMA/s at 700 W) sets the floor, ~50 ms, not memory (~0.4 ms).
//
// Design.  One block computes a tile of MF_T = 512 lags x MF_TP = 32
// templates.  Per channel it stages in shared memory the tile's template
// rows (32 x L_pad f32), the data span the tile's moveouts reach
// (MF_T + max_delta + L_pad samples, read once from global memory) and y
// for every window start of that span (csrc/mf_window.cuh: local f32
// L-sums, summed as MF_YG-sample partials).
// Each warp owns 4 templates, each lane MF_R = 16 consecutive lags of one
// template at a time: a rolling register window of 16 data samples turns
// every shared-memory read of data into 16 FMAs, and the template taps are
// warp-wide broadcasts read as float4.  The data span is stored skewed
// (one pad word per 32) so the lanes' stride-16 reads hit distinct banks.
// Template rows are zero-padded to a multiple of MF_R taps (L = 200 ->
// 208: 4% of the FMAs are on zeros).  The register budget is set for two
// blocks per SM (128 registers, no spills).  On an H100 SXM at 700 W
// this choice ran a main-path day about 30% faster than MF_R = 8 with
// direct window sums (tools/mf_tile_sweep.py; the times are in PERF.md).
// Moveouts are pointer offsets into the span, so none of the zero taps of
// the TPU's L + max_moveout filter fold are computed.  The network sum is
// kept in registers and each output is written once, with 64-bit offsets.
//
// Precision.  The rungs highest and default and the screen scan run this
// kernel, in f32, which lies inside each of these rungs' error classes;
// `screen` keeps its margin-widened candidate extraction and exact
// float64 host refine, so its detection decisions do not change.  The
// rung high runs csrc/mf_split.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mf_window.cuh"

#ifndef MF_R
#define MF_R 16         // consecutive lags per thread (a multiple of 4)
#endif
#ifndef MF_MINB
#define MF_MINB 2       // blocks per SM the register budget must allow
#endif
#ifndef MF_YG
#define MF_YG 16        // samples per partial of the window sums (1: direct)
#endif
#define MF_T (32 * MF_R)
#define MF_TP 32
#define MF_THREADS 256
#define MF_TPW (MF_TP / (MF_THREADS / 32))  // templates per warp
#define SK(i) ((i) + ((i) >> 5))

struct MfSkew {
    __device__ static __forceinline__ int at(int i) { return SK(i); }
};

__global__ void __launch_bounds__(MF_THREADS, MF_MINB)
mf_kernel(const float* __restrict__ data,     // (n_ch, ext) padded day
          long long ext,
          const float* __restrict__ filt,     // (n_ch, n_tp_pad, L_pad)
          const int* __restrict__ mvf,        // (n_ch, n_tp_pad); -1 = skip
          const int* __restrict__ tile_lo,    // (n_ch, n_tiles); -1 = skip
          float* __restrict__ out,            // (n_tp, n_corr)
          int n_ch, int n_tp, int n_tp_pad, int L, int L_pad,
          long long n_corr, long long lo_p, long long hi_p, int max_delta)
{
    extern __shared__ float smem[];
    float* f_s = smem;                               // MF_TP * L_pad
    int* mv_s = reinterpret_cast<int*>(f_s + MF_TP * L_pad);
    float* y_s = reinterpret_cast<float*>(mv_s + MF_TP);
    const int n_y = MF_T + max_delta;
    float* d_s = y_s + n_y;
    const int span = n_y + L_pad;
    float* s1_s = d_s + SK(span) + 1;                // n_y + L_pad each
    float* s2_s = s1_s + n_y + L_pad;

    const long long b0 = (long long)blockIdx.x * MF_T;
    const int tile = blockIdx.y;
    const int n_tiles = gridDim.y;
    const int t0 = tile * MF_TP;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    float tot[MF_TPW][MF_R];
#pragma unroll
    for (int ti = 0; ti < MF_TPW; ++ti)
#pragma unroll
        for (int r = 0; r < MF_R; ++r) tot[ti][r] = 0.0f;

    for (int c = 0; c < n_ch; ++c) {
        const int lo = tile_lo[(long long)c * n_tiles + tile];
        if (lo < 0) continue;  // no template of this tile uses channel c
        __syncthreads();       // the previous channel is done with smem

        const float* fsrc = filt + ((long long)c * n_tp_pad + t0) * L_pad;
        for (int i = tid; i < MF_TP * L_pad; i += MF_THREADS)
            f_s[i] = fsrc[i];
        if (tid < MF_TP) mv_s[tid] = mvf[(long long)c * n_tp_pad + t0 + tid];
        const float* drow = data + (long long)c * ext;
        const long long g0 = b0 + lo;
        for (int i = tid; i < span; i += MF_THREADS) {
            const long long g = g0 + i;
            d_s[SK(i)] = (g < ext) ? drow[g] : 0.0f;
        }
        __syncthreads();

        mf_window_y<MF_YG, MfSkew>(d_s, s1_s, s2_s, y_s, n_y, L, tid,
                                   MF_THREADS);

#pragma unroll
        for (int ti = 0; ti < MF_TPW; ++ti) {
            const int t = warp + (MF_THREADS / 32) * ti;
            const int mv = mv_s[t];
            if (mv < 0) continue;  // warp-uniform: zero weight or zero norm
            const int base = lane * MF_R + (mv - lo);
            float acc[MF_R], win[MF_R];
#pragma unroll
            for (int r = 0; r < MF_R; ++r) {
                acc[r] = 0.0f;
                win[r] = d_s[SK(base + r)];
            }
            const float* fr = f_s + t * L_pad;
            for (int j0 = 0; j0 < L_pad; j0 += MF_R) {
                float fv[MF_R];
#pragma unroll
                for (int u = 0; u < MF_R / 4; ++u) {
                    const float4 f4 =
                        *reinterpret_cast<const float4*>(fr + j0 + 4 * u);
                    fv[4 * u] = f4.x;
                    fv[4 * u + 1] = f4.y;
                    fv[4 * u + 2] = f4.z;
                    fv[4 * u + 3] = f4.w;
                }
#pragma unroll
                for (int jj = 0; jj < MF_R; ++jj) {
#pragma unroll
                    for (int r = 0; r < MF_R; ++r)
                        acc[r] = fmaf(fv[jj], win[(r + jj) % MF_R], acc[r]);
                    // the oldest sample leaves, the next one enters
                    win[jj] = d_s[SK(base + j0 + jj + MF_R)];
                }
            }
            const long long p0 = b0 + lane * MF_R + mv;
#pragma unroll
            for (int r = 0; r < MF_R; ++r) {
                const long long p = p0 + r;
                const float v = acc[r] * y_s[base + r];
                tot[ti][r] += (p >= lo_p && p <= hi_p) ? v : 0.0f;
            }
        }
    }

#pragma unroll
    for (int ti = 0; ti < MF_TPW; ++ti) {
        const int t = t0 + warp + (MF_THREADS / 32) * ti;
        if (t >= n_tp) continue;
#pragma unroll
        for (int r = 0; r < MF_R; ++r) {
            const long long b = b0 + lane * MF_R + r;
            if (b < n_corr) out[(long long)t * n_corr + b] = tot[ti][r];
        }
    }
}

extern "C" {

// Dynamic shared memory (bytes) one block needs for these sizes.
long long mf_smem_bytes(int L_pad, int max_delta)
{
    const long long n_y = MF_T + max_delta;
    const long long span = n_y + L_pad;
    return 4LL * (MF_TP * (long long)L_pad + MF_TP + n_y + SK(span) + 1
                  + 2 * (n_y + L_pad));
}

int mf_tile_templates(void) { return MF_TP; }

int mf_tile_lags(void) { return MF_T; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int mf_launch(const void* data, long long ext, const void* filt,
              const void* mvf, const void* tile_lo, void* out,
              int n_ch, int n_tp, int n_tp_pad, int L, int L_pad,
              long long n_corr, long long lo_p, long long hi_p,
              int max_delta, void* stream)
{
    if (n_corr <= 0 || n_tp <= 0) return 0;
    const long long smem = mf_smem_bytes(L_pad, max_delta);
    cudaError_t e = cudaFuncSetAttribute(
        mf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((n_corr + MF_T - 1) / MF_T),
              (unsigned)(n_tp_pad / MF_TP));
    mf_kernel<<<grid, MF_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)data, ext, (const float*)filt, (const int*)mvf,
        (const int*)tile_lo, (float*)out, n_ch, n_tp, n_tp_pad, L, L_pad,
        n_corr, lo_p, hi_p, max_delta);
    return (int)cudaGetLastError();
}

const char* mf_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
