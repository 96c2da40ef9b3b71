// Fused normalized, network-summed matched filter of the `high` rung:
// every product operand split in two bf16 parts, the products on the
// tensor cores (CUDA C++, sm_90a).
//
// Replaces the TPU kernel
// `seismic_bpmf_tpu/ops/pallas_mf.py::_mf_kernel_split`.  It computes
//
//   fh = bf16_rne(f),  fl = bf16_rne(f - fh)        (host, once per plan)
//   dh = bf16_rne(d),  dl = bf16_rne(d - dh)        (here, per staged span)
//   corr[t, c, b] = sum_j fh*dh + (fh*dl + fl*dh)   at d index b+mv[c,t]+j
//   out[t, b] = sum_c mask(t, c, b) * y_c(b + mv[c, t]) * corr[t, c, b]
//
// with f the demeaned, weight-over-norm scaled template rows, d the padded
// data, y_c(p) = rsqrt(r2 - r1^2 / L) from the L-sample window sums of the
// UNSPLIT f32 data at padded position p (0 where the window variance is
// <= 1e-10, so zero-filled gaps give CC = 0), mask = p in [lo_p, hi_p], and
// channels with mv = -1 skipped: y, the mask and the skip are exactly those
// of csrc/mf.cu.  The dropped term fl*dl is ~2^-18 of a product.
//
// What bounds it on an H100: operations on the tensor cores.  One day of
// the main path (128 templates x 30 channels x 200 taps x 2.16 M lags) is
// 3 x 3.32e12 bf16 operations against ~1.4 GB of data in and CC out:
// ~10 ms at 989 TFLOP/s dense bf16, memory ~0.4 ms.
//
// Design.  A moveout is a pointer offset into a shared-memory data span,
// as in csrc/mf.cu, so none of the zero taps of the TPU's L + max_moveout
// wide filters are computed.  For one (template, channel) and 128
// consecutive lags the correlation is a small matrix product,
//
//   out[o(i) + n] = sum_k A[i, k] * B[k, n],   i < 16, n < 8, k < K
//   A[i, k] = d[base + o(i) + k]    (16 rows that overlap in the span)
//   B[k, n] = f[k - n]              (the template row as a K x 8 band)
//
// with K = L + 7 rounded up to 16 (208 for L = 200: 96% useful), run as a
// chain of K / 16 `mma.sync.m16n8k16` bf16 instructions with f32
// accumulation, three per k-step into one accumulator, in the order dh*fh,
// dl*fh, dh*fl.  The plain version `ops.mf.matched_filter_split_plain`
// sums each product over all taps first and then adds hh + (lh + hl): the
// same bf16 products (each exact in f32), equal up to f32 reassociation.
//   Which lags a row holds is free as long as the 16 rows tile the 128
// lags: o(i) = 32 (i / 2) + 8 (i % 2) for i < 8 and o(i + 8) = o(i) + 16.
// Thread (g, q) of a warp holds rows g and g + 8, so its second row reads
// the span 16 elements after its first: the A registers of row g + 8 at
// k-step s are those of row g at step s + 1.  A k-step therefore loads
// only the second row's registers (2 words for dh, 2 for dl, instead of 4
// and 4) and the loop is unrolled in pairs of steps so that the two
// register sets swap roles without moves.
//   A fragment register holds two consecutive bf16 (k, k + 1).  For A
// their address is span + base + o(row) + k, 4-byte aligned only for even
// base; for B it is row + k - n, misaligned for odd n.  So every bf16 array
// is kept twice in shared memory, as it is and shifted by one element, and
// a thread reads the copy that makes its pairs aligned: plain 32-bit
// loads.  The A loads of a warp start at words {0, 4, 16, 20, 32, 36, 48,
// 52} + q past a common word; the bf16 spans are stored skewed, 8 pad
// words after every 16, which puts those 32 words in 32 distinct banks
// for every alignment of the common word.
//   One block computes MFS_T = 128 MFS_NSUB lags x 32 templates.  Per
// channel it stages the 32 template rows (hi and lo, both shifts, with 8
// zeros in front: the host lays them out so, `ops.mf.stage_split_rows`, and
// a (channel, tile) block is one 16-byte-wide copy), the f32 data span
// MFS_T + max_delta + K samples, y for every window start of the span
// (csrc/mf_window.cuh, shared with csrc/mf.cu), and the span's four bf16
// arrays (hi/lo x shift).  Each warp owns 4 templates; for one template it loads
// a k-step's B fragments once and runs the block's sub-tiles on them.  The
// fragment of thread (g, q) holds lags o(g) + 2 q + {0, 1} and 16 more: y
// and the mask are applied there and the network sum stays in registers
// across channels; each output is written once, with 64-bit offsets.
//   The register budget is set for two blocks per SM (128 registers, a
// few hundred bytes of spills), so that one block's staging overlaps the
// other's products: on an H100 SXM at 700 W that ran a main-path day 17%
// faster than one block per SM without spills (tools/mf_tile_sweep.py
// mf_split; the times are in PERF.md).
// Later work: wgmma, TMA, a pipelined ring that overlaps a channel's
// staging with the previous channel's products inside one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mf_window.cuh"

#ifndef MFS_NSUB
#define MFS_NSUB 4      // 128-lag sub-tiles per block
#endif
#ifndef MFS_MINB
#define MFS_MINB 2      // blocks per SM the register budget must allow
#endif
#define MFS_YG 16       // samples per partial of the window sums
#define MFS_T (128 * MFS_NSUB)
#define MFS_TP 32
#define MFS_THREADS 256
#define MFS_TPW (MFS_TP / (MFS_THREADS / 32))  // templates per warp
#define MFS_FRONT 8     // zeros in front of a staged template row

// word index of a bf16 span -> its skewed place (8 pad words per 16)
#define MFS_SK(w) ((w) + (((w) >> 4) << 3))

// the f32 span is stored as it is
struct MfsFlat {
    __device__ static __forceinline__ int at(int i) { return i; }
};

struct MfsLayout {
    int K, KP, n_y, span, span2, n_sum, skw;
    long long f_bytes, total;
};

__host__ __device__ inline MfsLayout mfs_layout(int L, int L_pad,
                                                int max_delta)
{
    MfsLayout s;
    s.K = ((L + 7 + 15) / 16) * 16;
    s.KP = s.K + MFS_FRONT;
    s.n_y = MFS_T + max_delta;
    s.span = s.n_y + s.K;
    s.span2 = (s.span + 3) & ~1;          // even, >= span + 2
    s.n_sum = s.n_y + L_pad;
    // one bf16 filter array: MFS_TP rows x 2 shifts x KP
    s.f_bytes = 2LL * MFS_TP * 2 * s.KP;
    s.skw = MFS_SK(s.span2 / 2) + 8;      // words of one skewed bf16 span
    s.total = 2 * s.f_bytes                       // hi and lo rows
              + 4LL * (MFS_TP + s.n_y + s.span2 + 2 * s.n_sum)
              + 4 * 4LL * s.skw;                  // hi/lo x shift spans
    return s;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MFS_THREADS, MFS_MINB)
mf_split_kernel(const float* __restrict__ data,     // (n_ch, ext) padded day
                long long ext,
                // (n_ch, n_tiles, hi/lo, MFS_TP, shift, KP) staged rows
                const __nv_bfloat16* __restrict__ rows,
                const int* __restrict__ mvf,        // (n_ch, n_tp_pad); -1 skip
                const int* __restrict__ tile_lo,    // (n_ch, n_tiles); -1 skip
                float* __restrict__ out,            // (n_tp, n_corr)
                int n_ch, int n_tp, int n_tp_pad, int L, int L_pad,
                long long n_corr, long long lo_p, long long hi_p,
                int max_delta)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const MfsLayout s = mfs_layout(L, L_pad, max_delta);
    const int KP = s.KP, n_y = s.n_y, span = s.span, span2 = s.span2;
    const __nv_bfloat16* fh_s =
        reinterpret_cast<const __nv_bfloat16*>(smem_raw);
    const __nv_bfloat16* fl_s = fh_s + MFS_TP * 2 * KP;
    int* mv_s = reinterpret_cast<int*>(smem_raw + 2 * s.f_bytes);
    float* y_s = reinterpret_cast<float*>(mv_s + MFS_TP);
    float* d_s = y_s + n_y;                          // span2
    float* s1_s = d_s + span2;                       // n_sum each
    float* s2_s = s1_s + s.n_sum;
    __nv_bfloat16* dh0 = reinterpret_cast<__nv_bfloat16*>(s2_s + s.n_sum);
    __nv_bfloat16* dh1 = dh0 + 2 * s.skw;            // element i + 1 at i
    __nv_bfloat16* dl0 = dh1 + 2 * s.skw;
    __nv_bfloat16* dl1 = dl0 + 2 * s.skw;
    const int n_ks = s.K / 16;

    const long long b0 = (long long)blockIdx.x * MFS_T;
    const int tile = blockIdx.y;
    const int n_tiles = gridDim.y;
    const int t0 = tile * MFS_TP;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3, gp = g & 1;
    // first lag of this thread's C fragment within a sub-tile
    const int row_lag = 32 * (g >> 1) + 8 * gp + 2 * q;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

    float tot[MFS_TPW][MFS_NSUB][4];
#pragma unroll
    for (int ti = 0; ti < MFS_TPW; ++ti)
#pragma unroll
        for (int u = 0; u < MFS_NSUB; ++u)
#pragma unroll
            for (int r = 0; r < 4; ++r) tot[ti][u][r] = 0.0f;

    for (int c = 0; c < n_ch; ++c) {
        const int lo = tile_lo[(long long)c * n_tiles + tile];
        if (lo < 0) continue;  // no template of this tile uses channel c
        __syncthreads();       // the previous channel is done with smem

        // template rows, hi then lo, as the host laid them out
        const int n16 = (int)(2 * s.f_bytes / 16);
        const uint4* rsrc = reinterpret_cast<const uint4*>(rows)
                            + ((long long)c * n_tiles + tile) * n16;
        uint4* rdst = reinterpret_cast<uint4*>(smem_raw);
        for (int i = tid; i < n16; i += MFS_THREADS) rdst[i] = rsrc[i];
        if (tid < MFS_TP) mv_s[tid] = mvf[(long long)c * n_tp_pad + t0 + tid];

        // the data span: f32 for y, and its bf16 split, both shifts.  lo
        // is the rounded f32 residual of a real round-to-nearest-even hi.
        const float* drow = data + (long long)c * ext;
        const long long g0 = b0 + lo;
        for (int i = tid; i < span2; i += MFS_THREADS) {
            const long long gi = g0 + i;
            const float v = (i < span && gi < ext) ? drow[gi] : 0.0f;
            d_s[i] = v;
            const __nv_bfloat16 h = __float2bfloat16_rn(v);
            const __nv_bfloat16 l =
                __float2bfloat16_rn(v - __bfloat162float(h));
            const int e0 = 2 * MFS_SK(i >> 1) + (i & 1);
            dh0[e0] = h;
            dl0[e0] = l;
            if (i > 0) {
                const int e1 = 2 * MFS_SK((i - 1) >> 1) + ((i - 1) & 1);
                dh1[e1] = h;
                dl1[e1] = l;
            }
            if (i == span2 - 1) {
                dh1[e0] = zero;
                dl1[e0] = zero;
            }
        }
        __syncthreads();

        mf_window_y<MFS_YG, MfsFlat>(d_s, s1_s, s2_s, y_s, n_y, L, tid,
                                     MFS_THREADS);

#pragma unroll
        for (int ti = 0; ti < MFS_TPW; ++ti) {
            const int t = warp + (MFS_THREADS / 32) * ti;
            const int mv = mv_s[t];
            if (mv < 0) continue;  // warp-uniform: zero weight or zero norm
            const int base = mv - lo;
            const int par = base & 1;
            // words of this thread's first row, k = 2q, at k-step 0; the
            // +4, +8, +12 words are its k = 2q + 8 pair, and the second
            // row's two pairs (16 elements on)
            const int wt = ((base - par) >> 1) + 16 * (g >> 1) + 4 * gp + q;
            const int i0 = MFS_SK(wt), i4 = MFS_SK(wt + 4);
            const int i8 = MFS_SK(wt + 8), i12 = MFS_SK(wt + 12);
            const uint32_t* ah =
                reinterpret_cast<const uint32_t*>(par ? dh1 : dh0);
            const uint32_t* al =
                reinterpret_cast<const uint32_t*>(par ? dl1 : dl0);
            // B[k, n = g] = row[k - g + 8]; odd g reads the shifted copy
            const int bw = (2 * t + gp) * (KP >> 1) + (MFS_FRONT >> 1) + q
                           - ((g + gp) >> 1);
            const uint32_t* bh = reinterpret_cast<const uint32_t*>(fh_s) + bw;
            const uint32_t* bl = reinterpret_cast<const uint32_t*>(fl_s) + bw;

            float acc[MFS_NSUB][4];
            // x: the first row's two pairs of the coming step; z: the
            // second row's.  After a step the second row's are the first
            // row's of the next step, so x and z swap roles.
            uint32_t xh[MFS_NSUB][2], xl[MFS_NSUB][2];
            uint32_t zh[MFS_NSUB][2], zl[MFS_NSUB][2];
#pragma unroll
            for (int u = 0; u < MFS_NSUB; ++u) {
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[u][r] = 0.0f;
                // 64 words a sub-tile: 96 in the skewed span
                xh[u][0] = ah[i0 + 96 * u];
                xh[u][1] = ah[i4 + 96 * u];
                xl[u][0] = al[i0 + 96 * u];
                xl[u][1] = al[i4 + 96 * u];
            }

            // one k-step: load the second row's pairs into (nh, nl) at
            // skewed words (w1, w3), multiply with first row (ph, pl)
#define MFS_STEP(ph, pl, nh, nl, w1, w3, ks)                                \
            {                                                               \
                const uint32_t bh0 = bh[8 * (ks)], bh1 = bh[8 * (ks) + 4]; \
                const uint32_t bl0 = bl[8 * (ks)], bl1 = bl[8 * (ks) + 4]; \
                _Pragma("unroll")                                           \
                for (int u = 0; u < MFS_NSUB; ++u) {                       \
                    nh[u][0] = ah[(w1) + 96 * u];                          \
                    nh[u][1] = ah[(w3) + 96 * u];                          \
                    nl[u][0] = al[(w1) + 96 * u];                          \
                    nl[u][1] = al[(w3) + 96 * u];                          \
                    const uint32_t a_h[4] = {ph[u][0], nh[u][0], ph[u][1],  \
                                             nh[u][1]};                    \
                    const uint32_t a_l[4] = {pl[u][0], nl[u][0], pl[u][1],  \
                                             nl[u][1]};                    \
                    mma_bf16(acc[u], a_h, bh0, bh1);  /* dh * fh */        \
                    mma_bf16(acc[u], a_l, bh0, bh1);  /* dl * fh */        \
                    mma_bf16(acc[u], a_h, bl0, bl1);  /* dh * fl */        \
                }                                                           \
            }
            // two k-steps are 16 words on: 24 in the skewed span
            for (int j = 0; j < (n_ks >> 1); ++j) {
                MFS_STEP(xh, xl, zh, zl, i8 + 24 * j, i12 + 24 * j, 2 * j)
                MFS_STEP(zh, zl, xh, xl, i0 + 24 * (j + 1),
                         i4 + 24 * (j + 1), 2 * j + 1)
            }
            if (n_ks & 1) {
                const int j = n_ks >> 1;
                MFS_STEP(xh, xl, zh, zl, i8 + 24 * j, i12 + 24 * j, 2 * j)
            }
#undef MFS_STEP
#pragma unroll
            for (int u = 0; u < MFS_NSUB; ++u)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int lag = 128 * u + row_lag + (r & 1)
                                    + 16 * (r >> 1);
                    const long long p = b0 + lag + mv;
                    const float v = acc[u][r] * y_s[base + lag];
                    tot[ti][u][r] += (p >= lo_p && p <= hi_p) ? v : 0.0f;
                }
        }
    }

#pragma unroll
    for (int ti = 0; ti < MFS_TPW; ++ti) {
        const int t = t0 + warp + (MFS_THREADS / 32) * ti;
        if (t >= n_tp) continue;
#pragma unroll
        for (int u = 0; u < MFS_NSUB; ++u)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const long long b = b0 + 128 * u + row_lag + (r & 1)
                                    + 16 * (r >> 1);
                if (b < n_corr) out[(long long)t * n_corr + b] = tot[ti][u][r];
            }
    }
}

extern "C" {

// Dynamic shared memory (bytes) one block needs for these sizes.
long long mf_split_smem_bytes(int L, int L_pad, int max_delta)
{
    return mfs_layout(L, L_pad, max_delta).total;
}

int mf_split_tile_templates(void) { return MFS_TP; }

int mf_split_tile_lags(void) { return MFS_T; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int mf_split_launch(const void* data, long long ext, const void* rows,
                    const void* mvf, const void* tile_lo, void* out,
                    int n_ch, int n_tp, int n_tp_pad, int L, int L_pad,
                    long long n_corr, long long lo_p, long long hi_p,
                    int max_delta, void* stream)
{
    if (n_corr <= 0 || n_tp <= 0) return 0;
    const long long smem = mf_split_smem_bytes(L, L_pad, max_delta);
    cudaError_t e = cudaFuncSetAttribute(
        mf_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((n_corr + MFS_T - 1) / MFS_T),
              (unsigned)(n_tp_pad / MFS_TP));
    mf_split_kernel<<<grid, MFS_THREADS, (size_t)smem,
                      (cudaStream_t)stream>>>(
        (const float*)data, ext, (const __nv_bfloat16*)rows,
        (const int*)mvf, (const int*)tile_lo,
        (float*)out, n_ch, n_tp, n_tp_pad, L, L_pad, n_corr, lo_p, hi_p,
        max_delta);
    return (int)cudaGetLastError();
}

const char* mf_split_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
