// Fused normalized, network-summed matched filter of the 'highest' rung:
// every product operand split in two TF32 parts, the products on the
// tensor cores with `mma.sync` (CUDA C++, sm_90a).
//
// Replaces, for the rung 'highest', the TPU kernel
// `seismic_bpmf_tpu/ops/pallas_mf.py::_mf_kernel` (csrc/mf.cu serves the
// same kernel's 'default' rung and the 'screen' scan).  It computes
//
//   fh = tf32(f),  fl = tf32(f - fh)                (host, once per plan)
//   dh = tf32(d),  dl = tf32(d - dh)                (here, per staged span)
//   corr[t, c, b] = sum_j fh*dh + (fh*dl + fl*dh)   at d index b+mv[c,t]+j
//   out[t, b] = sum_c mask(t, c, b) * y_c(b + mv[c, t]) * corr[t, c, b]
//
// with tf32 = cvt.rna.tf32.f32 (`ops.mf.split_tf32` is the same on the
// host), f the demeaned, weight-over-norm scaled template rows, d the
// padded data, y_c(p) = rsqrt(r2 - r1^2 / L) from the L-sample window sums
// of the UNSPLIT f32 data at padded position p (0 where the window variance
// is <= 1e-10), mask = p in [lo_p, hi_p], and channels with mv = -1
// skipped: y, the mask and the skip are those of csrc/mf.cu.  Each product
// of two TF32 parts is exact in f32; the dropped parts (fl*dl, which
// csrc/mf.cu and the plain version `ops.mf.matched_filter_plain` keep, and
// the residuals of the lo parts) are ~2^-21 of a product.
//
// Accumulation.  The tensor cores add an `mma`'s products into its f32
// accumulator with truncation, not round to nearest.  Near a detection
// every product of a channel has the same sign, so a running sum carried
// through a channel's dependent `mma`s loses a little at each one, always
// toward zero (~2e-6 of the CC at the main path's shape).  So each k-step's
// three `mma`s start from a zeroed fragment, the two small products (dl*fh,
// dh*fl) first, and the tensor cores truncate only at the scale of one
// k-step's partial; that partial is added into the running sum with an
// ordinary round-to-nearest f32 add.  That keeps 'highest' within 1e-6 of
// the float64 oracle, tighter than 'high'.
//
// What bounds it on an H100: operations on the tensor cores, ~20 ms a day
// of the main path (128 templates x 30 channels x 200 taps x 2.16 M lags)
// at 495 TFLOP/s dense TF32; `mma.sync` TF32 peaks well below that rate
// (PERF.md).  This is the design csrc/mf.cu had before its `wgmma`
// redesign, kept for this rung alone.
//
// Design.  A moveout is a pointer offset into a shared-memory data span,
// so none of the zero taps of the TPU's L + max_moveout wide filters are
// computed.  For one (template, channel) and 128 lags the correlation is a
// small matrix product,
//
//   out[o(i) + n] = sum_k A[i, k] * B[k, n],   i < 16, n < 8, k < K
//   A[i, k] = d[base + o(i) + k]    (16 rows that overlap in the span)
//   B[k, n] = f[k - n]              (the template row as a K x 8 band)
//
// with K = L + 7 rounded up to 8, run as a chain of K / 8
// `mma.sync.m16n8k8` TF32 instructions.  A block's MF_T = 128 MF_NSUB
// lags are MF_NSUB products ("sub-tiles") per template; thread (g, q) of a
// warp holds rows g and g + 8 of each, and sub-tile u's rows lie at
// o_u(g) = 16 MF_NSUB g + 16 u and o_u(g) + 8.  So lane group g owns
// 16 MF_NSUB consecutive lags, and the A registers of all its rows at
// k-step s are the window positions s .. s + 2 MF_NSUB - 1 of one stream,
// position m being span elements e0 + 8 m and e0 + 8 m + 4 of each part
// (k = q and q + 4).  The window lives in registers, position m in slot
// m % (2 MF_NSUB + 1); a k-step runs every sub-tile from it and then loads
// ONE new position (4 words) into the slot just freed, a step before its
// first use.  The loop is unrolled in rounds of 2 MF_NSUB + 1 steps, so
// that every slot is a fixed register.
//   The spans and y are stored skewed, 4 pad words after every 16 MF_NSUB
// elements (MF_SK): a warp's A loads then hit 32 distinct banks for every
// alignment, its y loads no bank more than twice (tests/test_torch_mf.py
// counts them).  The B loads of a warp read 11 distinct words of one row.
//   Per channel a block stages the 32 template rows (hi and lo, with 8
// zeros in front: `ops.mf.stage_tf32_rows`), the f32 data span MF_T +
// max_delta + K samples, y for every window start of the span
// (csrc/mf_window.cuh) and the span's two TF32 parts.  Each warp owns 4
// templates; the fragment of thread (g, q) holds lags o_u(g) + 2 q +
// {0, 1} and 8 more: y and the mask are applied there and the network sum
// stays in registers across channels; each output is written once.  Two
// blocks share an SM (MF_MINB), so that one block's staging and window
// sums overlap the other's products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mf_window.cuh"

#ifndef MF_NSUB
#define MF_NSUB 4       // 128-lag sub-tiles per block: 1, 2, 4 or 8
#endif
#ifndef MF_MINB
#define MF_MINB 2       // blocks per SM the register budget must allow
#endif
#define MF_YG 16        // samples per partial of the window sums
#define MF_T (128 * MF_NSUB)
#define MF_TP 32
#define MF_THREADS 256
#define MF_TPW (MF_TP / (MF_THREADS / 32))  // templates per warp
#define MF_FRONT 8      // zeros in front of a staged template row
// window slots per lane: a step reads 2 MF_NSUB positions, and one more
// slot lets each load be issued a step before the step that first reads it
#define MF_WS (2 * MF_NSUB + 1)
#define MF_RUN (16 * MF_NSUB)               // lags of a lane group

#if MF_NSUB == 1
#define MF_SKS 4
#elif MF_NSUB == 2
#define MF_SKS 5
#elif MF_NSUB == 4
#define MF_SKS 6
#elif MF_NSUB == 8
#define MF_SKS 7
#else
#error "MF_NSUB must be 1, 2, 4 or 8"
#endif

// element index of a span -> its skewed place (4 pad words per MF_RUN)
#define MF_SK(e) ((e) + (((e) >> MF_SKS) << 2))

// the f32 span is stored as it is; y and the TF32 parts skewed
struct MfFlat {
    __device__ static __forceinline__ int at(int i) { return i; }
};
struct MfSkew {
    __device__ static __forceinline__ int at(int i) { return MF_SK(i); }
};

struct MfLayout {
    int K, KP, n_y, span, n_sum, skw, yw;
    long long rows_bytes, total;
};

__host__ __device__ inline MfLayout mf_layout(int L, int max_delta)
{
    MfLayout s;
    s.K = ((L + 7 + 7) / 8) * 8;
    s.KP = s.K + MF_FRONT;
    s.n_y = MF_T + max_delta;
    s.span = s.n_y + s.K + 8;             // + 8: the loads issued ahead
    s.n_sum = s.n_y + L;
    s.skw = MF_SK(s.span) + 4;            // words of one skewed span
    s.yw = MF_SK(s.n_y) + 4;              // words of the skewed y
    // the hi and lo rows: 2 x MF_TP x KP f32
    s.rows_bytes = 4LL * 2 * MF_TP * s.KP;
    s.total = s.rows_bytes
              + 4LL * (MF_TP + s.yw + s.span + 2 * s.n_sum + 2 * s.skw);
    return s;
}

__device__ __forceinline__ float tf32_rna(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c = a * b from a zeroed accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&c)[4], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0,
                                              uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.0f));
}

// One k-step's three products of sub-tile rows (p, n): dl*fh, dh*fl,
// dh*fh from zero, the partial added to acc in round-to-nearest f32.
__device__ __forceinline__ void mf_products(float (&acc)[4],
                                            const uint32_t (&hp)[2],
                                            const uint32_t (&hn)[2],
                                            const uint32_t (&lp)[2],
                                            const uint32_t (&ln)[2],
                                            uint32_t bh0, uint32_t bh1,
                                            uint32_t bl0, uint32_t bl1)
{
    float part[4];
    mma_tf32_zero(part, lp[0], ln[0], lp[1], ln[1], bh0, bh1);  // dl * fh
    mma_tf32(part, hp[0], hn[0], hp[1], hn[1], bl0, bl1);       // dh * fl
    mma_tf32(part, hp[0], hn[0], hp[1], hn[1], bh0, bh1);       // dh * fh
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] += part[r];
}

__global__ void __launch_bounds__(MF_THREADS, MF_MINB)
mf_highest_kernel(const float* __restrict__ data,     // (n_ch, ext) padded day
          long long ext,
          // (n_ch, n_tiles, hi/lo, MF_TP, KP) staged TF32 rows
          const float* __restrict__ rows,
          const int* __restrict__ mvf,        // (n_ch, n_tp_pad); -1 = skip
          const int* __restrict__ tile_lo,    // (n_ch, n_tiles); -1 = skip
          float* __restrict__ out,            // (n_tp, n_corr)
          int n_ch, int n_tp, int n_tp_pad, int L,
          long long n_corr, long long lo_p, long long hi_p, int max_delta)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const MfLayout s = mf_layout(L, max_delta);
    const int KP = s.KP, n_y = s.n_y, span = s.span;
    const uint32_t* fh_s = reinterpret_cast<const uint32_t*>(smem_raw);
    const uint32_t* fl_s = fh_s + MF_TP * KP;
    int* mv_s = reinterpret_cast<int*>(smem_raw + s.rows_bytes);
    float* y_s = reinterpret_cast<float*>(mv_s + MF_TP);  // yw, skewed
    float* d_s = y_s + s.yw;                         // span
    float* s1_s = d_s + span;                        // n_sum each
    float* s2_s = s1_s + s.n_sum;
    float* dh_s = s2_s + s.n_sum;                    // skw each, skewed
    float* dl_s = dh_s + s.skw;
    const uint32_t* ah = reinterpret_cast<const uint32_t*>(dh_s);
    const uint32_t* al = reinterpret_cast<const uint32_t*>(dl_s);
    const int n_ks = s.K / 8;

    const long long b0 = (long long)blockIdx.x * MF_T;
    const int tile = blockIdx.y;
    const int n_tiles = gridDim.y;
    const int t0 = tile * MF_TP;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    // first lag of this thread's C fragments: sub-tile u adds 16 u, the
    // fragment's second row 8 more
    const int row_lag = MF_RUN * g + 2 * q;

    float tot[MF_TPW][MF_NSUB][4];
#pragma unroll
    for (int ti = 0; ti < MF_TPW; ++ti)
#pragma unroll
        for (int u = 0; u < MF_NSUB; ++u)
#pragma unroll
            for (int r = 0; r < 4; ++r) tot[ti][u][r] = 0.0f;

    for (int c = 0; c < n_ch; ++c) {
        const int lo = tile_lo[(long long)c * n_tiles + tile];
        if (lo < 0) continue;  // no template of this tile uses channel c
        __syncthreads();       // the previous channel is done with smem

        // template rows, hi then lo, as the host laid them out
        const int n16 = (int)(s.rows_bytes / 16);
        const uint4* rsrc = reinterpret_cast<const uint4*>(rows)
                            + ((long long)c * n_tiles + tile) * n16;
        uint4* rdst = reinterpret_cast<uint4*>(smem_raw);
        for (int i = tid; i < n16; i += MF_THREADS) rdst[i] = rsrc[i];
        if (tid < MF_TP) mv_s[tid] = mvf[(long long)c * n_tp_pad + t0 + tid];

        // the data span: f32 for y, and its TF32 split, skewed
        const float* drow = data + (long long)c * ext;
        const long long g0 = b0 + lo;
        for (int i = tid; i < span; i += MF_THREADS) {
            const long long gi = g0 + i;
            const float v = (gi < ext) ? drow[gi] : 0.0f;
            d_s[i] = v;
            const float h = tf32_rna(v);
            dh_s[MF_SK(i)] = h;
            dl_s[MF_SK(i)] = tf32_rna(v - h);
        }
        __syncthreads();

        mf_window_y<MF_YG, MfFlat, MfSkew>(d_s, s1_s, s2_s, y_s, n_y, L,
                                           tid, MF_THREADS);

#pragma unroll
        for (int ti = 0; ti < MF_TPW; ++ti) {
            const int t = warp + (MF_THREADS / 32) * ti;
            const int mv = mv_s[t];
            if (mv < 0) continue;  // warp-uniform: zero weight or zero norm
            const int base = mv - lo;
            // window position m of this thread: span elements e0 + 8 m and
            // e0 + 8 m + 4 (k = q and q + 4) of each part
            const int e0 = base + MF_RUN * g + q;
            // B[k, n = g] = row[k - g + 8]
            const uint32_t* bh = fh_s + t * KP + MF_FRONT + q - g;
            const uint32_t* bl = fl_s + t * KP + MF_FRONT + q - g;

            float acc[MF_NSUB][4];
            uint32_t wh[MF_WS][2], wl[MF_WS][2];
#pragma unroll
            for (int u = 0; u < MF_NSUB; ++u)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[u][r] = 0.0f;
#pragma unroll
            for (int m = 0; m < MF_WS; ++m) {
                const int i0 = MF_SK(e0 + 8 * m), i4 = MF_SK(e0 + 8 * m + 4);
                wh[m][0] = ah[i0];
                wh[m][1] = ah[i4];
                wl[m][0] = al[i0];
                wl[m][1] = al[i4];
            }
            // k-step s: sub-tile u's rows are window positions s + 2 u and
            // s + 2 u + 1, position m kept in slot m % MF_WS; after the step,
            // slot s % MF_WS takes position s + MF_WS, first read two steps
            // later.  The rounds are unrolled so that every slot is a fixed
            // register.
#define MF_STEP(i, ks)                                                      \
            {                                                               \
                const uint32_t bh0 = bh[8 * (ks)], bh1 = bh[8 * (ks) + 4];  \
                const uint32_t bl0 = bl[8 * (ks)], bl1 = bl[8 * (ks) + 4];  \
                _Pragma("unroll")                                           \
                for (int u = 0; u < MF_NSUB; ++u) {                        \
                    const int p = ((i) + 2 * u) % MF_WS;                   \
                    const int n = ((i) + 2 * u + 1) % MF_WS;               \
                    mf_products(acc[u], wh[p], wh[n], wl[p], wl[n], bh0,   \
                                bh1, bl0, bl1);                            \
                }                                                           \
                const int e = e0 + 8 * ((ks) + MF_WS);                     \
                const int i0 = MF_SK(e), i4 = MF_SK(e + 4);                \
                wh[i][0] = ah[i0];                                          \
                wh[i][1] = ah[i4];                                          \
                wl[i][0] = al[i0];                                          \
                wl[i][1] = al[i4];                                          \
            }
            // whole rounds of MF_WS steps, then the rest one by one
            int s0 = 0;
            for (; s0 + MF_WS <= n_ks; s0 += MF_WS) {
#pragma unroll
                for (int i = 0; i < MF_WS; ++i) MF_STEP(i, s0 + i)
            }
#pragma unroll
            for (int i = 0; i < MF_WS - 1; ++i)
                if (s0 + i < n_ks) MF_STEP(i, s0 + i)  // warp-uniform
#undef MF_STEP
            // lags of this block whose window lies inside the data
            const long long rel = b0 + mv;
            const int lag_lo = (int)max(lo_p - rel, -1LL);
            const int lag_hi = (int)min(hi_p - rel, (long long)MF_T);
#pragma unroll
            for (int u = 0; u < MF_NSUB; ++u)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int lag = row_lag + 16 * u + 8 * (r >> 1) + (r & 1);
                    const float v = acc[u][r] * y_s[MF_SK(base + lag)];
                    tot[ti][u][r] += (lag >= lag_lo && lag <= lag_hi) ? v
                                                                      : 0.0f;
                }
        }
    }

#pragma unroll
    for (int ti = 0; ti < MF_TPW; ++ti) {
        const int t = t0 + warp + (MF_THREADS / 32) * ti;
        if (t >= n_tp) continue;
#pragma unroll
        for (int u = 0; u < MF_NSUB; ++u)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const long long b = b0 + row_lag + 16 * u + 8 * (r >> 1)
                                    + (r & 1);
                if (b < n_corr) out[(long long)t * n_corr + b] = tot[ti][u][r];
            }
    }
}

extern "C" {

// Dynamic shared memory (bytes) one block needs for these sizes.
long long mf_highest_smem_bytes(int L, int max_delta)
{
    return mf_layout(L, max_delta).total;
}

int mf_highest_tile_templates(void) { return MF_TP; }

int mf_highest_tile_lags(void) { return MF_T; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
int mf_highest_launch(const void* data, long long ext, const void* rows,
              const void* mvf, const void* tile_lo, void* out,
              int n_ch, int n_tp, int n_tp_pad, int L,
              long long n_corr, long long lo_p, long long hi_p,
              int max_delta, void* stream)
{
    if (n_corr <= 0 || n_tp <= 0) return 0;
    const long long smem = mf_highest_smem_bytes(L, max_delta);
    cudaError_t e = cudaFuncSetAttribute(
        mf_highest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((n_corr + MF_T - 1) / MF_T),
              (unsigned)(n_tp_pad / MF_TP));
    mf_highest_kernel<<<grid, MF_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)data, ext, (const float*)rows, (const int*)mvf,
        (const int*)tile_lo, (float*)out, n_ch, n_tp, n_tp_pad, L, n_corr,
        lo_p, hi_p, max_delta);
    return (int)cudaGetLastError();
}

const char* mf_highest_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
