// Fused normalized, network-summed matched filter of the `high` rung:
// every product operand split in two bf16 parts, the products on Hopper's
// warpgroup tensor-core instruction (`wgmma`, CUDA C++, sm_90a).
//
// Replaces the TPU kernel
// `seismic_bpmf_tpu/ops/pallas_mf.py::_mf_kernel_split`.  It computes
//
//   fh = bf16_rne(f),  fl = bf16_rne(f - fh)        (host, once per plan)
//   dh = bf16_rne(d),  dl = bf16_rne(d - dh)        (pre-pass, once a call)
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
// ~10 ms at 989 TFLOP/s dense bf16, memory ~0.4 ms.  The previous design
// (`mma.sync`) staged and split each channel's span and recomputed its
// window norms in every block, between two block barriers, for each of
// the bank's template tiles again: 42 ms a day on an H100 80GB HBM3 at
// 700 W.
//
// Design.  Two kernels.  `mf_split_prepass` runs once a call: for every
// window start of the padded day it writes y (csrc/mf_window.cuh's partial
// order, so each value has the bits a per-span computation gives: y at p
// reads the data from p onward only) and the day's bf16 hi and lo parts.
// `mf_split_kernel` then never splits or normalizes anything: a block's 4
// templates x 4096 lags read those arrays through a ring of shared-memory
// stages, one channel a stage, that a producer warpgroup fills with
// `cp.async` and `mbarrier`s while two consumer warpgroups multiply on the
// stage before it (`setmaxnreg` moves registers from the producer to
// them).
//   For one (template, channel) the 4096 lags are one m64n64 product per
// k-step:
//
//   out[m, n] = sum_k A[m, k] B[k, n]  = corr at lag 64 n + m
//   A[m, k] = f[k - m - delta]      (64 shifts of the template row: registers)
//   B[k, n] = d[a - delta + 64 n + k]  (the data span: shared memory)
//
// with a = b0 + mv - G0 the template's offset in the staged span (G0 the
// span's 16-byte aligned start) and delta = a mod 8, so that B starts on a
// 16-byte boundary whatever the moveout; K = L + 70 rounded up to 16 (272
// for L = 200: 74% of the products add taps).  B is the span as it is,
// 128-byte rows 64 samples apart, read by a `wgmma` descriptor in the
// 128-byte swizzle (the producer stores each 16-byte chunk at its swizzled
// place), so all templates of a block share one staged copy of the day;
// the k-step s reads the descriptor 32 s bytes on.  A is loaded into the
// operand registers each k-step from the template's row, staged twice (as
// it is and one element on, so that a pair of taps is one aligned word);
// a warp's loads touch two runs of 8 words 16 banks apart.  Three `wgmma`
// a k-step, fh*dh, fh*dl, fl*dh, accumulate in f32 registers; a consumer
// warpgroup issues the k-steps of its two templates as one group of six,
// and waits for the group before last (the wait on each group, not the
// multiply, paced groups of three: 26 ms a day against 24).  After the
// k-steps the epilogue multiplies each lag by y (staged with 8 pad words
// after every 128, which puts a warp's 32 loads in 32 banks), masks it and
// adds it to the template's network sum, which stays in registers across
// channels; each output is written once, with 64-bit offsets.  No branch
// surrounds the tensor cores' instructions: ptxas serializes them on a
// path it cannot prove uniform, so a template that skips a channel
// multiplies the span's start and adds nothing.
//   The ring has up to MFS_STAGES stages (the launch takes as many as fit
// shared memory); a channel that `tile_lo` marks -1 is skipped by the
// producer and the consumers alike, so it costs no stage.  The times of
// each design are in PERF.md (tools/mf_tile_sweep.py mf_split).
//   The plain version `ops.mf.matched_filter_split_plain` sums each product
// over all taps first and then adds hh + (lh + hl): the same bf16 products
// (each exact in f32), equal up to f32 reassociation.  Its index maps are
// mirrored on the CPU by tests/test_torch_mf_split.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mf_window.cuh"

#ifndef MFS_STAGES
#define MFS_STAGES 3    // deepest ring a launch may use
#endif
#ifndef MFS_DIAG
#define MFS_DIAG 0      // diagnostic builds: 1 no products, 2 staging only
#endif
#define MFS_YG 16       // samples per partial of the window sums
#define MFS_N 64        // 64-lag blocks of one product (its columns)
#define MFS_T (64 * MFS_N)                 // lags a block: 4096
#define MFS_TPW 2       // templates a consumer warpgroup, multiplied together
#define MFS_CWG 2       // consumer warpgroups
#define MFS_TPB (MFS_TPW * MFS_CWG)        // templates a block: 4
#define MFS_THREADS (128 * MFS_CWG + 128)  // and a producer warpgroup
// registers a thread after `setmaxnreg`: the producer gives, the consumers
// take, inside the block's allocation at launch (168 a thread for 384
// threads); the launch checks that the kernel's own count covers both
#define MFS_PRODUCER_REGS 40
#define MFS_CONSUMER_REGS 232
#define MFS_OFF 72      // zeros in front of a staged template row
#define MFS_TILE 32     // templates a `tile_lo` entry covers (TEMPLATE_TILE)
#define MFS_PP 2048     // window starts a pre-pass block
#define MFS_PP_THREADS 256
#define MFS_SMEM_LIMIT 232448

struct MfsLayout {
    int K, row, span, n_y4, stages;
    int o_lo, o_f, o_y, o_mv, f_bytes, stage_bytes;
    long long total;
};

// taps a k-loop covers: every shift m < 64 and delta < 8 of an L-tap row
__host__ __device__ inline int mfs_k(int L) { return ((L + 70 + 15) / 16) * 16; }

// elements of a staged template row: >= K + 72, and row / 2 words = 16
// mod 32, so the two copies of a row lie 16 banks apart
__host__ __device__ inline int mfs_row(int L)
{
    return ((mfs_k(L) + 40 + 63) / 64) * 64 + 32;
}

__host__ __device__ inline MfsLayout mfs_layout_n(int L, int max_delta,
                                                  int stages)
{
    MfsLayout s;
    s.K = mfs_k(L);
    s.row = mfs_row(L);
    // the data span (bf16): B reads up to a - delta + 64 * 63 + K - 1
    s.span = ((max_delta + 8 + MFS_T - MFS_N + s.K + 63) / 64) * 64;
    const int hb = ((2 * s.span + 1023) / 1024) * 1024;
    // y for window starts a + lag < max_delta + 8 + MFS_T
    s.n_y4 = ((max_delta + 8 + MFS_T + 3) / 4) * 4;
    const int y_words = s.n_y4 + 8 * ((s.n_y4 + 127) / 128);
    s.f_bytes = MFS_TPB * 8 * s.row;       // hi, lo x as is, one on
    s.o_lo = hb;
    s.o_f = 2 * hb;
    s.o_y = s.o_f + s.f_bytes;
    s.o_mv = s.o_y + 4 * y_words;
    s.stage_bytes = ((s.o_mv + 4 * MFS_TPB + 1023) / 1024) * 1024;
    s.stages = stages;
    // 1 KB to align the ring, then the stages, then the mbarriers
    s.total = 1024 + (long long)stages * s.stage_bytes + 16 * stages;
    return s;
}

// the deepest ring that fits, 1 when none does
__host__ __device__ inline MfsLayout mfs_layout(int L, int max_delta)
{
    for (int n = MFS_STAGES; n > 1; --n) {
        const MfsLayout s = mfs_layout_n(L, max_delta, n);
        if (s.total <= MFS_SMEM_LIMIT) return s;
    }
    return mfs_layout_n(L, max_delta, 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity)
{
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(dst), "l"(src) : "memory");
}

// the barrier gets this thread's arrival once its copies have landed
__device__ __forceinline__ void cp_arrive(uint32_t bar)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(bar) : "memory");
}

// byte offset of a 16-byte chunk in the 128-byte swizzle (bits 4-6 ^= 7-9)
__host__ __device__ __forceinline__ uint32_t mfs_swz(uint32_t off)
{
    return off ^ ((off >> 3) & 0x70);
}

// wgmma descriptor of a K-major bf16 operand in the 128-byte swizzle:
// rows 128 bytes apart, 8-row groups 1024 bytes apart.  The swizzle is a
// function of the shared-memory address, so a start on any 16-byte
// boundary reads what the producer stored there (base offset 0; the card
// gave wrong products with the start's row phase in that field)
__device__ __forceinline__ uint64_t mfs_desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps reads of the accumulators after the wait that completes them
__device__ __forceinline__ void fence_acc(float (&d)[32])
{
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// stores one window start's bf16 parts and y
struct MfsPut {
    __nv_bfloat16* dh;
    __nv_bfloat16* dl;
    float* y;
    long long o;
    __device__ __forceinline__ void operator()(int i, float v,
                                               float yv) const
    {
        const __nv_bfloat16 h = __float2bfloat16_rn(v);
        dh[o + i] = h;
        dl[o + i] = __float2bfloat16_rn(v - __bfloat162float(h));
        y[o + i] = yv;
    }
};

// y and the bf16 parts of every window start of the padded day:
// (n_ch, ext_al) each, zero parts beyond ext
__global__ void __launch_bounds__(MFS_PP_THREADS)
mf_split_prepass(const float* __restrict__ data, long long ext,
                 long long ext_al, int L, __nv_bfloat16* __restrict__ dh,
                 __nv_bfloat16* __restrict__ dl, float* __restrict__ y)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int c = blockIdx.y;
    const long long p0 = (long long)blockIdx.x * MFS_PP;
    const MfsPut put{dh, dl, y, (long long)c * ext_al + p0};
    mf_prepass_block<MFS_YG, MFS_PP, MFS_PP_THREADS>(
        data + (long long)c * ext, ext, ext_al, p0, L,
        reinterpret_cast<float*>(smem_raw), put);
}

__global__ void __launch_bounds__(MFS_THREADS, 1)
mf_split_kernel(const __nv_bfloat16* __restrict__ dh,  // (n_ch, ext_al)
                const __nv_bfloat16* __restrict__ dl,
                const float* __restrict__ yg,           // (n_ch, ext_al)
                long long ext_al,
                // (n_ch, n_tp_pad, hi/lo, as is / one on, row) staged rows
                const __nv_bfloat16* __restrict__ rows,
                const int* __restrict__ mvf,        // (n_ch, n_tp_pad); -1 skip
                const int* __restrict__ tile_lo,    // (n_ch, n_tiles); -1 skip
                float* __restrict__ out,            // (n_tp, n_corr)
                int n_ch, int n_tp, int n_tp_pad, int L, int n_corr,
                int lo_p, int hi_p, int max_delta)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const MfsLayout s = mfs_layout(L, max_delta);
    const int stages = s.stages;
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* const base_g = smem_raw + (base - raw);
    // full[i] at bars + 8 i, empty[i] at bars + 8 (stages + i)
    const uint32_t bars = base + stages * s.stage_bytes;
    const int tid = threadIdx.x;
    const int t0 = blockIdx.x * MFS_TPB;
    const long long b0 = (long long)blockIdx.y * MFS_T;
    const int n_tiles = n_tp_pad / MFS_TILE;
    const int tile = t0 / MFS_TILE;
    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(bars + 8 * i, 128);                  // producer threads
            mbar_init(bars + 8 * (stages + i), 4 * MFS_CWG);  // consumer warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= 128 * MFS_CWG) {
        // the producer warpgroup: channel after channel into the ring
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(MFS_PRODUCER_REGS));
        const int pt = tid - 128 * MFS_CWG;
        int it = 0;
        int lo_next = __ldg(tile_lo + tile);
        for (int c = 0; c < n_ch; ++c) {
            const int lo = lo_next;  // the next channel's is read meanwhile
            if (c + 1 < n_ch)
                lo_next = __ldg(tile_lo + (long long)(c + 1) * n_tiles + tile);
            if (lo < 0) continue;  // no template of the tile uses channel c
            const int st = it % stages;
            if (it >= stages)      // the consumers are done with the stage
                mbar_wait(bars + 8 * (stages + st), (it / stages - 1) & 1);
            const uint32_t sb = base + st * s.stage_bytes;
            const long long g0 = (b0 + lo) & ~7LL;
            const long long crow = (long long)c * ext_al;
            // the data span's parts, 16-byte chunks at their swizzled place;
            // ext_al is a multiple of 64, so a chunk is all in or all out
            for (int u = pt; u < s.span / 8; u += 128) {
                const long long gi = g0 + 8LL * u;
                const int n = gi < ext_al ? 16 : 0;
                const long long src = crow + (n ? gi : 0);
                const uint32_t sw = mfs_swz(16u * u);
                cp16(sb + sw, dh + src, n);
                cp16(sb + s.o_lo + sw, dl + src, n);
            }
            // y, 8 pad words after every 128
            for (int u = pt; u < s.n_y4 / 4; u += 128) {
                const long long gi = g0 + 4LL * u;
                const int n = gi < ext_al ? 16 : 0;
                cp16(sb + s.o_y + 16 * u + 32 * (u >> 5),
                     yg + crow + (n ? gi : 0), n);
            }
            // the block's template rows, one contiguous block
            const unsigned char* fsrc = reinterpret_cast<const unsigned char*>(
                rows + ((long long)c * n_tp_pad + t0) * 4 * s.row);
            for (int u = pt; u < s.f_bytes / 16; u += 128)
                cp16(sb + s.o_f + 16 * u, fsrc + 16LL * u, 16);
            if (pt < MFS_TPB)
                cp4(sb + s.o_mv + 4 * pt,
                    mvf + (long long)c * n_tp_pad + t0 + pt);
            cp_arrive(bars + 8 * st);
            ++it;
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
        // the consumer warpgroups: templates wg * MFS_TPW + u of the block,
        // their k-steps issued together, one group of products a k-step
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                     :: "n"(MFS_CONSUMER_REGS));
        const int wg = tid >> 7;
        const int w = (tid >> 5) & 3;
        const int lane = tid & 31;
        const int g = lane >> 2, q = lane & 3;
        const int m = 16 * w + g;            // this thread's first row
        const int n_ks = s.K / 16;
        const int b0i = (int)b0;             // positions fit 31 bits
        float tot[MFS_TPW][32];
#pragma unroll
        for (int ti = 0; ti < MFS_TPW; ++ti)
#pragma unroll
            for (int r = 0; r < 32; ++r) tot[ti][r] = 0.0f;

        int it = 0;
        int lo_next = __ldg(tile_lo + tile);
        for (int c = 0; c < n_ch; ++c) {
            const int lo = lo_next;
            if (c + 1 < n_ch)
                lo_next = __ldg(tile_lo + (long long)(c + 1) * n_tiles + tile);
            if (lo < 0) continue;
            const int st = it % stages;
            mbar_wait(bars + 8 * st, (it / stages) & 1);
            // the copies landed; order them before the tensor cores' reads
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            const uint32_t sb = base + st * s.stage_bytes;
            const unsigned char* sg = base_g + st * s.stage_bytes;
            const int g0 = (b0i + lo) & ~7;
            const int* mv_s = reinterpret_cast<const int*>(sg + s.o_mv);
            const float* y_s = reinterpret_cast<const float*>(sg + s.o_y);
#if MFS_DIAG != 2
            // no branch around the tensor cores' instructions (ptxas
            // serializes them in a path it cannot prove uniform): a
            // template that skips the channel multiplies the span's start
            // and adds nothing
            int a[MFS_TPW];
            bool used[MFS_TPW];
#pragma unroll
            for (int u = 0; u < MFS_TPW; ++u) {
                const int mv = mv_s[wg * MFS_TPW + u];
                used[u] = mv >= 0;
                a[u] = used[u] ? b0i + mv - g0 : 0;   // < max_delta + 8
            }
            // written first by a product with scale-d 0: no other
            // instruction may define the accumulators while products are in
            // flight, or ptxas serializes them
            float acc[MFS_TPW][32];
#if MFS_DIAG == 1
#pragma unroll
            for (int u = 0; u < MFS_TPW; ++u)
#pragma unroll
                for (int r = 0; r < 32; ++r) acc[u][r] = 0.0f;
#else
            uint32_t bh[MFS_TPW];
            const uint32_t* fh[MFS_TPW];
#pragma unroll
            for (int u = 0; u < MFS_TPW; ++u) {
                const int dlt = a[u] & 7;
                bh[u] = sb + 2 * (a[u] - dlt);        // 16-byte aligned
                // A[m, k] = f[k - m - dlt] = row[k - m - dlt + OFF]; the
                // pair (k, k + 1) is one word of the copy with par = the
                // parity of m + dlt (rows m and m + 8 alike)
                const int par = (m + dlt) & 1;
                const int x0 = 2 * q - m - dlt + MFS_OFF - par;
                fh[u] = reinterpret_cast<const uint32_t*>(
                            sg + s.o_f + (wg * MFS_TPW + u) * 8 * s.row)
                        + par * (s.row >> 1) + (x0 >> 1);
            }
            uint32_t ah0[MFS_TPW][4], al0[MFS_TPW][4];
            uint32_t ah1[MFS_TPW][4], al1[MFS_TPW][4];
            // one k-step of every template into registers (ah, al): rows
            // m, m + 8 at k = 16 ks + 2q and + 8 (row m + 8: 8 taps, 4
            // words, back; the lo part s.row words on), then its products,
            // one group
#define MFS_STEP(ah, al, ks)                                                 \
            {                                                                \
                const int o = 8 * (ks);                                      \
                _Pragma("unroll")                                            \
                for (int u = 0; u < MFS_TPW; ++u) {                          \
                    const uint32_t* f = fh[u] + o;                           \
                    ah[u][0] = f[0]; ah[u][1] = f[-4];                       \
                    ah[u][2] = f[4]; ah[u][3] = f[0];                        \
                    al[u][0] = f[s.row]; al[u][1] = f[s.row - 4];            \
                    al[u][2] = f[s.row + 4]; al[u][3] = f[s.row];            \
                }                                                            \
                wgmma_fence();                                               \
                _Pragma("unroll")                                            \
                for (int u = 0; u < MFS_TPW; ++u) {                          \
                    const uint64_t db = mfs_desc(bh[u] + 32 * (ks));         \
                    const uint64_t dc = mfs_desc(bh[u] + s.o_lo + 32 * (ks));\
                    wgmma_bf16(acc[u], ah[u], db, (ks) > 0);  /* fh*dh */    \
                    wgmma_bf16(acc[u], ah[u], dc, 1);         /* fh*dl */    \
                    wgmma_bf16(acc[u], al[u], db, 1);         /* fl*dh */    \
                }                                                            \
                wgmma_commit();                                              \
                wgmma_wait<1>();                                             \
            }
            int ks = 0;
            for (; ks + 1 < n_ks; ks += 2) {
                MFS_STEP(ah0, al0, ks)
                MFS_STEP(ah1, al1, ks + 1)
            }
            if (ks < n_ks) MFS_STEP(ah0, al0, ks)
#undef MFS_STEP
            wgmma_wait<0>();
#pragma unroll
            for (int u = 0; u < MFS_TPW; ++u) fence_acc(acc[u]);
#endif
#pragma unroll
            for (int u = 0; u < MFS_TPW; ++u) {
                // lag of acc[4 j + 2 h + e]: 512 j + 128 q + 64 e + m + 8 h;
                // y of lag l at a + l, stored at i + 8 (i >> 7)
                const int pb = g0 + a[u];        // padded position of lag 0
                const bool full = used[u] && pb >= lo_p
                                  && pb + MFS_T - 1 <= hi_p;
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int r = a[u] + m + 8 * h + 64 * e;
                        const float* yr = y_s + r + 8 * (r >> 7) + 136 * q;
                        const int pr = pb + m + 8 * h + 64 * e + 128 * q;
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            const float v = acc[u][4 * j + 2 * h + e]
                                            * yr[544 * j];
                            const int p = pr + 512 * j;
                            tot[u][4 * j + 2 * h + e] +=
                                (full || (used[u] && p >= lo_p && p <= hi_p))
                                    ? v : 0.0f;
                        }
                    }
            }
#endif
            __syncwarp();
            if (lane == 0) mbar_arrive(bars + 8 * (stages + st));
            ++it;
        }

#pragma unroll
        for (int ti = 0; ti < MFS_TPW; ++ti) {
            const int t = t0 + wg * MFS_TPW + ti;
            if (t >= n_tp) continue;
            float* orow = out + (long long)t * n_corr;
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const int b = b0i + 512 * j + 128 * q + 64 * e + m
                                      + 8 * h;
                        if (b < n_corr) orow[b] = tot[ti][4 * j + 2 * h + e];
                    }
        }
    }
}

extern "C" {

// Dynamic shared memory (bytes) one block of the main kernel needs, with
// the deepest ring that fits.
long long mf_split_smem_bytes(int L, int max_delta)
{
    return mfs_layout(L, max_delta).total;
}

int mf_split_stages(int L, int max_delta)
{
    return mfs_layout(L, max_delta).stages;
}

int mf_split_block_templates(void) { return MFS_TPB; }

int mf_split_tile_lags(void) { return MFS_T; }

int mf_split_row_width(int L) { return mfs_row(L); }

long long mf_split_prepass_smem_bytes(int L)
{
    return 4LL * mf_prepass_floats(MFS_PP, L);
}

// The pre-pass on `stream`: y, hi and lo of every window start, (n_ch,
// ext_al) each; returns the cudaError_t of the launch (0 = ok).
int mf_split_prepass_launch(const void* data, long long ext, long long ext_al,
                            int n_ch, int L, void* dh, void* dl, void* y,
                            void* stream)
{
    if (ext_al <= 0 || n_ch <= 0) return 0;
    const long long smem = mf_split_prepass_smem_bytes(L);
    cudaError_t e = cudaFuncSetAttribute(
        mf_split_prepass, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((ext_al + MFS_PP - 1) / MFS_PP), (unsigned)n_ch);
    mf_split_prepass<<<grid, MFS_PP_THREADS, (size_t)smem,
                       (cudaStream_t)stream>>>(
        (const float*)data, ext, ext_al, L, (__nv_bfloat16*)dh,
        (__nv_bfloat16*)dl, (float*)y);
    return (int)cudaGetLastError();
}

// The main kernel on `stream`, on the pre-pass's arrays; returns the
// cudaError_t of the launch (0 = ok).
int mf_split_launch(const void* dh, const void* dl, const void* y,
                    long long ext_al, const void* rows, const void* mvf,
                    const void* tile_lo, void* out, int n_ch, int n_tp,
                    int n_tp_pad, int L, long long n_corr, long long lo_p,
                    long long hi_p, int max_delta, void* stream)
{
    if (n_corr <= 0 || n_tp <= 0) return 0;
    // the kernel keeps positions in 32 bits
    if (ext_al > INT_MAX - 2 * MFS_T || n_corr > INT_MAX - 2 * MFS_T)
        return (int)cudaErrorInvalidValue;
    const int lo_c = (int)(lo_p < -(INT_MAX / 2) ? -(INT_MAX / 2) : lo_p);
    const int hi_c = (int)(hi_p > INT_MAX / 2 ? INT_MAX / 2 : hi_p);
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, mf_split_kernel);
    if (e != cudaSuccess) return (int)e;
    // setmaxnreg moves registers inside the block's own allocation: a
    // smaller one would leave the consumers waiting for registers forever
    if (attr.numRegs * MFS_THREADS
        < 128 * MFS_PRODUCER_REGS + 128 * MFS_CWG * MFS_CONSUMER_REGS)
        return (int)cudaErrorInvalidConfiguration;
    const long long smem = mf_split_smem_bytes(L, max_delta);
    e = cudaFuncSetAttribute(
        mf_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((n_tp + MFS_TPB - 1) / MFS_TPB),
              (unsigned)((n_corr + MFS_T - 1) / MFS_T));
    mf_split_kernel<<<grid, MFS_THREADS, (size_t)smem,
                      (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)dh, (const __nv_bfloat16*)dl, (const float*)y,
        ext_al, (const __nv_bfloat16*)rows, (const int*)mvf,
        (const int*)tile_lo, (float*)out, n_ch, n_tp, n_tp_pad, L,
        (int)n_corr, lo_c, hi_c, max_delta);
    return (int)cudaGetLastError();
}

const char* mf_split_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
