// Fused normalized, network-summed matched filter at f32-class accuracy:
// every product operand split in two TF32 parts, the products on Hopper's
// warpgroup tensor-core instruction (`wgmma`, CUDA C++, sm_90a).
//
// Replaces the TPU kernel `seismic_bpmf_tpu/ops/pallas_mf.py::_mf_kernel`
// at the f32 rungs: this build serves 'default' and the 'screen' scan, the
// build with MF_ACC_OUT=1 serves 'highest' (below; the `high` twin
// `_mf_kernel_split` is csrc/mf_split.cu).  It computes
//
//   fh = tf32(f),  fl = tf32(f - fh)                (host, once per plan)
//   dh = tf32(d),  dl = tf32(d - dh)                (pre-pass, once a call)
//   corr[t, c, b] = sum_j (fh*dh + fh*dl) + (fl*dh + fl*dl)
//                                                   at d index b+mv[c,t]+j
//   out[t, b] = sum_c mask(t, c, b) * y_c(b + mv[c, t]) * corr[t, c, b]
//
// with tf32 = cvt.rna.tf32.f32 (round to nearest, ties away from zero, the
// low 13 bits cleared; `ops.mf.split_tf32` is the same on the host), f the
// demeaned, weight-over-norm scaled template rows, d the padded data,
// y_c(p) = rsqrt(r2 - r1^2 / L) from the L-sample window sums of the
// UNSPLIT f32 data at padded position p (0 where the window variance is
// <= 1e-10, so zero-filled gaps give CC = 0), mask = p in [lo_p, hi_p], i.e.
// the template's window lies inside the unpadded data, and channels with
// mv = -1 skipped: y, the mask and the skip are those of csrc/mf_split.cu.
// A TF32 value has 11 significant bits, so each product of two parts is
// exact in f32; the sums are f32 (the tensor cores' additions truncate).
// The residuals of the lo parts are ~2^-22 of a product: f32-class.  The
// plain version `ops.mf.matched_filter_plain` sums each product over all
// taps first and adds (hh + hl) + (lh + ll): the same four products, equal
// up to f32 reassociation.
//
// What bounds it on an H100: operations on the tensor cores.  One day of
// the main path (128 templates x 30 channels x 200 taps x 2.16 M lags) is
// 3 x 3.32e12 TF32 operations against ~1.4 GB of data in and CC out:
// ~20 ms at 495 TFLOP/s dense TF32, memory ~0.4 ms.  The previous design
// (`mma.sync.m16n8k8`, which also served 'highest') staged and split
// each channel's span and recomputed its window norms in every block,
// between two block barriers, for each of the bank's template tiles again,
// and `mma.sync` TF32 peaks well below the card's rate: 63.9 ms a day on an
// H100 80GB HBM3 at 700 W.  This design issues 4/3 x 240/200 of the bound's
// operations (the fl*dl products and the zero taps), 32 ms at the peak rate;
// its product loop alone runs at ~440 TFLOP/s, and the day takes ~45 ms:
// the epilogue and the staging (~12 ms alone, the span restaged for every
// block of 4 templates) overlap the products only in part (PERF.md,
// tools/mf_tile_sweep.py mf).
//
// Design: csrc/mf_split.cu's, for TF32.  Two kernels.  `mf_prepass` runs
// once a call: for every window start of the padded day it writes y
// (csrc/mf_window.cuh's partial order, shared with csrc/mf_split.cu's
// pre-pass: y at p reads the data from p on only) and the day's TF32 hi and
// lo parts.  `mf_kernel` then never splits or normalizes anything: a
// block's 4 templates x 2048 lags read those arrays through a ring of
// shared-memory stages, one channel a stage, that a producer warpgroup
// fills with `cp.async` and `mbarrier`s while four consumer warpgroups, one
// template each, multiply on the stage before it (`setmaxnreg` moves
// registers from the producer to them).
//   `wgmma` takes TF32 operands K-major only, 8 (32 bytes) a k-step, and a
// 128-byte swizzled row of B holds 32 of them.  So for one (template,
// channel) the 2048 lags are one m64n64k8 product chain whose 64 columns
// lie 32 lags apart and whose 64 rows are 32 shifts of the template's hi
// part and the same 32 shifts of its lo part:
//
//   D[m, n] = sum_k A[m, k] B[k, n]   = corr of part(m) at lag 32 n + s(m)
//   A[m, k] = f_part(m)[k - s(m) - delta]   (registers)
//   B[k, n] = d_x[a - delta + 32 n + k]     (the dh or the dl span)
//
// with rows 16 w + g the hi part and 16 w + g + 8 the lo part of shift
// s = 8 w + g (w the warp of the warpgroup, g = lane / 4: the two rows of
// one thread's accumulator fragment), a = b0 + mv - G0 the template's
// offset in the staged span (G0 the span's 16-byte aligned start) and
// delta = a mod 4, so that B starts on a 16-byte boundary whatever the
// moveout; K = L + 34 rounded up to 8 (240 for L = 200: 83% of the
// products add taps).  Two `wgmma` a k-step, B = dh then B = dl, give
// fh*dh + fh*dl in one row and fl*dh + fl*dl in the other; the epilogue
// adds the two in registers.  B is the span as it is, 128-byte rows 32
// samples apart, read by a `wgmma` descriptor in the 128-byte swizzle (the
// producer stores each 16-byte chunk at its swizzled place; the swizzle
// follows the address, so a start on any 16-byte boundary reads what was
// stored there), so all templates of a block share one staged copy of the
// day; the k-step s reads the descriptor 32 s bytes on.  A is loaded into
// the operand registers each k-step from the template's rows (a warp's
// loads touch 11 neighbouring words of a row: no bank conflict), staged
// with MF_FRONT zeros in front so that every shift reads zeros before the
// taps.  A consumer warpgroup issues two k-steps of its template as one
// group of four products and waits for the group before last (four
// warpgroups of one template, groups of two k-steps: 45.4 ms a day, where
// two warpgroups of two templates with groups of one k-step took 51.9).
// After the k-steps the epilogue multiplies each lag by y (staged with 8
// pad words after every 64, which puts a warp's 32 loads in 32 banks),
// masks it and adds it to the template's network sum, which stays in
// registers across channels; each output is written once.  No branch surrounds the
// tensor cores' instructions (ptxas serializes them on a path it cannot
// prove uniform), so a template that skips a channel multiplies the
// span's start and adds nothing; the accumulators are first written by a
// product with scale-d 0.
//   The ring has up to MF_STAGES stages (the launch takes as many as fit
// shared memory); a channel that `tile_lo` marks -1 is skipped by the
// producer and the consumers alike, so it costs no stage.  The times of
// each design are in PERF.md (tools/mf_tile_sweep.py mf, mf_highest).  The
// index maps are mirrored on the CPU by tests/test_torch_mf_tc.py.
//
// The 'highest' build (MF_ACC_OUT=1) differs in the consumers' sums alone.
// The tensor cores add into their f32 accumulator with truncation, not
// round to nearest.  Near a detection every product of a channel has one
// sign, so a sum carried through a channel's 60 dependent products loses a
// little at each, always toward zero: ~2e-6 of the CC at the main path's
// shape, where 'highest' must stay within 1e-6 of the float64 oracle.  So
// each group of MF_ACC_G k-steps of a template is summed from zero in a
// partial fragment (B = dl first, with scale-d 0, then B = dh): the tensor
// cores truncate only at the scale of one group's partial.  The partial is
// added into the running sum by an ordinary round-to-nearest f32 add; the
// sum keeps its hi and lo rows apart until the epilogue.  The add reads the
// partial only once its group has finished (`wgmma.wait_group 0`): ptxas
// serializes every `wgmma` of the kernel where an accumulator is read while
// another product is in flight, as a second partial alternating with the
// first would need.  So a consumer warpgroup leaves the tensor cores to the
// other three while it adds; a k-step is a commit group of its own, its A
// in one of two register sets.  The sum, the partial and the network sum
// fit the 112 registers a consumer thread has, as the accumulator and the
// network sum of the default build do.  One day of the main path on an
// H100 80GB HBM3 at 700 W: 53.9 ms at MF_ACC_G = 2, where the `mma.sync`
// design that served 'highest' before took 72.3 in the same run; larger
// groups run faster (48.9 ms at 5, 47.0 at 10) but lie further from the
// oracle at planted repeats (4.8e-07 and 6.6e-07, 2.4e-07 at 2), and two
// consumer warpgroups of two templates each ran slower (52.4 ms at 5)
// (PERF.md, tools/mf_tile_sweep.py mf_highest).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mf_window.cuh"

#ifndef MF_STAGES
#define MF_STAGES 4     // deepest ring a launch may use
#endif
#ifndef MF_DIAG
#define MF_DIAG 0       // diagnostic builds: 1 no products, 2 staging only,
                        // 3 products only (no copies, no waits for the
                        // stages, no epilogue: the product loop's own
                        // rate), 4 products and epilogue (no copies, no
                        // waits)
#endif
#ifndef MF_ACC_OUT
#define MF_ACC_OUT 0    // 1: the 'highest' build (partials summed outside
                        // the tensor cores' accumulator)
#endif
#ifndef MF_ACC_G
#define MF_ACC_G 2      // k-steps a partial of the 'highest' build
#endif
#define MF_YG 16        // samples per partial of the window sums
#define MF_N 64         // columns of one product, 32 lags apart
#define MF_T (32 * MF_N)                 // lags a block: 2048
#define MF_TPB 4        // templates a block
#define MF_CWG 4        // consumer warpgroups
#define MF_TPW (MF_TPB / MF_CWG)         // templates a consumer warpgroup
#define MF_GROUP 2      // k-steps a group of products
#define MF_THREADS (128 * MF_CWG + 128)  // and a producer warpgroup
// registers a thread after `setmaxnreg`: the producer gives, the consumers
// take, inside the block's allocation at launch (96 a thread for 640
// threads: 128 x 32 + 512 x 112); the launch checks that the kernel's own
// count covers both
#define MF_PRODUCER_REGS 32
#define MF_CONSUMER_REGS 112
#if MF_ACC_OUT && MF_ACC_G < 1
#error "a partial of the 'highest' build takes one k-step at least"
#endif
#define MF_GFRONT 8     // zeros in front of a row as the plan stages it
#define MF_FRONT 40     // zeros in front of a row in a stage: >= 31 + 3
#define MF_TILE 32      // templates a `tile_lo` entry covers (TEMPLATE_TILE)
#define MF_PP 2048      // window starts a pre-pass block
#define MF_PP_THREADS 256
#define MF_SMEM_LIMIT 232448

struct MfLayout {
    int K, row, grow, span, n_y4, stages;
    int o_lo, o_f, o_y, o_mv, f_bytes, stage_bytes;
    long long total;
};

// taps a k-loop covers: every shift s < 32 and delta < 4 of an L-tap row
__host__ __device__ inline int mf_k(int L) { return ((L + 34 + 7) / 8) * 8; }

// elements of a staged template row: MF_FRONT zeros, then K taps' room
__host__ __device__ inline int mf_row(int L) { return mf_k(L) + MF_FRONT; }

// elements of a template row as the plan lays it out (`stage_tf32_rows`):
// MF_GFRONT zeros, the taps, zeros to round_up(L + 7, 8) + MF_GFRONT
__host__ __device__ inline int mf_grow(int L)
{
    return ((L + 7 + 7) / 8) * 8 + MF_GFRONT;
}

__host__ __device__ inline MfLayout mf_layout_n(int L, int max_delta,
                                                int stages)
{
    MfLayout s;
    s.K = mf_k(L);
    s.row = mf_row(L);
    s.grow = mf_grow(L);
    // the data span (f32): B reads up to a - delta + 32 (MF_N - 1) + K - 1
    // with a < max_delta + 4
    s.span = ((max_delta + 4 + 32 * (MF_N - 1) + s.K + 31) / 32) * 32;
    const int pb = ((4 * s.span + 1023) / 1024) * 1024;
    // y for window starts a + lag < max_delta + 4 + MF_T
    s.n_y4 = ((max_delta + 4 + MF_T + 3) / 4) * 4;
    const int y_words = s.n_y4 + 8 * ((s.n_y4 + 63) / 64);
    s.f_bytes = MF_TPB * 2 * 4 * s.row;   // hi rows, then lo rows
    s.o_lo = pb;
    s.o_f = 2 * pb;
    s.o_y = s.o_f + s.f_bytes;
    s.o_mv = s.o_y + 4 * y_words;
    s.stage_bytes = ((s.o_mv + 4 * MF_TPB + 1023) / 1024) * 1024;
    s.stages = stages;
    // 1 KB to align the ring, then the stages, then the mbarriers
    s.total = 1024 + (long long)stages * s.stage_bytes + 16 * stages;
    return s;
}

// the deepest ring that fits, 1 when none does
__host__ __device__ inline MfLayout mf_layout(int L, int max_delta)
{
    for (int n = MF_STAGES; n > 1; --n) {
        const MfLayout s = mf_layout_n(L, max_delta, n);
        if (s.total <= MF_SMEM_LIMIT) return s;
    }
    return mf_layout_n(L, max_delta, 1);
}

__device__ __forceinline__ float tf32_rna(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
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
__host__ __device__ __forceinline__ uint32_t mf_swz(uint32_t off)
{
    return off ^ ((off >> 3) & 0x70);
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows 128
// bytes apart, 8-row groups 1024 bytes apart, base offset 0 (the swizzle
// is a function of the shared-memory address)
__device__ __forceinline__ uint64_t mf_desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A B: A 64 x 8 TF32 in registers (thread (w, g, q): rows 16 w + g
// and + 8 at k = q and q + 4), B 8 x 64 TF32 through `desc`
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

// stores one window start's TF32 parts and y
struct MfPut {
    float* dh;
    float* dl;
    float* y;
    long long o;
    __device__ __forceinline__ void operator()(int i, float v,
                                               float yv) const
    {
        const float h = tf32_rna(v);
        dh[o + i] = h;
        dl[o + i] = tf32_rna(v - h);
        y[o + i] = yv;
    }
};

// y and the TF32 parts of every window start of the padded day:
// (n_ch, ext_al) each, zero parts beyond ext
__global__ void __launch_bounds__(MF_PP_THREADS)
mf_prepass(const float* __restrict__ data, long long ext, long long ext_al,
           int L, float* __restrict__ dh, float* __restrict__ dl,
           float* __restrict__ y)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int c = blockIdx.y;
    const long long p0 = (long long)blockIdx.x * MF_PP;
    const MfPut put{dh, dl, y, (long long)c * ext_al + p0};
    mf_prepass_block<MF_YG, MF_PP, MF_PP_THREADS>(
        data + (long long)c * ext, ext, ext_al, p0, L,
        reinterpret_cast<float*>(smem_raw), put);
}

__global__ void __launch_bounds__(MF_THREADS, 1)
mf_kernel(const float* __restrict__ dh,      // (n_ch, ext_al) TF32 parts
          const float* __restrict__ dl,
          const float* __restrict__ yg,      // (n_ch, ext_al) window norms
          long long ext_al,
          // (n_ch, n_tiles, hi/lo, MF_TILE, grow) staged TF32 rows
          const float* __restrict__ rows,
          const int* __restrict__ mvf,       // (n_ch, n_tp_pad); -1 = skip
          const int* __restrict__ tile_lo,   // (n_ch, n_tiles); -1 = skip
          float* __restrict__ out,           // (n_tp, n_corr)
          int n_ch, int n_tp, int n_tp_pad, int L, int n_corr, int lo_p,
          int hi_p, int max_delta)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const MfLayout s = mf_layout(L, max_delta);
    const int stages = s.stages;
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* const base_g = smem_raw + (base - raw);
    // full[i] at bars + 8 i, empty[i] at bars + 8 (stages + i)
    const uint32_t bars = base + stages * s.stage_bytes;
    const int tid = threadIdx.x;
    const int t0 = blockIdx.x * MF_TPB;
    const long long b0 = (long long)blockIdx.y * MF_T;
    const int n_tiles = n_tp_pad / MF_TILE;
    const int tile = t0 / MF_TILE;
    // the staged rows' zeros (in front of and after the plan's rows) are
    // written once: the producer copies the rows between them
    for (int st = 0; st < stages; ++st) {
        float* f = reinterpret_cast<float*>(base_g + st * s.stage_bytes
                                            + s.o_f);
        for (int i = tid; i < s.f_bytes / 4; i += MF_THREADS) f[i] = 0.0f;
    }
    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(bars + 8 * i, 128);                 // producer threads
            mbar_init(bars + 8 * (stages + i), 4 * MF_CWG);  // consumer warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= 128 * MF_CWG) {
        // the producer warpgroup: channel after channel into the ring
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(MF_PRODUCER_REGS));
        const int pt = tid - 128 * MF_CWG;
        const int n16 = s.grow / 4;        // 16-byte chunks of a plan row
        int it = 0;
#if MF_DIAG >= 3
        n_ch = 0;                          // no copies, no stages
#endif
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
            const long long g0 = (b0 + lo) & ~3LL;
            const long long crow = (long long)c * ext_al;
            // the data span's parts, 16-byte chunks at their swizzled place;
            // ext_al is a multiple of 64, so a chunk is all in or all out
            for (int u = pt; u < s.span / 4; u += 128) {
                const long long gi = g0 + 4LL * u;
                const int n = gi < ext_al ? 16 : 0;
                const long long src = crow + (n ? gi : 0);
                const uint32_t sw = mf_swz(16u * u);
                cp16(sb + sw, dh + src, n);
                cp16(sb + s.o_lo + sw, dl + src, n);
            }
            // y, 8 pad words after every 64
            for (int u = pt; u < s.n_y4 / 4; u += 128) {
                const long long gi = g0 + 4LL * u;
                const int n = gi < ext_al ? 16 : 0;
                cp16(sb + s.o_y + 16 * u + 32 * (u >> 4),
                     yg + crow + (n ? gi : 0), n);
            }
            // the block's template rows, each MF_FRONT - MF_GFRONT
            // elements into its staged row
            const float* rsrc = rows
                + ((long long)c * n_tiles + tile) * 2 * MF_TILE * s.grow
                + (long long)(t0 % MF_TILE) * s.grow;
            // hi rows r = u, lo rows r = 4 + u
            for (int v = pt; v < 2 * MF_TPB * n16; v += 128) {
                const int r = v / n16, i = v - r * n16;
                const int part = r / MF_TPB, u = r - part * MF_TPB;
                cp16(sb + s.o_f + 4 * (r * s.row + MF_FRONT - MF_GFRONT
                                       + 4 * i),
                     rsrc + (long long)part * MF_TILE * s.grow
                         + u * s.grow + 4 * i, 16);
            }
            if (pt < MF_TPB)
                cp4(sb + s.o_mv + 4 * pt,
                    mvf + (long long)c * n_tp_pad + t0 + pt);
            cp_arrive(bars + 8 * st);
            ++it;
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
        // the consumer warpgroups: templates wg * MF_TPW + u of the block,
        // their k-steps issued together, one group of products a k-step
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                     :: "n"(MF_CONSUMER_REGS));
        const int wg = tid >> 7;
        const int w = (tid >> 5) & 3;
        const int lane = tid & 31;
        const int g = lane >> 2, q = lane & 3;
        const int sft = 8 * w + g;           // the shift of this thread's rows
        const int n_ks = s.K / 8;
        const int b0i = (int)b0;             // positions fit 31 bits
        const int lo_off = MF_TPB * s.row;   // a template's lo row, words on
        float tot[MF_TPW][16];
#pragma unroll
        for (int ti = 0; ti < MF_TPW; ++ti)
#pragma unroll
            for (int r = 0; r < 16; ++r) tot[ti][r] = 0.0f;

        int it = 0;
        int lo_next = __ldg(tile_lo + tile);
        for (int c = 0; c < n_ch; ++c) {
            const int lo = lo_next;
            if (c + 1 < n_ch)
                lo_next = __ldg(tile_lo + (long long)(c + 1) * n_tiles + tile);
            if (lo < 0) continue;
            const int st = it % stages;
#if MF_DIAG < 3
            mbar_wait(bars + 8 * st, (it / stages) & 1);
#endif
            // the copies landed; order them before the tensor cores' reads
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            const uint32_t sb = base + st * s.stage_bytes;
            const unsigned char* sg = base_g + st * s.stage_bytes;
            const int g0 = (b0i + lo) & ~3;
            const int* mv_s = reinterpret_cast<const int*>(sg + s.o_mv);
            const float* y_s = reinterpret_cast<const float*>(sg + s.o_y);
#if MF_DIAG != 2
            // no branch around the tensor cores' instructions (ptxas
            // serializes them in a path it cannot prove uniform): a
            // template that skips the channel multiplies the span's start
            // and adds nothing
            int a[MF_TPW];
            bool used[MF_TPW];
#pragma unroll
            for (int u = 0; u < MF_TPW; ++u) {
#if MF_DIAG >= 3
                // nothing was staged: products at offsets that differ from
                // template to template and channel to channel, the epilogue
                // on what the stage holds
                used[u] = mv_s[wg * MF_TPW + u] >= 0;
                a[u] = (61 * (wg * MF_TPW + u) + 29 * c) % (max_delta + 1);
#else
                const int mv = mv_s[wg * MF_TPW + u];
                used[u] = mv >= 0;
                a[u] = used[u] ? b0i + mv - g0 : 0;   // < max_delta + 4
#endif
            }
            // the tensor cores' accumulators (the partials of the 'highest'
            // build) are written first by a product with scale-d 0: no
            // other instruction may define them while products are in
            // flight, or ptxas serializes them
            float acc[MF_TPW][32];
#if MF_DIAG == 1
#pragma unroll
            for (int u = 0; u < MF_TPW; ++u)
#pragma unroll
                for (int r = 0; r < 32; ++r) acc[u][r] = 0.0f;
#else
            uint32_t bh[MF_TPW];
            const uint32_t* fr[MF_TPW];
#pragma unroll
            for (int u = 0; u < MF_TPW; ++u) {
                const int dlt = a[u] & 3;
                bh[u] = sb + 4 * (a[u] - dlt);        // 16-byte aligned
                // A[16 w + g, k] = fh[k - sft - dlt] = row[k - sft - dlt +
                // MF_FRONT], A[16 w + g + 8, k] the same of fl
                fr[u] = reinterpret_cast<const uint32_t*>(sg + s.o_f)
                        + (wg * MF_TPW + u) * s.row + MF_FRONT + q - sft
                        - dlt;
            }
            // k-step ks of a template into registers: k = 8 ks + q and + 4
            // of the hi and the lo row
#define MF_LOAD_A(r, f, o)                                                   \
            {                                                                \
                r[0] = f[o]; r[1] = f[(o) + lo_off];                         \
                r[2] = f[(o) + 4]; r[3] = f[(o) + lo_off + 4];               \
            }
#if MF_ACC_OUT
            // each group of MF_ACC_G k-steps of template u summed from zero
            // into `part` (B = dl first, with scale-d 0, then dh) and added
            // into acc[u] in round-to-nearest f32 once the whole group has
            // finished (the note at the top: ptxas serializes the products
            // if an accumulator is read while one is in flight, even after
            // wait_group 1); a k-step is a commit group of its own, its A in
            // one of two register sets, loaded while the k-step before runs
            float part[32];
            uint32_t ar[2][4];
#pragma unroll
            for (int u = 0; u < MF_TPW; ++u)
#pragma unroll
                for (int r = 0; r < 32; ++r) acc[u][r] = 0.0f;
#define MF_PARTIAL(u, ks, nk)                                                \
            {                                                                \
                _Pragma("unroll")                                            \
                for (int kk = 0; kk < (nk); ++kk) {                          \
                    const uint32_t o = 32 * ((ks) + kk);                     \
                    if (kk >= 2)            /* its A set is free */          \
                        wgmma_wait<1>();                                     \
                    MF_LOAD_A(ar[kk & 1], fr[u], 8 * ((ks) + kk))            \
                    wgmma_fence();                                           \
                    wgmma_tf32(part, ar[kk & 1],                             \
                               mf_desc(bh[u] + s.o_lo + o), kk > 0);         \
                    wgmma_tf32(part, ar[kk & 1], mf_desc(bh[u] + o), 1);     \
                    wgmma_commit();                                          \
                }                                                            \
                wgmma_wait<0>();                                             \
                fence_acc(part);                                             \
                _Pragma("unroll")                                            \
                for (int r = 0; r < 32; ++r) acc[u][r] += part[r];           \
            }
            const int n_grp = n_ks / MF_ACC_G;
            for (int gi = 0; gi < n_grp; ++gi)
#pragma unroll
                for (int u = 0; u < MF_TPW; ++u)
                    MF_PARTIAL(u, MF_ACC_G * gi, MF_ACC_G)
            // the k-steps after the last whole group, one a group
            for (int ks = MF_ACC_G * n_grp; ks < n_ks; ++ks)
#pragma unroll
                for (int u = 0; u < MF_TPW; ++u)
                    MF_PARTIAL(u, ks, 1)
#undef MF_PARTIAL
#else
            uint32_t a0[MF_TPW][MF_GROUP][4], a1[MF_TPW][MF_GROUP][4];
            // k-steps ks .. ks + nk - 1 of every template into registers,
            // then their products, one group
#define MF_STEP(ar, ks, nk)                                                  \
            {                                                                \
                _Pragma("unroll")                                            \
                for (int i = 0; i < (nk); ++i)                               \
                    _Pragma("unroll")                                        \
                    for (int u = 0; u < MF_TPW; ++u)                         \
                        MF_LOAD_A(ar[u][i], fr[u], 8 * ((ks) + i))           \
                wgmma_fence();                                               \
                _Pragma("unroll")                                            \
                for (int i = 0; i < (nk); ++i)                               \
                    _Pragma("unroll")                                        \
                    for (int u = 0; u < MF_TPW; ++u) {                       \
                        const uint32_t o = 32 * ((ks) + i);                  \
                        const uint64_t dh_d = mf_desc(bh[u] + o);            \
                        const uint64_t dl_d = mf_desc(bh[u] + s.o_lo + o);   \
                        wgmma_tf32(acc[u], ar[u][i], dh_d, (ks) + i > 0);    \
                        wgmma_tf32(acc[u], ar[u][i], dl_d, 1);               \
                    }                                                        \
                wgmma_commit();                                              \
                wgmma_wait<1>();                                             \
            }
            int ks = 0;
            for (; ks + 2 * MF_GROUP <= n_ks; ks += 2 * MF_GROUP) {
                MF_STEP(a0, ks, MF_GROUP)
                MF_STEP(a1, ks + MF_GROUP, MF_GROUP)
            }
            // fewer than 2 MF_GROUP k-steps left: one a group
            if (ks < n_ks) MF_STEP(a0, ks, 1)
            if (ks + 1 < n_ks) MF_STEP(a1, ks + 1, 1)
            if (ks + 2 < n_ks) MF_STEP(a0, ks + 2, 1)
#undef MF_STEP
            wgmma_wait<0>();
#pragma unroll
            for (int u = 0; u < MF_TPW; ++u) fence_acc(acc[u]);
#endif
#undef MF_LOAD_A
#if MF_DIAG == 3
            // keeps the products: ptxas drops those whose sums go unused
            if (lo_p == INT_MIN)
#pragma unroll
                for (int u = 0; u < MF_TPW; ++u)
#pragma unroll
                    for (int r = 0; r < 32; ++r) tot[u][r & 15] += acc[u][r];
#endif
#endif
#if MF_DIAG != 3
#pragma unroll
            for (int u = 0; u < MF_TPW; ++u) {
                // acc[4 j + 2 h + e]: row 16 w + g + 8 h (h = 0 the hi part,
                // 1 the lo part of shift sft), column 8 j + 2 q + e, so lag
                // 256 j + 64 q + 32 e + sft; y of lag l at i = a + l, stored
                // at i + 8 (i >> 6): 288 j on from j = 0's
                const int pb = g0 + a[u];        // padded position of lag 0
                const bool full = used[u] && pb >= lo_p
                                  && pb + MF_T - 1 <= hi_p;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int r = a[u] + sft + 64 * q + 32 * e;
                    const float* yr = y_s + r + 8 * (r >> 6);
                    const int pe = pb + sft + 64 * q + 32 * e;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const float v = (acc[u][4 * j + e]
                                         + acc[u][4 * j + 2 + e])
                                        * yr[288 * j];
                        const int p = pe + 256 * j;
                        tot[u][2 * j + e] +=
                            (full || (used[u] && p >= lo_p && p <= hi_p))
                                ? v : 0.0f;
                    }
                }
            }
#endif
#endif
#if MF_DIAG < 3
            __syncwarp();
            if (lane == 0) mbar_arrive(bars + 8 * (stages + st));
#endif
            ++it;
        }

#pragma unroll
        for (int ti = 0; ti < MF_TPW; ++ti) {
            const int t = t0 + wg * MF_TPW + ti;
            if (t >= n_tp) continue;
            float* orow = out + (long long)t * n_corr;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int b = b0i + 256 * j + 64 * q + 32 * e + sft;
                    if (b < n_corr) orow[b] = tot[ti][2 * j + e];
                }
        }
    }
}

extern "C" {

// Dynamic shared memory (bytes) one block of the main kernel needs, with
// the deepest ring that fits.
long long mf_smem_bytes(int L, int max_delta)
{
    return mf_layout(L, max_delta).total;
}

int mf_stages(int L, int max_delta) { return mf_layout(L, max_delta).stages; }

int mf_tile_templates(void) { return MF_TILE; }

int mf_block_templates(void) { return MF_TPB; }

int mf_tile_lags(void) { return MF_T; }

int mf_row_width(int L) { return mf_row(L); }

int mf_plan_row_width(int L) { return mf_grow(L); }

// 0 for the 'default' build; the 'highest' build's k-steps a partial
int mf_partial_steps(void) { return MF_ACC_OUT ? MF_ACC_G : 0; }

long long mf_prepass_smem_bytes(int L)
{
    return 4LL * mf_prepass_floats(MF_PP, L);
}

// The pre-pass on `stream`: y, hi and lo of every window start, (n_ch,
// ext_al) each; returns the cudaError_t of the launch (0 = ok).
int mf_prepass_launch(const void* data, long long ext, long long ext_al,
                      int n_ch, int L, void* dh, void* dl, void* y,
                      void* stream)
{
    if (ext_al <= 0 || n_ch <= 0) return 0;
    const long long smem = mf_prepass_smem_bytes(L);
    cudaError_t e = cudaFuncSetAttribute(
        mf_prepass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((ext_al + MF_PP - 1) / MF_PP), (unsigned)n_ch);
    mf_prepass<<<grid, MF_PP_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)data, ext, ext_al, L, (float*)dh, (float*)dl,
        (float*)y);
    return (int)cudaGetLastError();
}

// The main kernel on `stream`, on the pre-pass's arrays; returns the
// cudaError_t of the launch (0 = ok).
int mf_launch(const void* dh, const void* dl, const void* y,
              long long ext_al, const void* rows, const void* mvf,
              const void* tile_lo, void* out, int n_ch, int n_tp,
              int n_tp_pad, int L, long long n_corr, long long lo_p,
              long long hi_p, int max_delta, void* stream)
{
    if (n_corr <= 0 || n_tp <= 0) return 0;
    // the kernel keeps positions in 32 bits
    if (ext_al > INT_MAX - 2 * MF_T || n_corr > INT_MAX - 2 * MF_T)
        return (int)cudaErrorInvalidValue;
    const int lo_c = (int)(lo_p < -(INT_MAX / 2) ? -(INT_MAX / 2) : lo_p);
    const int hi_c = (int)(hi_p > INT_MAX / 2 ? INT_MAX / 2 : hi_p);
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, mf_kernel);
    if (e != cudaSuccess) return (int)e;
    // setmaxnreg moves registers inside the block's own allocation: a
    // smaller one would leave the consumers waiting for registers forever
    if (attr.numRegs * MF_THREADS
        < 128 * MF_PRODUCER_REGS + 128 * MF_CWG * MF_CONSUMER_REGS)
        return (int)cudaErrorInvalidConfiguration;
    const long long smem = mf_smem_bytes(L, max_delta);
    e = cudaFuncSetAttribute(
        mf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((n_tp + MF_TPB - 1) / MF_TPB),
              (unsigned)((n_corr + MF_T - 1) / MF_T));
    mf_kernel<<<grid, MF_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)dh, (const float*)dl, (const float*)y, ext_al,
        (const float*)rows, (const int*)mvf, (const int*)tile_lo,
        (float*)out, n_ch, n_tp, n_tp_pad, L, (int)n_corr, lo_c, hi_c,
        max_delta);
    return (int)cudaGetLastError();
}

const char* mf_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
