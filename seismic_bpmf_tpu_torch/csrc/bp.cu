// Shift-and-stack beamforming with its first-max argmax (CUDA C++, sm_90a).
//
// Replaces the TPU kernel built by `_make_bp_kernel`
// (`seismic_bpmf_tpu/ops/pallas_bp.py:67`, launched by `_bp_pallas_call`).
// Same semantics as `ops.reference.beamform` on the folded features g:
//
//   beam[i, t] = sum_sp w[i, sp] * g[sp, t + mv[i, sp]]     (sp ascending)
//
// with beam = 0 where the strict policy applies and t + lo[i] < 0 or
// t + hi[i] >= n_samp (lo, hi: the source's used-moveout bounds; t is the
// ABSOLUTE sample, so a call over a later range of time tiles masks
// exactly as the whole-day call does).  The flexible policy needs no mask:
// g is zero past the day.  g's column 0 is the absolute sample g_t0 (0 for
// a whole day; a time shard's first sample on a mesh, so that the shard
// holds only its own columns and a halo while the mask stays absolute).  reduce = max keeps, for each t, the largest
// beam and the smallest source index that reaches it; sources >= n_src
// (tile padding) take no part.  reduce = none writes the whole beam.
//
// What bounds it on an H100: operations.  One main-path day is 100k
// sources x 20 used station-phases x 2.16 M samples = 4.3e12 multiply-adds,
// 8.6e12 FLOP (129 ms at 67 TFLOP/s), against ~0.6 GB of features read
// once (0.2 ms at 3.35 TB/s).  On Hopper a moveout is an address offset,
// so the TPU's one-hot Hankel matmul has no counterpart: this kernel
// gathers from a time tile staged in shared memory.  An SM loads 32 words
// a clock from shared memory and does 128 multiply-adds, so a design in
// which every multiply-add loads its own sample (the first one here: lane
// t of a warp read row[t + offset] for one source at a time) cannot pass a
// quarter of the f32 rate, 4 x 129.7 = 519 ms for that day; it took 976.
// This one is paced by shared memory too, at 1.65 multiply-adds a word.
//
// Design.  The sources of a grid are ordered so that neighbours have
// nearly the same moveouts, so two neighbouring sources read nearly the
// same samples of a row, a few samples apart.
//
//   * A lane owns BP_R NEIGHBOURING samples, lane * BP_R + c, and a warp a
//     PAIR of neighbouring sources: acc[0][c], acc[1][c] in registers.  An
//     item is one staged row for the pair: the lane loads the window
//     x[0 .. BP_R + |delta|) of the row once, delta being the difference of
//     the two moveouts, and both sources are served from it, acc[0][c] +=
//     wa * x[c + max(-delta, 0)], acc[1][c] += wb * x[c + max(delta, 0)].
//     Register arrays take no run-time index, so each delta in (-BP_D,
//     BP_D) has its own block of loads and multiply-adds (and a source
//     alone on a row, or BP_D or more from its partner, a block of its
//     own), and an item's code selects its block by an indexed branch.
//     The loop over items is PTX (bp_items.cuh, written by _bp_items.py):
//     a C++ switch becomes a tree of compares, each a taken branch to cold
//     code.  An indexed branch costs a warp ~240 cycles, which 16 warps
//     hide behind the 2 BP_R multiply-adds it selects; with more sources a
//     warp (K sources, D shifts: K x D blocks of BP_R) a branch selected
//     too little work and the blocks outgrew the instruction cache.
//   * BP_R is odd: lanes BP_R words apart then fall into 32 different
//     banks at any offset, with the row laid out in shared memory as it is
//     in device memory.
//   * So a row g[sp, t0 + lo : t0 + lo + span + BP_T), lo a multiple of 4
//     words, is staged by ONE bulk copy (cp.async.bulk, completion counted
//     in bytes on an mbarrier), and a stage's whole program by one more.  A
//     producer warp starts them, a lane per row; the BP_WARPS computing
//     warps start no copy and never touch device memory between a tile's
//     first stage and its last.
//   * A ring of BP_NSTAGE slots, each with a `full` barrier (the copies
//     land) and an `empty` one (every computing warp is done with it), so
//     the producer runs up to BP_NSTAGE - 1 stages ahead and the warps
//     drift apart freely: no block-wide barrier inside the loop.
//   * A block owns BP_T = 32 * BP_R consecutive samples and walks over a
//     contiguous range of source tiles of BP_S = 2 BP_WARPS sources (the
//     last one ragged).  Only the rows a tile uses are staged; the host
//     cuts a tile's rows, in ascending station-phase order, into stages
//     that fit a slot.  A station-phase whose used moveouts spread too
//     wide inside a tile is staged as several rows, each item pointing
//     into the one that holds its offset, so no spread is refused.  A warp
//     keeps its sums across the tile's stages, so a source may use any
//     number of station-phases.  A source's items come in ascending
//     station-phase order and each adds one fmaf per sample, so reduce =
//     none and max agree and neither the cut into calls, nor into stages,
//     nor the pairing changes a bit.
//   * At a tile's last stage a warp folds its two sums per sample into its
//     running first maximum: one fmaxf and one compare per sample; the
//     source is looked up only where the maximum rises.
//
// The argmax across warps and blocks: every (source, sample) value is
// packed into a 64-bit key (order-preserving bits of the value << 32 |
// 0xFFFFFFFF - index), so a larger value wins and, at equal values, the
// smaller index.  -0.0 is made +0.0 first, so equal beams compare equal.
// Keys are folded with max in registers, then in shared memory, then with
// one global atomicMax per sample and block: the result does not depend on
// the order in which blocks run.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BP_R
#define BP_R 15           // samples per lane (odd)
#endif
#ifndef BP_WARPS
#define BP_WARPS 15       // computing warps; one more warp stages
#endif
#ifndef BP_D
#define BP_D 8            // a pair's moveouts on a row lie less apart
#endif
#ifndef BP_NSTAGE
#define BP_NSTAGE 3       // slots of the staging ring
#endif
#define BP_K 2                      // sources per warp: a pair
#define BP_T (32 * BP_R)            // samples per block
#define BP_S (BP_WARPS * BP_K)      // sources per source tile
#define BP_THREADS (32 * (BP_WARPS + 1))
#define BP_HW ((BP_WARPS + 6) & ~3) // words of a stage program's head

static_assert(BP_R % 2 == 1, "lanes BP_R words apart must hit 32 banks");
static_assert(BP_NSTAGE >= 2, "a ring");

// BP_ITEMS(acc, addr, rows): the loop over a warp's items of one stage, in
// PTX; written for these sizes by _bp_items.py when the library is built
#include <bp_items.cuh>

__device__ __forceinline__ unsigned long long bp_key(float v, int idx)
{
    if (v == 0.0f) v = 0.0f;  // -0.0 -> +0.0
    unsigned int u = __float_as_uint(v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32)
           | (unsigned long long)(0xFFFFFFFFu - (unsigned int)idx);
}

// mbarriers (sm_90): a phase ends when the expected arrivals have come and
// the expected bytes have landed.
__device__ __forceinline__ void mbar_init(unsigned bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the phase of this parity has ended.  A wait that never ends
// (a fault in the tables) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity)
{
    unsigned done;
    int spins = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (!done && ++spins > (1 << 22)) __trap();
    } while (!done);
}

// One bulk copy global -> shared; 16-byte addresses and size; its bytes
// count on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(d), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The producer warp's copies of stage j into one slot: the program, then a
// lane per row.
__device__ __forceinline__ void bp_stage(
    unsigned char* slot, unsigned full, int j, const float* __restrict__ g,
    long long ld, const int* __restrict__ stage_row,
    const int* __restrict__ stage_prog, const int4* __restrict__ prog,
    const int* __restrict__ ent_sp, const int* __restrict__ ent_lo,
    const int* __restrict__ ent_span, long long t_g0, int stride,
    int prog_bytes)
{
    const int lane = threadIdx.x & 31;
    const int pa = __ldg(stage_prog + j);
    const unsigned pbytes = 16u * (unsigned)(__ldg(stage_prog + j + 1) - pa);
    const int e_a = __ldg(stage_row + j), ne = __ldg(stage_row + j + 1) - e_a;
    unsigned bytes = 0;
    for (int k = lane; k < ne; k += 32)
        bytes += 4u * (BP_T + ((__ldg(ent_span + e_a + k) + 3) & ~3));
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) {
        mbar_arrive_expect_tx(full, bytes + pbytes);
        bulk_copy(slot, prog + pa, pbytes, full);
    }
    __syncwarp();  // the bytes are expected before any of them lands
    float* rows = reinterpret_cast<float*>(slot + prog_bytes);
    for (int k = lane; k < ne; k += 32) {
        const float* row = g + (long long)__ldg(ent_sp + e_a + k) * ld
                           + t_g0 + __ldg(ent_lo + e_a + k);
        bulk_copy(rows + (long long)k * stride, row,
                  4u * (BP_T + ((__ldg(ent_span + e_a + k) + 3) & ~3)), full);
    }
}

__global__ void __launch_bounds__(BP_THREADS, 1)
bp_kernel(const float* __restrict__ g,          // (n_sp, ld) folded, padded
          long long ld,
          const int* __restrict__ tile_stage,   // (n_tiles + 1,) CSR
          const int* __restrict__ stage_row,    // (n_stages + 1,) CSR
          const int* __restrict__ stage_prog,   // (n_stages + 1,) CSR, x16 B
          const int4* __restrict__ prog,        // the stages' programs
          const int* __restrict__ ent_sp,       // per row: station-phase,
          const int* __restrict__ ent_lo,       //   first staged moveout,
          const int* __restrict__ ent_span,     //   spread of used moveouts
          const int* __restrict__ lo_src,       // (n_src,) strict bounds
          const int* __restrict__ hi_src,
          int n_src, int n_tiles, int tiles_per_split, long long tile0,
          long long n_samp, long long g_t0, long long beam_ld, int strict,
          int hi_max, int stride, int prog_bytes, int slot_bytes,
          unsigned long long* __restrict__ keys,  // (n_tt * BP_T,) max
          float* __restrict__ beam_out)           // (n_src, beam_ld) or null
{
    extern __shared__ unsigned long long smem_u64[];
    unsigned long long* keys_s = smem_u64;                   // BP_T
    const unsigned bars = (unsigned)__cvta_generic_to_shared(keys_s + BP_T);
    // full barrier of slot s: bars + 8 s; empty: bars + 8 (BP_NSTAGE + s)
    unsigned char* slots = reinterpret_cast<unsigned char*>(
        keys_s + BP_T + 2 * BP_NSTAGE);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long t_loc0 = (long long)blockIdx.x * BP_T;   // in this call
    const long long t_abs0 = (tile0 + blockIdx.x) * BP_T;     // absolute
    const int tile_a = blockIdx.y * tiles_per_split;
    const int tile_b = min(tile_a + tiles_per_split, n_tiles);
    const int j_a = tile_stage[tile_a], n_st = tile_stage[tile_b] - j_a;

    for (int i = tid; i < BP_T; i += BP_THREADS) keys_s[i] = 0ull;
    if (tid == 0) {
        for (int s = 0; s < BP_NSTAGE; ++s) {
            mbar_init(bars + 8 * s, 1);
            mbar_init(bars + 8 * (BP_NSTAGE + s), BP_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == BP_WARPS) {
        // the producer: stage jj goes into slot jj % BP_NSTAGE once every
        // computing warp has released what the slot held before
        for (int jj = 0, s = 0, round = 0; jj < n_st; ++jj) {
            if (round > 0)
                mbar_wait(bars + 8 * (BP_NSTAGE + s), (round - 1) & 1);
            bp_stage(slots + (long long)s * slot_bytes, bars + 8 * s,
                     j_a + jj, g, ld, stage_row, stage_prog, prog, ent_sp,
                     ent_lo, ent_span, t_abs0 - g_t0, stride, prog_bytes);
            if (++s == BP_NSTAGE) { s = 0; ++round; }
        }
    } else {
        float best_v[BP_R];
        int best_i[BP_R];
#pragma unroll
        for (int c = 0; c < BP_R; ++c) {
            best_v[c] = -__int_as_float(0x7f800000);  // -inf
            best_i[c] = 0;
        }
        float acc[BP_K][BP_R];  // the warp's sources, across a tile's stages
        // is any sample of this block masked for any source?
        const bool edge_blk = strict && t_abs0 + BP_T - 1 + hi_max >= n_samp;

        for (int jj = 0, s = 0, round = 0; jj < n_st; ++jj) {
            const unsigned char* slot = slots + (long long)s * slot_bytes;
            mbar_wait(bars + 8 * s, round & 1);
            const int* head = reinterpret_cast<const int*>(slot);
            const int flags = head[BP_WARPS + 1];
            if (flags & 1) {
#pragma unroll
                for (int k = 0; k < BP_K; ++k)
#pragma unroll
                    for (int c = 0; c < BP_R; ++c) acc[k][c] = 0.0f;
            }
            // this warp's items, up to its end mark
            const unsigned slot_s = (unsigned)__cvta_generic_to_shared(slot);
            unsigned at = slot_s + 4u * BP_HW + 16u * (unsigned)head[warp];
            BP_ITEMS(acc, at, slot_s + (unsigned)prog_bytes
                                  + 4u * BP_R * (unsigned)lane);
            if (flags & 2) {
                // the tile's last stage: fold the warp's sums
                const int src0 = head[BP_WARPS + 2] * BP_S + warp * BP_K;
                if (beam_out != nullptr || edge_blk || src0 + BP_K > n_src) {
                    // the general way: the strict mask, the ragged tile,
                    // the full beam
#pragma unroll
                    for (int k = 0; k < BP_K; ++k) {
                        const int src = src0 + k;
                        if (src >= n_src) break;
                        const int hi = hi_src[src], lo = lo_src[src];
#pragma unroll
                        for (int c = 0; c < BP_R; ++c) {
                            const long long t = t_abs0 + lane * BP_R + c;
                            float v = acc[k][c];
                            if (edge_blk && (t + lo < 0 || t + hi >= n_samp))
                                v = 0.0f;
                            if (beam_out != nullptr) {
                                if (t < n_samp)
                                    beam_out[(long long)src * beam_ld + t
                                             - tile0 * BP_T] = v;
                            } else if (v > best_v[c]) {
                                best_v[c] = v;
                                best_i[c] = src;
                            }
                        }
                    }
                } else {
                    float m[BP_R];
                    bool any = false;
#pragma unroll
                    for (int c = 0; c < BP_R; ++c) {
                        m[c] = acc[0][c];
#pragma unroll
                        for (int k = 1; k < BP_K; ++k)
                            m[c] = fmaxf(m[c], acc[k][c]);
                        any |= m[c] > best_v[c];
                    }
                    if (any) {
#pragma unroll
                        for (int c = 0; c < BP_R; ++c) {
                            if (m[c] > best_v[c]) {
                                int kk = BP_K - 1;  // the first that reaches it
#pragma unroll
                                for (int k = BP_K - 2; k >= 0; --k)
                                    if (acc[k][c] == m[c]) kk = k;
                                best_v[c] = m[c];
                                best_i[c] = src0 + kk;
                            }
                        }
                    }
                }
            }
            __syncwarp();  // every lane has read what it needs of the slot
            if (lane == 0) mbar_arrive(bars + 8 * (BP_NSTAGE + s));
            if (++s == BP_NSTAGE) { s = 0; ++round; }
        }
        if (beam_out == nullptr) {
#pragma unroll
            for (int c = 0; c < BP_R; ++c)
                if (best_v[c] > -__int_as_float(0x7f800000))
                    atomicMax(keys_s + lane * BP_R + c,
                              bp_key(best_v[c], best_i[c]));
        }
    }

    if (beam_out != nullptr) return;
    __syncthreads();
    for (int i = tid; i < BP_T; i += BP_THREADS)
        atomicMax(keys + t_loc0 + i, keys_s[i]);
}

__global__ void bp_unpack(const unsigned long long* __restrict__ keys,
                          long long n, float* __restrict__ val,
                          int* __restrict__ idx)
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    const unsigned long long k = keys[t];
    unsigned int u = (unsigned int)(k >> 32);
    u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
    val[t] = __uint_as_float(u);
    idx[t] = (int)(0xFFFFFFFFu - (unsigned int)(k & 0xFFFFFFFFull));
}

extern "C" {

int bp_tile_samples(void) { return BP_T; }

int bp_tile_sources(void) { return BP_S; }

int bp_window(void) { return BP_D; }

int bp_ring(void) { return BP_NSTAGE; }

// Bytes of one slot of the ring (a stage's program and its rows), and the
// dynamic shared memory of a block (the argmax keys, the barriers and the
// ring) for these sizes.
long long bp_slot_bytes(int stride, int max_rows, int prog_bytes)
{
    return prog_bytes + 4LL * max_rows * (long long)stride;
}

long long bp_smem_bytes(int stride, int max_rows, int prog_bytes)
{
    return 8LL * BP_T + 16LL * BP_NSTAGE
           + BP_NSTAGE * bp_slot_bytes(stride, max_rows, prog_bytes);
}

// Launches on `stream` over the n_tt time tiles that start at the absolute
// tile tile0, with the source tiles cut into n_splits ranges (grid.y);
// g's column 0 is the absolute sample g_t0 (a multiple of 4).
// reduce = max (beam_out == NULL): `keys` (n_tt * BP_T, zero-filled by the
// caller) gets the per-sample maximum key, unpacked into val / idx;
// reduce = none: the beam of those tiles is written, row stride beam_ld,
// column 0 the first sample of tile tile0, samples >= n_samp left out.
// Returns the cudaError_t of the launches (0 = ok).
int bp_launch(const void* g, long long ld, const void* tile_stage,
              const void* stage_row, const void* stage_prog,
              const void* prog, const void* ent_sp, const void* ent_lo,
              const void* ent_span, const void* lo_src, const void* hi_src,
              int n_src, int n_tiles, int n_splits, long long tile0,
              long long n_tt, long long n_samp, long long g_t0,
              long long beam_ld, int strict, int hi_max,
              int stride, int max_rows, int prog_bytes, void* keys,
              void* val, void* idx, void* beam_out, void* stream)
{
    if (n_tt <= 0 || n_tiles <= 0) return 0;
    const long long smem = bp_smem_bytes(stride, max_rows, prog_bytes);
    const int slot_bytes = (int)bp_slot_bytes(stride, max_rows, prog_bytes);
    cudaError_t e = cudaFuncSetAttribute(
        bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int tps = (n_tiles + n_splits - 1) / n_splits;
    dim3 grid((unsigned)n_tt, (unsigned)((n_tiles + tps - 1) / tps));
    cudaStream_t st = (cudaStream_t)stream;
    bp_kernel<<<grid, BP_THREADS, (size_t)smem, st>>>(
        (const float*)g, ld, (const int*)tile_stage, (const int*)stage_row,
        (const int*)stage_prog, (const int4*)prog, (const int*)ent_sp,
        (const int*)ent_lo, (const int*)ent_span, (const int*)lo_src,
        (const int*)hi_src, n_src, n_tiles, tps, tile0, n_samp, g_t0,
        beam_ld, strict, hi_max, stride, prog_bytes, slot_bytes,
        (unsigned long long*)keys, (float*)beam_out);
    e = cudaGetLastError();
    if (e != cudaSuccess || beam_out != nullptr) return (int)e;
    const long long n = n_tt * BP_T;
    bp_unpack<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        (const unsigned long long*)keys, n, (float*)val, (int*)idx);
    return (int)cudaGetLastError();
}

const char* bp_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
