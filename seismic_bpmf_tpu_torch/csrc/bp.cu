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
// g is zero past the day.  reduce = max keeps, for each t, the largest
// beam and the smallest source index that reaches it; sources >= n_src
// (tile padding) take no part.  reduce = none writes the whole beam.
//
// What bounds it on an H100: operations.  One main-path day is 100k
// sources x 20 used station-phases x 2.16 M samples = 4.3e12 multiply-adds,
// 8.6e12 FLOP (129 ms at 67 TFLOP/s), against ~0.6 GB of features read
// once (0.2 ms at 3.35 TB/s).  On Hopper a moveout is an address offset,
// so the TPU's one-hot Hankel matmul has no counterpart: this kernel
// gathers.  Each multiply-add reads its feature sample from shared memory
// (a warp-wide load of 32 consecutive words), so the shared-memory rate
// (32 words per clock per SM against 128 FMAs) sets its pace, about 4x the
// FMA bound; a loaded sample feeds one multiply-add, because every source
// reads each station-phase at its own offset.
//
// Design.  A block owns BP_T = 32 * BP_R consecutive samples and walks
// over a contiguous range of source tiles of BP_S = 32 consecutive sources
// (the last one ragged).  For a source tile the host lists the
// station-phases ("rows") that at least one of its sources uses, each with
// the lowest used moveout `lo` and the spread `span` of the tile's used
// moveouts on it; only those rows are staged, g[sp, t0 + lo : t0 + lo +
// span + BP_T).  The host cuts a tile's rows, in ascending station-phase
// order, into "stages" of as many rows as fit one of two shared-memory
// buffers; a stage is staged as a whole, and the next stage's copies
// (cp.async) fly while this one computes.  Each warp keeps the sums of its
// sources of the tile in registers across the tile's stages, so a source
// may use any number of station-phases; nothing is clamped.  The warps
// take the tile's sources in turn and each lane owns BP_R columns (lane +
// 32 c), so every load of a staged row is 32 consecutive words.  In a
// stage a source walks its compact list of used pairs (row, offset,
// weight), sorted by station-phase: zero weights cost nothing, and a
// source with no used pair gives a beam of 0.  Sums are fmaf in ascending
// station-phase order, so reduce = none and max agree and neither the way
// a day is cut into calls nor the way a tile is cut into stages changes a
// bit.
//
// The argmax across blocks: every (source, sample) value is packed into a
// 64-bit key (order-preserving bits of the value << 32 | 0xFFFFFFFF -
// index), so a larger value wins and, at equal values, the smaller index.
// -0.0 is made +0.0 first, so equal beams compare equal.  Keys are folded
// with max in registers, then in shared memory, then with one global
// atomicMax per sample and block: the result does not depend on the order
// in which blocks run.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef BP_R
#define BP_R 16           // columns per lane
#endif
#define BP_T (32 * BP_R)  // samples per block
#define BP_S 32           // sources per source tile
#define BP_THREADS 512
#define BP_WARPS (BP_THREADS / 32)
#define BP_K (BP_S / BP_WARPS)  // sources of a tile per warp
#define BP_PP 34          // stage_pp words of a stage (BP_S + 1, even)

static_assert(BP_S % BP_WARPS == 0, "a warp takes BP_K sources of a tile");

__device__ __forceinline__ unsigned long long bp_key(float v, int idx)
{
    if (v == 0.0f) v = 0.0f;  // -0.0 -> +0.0
    unsigned int u = __float_as_uint(v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32)
           | (unsigned long long)(0xFFFFFFFFu - (unsigned int)idx);
}

// Asynchronous global -> shared copies (cp.async, sm_80+): a thread keeps
// all of its copies in flight and spends no registers on them; a commit
// closes a group, a wait lets all but the newest N groups land.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     :: "r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One staging buffer: the stage's pairs, its stage_pp words and its rows.
struct Buf {
    int2* pairs;
    int* pp;
    float* rows;
};

__device__ __forceinline__ Buf bp_buf(unsigned char* base, int max_pairs)
{
    Buf b;
    b.pairs = reinterpret_cast<int2*>(base);
    b.pp = reinterpret_cast<int*>(b.pairs + max_pairs);
    b.rows = reinterpret_cast<float*>(b.pp + BP_PP);
    return b;
}

// Issue (and commit) the copies of one stage's pairs and rows.
__device__ __forceinline__ void bp_stage(
    const Buf& b, int j, const float* __restrict__ g, long long ld,
    const int* __restrict__ stage_pp, const int2* __restrict__ pairs,
    const int* __restrict__ stage_row, const int* __restrict__ ent_sp,
    const int* __restrict__ ent_lo, const int* __restrict__ ent_span,
    long long t_abs0, int stride)
{
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int* pp = stage_pp + (long long)j * BP_PP;
    const int pa = __ldg(pp), n_p = __ldg(pp + BP_PP - 1) - pa;
    for (int i = tid; i < BP_PP; i += BP_THREADS)
        cp_async(b.pp + i, pp + i, 4);
    for (int i = tid; i < n_p; i += BP_THREADS)
        cp_async(b.pairs + i, pairs + pa + i, 8);
    // a warp per row: its descriptor is one broadcast load
    const int e_a = stage_row[j], ne = stage_row[j + 1] - e_a;
    for (int k = warp; k < ne; k += BP_WARPS) {
        const float* row = g + (long long)__ldg(ent_sp + e_a + k) * ld
                           + t_abs0 + __ldg(ent_lo + e_a + k);
        float* dst = b.rows + k * stride;
        const int n = __ldg(ent_span + e_a + k) + BP_T;
        for (int i = lane; i < n; i += 32) cp_async(dst + i, row + i, 4);
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(BP_THREADS, 1)
bp_kernel(const float* __restrict__ g,          // (n_sp, ld) folded, padded
          long long ld,
          const int* __restrict__ tile_stage,   // (n_tiles + 1,) CSR
          const int* __restrict__ stage_pp,     // (n_stages, BP_PP)
          const int2* __restrict__ pairs,       // (k * stride + offset, w)
          const int* __restrict__ lo_src,       // (n_src,) strict bounds
          const int* __restrict__ hi_src,
          const int* __restrict__ stage_row,    // (n_stages + 1,) CSR
          const int* __restrict__ ent_sp,       // per row: station-phase,
          const int* __restrict__ ent_lo,       //   lowest used moveout,
          const int* __restrict__ ent_span,     //   spread of used moveouts
          int n_src, int n_tiles, int tiles_per_split, long long tile0,
          long long n_samp, int strict, int stride, int max_pairs,
          int buf_bytes,
          unsigned long long* __restrict__ keys,  // (n_tt * BP_T,) max
          float* __restrict__ beam_out)           // (n_src, n_samp) or null
{
    extern __shared__ unsigned long long smem_u64[];
    unsigned long long* keys_s = smem_u64;                   // BP_T
    // two staging buffers; a buffer's pointers are computed, not indexed
    // from an array, so that they stay in registers (an array indexed by
    // the loop's buffer number would live in local memory)
    unsigned char* base = reinterpret_cast<unsigned char*>(keys_s + BP_T);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long t_loc0 = (long long)blockIdx.x * BP_T;   // in this call
    const long long t_abs0 = (tile0 + blockIdx.x) * BP_T;     // absolute
    const int tile_a = blockIdx.y * tiles_per_split;
    const int tile_b = min(tile_a + tiles_per_split, n_tiles);
    const int j_a = tile_stage[tile_a], j_b = tile_stage[tile_b];

    for (int i = tid; i < BP_T; i += BP_THREADS) keys_s[i] = 0ull;
    float best_v[BP_R];
    int best_i[BP_R];
#pragma unroll
    for (int c = 0; c < BP_R; ++c) {
        best_v[c] = -__int_as_float(0x7f800000);  // -inf
        best_i[c] = 0;
    }
    float acc[BP_K][BP_R];  // the warp's sources of the tile, across stages

    if (j_a < j_b)
        bp_stage(bp_buf(base, max_pairs), j_a, g, ld, stage_pp, pairs,
                 stage_row, ent_sp, ent_lo, ent_span, t_abs0, stride);
    int tile = tile_a;
    for (int j = j_a, cur = 0; j < j_b; ++j, cur ^= 1) {
        // the next stage's copies fly while this one computes
        if (j + 1 < j_b) {
            bp_stage(bp_buf(base + (cur ^ 1) * buf_bytes, max_pairs), j + 1,
                     g, ld, stage_pp, pairs, stage_row, ent_sp, ent_lo,
                     ent_span, t_abs0, stride);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // this stage's buffer has landed for every thread
        if (j == tile_stage[tile + 1]) ++tile;  // every tile has a stage
        const bool first = j == tile_stage[tile];
        const bool last = j + 1 == tile_stage[tile + 1];
        const Buf b = bp_buf(base + cur * buf_bytes, max_pairs);
        const int s0 = tile * BP_S, n_s = min(BP_S, n_src - s0);
        const int pa = b.pp[0];
        // warp w takes the tile's sources w, w + BP_WARPS, ..., so a
        // lane's sources ascend (the first maximum stays)
#pragma unroll
        for (int k = 0; k < BP_K; ++k) {
            const int s = warp + BP_WARPS * k;
            if (s >= n_s) break;
            if (first) {
#pragma unroll
                for (int c = 0; c < BP_R; ++c) acc[k][c] = 0.0f;
            }
            const int p1 = b.pp[s + 1] - pa;
#pragma unroll 2
            for (int p = b.pp[s] - pa; p < p1; ++p) {
                const int2 q = b.pairs[p];
                const float* r = b.rows + q.x + lane;
                const float w = __int_as_float(q.y);
#pragma unroll
                for (int c = 0; c < BP_R; ++c)
                    acc[k][c] = fmaf(w, r[32 * c], acc[k][c]);
            }
            if (!last) continue;
            const int src = s0 + s;
            const int lo = lo_src[src], hi = hi_src[src];
            // warp-uniform: is any column of this block masked?
            const bool edge = strict && (t_abs0 + lo < 0
                                         || t_abs0 + BP_T - 1 + hi >= n_samp);
#pragma unroll
            for (int c = 0; c < BP_R; ++c) {
                const long long t = t_abs0 + lane + 32 * c;
                float v = acc[k][c];
                if (edge && (t + lo < 0 || t + hi >= n_samp)) v = 0.0f;
                if (beam_out != nullptr) {
                    if (t < n_samp) beam_out[(long long)src * n_samp + t] = v;
                } else if (v > best_v[c]) {
                    best_v[c] = v;
                    best_i[c] = src;
                }
            }
        }
        __syncthreads();  // done with this buffer before it is restaged
    }

    if (beam_out != nullptr) return;
#pragma unroll
    for (int c = 0; c < BP_R; ++c)
        if (best_v[c] > -__int_as_float(0x7f800000))
            atomicMax(keys_s + lane + 32 * c, bp_key(best_v[c], best_i[c]));
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

// Bytes of one staging buffer, and the dynamic shared memory of a block
// (the argmax keys and two buffers) for these sizes.
long long bp_buf_bytes(int stride, int max_rows, int max_pairs)
{
    const long long b = 8LL * max_pairs + 4LL * BP_PP
                        + 4LL * max_rows * (long long)stride;
    return (b + 15) / 16 * 16;
}

long long bp_smem_bytes(int stride, int max_rows, int max_pairs)
{
    return 8LL * BP_T + 2 * bp_buf_bytes(stride, max_rows, max_pairs);
}

// Launches on `stream` over the n_tt time tiles that start at the absolute
// tile tile0, with the source tiles cut into n_splits ranges (grid.y).
// reduce = max (beam_out == NULL): `keys` (n_tt * BP_T, zero-filled by the
// caller) gets the per-sample maximum key, unpacked into val / idx;
// reduce = none: the beam is written.  Returns the cudaError_t of the
// launches (0 = ok).
int bp_launch(const void* g, long long ld, const void* tile_stage,
              const void* stage_pp, const void* pairs, const void* lo_src,
              const void* hi_src, const void* stage_row, const void* ent_sp,
              const void* ent_lo, const void* ent_span, int n_src,
              int n_tiles, int n_splits, long long tile0, long long n_tt,
              long long n_samp, int strict, int stride, int max_rows,
              int max_pairs, void* keys, void* val, void* idx,
              void* beam_out, void* stream)
{
    if (n_tt <= 0 || n_tiles <= 0) return 0;
    const long long smem = bp_smem_bytes(stride, max_rows, max_pairs);
    const int buf_bytes = (int)bp_buf_bytes(stride, max_rows, max_pairs);
    cudaError_t e = cudaFuncSetAttribute(
        bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int tps = (n_tiles + n_splits - 1) / n_splits;
    dim3 grid((unsigned)n_tt, (unsigned)((n_tiles + tps - 1) / tps));
    cudaStream_t st = (cudaStream_t)stream;
    bp_kernel<<<grid, BP_THREADS, (size_t)smem, st>>>(
        (const float*)g, ld, (const int*)tile_stage, (const int*)stage_pp,
        (const int2*)pairs, (const int*)lo_src, (const int*)hi_src,
        (const int*)stage_row, (const int*)ent_sp, (const int*)ent_lo,
        (const int*)ent_span, n_src, n_tiles, tps, tile0, n_samp, strict,
        stride, max_pairs, buf_bytes, (unsigned long long*)keys,
        (float*)beam_out);
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
