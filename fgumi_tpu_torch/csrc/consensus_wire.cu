// Wire consensus kernels for Hopper (sm_90a): K1, the full-column kernel,
// K1-r, K1 plus the duplex combine's resident arrays, and K1-f, the fused
// consensus->filter kernel. All three run one design and share its read
// loop; they differ only in what a finished column stores (K1-r stages
// its narrow planes in shared memory first).
//
// K1 replaces the Pallas TPU kernel fgumi_tpu/ops/pallas_kernel.py
// `_consensus_kernel` (with its `_pack_split` packing and the
// `_full_jit`/`call_full` wrapper): per UMI family (segment, one consensus
// read) and position, the dictionary lookup of the f32 match contribution,
// the 4-lane contribution/observation sums plus a poison count for
// nonfinite entries, the first-max winner, the loser-gap posterior, the
// two-trials pre-UMI combine, the Phred conversion, the suspect guard band
// and the no-call rules, then the split packing: qs = qual | suspect << 7
// (1 B), wp = 2-bit winners 4 per byte, and u16 depth/errors.
//
// Bound: memory. Each observation is read once (1 B of wire) and each
// output column is written once (qs 1 B + wp 0.25 B + depth 2 B + errors 2 B
// = 5.25 B); the arithmetic is a handful of f32 ops per observation and ~40
// transcendental-free ops plus 6 expf/logf/log1pf per output column.
//
// Design (Hopper): the TPU kernel walked a sequential (segment tile, row
// window) grid and carried the sums in VMEM scratch between grid steps.
// Here one warp owns one consensus read, on a persistent grid.
// - A block holds kWarps warps; the grid is SMs x resident blocks (from
//   the occupancy query at first use), capped by the reads, and warp w
//   takes reads w, w + all warps, ... Every output is one warp's own work,
//   so none depends on the schedule, and there is no __syncthreads per read.
// - A read's rows [starts[f], starts[f+1]) are one contiguous span of n*L
//   bytes. The warp copies it into its own slice of shared memory with
//   cp.async (16 B over the 16-byte-aligned body, 4 B at the ends), waits
//   once, then accumulates from shared memory. A read larger than the slice,
//   or with more than 255 rows, goes in 32-column strips of row chunks, the
//   sums carried in registers. Any row count and any L % 4 == 0 are taken.
// - A lane owns one position per step (32 consecutive positions), so at
//   L = 152 five steps keep 95% of the lanes busy, the accumulators are 4
//   f32 sums + 4 counts + a poison count, and the byte planes (32 B) and
//   u16 planes (64 B) leave as one coalesced segment per warp step. The wp
//   byte of 4 positions is OR-combined across 4 lanes with shuffles.
// - An observation costs one shared byte load and one lookup in a per-block
//   table of the 256 wire bytes (4 lane terms, a packed count and a poison
//   increment): 4 float adds and 2 integer adds, no compares or selects.
//
// Numerics: f32 throughout with libdevice expf/logf/log1pf (no fast-math).
// The guard band (fgumi_tpu_torch/ops/kernel.py) holds for summing the
// nonnegative terms in any order, so a non-suspect position is exact; the
// rows of a position are summed in ascending order all the same, so the
// sums equal those of a compare-and-select loop over the rows bit for bit.
// Nonfinite dictionary entries are zeroed per observation and counted in
// `poison`, which forces the suspect flag at the cells they touch (adding
// -inf to one lane alone would lose the all-lane NaN that flags them).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMinPhred = 2;
constexpr int kMaxPhred = 93;
constexpr int kNCode = 4;
constexpr float kQualGuardFloor = 3e-4f;
constexpr float kTieGuardFloor = 1e-5f;

struct Constants {
    float ln_4_3;      // f32(ln(4/3))
    float eps32;       // FLT_EPSILON
    float phred_per_ln;  // f32(10 / ln 10)
};

__device__ __forceinline__ void column_epilogue(
        const float c[4], const int o[4], int poison, float pre,
        const Constants k, int* winner_out, int* qual_out, int* depth_out,
        int* errors_out, bool* suspect_out) {
    const int depth = o[0] + o[1] + o[2] + o[3];
    const float depth_f = (float)depth;
    const float max_c = fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3]));
    // first-max winner
    int win = 0;
    if (c[0] != max_c) {
        win = (c[1] == max_c) ? 1 : (c[2] == max_c) ? 2 : 3;
    }
    // loser-gap frame
    float s = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (b != win) s += expf(-(max_c - c[b]));
    }
    const float ln_cons_err = logf(s) - log1pf(s);
    const float hi = fmaxf(pre, ln_cons_err);
    const float lo = fminf(pre, ln_cons_err);
    const float diff = hi - lo;
    const bool quick = !(diff < 6.0f);
    const float safe_diff = quick ? 6.0f : diff;
    const float l1p = log1pf(expf(-safe_diff));
    const float term1 = hi + l1p;
    const float term2_minus_term1 = k.ln_4_3 + lo - l1p;
    const float full =
        term1 + log1pf(-expf(fminf(term2_minus_term1, -k.eps32)));
    const float ln_final = quick ? hi : full;
    const float phred_f = -ln_final * k.phred_per_ln + 0.001f;
    const float fl = floorf(phred_f);
    int qual = (int)fminf(fmaxf(fl, (float)kMinPhred), (float)kMaxPhred);

    // suspect guard band
    const float eps_gap = k.eps32 * (depth_f + 2.0f) * (1.0f + max_c);
    float second = -INFINITY;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        if (b != win) second = fmaxf(second, c[b]);
    }
    const float margin = max_c - second;
    const bool tie_suspect = margin <= (2.0f * eps_gap + kTieGuardFloor);
    const bool took_pre = quick && (ln_cons_err < pre);
    const float err_phred =
        took_pre ? 0.0f : k.phred_per_ln * 2.0f * eps_gap;
    const float frac = phred_f - fl;
    const bool near_boundary =
        fminf(frac, 1.0f - frac) <= (err_phred + kQualGuardFloor);
    const bool clamped = (phred_f <= (float)kMinPhred) ||
                         (phred_f >= (float)kMaxPhred + 0.5f);
    const bool branch_suspect =
        fabsf(diff - 6.0f) <= (2.0f * eps_gap + 1e-4f);
    const bool nonfinite = !isfinite(max_c) || poison > 0;
    bool suspect = tie_suspect || branch_suspect || nonfinite ||
                   (near_boundary && !clamped);
    const bool no_call = depth == 0;
    const int winner_obs = o[win];
    if (no_call || tie_suspect) {
        win = kNCode;
        qual = kMinPhred;
    }
    suspect = suspect && !no_call;
    *winner_out = win;
    *qual_out = qual;
    *depth_out = depth;
    *errors_out = depth - (win == kNCode ? 0 : winner_obs);
    *suspect_out = suspect;
}

// ---------------------------------------------------------------------------
// The read loop the kernels share.

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Resident blocks a kernel is compiled for: 4 cap a thread at 64 registers,
// which both kernels fit without spills; 5 cap it at 48, where each spills
// and is slower on the main path's longtail batches (PERF.md).
constexpr int kMinBlocks = 4;
constexpr int kMaxTileRows = 255;  // rows the packed 8-bit counts take
constexpr int kMinSlice = 2048;    // shared bytes of a warp's slice
constexpr int kMaxSlice = 6144;
// the most dynamic shared memory a block's slices take: kWarps of the
// widest, each with its 16 spare bytes (K1-r adds its chunk staging)
constexpr int kMaxSmem = kWarps * (kMaxSlice + 16);
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async4(void* sdst, const void* gsrc) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gsrc)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(void* sdst, const void* gsrc) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(sdst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gsrc)
                 : "memory");
}

// Copy `rows` rows x `cw` bytes from `src` (row pitch L in device memory)
// into the warp's slice, packed at pitch cw; returns the tile's first byte.
// All 32 lanes call it; on return every lane sees the whole tile. With
// cw == L the rows are one span, placed at the span's 16-byte phase so the
// body goes in 16-byte copies (the slice has 16 spare bytes for that).
__device__ __forceinline__ const uint8_t* stage_tile(
        uint8_t* slice, const uint8_t* src, int rows, int cw, int L,
        int lane) {
    __syncwarp();  // every lane is done with the previous tile
    uint8_t* dst;
    if (cw == L) {
        const int bytes = rows * L;
        const int mis = (int)((uintptr_t)src & 15u);
        dst = slice + mis;
        int head = (16 - mis) & 15;
        if (head > bytes) head = bytes;
        if (4 * lane < head) cp_async4(dst + 4 * lane, src + 4 * lane);
        const int body = (bytes - head) >> 4;
        for (int i = lane; i < body; i += 32) {
            cp_async16(dst + head + 16 * i, src + head + 16 * i);
        }
        const int tail = head + 16 * body;
        if (tail + 4 * lane < bytes) {
            cp_async4(dst + tail + 4 * lane, src + tail + 4 * lane);
        }
    } else {
        dst = slice;
        const int wpr = cw >> 2;  // 4-byte words per row
        const int words = rows * wpr;
        for (int i = lane; i < words; i += 32) {
            const int r = i / wpr;
            const int w = i - r * wpr;
            cp_async4(dst + r * cw + 4 * w, src + (size_t)r * L + 4 * w);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    return dst;
}

// The per-byte observation table: a wire byte (dictionary index q << 2 |
// base code) maps to the 4 lane terms it adds (its dictionary entry in its
// base's lane, zeroed when nonfinite, +0 in the others; all +0 for q = 63,
// no observation), its count increment (one in its base's 8-bit field of a
// packed u32) and its poison increment. Adding +0 leaves a sum unchanged, so
// this equals a compare-and-select on the base code bit for bit.
struct ObsTable {
    float4 terms[256];
    uint2 incs[256];  // x: packed base counts, y: poison
};

__device__ __forceinline__ void build_obs_table(
        const float* __restrict__ dict, ObsTable& t) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
        const int q = i >> 2;
        const int code = i & 3;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint2 inc = make_uint2(0u, 0u);
        if (q != 63) {
            const float d = dict[q];
            const bool fin = isfinite(d);
            v[code] = fin ? d : 0.0f;
            inc.x = 1u << (8 * code);
            inc.y = fin ? 0u : 1u;
        }
        t.terms[i] = make_float4(v[0], v[1], v[2], v[3]);
        t.incs[i] = inc;
    }
}

// One position's lane sums over `rows` (<= kMaxTileRows) staged rows (`col`
// is the position's byte in the tile's first row, `pitch` the tile's row
// pitch), added to c/o/pois.
__device__ __forceinline__ void accumulate_column(
        const uint8_t* col, int pitch, int rows, const ObsTable& t,
        float c[4], int o[4], int& pois) {
    uint32_t counts = 0u;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
        const uint32_t byte = col[r * pitch];
        const float4 v = t.terms[byte];
        const uint2 inc = t.incs[byte];
        c[0] += v.x;
        c[1] += v.y;
        c[2] += v.z;
        c[3] += v.w;
        counts += inc.x;
        pois += (int)inc.y;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) o[b] += (int)((counts >> (8 * b)) & 0xFFu);
}

// One consensus read of n rows (its rows one span at `span`, pitch L)
// through the warp: stages the rows into the warp's slice, sums every
// position and hands each finished position to
// finish(c, o, pois, valid, pos). All 32 lanes call it and every lane calls
// `finish` on every step (the wp shuffles); lanes past L pass valid = false.
template <class Finish>
__device__ __forceinline__ void consensus_read(
        const uint8_t* span, int n, int L, int slice_bytes, uint8_t* slice,
        const ObsTable& table, int lane, const Finish& finish) {
    if (n <= kMaxTileRows && (long long)n * L <= slice_bytes) {
        // the whole span in one tile
        const uint8_t* tile = stage_tile(slice, span, n, L, L, lane);
        for (int p0 = 0; p0 < L; p0 += 32) {
            const int p = p0 + lane;
            const bool valid = p < L;
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            int o[4] = {0, 0, 0, 0};
            int pois = 0;
            accumulate_column(tile + p, L, valid ? n : 0, table, c, o, pois);
            finish(c, o, pois, valid, p);
        }
    } else {
        // 32-column strips of row chunks, the sums in registers
        const int chunk_rows = min(slice_bytes / 32, kMaxTileRows);
        for (int ca = 0; ca < L; ca += 32) {
            const int cw = min(32, L - ca);
            const bool valid = lane < cw;
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            int o[4] = {0, 0, 0, 0};
            int pois = 0;
            for (int ra = 0; ra < n; ra += chunk_rows) {
                const int rows = min(chunk_rows, n - ra);
                const uint8_t* tile = stage_tile(
                    slice, span + (size_t)ra * L + ca, rows, cw, L, lane);
                accumulate_column(tile + lane, cw, valid ? rows : 0, table, c,
                                  o, pois);
            }
            finish(c, o, pois, valid, ca + lane);
        }
    }
}

// The 2-bit winners of 4 aligned positions (4 lanes) as one wp byte. All
// 32 lanes call it; a lane past L adds nothing.
__device__ __forceinline__ uint32_t wp_byte(int win, bool valid, int pos) {
    uint32_t wbits =
        valid ? (uint32_t)(win > 3 ? 0 : win) << (2 * (pos & 3)) : 0u;
    wbits |= __shfl_xor_sync(kFullMask, wbits, 1);
    wbits |= __shfl_xor_sync(kFullMask, wbits, 2);
    return wbits;
}

// ---------------------------------------------------------------------------
// K1: per position, the column epilogue and the split packing.

struct FullOut {
    uint8_t* qs;
    uint8_t* wp;
    uint16_t* depth;
    uint16_t* errors;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
consensus_wire_full_kernel(
        const uint8_t* __restrict__ wire, const int32_t* __restrict__ starts,
        const float* __restrict__ dict, float pre, Constants k, int L,
        int num_segments, int slice_bytes, FullOut out) {
    __shared__ ObsTable table;
    extern __shared__ __align__(16) uint8_t stage_mem[];
    build_obs_table(dict, table);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint8_t* slice = stage_mem + warp * (slice_bytes + 16);
    const int stride = gridDim.x * kWarps;
    for (int f = blockIdx.x * kWarps + warp; f < num_segments;
         f += stride) {
        const int r0 = starts[f];
        const size_t row = (size_t)f * L;
        auto finish = [=](const float c[4], const int o[4], int pois,
                          bool valid, int pos) {
            int win, qual, depth, errors;
            bool suspect;
            column_epilogue(c, o, pois, pre, k, &win, &qual, &depth, &errors,
                            &suspect);
            const uint32_t wbits = wp_byte(win, valid, pos);
            if (valid) {
                const size_t col = row + pos;
                out.qs[col] = (uint8_t)(qual | (suspect ? 0x80 : 0));
                out.depth[col] = (uint16_t)depth;
                out.errors[col] = (uint16_t)errors;
                if ((pos & 3) == 0) out.wp[col >> 2] = (uint8_t)wbits;
            }
        };
        consensus_read(wire + (size_t)r0 * L, starts[f + 1] - r0, L,
                       slice_bytes, slice, table, lane, finish);
    }
}

// ---------------------------------------------------------------------------
// K1-r: K1 plus the arrays the duplex strand combine keeps on the device.
//
// Replaces the XLA jit fgumi_tpu/ops/kernel.py `_wire_resident_fn` (the
// `_wire_epilogue` reduction, K1's split packing and the thresholded
// outputs): per position, K1's four planes, then tb/tq, the consensus
// thresholds (depth < min_reads -> N/Q0, qual < min_qual -> N/Q2, as
// oracle.apply_consensus_thresholds), and obs, the position's four lane
// observation counts as int32. tb, tq and obs stay on the card for the
// strand combine (K5), which gathers rows of them by index.
//
// Bound: memory. K1's bytes plus 18 B a column (tb 1 B, tq 1 B, obs 16 B):
// 23.25 B written a column against ~3 B of wire read at the duplex batch's
// 3-row families, so the stores dominate. At 71,172 rows x 128 over 23,724
// reads that is 79.8 MB, 0.0238 ms at 3.35 TB/s.
//
// What held the first design back: every lane wrote all seven planes at
// every 32-column step, six of them a byte or two a lane, and it took
// 0.0622 ms at that batch on an H100 80GB HBM3 (700 W), 38% of its byte
// bound and the same time a column as K1, which writes a quarter of the
// bytes. Halving the epilogue's instructions did not move it: a split
// epilogue (a short common path for the columns whose three losing lanes
// hold equal sums and whose combine takes its quick branch, the rest
// compacted through a per-warp queue in shared memory) took the parent's
// time with the per-column stores, and with the staging below it was
// within 6% of this design either way by batch (PERF.md, kernel_ab.py), too
// little to pay for a queue and a routing rule. The stores bound it.
//
// Design: K1's (one warp a read on the persistent grid, the shared read
// loop, K1's column epilogue in every lane), with the thresholds in the
// column's finish. The counts o[4] are the column's own registers there; a
// lane stores them as one int4, so a warp step writes 512 contiguous bytes
// of obs. The narrow planes (qs, tb, tq, depth, errors, wp) of the 128
// columns in hand are staged in the warp's shared memory after the block's
// slices (928 B a warp) and written once the chunk is whole, 4 bytes a
// lane of each byte plane and 8 of each u16 plane: one store instruction a
// plane every four steps. 64 registers, no spills, as K1.

// A warp's staging of the narrow planes of the kChunk columns in hand,
// written out with one wide store a plane.
constexpr int kChunk = 128;

struct ChunkStage {
    uint16_t depth[kChunk];
    uint16_t errors[kChunk];
    uint8_t qs[kChunk];
    uint8_t tb[kChunk];
    uint8_t tq[kChunk];
    uint8_t wp[kChunk / 4];
};

struct ResidentOut {
    uint8_t* qs;
    uint8_t* wp;
    uint16_t* depth;
    uint16_t* errors;
    uint8_t* tb;
    uint8_t* tq;
    int4* obs;
};

// The staged chunk of w columns (w % 4 == 0) from column c0 of the read
// whose first column is `row`, into the planes: 4 bytes a lane of each byte
// plane and 8 of each u16 plane (row + c0 is a multiple of 4, as L is),
// and the wp bytes. All 32 lanes call it.
__device__ __forceinline__ void write_chunk(
        const ChunkStage& s, const ResidentOut& out, size_t row, int c0,
        int w, int lane) {
    __syncwarp();  // every lane's columns are staged
    const size_t col = row + c0 + 4 * lane;
    if (4 * lane < w) {
        const int i = 4 * lane;
        *reinterpret_cast<uint32_t*>(out.qs + col) =
            *reinterpret_cast<const uint32_t*>(s.qs + i);
        *reinterpret_cast<uint32_t*>(out.tb + col) =
            *reinterpret_cast<const uint32_t*>(s.tb + i);
        *reinterpret_cast<uint32_t*>(out.tq + col) =
            *reinterpret_cast<const uint32_t*>(s.tq + i);
        *reinterpret_cast<uint2*>(out.depth + col) =
            *reinterpret_cast<const uint2*>(s.depth + i);
        *reinterpret_cast<uint2*>(out.errors + col) =
            *reinterpret_cast<const uint2*>(s.errors + i);
        out.wp[col >> 2] = s.wp[lane];
    }
    __syncwarp();  // read before any lane stages the next chunk
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
consensus_wire_resident_kernel(
        const uint8_t* __restrict__ wire, const int32_t* __restrict__ starts,
        const float* __restrict__ dict, float pre, Constants k, int L,
        int num_segments, int min_reads, int min_qual, int slice_bytes,
        ResidentOut out) {
    __shared__ ObsTable table;
    extern __shared__ __align__(16) uint8_t stage_mem[];
    build_obs_table(dict, table);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint8_t* slice = stage_mem + warp * (slice_bytes + 16);
    ChunkStage& s = reinterpret_cast<ChunkStage*>(
        stage_mem + kWarps * (slice_bytes + 16))[warp];
    const int stride = gridDim.x * kWarps;
    for (int f = blockIdx.x * kWarps + warp; f < num_segments;
         f += stride) {
        const int r0 = starts[f];
        const size_t row = (size_t)f * L;
        auto finish = [=, &s](const float c[4], const int o[4], int pois,
                              bool valid, int pos) {
            int win, qual, depth, errors;
            bool suspect;
            column_epilogue(c, o, pois, pre, k, &win, &qual, &depth, &errors,
                            &suspect);
            const uint32_t wbits = wp_byte(win, valid, pos);
            const int p0 = pos - lane;  // the step's first column
            const int c0 = p0 & -kChunk;
            if (valid) {
                const int i = pos - c0;
                const bool low_depth = depth < min_reads;
                const bool low_qual = qual < min_qual;
                s.qs[i] = (uint8_t)(qual | (suspect ? 0x80 : 0));
                s.depth[i] = (uint16_t)depth;
                s.errors[i] = (uint16_t)errors;
                s.tb[i] = (uint8_t)((low_depth || low_qual) ? kNCode : win);
                s.tq[i] = (uint8_t)(low_depth ? 0
                                    : (low_qual ? kMinPhred : qual));
                if ((pos & 3) == 0) s.wp[i >> 2] = (uint8_t)wbits;
                out.obs[row + pos] = make_int4(o[0], o[1], o[2], o[3]);
            }
            // the chunk is whole at its fourth step or the read's last
            if (p0 + 32 >= L || ((p0 + 32) & (kChunk - 1)) == 0) {
                write_chunk(s, out, row, c0, min(kChunk, L - c0), lane);
            }
        };
        consensus_read(wire + (size_t)r0 * L, starts[f + 1] - r0, L,
                       slice_bytes, slice, table, lane, finish);
    }
}

// ---------------------------------------------------------------------------
// K1-f: the fused consensus->filter kernel.
//
// Replaces the Pallas dispatch fgumi_tpu/ops/pallas_kernel.py `_filter_jit` /
// `call_filter` (the same `_consensus_kernel` body plus the jnp filter
// epilogue that ran outside it). Per position, after K1's column epilogue:
// the consensus thresholds (low depth -> N/Q0, low qual -> N/Q2), the
// simplex per-base filter mask as integer compares (d16 < min_reads,
// e16 >= emin[d16] where emin is the exact integer reformulation of the f64
// per-base error-rate test, and tq < min_base_q), and the position's share
// of the 7 per-read stats over positions < lens[f].
//
// Bound: memory, as K1. Per output column it writes fb, fq (1 B each),
// depth/errors (2 B each), qs (1 B) and a quarter wp byte = 7.25 B, plus a
// 28 B stats row per read. The 32768-entry int32 emin table (128 KB) is read
// through __ldg and stays in L2; only the entries the data touches load.
//
// Design: K1's, with one owner per read, so the stats row reduces with warp
// shuffles alone (max for column 0, or for column 6, wrapping u32 sums for
// the rest) and lane 0 writes it; there is no shared slot.

struct FilterParams {
    int min_reads_c;   // consensus --min-reads
    int min_qual_c;    // consensus --min-consensus-base-quality
    int f_min_reads;   // filter per-base min depth
    int f_min_base_q;  // filter --min-base-quality (< 0: off)
    int per_base;      // records carry cd/ce: depth/error masks apply
};

constexpr int kStatsCols = 7;
constexpr int kI16Max = 32767;

struct FilterOut {
    int32_t* stats;
    uint8_t* fb;
    uint8_t* fq;
    uint16_t* depth;
    uint16_t* errors;
    uint8_t* qs;
    uint8_t* wp;
};

// The column epilogue, the filter and the stores of position `pos` of one
// read (its first column at `row` of the (J, L) planes), plus its share of
// the stats in s. All 32 lanes call it (the wp shuffles); lanes past L pass
// valid = false and store and count nothing.
__device__ __forceinline__ void finish_column(
        const float c[4], const int o[4], int pois, bool valid, int pos,
        size_t row, int len_f, float pre, const Constants& k,
        const FilterParams& fp, const int32_t* __restrict__ emin,
        const FilterOut& out, uint32_t s[kStatsCols]) {
    int win, qual, depth, errors;
    bool suspect;
    column_epilogue(c, o, pois, pre, k, &win, &qual, &depth, &errors,
                    &suspect);
    const uint32_t wbits = wp_byte(win, valid, pos);

    const bool low_depth = depth < fp.min_reads_c;
    const bool low_qual = qual < fp.min_qual_c;
    const int tb = (low_depth || low_qual) ? kNCode : win;
    const int tq = low_depth ? 0 : (low_qual ? kMinPhred : qual);
    const bool in_len = valid && pos < len_f;
    const int d16 = depth < kI16Max ? depth : kI16Max;
    const int e16 = errors < kI16Max ? errors : kI16Max;
    bool fmask = false;
    if (fp.per_base) {
        const int lim = d16 > 0 ? __ldg(emin + d16) : INT_MAX;
        fmask = d16 < fp.f_min_reads || e16 >= lim;
    }
    if (fp.f_min_base_q >= 0) fmask = fmask || tq < fp.f_min_base_q;
    fmask = fmask && in_len;
    const int fbv = fmask ? kNCode : tb;
    if (valid) {
        const size_t col = row + pos;
        out.qs[col] = (uint8_t)(qual | (suspect ? 0x80 : 0));
        out.depth[col] = (uint16_t)depth;
        out.errors[col] = (uint16_t)errors;
        out.fb[col] = (uint8_t)fbv;
        out.fq[col] = (uint8_t)(fmask ? kMinPhred : tq);
        if ((pos & 3) == 0) out.wp[col >> 2] = (uint8_t)wbits;  // L % 4 == 0
    }
    s[0] = max(s[0], in_len ? (uint32_t)d16 : 0u);
    s[1] += in_len ? (uint32_t)d16 : 0u;
    s[2] += in_len ? (uint32_t)e16 : 0u;
    s[3] += in_len ? (uint32_t)tq : 0u;
    s[4] += (in_len && fbv == kNCode) ? 1u : 0u;
    s[5] += (fmask && tb != kNCode) ? 1u : 0u;
    s[6] |= (in_len && suspect) ? 1u : 0u;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
consensus_wire_filter_kernel(
        const uint8_t* __restrict__ wire, const int32_t* __restrict__ starts,
        const float* __restrict__ dict, float pre, Constants k, int L,
        int num_segments, const int32_t* __restrict__ lens,
        const int32_t* __restrict__ emin, FilterParams fp, int slice_bytes,
        FilterOut out) {
    __shared__ ObsTable table;
    extern __shared__ __align__(16) uint8_t stage_mem[];
    build_obs_table(dict, table);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    uint8_t* slice = stage_mem + warp * (slice_bytes + 16);
    const int stride = gridDim.x * kWarps;
    for (int f = blockIdx.x * kWarps + warp; f < num_segments;
         f += stride) {
        const int r0 = starts[f];
        const int len_f = lens[f];
        const size_t row = (size_t)f * L;
        uint32_t s[kStatsCols] = {0u, 0u, 0u, 0u, 0u, 0u, 0u};
        auto finish = [=, &s](const float c[4], const int o[4], int pois,
                              bool valid, int pos) {
            finish_column(c, o, pois, valid, pos, row, len_f, pre, k, fp,
                          emin, out, s);
        };
        consensus_read(wire + (size_t)r0 * L, starts[f + 1] - r0, L,
                       slice_bytes, slice, table, lane, finish);
#pragma unroll
        for (int j = 0; j < kStatsCols; ++j) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const uint32_t u = __shfl_xor_sync(kFullMask, s[j], off);
                s[j] = j == 0 ? max(s[j], u)
                              : (j == 6 ? (s[j] | u) : s[j] + u);
            }
        }
        if (lane == 0) {
#pragma unroll
            for (int j = 0; j < kStatsCols; ++j) {
                out.stats[(size_t)f * kStatsCols + j] = (int32_t)s[j];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Launch geometry, shared by the kernels.

// A warp's slice of shared memory for rows of L bytes: 16 rows, between
// 2 KB and 6 KB (a 5-row family at L = 152 fits whole; longer reads go in
// strips), in 16-byte units.
int slice_bytes_for(int L) {
    long long s = 16LL * L;
    s = s < kMinSlice ? kMinSlice : (s > kMaxSlice ? kMaxSlice : s);
    return (int)((s + 15) & ~15LL);
}

struct Geometry {
    int grid;
    int warps;
    int smem;
    int blocks_per_sm;
    int slice;
    int sms;
};

// Occupancy per (kernel, device, dynamic shared bytes), computed at first
// use: the kernels use different registers, so one's entry does not
// hold for the other.
struct OccupancyEntry {
    const void* kernel;
    int dev;
    int smem;
    int sms;
    int blocks;
};
std::mutex g_occ_mutex;
OccupancyEntry g_occ[64];
int g_occ_n = 0;

// `warp_extra`: shared bytes a warp takes after the block's slices (K1-r's
// chunk staging; 0 for K1 and K1-f).
int launch_geometry(const void* kernel, int L, int num_segments,
                    int warp_extra, Geometry* g) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    g->warps = kWarps;
    g->slice = slice_bytes_for(L);
    g->smem = kWarps * (g->slice + 16 + warp_extra);
    int sms = 0, blocks = 0;
    {
        std::lock_guard<std::mutex> hold(g_occ_mutex);
        for (int i = 0; i < g_occ_n; ++i) {
            if (g_occ[i].kernel == kernel && g_occ[i].dev == dev &&
                g_occ[i].smem == g->smem) {
                sms = g_occ[i].sms;
                blocks = g_occ[i].blocks;
            }
        }
        if (blocks == 0) {
            // Without the opt-in a block may take 48 KB less its static
            // shared memory (the 6 KB byte table), which the slices pass
            // from L = 336 on: allow the widest slices whatever this L is.
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                kMaxSmem + kWarps * warp_extra);
            if (err != cudaSuccess) return (int)err;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, kernel, kThreads, g->smem);
            if (err != cudaSuccess) return (int)err;
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
            if (err != cudaSuccess) return (int)err;
            if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
            if (g_occ_n < 64) {
                g_occ[g_occ_n++] = {kernel, dev, g->smem, sms, blocks};
            }
        }
    }
    g->sms = sms;
    g->blocks_per_sm = blocks;
    const long long need =
        ((long long)num_segments + kWarps - 1) / kWarps;
    const long long full = (long long)sms * blocks;
    g->grid = (int)(need < full ? need : full);
    if (g->grid < 1) g->grid = 1;
    return 0;
}

int geometry_out(const void* kernel, int L, int num_segments,
                 int warp_extra, int* out) {
    if (L <= 0 || (L & 3) != 0) return (int)cudaErrorInvalidValue;
    Geometry g;
    const int rc = launch_geometry(kernel, L, num_segments, warp_extra, &g);
    if (rc != 0) return rc;
    out[0] = g.grid;
    out[1] = g.warps;
    out[2] = g.smem;
    out[3] = g.blocks_per_sm;
    out[4] = g.slice;
    out[5] = g.sms;
    return 0;
}

}  // namespace

extern "C" {

// K1 launch on `stream`: a persistent grid of warps, one consensus read
// (segment f < num_segments, rows [starts[f], starts[f+1]) of the (N, L)
// wire, L % 4 == 0) per warp at a time. Outputs are (num_segments, L)
// qs/depth/errors and (num_segments, L/4) wp. Returns cudaGetLastError()
// after the launch (0 on success).
int fgumi_consensus_wire_full(const uint8_t* wire, const int32_t* starts,
                              const float* dict, float pre, float ln_4_3,
                              float eps32, float phred_per_ln, int L,
                              int num_segments, uint8_t* qs, uint8_t* wp,
                              uint16_t* depth, uint16_t* errors,
                              cudaStream_t stream) {
    if (num_segments <= 0) return 0;
    if (L <= 0 || (L & 3) != 0) return (int)cudaErrorInvalidValue;
    Geometry g;
    const int rc = launch_geometry((const void*)consensus_wire_full_kernel, L,
                                   num_segments, 0, &g);
    if (rc != 0) return rc;
    Constants k{ln_4_3, eps32, phred_per_ln};
    FullOut out{qs, wp, depth, errors};
    consensus_wire_full_kernel<<<g.grid, kThreads, g.smem, stream>>>(
        wire, starts, dict, pre, k, L, num_segments, g.slice, out);
    return (int)cudaGetLastError();
}

// K1-r launch on `stream`: as K1, plus the consensus thresholds min_reads
// and min_qual. Extra outputs: tb, tq (num_segments, L) uint8 and obs
// (num_segments, L, 4) int32 (16-byte aligned; qs, tb and tq 4-byte,
// depth and errors 8-byte aligned). Returns cudaGetLastError() after the
// launch (0 on success).
int fgumi_consensus_wire_resident(
        const uint8_t* wire, const int32_t* starts, const float* dict,
        float pre, float ln_4_3, float eps32, float phred_per_ln, int L,
        int num_segments, int min_reads, int min_qual, uint8_t* qs,
        uint8_t* wp, uint16_t* depth, uint16_t* errors, uint8_t* tb,
        uint8_t* tq, int32_t* obs, cudaStream_t stream) {
    if (num_segments <= 0) return 0;
    if (L <= 0 || (L & 3) != 0) return (int)cudaErrorInvalidValue;
    // obs takes int4 stores, the chunk's byte planes 4-byte and its u16
    // planes 8-byte ones
    if (((uintptr_t)obs & 15u) != 0 ||
        (((uintptr_t)qs | (uintptr_t)tb | (uintptr_t)tq) & 3u) != 0 ||
        (((uintptr_t)depth | (uintptr_t)errors) & 7u) != 0) {
        return (int)cudaErrorMisalignedAddress;
    }
    Geometry g;
    const int rc = launch_geometry(
        (const void*)consensus_wire_resident_kernel, L, num_segments,
        (int)sizeof(ChunkStage), &g);
    if (rc != 0) return rc;
    Constants k{ln_4_3, eps32, phred_per_ln};
    ResidentOut out{qs, wp, depth, errors, tb, tq,
                    reinterpret_cast<int4*>(obs)};
    consensus_wire_resident_kernel<<<g.grid, kThreads, g.smem, stream>>>(
        wire, starts, dict, pre, k, L, num_segments, min_reads, min_qual,
        g.slice, out);
    return (int)cudaGetLastError();
}

// K1-f launch on `stream`: as K1, plus lens (num_segments,) consensus
// lengths and emin (32768,) int32. Outputs: stats (num_segments, 7) int32;
// fb, fq, qs (num_segments, L) and wp (num_segments, L/4) uint8; raw u16
// depth/errors (num_segments, L). Returns cudaGetLastError() after the
// launch (0 on success).
int fgumi_consensus_wire_filter(
        const uint8_t* wire, const int32_t* starts, const float* dict,
        float pre, float ln_4_3, float eps32, float phred_per_ln, int L,
        int num_segments, const int32_t* lens, const int32_t* emin,
        int min_reads_c, int min_qual_c, int f_min_reads, int f_min_base_q,
        int per_base, int32_t* stats, uint8_t* fb, uint8_t* fq,
        uint16_t* depth, uint16_t* errors, uint8_t* qs, uint8_t* wp,
        cudaStream_t stream) {
    if (num_segments <= 0) return 0;
    if (L <= 0 || (L & 3) != 0) return (int)cudaErrorInvalidValue;
    Geometry g;
    const int rc = launch_geometry(
        (const void*)consensus_wire_filter_kernel, L, num_segments, 0, &g);
    if (rc != 0) return rc;
    Constants k{ln_4_3, eps32, phred_per_ln};
    FilterParams fp{min_reads_c, min_qual_c, f_min_reads, f_min_base_q,
                    per_base};
    FilterOut out{stats, fb, fq, depth, errors, qs, wp};
    consensus_wire_filter_kernel<<<g.grid, kThreads, g.smem, stream>>>(
        wire, starts, dict, pre, k, L, num_segments, lens, emin, fp, g.slice,
        out);
    return (int)cudaGetLastError();
}

// Each kernel's launch geometry for rows of L bytes and num_segments reads
// on the current device: out[0..5] = grid blocks, warps per block, dynamic
// shared bytes per block (K1-r's with its warps' chunk staging), resident blocks per SM, shared bytes per warp's slice, SMs.
// Returns 0 or a cudaError_t.
int fgumi_consensus_wire_full_geometry(int L, int num_segments, int* out) {
    return geometry_out((const void*)consensus_wire_full_kernel, L,
                        num_segments, 0, out);
}

int fgumi_consensus_wire_filter_geometry(int L, int num_segments, int* out) {
    return geometry_out((const void*)consensus_wire_filter_kernel, L,
                        num_segments, 0, out);
}

int fgumi_consensus_wire_resident_geometry(int L, int num_segments,
                                           int* out) {
    return geometry_out((const void*)consensus_wire_resident_kernel, L,
                        num_segments, (int)sizeof(ChunkStage), out);
}

const char* fgumi_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
