// K8, the tuner's elementwise combine for Hopper (sm_90a). It replaces the
// XLA device function of the JAX package fgumi_tpu/tune/autotune.py:206-207
// `dev_combine`, jitted inside `_bench_choosers`:
//     where(x == y, min(x, y) + 3, max(x, y) - min(x, y))
// over two uint8 (n, L) arrays, uint8 out, in 8-bit unsigned arithmetic
// (min + 3 wraps for a minimum of 253-255, as in JAX, numpy and PyTorch).
// `tune` times it against the same numpy expression to price the two
// strand-combine choosers (seconds per million cells on each side).
//
// Bound: memory. Each cell reads two bytes and writes one: 3 bytes a cell,
// 153,600 B at the quick (512, 100) and 1,843,200 B at (4096, 150), that
// is 0.0000459 and 0.000550 ms at 3.35 TB/s. A launch's own latency (a few
// microseconds) is far above both, so it sets the time, as for K7. The
// design is the plainest one that reads at full width:
// - a grid-stride loop over 16-byte words where x, y and out are all
//   16-byte aligned: one 16-byte load of each input and one 16-byte store a
//   thread a step, each 4-byte lane combined with the SIMD byte
//   intrinsics (__vcmpeq4, __vminu4, __vmaxu4, __vadd4, __vsub4: four
//   bytes at once, each byte wrapping on its own);
// - the n % 16 tail bytes, or every byte where a pointer is not 16-byte
//   aligned (a sliced input), one byte a thread a step.
//
// Numerics: integers only; the output is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

// four cells of one 32-bit lane: eq selects min + 3, else max - min
__device__ __forceinline__ unsigned int combine4(unsigned int x,
                                                 unsigned int y) {
    const unsigned int lo = __vminu4(x, y);
    const unsigned int hi = __vmaxu4(x, y);
    const unsigned int eq = __vcmpeq4(x, y);  // 0xff in each equal byte
    return (eq & __vadd4(lo, 0x03030303u)) | (~eq & __vsub4(hi, lo));
}

__device__ __forceinline__ uint8_t combine1(uint8_t x, uint8_t y) {
    const uint8_t lo = x < y ? x : y;
    const uint8_t hi = x < y ? y : x;
    return x == y ? (uint8_t)(lo + 3) : (uint8_t)(hi - lo);
}

__global__ void __launch_bounds__(kThreads)
tune_combine_kernel(const uint8_t* __restrict__ x,
                    const uint8_t* __restrict__ y,
                    uint8_t* __restrict__ out, long long n,
                    long long n_words) {
    const long long stride = (long long)gridDim.x * kThreads;
    const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
    const uint4* xw = reinterpret_cast<const uint4*>(x);
    const uint4* yw = reinterpret_cast<const uint4*>(y);
    uint4* ow = reinterpret_cast<uint4*>(out);
    for (long long i = first; i < n_words; i += stride) {
        const uint4 a = xw[i];
        const uint4 b = yw[i];
        ow[i] = make_uint4(combine4(a.x, b.x), combine4(a.y, b.y),
                           combine4(a.z, b.z), combine4(a.w, b.w));
    }
    for (long long i = n_words * 16 + first; i < n; i += stride)
        out[i] = combine1(x[i], y[i]);
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// (grid blocks, 16-byte words) of a launch over n bytes
void plan(long long n, bool vector, int* blocks, long long* n_words) {
    *n_words = vector ? n / 16 : 0;
    const long long items = *n_words + (n - *n_words * 16);
    long long b = (items + kThreads - 1) / kThreads;
    if (b < 1) b = 1;
    if (b > kMaxBlocks) b = kMaxBlocks;
    *blocks = (int)b;
}

}  // namespace

extern "C" {

// K8 on `stream`: out[i] = combine(x[i], y[i]) for i in [0, n). The three
// buffers hold n > 0 bytes each; the 16-byte path runs where all three are
// 16-byte aligned, the byte path otherwise. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for n <= 0.
int fgumi_tune_combine(const uint8_t* x, const uint8_t* y, uint8_t* out,
                       long long n, cudaStream_t stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    int blocks;
    long long n_words;
    plan(n, aligned16(x) && aligned16(y) && aligned16(out), &blocks,
         &n_words);
    tune_combine_kernel<<<blocks, kThreads, 0, stream>>>(x, y, out, n,
                                                         n_words);
    return (int)cudaGetLastError();
}

// The launch of K8 over n bytes into out[3]: grid blocks, threads a block,
// and 1 where the 16-byte path runs (`vector`, all pointers aligned).
int fgumi_tune_combine_geometry(long long n, int vector, int* out) {
    int blocks;
    long long n_words;
    plan(n, vector != 0, &blocks, &n_words);
    out[0] = blocks;
    out[1] = kThreads;
    out[2] = vector != 0;
    return 0;
}

const char* fgumi_tune_combine_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
