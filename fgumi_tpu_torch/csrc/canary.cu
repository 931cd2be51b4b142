// K7, the device canary for Hopper (sm_90a): the int32 sum of a uint8
// vector. It replaces the XLA device function of the JAX package
// fgumi_tpu/ops/kernel.py:1211 `_canary_sum_jit` (jnp.sum(x.astype(int32))),
// the health monitor's liveness round trip over a 1 MiB zero payload
// (ops/kernel.py device_canary): any result other than 0 is corruption.
//
// Bound: memory. One read of n bytes and a 4-byte write; at the canary's
// 1 MiB that is 1,048,576 B / 3.35 TB/s = 0.31 us, far under a launch's own
// latency, which therefore sets the time. The design is the plainest one
// that reads at full width:
// - a grid-stride loop over 16-byte words, one 16-byte load a thread a
//   step (a warp reads 512 contiguous bytes), each word's 16 bytes summed
//   in registers;
// - the n % 16 tail bytes summed by the first threads of block 0;
// - a warp-shuffle reduction, one partial a warp in shared memory, the
//   first warp's reduction of those, and one atomicAdd a block into the
//   output word (zeroed on the stream before the launch).
//
// Numerics: integers only, so the sum is exact in any order. The wrapper
// caps n at (2^31 - 1) / 255 bytes, so no partial or total passes INT_MAX;
// the sums are unsigned and read back as int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ unsigned int word_sum(unsigned int w) {
    return (w & 0xffu) + ((w >> 8) & 0xffu) + ((w >> 16) & 0xffu) + (w >> 24);
}

__device__ __forceinline__ unsigned int warp_sum(unsigned int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__global__ void __launch_bounds__(kThreads)
canary_sum_kernel(const uint4* __restrict__ words, long long n_words,
                  const uint8_t* __restrict__ tail, int n_tail,
                  unsigned int* __restrict__ out) {
    unsigned int acc = 0;
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < n_words; i += stride) {
        const uint4 v = words[i];
        acc += word_sum(v.x) + word_sum(v.y) + word_sum(v.z) + word_sum(v.w);
    }
    if (blockIdx.x == 0 && (int)threadIdx.x < n_tail) acc += tail[threadIdx.x];
    __shared__ unsigned int partial[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    acc = warp_sum(acc);
    if (lane == 0) partial[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = warp_sum(lane < kWarps ? partial[lane] : 0u);
        if (lane == 0) atomicAdd(out, acc);
    }
}

}  // namespace

extern "C" {

// K7 on `stream`: out (one int32) = the sum of x[0, n) as uint8. x is
// 16-byte aligned and 0 < n <= INT_MAX / 255 (the wrapper checks). The
// output word is zeroed on the stream first. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for what the
// kernel does not take.
int fgumi_canary_sum(const uint8_t* x, long long n, int32_t* out,
                     cudaStream_t stream) {
    if (n <= 0 || n > 0x7fffffffLL / 255 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t), stream);
    if (err != cudaSuccess) return (int)err;
    const long long n_words = n / 16;
    const int n_tail = (int)(n % 16);
    long long blocks = (n_words + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    canary_sum_kernel<<<(int)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(x), n_words, x + n_words * 16, n_tail,
        reinterpret_cast<unsigned int*>(out));
    return (int)cudaGetLastError();
}

// The launch of K7 over n bytes into out[2]: grid blocks and threads a
// block.
int fgumi_canary_sum_geometry(long long n, int* out) {
    long long blocks = (n / 16 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    out[0] = (int)blocks;
    out[1] = kThreads;
    return 0;
}

const char* fgumi_canary_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
