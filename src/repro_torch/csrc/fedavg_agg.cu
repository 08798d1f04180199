// K3: the selection-weighted FedAvg mean of paper eq. (34) on Hopper.
//
// Replaces the JAX package's Pallas kernel
// kernels/fedavg_agg/kernel.py::_agg_kernel (fedavg_agg_call): for stacked
// client tensors x (K, N) and slot weights w (K,),
//
//     out[n] = sum_k (w_k / max(sum_j w_j, 1e-30)) * x[k, n]
//
// in float32.  The server runs it once per parameter leaf at every
// aggregation of every engine (loop, scan, async).
//
// What bounds it on the card: memory.  It reads K * N floats once and
// writes N, with 2K operations per output: (K + 1) * N * 4 bytes against
// 2 * K * N flops, far below the card's ~20 flops per byte.  The design
// keeps every byte moving once and nothing else:
//   * one thread per output element in a grid-stride loop; thread i reads
//     x[0, i], x[1, i], ... at stride N, so the 32 threads of a warp read
//     32 neighbouring floats of one row — one coalesced transaction per
//     slot — and the K loads of a thread are independent, so they are in
//     flight together;
//   * the normalised weights are computed once per block into shared
//     memory (K divisions), not once per element.
//
// Replication contract: sum_j w_j is taken in slot order by one thread,
// clamped at 1e-30, each weight normalised by a true (IEEE) division, and
// out[n] accumulated over k = 0..K-1 in order from 0, one rounded multiply
// and one rounded add per slot (the library is built with --fmad=false).
// No atomics: the result is the same bits on every run, which the async
// engine's bitwise full-buffer limit needs, and the plain torch version
// (kernels/fedavg_agg/ref.py) spells the same operations in the same order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// Enough blocks to keep every SM busy (132 SMs x 16 blocks of 256 threads
// fill the H100's 2048 threads per SM); larger N loops inside the block.
constexpr int64_t kMaxGrid = 132 * 16;

__global__ void agg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           float* __restrict__ out, int k, int64_t n) {
  extern __shared__ float w_hat[];
  __shared__ float wsum;
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s = s + w[j];
    wsum = fmaxf(s, 1e-30f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) w_hat[j] = w[j] / wsum;
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.0f;
    const float* col = x + i;
#pragma unroll 4
    for (int j = 0; j < k; ++j) acc = acc + w_hat[j] * col[static_cast<int64_t>(j) * n];
    out[i] = acc;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the cudaGetLastError()
// code right after the launch (0 = launched).
extern "C" int fedavg_agg_f32(const void* x, const void* w, void* out, int k, int64_t n,
                              void* stream) {
  if (n > 0 && k > 0) {
    int64_t blocks = (n + kBlock - 1) / kBlock;
    if (blocks > kMaxGrid) blocks = kMaxGrid;
    agg_kernel<<<static_cast<unsigned int>(blocks), kBlock, k * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), k, n);
  }
  return static_cast<int>(cudaGetLastError());
}
