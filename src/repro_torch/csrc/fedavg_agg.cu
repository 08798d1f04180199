// K3: the selection-weighted FedAvg mean of paper eq. (34) on Hopper.
//
// Replaces the JAX package's Pallas kernel
// kernels/fedavg_agg/kernel.py::_agg_kernel (fedavg_agg_call), for every
// parameter leaf of one aggregation in one launch: for each leaf i, stacked
// client tensors x_i (K, n_i) and the slot weights w (K,),
//
//     out_i[e] = sum_k (w_k / max(sum_j w_j, 1e-30)) * x_i[k, e]
//
// in float32.  The server runs it once per aggregation of every engine
// (loop, scan, async), over all the model's leaves.
//
// What bounds it on the card: memory, and at the simulation's sizes the
// launch.  It reads K * N floats once and writes N, with 2K operations per
// output: (K + 1) * N * 4 bytes against 2 * K * N flops, far below the
// card's ~20 flops per byte.  The mnist MLP's six leaves (N = 136 074 at
// K = 4) are a few microseconds of bytes, about one launch's floor, so the
// design's first aim is one launch per aggregation, not one per leaf:
//   * the leaves come in a table passed by value (__grid_constant__, read
//     from the constant bank): per leaf, its stacked and output pointers,
//     n_i and its first block.  Blocks are spread over the leaves by a
//     prefix of block counts; a block finds its leaf by a scan of the
//     table and loops over the leaf with a stride of the leaf's blocks;
//   * one thread per output element (four with float4 loads, where a
//     leaf's rows and output start on 16-byte boundaries and n_i % 4 == 0;
//     the scalar path takes the rest, e.g. a 10-float bias).  Thread e
//     reads x[0, e], x[1, e], ... at stride n_i, so a warp reads
//     neighbouring addresses of one row — coalesced — and the K loads of a
//     thread are independent, so they are in flight together;
//   * the normalised weights are computed once per block into shared
//     memory (K divisions), not once per element.
// A table holds kMaxLeaves leaves; the C entry launches once per full
// table (the paper's models need one).
//
// Replication contract: sum_j w_j is taken in slot order by one thread,
// clamped at 1e-30, each weight normalised by a true (IEEE) division, and
// each output accumulated over k = 0..K-1 in order from 0, one rounded
// multiply and one rounded add per slot (the library is built with
// --fmad=false); float4 lanes do the same per component.  No atomics: the
// result is the same bits on every run, which the async engine's bitwise
// full-buffer limit needs, and the plain torch version
// (kernels/fedavg_agg/ref.py) spells the same operations in the same order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// Blocks per leaf at most: enough to keep every SM busy (132 SMs x 8 blocks
// of 256 threads fill the H100's 2048 threads per SM, twice over); a larger
// leaf loops inside the block.
constexpr int64_t kMaxBlocksPerLeaf = 132 * 16;
constexpr int kMaxLeaves = 64;

struct Leaf {
  const float* x;   // (K, n) stacked client rows
  float* out;       // (n,)
  int64_t n;
  int first_block;  // the leaf's first block of the grid
  int vec;          // 1: float4 loads and stores
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int count;
};

__device__ __forceinline__ float4 axpy4(float4 acc, float w, float4 v) {
  acc.x = acc.x + w * v.x;
  acc.y = acc.y + w * v.y;
  acc.z = acc.z + w * v.z;
  acc.w = acc.w + w * v.w;
  return acc;
}

__global__ void __launch_bounds__(kBlock)
    agg_leaves_kernel(const __grid_constant__ LeafTable t, const float* __restrict__ w,
                      int k) {
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

  const int block = static_cast<int>(blockIdx.x);
  int li = 0;
  while (li + 1 < t.count && block >= t.leaf[li + 1].first_block) ++li;
  const Leaf& leaf = t.leaf[li];
  const int end = li + 1 < t.count ? t.leaf[li + 1].first_block : static_cast<int>(gridDim.x);
  const int64_t stride = static_cast<int64_t>(end - leaf.first_block) * blockDim.x;
  const int64_t start = static_cast<int64_t>(block - leaf.first_block) * blockDim.x + threadIdx.x;
  if (leaf.vec) {
    const int64_t n4 = leaf.n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(leaf.x);
    float4* out4 = reinterpret_cast<float4*>(leaf.out);
    for (int64_t e = start; e < n4; e += stride) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int j = 0; j < k; ++j) acc = axpy4(acc, w_hat[j], x4[static_cast<int64_t>(j) * n4 + e]);
      out4[e] = acc;
    }
  } else {
    const int64_t n = leaf.n;
    for (int64_t e = start; e < n; e += stride) {
      float acc = 0.0f;
      const float* col = leaf.x + e;
#pragma unroll 4
      for (int j = 0; j < k; ++j) acc = acc + w_hat[j] * col[static_cast<int64_t>(j) * n];
      leaf.out[e] = acc;
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.
extern "C" {

// `leaves` holds n_leaves rows of three int64: the (K, n) stacked pointer,
// the (n,) output pointer and n.  Rows with n == 0 are skipped; the rest go
// out in tables of fedavg_agg_table_leaves() leaves, one launch each.
// Returns the cudaGetLastError() code after the last launch (0 = launched).
int fedavg_agg_leaves_f32(const int64_t* leaves, int n_leaves, const void* w, int k,
                          void* stream) {
  if (k <= 0) return static_cast<int>(cudaGetLastError());
  LeafTable t;
  t.count = 0;
  int blocks = 0;
  const auto launch = [&]() {
    agg_leaves_kernel<<<blocks, kBlock, k * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const float*>(w), k);
    t.count = 0;
    blocks = 0;
    return cudaGetLastError();
  };
  for (int j = 0; j < n_leaves; ++j) {
    const int64_t n = leaves[3 * j + 2];
    if (n <= 0) continue;
    const auto x = reinterpret_cast<const float*>(leaves[3 * j]);
    const auto out = reinterpret_cast<float*>(leaves[3 * j + 1]);
    const int vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) % 16) == 0;
    const int64_t units = vec ? n / 4 : n;
    int64_t nb = (units + kBlock - 1) / kBlock;
    if (nb > kMaxBlocksPerLeaf) nb = kMaxBlocksPerLeaf;
    t.leaf[t.count] = Leaf{x, out, n, blocks, vec};
    t.count += 1;
    blocks += static_cast<int>(nb);
    if (t.count == kMaxLeaves) {
      const cudaError_t err = launch();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (t.count > 0) return static_cast<int>(launch());
  return static_cast<int>(cudaGetLastError());
}

// Leaves per launch.
int fedavg_agg_table_leaves(void) { return kMaxLeaves; }

}  // extern "C"
