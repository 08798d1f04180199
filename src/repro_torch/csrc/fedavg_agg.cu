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
// A cell axis (fedavg_agg_cells_f32): a group of B simulation cells
// aggregates in the same launch, the cell on blockIdx.y over the same leaf
// table.  Each leaf row then carries its output's cell stride (x's is
// K * n_i); each block normalises its own cell's K weights (w is (B, K)).
// A one-cell launch is the B = 1 grid, so every cell's output is the bits
// of its own one-cell launch.
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
  const float* x;      // (B, K, n) stacked client rows, cell stride K * n
  float* out;          // (B, n) outputs, cell stride out_stride
  int64_t n;
  int64_t out_stride;
  int first_block;     // the leaf's first block of the grid
  int vec;             // 1: float4 loads and stores
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
  const int64_t cell = blockIdx.y;
  const float* wc = w + cell * k;
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s = s + wc[j];
    wsum = fmaxf(s, 1e-30f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) w_hat[j] = wc[j] / wsum;
  __syncthreads();

  const int block = static_cast<int>(blockIdx.x);
  int li = 0;
  while (li + 1 < t.count && block >= t.leaf[li + 1].first_block) ++li;
  const Leaf& leaf = t.leaf[li];
  const int end = li + 1 < t.count ? t.leaf[li + 1].first_block : static_cast<int>(gridDim.x);
  const int64_t stride = static_cast<int64_t>(end - leaf.first_block) * blockDim.x;
  const int64_t start = static_cast<int64_t>(block - leaf.first_block) * blockDim.x + threadIdx.x;
  const float* x = leaf.x + cell * k * leaf.n;
  float* out = leaf.out + cell * leaf.out_stride;
  if (leaf.vec) {
    const int64_t n4 = leaf.n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* out4 = reinterpret_cast<float4*>(out);
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
      const float* col = x + e;
#pragma unroll 4
      for (int j = 0; j < k; ++j) acc = acc + w_hat[j] * col[static_cast<int64_t>(j) * n];
      out[e] = acc;
    }
  }
}

// Fill tables from `leaves` (rows of `width` int64: the stacked pointer,
// the output pointer, n and, when width is 4, the output's cell stride) and
// launch each full table over a (blocks, cells) grid.  Rows with n == 0 are
// skipped.  Returns the cudaGetLastError() code after the last launch.
int agg_launch(const int64_t* leaves, int n_leaves, int width, const void* w, int k,
               int cells, void* stream) {
  if (k <= 0 || cells <= 0) return static_cast<int>(cudaGetLastError());
  LeafTable t;
  t.count = 0;
  int blocks = 0;
  const auto launch = [&]() {
    agg_leaves_kernel<<<dim3(blocks, cells), kBlock, k * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(t, static_cast<const float*>(w), k);
    t.count = 0;
    blocks = 0;
    return cudaGetLastError();
  };
  for (int j = 0; j < n_leaves; ++j) {
    const int64_t* row = leaves + static_cast<int64_t>(width) * j;
    const int64_t n = row[2];
    if (n <= 0) continue;
    const auto x = reinterpret_cast<const float*>(row[0]);
    const auto out = reinterpret_cast<float*>(row[1]);
    const int64_t out_stride = width > 3 ? row[3] : n;
    const int vec = n % 4 == 0 && out_stride % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) % 16) == 0;
    const int64_t units = vec ? n / 4 : n;
    int64_t nb = (units + kBlock - 1) / kBlock;
    if (nb > kMaxBlocksPerLeaf) nb = kMaxBlocksPerLeaf;
    t.leaf[t.count] = Leaf{x, out, n, out_stride, blocks, vec};
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

}  // namespace

// Plain C interface, loaded with ctypes.
extern "C" {

// One aggregation: `leaves` holds n_leaves rows of three int64, the (K, n)
// stacked pointer, the (n,) output pointer and n; w is (K,).  The leaves go
// out in tables of fedavg_agg_table_leaves() leaves, one launch each.
int fedavg_agg_leaves_f32(const int64_t* leaves, int n_leaves, const void* w, int k,
                          void* stream) {
  return agg_launch(leaves, n_leaves, 3, w, k, 1, stream);
}

// One aggregation per cell of a group, all cells in the same launches:
// rows of four int64, the (B, K, n) stacked pointer, the output pointer,
// n and the output's cell stride (in floats); w is (B, K), B = cells.
int fedavg_agg_cells_f32(const int64_t* leaves, int n_leaves, const void* w, int k,
                         int cells, void* stream) {
  return agg_launch(leaves, n_leaves, 4, w, k, cells, stream);
}

// Leaves per launch.
int fedavg_agg_table_leaves(void) { return kMaxLeaves; }

// Cells per launch: the grid's y limit.
int fedavg_agg_max_cells(void) { return 65535; }

}  // extern "C"
