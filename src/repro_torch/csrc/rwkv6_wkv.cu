// K5: the RWKV-6 ("Finch") WKV recurrence on Hopper.
//
// Replaces the JAX package's Pallas kernel
// kernels/rwkv6_wkv/kernel.py::_wkv6_kernel (called from wkv6_call, wrapper
// kernels/rwkv6_wkv/ops.py::wkv6_pallas).  For r, k, v, w (B, T, H, hs) in
// the model's layout, u (H, hs) and the state S (B, H, hs, hs), all f32:
//
//     y_t[j]   = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// for t = 0 .. T-1, returning y and the final S.  The serving path calls it
// for every WKV step: prefill (T = prompt length) and each decode step
// (T = 1).
//
// What bounds it on the card.  It reads r, k, v, w once and writes y once
// (5 * B * T * H * hs floats) and reads and writes the state once, and its
// 7 * B * T * H * hs^2 flops take about as long at the card's 67 TFLOP/s
// FP32; but none of them fuse (the contract below forbids FMA), so the
// FP32 pipe needs twice that, and the recurrence is sequential in t, so
// every step's r_i, k_i, w_i must reach every column's threads from shared
// memory: 12 bytes per state element per step.  Read with one 32-bit load
// each (as by one thread per column), shared-memory bandwidth per lane, not
// the parallelism, bounds the kernel; with a column spread over TPC
// neighbouring lanes of a warp, a warp's loads hit TPC addresses and
// shared memory serves them in as many wavefronts.  The design:
//   * one block per (batch, head) of TPC * hs threads, TPC =
//     kThreadsPerColumn = 4 threads per column of S (on the H100, 1, 2 and
//     8 gave times within a few per cent of 4: PERF.md).  Thread (c, j)
//     keeps S[i][j] and u_i
//     for the hs / TPC rows i = a * TPC + c in registers; S is read from
//     and written to memory once.  A warp holds 32 columns of one c, so
//     all its lanes read the same rows: every load is a broadcast;
//   * r_t, k_t, w_t, v_t of 16 steps at a time are staged in shared memory
//     by all threads with cp.async, into two buffers: the next 16 steps
//     load while these are computed.  r, k and w are stored with each row
//     group's rows together, so a thread reads four with one 128-bit load;
//   * y_j's sum over i is one pairwise tree (i + hs/2, then i + hs/4, ...):
//     thread c runs the levels i + hs/2 .. i + TPC over its own hs / TPC
//     products (local index a pairs with a + hs / (2 TPC), which is i with
//     i + hs/2) and writes its partial sum to shared memory; after each
//     chunk the block runs the last log2 TPC levels (i + TPC/2 .. i + 1)
//     over the partials of every (step, column) and writes y.
//
// Replication contract: every product and sum is one IEEE f32 operation
// (the library is built with --fmad=false), in the order of the plain
// version kernels/rwkv6_wkv/ref.py::wkv6_plain — kv = k_i v_j,
// a = S + u_i kv, p_i = r_i a, the same tree over i, S = w_i S + kv — so
// kernel and plain version agree to the bit (the tree is the same tree,
// cut between threads at a level boundary).  The
// model needs that: with random weights at full width, f32 differences in
// a head's nearly cancelling sums become bf16 rounding flips after the
// per-head normalisation and grow over the layers (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;            // time steps staged per buffer
constexpr int kThreadsPerColumn = 4;  // TPC: threads per column of S

// p[0] = the pairwise-tree sum of p[0 .. N): p[i] += p[i + N/2], then over
// the first N/2, ... — every index a compile-time constant, so p stays in
// registers.
template <int N>
__device__ __forceinline__ void tree_sum(float* p) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = p[i] + p[i + N / 2];
  if constexpr (N > 2) tree_sum<N / 2>(p);
}

// Dynamic shared memory of one block, in floats: r, k, w and v of kChunk
// steps, twice (one buffer is read while the other fills), and the TPC
// partial sums of every (step, column) of a chunk.  A staged r, k or w step
// holds row i at (i % TPC) * N + i / TPC: thread group c's rows together.
template <int HS>
struct Smem {
  static constexpr int TPC = kThreadsPerColumn;
  static constexpr int N = HS / TPC;  // state rows per thread
  static_assert(N % 4 == 0, "a thread reads its rows four at a time");
  static constexpr int kBuf = kChunk * HS;  // one array, one buffer
  static constexpr int kR = 0, kK = 2 * kBuf, kW = 4 * kBuf, kV = 6 * kBuf, kPart = 8 * kBuf;
  static constexpr int kFloats = kPart + kChunk * TPC * HS;
  __device__ static constexpr int pos(int i) { return (i % TPC) * N + i / TPC; }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <int HS>
__global__ void __launch_bounds__(HS * kThreadsPerColumn)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int t_len, int n_heads) {
  using L = Smem<HS>;
  constexpr int TPC = L::TPC, N = L::N;
  constexpr int kBlock = HS * TPC;
  extern __shared__ __align__(16) float smem[];
  float* const part = smem + L::kPart;  // [kChunk][TPC][HS]
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x;
  const int c = tid / HS, j = tid % HS;  // rows c, c + TPC, ... of column j

  const int64_t step = static_cast<int64_t>(n_heads) * HS;  // between time steps
  const int64_t base = static_cast<int64_t>(b) * t_len * step + static_cast<int64_t>(h) * HS;
  // Asynchronous copies of steps t0 .. t0 + kChunk - 1 into buffer buf.
  auto stage = [&](int t0, int buf) {
    const int n = min(kChunk, t_len - t0);
    float* const dst = smem + buf * L::kBuf;
    for (int idx = tid; idx < n * HS; idx += kBlock) {
      const int tt = idx / HS, i = idx % HS;
      const int64_t off = base + static_cast<int64_t>(t0 + tt) * step + i;
      cp_async4(dst + L::kR + tt * HS + L::pos(i), r + off);
      cp_async4(dst + L::kK + tt * HS + L::pos(i), k + off);
      cp_async4(dst + L::kW + tt * HS + L::pos(i), w + off);
      cp_async4(dst + L::kV + tt * HS + i, v + off);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0, 0);

  float S[N], us[N];
  const float* s_in = s0 + static_cast<int64_t>(bh) * HS * HS;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    S[a] = s_in[(a * TPC + c) * HS + j];
    us[a] = u[h * HS + a * TPC + c];
  }

  for (int t0 = 0, buf = 0; t0 < t_len; t0 += kChunk, buf ^= 1) {
    const int n = min(kChunk, t_len - t0);
    if (t0 + kChunk < t_len) {
      stage(t0 + kChunk, buf ^ 1);  // its buffer's readers finished last chunk
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this chunk's copies, from every thread, have landed
    const float* const cur = smem + buf * L::kBuf;
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      const float vj = cur[L::kV + tt * HS + j];
      // Every lane of a warp has the same c: these loads are broadcasts.
      const float4* r4 = reinterpret_cast<const float4*>(cur + L::kR + tt * HS + c * N);
      const float4* k4 = reinterpret_cast<const float4*>(cur + L::kK + tt * HS + c * N);
      const float4* w4 = reinterpret_cast<const float4*>(cur + L::kW + tt * HS + c * N);
      float p[N];
#pragma unroll
      for (int a4 = 0; a4 < N / 4; ++a4) {
        const float4 rq = r4[a4], kq = k4[a4], wq = w4[a4];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w}, kk[4] = {kq.x, kq.y, kq.z, kq.w},
                    ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = 4 * a4 + e;  // row i = a * TPC + c
          const float kv = kk[e] * vj;
          p[a] = rr[e] * (S[a] + us[a] * kv);
          S[a] = ww[e] * S[a] + kv;
        }
      }
      tree_sum<N>(p);
      part[(tt * TPC + c) * HS + j] = p[0];
    }
    __syncthreads();  // buf is read; the partial sums are written
    // The tree's last log2 TPC levels: y = tree over the TPC partials.
    for (int idx = tid; idx < n * HS; idx += kBlock) {
      const int tt = idx / HS, jj = idx % HS;
      float x[TPC];
#pragma unroll
      for (int cc = 0; cc < TPC; ++cc) x[cc] = part[(tt * TPC + cc) * HS + jj];
      tree_sum<TPC>(x);
      y[base + static_cast<int64_t>(t0 + tt) * step + jj] = x[0];
    }
  }

  float* s_fin = s_out + static_cast<int64_t>(bh) * HS * HS;
#pragma unroll
  for (int a = 0; a < N; ++a) s_fin[(a * TPC + c) * HS + j] = S[a];
}

template <int HS>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* y, float* s_out, int b, int t_len, int n_heads,
           cudaStream_t stream) {
  constexpr int smem = Smem<HS>::kFloats * static_cast<int>(sizeof(float));
  if constexpr (smem > 48 * 1024) {  // the opt-in above 48 KB, on the current device
    cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<HS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_kernel<HS><<<b * n_heads, HS * kThreadsPerColumn, smem, stream>>>(
      r, k, v, w, u, s0, y, s_out, t_len, n_heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  r, k, v, w and y (b, t_len,
// n_heads, hs); u (n_heads, hs); s0 and s_out (b, n_heads, hs, hs); all
// contiguous float32 on the current device, hs 32 or 64, t_len >= 1.
// Returns the cudaGetLastError() code right after the launch (0 =
// launched).
extern "C" int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out, int b, int t_len,
                        int n_heads, int hs, void* stream) {
  if (b <= 0 || n_heads <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const yy = static_cast<float*>(y);
  float* const so = static_cast<float*>(s_out);
  if (hs == 32)
    return launch<32>(f(r), f(k), f(v), f(w), f(u), f(s0), yy, so, b, t_len, n_heads, s);
  if (hs == 64)
    return launch<64>(f(r), f(k), f(v), f(w), f(u), f(s0), yy, so, b, t_len, n_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Threads per block of the wkv6_f32 entry at head size hs.
extern "C" int wkv6_threads_per_block(int hs) { return hs * kThreadsPerColumn; }
