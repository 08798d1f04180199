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
// What bounds it on the card: bytes, barely.  It reads r, k, v, w once and
// writes y once (5 * B * T * H * hs floats) and reads and writes the state
// once; its 7 * B * T * H * hs^2 flops take about as long at the card's
// 67 TFLOP/s FP32.  But the recurrence is sequential in t, so the
// parallelism is B * H * hs threads, and its time is the latency of T steps.
// The design keeps the state out of memory for all T steps:
//   * one block per (batch, head), hs threads; thread j owns column j of
//     S, S[:, j], in hs registers, read from and written to memory once;
//   * r_t, k_t, w_t, v_t of 32 steps at a time are staged in shared memory
//     with one barrier pair per 32 steps (coalesced: thread j loads element
//     j of each row); every thread then reads r_t[i], k_t[i], w_t[i], u[i]
//     as shared-memory broadcasts;
//   * y_j's sum over i is a pairwise tree (i + hs/2, then i + hs/4, ...)
//     over hs products held in registers, so one step is not a chain of hs
//     dependent adds.
//
// Replication contract: every product and sum is one IEEE f32 operation
// (the library is built with --fmad=false), in the order of the plain
// version kernels/rwkv6_wkv/ref.py::wkv6_plain — kv = k_i v_j,
// a = S + u_i kv, p_i = r_i a, the same tree over i, S = w_i S + kv — so
// kernel and plain version agree to the bit.  The model needs that: with
// random weights at full width, f32 differences in a head's nearly
// cancelling sums become bf16 rounding flips after the per-head
// normalisation and grow over the layers (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // time steps staged per barrier pair

// p[0] = the pairwise-tree sum of p[0 .. N): p[i] += p[i + N/2], then over
// the first N/2, ... — every index a compile-time constant, so p stays in
// registers.
template <int N>
__device__ __forceinline__ void tree_sum(float* p) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = p[i] + p[i + N / 2];
  if constexpr (N > 2) tree_sum<N / 2>(p);
}

template <int HS>
__global__ void __launch_bounds__(HS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int t_len, int n_heads) {
  __shared__ float rs[kChunk][HS], ks[kChunk][HS], ws[kChunk][HS], vs[kChunk][HS];
  __shared__ float us[HS];
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int j = threadIdx.x;

  float S[HS];
  const float* s_in = s0 + static_cast<int64_t>(bh) * HS * HS;
#pragma unroll
  for (int i = 0; i < HS; ++i) S[i] = s_in[i * HS + j];
  us[j] = u[h * HS + j];

  const int64_t step = static_cast<int64_t>(n_heads) * HS;  // between time steps
  const int64_t base = static_cast<int64_t>(b) * t_len * step + static_cast<int64_t>(h) * HS + j;
  for (int t0 = 0; t0 < t_len; t0 += kChunk) {
    const int n = min(kChunk, t_len - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int tt = 0; tt < n; ++tt) {
      const int64_t off = base + static_cast<int64_t>(t0 + tt) * step;
      rs[tt][j] = r[off];
      ks[tt][j] = k[off];
      ws[tt][j] = w[off];
      vs[tt][j] = v[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float p[HS];
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float kv = ks[tt][i] * vj;
        p[i] = rs[tt][i] * (S[i] + us[i] * kv);
        S[i] = ws[tt][i] * S[i] + kv;
      }
      tree_sum<HS>(p);
      y[base + static_cast<int64_t>(t0 + tt) * step] = p[0];
    }
  }

  float* s_fin = s_out + static_cast<int64_t>(bh) * HS * HS;
#pragma unroll
  for (int i = 0; i < HS; ++i) s_fin[i * HS + j] = S[i];
}

template <int HS>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* y, float* s_out, int b, int t_len, int n_heads,
           cudaStream_t stream) {
  wkv6_kernel<HS><<<b * n_heads, HS, 0, stream>>>(r, k, v, w, u, s0, y, s_out, t_len, n_heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  r, k, v, w and y (b, t_len,
// n_heads, hs); u (n_heads, hs); s0 and s_out (b, n_heads, hs, hs); all
// contiguous float32 on the current device, hs 32 or 64, t_len >= 1.
// Returns the cudaGetLastError() code right after the launch (0 = launched).
extern "C" int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_out, int b, int t_len,
                        int n_heads, int hs, void* stream) {
  if (b <= 0 || n_heads <= 0 || t_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hs == 32)
    return launch<32>(f(r), f(k), f(v), f(w), f(u), f(s0), static_cast<float*>(y),
                      static_cast<float*>(s_out), b, t_len, n_heads, s);
  if (hs == 64)
    return launch<64>(f(r), f(k), f(v), f(w), f(u), f(s0), static_cast<float*>(y),
                      static_cast<float*>(s_out), b, t_len, n_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
