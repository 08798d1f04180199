// K4: causal / sliding-window flash attention with grouped KV heads, on Hopper.
//
// Replaces the JAX package's Pallas kernel
// kernels/flash_attention/kernel.py::flash_attention_kernel (called from
// flash_attention_call, wrapper kernels/flash_attention/ops.py).  For q
// (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) in the model's own layout, bf16 or
// f32, query head h reading KV head h / (Hq / Hkv):
//
//     s[i, j] = (q_i . k_j) * scale           masked to -1e30 unless
//               j <= i + Sk - Sq (causal) and j > i + Sk - Sq - window
//     o_i     = sum_j softmax_j(s[i, :]) v_j    in f32, cast to q's type once
//
// with the Pallas body's online softmax: a running max m and denominator l
// per query row in f32, acc = acc * exp(m_old - m_new) + p . v, and
// o = acc / max(l, 1e-30) at the end.
//
// What bounds it on the card: at the serving shapes (Sq = Sk = 512, D = 128)
// the work, 4 * B * Hq * S^2 * D / 2 flops, is far above the bytes
// (q, k, v, o once each), so the tensor cores bound it.  This first kernel
// does not use them: it is a plain SIMT kernel, right first —
//   * one block of 128 threads per (batch * query head, 64-query block);
//     the four warps own 16 query rows each;
//   * K and V tiles of 64 keys staged in shared memory in the input type
//     (rows padded by 4 bytes, so the column reads below hit 32 distinct
//     banks); the Q tile too, read once per key tile;
//   * each thread computes a 4-row x 8-key block of scores (12 shared loads
//     for 32 FMAs), row max and row sum over the 8 threads of a row group
//     by shuffles, and keeps a 4-row x D/8 block of the output accumulator
//     and the rows' m and l in f32 registers; the probabilities reach the
//     P.V product by shuffles, not through shared memory;
//   * GQA by indexing the KV head: the repeat is never materialised;
//   * key tiles that the causal or window mask hides from every row of the
//     block are skipped.  Skipping cannot change a row's result: each row
//     has an unmasked key inside the visited range, and a tile masked for
//     a row contributes exp(-1e30 - m) = 0 after that key (before it, its
//     weight is multiplied by exp(-1e30 - m_new) = 0 when the key arrives).
// wgmma, TMA and warp specialisation are work for a later kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row pitch of a staged tile, in elements: D plus 4 bytes.
template <typename T, int D>
__host__ __device__ constexpr int pitch() { return D + 4 / static_cast<int>(sizeof(T)); }

template <typename T, int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBQ + 2 * kBK) * pitch<T, D>() * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int sq, int sk, int hq, int hkv, float scale, int causal,
                 int window) {
  constexpr int P = pitch<T, D>();
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBQ * P;
  T* vs = ks + kBK * P;

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * D;   // between positions
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
  const T* qb = q + static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * D;
  const T* kb = k + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * D;
  const T* vb = v + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * D;
  T* ob = o + static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int row0 = warp * 16 + rg * 4;  // this thread's 4 rows: row0 .. row0 + 3

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qs[r * P + c] = (q0 + r < sq) ? qb[static_cast<int64_t>(q0 + r) * q_stride + c] : from_f<T>(0.f);
  }

  // The key tiles some row of this block can see.
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int n_tiles = (sk + kBK - 1) / kBK;
  int kt_hi = n_tiles;
  if (causal) kt_hi = min(n_tiles, (last_q + q_offset) / kBK + 1);
  int kt_lo = 0;
  if (window > 0) {
    const int first_col = q0 + q_offset - window + 1;
    if (first_col > 0) kt_lo = first_col / kBK;
  }

  float m_run[4], l_run[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < sk;
      const int64_t off = static_cast<int64_t>(k0 + r) * kv_stride + c;
      ks[r * P + c] = in ? kb[off] : from_f<T>(0.f);
      vs[r * P + c] = in ? vb[off] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f(qs[(row0 + i) * P + dd]);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = to_f(ks[(cg + 8 * j) * P + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + row0 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] * scale;
        if (col >= sk) {
          x = -INFINITY;  // past the end of the keys: no weight at all
        } else if ((causal && col > qpos) || (window > 0 && col <= qpos - window)) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_run[i] = alpha * l_run[i] + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }

    // acc[i][:] += sum_kk p[row i][kk] * v[kk][cg + 8 j]; p[row i][kk] lives
    // in register p[i][kk / 8] of lane (row group) * 8 + kk % 8.
    const int src_base = lane & ~7;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int src = 0; src < 8; ++src) {
        const int kk = src + 8 * jj;
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = __shfl_sync(0xffffffffu, p[i][jj], src_base + src);
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float vv = to_f(vs[kk * P + cg + 8 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    T* orow = ob + static_cast<int64_t>(qi) * q_stride;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[cg + 8 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int hq,
           int hkv, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  // The opt-in above 48 KB of shared memory, on the current device.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, hq, hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int hq,
             int hkv, int d, float scale, int causal, int window, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<T, 64>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  if (d == 128) return launch<T, 128>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes.  q (b, sq, hq, d), k and v
// (b, sk, hkv, d), o like q, all contiguous on the current device; d is 64
// or 128, hq a multiple of hkv, sq <= sk.  Returns the cudaGetLastError()
// code right after the launch (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int sk, int hq, int hkv, int d, float scale,
                                   int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, b, sq, sk, hq, hkv, d, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                    int sq, int sk, int hq, int hkv, int d, float scale,
                                    int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, hq, hkv, d, scale, causal, window,
                                 stream);
}
