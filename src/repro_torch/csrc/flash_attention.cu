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
// o = acc / max(l, 1e-30) at the end.  Keys past Sk score -inf.
//
// What bounds it on the card: at the serving shape (B 4, Sq = Sk = 512,
// Hq 28, Hkv 4, D = 128) the bf16 tensor-core work, 4 * D flops per visible
// (query, key) pair (7.5 GFLOP, 7.6 us at 989 TFLOP/s), and the bytes (q,
// k, v, o once each: 33.6 MB, 10.0 us at 3.35 TB/s) are of one size, so a
// kernel near its bound keeps both the tensor cores and the loads busy.
// Two kernels, one per input type:
//
// bf16 (flash_attention_bf16): flash_fwd_bf16_wgmma, on the tensor cores.
//   * One block per (batch * query head, 64-query block): one consumer
//     warpgroup and one producer warp, two blocks per SM.  Blocks are
//     numbered so that the last query blocks, whose causal range is the
//     longest, start first.
//   * The producer warp's lane 0 loads the block's Q tile once and K and V
//     tiles of 64 keys into a two-stage ring by TMA, in the 128-byte
//     swizzle the wgmma descriptors expect.  The tensor maps are 4-D,
//     (D, H, S, B), with boxes of 64 columns of one head, so a read past a
//     head's D columns or past a batch's S rows fills zeros: a tile is
//     ceil(D / 64) atoms of 64 columns, and at D = 80 the second atom holds
//     columns 64-79 and 48 zero columns (never the next head's).  Each load
//     completes on an mbarrier; the consumers free a stage on another.
//   * S = Q K^T is wgmma m64n64k16 with both operands in shared memory,
//     D / 16 steps of 16 (5 at D = 80: the zero columns are not read),
//     accumulated in f32 registers.  The row max and sum of the online
//     softmax run on those registers (a row's 64 scores lie in 4 lanes).
//   * O += P V is wgmma m64n64k16 with P from registers and V read in its
//     (key, D) layout through the transpose bit.  Rounding P to bf16 would
//     move ~10% of the outputs by more than one bf16 ulp from the f32
//     plain version, so each probability is split into bf16 p_hi + p_lo
//     (p_hi = bf16(p), p_lo = bf16(p - p_hi), rounded by integer adds and
//     byte permutes rather than by conversions) and both products go into
//     the same f32 accumulator: P is kept to 2^-18 of itself at 3/2 the
//     flops.  exp2 is one ex2.approx instruction.
//   * The row rescale acc *= exp(m_old - m_new) runs in registers between
//     the two products, as in the Pallas body.
//   * At D = 80 the body is D = 128's: P V runs over both 64-column atoms
//     of V (its zero columns give zero outputs), and the store writes
//     only the D columns of the head.
//   * Each tile runs S, softmax, P V in order; the two blocks on an SM
//     overlap one another's phases.  On the H100, two 64-row warpgroups per
//     block sharing the ring, a third stage, and issuing tile n's Q K^T
//     before tile n-1's P V (so the softmax runs under the product) were
//     each slower (PERF.md).
// f32 (flash_attention_f32): flash_fwd_kernel, SIMT f32 FMAs.  The tensor
//   cores' f32 path is TF32, which would break the f32 result's 1e-5
//   agreement; at the serving shape it beats SDPA's f32 run (PERF.md).
//   * one block of 128 threads per (batch * query head, 64-query block);
//     the four warps own 16 query rows each;
//   * K and V tiles of 64 keys staged in shared memory (rows padded by 4
//     bytes, so the column reads below hit 32 distinct banks); the Q tile
//     too, read once per key tile;
//   * each thread computes a 4-row x 8-key block of scores, row max and row
//     sum over the 8 threads of a row group by shuffles, and keeps a 4-row x
//     D/8 block of the output accumulator in registers; the probabilities
//     reach the P.V product by shuffles.
//
// Both kernels index the KV head for GQA (the repeat is never
// materialised) and skip the key tiles that the causal or window mask hides
// from every row of the block.  Skipping cannot change a row's result: each
// row has an unmasked key inside the visited range, and a tile masked for a
// row contributes exp(-1e30 - m) = 0 after that key (before it, its weight
// is multiplied by exp(-1e30 - m_new) = 0 when the key arrives).  Only the
// tiles that straddle the diagonal, the window's edge or Sk are masked.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// SIMT kernel (f32)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows

// Row pitch of a staged tile, in floats: D plus one.
template <int D>
__host__ __device__ constexpr int pitch() { return D + 1; }

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBQ + 2 * kBK) * pitch<D>() * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq, int sk, int hq,
                 int hkv, float scale, int causal, int window) {
  constexpr int P = pitch<D>();
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBQ * P;
  float* vs = ks + kBK * P;

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int q_offset = sk - sq;
  const int64_t q_stride = static_cast<int64_t>(hq) * D;   // between positions
  const int64_t kv_stride = static_cast<int64_t>(hkv) * D;
  const float* qb = q + static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * D;
  const float* kb = k + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * D;
  const float* vb = v + static_cast<int64_t>(b) * sk * kv_stride + static_cast<int64_t>(hk) * D;
  float* ob = o + static_cast<int64_t>(b) * sq * q_stride + static_cast<int64_t>(h) * D;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int row0 = warp * 16 + rg * 4;  // this thread's 4 rows: row0 .. row0 + 3

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qs[r * P + c] = (q0 + r < sq) ? qb[static_cast<int64_t>(q0 + r) * q_stride + c] : 0.f;
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
      ks[r * P + c] = in ? kb[off] : 0.f;
      vs[r * P + c] = in ? vb[off] : 0.f;
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
      for (int i = 0; i < 4; ++i) qv[i] = qs[(row0 + i) * P + dd];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(cg + 8 * j) * P + dd];
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
          const float vv = vs[kk * P + cg + 8 * j];
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
    float* orow = ob + static_cast<int64_t>(qi) * q_stride;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[cg + 8 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int hq,
           int hkv, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // The opt-in above 48 KB of shared memory, on the current device.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, hq, hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk, int hq,
             int hkv, int d, float scale, int causal, int window, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  if (d == 80) return launch<80>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  if (d == 128) return launch<128>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16): TMA ring, wgmma, one producer warp
// ---------------------------------------------------------------------------

constexpr int kTQ = 64;                 // queries per block: one consumer warpgroup
constexpr int kTK = 64;                 // keys per tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kTcThreads = 128 + 32;    // the warpgroup and the producer warp
constexpr int kRowBytes = 128;          // one swizzle row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of the tensor-core kernel, in bytes from a
// 1024-aligned base.  Each tile is stored as ceil(D/64) "atoms" of [rows][64]
// bf16, 128 bytes per row, swizzled by TMA's 128-byte pattern; columns past
// D in the last atom hold zeros (the TMA box reads past the head's edge).
template <int D>
struct TcLayout {
  static_assert(D % 16 == 0, "Q K^T steps over D in slices of 16");
  static constexpr int kAtoms = (D + 63) / 64;
  static constexpr int kQBytes = kTQ * kAtoms * kRowBytes;     // full boxes, zeros included
  static constexpr int kKVBytes = kTK * kAtoms * kRowBytes;    // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBar + 128 + 1024;  // barriers, alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.  A
// phase still open after ~2^34 cycles (seconds) is a fault of the pipeline:
// the kernel traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

// One box of a 4-D (D, H, S, B) map at column c0 of head c1, row c2, batch c3.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (between 64-element atoms along M or N; read
// only for MN-major operands wider than one atom), stride byte offset
// (between groups of 8 rows: 1024), layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WG_D32_STR                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) = A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major), plus d when scale_d != 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) . B (16 x 64, shared,
// MN-major: the transpose bit reads V as it lies, key-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x on the special-function unit, one instruction (relative error
// ~2^-22; results below 2^-126 flush to 0, which no output can see).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The bits of x with bf16(x), rounded to nearest (ties away from zero), in
// the top 16: integer work, not a conversion.
__device__ __forceinline__ uint32_t bf16_round_bits(float x) {
  return __float_as_uint(x) + 0x8000u;
}

// p = p_hi + p_lo + e with p_hi = bf16(p), p_lo = bf16(p - p_hi), both
// rounded to nearest, |e| <= 2^-18 |p|; a and b are two neighbouring
// columns, packed as bf16x2 A-fragment registers (a in the low half).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t ha = bf16_round_bits(a), hb = bf16_round_bits(b);
  hi = __byte_perm(ha, hb, 0x7632);
  const float la = a - __uint_as_float(ha & 0xFFFF0000u);  // exact in f32
  const float lb = b - __uint_as_float(hb & 0xFFFF0000u);
  lo = __byte_perm(bf16_round_bits(la), bf16_round_bits(lb), 0x7632);
}

// Register layout of a 64 x N f32 accumulator in a warpgroup (PTX ISA,
// wgmma D fragment): warp w of the group holds rows 16 w + g and 16 w + g + 8
// (g = lane / 4); register 4 j + 2 h + e holds row 16 w + g + 8 h, column
// 8 j + 2 (lane % 4) + e.  The A fragment of a 64 x 16 slice has the same
// layout, so P's columns 16 kk .. 16 kk + 15 are registers 8 kk .. 8 kk + 7.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                     int sq, int sk, int hq, int hkv, float scale_log2, int causal, int window) {
  using L = TcLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024
  const uint32_t q_s = base + L::kQ;
  const uint32_t bar = base + L::kBar;
  // Barriers, 8 bytes each: Q full; K full, V full and stage empty per stage.
  auto q_full = [&]() { return bar; };
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto v_full = [&](int st) { return bar + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bar + 8 * (1 + 2 * kStages + st); };
  auto k_s = [&](int st) { return base + L::kK + st * L::kKVBytes; };
  auto v_s = [&](int st) { return base + L::kV + st * L::kKVBytes; };

  // Longest first: block n takes query block nqb - 1 - n / (B * Hq).
  const int nqb = (sq + kTQ - 1) / kTQ;
  const int n_bh = gridDim.x / nqb;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = qb * kTQ;
  const int q_offset = sk - sq;

  // The key tiles some row of this block can see.
  const int last_q = min(q0 + kTQ, sq) - 1;
  const int n_tiles = (sk + kTK - 1) / kTK;
  int kt_hi = n_tiles;
  if (causal) kt_hi = min(n_tiles, (last_q + q_offset) / kTK + 1);
  int kt_lo = 0;
  if (window > 0) {
    const int first_col = q0 + q_offset - window + 1;
    if (first_col > 0) kt_lo = first_col / kTK;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: one lane issues every load ----
    if (lane == 0) {
      mbar_expect_tx(q_full(), L::kQBytes);
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load_4d(q_s + a * kTQ * kRowBytes, &q_map, q_full(), a * 64, h, q0, b);
      for (int kt = kt_lo, n = 0; kt < kt_hi; ++kt, ++n) {
        const int st = n % kStages, round = n / kStages;
        if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
        mbar_expect_tx(k_full(st), L::kKVBytes);
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load_4d(k_s(st) + a * kTK * kRowBytes, &k_map, k_full(st), a * 64, hk,
                      kt * kTK, b);
        mbar_expect_tx(v_full(st), L::kKVBytes);
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load_4d(v_s(st) + a * kTK * kRowBytes, &v_map, v_full(st), a * 64, hk,
                      kt * kTK, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: query rows q0 .. q0 + 63 ----
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 16 * warp + g;  // and row0 + 8
  const int q_hi = min(q0 + kTQ - 1, sq - 1);

  float acc[L::kAtoms][32];  // O, 64 x 64 kAtoms: atom c holds columns 64 c .. 64 c + 63
  float m_run[2] = {kNegInf, kNegInf}, l_part[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < L::kAtoms; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t p_hi[4][4], p_lo[4][4];

  mbar_wait(q_full(), 0);
  __syncwarp();

  for (int kt = kt_lo, n = 0; kt < kt_hi; ++kt, ++n) {
    const int st = n % kStages, phase = (n / kStages) & 1;
    const int k0 = kt * kTK;
    mbar_wait(k_full(st), phase);
    __syncwarp();
    // S = Q K^T over D / 16 slices of 16 (the zero columns past D skipped).
    wgmma_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qa = q_s + (kk / 4) * kTQ * kRowBytes + (kk % 4) * 32;
      const uint32_t ka = k_s(st) + (kk / 4) * kTK * kRowBytes + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(qa, 16), sw128_desc(ka, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scale into the log2 domain and mask the tiles that need it.
    const bool need_mask = k0 + kTK > sk || (causal && k0 + kTK - 1 > q0 + q_offset) ||
                           (window > 0 && k0 <= q_hi + q_offset - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // register i: row half (i / 2) % 2, column 8 (i / 4) + 2 t + i % 2
      float x = s[i] * scale_log2;
      if (need_mask) {
        const int col = k0 + 8 * (i / 4) + 2 * t + i % 2;
        const int qpos = row0 + 8 * ((i / 2) % 2) + q_offset;
        if (col >= sk) {
          x = -INFINITY;  // past the end of the keys: no weight at all
        } else if ((causal && col > qpos) || (window > 0 && col <= qpos - window)) {
          x = kNegInf;
        }
      }
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      alpha[hh] = ex2(m_run[hh] - m_new);
      m_run[hh] = m_new;
      l_part[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(s[i] - m_run[(i / 2) % 2]);
      l_part[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int c = 0; c < L::kAtoms; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i / 2) % 2];
    // P, split into bf16 p_hi + p_lo as A fragments of the four 16-key slices.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        split_bf16x2(s[i], s[i + 1], p_hi[kk][r], p_lo[kk][r]);
      }

    // O += P_hi V + P_lo V, one 64-column atom of V at a time.
    mbar_wait(v_full(st), phase);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < L::kAtoms; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < L::kAtoms; ++c) {
        const uint64_t vd =
            sw128_desc(v_s(st) + c * kTK * kRowBytes + kk * 16 * kRowBytes, kTK * kRowBytes);
        wgmma_rs(acc[c], p_hi[kk], vd);
        wgmma_rs(acc[c], p_lo[kk], vd);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < L::kAtoms; ++c) fence_regs(acc[c]);
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
  }

  // o = acc / max(l, 1e-30), one bf16 cast; lanes 4g .. 4g + 3 share a row;
  // only the head's D columns are stored (8 j + 2 t < 16 at D = 80's edge).
  const int64_t q_stride = static_cast<int64_t>(hq) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_part[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = row0 + 8 * hh;
    if (row >= sq) continue;
    __nv_bfloat16* orow = o + (static_cast<int64_t>(b) * sq + row) * q_stride +
                          static_cast<int64_t>(h) * D;
#pragma unroll
    for (int c = 0; c < L::kAtoms; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (64 * c + 8 * j >= D) break;  // compile-time: past the head's columns
        const int col = 64 * c + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[c][4 * j + 2 * hh] * inv, acc[c][4 * j + 2 * hh + 1] * inv);
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a (batch, rows, heads, d) bf16 tensor, innermost first
// (d, heads, rows, batch), boxes of 64 columns x 1 head x box_rows rows x 1
// batch, 128-byte swizzle; reads past a head's d columns or past the rows
// fill zeros.  The strides (2 d bytes between heads: 160 at d = 80) are
// multiples of 16, as TMA needs.
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int d,
                int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(d) * heads * 2,
                                 static_cast<cuuint64_t>(d) * heads * rows * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                 int hq, int hkv, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int smem = TcLayout<D>::kBytes;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, b, sq, hq, D, kTQ) || !encode_map(&k_map, k, b, sk, hkv, D, kTK) ||
      !encode_map(&v_map, v, b, sk, hkv, D, kTK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (sq + kTQ - 1) / kTQ * b * hq;
  flash_fwd_bf16_wgmma<D><<<blocks, kTcThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), sq, sk, hq, hkv, scale * kLog2e,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  q (b, sq, hq, d), k and v
// (b, sk, hkv, d), o like q, all contiguous on the current device; d is 64,
// 80 or 128, hq a multiple of hkv, sq <= sk; the bf16 entry also needs q, k
// and v 16-byte aligned (TMA).  Returns the cudaGetLastError() code right
// after the launch (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int sk, int hq, int hkv, int d, float scale,
                                   int causal, int window, void* stream) {
  return dispatch(q, k, v, o, b, sq, sk, hq, hkv, d, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                    int sq, int sk, int hq, int hkv, int d, float scale,
                                    int causal, int window, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_wgmma<64>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  if (d == 80) return launch_wgmma<80>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  if (d == 128)
    return launch_wgmma<128>(q, k, v, o, b, sq, sk, hq, hkv, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of the bf16 entry's launch at head dim d, in bytes.
extern "C" int flash_attention_bf16_smem_bytes(int d) {
  return d == 64 ? TcLayout<64>::kBytes
         : d == 80 ? TcLayout<80>::kBytes
         : d == 128 ? TcLayout<128>::kBytes
                    : 0;
}
