// Algorithm 1 (polyblock outer approximation, paper eqs. 21-29) on Hopper.
//
// Four kernels that share the arithmetic of one projection:
//
//   K2  project_coop_kernel replaces the JAX package's Pallas kernel
//       kernels/polyblock_project/kernel.py::_project_kernel: for each
//       vertex v = (tau, p), zeta from 60 halvings of (TINY, 1] on
//       g(zeta tau, zeta p) = 0 (eq. 22), zeta = 1 when v is already
//       feasible; writes zeta * v.  L = 4, 8 or 16 lanes of a warp own one
//       vertex (32 / L vertices per warp) and run K1's speculative
//       bisection (coop_project, below), so a vertex's 60 halvings are
//       1 + ceil(60 / log2 L) dependent evaluations of g deep, not 61.
//
//   K2, one lane per vertex: project_kernel, the 60 halvings in sequence
//       on one thread.  It is the reference schedule the cooperative one
//       is held bitwise equal to (lanes = 1 at the C entry).  The wrapper
//       picks the lanes from the vertex count (polyblock_project.ops.
//       project_lanes): 16 where the batch leaves the card idle and one
//       vertex's chain is the kernel's time (the step driver's few hundred
//       vertices per call), fewer where the batch fills the card and
//       speculation's extra evaluations cost issue slots.
//
//   K1  solve_coop_kernel replaces kernels/polyblock_fused/kernel.py::
//       _solve_kernel: all of Algorithm 1 for one feasible (beta, |h|^2,
//       E^max) pair — vertex store, first-max selection, eq.-26
//       retirement, eq.-23 children, two projections, eq.-24 store writes —
//       looping until the pair retires or hits max_iter.  Returns tau*, p*,
//       T*, iterations.  2L lanes of a warp own one pair (L = 4, 8 or 16
//       lanes per child: 4, 2 or 1 pairs per warp).
//
//   K1, one lane per pair: solve_kernel, the same solve with one thread per
//       pair and the store in global scratch.  It is the reference schedule
//       the cooperative one is held bitwise equal to (lanes = 1 at the C
//       entry).
//
// What bounds them on the card.  One evaluation of g is a log1p, two IEEE
// divisions and ~12 more operations in float64 (the op counts of the JAX
// package's launch/analytic.py: g_eval_ops, projection_ops), and a
// projection runs 61 of them while a pair moves 3 values in and 4 out, so
// the operation count, not memory, is the roof in principle.  In practice
// K1 is bound by neither: the whole main-path batch is ~4 x 10^5
// evaluations (microseconds of the card's FP64 rate), but one pair's solve
// is a serial chain — 1 + 2 * iterations projections of 61 dependent
// evaluations each, ~760 cycles per evaluation — and the slowest pair's
// chain sets the kernel's time.  The cooperative schedule shortens that
// chain:
//   * speculative bisection: the L lanes of a child evaluate at once the
//     midpoints of the next d = log2 L levels of the bisection tree (node r
//     of the heap, r = 1 .. L - 1, on lane r).  Each lane reaches its
//     node's (lo, hi) by applying mid = 0.5 * (lo + hi) along its own path —
//     the operations the sequential loop applies — so its sign is the one
//     the sequential loop would compute there; one __ballot_sync gathers the
//     signs and every lane walks the d levels to the taken node.  60
//     halvings take ceil(60 / d) dependent evaluations, not 60 (15 at
//     L = 16), bit for bit the same (lo, hi); and once a halving no longer
//     moves an end of the bracket (float precision reached), the rounds
//     left could change nothing and evaluate nothing;
//   * the two children of an iteration (eq. 23) are projected at the same
//     time, each on half of the pair's lanes, so a solve of I iterations
//     is 1 + I projections deep, not 1 + 2I;
//   * the vertex store (max_iter + 1 slots x 4 values — vertex tau, p, its
//     zeta and f — 2.1 KB per pair in float64) lives in shared memory, laid
//     out [field][slot] per pair, and selection is an arg-max over the
//     pair's lanes (strided scan, then a butterfly keeping the larger value
//     and on a tie the lower slot: the serial scan's first max);
//   * a projection whose vertex is already feasible skips its halvings
//     (zeta = 1).
// Where the batch fills the card (~10^5 pairs) the cost is no longer one
// chain but the warps' issue slots: speculation costs 2^d - 1 evaluations
// per d levels (1.5x, 2.3x and 3.75x the sequential work at L = 4, 8, 16),
// and a warp's lanes idle while it waits for its slowest pair.  So the
// grid holds only as many blocks as are resident at once, and a pair group
// whose pair retires claims the next unsolved pair from a counter; the
// wrapper picks L from the pair count.  A store that does not fit in
// shared memory (max_iter too large for the lanes chosen;
// polyblock_solve_max_iter) is refused at the entry.
//
// Replication contract: the arithmetic is spelled exactly as the Pallas
// kernels and the JAX package's wireless.total_energy / total_time spell
// it — folded kappa0 * mu, x * x for squares, division by LN2, the 1e-30
// floors, mid = 0.5 * (lo + hi), the g > 0 branch sense — and the library
// is built with --fmad=false so no multiply-add is contracted.  Selection
// takes the first max over the slots in ascending order (strict >), which
// is the Pallas kernel's min-index first-max rule.  Every schedule gives
// the same bits; what can still differ from the CPU is the last ulp of
// log1p.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr double kLn2 = 0.69314718055994530942;
constexpr double kTiny = 1e-12;
constexpr int kFields = 5;  // store fields: vertex tau, p; projection tau, p; f
enum { kVT = 0, kVP = 1, kPT = 2, kPP = 3, kF = 4 };

template <typename T>
struct Phys {
  T kappa0_mu, mu_cycles, cpu_hz, pt_w, model_bits, bandwidth_hz;
};

__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }
__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }

// eq. (10): E^cp + p P_t T^cm, spelled as wireless.total_energy.
template <typename T>
__device__ __forceinline__ T energy(T tau, T p, T beta, T h2, const Phys<T>& c) {
  const T tc = tau * c.cpu_hz;
  const T e_cp = c.kappa0_mu * beta * (tc * tc);
  const T rate = c.bandwidth_hz * log1p_t(p * h2) / static_cast<T>(kLn2);
  const T t_cm = c.model_bits / max_t(rate, static_cast<T>(1e-30));
  return e_cp + p * c.pt_w * t_cm;
}

// -T of eq. (8), spelled as wireless.total_time (f of eq. 21).
template <typename T>
__device__ __forceinline__ T neg_time(T tau, T p, T beta, T h2, const Phys<T>& c) {
  const T t_cp = c.mu_cycles * beta / max_t(tau, static_cast<T>(1e-30)) / c.cpu_hz;
  const T rate = c.bandwidth_hz * log1p_t(p * h2) / static_cast<T>(kLn2);
  const T t_cm = c.model_bits / max_t(rate, static_cast<T>(1e-30));
  return -(t_cp + t_cm);
}

// eqs. (27-29): the bisection of project_jnp / _project_kernel.
template <typename T>
__device__ __forceinline__ void project(T tau_v, T p_v, T beta, T h2, T e_max,
                                        int n_bisect, const Phys<T>& c,
                                        T& out_tau, T& out_p) {
  T zeta = static_cast<T>(1);
  if (energy(tau_v, p_v, beta, h2, c) - e_max > static_cast<T>(0)) {
    T lo = static_cast<T>(kTiny);
    T hi = static_cast<T>(1);
    for (int i = 0; i < n_bisect; ++i) {
      const T mid = static_cast<T>(0.5) * (lo + hi);
      if (energy(mid * tau_v, mid * p_v, beta, h2, c) - e_max > static_cast<T>(0)) {
        hi = mid;
      } else {
        lo = mid;
      }
    }
    zeta = lo;
  }
  out_tau = zeta * tau_v;
  out_p = zeta * p_v;
}

template <typename T>
__global__ void project_kernel(const T* __restrict__ v, const T* __restrict__ beta,
                               const T* __restrict__ h2, const T* __restrict__ e_max,
                               T* __restrict__ out, int64_t n, int n_bisect, Phys<T> c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T o_tau, o_p;
  project(v[2 * i], v[2 * i + 1], beta[i], h2[i], e_max[i], n_bisect, c, o_tau, o_p);
  out[2 * i] = o_tau;
  out[2 * i + 1] = o_p;
}

template <typename T>
__global__ void solve_kernel(const T* __restrict__ beta_in, const T* __restrict__ h2_in,
                             const T* __restrict__ emax_in, T* __restrict__ tau_out,
                             T* __restrict__ p_out, T* __restrict__ time_out,
                             int32_t* __restrict__ iters_out, T* __restrict__ store,
                             int64_t n, T eps, int max_iter, int n_bisect, Phys<T> c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T beta = beta_in[i];
  const T h2 = h2_in[i];
  const T e_max = emax_in[i];
  // store[(slot * 5 + field) * n + i]
  auto at = [&](int slot, int field) -> T& {
    return store[(static_cast<int64_t>(slot) * kFields + field) * n + i];
  };

  T pj0_tau, pj0_p;
  project(static_cast<T>(1), static_cast<T>(1), beta, h2, e_max, n_bisect, c, pj0_tau, pj0_p);
  const T f0 = neg_time(pj0_tau, pj0_p, beta, h2, c);
  at(0, kVT) = static_cast<T>(1);
  at(0, kVP) = static_cast<T>(1);
  at(0, kPT) = pj0_tau;
  at(0, kPP) = pj0_p;
  at(0, kF) = f0;

  T prev_best = static_cast<T>(INFINITY);
  T best_f = f0, best_tau = pj0_tau, best_p = pj0_p;
  int iters = 0;
  int nvalid = 1;
  for (int t = 0; t < max_iter; ++t) {
    // Selection (paper steps 9-10): first max over the written slots.
    int idx = 0;
    T fbest = at(0, kF);
    for (int s = 1; s < nvalid; ++s) {
      const T f = at(s, kF);
      if (f > fbest) {
        fbest = f;
        idx = s;
      }
    }
    const T sel_ptau = at(idx, kPT);
    const T sel_pp = at(idx, kPP);
    if (fbest > best_f) {
      best_f = fbest;
      best_tau = sel_ptau;
      best_p = sel_pp;
    }
    const bool done = abs_t(fbest - prev_best) <= eps;  // eq. (26)
    prev_best = fbest;
    if (done) break;
    iters += 1;

    // Children (eq. 23): split the chosen vertex at its projection.
    const T v_tau = at(idx, kVT);
    const T v_p = at(idx, kVP);
    T c1_tau, c1_p, c2_tau, c2_p;
    project(sel_ptau, v_p, beta, h2, e_max, n_bisect, c, c1_tau, c1_p);
    project(v_tau, sel_pp, beta, h2, e_max, n_bisect, c, c2_tau, c2_p);
    const T f1 = neg_time(c1_tau, c1_p, beta, h2, c);
    const T f2 = neg_time(c2_tau, c2_p, beta, h2, c);

    // eq. (24): child1 replaces the split slot, child2 takes the next one.
    at(idx, kVT) = sel_ptau;
    at(idx, kVP) = v_p;
    at(idx, kPT) = c1_tau;
    at(idx, kPP) = c1_p;
    at(idx, kF) = f1;
    at(nvalid, kVT) = v_tau;
    at(nvalid, kVP) = sel_pp;
    at(nvalid, kPT) = c2_tau;
    at(nvalid, kPP) = c2_p;
    at(nvalid, kF) = f2;
    nvalid += 1;
  }
  tau_out[i] = best_tau;
  p_out[i] = best_p;
  time_out[i] = -best_f;
  iters_out[i] = iters;
}

// ---------------------------------------------------------------------------
// K1, cooperative schedule
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCoopWarps = 4;               // warps per block, fewer if the store needs
constexpr int kSmemLimit = 232448;          // shared memory a block may opt in to (227 KB)
constexpr int kCoopFields = 4;              // store fields: vertex tau, p; zeta; f

// zeta and zeta * v for the vertex (tau_v, p_v) of this lane's child (K1)
// or vertex (K2), on its L = 2^D lanes (r = lane within them, child_base =
// the first of them in the warp): the speculative bisection of the note at the
// top, bit for bit project().  A bracket whose halving no longer moves an
// end is settled, and its remaining rounds evaluate nothing (after ~24
// halvings in float32, ~53 in float64): at mid == lo no later halving
// changes lo, and at mid == hi neither, since g > 0 at every hi (1 when the
// vertex needs its root, else a midpoint whose g was > 0).  The rounds
// still run (a ballot and a branch each), which costs less than a vote
// per round to leave early.  Every lane of the warp must call it
// (ballots); `live` false evaluates nothing and returns zeta = 1.
template <typename T, int D>
__device__ __forceinline__ void coop_project(T tau_v, T p_v, T beta, T h2, T e_max, bool live,
                                             int n_bisect, int r, int child_base,
                                             const Phys<T>& c, T& out_tau, T& out_p,
                                             T& out_zeta) {
  constexpr unsigned kGroup = (1u << (1 << D)) - 1u;
  const bool need = live && energy(tau_v, p_v, beta, h2, c) - e_max > static_cast<T>(0);
  T lo = static_cast<T>(kTiny);
  T hi = static_cast<T>(1);
  if (__any_sync(kFull, need)) {
    T mid0 = static_cast<T>(0.5) * (lo + hi);   // the round's first midpoint
    bool go = need;
    for (int done = 0; done < n_bisect; done += D) {
      go = go && mid0 != lo && mid0 != hi;          // not settled yet
      const int levels = min(D, n_bisect - done);   // the last round may be partial
      bool take_hi = false;
      if (go && r > 0 && r < (1 << levels)) {
        // Node r of the heap: its path from the root is r's bits below the
        // leading one, 1 = the g > 0 branch (hi = mid).
        T l = lo, h = hi, mid = mid0;
        for (int b = 30 - __clz(r); b >= 0; --b) {
          if ((r >> b) & 1) {
            h = mid;
          } else {
            l = mid;
          }
          mid = static_cast<T>(0.5) * (l + h);
        }
        take_hi = energy(mid * tau_v, mid * p_v, beta, h2, c) - e_max > static_cast<T>(0);
      }
      const unsigned signs = (__ballot_sync(kFull, take_hi) >> child_base) & kGroup;
      if (go) {
        int node = 1;
        for (int b = 0; b < levels; ++b) {
          const int s = (signs >> node) & 1;
          if (s) {
            hi = mid0;
          } else {
            lo = mid0;
          }
          node = 2 * node + s;
          mid0 = static_cast<T>(0.5) * (lo + hi);
        }
      }
    }
  }
  out_zeta = need ? lo : static_cast<T>(1);
  out_tau = out_zeta * tau_v;
  out_p = out_zeta * p_v;
}

// The first max of f[0, nvalid) over a pair's G lanes (g = lane within the
// pair): each lane scans slots g, g + G, ... in ascending order with a
// strict >, then a butterfly keeps the larger value and, on equal values,
// the lower slot — the serial scan's lowest-index first max, on every lane.
// A lane with no slot holds (-inf, INT_MAX) and loses every tie.  The
// store's values are finite or -inf.
template <typename T, int G>
__device__ __forceinline__ void group_first_max(const T* f, int nvalid, int g, T& fbest,
                                                int& idx) {
  T bf = -static_cast<T>(INFINITY);
  int bi = INT_MAX;
  for (int s = g; s < nvalid; s += G) {
    const T v = f[s];
    if (bi == INT_MAX || v > bf) {
      bf = v;
      bi = s;
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const T of = __shfl_xor_sync(kFull, bf, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (of > bf || (of == bf && oi < bi)) {
      bf = of;
      bi = oi;
    }
  }
  fbest = bf;
  idx = bi;
}

// All of Algorithm 1 on 2L lanes per pair (L = 2^D lanes per child), a
// pair group per 2L lanes of the block, each group working through pairs
// until none are left: its first pair is its own index, the next ones come
// from `next_pair` (zeroed by the launcher; atomically claimed), so a group
// whose pair retires early takes a new one while the other groups of its
// warp go on — the warp's lanes stay busy, and one pair's serial chain
// never waits on another's.  Group q of the block keeps its store at
// smem[q * 4 * (max_iter + 1) ...]: fields vertex tau, vertex p, zeta (the
// projection is zeta * vertex, the bits project() returns) and f, of
// max_iter + 1 slots each.
template <typename T, int D>
__global__ void __launch_bounds__(kCoopWarps * 32)
    solve_coop_kernel(const T* __restrict__ beta_in, const T* __restrict__ h2_in,
                      const T* __restrict__ emax_in, T* __restrict__ tau_out,
                      T* __restrict__ p_out, T* __restrict__ time_out,
                      int32_t* __restrict__ iters_out, unsigned long long* next_pair,
                      int64_t n, T eps, int max_iter, int n_bisect, Phys<T> c) {
  constexpr int L = 1 << D;   // lanes per child
  constexpr int G = 2 * L;    // lanes per pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int g = lane % G;
  const int child = g / L;    // 0: child 1 of eq. 23, 1: child 2
  const int r = g % L;
  const int child_base = lane - r;
  const int group_base = lane - g;
  const int q = threadIdx.x / G;
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (blockDim.x / G);
  const int m = max_iter + 1;
  T* const s_vt = reinterpret_cast<T*>(smem_raw) + static_cast<int64_t>(q) * kCoopFields * m;
  T* const s_vp = s_vt + m;
  T* const s_z = s_vt + 2 * m;
  T* const s_f = s_vt + 3 * m;
  const T one = static_cast<T>(1);

  int64_t i = static_cast<int64_t>(blockIdx.x) * (blockDim.x / G) + q;
  bool live = i < n;    // the group holds pair i
  bool fresh = true;    // pair i still needs its first projection
  T beta = one, h2 = one, e_max = one;
  if (live) {
    beta = beta_in[i];
    h2 = h2_in[i];
    e_max = emax_in[i];
  }
  T prev_best = static_cast<T>(INFINITY);
  T best_f = 0, best_tau = 0, best_p = 0;
  int iters = 0, nvalid = 1, t = 0;
  while (true) {
    // Selection (paper steps 9-10) for a running pair: first max over the
    // written slots, the incumbent, eq.-26 retirement; a pair also ends
    // after max_iter iterations.
    T fbest;
    int idx;
    const bool running = live && !fresh;
    group_first_max<T, G>(s_f, running ? nvalid : 1, g, fbest, idx);
    idx = running ? idx : 0;   // a fresh group's store is not written yet
    const T sel_z = s_z[idx];
    const T v_tau = s_vt[idx];
    const T v_p = s_vp[idx];
    const T sel_ptau = sel_z * v_tau;
    const T sel_pp = sel_z * v_p;
    bool finish = false;
    if (running) {
      if (t == max_iter) {
        finish = true;
      } else {
        if (fbest > best_f) {
          best_f = fbest;
          best_tau = sel_ptau;
          best_p = sel_pp;
        }
        finish = abs_t(fbest - prev_best) <= eps;  // eq. (26)
        prev_best = fbest;
        iters += !finish;
      }
    }
    // A finished pair's results out; the group claims the next pair.
    unsigned long long claim = 0;
    if (finish && g == 0) {
      tau_out[i] = best_tau;
      p_out[i] = best_p;
      time_out[i] = -best_f;
      iters_out[i] = iters;
      claim = atomicAdd(next_pair, 1ull);
    }
    claim = __shfl_sync(kFull, claim, group_base);
    if (finish) {
      i = groups + static_cast<int64_t>(claim);
      live = i < n;
      fresh = true;
      if (live) {
        beta = beta_in[i];
        h2 = h2_in[i];
        e_max = emax_in[i];
      }
    }
    if (!__any_sync(kFull, live)) break;

    // The vertices to project: (1, 1) on both halves for a fresh pair; the
    // children of eq. 23 for a running one — child 1 is the chosen vertex
    // with tau at its projection, child 2 with p.
    const T ct = fresh ? one : (child == 0 ? sel_ptau : v_tau);
    const T cp = fresh ? one : (child == 0 ? v_p : sel_pp);
    T o_tau, o_p, zeta;
    coop_project<T, D>(ct, cp, beta, h2, e_max, live, n_bisect, r, child_base, c, o_tau, o_p,
                       zeta);
    const T fc = neg_time(o_tau, o_p, beta, h2, c);
    __syncwarp();   // every lane has read slot idx before it is rewritten

    if (live) {
      // A fresh pair's slot 0; for a running one eq. (24): child 1
      // replaces the split slot, child 2 takes the next one.
      const int slot = fresh ? 0 : (child == 0 ? idx : nvalid);
      if (r == 0 && (!fresh || child == 0)) {
        s_vt[slot] = ct;
        s_vp[slot] = cp;
        s_z[slot] = zeta;
        s_f[slot] = fc;
      }
      if (fresh) {
        best_f = fc;
        best_tau = o_tau;
        best_p = o_p;
        prev_best = static_cast<T>(INFINITY);
        iters = 0;
        nvalid = 1;
        t = 0;
        fresh = false;
      } else {
        nvalid += 1;
        t += 1;
      }
    }
    __syncwarp();
  }
}

// Warps per block for the cooperative schedule: up to kCoopWarps, as many
// as the block's stores fit in shared memory (0: not even one warp's).
inline int coop_warps(int lanes, int max_iter, int elem_bytes) {
  const int64_t per_warp = static_cast<int64_t>(32 / (2 * lanes)) * kCoopFields *
                           (static_cast<int64_t>(max_iter) + 1) * elem_bytes;
  return static_cast<int>(std::min<int64_t>(kCoopWarps, kSmemLimit / per_warp));
}

// One launch of the cooperative schedule: as many blocks as are resident on
// the card at once (or fewer, one pair per group, for a small batch).
template <typename T, int D>
int launch_coop(const T* beta, const T* h2, const T* e_max, T* tau, T* p, T* time_s,
                int32_t* iters, void* next_pair, int64_t n, T eps, int max_iter, int n_bisect,
                const Phys<T>& c, cudaStream_t stream) {
  constexpr int L = 1 << D;
  const int warps = coop_warps(L, max_iter, sizeof(T));
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs_per_block = warps * 32 / (2 * L);
  const size_t smem =
      static_cast<size_t>(pairs_per_block) * kCoopFields * (max_iter + 1) * sizeof(T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(solve_coop_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solve_coop_kernel<T, D>,
                                                           warps * 32, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int64_t resident = static_cast<int64_t>(std::max(per_sm, 1)) * sms;
  const int64_t blocks = std::min<int64_t>((n + pairs_per_block - 1) / pairs_per_block, resident);
  err = cudaMemsetAsync(next_pair, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  solve_coop_kernel<T, D><<<static_cast<unsigned int>(blocks), warps * 32, smem, stream>>>(
      beta, h2, e_max, tau, p, time_s, iters, static_cast<unsigned long long*>(next_pair), n,
      eps, max_iter, n_bisect, c);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2, cooperative schedule
// ---------------------------------------------------------------------------

// zeta * v for vertex i on its L = 2^D lanes (lane r of the vertex, lanes
// child_base .. child_base + L - 1 of the warp).  Vertices are independent
// and each costs 0 or n_bisect halvings, so a plain grid of kCoopWarps-warp
// blocks covers them, n * L threads.  coop_project votes over the whole
// warp, so no lane returns early: a lane past the last vertex (the tail
// warp) runs the rounds with live = false and writes nothing.  Lane 0 of
// the vertex writes the result.
template <typename T, int D>
__global__ void __launch_bounds__(kCoopWarps * 32)
    project_coop_kernel(const T* __restrict__ v, const T* __restrict__ beta,
                        const T* __restrict__ h2, const T* __restrict__ e_max,
                        T* __restrict__ out, int64_t n, int n_bisect, Phys<T> c) {
  constexpr int L = 1 << D;
  static_assert(32 % L == 0, "a vertex's lanes must not cross a warp");
  const int lane = threadIdx.x & 31;
  const int r = lane % L;
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / L;
  const bool live = i < n;
  const T one = static_cast<T>(1);
  T tau_v = one, p_v = one, b = one, h = one, e = one;
  if (live) {
    tau_v = v[2 * i];
    p_v = v[2 * i + 1];
    b = beta[i];
    h = h2[i];
    e = e_max[i];
  }
  T o_tau, o_p, zeta;
  coop_project<T, D>(tau_v, p_v, b, h, e, live, n_bisect, r, lane - r, c, o_tau, o_p, zeta);
  if (live && r == 0) {
    out[2 * i] = o_tau;
    out[2 * i + 1] = o_p;
  }
}

constexpr int kBlock = 128;

inline unsigned int grid_for(int64_t n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

template <typename T, int D>
void launch_project_coop(const T* v, const T* beta, const T* h2, const T* e_max, T* out,
                         int64_t n, int n_bisect, const Phys<T>& c, cudaStream_t stream) {
  project_coop_kernel<T, D><<<grid_for(n * (1 << D)), kCoopWarps * 32, 0, stream>>>(
      v, beta, h2, e_max, out, n, n_bisect, c);
}

template <typename T>
int launch_project(const void* v, const void* beta, const void* h2, const void* e_max,
                   void* out, int64_t n, int n_bisect, int lanes, double kappa0_mu,
                   double cpu_hz, double pt_w, double model_bits, double bandwidth_hz,
                   void* stream) {
  const Phys<T> c{static_cast<T>(kappa0_mu), static_cast<T>(0), static_cast<T>(cpu_hz),
                  static_cast<T>(pt_w), static_cast<T>(model_bits),
                  static_cast<T>(bandwidth_hz)};
  if (lanes != 1 && lanes != 4 && lanes != 8 && lanes != 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto vv = static_cast<const T*>(v);
  const auto b = static_cast<const T*>(beta);
  const auto h = static_cast<const T*>(h2);
  const auto e = static_cast<const T*>(e_max);
  const auto o = static_cast<T*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1:
      project_kernel<T><<<grid_for(n), kBlock, 0, s>>>(vv, b, h, e, o, n, n_bisect, c);
      break;
    case 4:
      launch_project_coop<T, 2>(vv, b, h, e, o, n, n_bisect, c, s);
      break;
    case 8:
      launch_project_coop<T, 3>(vv, b, h, e, o, n, n_bisect, c, s);
      break;
    default:
      launch_project_coop<T, 4>(vv, b, h, e, o, n, n_bisect, c, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const void* beta, const void* h2, const void* e_max, void* tau, void* p,
                 void* time_s, void* iters, void* store, int64_t n, double eps,
                 int max_iter, int n_bisect, int lanes, double kappa0_mu, double mu_cycles,
                 double cpu_hz, double pt_w, double model_bits, double bandwidth_hz,
                 void* stream) {
  const Phys<T> c{static_cast<T>(kappa0_mu), static_cast<T>(mu_cycles),
                  static_cast<T>(cpu_hz), static_cast<T>(pt_w),
                  static_cast<T>(model_bits), static_cast<T>(bandwidth_hz)};
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto b = static_cast<const T*>(beta);
  const auto h = static_cast<const T*>(h2);
  const auto e = static_cast<const T*>(e_max);
  const auto o_tau = static_cast<T*>(tau);
  const auto o_p = static_cast<T*>(p);
  const auto o_t = static_cast<T*>(time_s);
  const auto o_it = static_cast<int32_t*>(iters);
  const auto s = static_cast<cudaStream_t>(stream);
  const T e_ps = static_cast<T>(eps);
  switch (lanes) {
    case 1:
      solve_kernel<T><<<grid_for(n), kBlock, 0, s>>>(b, h, e, o_tau, o_p, o_t, o_it,
                                                      static_cast<T*>(store), n, e_ps,
                                                      max_iter, n_bisect, c);
      return static_cast<int>(cudaGetLastError());
    case 4:
      return launch_coop<T, 2>(b, h, e, o_tau, o_p, o_t, o_it, store, n, e_ps, max_iter,
                               n_bisect, c, s);
    case 8:
      return launch_coop<T, 3>(b, h, e, o_tau, o_p, o_t, o_it, store, n, e_ps, max_iter,
                               n_bisect, c, s);
    case 16:
      return launch_coop<T, 4>(b, h, e, o_tau, o_p, o_t, o_it, store, n, e_ps, max_iter,
                               n_bisect, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every function returns the
// cudaGetLastError() code right after its launch (0 = launched).
extern "C" {

// lanes = 1: project_kernel, one thread per vertex.  lanes = 4, 8 or 16:
// project_coop_kernel with that many lanes per vertex.  Any other lanes is
// refused.
int polyblock_project_f64(const void* v, const void* beta, const void* h2,
                          const void* e_max, void* out, int64_t n, int n_bisect, int lanes,
                          double kappa0_mu, double cpu_hz, double pt_w,
                          double model_bits, double bandwidth_hz, void* stream) {
  return launch_project<double>(v, beta, h2, e_max, out, n, n_bisect, lanes, kappa0_mu,
                                cpu_hz, pt_w, model_bits, bandwidth_hz, stream);
}

int polyblock_project_f32(const void* v, const void* beta, const void* h2,
                          const void* e_max, void* out, int64_t n, int n_bisect, int lanes,
                          double kappa0_mu, double cpu_hz, double pt_w,
                          double model_bits, double bandwidth_hz, void* stream) {
  return launch_project<float>(v, beta, h2, e_max, out, n, n_bisect, lanes, kappa0_mu,
                               cpu_hz, pt_w, model_bits, bandwidth_hz, stream);
}

// lanes = 1: solve_kernel, one thread per pair, `store` a global scratch of
// (max_iter + 1) * 5 * n values.  lanes = 4, 8 or 16: solve_coop_kernel with
// that many lanes per child, `store` 8 bytes of scratch (the pair counter,
// zeroed here); max_iter must be at most polyblock_solve_max_iter(lanes,
// sizeof(T)).  Any other lanes is refused.
int polyblock_solve_f64(const void* beta, const void* h2, const void* e_max, void* tau,
                        void* p, void* time_s, void* iters, void* store, int64_t n,
                        double eps, int max_iter, int n_bisect, int lanes, double kappa0_mu,
                        double mu_cycles, double cpu_hz, double pt_w, double model_bits,
                        double bandwidth_hz, void* stream) {
  return launch_solve<double>(beta, h2, e_max, tau, p, time_s, iters, store, n, eps,
                              max_iter, n_bisect, lanes, kappa0_mu, mu_cycles, cpu_hz, pt_w,
                              model_bits, bandwidth_hz, stream);
}

int polyblock_solve_f32(const void* beta, const void* h2, const void* e_max, void* tau,
                        void* p, void* time_s, void* iters, void* store, int64_t n,
                        double eps, int max_iter, int n_bisect, int lanes, double kappa0_mu,
                        double mu_cycles, double cpu_hz, double pt_w, double model_bits,
                        double bandwidth_hz, void* stream) {
  return launch_solve<float>(beta, h2, e_max, tau, p, time_s, iters, store, n, eps,
                             max_iter, n_bisect, lanes, kappa0_mu, mu_cycles, cpu_hz, pt_w,
                             model_bits, bandwidth_hz, stream);
}

// The largest max_iter whose vertex store fits the shared memory of a block
// of the cooperative schedule with `lanes` lanes per child, for values of
// `elem_bytes` bytes (one warp per block at the limit).
int polyblock_solve_max_iter(int lanes, int elem_bytes) {
  if (lanes != 4 && lanes != 8 && lanes != 16) return -1;
  return kSmemLimit / ((32 / (2 * lanes)) * kCoopFields * elem_bytes) - 1;
}

}  // extern "C"
