// Algorithm 1 (polyblock outer approximation, paper eqs. 21-29) on Hopper.
//
// Two kernels that share one device projection routine:
//
//   K2  project_kernel  replaces the JAX package's Pallas kernel
//       kernels/polyblock_project/kernel.py::_project_kernel: for each
//       vertex v = (tau, p), zeta from 60 halvings of (TINY, 1] on
//       g(zeta tau, zeta p) = 0 (eq. 22), zeta = 1 when v is already
//       feasible; writes zeta * v.  One thread per vertex.
//
//   K1  solve_kernel    replaces kernels/polyblock_fused/kernel.py::
//       _solve_kernel: all of Algorithm 1 for one feasible
//       (beta, |h|^2, E^max) pair per thread — vertex store, first-max
//       selection, eq.-26 retirement, eq.-23 children, two projections,
//       eq.-24 store writes — looping until the pair retires or hits
//       max_iter.  Returns tau*, p*, T*, iterations.
//
// What bounds them on the card: arithmetic, not memory.  One evaluation of
// g is a log1p, a division and ~12 more operations (the op counts of the
// JAX package's launch/analytic.py: g_eval_ops, projection_ops), and a
// projection runs 61 of them, while a pair moves 3 values in and 4 out.
// In float64 the division and log1p are multi-instruction sequences on the
// FP64 pipes, so FP64 throughput is the roof.  The design does nothing
// clever about that yet; it keeps the arithmetic off memory:
//   * all per-element state of the bisection lives in registers;
//   * K1's vertex store (max_iter + 1 slots x 5 values, 2.6 KB per pair in
//     float64 — too large for registers) sits in a global scratch laid out
//     [slot][field][pair], so neighbouring threads touch neighbouring
//     addresses and every store access is one coalesced transaction per
//     warp; a pair scans only its written slots [0, nvalid);
//   * a thread exits as soon as its pair retires, and a projection whose
//     vertex is already feasible skips its halvings (zeta = 1 either way).
//
// Replication contract: the arithmetic is spelled exactly as the Pallas
// kernels and the JAX package's wireless.total_energy / total_time spell
// it — folded kappa0 * mu, x * x for squares, division by LN2, the 1e-30
// floors, mid = 0.5 * (lo + hi), the g > 0 branch sense — and the library
// is built with --fmad=false so no multiply-add is contracted.  Selection
// scans the slots in ascending order with a strict >, which is the Pallas
// kernel's min-index first-max rule.  What can still differ from the CPU
// is the last ulp of log1p.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int kBlock = 128;

inline unsigned int grid_for(int64_t n) {
  return static_cast<unsigned int>((n + kBlock - 1) / kBlock);
}

template <typename T>
int launch_project(const void* v, const void* beta, const void* h2, const void* e_max,
                   void* out, int64_t n, int n_bisect, double kappa0_mu, double cpu_hz,
                   double pt_w, double model_bits, double bandwidth_hz, void* stream) {
  const Phys<T> c{static_cast<T>(kappa0_mu), static_cast<T>(0), static_cast<T>(cpu_hz),
                  static_cast<T>(pt_w), static_cast<T>(model_bits),
                  static_cast<T>(bandwidth_hz)};
  if (n > 0) {
    project_kernel<T><<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(v), static_cast<const T*>(beta), static_cast<const T*>(h2),
        static_cast<const T*>(e_max), static_cast<T*>(out), n, n_bisect, c);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const void* beta, const void* h2, const void* e_max, void* tau, void* p,
                 void* time_s, void* iters, void* store, int64_t n, double eps,
                 int max_iter, int n_bisect, double kappa0_mu, double mu_cycles,
                 double cpu_hz, double pt_w, double model_bits, double bandwidth_hz,
                 void* stream) {
  const Phys<T> c{static_cast<T>(kappa0_mu), static_cast<T>(mu_cycles),
                  static_cast<T>(cpu_hz), static_cast<T>(pt_w),
                  static_cast<T>(model_bits), static_cast<T>(bandwidth_hz)};
  if (n > 0) {
    solve_kernel<T><<<grid_for(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(beta), static_cast<const T*>(h2),
        static_cast<const T*>(e_max), static_cast<T*>(tau), static_cast<T*>(p),
        static_cast<T*>(time_s), static_cast<int32_t*>(iters), static_cast<T*>(store), n,
        static_cast<T>(eps), max_iter, n_bisect, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Every function returns the
// cudaGetLastError() code right after its launch (0 = launched).
extern "C" {

int polyblock_project_f64(const void* v, const void* beta, const void* h2,
                          const void* e_max, void* out, int64_t n, int n_bisect,
                          double kappa0_mu, double cpu_hz, double pt_w,
                          double model_bits, double bandwidth_hz, void* stream) {
  return launch_project<double>(v, beta, h2, e_max, out, n, n_bisect, kappa0_mu, cpu_hz,
                                pt_w, model_bits, bandwidth_hz, stream);
}

int polyblock_project_f32(const void* v, const void* beta, const void* h2,
                          const void* e_max, void* out, int64_t n, int n_bisect,
                          double kappa0_mu, double cpu_hz, double pt_w,
                          double model_bits, double bandwidth_hz, void* stream) {
  return launch_project<float>(v, beta, h2, e_max, out, n, n_bisect, kappa0_mu, cpu_hz,
                               pt_w, model_bits, bandwidth_hz, stream);
}

int polyblock_solve_f64(const void* beta, const void* h2, const void* e_max, void* tau,
                        void* p, void* time_s, void* iters, void* store, int64_t n,
                        double eps, int max_iter, int n_bisect, double kappa0_mu,
                        double mu_cycles, double cpu_hz, double pt_w, double model_bits,
                        double bandwidth_hz, void* stream) {
  return launch_solve<double>(beta, h2, e_max, tau, p, time_s, iters, store, n, eps,
                              max_iter, n_bisect, kappa0_mu, mu_cycles, cpu_hz, pt_w,
                              model_bits, bandwidth_hz, stream);
}

int polyblock_solve_f32(const void* beta, const void* h2, const void* e_max, void* tau,
                        void* p, void* time_s, void* iters, void* store, int64_t n,
                        double eps, int max_iter, int n_bisect, double kappa0_mu,
                        double mu_cycles, double cpu_hz, double pt_w, double model_bits,
                        double bandwidth_hz, void* stream) {
  return launch_solve<float>(beta, h2, e_max, tau, p, time_s, iters, store, n, eps,
                             max_iter, n_bisect, kappa0_mu, mu_cycles, cpu_hz, pt_w,
                             model_bits, bandwidth_hz, stream);
}

}  // extern "C"
