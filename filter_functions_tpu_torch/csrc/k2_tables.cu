// The weighted K2 lattice of the second-order frequency shifts, from the
// separable tables, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds these tables with XLA
// ops (filter_functions_tpu/numeric.py: _second_order_factored_single).
// The port's plain version is numeric._factored_weighted_lattice_plain:
// _second_order_factored_single, _factored_stacks and _weighted_lattice,
// about 160 elementwise passes a chunk of segments over (n_w, d^2)
// arrays, the six D_k of _frac_divdiff_coeffs ten passes each.
//
// What it computes.  For each segment (eigenvalues E, duration dt) the
// lattice I[o, ij, mn] is  sum_t left_t[o, ij] right_t[o, mn]
// - f_z[ij, mn] r_big[o, mn]  over T = 8 terms, and the shifts want
// ell[s, ij, mn] = sum_o weights[s, o] I[o, ij, mn].  Every entry of a
// left table is a function of one (o, ij), every entry of a right table
// of one (o, mn): left = (f_x, special, dks_0..5), right = (r_big, m0,
// yks_0..5).  Three launches a chunk:
//   1. k2_tables_kernel: each thread takes one frequency o (a lane) and
//      walks the differences q; at (o, q) it builds the left column at
//      ij = q and the right column at mn = q in registers and writes
//      them as the product reads them: left as float64 planes (re, im)
//      of (2 d^2, K), right times weights[s, o] as (n_s d^2, K), both
//      K-major with K = (t, o).  The wrapper's torch.bmm reads left and
//      right^T with no copy (cuBLAS takes the transposed operand as its
//      op).  It also writes each 32-frequency tile's partial sums of
//      weights[s, o] r_big[o, mn] (rho), reduced over the warp in a fixed
//      order, so the result does not depend on scheduling.
//   2. one batched DGEMM (the wrapper, cuBLAS): P = left @ right^T,
//      (2 d^2, n_s d^2) a segment, the real and imaginary planes stacked
//      as rows.
//   3. k2_epilogue_kernel: ell = complex(P_re, P_im) - f_z rho, f_z =
//      frac(Omega_ij + Omega_mn) from the eigenvalues, rho summed over
//      the tiles in order, written as (n_s, d^2, d^2) complex128.
//
// Branches and constants are the plain version's: _SO_SMALL_Y (1e-2),
// _SO_SMALL_K (6), _SO_SERIES_W (0.2), _SO_SERIES_J (12), the masks at
// y == 0 and x == 0, the dt^2/2 limit and _frac_from_trig's Taylor
// branch below |u dt| = 0.05.  Each element takes the branch its
// arguments select and evaluates only that one.  The D_k keep the plain
// version's two stages: the static coefficients (passed in, those of
// numeric._frac_divdiff_static) are contracted with the powers of
// a = -omega dt once per block and frequency (the block's prologue,
// into shared memory), then each element sums them against the powers of
// b = Omega_ij dt.  The elementwise steps that the plain version takes
// as separate tensor operations are rounded one by one here too
// (__dmul_rn and friends, which nvcc does not contract), so f_x, the
// limit and the right tables follow the plain version's rounding.
//
// Bound.  Per call of four flagship pulses (52 segments, d = 16, 1000
// frequencies, one row of weights) the kernel writes 2.56 GB: left 16
// float64 planes and right 8 of (n_w, d^2) a segment; 0.76 ms at
// 3.35 TB/s.  It reads next to nothing (eigenvalues, frequencies,
// weights, 32 KB of coefficients).  Per element it runs about 100 FP64
// operations on average (the closed form's 27 complex products, the
// series' 78 where |x dt| <= 0.2, four divisions), ~1.3e9 a call, below
// the memory floor on the card's 34 TFLOP/s of FP64 outside the tensor
// cores.  So it is bound by the bytes of its output, and its design
// writes each byte once, in full 256-byte lines (32 lanes, consecutive
// o), and keeps everything else in registers and shared memory.  The
// DGEMM reads them once: 2.73e10 flop a pulse on the tensor cores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 6;                   // _SO_SMALL_K
constexpr int kP = 13;                  // _SO_SERIES_J + 1 powers
constexpr int kT = 2 + kK;              // terms of the tables
constexpr double kSmallY = 1e-2;        // _SO_SMALL_Y
constexpr double kSeriesW = 0.2;        // _SO_SERIES_W
constexpr double kTaylorW = 0.05;       // _frac_from_trig's branch
constexpr int kTileO = 32;              // frequencies a block, one a lane
constexpr int kTileQ = 128;             // differences a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeriesEntries = kK * kP;           // T_m[k][s], 78
constexpr int kClosedEntries = 27;                // T_b[k][s <= k + 1]
constexpr int kEntries = kSeriesEntries + kClosedEntries;
constexpr int kQVals = 4 + kP;                    // Omega, b, sin b, cos b, b^s
constexpr int kEpilogueIJ = 16;                   // ij a block of the epilogue
constexpr size_t kTablesSmem =
    sizeof(double2) * kEntries * kTileO + sizeof(double) * kQVals * kTileQ +
    sizeof(double) * 2 * kK;

// first entry of T_b[k] in the closed-form block: sum_{j < k} (j + 2)
__host__ __device__ constexpr int closed_offset(int k) {
  return k * (k + 3) / 2;
}

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// numeric._frac_from_trig: (re, im) of frac(u) = (e^{i u dt} - 1)/u from
// sin/cos(u dt), the Taylor branch below |u dt| = 0.05
__device__ __forceinline__ void frac_from_trig(double u, double sin_u,
                                               double cos_u, double dt,
                                               double& re, double& im) {
  const double w = mul(u, dt);
  if (fabs(w) < kTaylorW) {
    const double w2 = mul(w, w);
    double p = add(1.0 / 720.0, mul(w2, -1.0 / 40320.0));
    p = add(-1.0 / 24.0, mul(w2, p));
    p = add(0.5, mul(w2, p));
    re = mul(mul(-dt, w), p);
    double q = add(1.0 / 120.0, mul(w2, -1.0 / 5040.0));
    q = add(-1.0 / 6.0, mul(w2, q));
    q = add(1.0, mul(w2, q));
    im = mul(dt, q);
  } else {
    const double inv_u = 1.0 / u;
    re = mul(sub(cos_u, 1.0), inv_u);
    im = mul(sin_u, inv_u);
  }
}

// k! as a double (exact for k <= 6)
__device__ __forceinline__ double factorial(int k) {
  double f = 1.0;
  for (int i = 2; i <= k; ++i) f *= i;
  return f;
}

// omega (n_w); eigvals (n_seg, d); dt (n_seg); weights (n_s, n_w);
// coef (2, kK, kP, kP) complex: numeric._frac_divdiff_static's series (M)
// and closed-form (B) coefficients [k][r][s].  left (n_seg, 2, d^2, kT,
// n_w); right (n_seg, n_s, d^2, kT, n_w); rho_part (n_seg, n_otiles,
// n_s, d^2).  One block per (segment, tile of kTileQ differences, tile of
// kTileO frequencies), flattened into blockIdx.x.
__global__ void __launch_bounds__(kThreads)
    k2_tables_kernel(const double* __restrict__ omega,
                     const double* __restrict__ eigvals,
                     const double* __restrict__ dt_seg,
                     const double* __restrict__ weights,
                     const double2* __restrict__ coef,
                     double* __restrict__ left, double* __restrict__ right,
                     double* __restrict__ rho_part, int d, int n_w, int n_s,
                     int n_otiles, int n_qtiles) {
  extern __shared__ double2 smem[];
  double2* tab = smem;                                   // [kEntries][kTileO]
  double* qv = reinterpret_cast<double*>(tab + kEntries * kTileO);
  double* dt_pow = qv + kQVals * kTileQ;   // dt^(k+2), then dt^(-k)

  const int d2 = d * d;
  long long bid = blockIdx.x;
  const int ot = static_cast<int>(bid % n_otiles);
  bid /= n_otiles;
  const int qt = static_cast<int>(bid % n_qtiles);
  const long long seg = bid / n_qtiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = ot * kTileO + lane;
  const bool o_ok = o < n_w;
  const double dt = dt_seg[seg];
  const double* ev = eigvals + seg * d;
  const int q0 = qt * kTileQ;
  const int n_q = min(kTileQ, d2 - q0);

  // the differences' values: Omega_ij, b = Omega_ij dt, sin/cos b and the
  // powers of b (numeric._k2_arguments, _frac_divdiff_coeffs)
  for (int i = threadIdx.x; i < n_q; i += kThreads) {
    const int q = q0 + i;
    const double de = sub(ev[q / d], ev[q % d]);
    const double b = mul(de, dt);
    qv[0 * kTileQ + i] = de;
    qv[1 * kTileQ + i] = b;
    qv[2 * kTileQ + i] = sin(b);
    qv[3 * kTileQ + i] = cos(b);
    double p = 1.0;
    qv[4 * kTileQ + i] = p;
    for (int s = 1; s < kP; ++s) {
      p = mul(p, b);
      qv[(4 + s) * kTileQ + i] = p;
    }
  }
  if (threadIdx.x < kK) {
    dt_pow[threadIdx.x] = pow(dt, static_cast<double>(threadIdx.x + 2));
    dt_pow[kK + threadIdx.x] = pow(dt, -static_cast<double>(threadIdx.x));
  }

  // the lane's frequency: a = -omega dt, sin/cos a, and the first stage
  // of the D_k polynomials, T[k][s] = sum_r coef[k][r][s] a^r
  const double w_o = o_ok ? omega[o] : 0.0;
  const double a = mul(-w_o, dt);
  const double sa = sin(a);
  const double ca = cos(a);
  {
    double apow[kP];
    apow[0] = 1.0;
#pragma unroll
    for (int r = 1; r < kP; ++r) apow[r] = mul(apow[r - 1], a);
    for (int e = warp; e < kEntries; e += kWarps) {
      int set, k, s;
      if (e < kSeriesEntries) {
        set = 0;
        k = e / kP;
        s = e % kP;
      } else {
        set = 1;
        k = 0;
        while (closed_offset(k + 1) <= e - kSeriesEntries) ++k;
        s = e - kSeriesEntries - closed_offset(k);
      }
      const double2* c = coef + ((set * kK + k) * kP) * kP + s;
      double re = 0.0, im = 0.0;
#pragma unroll
      for (int r = 0; r < kP; ++r) {
        const double2 m = c[r * kP];
        re = fma(m.x, apow[r], re);
        im = fma(m.y, apow[r], im);
      }
      tab[e * kTileO + lane] = make_double2(re, im);
    }
  }
  __syncthreads();

  const size_t plane = static_cast<size_t>(kT) * n_w;   // one (q) row
  for (int i = warp; i < n_q; i += kWarps) {
    const int q = q0 + i;
    const double de = qv[0 * kTileQ + i];
    const double b = qv[1 * kTileQ + i];
    const double sb = qv[2 * kTileQ + i];
    const double cb = qv[3 * kTileQ + i];

    // numeric._k2_arguments at (o, ij = q) and (o, mn = q)
    const double x = sub(de, w_o);
    const double y = add(w_o, de);
    const double sin_x = add(mul(sb, ca), mul(cb, sa));
    const double cos_x = sub(mul(cb, ca), mul(sb, sa));
    double fx_re, fx_im;
    frac_from_trig(x, sin_x, cos_x, dt, fx_re, fx_im);

    // the y == 0 limit: (f_x - i dt e^{i x dt})/x, dt^2/2 at x == 0
    double sp_re, sp_im;
    if (x != 0.0) {
      const double r_x = 1.0 / x;
      sp_re = mul(sub(fx_re, mul(-sin_x, dt)), r_x);
      sp_im = mul(sub(fx_im, mul(cos_x, dt)), r_x);
    } else {
      sp_re = mul(dt, dt) / 2.0;
      sp_im = 0.0;
    }

    double* lre = left + ((seg * 2 + 0) * d2 + q) * plane + o;
    double* lim = left + ((seg * 2 + 1) * d2 + q) * plane + o;
    if (o_ok) {
      lre[0] = fx_re;
      lim[0] = fx_im;
      lre[n_w] = sp_re;
      lim[n_w] = sp_im;
    }

    // dks_k = D_k(x) / dt^k, D_k = -frac^(k+1)(x)/(k+1)!
    // (numeric._frac_divdiff_coeffs), on the branch |x dt| selects
    const double w = add(a, b);
    const double* bpow = qv + 4 * kTileQ + i;
    if (fabs(w) <= kSeriesW) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const double2* t = tab + (k * kP) * kTileO + lane;
        double p_re = 0.0, p_im = 0.0;
#pragma unroll
        for (int s = 0; s < kP; ++s) {
          const double2 c = t[s * kTileO];
          const double bs = bpow[s * kTileQ];
          p_re = fma(c.x, bs, p_re);
          p_im = fma(c.y, bs, p_im);
        }
        // times i^(k+2) dt^(k+2), then -1/(k+1)!, then dt^-k
        const double f = dt_pow[k];
        double s_re, s_im;
        switch ((k + 2) & 3) {
          case 0: s_re = mul(p_re, f); s_im = mul(p_im, f); break;
          case 1: s_re = -mul(p_im, f); s_im = mul(p_re, f); break;
          case 2: s_re = -mul(p_re, f); s_im = -mul(p_im, f); break;
          default: s_re = mul(p_im, f); s_im = -mul(p_re, f); break;
        }
        const double inv_fact = -1.0 / factorial(k + 1);
        const double g = dt_pow[kK + k];
        if (o_ok) {
          lre[(2 + k) * n_w] = mul(mul(s_re, inv_fact), g);
          lim[(2 + k) * n_w] = mul(mul(s_im, inv_fact), g);
        }
      }
    } else {
      // (e^{i x dt} S_k(-i x dt) - 1) (-1)^(k+1) (k+1)! (dt/w)^(k+2)
      const double base = dt / w;
      double u_pow = mul(base, base);
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (k > 0) u_pow = mul(u_pow, base);
        const double2* t =
            tab + (kSeriesEntries + closed_offset(k)) * kTileO + lane;
        double p_re = 0.0, p_im = 0.0;
        for (int s = 0; s <= k + 1; ++s) {
          const double2 c = t[s * kTileO];
          const double bs = bpow[s * kTileQ];
          p_re = fma(c.x, bs, p_re);
          p_im = fma(c.y, bs, p_im);
        }
        const double e_re = cos_x * p_re - sin_x * p_im - 1.0;
        const double e_im = cos_x * p_im + sin_x * p_re;
        const double fact = factorial(k + 1);
        const double scale = mul(u_pow, (k & 1) ? fact : -fact);
        const double inv_fact = -1.0 / fact;
        const double g = dt_pow[kK + k];
        if (o_ok) {
          lre[(2 + k) * n_w] = mul(mul(mul(e_re, scale), inv_fact), g);
          lim[(2 + k) * n_w] = mul(mul(mul(e_im, scale), inv_fact), g);
        }
      }
    }

    // the right column at mn = q: r_big = 1/y where |y dt| >= 1e-2, m0 =
    // [y == 0], yks_k = (y dt)^k where 0 < |y dt| < 1e-2
    const double ydt = mul(y, dt);
    const bool mask_y = y != 0.0;
    const bool small_y = mask_y && fabs(ydt) < kSmallY;
    const double r_big = (mask_y && !small_y) ? 1.0 / y : 0.0;
    double rt[kT];
    rt[0] = r_big;
    rt[1] = mask_y ? 0.0 : 1.0;
    rt[2] = small_y ? 1.0 : 0.0;
#pragma unroll
    for (int k = 1; k < kK; ++k) rt[2 + k] = mul(rt[1 + k], ydt);

    for (int s = 0; s < n_s; ++s) {
      const double ws = o_ok ? weights[static_cast<size_t>(s) * n_w + o] : 0.0;
      double* rrow = right + ((seg * n_s + s) * d2 + q) * plane + o;
      double r0 = mul(rt[0], ws);
      if (o_ok) {
#pragma unroll
        for (int t = 0; t < kT; ++t) rrow[t * n_w] = mul(rt[t], ws);
      }
      // this tile's sum over o of weights[s, o] r_big[o, mn]
      for (int off = 16; off > 0; off >>= 1)
        r0 += __shfl_xor_sync(0xffffffffu, r0, off);
      if (lane == 0)
        rho_part[((seg * n_otiles + ot) * n_s + s) * d2 + q] = r0;
    }
  }
}

// prod (n_seg, 2, d^2, n_s d^2) float64, the DGEMM's; rho_part as above;
// ell (n_seg, n_s, d^2, d^2) complex128 as (re, im) pairs.  One block per
// (segment and row s, kEpilogueIJ rows ij, kThreads columns mn),
// flattened into blockIdx.x.
__global__ void __launch_bounds__(kThreads)
    k2_epilogue_kernel(const double* __restrict__ prod,
                       const double* __restrict__ rho_part,
                       const double* __restrict__ eigvals,
                       const double* __restrict__ dt_seg,
                       double2* __restrict__ ell, int d, int n_s,
                       int n_otiles, int n_mnb, int n_ijb) {
  const int d2 = d * d;
  long long bid = blockIdx.x;
  const int mnb = static_cast<int>(bid % n_mnb);
  bid /= n_mnb;
  const int ijb = static_cast<int>(bid % n_ijb);
  bid /= n_ijb;
  const int s = static_cast<int>(bid % n_s);
  const long long seg = bid / n_s;
  const int mn = mnb * kThreads + threadIdx.x;
  if (mn >= d2) return;
  const double dt = dt_seg[seg];
  const double* ev = eigvals + seg * d;

  double rho = 0.0;
  for (int t = 0; t < n_otiles; ++t)
    rho += rho_part[((seg * n_otiles + t) * n_s + s) * d2 + mn];
  const double de_mn = sub(ev[mn / d], ev[mn % d]);
  const size_t row = static_cast<size_t>(n_s) * d2;
  const double* p_re = prod + (seg * 2 + 0) * d2 * row + s * d2 + mn;
  const double* p_im = prod + (seg * 2 + 1) * d2 * row + s * d2 + mn;
  double2* out = ell + ((seg * n_s + s) * d2) * d2 + mn;
  const int ij_end = min(d2, (ijb + 1) * kEpilogueIJ);
  for (int ij = ijb * kEpilogueIJ; ij < ij_end; ++ij) {
    // f_z = frac(Omega_ij + Omega_mn) (numeric._k2_arguments)
    const double z = add(sub(ev[ij / d], ev[ij % d]), de_mn);
    const double zdt = mul(z, dt);
    double fz_re, fz_im;
    frac_from_trig(z, sin(zdt), cos(zdt), dt, fz_re, fz_im);
    out[static_cast<size_t>(ij) * d2] =
        make_double2(add(p_re[ij * row], mul(-fz_re, rho)),
                     add(p_im[ij * row], mul(-fz_im, rho)));
  }
}

}  // namespace

extern "C" int k2_tables_tile_o() { return kTileO; }

// The tables (launch 1).  omega (n_w), eigvals (n_seg, d), dt (n_seg),
// weights (n_s, n_w), coef (2, 6, 13, 13) complex as (re, im); left (n_seg,
// 2 d^2, 8 n_w), right (n_seg, n_s d^2, 8 n_w), rho_part (n_seg,
// ceil(n_w / 32), n_s, d^2); all float64 and contiguous.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int k2_tables_launch(const double* omega, const double* eigvals,
                                const double* dt, const double* weights,
                                const double* coef, double* left,
                                double* right, double* rho_part,
                                long long n_seg, int d, int n_w, int n_s,
                                cudaStream_t stream) {
  if (n_seg <= 0 || d <= 0 || n_w <= 0 || n_s <= 0)
    return static_cast<int>(cudaSuccess);
  // above 48 KB of dynamic shared memory only once allowed (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      k2_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTablesSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_otiles = (n_w + kTileO - 1) / kTileO;
  const int n_qtiles = (d * d + kTileQ - 1) / kTileQ;
  const long long blocks = n_seg * n_otiles * n_qtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k2_tables_kernel<<<static_cast<unsigned>(blocks), kThreads, kTablesSmem,
                     stream>>>(omega, eigvals, dt, weights,
                               reinterpret_cast<const double2*>(coef), left,
                               right, rho_part, d, n_w, n_s, n_otiles,
                               n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

// The epilogue (launch 3).  prod (n_seg, 2 d^2, n_s d^2) float64, rho_part
// as k2_tables_launch wrote it, eigvals and dt as there; ell (n_seg, n_s,
// d^2, d^2) complex128.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int k2_epilogue_launch(const double* prod, const double* rho_part,
                                  const double* eigvals, const double* dt,
                                  double* ell, long long n_seg, int d,
                                  int n_w, int n_s, cudaStream_t stream) {
  if (n_seg <= 0 || d <= 0 || n_w <= 0 || n_s <= 0)
    return static_cast<int>(cudaSuccess);
  const int d2 = d * d;
  const int n_otiles = (n_w + kTileO - 1) / kTileO;
  const int n_mnb = (d2 + kThreads - 1) / kThreads;
  const int n_ijb = (d2 + kEpilogueIJ - 1) / kEpilogueIJ;
  const long long blocks = n_seg * n_s * n_ijb * n_mnb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  k2_epilogue_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      prod, rho_part, eigvals, dt, reinterpret_cast<double2*>(ell), d, n_s,
      n_otiles, n_mnb, n_ijb);
  return static_cast<int>(cudaGetLastError());
}
