// Digit slices of the factored D operand of the Ozaki contraction, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel filter_functions_tpu/ops/dword_pallas.py:
// dword_digits (Pallas body `_kernel`).  For D[k, (j c)] = B[k, j] * C[k, c]
// given as 23-bit int32 fixed-point factors it forms the three Gauss
// components Dr, Di and Dr + Di as 30-bit int32 words, finds each
// column's max |word|, normalizes the column by the rounded shift
// min(n_d * sb, 30) - 1 - bitlen(max - 1) and peels n_d int8 digits,
// round half up, high digit first.  The result is bit-exact against the
// JAX package and against the plain torch version
// (ops/dword.py: dword_digits_reference).
//
// Words without splits.  The JAX package forms each word from 12-bit
// splits of the factors in int32 (`_outer_word`): that chain is
// floor((floor((zB zC + 2^11) / 2^12) + 2^5) / 2^6).  Nested floors of
// divisions by powers of two compose, so for |zB|, |zC| <= 2^23, where
// the split form wraps nowhere, it is the single 64-bit product
//     w = (int64(zB) zC + 2^17 + 2^11) >> 18,     |w| <= 2^28.
// ops/ozaki._fix rounds x 2^(23 - e) with |x| <= 2^e, so the factors it
// makes lie in [-2^23, 2^23]: on that domain this kernel is bit-exact.
// Outside it the words differ from the plain version's.
//
// Design.  One block per (pulse, column (j, c)); the pulse index is
// blockIdx.z.  Each thread owns runs of kRun = 16 consecutive k of the
// column and keeps the Dr and Di words of its runs in registers (32 a
// run; Dr + Di is their sum), so each word is computed once.  The three
// column maxima are reduced over the block (warp shuffles, then one
// small shared array and a __syncthreads); thread 0 writes the shifts.
// Each thread then normalizes and peels its words in registers and
// packs the 16 digits of one (component, digit) plane into one int4:
// one 16-byte store, so a warp writes 512 contiguous bytes of a plane
// per store.  A run whose bytes are not one aligned 16-byte line (the
// ragged tail of a row, or every run of a row that does not start on a
// 16-byte boundary, as when K % 16 != 0) falls back to byte stores.
// The digits are written as (N, K) planes, K contiguous: plane.t() is
// the K-major right operand cuBLASLt's int8 GEMM takes.  The factors
// arrive transposed, (J, K) and (C, K), so a run's factors are four
// 64-byte loads.
//
// The register cap.  The instance kRuns = 1 keeps one run a thread at up
// to kMaxThreads threads (K <= 8192), kRuns = 2 two runs (K <= 16384 =
// kKeepCap).  Above the cap the instance kRuns = 0 sweeps K a second
// time and recomputes the words rather than keep them, with the same
// 64-bit words and 16-byte stores.
//
// Bound.  Per call of two flagship pulses (K = 3328, J = 18, C = 256,
// n_d = 5) it reads 14.6 MB of factors and writes 460.2 MB of digits
// and shifts: 0.142 ms at 3.35 TB/s, the memory floor (there is no
// published int32 peak to set an operation bound).  Per element it runs
// about 100 int32 operations: 4 words of 2 (a 64-bit multiply-add and a
// funnel shift) and 3 adds, 3 maxima of |word|, 3 normalizations, 12
// peel steps of 3 and the byte packing, ~3 G operations over the 30.7 M
// elements of the call; on the card's ~15-17 T int32 operations/s that
// is the same order as the memory floor.  Measured by chip_smoke.py on
// an H100 SXM (80 GB HBM3, 700 W limit): 0.272 ms a call, 52 % of the
// floor.  The digits leave at 1.7 TB/s, half the memory rate, while the
// ~3 G operations run at ~11 T/s: the int32 pipeline bounds it, with 2
// blocks of 7 warps a SM resident at the kRuns = 1 instance's 102
// registers.
//
// Signed overflow, and a left shift of a negative int, are undefined in
// C++17: the wrapping operations below go through unsigned and cast
// back, which matches XLA's and torch's two's-complement semantics for
// any input.  `>>` on int and int64 is arithmetic.  __clz(0) is 32, so
// an all-zero column gets bit length 0, as in JAX.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 16;
constexpr int kMaxThreads = 512;
constexpr int kKeepCap = 2 * kMaxThreads * kRun;
constexpr long long kWordRound = (1LL << 17) + (1LL << 11);

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wshl(int a, int s) {
  return static_cast<int>(static_cast<unsigned>(a) << s);
}

__device__ __forceinline__ int wabs(int a) { return a < 0 ? wsub(0, a) : a; }

// the 30-bit word of zB * zC / 2^18 (ops/ozaki.py: _outer_word), for
// |zB|, |zC| <= 2^23
__device__ __forceinline__ int word(int b, int c) {
  return static_cast<int>((static_cast<long long>(b) * c + kWordRound) >> 18);
}

// kRun factors of one row from k0 on; zeros past K
__device__ __forceinline__ void load_run(const int* __restrict__ row, int k0,
                                         int K, int v[kRun]) {
  const int* p = row + k0;
  if (k0 + kRun <= K && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(p) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) v[i] = k0 + i < K ? __ldg(p + i) : 0;
  }
}

struct Rows {
  const int* br;
  const int* bi;
  const int* cr;
  const int* ci;
};

// the Dr and Di words of the run at k0; folds |Dr|, |Di|, |Dr + Di| into m
__device__ __forceinline__ void run_words(const Rows& rows, int k0, int K,
                                          int dr[kRun], int di[kRun],
                                          int m[3]) {
  int br[kRun], bi[kRun], cr[kRun], ci[kRun];
  load_run(rows.br, k0, K, br);
  load_run(rows.bi, k0, K, bi);
  load_run(rows.cr, k0, K, cr);
  load_run(rows.ci, k0, K, ci);
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    dr[i] = wsub(word(br[i], cr[i]), word(bi[i], ci[i]));
    di[i] = wadd(word(br[i], ci[i]), word(bi[i], cr[i]));
    m[0] = max(m[0], wabs(dr[i]));
    m[1] = max(m[1], wabs(di[i]));
    m[2] = max(m[2], wabs(wadd(dr[i], di[i])));
  }
}

// low bytes of a, b, c, d in address order
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>(__byte_perm(__byte_perm(a, b, 0x0040),
                                      __byte_perm(c, d, 0x0040), 0x5410));
}

// the low bytes of v to dst[0 .. min(n, kRun)): one 16-byte store if the
// run is whole and aligned, else byte stores
__device__ __forceinline__ void store_run(int8_t* dst, const int v[kRun],
                                          int n) {
  if (n >= kRun && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<int4*>(dst) =
        make_int4(pack4(v[0], v[1], v[2], v[3]), pack4(v[4], v[5], v[6], v[7]),
                  pack4(v[8], v[9], v[10], v[11]),
                  pack4(v[12], v[13], v[14], v[15]));
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      if (i < n) dst[i] = static_cast<int8_t>(v[i]);
  }
}

struct Norm {
  int lshift[3], rshift[3], half[3];
};

// normalize the run's three components and peel their digits into the
// planes: out points at the column's row of plane (component 0, digit 0)
__device__ __forceinline__ void peel_run(int8_t* out, size_t plane, int k0,
                                         int K, const int dr[kRun],
                                         const int di[kRun], const Norm& nm,
                                         int n_d, int slice_bits) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    int z[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int w = t == 0 ? dr[i] : t == 1 ? di[i] : wadd(dr[i], di[i]);
      z[i] = wadd(wshl(w, nm.lshift[t]), nm.half[t]) >> nm.rshift[t];
    }
    int8_t* o = out + static_cast<size_t>(t) * n_d * plane + k0;
    for (int s = n_d - 1; s > 0; --s) {
      const int sh = slice_bits * s;
      const int round = 1 << (sh - 1);
      int d[kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        d[i] = wadd(z[i], round) >> sh;
        z[i] = wsub(z[i], wshl(d[i], sh));
      }
      store_run(o + static_cast<size_t>(n_d - 1 - s) * plane, d, K - k0);
    }
    store_run(o + static_cast<size_t>(n_d - 1) * plane, z, K - k0);
  }
}

// kRuns > 0: each thread keeps the words of kRuns runs in registers
// (runs threadIdx.x + i * blockDim.x).  kRuns == 0: each thread sweeps
// its runs twice, recomputing the words.
template <int kRuns>
__global__ void __launch_bounds__(kMaxThreads)
dword_digits_kernel(const int* __restrict__ zbr, const int* __restrict__ zbi,
                    const int* __restrict__ zcr, const int* __restrict__ zci,
                    int8_t* __restrict__ digits, int* __restrict__ shifts,
                    int K, int J, int C, int n_d, int slice_bits) {
  const int N = J * C;
  const int col = blockIdx.x;
  const int b = blockIdx.z;
  const int j = col / C;
  const int c = col - j * C;
  const Rows rows{zbr + (static_cast<size_t>(b) * J + j) * K,
                  zbi + (static_cast<size_t>(b) * J + j) * K,
                  zcr + (static_cast<size_t>(b) * C + c) * K,
                  zci + (static_cast<size_t>(b) * C + c) * K};
  const int n_runs = (K + kRun - 1) / kRun;
  constexpr int kHeld = kRuns > 0 ? kRuns : 1;
  int dr[kHeld][kRun], di[kHeld][kRun];

  // the column's max |word| of each component
  int m[3] = {0, 0, 0};
  if constexpr (kRuns > 0) {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const int r = threadIdx.x + i * blockDim.x;
      if (r < n_runs) run_words(rows, r * kRun, K, dr[i], di[i], m);
    }
  } else {
    for (int r = threadIdx.x; r < n_runs; r += blockDim.x)
      run_words(rows, r * kRun, K, dr[0], di[0], m);
  }
  __shared__ int smax[3][kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[t] = max(m[t], __shfl_xor_sync(0xffffffffu, m[t], off));
    if (lane == 0) smax[t][warp] = m[t];
  }
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    m[t] = smax[t][0];
    for (int w = 1; w < n_warps; ++w) m[t] = max(m[t], smax[t][w]);
  }

  const int top = min(n_d * slice_bits, 30) - 1;
  Norm nm;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int e_w = 32 - __clz(max(m[t], 1) - 1);
    const int shift = top - e_w;
    nm.lshift[t] = max(shift, 0);
    nm.rshift[t] = max(-shift, 0);
    nm.half[t] = (1 << nm.rshift[t]) >> 1;
    if (threadIdx.x == 0)
      shifts[(static_cast<size_t>(b) * 3 + t) * N + col] = shift;
  }

  // normalize, peel and store the digits
  const size_t plane = static_cast<size_t>(N) * K;
  int8_t* out = digits + static_cast<size_t>(b) * 3 * n_d * plane
                + static_cast<size_t>(col) * K;
  if constexpr (kRuns > 0) {
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      const int r = threadIdx.x + i * blockDim.x;
      if (r < n_runs)
        peel_run(out, plane, r * kRun, K, dr[i], di[i], nm, n_d, slice_bits);
    }
  } else {
    for (int r = threadIdx.x; r < n_runs; r += blockDim.x) {
      int unused[3] = {0, 0, 0};
      run_words(rows, r * kRun, K, dr[0], di[0], unused);
      peel_run(out, plane, r * kRun, K, dr[0], di[0], nm, n_d, slice_bits);
    }
  }
}

// whole warps enough for `runs` runs a thread, at most kMaxThreads
int threads_for(int runs_per_thread, int n_runs) {
  const int t = (n_runs + runs_per_thread - 1) / runs_per_thread;
  const int warps = (t + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

}  // namespace

// zbr, zbi: (batch, J, K) int32; zcr, zci: (batch, C, K) int32, contiguous,
// entries in [-2^23, 2^23].  digits: (batch, 3, n_d, J*C, K) int8;
// shifts: (batch, 3, J*C) int32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dword_digits_launch(const int* zbr, const int* zbi,
                                   const int* zcr, const int* zci,
                                   int8_t* digits, int* shifts, int batch,
                                   int K, int J, int C, int n_d,
                                   int slice_bits, cudaStream_t stream) {
  const int N = J * C;
  if (batch <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const int n_runs = (K + kRun - 1) / kRun;
  const dim3 grid(N, 1, batch);
  if (n_runs <= kMaxThreads) {
    dword_digits_kernel<1><<<grid, threads_for(1, n_runs), 0, stream>>>(
        zbr, zbi, zcr, zci, digits, shifts, K, J, C, n_d, slice_bits);
  } else if (K <= kKeepCap) {
    dword_digits_kernel<2><<<grid, threads_for(2, n_runs), 0, stream>>>(
        zbr, zbi, zcr, zci, digits, shifts, K, J, C, n_d, slice_bits);
  } else {
    dword_digits_kernel<0><<<grid, kMaxThreads, 0, stream>>>(
        zbr, zbi, zcr, zci, digits, shifts, K, J, C, n_d, slice_bits);
  }
  return static_cast<int>(cudaGetLastError());
}
