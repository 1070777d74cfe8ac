// Digit slices of the factored D operand of the Ozaki contraction, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel filter_functions_tpu/ops/dword_pallas.py:
// dword_digits (Pallas body `_kernel`).  For D[k, (j c)] = B[k, j] * C[k, c]
// given as 23-bit int32 fixed-point factors it forms the three Gauss
// components Dr, Di and Dr + Di as 30-bit int32 words (12-bit factor
// splits, `_outer_word`), finds each column's max |word|, normalizes the
// column by the rounded shift min(n_d * sb, 30) - 1 - bitlen(max - 1)
// and peels n_d int8 digits, round half up, high digit first.  The
// arithmetic is the JAX package's, expression for expression, and the
// result is bit-exact against it and against the plain torch version
// (ops/dword.py: dword_digits_reference).
//
// Design.  One warp owns one column (j, c) of one pulse: its lanes
// stride over K, so the column max is a warp reduction (shuffles, no
// shared memory, no second launch), and pass 2 recomputes the words
// rather than keeping them.  The digits are written as (N, K) planes,
// K contiguous: neighbouring lanes store neighbouring bytes, and
// plane.t() is the K-major right operand cuBLASLt's int8 GEMM takes.
// The factors arrive transposed, (J, K) and (C, K), so the lanes' loads
// coalesce too.  8 warps per block; the pulse index is blockIdx.z.
//
// What bounds it.  Per flagship pulse (K = 3328, J = 18, C = 256,
// n_d = 5) it reads ~7 MB of factors (L2-resident after the first
// columns) and writes 230 MB of digits: >= 69 us at 3.35 TB/s.  It also
// runs ~4 outer words (~10 int32 ops each) per element in each of the
// two passes plus 15 peel steps in pass 2, over 15.3 M (k, column)
// elements: ~3-4 G int32 operations per pulse.  Measured on an H100
// SXM (80 GB HBM3, 700 W limit): 0.55 ms per call of two pulses, four
// times the 0.14 ms memory floor, so the int32 pipeline, not memory,
// bounds this design; caching the 12-bit splits or the words of pass 1
// is where a faster kernel starts.
//
// Signed overflow, and a left shift of a negative int, are undefined in
// C++17: the wrapping operations below go through unsigned and cast
// back, which matches XLA's and torch's two's-complement semantics for
// any input.  `>>` on int is arithmetic.  __clz(0) is 32, so an all-zero
// column gets bit length 0, as in JAX.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int wshl(int a, int s) {
  return static_cast<int>(static_cast<unsigned>(a) << s);
}

__device__ __forceinline__ int wabs(int a) { return a < 0 ? wsub(0, a) : a; }

// z = hi * 2^12 + lo, round to nearest (ops/ozaki.py: _split12)
__device__ __forceinline__ void split12(int z, int& hi, int& lo) {
  hi = wadd(z, 1 << 11) >> 12;
  lo = wsub(z, wshl(hi, 12));
}

// top-30-bit word of the product of two split factors
// (ops/ozaki.py: _outer_word)
__device__ __forceinline__ int outer_word(int b1, int b0, int c1, int c0) {
  const int p2 = wmul(b1, c1);
  const int p1 = wadd(wmul(b1, c0), wmul(b0, c1));
  const int p0 = wmul(b0, c0);
  return wadd(wshl(p2, 6),
              wadd(wadd(p1, wadd(p0, 1 << 11) >> 12), 1 << 5) >> 6);
}

// the three Gauss-component words (Dr, Di, Dr + Di) of one element
__device__ __forceinline__ void comp_words(int br, int bi, int cr, int ci,
                                           int w[3]) {
  int b1, b0, i1, i0, c1, c0, d1, d0;
  split12(br, b1, b0);
  split12(bi, i1, i0);
  split12(cr, c1, c0);
  split12(ci, d1, d0);
  const int w_rr = outer_word(b1, b0, c1, c0);
  const int w_ii = outer_word(i1, i0, d1, d0);
  const int w_ri = outer_word(b1, b0, d1, d0);
  const int w_ir = outer_word(i1, i0, c1, c0);
  w[0] = wsub(w_rr, w_ii);
  w[1] = wadd(w_ri, w_ir);
  w[2] = wadd(w[0], w[1]);
}

__global__ void __launch_bounds__(kWarps * 32)
dword_digits_kernel(const int* __restrict__ zbr, const int* __restrict__ zbi,
                    const int* __restrict__ zcr, const int* __restrict__ zci,
                    int8_t* __restrict__ digits, int* __restrict__ shifts,
                    int K, int J, int C, int n_d, int slice_bits) {
  const int lane = threadIdx.x & 31;
  const int N = J * C;
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (col >= N) return;  // uniform per warp: the shuffles stay full-warp
  const int b = blockIdx.z;
  const int j = col / C;
  const int c = col - j * C;
  const int* br = zbr + (static_cast<size_t>(b) * J + j) * K;
  const int* bi = zbi + (static_cast<size_t>(b) * J + j) * K;
  const int* cr = zcr + (static_cast<size_t>(b) * C + c) * K;
  const int* ci = zci + (static_cast<size_t>(b) * C + c) * K;

  // pass 1: per-component max |word| of the column
  int m[3] = {0, 0, 0};
  for (int k = lane; k < K; k += 32) {
    int w[3];
    comp_words(br[k], bi[k], cr[k], ci[k], w);
#pragma unroll
    for (int t = 0; t < 3; ++t) m[t] = max(m[t], wabs(w[t]));
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[t] = max(m[t], __shfl_xor_sync(0xffffffffu, m[t], off));
  }

  const int top = min(n_d * slice_bits, 30) - 1;
  int lshift[3], rshift[3], half[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int e_w = 32 - __clz(max(m[t], 1) - 1);
    const int shift = top - e_w;
    lshift[t] = max(shift, 0);
    rshift[t] = max(-shift, 0);
    half[t] = (1 << rshift[t]) >> 1;
    if (lane == 0) shifts[(static_cast<size_t>(b) * 3 + t) * N + col] = shift;
  }

  // pass 2: recompute the words, normalize, peel the digits
  const size_t plane = static_cast<size_t>(N) * K;
  int8_t* out = digits + static_cast<size_t>(b) * 3 * n_d * plane
                + static_cast<size_t>(col) * K;
  for (int k = lane; k < K; k += 32) {
    int w[3];
    comp_words(br[k], bi[k], cr[k], ci[k], w);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      int z = wadd(wshl(w[t], lshift[t]), half[t]) >> rshift[t];
      int8_t* o = out + static_cast<size_t>(t) * n_d * plane + k;
      for (int s = n_d - 1; s > 0; --s) {
        const int sh = slice_bits * s;
        const int d = wadd(z, 1 << (sh - 1)) >> sh;
        o[static_cast<size_t>(n_d - 1 - s) * plane] = static_cast<int8_t>(d);
        z = wsub(z, wshl(d, sh));
      }
      o[static_cast<size_t>(n_d - 1) * plane] = static_cast<int8_t>(z);
    }
  }
}

}  // namespace

// zbr, zbi: (batch, J, K) int32; zcr, zci: (batch, C, K) int32, contiguous.
// digits: (batch, 3, n_d, J*C, K) int8; shifts: (batch, 3, J*C) int32.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dword_digits_launch(const int* zbr, const int* zbi,
                                   const int* zcr, const int* zci,
                                   int8_t* digits, int* shifts, int batch,
                                   int K, int J, int C, int n_d,
                                   int slice_bits, cudaStream_t stream) {
  const int N = J * C;
  if (batch <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kWarps * 32);
  const dim3 grid((N + kWarps - 1) / kWarps, 1, batch);
  dword_digits_kernel<<<grid, block, 0, stream>>>(
      zbr, zbi, zcr, zci, digits, shifts, K, J, C, n_d, slice_bits);
  return static_cast<int>(cudaGetLastError());
}
