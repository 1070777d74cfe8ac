// The int8 slice products of the factored Ozaki contraction and their
// recombination, for Hopper (sm_90a): one launch per call of
// ops/ozaki.py: _outer_contract on CUDA tensors.
//
// It replaces no TPU kernel.  On the TPU the JAX package leaves the slice
// products to XLA (filter_functions_tpu/ops/ozaki.py: _matmul_from_slices,
// one int8 dot_general per slice pair, the level sums and the
// double-single recombination as elementwise passes), and the port's
// plain version does the same with torch._int_mm and ~70 elementwise
// launches per Gauss product (ops/ozaki.py: _outer_contract_plain).  Here
// no int32 level and no double-single pair leaves the registers.
//
// What it computes, per pulse b and Gauss product t (P_t = Pr, Pi or
// Pr + Pi against D_t = Dr, Di or Dr + Di), for levels s = 0 .. n - 1:
//     L_s = sum_{i = 0 .. s} A_{t,i} @ D_{t,s-i}        exact in int32
//     (hi, lo) = ds_add((hi, lo), ds(L_s) * 2^(-slice_bits s))
//     p_t = ((f64(hi) + f64(lo)) * a_sc_t[m]) * d_sc_t[n]
// then re = p_0 - p_1 and im = (p_2 - p_0) - p_1.  Every float step is
// the plain version's IEEE operation in its order (the _rn intrinsics
// keep the compiler from contracting any of them into an FMA), and the
// integer sums are exact in any order, so the result is bit-exact
// against it.
//
// Design.  One block of two warpgroups per (128 rows of M, 64 columns of
// N, pulse); each warpgroup owns 64 rows and keeps all n levels of its
// 64 x 64 tile in registers as int32 (n x 32 a thread).  The block walks
// the three products and, in each, K in steps of kBK = 64 bytes.  A step
// is one stage of a ring in shared memory: the n P slices' tiles (128
// rows) and the n D slices' tiles (64 rows) at that K, all K-major as the
// operands are (P's slices are (M, K) rows, dword_digits writes (N, K)
// planes), loaded by TMA in the 64-byte swizzle that the wgmma
// descriptors name.  Per step and k32 a warpgroup runs one m64n64k32
// wgmma for every slice pair (i, j) with i + j < n into level i + j: each
// tile loaded serves n - i pairs, three times the reuse of one pair a
// load.  A 60 KB step (72 KB at n = 6) leaves room for three stages;
// steps of 32 bytes a row made the loads the limit (a row is then one
// 32-byte sector of a separate line), and of 128 bytes would not leave
// two.  Thread 0 keeps the ring kStages - 1 steps ahead: a step's "full"
// barrier counts its TMA bytes, its "empty" barrier the two warpgroups'
// release after their wgmma of the step has completed; one wgmma group is
// in flight across the loop's back edge.  Rows past M or N and bytes past
// K are zeros (TMA's out-of-bounds fill), which add nothing to an integer
// sum.  After a product's last step a warpgroup waits for its wgmma,
// folds the levels in order into a double-single pair, and writes p_t
// (t = 0, 1 into re and im) or combines p_2 with the p_0 and p_1 it
// wrote (t = 2).
//
// Bound.  The cells' call (2 pulses, M = 1000, K = 3328, N = 4608,
// slice_bits 7, n = 5: 3 x 15 slice pairs) is 2.76e12 int8 operations,
// 1.39 ms at the H100's dense int8 peak of 1979 T/s; its compulsory
// memory traffic (the slices read once, re and im written once, p_0 and
// p_1 written and read back) is ~1 GB, 0.3 ms at 3.35 TB/s: the tensor
// cores bound it.
//
// Requirements, checked by the wrapper (ops/products.py): K % 16 == 0,
// every operand row and base 16-byte aligned, slice_bits 5..7 and
// n = ceil(30 / slice_bits) levels, so that no level sum leaves int32.

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSlices = 6;
constexpr int kThreads = 256;            // two warpgroups
constexpr int kBM = 128;                 // rows of M a block, 64 a warpgroup
constexpr int kBN = 64;                  // columns of N a block
constexpr int kBK = 64;                  // bytes of K a step: two k32 wgmma
constexpr int kRingMax = 224 * 1024;     // shared memory of the ring, at most

struct Args {
  CUtensorMap a[3][kMaxSlices];  // (B, M, K) P slices, box (kBK, kBM, 1)
  CUtensorMap d[3][kMaxSlices];  // (B, N, K) D slices, box (kBK, kBN, 1)
  const void* a_sc[3];           // (B, M) row scales, float or double
  const double* d_sc[3];         // (B, N) column scales
  double* re;                    // (B, M, N)
  double* im;
  int M, N, K, n, slice_bits, a_sc_f64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spins until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the box of `map` at (c0, c1, c2) into shared memory at dst, counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma
template <int L, int R>
__device__ __forceinline__ void fence_operands(int (&d)[L][R]) {
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int r = 0; r < R; ++r) asm volatile("" : "+r"(d[l][r])::"memory");
}

// descriptor of a K-major tile in the 64-byte swizzle: rows of kBK = 64
// bytes, 8-row groups 512 bytes apart, the tile 512-byte aligned
__device__ __forceinline__ uint64_t tile_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// d += A B for the 64 x 32 int8 tile A and the 64 x 32 tile B (K-major)
// that the descriptors name; the caller zeroes d
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// two-float addition (ah, al) += (bh, bl): ops/ozaki.py: _ds_add
__device__ __forceinline__ void ds_add(float& ah, float& al, float bh,
                                       float bl) {
  const float s = __fadd_rn(ah, bh);
  const float v = __fsub_rn(s, ah);
  float e = __fadd_rn(__fsub_rn(ah, __fsub_rn(s, v)), __fsub_rn(bh, v));
  e = __fadd_rn(e, __fadd_rn(al, bl));
  const float h = __fadd_rn(s, e);
  ah = h;
  al = __fsub_rn(e, __fsub_rn(h, s));
}

// level s's int32 sum into the running pair: the exact split
// (_ds_from_int32), both halves scaled by 2^(-slice_bits s), then ds_add
template <int R>
__device__ __forceinline__ void fold_level(const int (&acc)[R], float (&hi)[R],
                                           float (&lo)[R], int s,
                                           int slice_bits) {
  const float scale = __int_as_float((127 - slice_bits * s) << 23);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int v = acc[r];
    const int vh = v & static_cast<int>(0xFFFF0000u);
    const float th = __fmul_rn(__int2float_rn(vh), scale);
    const float tl = __fmul_rn(__int2float_rn(v - vh), scale);
    if (s == 0) {
      hi[r] = th;
      lo[r] = tl;
    } else {
      ds_add(hi[r], lo[r], th, tl);
    }
  }
}

// product t of the thread's elements: widened, scaled by the row and the
// column scale, and written (t = 0: re, t = 1: im) or combined with the
// two written before (t = 2)
template <int R>
__device__ __forceinline__ void finish_product(const float (&hi)[R],
                                               const float (&lo)[R],
                                               const Args& p, int t, int b,
                                               int m0, int n0, int tid) {
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row0 = m0 + (tid >> 7) * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  const size_t rows = static_cast<size_t>(b) * p.M;
  const float* a_sc32 = static_cast<const float*>(p.a_sc[t]) + rows;
  const double* a_sc64 = static_cast<const double*>(p.a_sc[t]) + rows;
  const double* d_sc = p.d_sc[t] + static_cast<size_t>(b) * p.N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // the wgmma accumulator layout: element r = 4 j + q of the thread is
    // row 8 (q / 2) of its quad, column 8 j + 2 (lane % 4) + q % 2
    const int m = row0 + 8 * ((r >> 1) & 1);
    const int n = col0 + 8 * (r >> 2) + (r & 1);
    if (m < p.M && n < p.N) {
      const double a_sc =
          p.a_sc_f64 ? a_sc64[m] : static_cast<double>(a_sc32[m]);
      double v = __dadd_rn(static_cast<double>(hi[r]),
                           static_cast<double>(lo[r]));
      v = __dmul_rn(__dmul_rn(v, a_sc), d_sc[n]);
      const size_t at = (static_cast<size_t>(b) * p.M + m) * p.N + n;
      if (t == 0) {
        p.re[at] = v;
      } else if (t == 1) {
        p.im[at] = v;
      } else {
        const double p0 = p.re[at];
        const double p1 = p.im[at];
        p.re[at] = __dsub_rn(p0, p1);
        p.im[at] = __dsub_rn(__dsub_rn(v, p0), p1);
      }
    }
  }
}


template <int kLevels>
struct Ring {
  static constexpr int kTileA = kBM * kBK;
  static constexpr int kTileB = kBN * kBK;
  static constexpr int kStage = kLevels * (kTileA + kTileB);
  static constexpr int kStages = kRingMax / kStage < 8 ? kRingMax / kStage : 8;
  // the ring, 1024-byte aligned, then the barriers
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * 8 * kStages;
};

// thread 0: step y (product t = y / k_steps, K offset kBK (y % k_steps)) of
// every slice into a stage, counted on its full barrier
template <int kLevels>
__device__ __forceinline__ void load_step(const Args& p, uint32_t stage,
                                          uint32_t full, int y, int k_steps,
                                          int b, int m0, int n0) {
  using Rg = Ring<kLevels>;
  const int t = y / k_steps;
  const int k = (y - t * k_steps) * kBK;
  mbar_expect_tx(full, Rg::kStage);
#pragma unroll
  for (int i = 0; i < kLevels; ++i) {
    tma_load(stage + i * Rg::kTileA, &p.a[t][i], full, k, m0, b);
    tma_load(stage + kLevels * Rg::kTileA + i * Rg::kTileB, &p.d[t][i], full,
             k, n0, b);
  }
}

template <int kLevels>
__global__ void __launch_bounds__(kThreads, 1)
    ozaki_products_kernel(const __grid_constant__ Args p) {
  using Rg = Ring<kLevels>;
  constexpr int kStages = Rg::kStages;
  constexpr int R = kBN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full0 = ring + kStages * Rg::kStage;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int k_steps = (p.K + kBK - 1) / kBK;
  const int steps = 3 * k_steps;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int y = 0; y < kStages && y < steps; ++y)
      load_step<kLevels>(p, ring + y * Rg::kStage, full0 + 8 * y, y,
                              k_steps, b, m0, n0);

  int acc[kLevels][R];
#pragma unroll
  for (int s = 0; s < kLevels; ++s)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[s][r] = 0;
  const uint32_t a_rows = (tid >> 7) * 64 * kBK;  // the warpgroup's 64 rows
  int x = 0;
  for (int t = 0; t < 3; ++t) {
    // nothing inside this loop touches the accumulators but the wgmma: a
    // group stays in flight across its back edge
    for (int ks = 0; ks < k_steps; ++ks, ++x) {
      const int stage = x % kStages;
      const uint32_t base = ring + stage * Rg::kStage;
      mbar_wait(full0 + 8 * stage, (x / kStages) & 1);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        // every slice pair (i, j) with i + j < kLevels into level i + j
#pragma unroll
        for (int i = 0; i < kLevels; ++i) {
          const uint64_t da =
              tile_desc(base + i * Rg::kTileA + a_rows) + 2 * kk;
#pragma unroll
          for (int j = 0; i + j < kLevels; ++j)
            wgmma_m64n64k32(
                acc[i + j], da,
                tile_desc(base + kLevels * Rg::kTileA + j * Rg::kTileB) +
                    2 * kk);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      // the step before has completed in this warpgroup: release its stage,
      // and thread 0 refills it once both warpgroups have
      if (x > 0) {
        const int prev = (x - 1) % kStages;
        if ((tid & 127) == 0) mbar_arrive(empty0 + 8 * prev);
        if (tid == 0 && x - 1 + kStages < steps) {
          mbar_wait(empty0 + 8 * prev, ((x - 1) / kStages) & 1);
          load_step<kLevels>(p, ring + prev * Rg::kStage,
                                  full0 + 8 * prev, x - 1 + kStages, k_steps,
                                  b, m0, n0);
        }
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    float hi[R], lo[R];
#pragma unroll
    for (int s = 0; s < kLevels; ++s)
      fold_level(acc[s], hi, lo, s, p.slice_bits);
    finish_product(hi, lo, p, t, b, m0, n0, tid);
#pragma unroll
    for (int s = 0; s < kLevels; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[s][r] = 0;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (batch, rows, K) int8 operand, rows `ld` bytes apart, in boxes of
// (kBK, box_rows, 1) in the 64-byte swizzle; zeros out of bounds
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int batch,
            int rows, int K, long long ld, long long batch_stride,
            int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld),
                                 static_cast<cuuint64_t>(batch_stride)};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kLevels>
int launch(Args& p, const unsigned long long* ptrs, int batch, long long a_bs,
           long long lda, long long d_bs, long long ldd, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  for (int t = 0; t < 3; ++t)
    for (int i = 0; i < kLevels; ++i) {
      const void* a = reinterpret_cast<const void*>(ptrs[t * kMaxSlices + i]);
      const void* d =
          reinterpret_cast<const void*>(ptrs[(3 + t) * kMaxSlices + i]);
      if (!encode(fn, &p.a[t][i], a, batch, p.M, p.K, lda, a_bs, kBM) ||
          !encode(fn, &p.d[t][i], d, batch, p.N, p.K, ldd, d_bs, kBN))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  using Rg = Ring<kLevels>;
  auto kernel = ozaki_products_kernel<kLevels>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Rg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN, batch);
  kernel<<<grid, kThreads, Rg::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: a[3][6], d[3][6], a_sc[3], d_sc[3], re, im (44 device addresses;
// unused slice slots may be 0).  dims: batch, M, N, K, n, slice_bits,
// a_bs, lda, d_bs, ldd (bytes), a_sc_f64 (1 where the row scales are
// double, 0 where float); the scales are contiguous (B, M) and (B, N).
// Launches on `stream` and returns the CUDA error (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int ozaki_products_launch(const unsigned long long* ptrs,
                                     const long long* dims,
                                     cudaStream_t stream) {
  Args p = {};
  for (int t = 0; t < 3; ++t) {
    p.a_sc[t] = reinterpret_cast<const void*>(ptrs[6 * kMaxSlices + t]);
    p.d_sc[t] = reinterpret_cast<const double*>(ptrs[6 * kMaxSlices + 3 + t]);
  }
  p.re = reinterpret_cast<double*>(ptrs[6 * kMaxSlices + 6]);
  p.im = reinterpret_cast<double*>(ptrs[6 * kMaxSlices + 7]);
  const int batch = static_cast<int>(dims[0]);
  p.M = static_cast<int>(dims[1]);
  p.N = static_cast<int>(dims[2]);
  p.K = static_cast<int>(dims[3]);
  p.n = static_cast<int>(dims[4]);
  p.slice_bits = static_cast<int>(dims[5]);
  p.a_sc_f64 = static_cast<int>(dims[10]);
  if (p.K % 16 != 0 || dims[7] % 16 != 0 || dims[9] % 16 != 0 ||
      p.slice_bits < 5 || p.slice_bits > 7 ||
      p.n != (30 + p.slice_bits - 1) / p.slice_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || p.M <= 0 || p.N <= 0 || p.K <= 0)
    return static_cast<int>(cudaSuccess);
  return p.n == 5 ? launch<5>(p, ptrs, batch, dims[6], dims[7], dims[8],
                             dims[9], stream)
                  : launch<6>(p, ptrs, batch, dims[6], dims[7], dims[8],
                             dims[9], stream);
}
