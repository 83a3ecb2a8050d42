// Tensor-core throughput probe: out = sum over reps of A.B (or A^T.B), bf16
// operands, float32 accumulation, the whole product repeated `grid` times.
//
// Replaces the TPU kernel scripts/bench_mxu_shapes.py::make_mm_kernel: a
// grid of GRID identical steps, each doing `reps` bf16 dot_generals over
// VMEM-resident (m, k) or (k, m) and (k, n) operands into an f32 (m, n)
// block, so that one launch runs long enough to time the matrix unit.  The
// contract kept here: `reps` accumulations of the same product, the grid
// repetition as a parameter, the transposed-lhs form, and an f32 (m, n)
// output equal to reps * (A.B).
//
// What differs on Hopper: the TPU holds both operands whole in VMEM; a
// (1280, 896) bf16 operand is 2.3 MB, above the 227 KB of shared memory one
// block can use.  So the operands stay in device memory (L2-resident: a few
// MB against 50 MB of L2), and each block owns a 64 x 64 output tile and
// streams 32-deep k-slices of A and B through shared memory with cp.async,
// double-buffered.  Each warp holds a 32 x 32 sub-tile as 2 x 2 wmma
// 16x16x16 bf16 fragments with float32 accumulators (mma.sync m16n8k16 on
// the tensor cores) and, per 16-deep slice, loads its fragments once and
// runs the `reps` products on them, each from a zero accumulator and added
// into the sum with a rounded float32 add.  The `grid` repetitions are the z
// dimension of the launch: every z-slice computes the same tile in the same
// order and writes the same values, so the output is defined whatever their
// order.  The k tail of a slice is zero-filled by cp.async and skipped by the
// products; m, k and n must be multiples of 16 (the wrapper checks).
//
// What bounds it on the card: the operations, 2 * m * k * n * reps * grid
// flops against the dense bf16 tensor-core peak (989e12 flop/s on an H100
// SXM at 700 W); the bytes, A and B read once and the f32 output written
// once, are a few MB.  mma.sync reaches a part of that peak; wgmma and TMA,
// which reach the rest, are later work.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into the package's
// shared library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/mma_probe.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;   // output rows of a block
constexpr int kBN = 64;   // output columns of a block
constexpr int kBK = 32;   // k-slice per stage
constexpr int kPad = 8;   // bf16 elements of row padding in shared memory
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile, 32 x 32 each
constexpr int kLdA = kBK + kPad;     // A row-major (m, k) tile
constexpr int kLdAt = kBM + kPad;    // A^T tile: rows k, columns m
constexpr int kLdB = kBN + kPad;     // B tile: rows k, columns n
constexpr int kAElems = (kBM * kLdA > kBK * kLdAt) ? kBM * kLdA : kBK * kLdAt;
constexpr int kBElems = kBK * kLdB;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage the k-slice starting at k0 of A (or A^T) and B into shared memory:
// 16-byte chunks, 2 per thread per operand; chunks past m, n or k are zeros.
template <bool kTransA>
__device__ __forceinline__ void load_slice(
    __nv_bfloat16* sA, __nv_bfloat16* sB, const __nv_bfloat16* A,
    const __nv_bfloat16* B, int m, int k, int n, int m0, int n0, int k0) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int c = threadIdx.x + it * kThreads;  // 256 chunks of 8 elements
    if (kTransA) {                              // (k, m) operand
      const int r = c / (kBM / 8), col = (c % (kBM / 8)) * 8;
      const bool ok = (k0 + r < k) && (m0 + col < m);
      cp_async16(sA + r * kLdAt + col,
                 ok ? A + (long long)(k0 + r) * m + m0 + col : A, ok);
    } else {                                    // (m, k) operand
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const bool ok = (m0 + r < m) && (k0 + col < k);
      cp_async16(sA + r * kLdA + col,
                 ok ? A + (long long)(m0 + r) * k + k0 + col : A, ok);
    }
    const int r = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
    const bool ok = (k0 + r < k) && (n0 + col < n);
    cp_async16(sB + r * kLdB + col,
               ok ? B + (long long)(k0 + r) * n + n0 + col : B, ok);
  }
}

template <bool kTransA>
__global__ void __launch_bounds__(kThreads)
mma_probe_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, float* __restrict__ out,
                 int m, int k, int n, int reps) {
  __shared__ __align__(128) __nv_bfloat16 sA[2][kAElems];
  __shared__ __align__(128) __nv_bfloat16 sB[2][kBElems];
  using ALayout = typename std::conditional<kTransA, wmma::col_major,
                                            wmma::row_major>::type;

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows0 = m0 + wm * 32;  // the warp's first output row

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], prod, zero;
  wmma::fill_fragment(zero, 0.0f);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (k + kBK - 1) / kBK;
  load_slice<kTransA>(sA[0], sB[0], A, B, m, k, n, m0, n0, 0);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load_slice<kTransA>(sA[(t + 1) & 1], sB[(t + 1) & 1], A, B, m, k, n,
                          m0, n0, (t + 1) * kBK);
    }
    cp_async_commit();     // possibly empty: one group per iteration
    cp_async_wait_one();   // slice t has landed
    __syncthreads();
    const __nv_bfloat16* a_s = sA[t & 1];
    const __nv_bfloat16* b_s = sB[t & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      if (t * kBK + kk >= k) break;   // the zero tail of the last slice
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16;
        if (kTransA) {
          wmma::load_matrix_sync(fa[i], a_s + kk * kLdAt + r, kLdAt);
        } else {
          wmma::load_matrix_sync(fa[i], a_s + r * kLdA + kk, kLdA);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb[j], b_s + kk * kLdB + wn * 32 + j * 16,
                               kLdB);
      }
      for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (rows0 + i * 16 >= m) continue;   // rows past m: nothing to do
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // the product from a zero accumulator, then a rounded add, as
            // the TPU kernel's acc + dot(a, b): the tensor cores truncate
            // when they add into C, which over 8 * k / 16 steps of
            // positive terms drifts by ~1e-5 of the sum
            wmma::mma_sync(prod, fa[i], fb[j], zero);
#pragma unroll
            for (int e = 0; e < prod.num_elements; ++e) {
              acc[i][j].x[e] += prod.x[e];
            }
          }
        }
      }
    }
    __syncthreads();       // the stage is refilled next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rows0 + i * 16;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + wn * 32 + j * 16;
      if (c >= n) continue;
      wmma::store_matrix_sync(out + (long long)r * n + c, acc[i][j], n,
                              wmma::mem_row_major);
    }
  }
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream` and returns cudaGetLastError(): nonzero
// means the launch was refused.  a is (m, k) row-major, or (k, m) with
// transpose_lhs; b is (k, n); out is (m, n) float32.  m, k, n must be
// multiples of 16 and 1 <= grid <= 65535 (the wrapper checks).
int cbet_mma_probe_bf16(const void* a, const void* b, void* out, int m, int k,
                        int n, int reps, int transpose_lhs, int grid,
                        void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (k <= 0 || reps <= 0 || grid <= 0 || grid > 65535 || m % 16 ||
      n % 16 || k % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 blocks((unsigned int)((n + kBN - 1) / kBN),
                    (unsigned int)((m + kBM - 1) / kBM), (unsigned int)grid);
  if (transpose_lhs) {
    mma_probe_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out, m, k,
        n, reps);
  } else {
    mma_probe_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)out, m, k,
        n, reps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
