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
// What bounds it on the card: the operations, 2 * m * k * n * reps * grid
// flops against the dense bf16 tensor-core peak (989e12 flop/s on an H100
// SXM at 700 W); the bytes, A and B read once and the f32 output written
// once, are a few MB.
//
// The probe, cbet_mma_probe_bf16: wgmma + TMA, the only route to that
// peak on Hopper.  The TPU holds both operands whole in VMEM; a (1280, 896)
// bf16 operand is 2.3 MB against the 227 KB of shared memory a block can
// use, so the operands stay in device memory (L2-resident) and a block
// streams 64-deep k-slices of them through a ring of kStages shared-memory
// stages:
//   * one producer thread issues cp.async.bulk.tensor.2d (TMA) loads of
//     64 x 64 bf16 boxes with the 128-byte swizzle, completed on a "full"
//     mbarrier per stage; the consumers hand a stage back through an "empty"
//     mbarrier.  No __syncthreads() after the barriers are set up.  The
//     tensor maps are encoded by the C entry point on every call (they hold
//     the operands' addresses) and passed as __grid_constant__ parameters;
//   * a block owns a 128 x 128 output tile: two consumer warpgroups, each
//     issuing wgmma.mma_async m64n128k16 (bf16 in, f32 out, both operands
//     from shared memory) on its 64 rows and the shared B stage.  n = 256 is
//     two tiles.  A block whose second 64 rows lie past m runs one consumer
//     warpgroup and loads one A box;
//   * nothing is transposed in memory: the (m, k) A is K-major, the (k, m)
//     transposed-lhs A and the (k, n) B are MN-major, which bf16 wgmma takes
//     through its transpose bits;
//   * ragged edges are the hardware's: TMA fills what lies outside a tensor
//     with zeros, the k tail skips its all-zero 16-deep steps, rows and
//     columns past m and n are not stored;
//   * the k-slices of a *chain* are accumulated in the wgmma accumulator
//     (the tensor cores truncate when they add into C), and each chain's
//     result is added into the f32 sum with a rounded add.  `run` (in
//     slices) is the chain length: the whole k (one rounded add per product,
//     as the TPU kernel's acc + dot) or shorter.  With `resident` a run of
//     `run` <= kStages slices stays in shared memory while all `reps`
//     products run their wgmmas on it, so every slice is loaded once per
//     block; otherwise the ring streams every slice again for every product
//     (reps x the L2 traffic: 128 x 128 tiles at 32 KB per 64-deep slice
//     need about 15 TB/s from L2 at the tensor cores' full rate).  All
//     reps x k/16 wgmmas are issued either way;
//   * the `grid` repetitions are the z dimension of the launch: every
//     z-slice computes the same tile in the same order and writes the same
//     values, so the output is defined whatever their order.  A persistent
//     block per SM would hide each block's ring fill behind the block
//     before; z blocks are the simple form, and a block's work (tens of
//     microseconds) is long against its fill.
//
// m, k and n must be multiples of 16 (the wrapper checks).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into the package's
// shared library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/mma_probe.py).

#include <cuda.h>   // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The wgmma + TMA probe.
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kSlice = 64;              // k depth of one stage
constexpr int kBoxRows = 64;            // a TMA box: 64 x 64 bf16, 128-byte rows
constexpr int kTileN = 128;             // output columns of a block
constexpr int kBoxBytes = kBoxRows * kSlice * 2;          // 8,192
constexpr int kConsumers = 2;           // warpgroups, 64 output rows each
constexpr int kTileM = 64 * kConsumers;
constexpr int kStageBytes = (kConsumers + 2) * kBoxBytes; // A boxes, 2 B boxes
constexpr int kStages = 6;
constexpr int kThreads = 128 * (kConsumers + 1);          // + the producer
// the ring, the slack to align it to the swizzle's 1,024 bytes, the barriers
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.  A wait that lasts
// seconds is a broken pipeline: trap, so that the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 8000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory matrix descriptor, 128-byte swizzle: the start
// address, the leading and the stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
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

// d (64 x 128 f32, 64 registers a thread) = a (64 x 16) . b (16 x 128)
// (+ d when scale_d).  kTransA: 0 K-major A, 1 MN-major; B is MN-major.
template <int kTransA>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA));
}

// Keeps the compiler from reading an accumulator before the wait that makes
// it valid, and from touching it while wgmmas are in flight.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <bool kTransA>
__global__ void __launch_bounds__(kThreads, 1)
mma_probe_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       float* __restrict__ out, int m, int k, int n, int reps,
                       int run, int resident) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + kStages * kStageBytes;   // 8-byte aligned
  const uint32_t empty0 = full0 + kStages * 8;

  // through a shuffle, so that the compiler sees a warp-uniform value and
  // does not treat the consumers' code as a divergent path (it serializes
  // the wgmmas there)
  const int wgid = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  // consumer warpgroups with output rows inside m
  const int active = (m0 + 64 < m) ? kConsumers : 1;
  const int nslices = (k + kSlice - 1) / kSlice;
  const int nruns = (nslices + run - 1) / run;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);               // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 4 * active);     // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgid == kConsumers) {
    // ---- the producer: one thread keeps the ring full ----
    if (threadIdx.x != kConsumers * 128) return;
    const uint32_t bytes = (active + 2) * kBoxBytes;
    int f = 0;                                   // fills so far
    for (int u = 0; u < nruns; ++u) {
      const int s0 = u * run, s1 = min(nslices, s0 + run);
      const int passes = resident ? 1 : reps;
      for (int pass = 0; pass < passes; ++pass) {
        for (int sl = s0; sl < s1; ++sl, ++f) {
          const int st = f % kStages;
          const uint32_t parity = (f / kStages) & 1;
          mbar_wait(empty0 + 8 * st, parity ^ 1);
          const uint32_t bar = full0 + 8 * st;
          mbar_arrive_expect_tx(bar, bytes);
          const uint32_t base = ring + st * kStageBytes;
          const int k0 = sl * kSlice;
          for (int w = 0; w < active; ++w) {
            if (kTransA) {
              tma_load_2d(base + w * kBoxBytes, &map_a, bar, m0 + 64 * w, k0);
            } else {
              tma_load_2d(base + w * kBoxBytes, &map_a, bar, k0, m0 + 64 * w);
            }
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            tma_load_2d(base + (kConsumers + c) * kBoxBytes, &map_b, bar,
                        n0 + 64 * c, k0);
          }
        }
      }
    }
    return;
  }
  if (wgid >= active) return;

  // ---- a consumer warpgroup: rows m0 + 64 * wgid .. + 63 ----
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  float acc[64], prod[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    prod[i] = 0.0f;
  }
  // 16-deep k step inside a stage: 32 bytes along a K-major row, 16 rows of
  // 128 bytes in an MN-major box (descriptor addresses count 16 bytes)
  constexpr uint64_t kStepA = kTransA ? (16 * 128) >> 4 : 32 >> 4;
  constexpr uint64_t kStepB = (16 * 128) >> 4;
  int f = 0;
  for (int u = 0; u < nruns; ++u) {
    const int s0 = u * run, s1 = min(nslices, s0 + run);
    const int len = s1 - s0;
    for (int rep = 0; rep < reps; ++rep) {
      const bool release = !resident || rep == reps - 1;
      int prev = -1;                              // stage of the slice before
      for (int sl = s0; sl < s1; ++sl) {
        const int fi = f + (resident ? 0 : rep * len) + (sl - s0);
        const int st = fi % kStages;
        mbar_wait(full0 + 8 * st, (fi / kStages) & 1);
        const uint32_t base = ring + st * kStageBytes;
        // K-major A: 8-row groups 1,024 bytes apart.  MN-major: 8 k-rows of
        // 128 bytes, 1,024 bytes to the next 8; B's two 64-wide column
        // boxes one box apart
        const uint64_t da = make_desc(base + wgid * kBoxBytes,
                                      kTransA ? kBoxBytes : 16, 1024);
        const uint64_t db = make_desc(base + kConsumers * kBoxBytes,
                                      kBoxBytes, 1024);
        const int ks = min(kSlice / 16, (k - sl * kSlice) / 16);
        fence_regs(prod);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlice / 16; ++kk) {
          if (kk < ks) {
            wgmma_m64n128k16<kTransA ? 1 : 0>(prod, da + kk * kStepA,
                                              db + kk * kStepB,
                                              (sl > s0 || kk > 0) ? 1 : 0);
          }
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();                        // the slice before is read
          if (release && lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(prod);
      if (release && lane == 0) mbar_arrive(empty0 + 8 * prev);
      // one rounded add per chain, as the TPU kernel's acc + dot
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += prod[i];
    }
    f += (resident ? 1 : reps) * len;
  }

  // the accumulator's layout: warp w holds rows 16 w .. 16 w + 15; a lane
  // holds rows lane / 4 and + 8, columns 8 j + 2 (lane % 4) and + 1
  const int row = m0 + 64 * wgid + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col < n) {
      if (row < m) {
        *reinterpret_cast<float2*>(out + (long long)row * n + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      }
      if (row + 8 < m) {
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * n + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: the library links
// nothing of libcuda.  nullptr when the installed libcuda lacks it.
EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The map of a row-major (outer, inner) bf16 tensor cut into 64 x 64 boxes
// with the 128-byte swizzle; what lies outside the tensor reads as zero.
bool encode_map(CUtensorMap* map, const void* ptr, int inner, int outer) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {kSlice, kBoxRows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kTransA>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, float* out, int m,
           int k, int n, int reps, int run, int resident, int grid,
           cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      mma_probe_wgmma_kernel<kTransA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 blocks((unsigned int)((n + kTileN - 1) / kTileN),
                    (unsigned int)((m + kTileM - 1) / kTileM),
                    (unsigned int)grid);
  mma_probe_wgmma_kernel<kTransA><<<blocks, kThreads, kSmemBytes, stream>>>(
      ma, mb, out, m, k, n, reps, run, resident);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// The probe (wgmma + TMA).  Enqueues one launch on `stream` and returns
// cudaGetLastError(): nonzero means the launch was refused.  a is (m, k)
// row-major, or (k, m) with transpose_lhs; b is (k, n); out is (m, n)
// float32; a and b 16-byte aligned.  m, k, n must be multiples of 16 and
// 1 <= grid <= 65535 (the wrapper checks).  `run` is the chain length in
// 64-deep slices (<= 0: the whole k); with `resident` a run stays in shared
// memory for all reps and must fit the ring (cbet_mma_probe_ring_slices()).
int cbet_mma_probe_bf16(const void* a, const void* b, void* out, int m, int k,
                        int n, int reps, int transpose_lhs, int run,
                        int resident, int grid, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (k <= 0 || reps <= 0 || grid <= 0 || grid > 65535 || m % 16 ||
      n % 16 || k % 16 || ((uintptr_t)a | (uintptr_t)b) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int nslices = (k + wg::kSlice - 1) / wg::kSlice;
  if (run <= 0 || run > nslices) run = nslices;
  if (resident && run > wg::kStages) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool ok = (transpose_lhs ? wg::encode_map(&ma, a, m, k)
                                 : wg::encode_map(&ma, a, k, m)) &&
                  wg::encode_map(&mb, b, n, k);
  if (!ok) return (int)cudaErrorNotSupported;
  if (transpose_lhs) {
    return wg::launch<true>(ma, mb, (float*)out, m, k, n, reps, run, resident,
                            grid, (cudaStream_t)stream);
  }
  return wg::launch<false>(ma, mb, (float*)out, m, k, n, reps, run, resident,
                           grid, (cudaStream_t)stream);
}

// Stages of the probe's ring: the longest resident run, in 64-deep slices.
int cbet_mma_probe_ring_slices() { return wg::kStages; }

}  // extern "C"
