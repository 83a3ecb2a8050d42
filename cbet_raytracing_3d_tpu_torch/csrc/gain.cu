// CBET gain reduction over beam pairs.
//
// Replaces the TPU kernel cbet_raytracing_3d_tpu/ops/pallas_gain.py::
// make_gain_kernel (body _gain_kernel), including its b_out form:
//
//   g[b, p] = pre[p] * sum_{b'} R(pair_u[b, b'] . rhat[:, p]) * I[b', p]
//   R(eta)  = iaw2 * eta / ((eta^2 - 1)^2 + iaw2 * eta^2)
//
// for the Bo output beams b (pair_u is (Bo, B, 3)) and all nodes p, never
// building the (B, B, P) intermediate.  Two kernels, one arithmetic
// (`coupling`, every operation pinned, so they agree bit for bit):
//
// gain_kernel, every (b, b'): any pair_u, and the b_out form (Bo < B).  The
// TPU kernel keeps a (B, L) block of I in VMEM and unrolls the partner loop
// over sublane rows; here one thread owns one node p and kOut output beams:
// it reads rhat/pre once, then walks the partners b' = 0..B-1 in the plain
// version's order, reading I[b', p] (neighbouring threads read neighbouring
// p: coalesced) and keeping kOut accumulators in registers.  The block's
// pair_u rows (kOut x B x 3 floats, 5.6 KB at B = 60) sit in shared memory,
// where every thread of a warp reads the same word: a broadcast.  Shared
// memory rather than __constant__ keeps the kernel free of global state and
// of a B limit.
//
// gain_pairs_kernel, each pair once: the full form (Bo = B) of the solver's
// couplings, where pair_u[b][a] = -pair_u[a][b] exactly with a zero
// diagonal.  R is odd, so R(b, a) = -R(a, b) bit for bit, and one evaluation
// serves both beams of a pair: 1,770 resonances per node at B = 60 instead
// of 3,600.  One thread owns one node and all B sums.  The beams go in tiles
// of kTile: the tile's sums and intensities sit in registers, the sums of
// the beams after the tile in a column of shared memory ([b][thread]: no
// bank conflicts, no atomics), and the lower triangle of pair_u in shared
// memory as float4, one broadcast load per pair.  For a tile (a0 ..), first
// its own pairs, then each later beam b with every a of the tile:
//   r = R(pair_u[b][a] . rhat);  sum[b] += r * I[a];  sum[a] -= r * I[b]
// Tiles ascend, b ascends and a ascends, so every sum receives its partners
// in ascending order, which is gain_kernel's order: the two kernels' outputs
// are equal bit for bit (for finite I; gain_kernel's diagonal term adds a
// zero).  I is read B / kTile times, from L1/L2 after the first.
//
// What bounds them on the card: the arithmetic.  At OMEGA (B = Bo = 60,
// P = 1e6) gain_kernel evaluates 3.6e9 resonances and gain_pairs_kernel
// 1.77e9, each an IEEE float division plus ~10 FMAs, against 240 MB of I
// (gain_kernel reads it ceil(Bo / kOut) times; L2 serves most of the
// repeats) and 240 MB written.  The division is what the pair kernel pays
// most for: nvcc guards its fast path (MUFU.RCP and five FFMAs) with an
// FCHK, a branch to a slow path and a convergence barrier around both, so a
// pair costs ~38 instruction slots where its arithmetic is ~16 operations, and
// neither the tile size nor the occupancy moves the time by more than 4 %
// (scripts/gain_sweep.py).
//
// The expression is the plain version's (eta = ux*rx + uy*ry + uz*rz, then
// acc += R * I, then * pre), in float32 with IEEE division, contracted into
// FMAs where `coupling` says so; the plain version on the card rounds each
// product, so kernel and plain version differ by that alone.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into the package's
// shared library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/gain.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 8;  // output beams per thread (register accumulators)

// The pair kernel's sizes, chosen on an H100 with scripts/gain_sweep.py.
constexpr int kPairThreads = 512;
constexpr int kPairBlocks = 1;  // blocks of an SM the registers must allow
constexpr int kTile = 20;  // beams of a tile (register sums and intensities)
// what a block may use of an SM's shared memory
constexpr long long kMaxSmemBytes = 232448;

// R(u . rhat) of one coupling u.  Every operation is an intrinsic, so no
// kernel contracts or reorders it differently: negating u negates the result
// exactly.
__device__ __forceinline__ float coupling(float ux, float uy, float uz,
                                          float rx, float ry, float rz,
                                          float iaw2) {
  const float eta = __fmaf_rn(uz, rz, __fmaf_rn(uy, ry, __fmul_rn(ux, rx)));
  const float e2 = __fmul_rn(eta, eta);
  const float m = __fsub_rn(e2, 1.f);
  return __fdiv_rn(__fmul_rn(iaw2, eta),
                   __fmaf_rn(m, m, __fmul_rn(iaw2, e2)));
}

__global__ void __launch_bounds__(kThreads)
gain_kernel(const float* __restrict__ pair_u, const float* __restrict__ rp,
            const float* __restrict__ inten, float* __restrict__ out, int bo,
            int B, long long P, float iaw2) {
  extern __shared__ float s_pair[];  // [kOut][B][3] rows b0 .. b0+kOut-1
  const int b0 = blockIdx.y * kOut;
  const int nb = min(kOut, bo - b0);
  for (int t = threadIdx.x; t < nb * B * 3; t += blockDim.x) {
    s_pair[t] = pair_u[(long long)b0 * B * 3 + t];
  }
  __syncthreads();

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float rx = rp[p], ry = rp[P + p], rz = rp[2 * P + p];
  const float pre = rp[3 * P + p];
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.f;

  for (int bp = 0; bp < B; ++bp) {
    const float ib = inten[(long long)bp * P + p];
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      if (j < nb) {
        const float* u = s_pair + (j * B + bp) * 3;
        const float r = coupling(u[0], u[1], u[2], rx, ry, rz, iaw2);
        acc[j] = __fmaf_rn(r, ib, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    if (j < nb) out[(long long)(b0 + j) * P + p] = __fmul_rn(acc[j], pre);
  }
}

// Shared memory of a gain_pairs_kernel block: the lower triangle of pair_u
// as float4, then the sums' columns.
inline long long pairs_smem_bytes(int B) {
  return (long long)B * (B - 1) / 2 * (long long)sizeof(float4) +
         (long long)B * kPairThreads * (long long)sizeof(float);
}

__global__ void __launch_bounds__(kPairThreads, kPairBlocks)
gain_pairs_kernel(const float* __restrict__ pair_u,
                  const float* __restrict__ rp,
                  const float* __restrict__ inten, float* __restrict__ out,
                  int B, long long P, float iaw2) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  // s_u[b (b - 1) / 2 + a] = pair_u[b][a] for a < b
  float4* s_u = reinterpret_cast<float4*>(s_raw);
  float* s_sum = reinterpret_cast<float*>(s_u + B * (B - 1) / 2);
  for (int t = threadIdx.x; t < B * B; t += kPairThreads) {
    const int b = t / B, a = t - b * B;
    if (a < b) {
      const float* u = pair_u + (long long)t * 3;
      s_u[b * (b - 1) / 2 + a] = make_float4(u[0], u[1], u[2], 0.f);
    }
  }
  __syncthreads();

  const long long p = (long long)blockIdx.x * kPairThreads + threadIdx.x;
  if (p >= P) return;                     // after the kernel's only barrier
  const float rx = rp[p], ry = rp[P + p], rz = rp[2 * P + p];
  const float pre = rp[3 * P + p];
  float* sum_of = s_sum + threadIdx.x;    // beam b's sum: sum_of[b * threads]

  for (int a0 = 0; a0 < B; a0 += kTile) {
    const int na = min(kTile, B - a0);
    float acc[kTile], ia[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const bool has = i < na;
      ia[i] = has ? inten[(long long)(a0 + i) * P + p] : 0.f;
      // the first tile starts every sum; later ones take up what the tiles
      // before them left
      acc[i] = has && a0 > 0 ? sum_of[(a0 + i) * kPairThreads] : 0.f;
    }
    // the tile's own pairs (a0 + i, a0 + j), i < j
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
#pragma unroll
      for (int j = i + 1; j < kTile; ++j) {
        if (j < na) {
          const int b = a0 + j;
          const float4 u = s_u[b * (b - 1) / 2 + a0 + i];
          const float r = coupling(u.x, u.y, u.z, rx, ry, rz, iaw2);
          acc[j] = __fmaf_rn(r, ia[i], acc[j]);
          acc[i] = __fmaf_rn(-r, ia[j], acc[i]);
        }
      }
    }
    // each later beam with every beam of the tile (which is then whole)
    for (int b = a0 + kTile; b < B; ++b) {
      const float ib = inten[(long long)b * P + p];
      float sb = a0 > 0 ? sum_of[b * kPairThreads] : 0.f;
      const float4* u = s_u + b * (b - 1) / 2 + a0;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const float4 v = u[i];
        const float r = coupling(v.x, v.y, v.z, rx, ry, rz, iaw2);
        sb = __fmaf_rn(r, ia[i], sb);
        acc[i] = __fmaf_rn(-r, ib, acc[i]);
      }
      sum_of[b * kPairThreads] = sb;
    }
    // the tile's beams have met every partner
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < na) out[(long long)(a0 + i) * P + p] = __fmul_rn(acc[i], pre);
    }
  }
}

}  // namespace

extern "C" {

// Each entry enqueues one launch on `stream` and returns cudaGetLastError():
// nonzero means the launch was refused.  No synchronization, no allocation.
int cbet_gain_f32(const void* pair_u, const void* rhat_pre,
                  const void* intensity, void* out, int bo, int B,
                  long long P, float iaw2, void* stream) {
  if (P <= 0 || bo <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned int)((P + kThreads - 1) / kThreads),
                  (unsigned int)((bo + kOut - 1) / kOut));
  const size_t smem = (size_t)kOut * B * 3 * sizeof(float);
  gain_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)pair_u, (const float*)rhat_pre, (const float*)intensity,
      (float*)out, bo, B, P, iaw2);
  return (int)cudaGetLastError();
}

// The most beams whose triangle and sums fit a block's shared memory.
int cbet_gain_pairs_max_beams(void) {
  int B = 1;
  while (pairs_smem_bytes(B + 1) <= kMaxSmemBytes) ++B;
  return B;
}

// The full form (pair_u (B, B, 3), antisymmetric with a zero diagonal: the
// caller checks) with each pair evaluated once; more beams than
// cbet_gain_pairs_max_beams() are refused.
int cbet_gain_pairs_f32(const void* pair_u, const void* rhat_pre,
                        const void* intensity, void* out, int B, long long P,
                        float iaw2, void* stream) {
  if (P <= 0 || B <= 0) return (int)cudaSuccess;
  const long long smem = pairs_smem_bytes(B);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel has to opt in
  const cudaError_t rc = cudaFuncSetAttribute(
      gain_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned int blocks =
      (unsigned int)((P + kPairThreads - 1) / kPairThreads);
  gain_pairs_kernel<<<blocks, kPairThreads, (size_t)smem,
                      (cudaStream_t)stream>>>(
      (const float*)pair_u, (const float*)rhat_pre, (const float*)intensity,
      (float*)out, B, P, iaw2);
  return (int)cudaGetLastError();
}

}  // extern "C"
