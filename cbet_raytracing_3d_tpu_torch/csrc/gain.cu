// CBET gain reduction over beam pairs.
//
// Replaces the TPU kernel cbet_raytracing_3d_tpu/ops/pallas_gain.py::
// make_gain_kernel (body _gain_kernel), including its b_out form:
//
//   g[b, p] = pre[p] * sum_{b'} R(pair_u[b, b'] . rhat[:, p]) * I[b', p]
//   R(eta)  = iaw2 * eta / ((eta^2 - 1)^2 + iaw2 * eta^2)
//
// for the Bo output beams b (pair_u is (Bo, B, 3)) and all nodes p, never
// building the (B, B, P) intermediate.  The TPU kernel keeps a (B, L) block
// of I in VMEM and unrolls the partner loop over sublane rows; here one
// thread owns one node p and kOut output beams: it reads rhat/pre once,
// then walks the partners b' = 0..B-1 in the plain version's order, reading
// I[b', p] (neighbouring threads read neighbouring p: coalesced) and keeping
// kOut accumulators in registers.  The block's pair_u rows (kOut x B x 3
// floats, 5.6 KB at B = 60) sit in shared memory, where every thread of a
// warp reads the same word: a broadcast.  Shared memory rather than
// __constant__ keeps the kernel free of global state and of a B limit.
//
// What bounds it on the card: the arithmetic.  At OMEGA (B = Bo = 60,
// P = 1e6) it evaluates 3.6e9 resonances, each an IEEE float division plus
// ~10 FMAs, against 240 MB of I read ceil(Bo / kOut) times (L2 serves most
// of the repeats) and 240 MB written.
//
// The expression is the plain version's (eta = ux*rx + uy*ry + uz*rz, then
// acc += R * I, then * pre), in float32 with IEEE division.  nvcc contracts
// a*b + c into FMAs (default -fmad=true); the plain version on the card
// rounds each product, so kernel and plain version differ by that alone.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into the package's
// shared library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/gain.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 8;  // output beams per thread (register accumulators)

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
        const float eta = u[0] * rx + u[1] * ry + u[2] * rz;
        const float e2 = eta * eta;
        const float m = e2 - 1.f;
        const float r = (iaw2 * eta) / (m * m + iaw2 * e2);
        acc[j] += r * ib;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    if (j < nb) out[(long long)(b0 + j) * P + p] = acc[j] * pre;
  }
}

}  // namespace

extern "C" {

// Enqueues one launch on `stream` and returns cudaGetLastError(): nonzero
// means the launch was refused.  No synchronization, no allocation.
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

}  // extern "C"
