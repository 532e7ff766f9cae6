// K2: HyperLogLog LogLog-Beta estimate for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel veneur_tpu/ops/pallas_hll.py
// `_estimate_pallas` (per-tile body `_estimate_block`), which the JAX
// package dispatches from batch_hll.estimate. Input: registers (D, 16384)
// int8. Output: (D,) float32 estimates. Per row: the zero-register count
// ez and s = sum 2^-reg, then LogLog-Beta (hyperloglog.go:207-231)
//   beta = BETA14_EZ*ez + sum_i c_i*log(ez+1)^(i+1)
//   est  = floor(alpha*M * (M - ez) / (beta + s) + 1), 0 where ez == M.
//
// Bound: bytes. The kernel must read D*16384 bytes and write D*4; per
// register it does a compare, a table-free power of two and an add. At
// D = 16 384 that is ~268 MB, ~80 us at 3.35 TB/s.
//
// Design: one 256-thread block per row. Each thread reads four 16-byte
// vectors, neighbouring threads on neighbouring addresses, so a warp
// reads 512 contiguous bytes per instruction and every register byte is
// read once. The zero count is an integer. Each 2^-r is built exactly as
// a double from its exponent bits and summed in double, so s is the exact
// sum to within 2^-39 relative whatever the reduction order; the plain
// PyTorch version (ops/hll_estimate.py) sums the same exact terms in
// double, and both round s to float32 once. Warp shuffles and one shared
// array reduce across the block. Thread 0 then evaluates the tail in
// float32, op for op as batch_hll._estimate_jnp does (lax.integer_pow's
// binary powers, the constants rounded from double to float), so the
// kernel and its plain version agree bit for bit unless the two double
// sums round to different floats.

#include <cuda_runtime.h>

namespace {

constexpr int kM = 16384;
constexpr int kThreads = 256;
constexpr int kVecPerThread = kM / 16 / kThreads;  // 4
constexpr unsigned kFullMask = 0xffffffffu;

// constants exactly as the JAX package forms them: Python doubles,
// rounded to float32 where they meet a float32 array
constexpr double kAlphaD = 0.7213 / (1.0 + 1.079 / kM);
__constant__ float kAlphaM = static_cast<float>(kAlphaD * kM);
__constant__ float kBetaEz = static_cast<float>(-0.370393911);
__constant__ float kBeta[7] = {
    static_cast<float>(0.070471823), static_cast<float>(0.17393686),
    static_cast<float>(0.16339839), static_cast<float>(-0.09237745),
    static_cast<float>(0.03738027), static_cast<float>(-0.005384159),
    static_cast<float>(0.00042419)};

__device__ __forceinline__ double pow2_neg(int r) {
  // 2^-r for any int8 r, exactly: the biased exponent 1023 - r
  return __longlong_as_double(static_cast<long long>(1023 - r) << 52);
}

__device__ __forceinline__ void accumulate(int word, int& zeros,
                                           double& s) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = static_cast<signed char>((word >> (8 * k)) & 0xff);
    zeros += r == 0;
    s += pow2_neg(r);
  }
}

// x^y as lax.integer_pow evaluates it (binary exponentiation, acc * x)
__device__ __forceinline__ float integer_pow(float x, int y) {
  float acc = 0.0f;
  bool have = false;
  while (y > 0) {
    if (y & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    y >>= 1;
    if (y > 0) x = x * x;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
hll_estimate_kernel(const signed char* __restrict__ regs,
                    float* __restrict__ out) {
  const long long row = blockIdx.x;
  const int4* vec = reinterpret_cast<const int4*>(regs + row * kM);
  int zeros = 0;
  double s = 0.0;
#pragma unroll
  for (int it = 0; it < kVecPerThread; ++it) {
    const int4 v = vec[it * kThreads + threadIdx.x];
    accumulate(v.x, zeros, s);
    accumulate(v.y, zeros, s);
    accumulate(v.z, zeros, s);
    accumulate(v.w, zeros, s);
  }
  zeros = __reduce_add_sync(kFullMask, zeros);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFullMask, s, off);
  }
  __shared__ int s_zeros[kThreads / 32];
  __shared__ double s_sum[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_zeros[warp] = zeros;
    s_sum[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int ez_i = 0;
  double sum = 0.0;
  for (int i = 0; i < kThreads / 32; ++i) {
    ez_i += s_zeros[i];
    sum += s_sum[i];
  }
  const float ez = static_cast<float>(ez_i);
  const float sf = static_cast<float>(sum);
  const float zl = logf(ez + 1.0f);
  float beta = kBetaEz * ez;
#pragma unroll
  for (int i = 0; i < 7; ++i) beta = beta + kBeta[i] * integer_pow(zl, i + 1);
  const float est =
      floorf(kAlphaM * (static_cast<float>(kM) - ez) / (beta + sf) + 1.0f);
  out[row] = ez >= static_cast<float>(kM) ? 0.0f : est;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int hll_estimate(const signed char* regs, float* out,
                            int num_rows, void* stream) {
  if (num_rows <= 0) return 0;
  hll_estimate_kernel<<<num_rows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(regs, out);
  return static_cast<int>(cudaGetLastError());
}
