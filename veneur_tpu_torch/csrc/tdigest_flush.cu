// K1: t-digest flush interpolation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel veneur_tpu/ops/pallas_tdigest.py
// `_flush_pallas` (per-tile body `_flush_block`). Input: per-row
// mean-sorted centroid means `sm` and weights `sw`, (K, W) float32 with W
// in {128, 256}; the per-key scalars `scal` (K, 8) in the order
// dmin dmax drecip lmin lmax lsum lweight lrecip; the percentiles `ps`
// (P <= 16). Output: (K, P + 10) float32 rows — the P quantiles, then
// count sum min max hmean lmin lmax lsum lweight lrecip. It computes
// exactly what the JAX package's _quantiles_from_sorted + _flush_outputs
// + _pack_flush compute (merging_digest.go:302-332 interpolation).
//
// Bound: bytes. The kernel must read K*W*8 bytes of centroids and K*32 of
// scalars and write K*(P+10)*4; its arithmetic is a few operations per
// byte. At K = 100 000, W = 256, P = 3 that is ~213 MB, ~64 us at
// 3.35 TB/s.
//
// Design: one warp per row, eight rows per 256-thread block, so blocks
// are independent and a ragged K needs only a per-warp bounds check. Each
// lane loads its W/32 consecutive slots of sm and sw with 16-byte vector
// loads (a warp reads each row's 1 KB of means and of weights in two
// instructions), so every input byte is read from device memory once.
// The running cumsum is a per-lane serial scan plus a warp-shuffle
// exclusive scan of the lane totals. The slot count n, the weighted sum
// and each percentile's i* = #(cum < p * tot) are warp reductions of
// per-lane counts (the TPU's compare-count, with no (K, P, W) cube). The
// means, weights and cumsum then go to shared memory, and lane p reads
// its selected centroid and the neighbouring means directly: the TPU's
// one-hot selection was a workaround for the lack of a gather. Lanes
// P..P+9 write the scalar tail, so each output row is one coalesced
// store. No synchronisation wider than a warp is needed.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kScalarsIn = 8;
constexpr int kScalarsOut = 10;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

// upper bound of slot j: dmax at the last weighted slot, else the midpoint
// of this mean and the next (the next of the last slot is 0, as the JAX
// package pads next_m with zeros)
template <int W>
__device__ __forceinline__ float upper_bound(const float* m, int j, int n,
                                             float dmax) {
  if (j == n - 1) return dmax;
  const float next = j + 1 < W ? m[j + 1] : 0.0f;
  return (next + m[j]) * 0.5f;
}

template <int E>  // slots per lane; W = 32 * E
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
tdigest_flush_kernel(const float* __restrict__ sm,
                     const float* __restrict__ sw,
                     const float* __restrict__ scal,
                     const float* __restrict__ ps,
                     float* __restrict__ out, int num_keys, int num_ps) {
  constexpr int W = 32 * E;
  static_assert(E % 4 == 0, "each lane loads its slots as float4");
  __shared__ float s_m[kWarpsPerBlock][W];
  __shared__ float s_w[kWarpsPerBlock][W];
  __shared__ float s_c[kWarpsPerBlock][W];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= num_keys) return;  // uniform across the warp

  const float* mrow = sm + row * W + lane * E;
  const float* wrow = sw + row * W + lane * E;
  float m[E], w[E], c[E];
#pragma unroll
  for (int v = 0; v < E / 4; ++v) {
    const float4 a = reinterpret_cast<const float4*>(mrow)[v];
    const float4 b = reinterpret_cast<const float4*>(wrow)[v];
    m[4 * v] = a.x; m[4 * v + 1] = a.y; m[4 * v + 2] = a.z; m[4 * v + 3] = a.w;
    w[4 * v] = b.x; w[4 * v + 1] = b.y; w[4 * v + 2] = b.z; w[4 * v + 3] = b.w;
  }

  // running cumsum: serial within the lane, exclusive scan across lanes
  float run = 0.0f, wm = 0.0f;
  int nz = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += w[e];
    c[e] = run;
    nz += w[e] > 0.0f;
    wm += m[e] * w[e];
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += up;
  }
  float excl = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    c[e] = excl + c[e];
    s_m[warp][lane * E + e] = m[e];
    s_w[warp][lane * E + e] = w[e];
    s_c[warp][lane * E + e] = c[e];
  }
  const float tot = __shfl_sync(kFullMask, c[E - 1], 31);
  const int n = __reduce_add_sync(kFullMask, nz);
  const float dsum = warp_sum(wm);
  __syncwarp();

  const float* srow = scal + row * kScalarsIn;
  const float dmin = srow[0], dmax = srow[1], drecip = srow[2];
  const int last = n > 0 ? n - 1 : 0;
  int my_i = 0;
  float my_qt = 0.0f;
  for (int p = 0; p < num_ps; ++p) {
    const float qt = ps[p] * tot;
    int below = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) below += c[e] < qt;
    below = __reduce_add_sync(kFullMask, below);
    if (lane == p) {
      my_i = below < last ? below : last;
      my_qt = qt;
    }
  }

  float* orow = out + row * (num_ps + kScalarsOut);
  if (lane < num_ps) {
    const float* rm = s_m[warp];
    const int i = my_i;
    const float wi = s_w[warp][i];
    const float ci = s_c[warp][i];
    const float ub = upper_bound<W>(rm, i, n, dmax);
    const float lb = i == 0 ? dmin : upper_bound<W>(rm, i - 1, n, dmax);
    const float prop = (my_qt - (ci - wi)) / fmaxf(wi, 1e-30f);
    const float q = lb + prop * (ub - lb);
    orow[lane] = n > 0 ? q : __int_as_float(0x7fc00000);
  } else if (lane < num_ps + kScalarsOut) {
    const int k = lane - num_ps;
    float v;
    switch (k) {
      case 0: v = tot; break;
      case 1: v = dsum; break;
      case 2: v = dmin; break;
      case 3: v = dmax; break;
      case 4: v = drecip != 0.0f ? tot / drecip : __int_as_float(0x7fc00000);
        break;
      default: v = srow[k - 2]; break;  // lmin lmax lsum lweight lrecip
    }
    orow[lane] = v;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tdigest_flush(const float* sm, const float* sw,
                             const float* scal, const float* ps, float* out,
                             int num_keys, int width, int num_ps,
                             void* stream) {
  if (num_keys <= 0) return 0;
  const dim3 grid((num_keys + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 128:
      tdigest_flush_kernel<4><<<grid, block, 0, s>>>(sm, sw, scal, ps, out,
                                                     num_keys, num_ps);
      break;
    case 256:
      tdigest_flush_kernel<8><<<grid, block, 0, s>>>(sm, sw, scal, ps, out,
                                                     num_keys, num_ps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
