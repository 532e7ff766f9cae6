// K3: llhist scatter-add for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel veneur_tpu/ops/pallas_llhist.py:55
// `_apply_pallas` (body `_kernel` :29-48), which the JAX package dispatches
// from batch_llhist.apply_batch. It adds int32 weights at (row, bin) into
// the (K, 4608) int32 register table of the llhist family, in place:
//   regs[row, bin] += wt   for every sample with 0 <= row < K and
//                          0 <= bin < 4608; other samples are dropped.
// The Pallas kernel dropped rows outside the table (PAD_ROW padding) by
// tiling; under the installed JAX it does not trace (`pl.load` is gone),
// so what the JAX package computes is its jnp path
// `regs.at[rows, bins].add(w, mode="drop")`, which also drops bins
// outside the padded width. This kernel drops both, like that path.
//
// Bound: bytes. Each sample reads 12 bytes (row, bin, weight) and
// read-modify-writes one 4-byte register: 20 B per sample, ~164 KB for a
// full 8192-sample batch, ~0.05 us at 3.35 TB/s. At that size the launch
// itself (a few us) is the cost, not the bytes.
//
// Design: one thread per sample in a grid-stride loop, each a single
// atomicAdd on the live table. Integer atomics are exact in any order, so
// the result is bit-identical to the plain version and to the JAX package,
// wrap-around on int32 overflow included. There is no table copy (the
// Pallas kernel copied the whole table per batch because it was not
// donated) and no restriction on K (the TPU kernel needed K % 256 == 0).
// Hot keys contend on their registers' atomics; warp-aggregated or
// shared-memory-privatised adds are later work, measured first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinsPad = 4608;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
llhist_apply_kernel(int* __restrict__ regs, const int* __restrict__ rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ wts, long long n,
                    int num_keys) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const int row = rows[i];
    const int bin = bins[i];
    if (row >= 0 && row < num_keys && bin >= 0 && bin < kBinsPad) {
      atomicAdd(regs + static_cast<long long>(row) * kBinsPad + bin,
                wts[i]);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int llhist_apply(int* regs, const int* rows, const int* bins,
                            const int* wts, long long n, int num_keys,
                            void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride past 16 per SM
  llhist_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      regs, rows, bins, wts, n, num_keys);
  return static_cast<int>(cudaGetLastError());
}
