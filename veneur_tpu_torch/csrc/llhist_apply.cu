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
// Bound: bytes. Each sample's row, bin and weight are read once (12 B),
// and each distinct register it adds to is read and written once (8 B):
// a 65 536-sample ingest chunk is ~1.3 MB, ~0.4 us at 3.35 TB/s. Beside
// it stands the launch floor, 1.2-1.8 us for a one-sample launch on the
// H100 (PERF.md), which no kernel body can go below. What the design
// does:
//
//   * Launch floor: the caller packs a whole ingest chunk (65 536
//     samples and more) into one block, copies it over once and launches
//     once for it (ops/batch_llhist.py pack, core/columnstore.py
//     LLHistTable), so the floor is paid once per chunk instead of once
//     per 8192 samples. The grid is sized for
//     such a chunk: one thread per 4 samples and one warp per block, so
//     an SM issues few of the scattered atomics (an 8192-sample buffer
//     spreads over 64 blocks, a 65 536-sample chunk over 512; 128-
//     thread blocks took 0.5 us longer on the first, PERF.md),
//     capped at one wave of 32 blocks per SM with a grid-stride loop
//     past it.
//   * Bytes: each thread reads its 4 consecutive samples with one 16-byte
//     load per column. A start that is not 16-byte aligned, columns that
//     are misaligned against each other and a ragged tail are handled
//     here: the first quad may begin before the first sample, lanes
//     outside [0, n) load nothing, and when the three columns differ in
//     alignment every quad loads element by element (a packed block
//     starts its columns on 16-byte boundaries, so the path never does).
//   * Atomics: one integer atomicAdd per in-range sample, on the live
//     table (a fire-and-forget reduction in the L2). Integer adds are
//     exact in any order, so the table is bit-identical to the plain
//     version and to the JAX package, int32 wrap-around included.
//     Warp-aggregated adds (lanes grouped by register with
//     __match_any_sync, each group's weights summed with
//     __reduce_add_sync as uint32) were tried and measured slower on
//     every input (a uniform buffer, a pump chunk, hot keys and
//     sender-ordered samples; both times in PERF.md): the groups'
//     reductions run one after another, and the L2 takes repeated
//     atomics faster than that. They were taken out.
//
// No table copy (the Pallas kernel copied the whole table per batch
// because it was not donated), no restriction on K (the TPU kernel
// needed K % 256 == 0), no block-level sort: device time per sample is
// not where the time goes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinsPad = 4608;
constexpr int kThreads = 32;  // one warp
constexpr int kPerThread = 4;
constexpr long long kMaxBlocks = 132 * 32;  // 32 resident blocks per SM

// Quad q covers samples first + 4q .. first + 4q + 3. `first` is 0, or
// the (negative) start that puts every quad of an aligned launch on a
// 16-byte boundary; `vec` says the three columns share that alignment.
__global__ void __launch_bounds__(kThreads)
llhist_apply_kernel(int* __restrict__ regs, const int* __restrict__ rows,
                    const int* __restrict__ bins,
                    const int* __restrict__ wts, long long n, int num_keys,
                    long long first, long long num_quads, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       q < num_quads; q += stride) {
    const long long base = first + q * kPerThread;
    int r[kPerThread], b[kPerThread], w[kPerThread];
    if (vec && base >= 0 && base + kPerThread <= n) {
      const int4 rv = __ldg(reinterpret_cast<const int4*>(rows + base));
      const int4 bv = __ldg(reinterpret_cast<const int4*>(bins + base));
      const int4 wv = __ldg(reinterpret_cast<const int4*>(wts + base));
      r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
      b[0] = bv.x; b[1] = bv.y; b[2] = bv.z; b[3] = bv.w;
      w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const long long s = base + j;
        const bool in = s >= 0 && s < n;
        r[j] = in ? __ldg(rows + s) : -1;
        b[j] = in ? __ldg(bins + s) : 0;
        w[j] = in ? __ldg(wts + s) : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (r[j] >= 0 && r[j] < num_keys && b[j] >= 0 && b[j] < kBinsPad) {
        atomicAdd(regs + static_cast<long long>(r[j]) * kBinsPad + b[j],
                  w[j]);
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int llhist_apply(int* regs, const int* rows, const int* bins,
                            const int* wts, long long n, int num_keys,
                            void* stream) {
  if (n <= 0 || num_keys <= 0) return 0;
  // int32 columns are 4-byte aligned; `mis` is the element offset past a
  // 16-byte boundary
  const unsigned mis = (reinterpret_cast<uintptr_t>(rows) >> 2) & 3;
  const int vec = mis == ((reinterpret_cast<uintptr_t>(bins) >> 2) & 3) &&
                  mis == ((reinterpret_cast<uintptr_t>(wts) >> 2) & 3);
  const long long first = vec && mis ? -static_cast<long long>(mis) : 0;
  const long long num_quads = (n - first + kPerThread - 1) / kPerThread;
  long long blocks = (num_quads + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  llhist_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      regs, rows, bins, wts, n, num_keys, first, num_quads, vec);
  return static_cast<int>(cudaGetLastError());
}
