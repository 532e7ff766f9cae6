"""veneur_tpu_torch: the PyTorch/CUDA port of veneur_tpu.

The port runs the local server's aggregation loop (counters, gauges,
t-digest timers/histograms, HLL sets) with its tables as torch tensors on
an NVIDIA GPU, and the flush-time t-digest interpolation and HLL estimate
as hand-written CUDA kernels (csrc/). It imports nothing from the JAX
package `veneur_tpu`, which stays the reference it is tested against.
"""

__version__ = "0.1.0"
