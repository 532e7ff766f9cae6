"""State carried across: the JAX package's table state, as numpy arrays,
to the port's tensors on a device, and back.

The layouts are the same in both packages, one family at a time:

  counter    {"sum", "comp"}           (K,) float32 Kahan pair
  gauge      {"value", "set"}          (K,) float32 / bool
  histogram  batch_tdigest state dict  (K, C) float32 grids + (K,) stats
  set        HLL registers             (D, 16384) int8
  llhist     log-linear registers      (K, 4608) int32

so a conversion is a checked copy. Give the JAX side as
`{k: np.asarray(v) for k, v in state.items()}` (or `np.asarray(regs)`).
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from veneur_tpu_torch.ops import batch_hll, batch_llhist, batch_tdigest

_F32 = np.dtype(np.float32)

# family -> {key: (dtype, trailing shape)}
LAYOUTS = {
    "counter": {"sum": (_F32, ()), "comp": (_F32, ())},
    "gauge": {"value": (_F32, ()), "set": (np.dtype(bool), ())},
    "histogram": {**{k: (_F32, (batch_tdigest.C,))
                     for k in batch_tdigest.GRIDS},
                  **{k: (_F32, ()) for k in batch_tdigest.SCALAR_INIT}},
}
# the families whose state is one register array
_REGISTERS = {"set": (np.dtype(np.int8), (batch_hll.M,)),
              "llhist": (np.dtype(np.int32), (batch_llhist.BINS_PAD,))}

State = Union[Dict[str, np.ndarray], np.ndarray]


def _check(family: str, key: str, array: np.ndarray, dtype, trailing,
           num_keys: int) -> None:
    if array.dtype != dtype:
        raise TypeError(f"{family} state {key!r}: dtype {array.dtype}, "
                        f"expected {dtype}")
    if array.shape != (num_keys,) + trailing:
        raise ValueError(f"{family} state {key!r}: shape {array.shape}, "
                         f"expected {(num_keys,) + trailing}")


def state_from_numpy(family: str, state: State, device) -> Union[
        Dict[str, torch.Tensor], torch.Tensor]:
    """The port's state of `family` on `device`, copied from the JAX
    package's state given as numpy arrays. Raises on a missing or extra
    key, a wrong dtype, or a shape that does not fit the family."""
    if family in _REGISTERS:
        regs = np.asarray(state)
        _check(family, "registers", regs, *_REGISTERS[family],
               regs.shape[0])
        return torch.from_numpy(regs.copy()).to(device)
    layout = LAYOUTS[family]
    if set(state) != set(layout):
        raise ValueError(f"{family} state keys {sorted(state)}, expected "
                         f"{sorted(layout)}")
    num_keys = np.asarray(next(iter(state.values()))).shape[0]
    out = {}
    for key, (dtype, trailing) in layout.items():
        array = np.asarray(state[key])
        _check(family, key, array, dtype, trailing, num_keys)
        out[key] = torch.from_numpy(array.copy()).to(device)
    return out


def state_to_numpy(family: str, state) -> State:
    """The port's state of `family` as numpy arrays in the JAX package's
    layout (host copies that share no memory with the tensors)."""
    if family in _REGISTERS:
        return state.detach().to("cpu", copy=True).numpy()
    return {k: state[k].detach().to("cpu", copy=True).numpy()
            for k in LAYOUTS[family]}
