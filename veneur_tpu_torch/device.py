"""Device choice for the port (the counterpart of util/jaxplatform.py).

Entry points run on the card unless the caller asks for the CPU: the
default is `cuda:0`, and a machine without a CUDA device is an error,
never a silent fall back to the CPU. `Server(cfg, device="cpu")` and the
CLI's `-device cpu` are the ways onto the CPU (the tests use them).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def pick_device(device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """Resolve the device the tables live on. None means the first CUDA
    device; a CUDA device that does not exist raises."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: -device cpu) to run the port on the CPU")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"CUDA device {index} does not exist "
                               f"({torch.cuda.device_count()} visible)")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type: {dev.type!r}")
    return dev
