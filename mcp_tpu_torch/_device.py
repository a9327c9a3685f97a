"""Device selection and device-resident constants.

Entry points take ``device=`` (default ``"cuda"``) and never fall back to the
CPU: a CUDA request on a machine without a GPU raises. Constants that the
model functions close over (dynamics matrices, halfspaces, index maps) are
host numpy arrays; ``const`` converts each one once per (dtype, device), so
a residual evaluation on the card issues no host-to-device copy (a pageable
copy synchronises the stream).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


# (id(array), dtype, device) -> (array, tensor). Holding the array keeps its
# id from being reused while the entry lives.
_CONSTS: dict = {}


def const(array, dtype, device) -> torch.Tensor:
    """The host array ``array`` as a tensor of ``dtype`` on ``device``,
    converted on first use and cached."""
    key = (id(array), dtype, str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        t = torch.as_tensor(np.asarray(array)).to(device=device, dtype=dtype)
        hit = _CONSTS[key] = (array, t)
    return hit[1]
