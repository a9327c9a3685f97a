"""Device selection and device-resident constants.

Entry points take ``device=`` (default ``"cuda"``) and never fall back to the
CPU: a CUDA request on a machine without a GPU raises. Constants that the
model functions close over (dynamics matrices, halfspaces, index maps) are
host numpy arrays; ``const`` converts each one once per (dtype, device), so
a residual evaluation on the card issues no host-to-device copy (a pageable
copy synchronises the stream). ``matmul_precision`` sets the precision of
float32 matrix products for a block of code, as ``jax.default_matmul_precision``
does.
"""

from __future__ import annotations

import contextlib

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


#: The JAX package's ``matmul_precision`` names → the argument of
#: ``torch.set_float32_matmul_precision``: full float32, TF32, or bf16
#: passes (the fewest bits, as a TPU's default).
MATMUL_PRECISIONS = {
    "highest": "highest", "float32": "highest",
    "high": "high", "tensorfloat32": "high",
    "default": "medium", "bfloat16": "medium",
}


def _apply_precision(precision: str, cublas_tf32: bool, cudnn_tf32: bool) -> None:
    # The TF32 flags first: the precision setter then has the last word, so
    # the flags and the precision never read as a mix of torch's two APIs.
    torch.backends.cuda.matmul.allow_tf32 = cublas_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(precision)


@contextlib.contextmanager
def matmul_precision(name: str):
    """Run the block with float32 matrix products at the JAX package's
    precision ``name`` (a key of ``MATMUL_PRECISIONS``): it sets
    ``torch.backends.cuda.matmul.allow_tf32``, ``torch.backends.cudnn.allow_tf32``
    and ``torch.set_float32_matmul_precision``, and restores all three on
    exit, by an exception too. Unknown names raise ``ValueError``."""
    try:
        precision = MATMUL_PRECISIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown matmul_precision {name!r}; expected one of {sorted(MATMUL_PRECISIONS)}"
        ) from None
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    reduced = precision != "highest"
    _apply_precision(precision, reduced, reduced)
    try:
        yield
    finally:
        _apply_precision(*before)
