"""The yardstick of the kernels' roofline shares: operations and bytes counted
from shapes (``counts``), the card's published peaks, and a table that maps
each kernel to the pattern of its device-side names and to its count
(``kernels.json``)."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

from . import counts

KERNELS = json.loads((Path(__file__).resolve().parent / "kernels.json").read_text())


ITEMSIZE = {"float32": 4, "float64": 8}


def launch_bound_s(kernel: str, batch: int, shape: dict, dtype: str) -> float:
    """The least seconds one launch of ``kernel`` could take at ``batch``
    lanes, the configuration's ``shape`` (``kernel_shapes`` in its file)
    and ``dtype``: the larger of its bytes over peak bandwidth and its
    operations over the dtype's peak rate."""
    count = getattr(counts, KERNELS[kernel]["counts"])
    nbytes, flops = count(batch, **shape, itemsize=ITEMSIZE[dtype])
    return counts.bound_s(nbytes, flops, dtype)


def kernel_roofline(kernel: str, trace, ctx) -> Optional[float]:
    """Percent of the roofline reached over every launch of ``kernel`` in the
    traced calls: Σ bound / Σ device time. None where the configuration
    does not run the kernel or no launch was recorded."""
    shape = ctx.config.get("kernel_shapes", {}).get(kernel)
    if shape is None:
        return None
    pattern = re.compile(KERNELS[kernel]["pattern"])
    launches = [k for k in trace.kernels if pattern.search(k.name)]
    device_s = sum(k.end_s - k.start_s for k in launches)
    if not launches or device_s <= 0.0:
        return None
    return 100.0 * len(launches) * launch_bound_s(kernel, ctx.batch, shape,
                                                  ctx.config["dtype"]) / device_s
