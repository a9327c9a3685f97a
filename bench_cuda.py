#!/usr/bin/env python3
"""Benchmark entry point of the PyTorch/CUDA port: batched MCP solves/s on
one CUDA card, the counterpart of bench.py.

    python3 bench_cuda.py                      # lane change, streamed
    python3 bench_cuda.py --suite qp           # random QPs, streamed
    python3 bench_cuda.py --suite warm         # warm-started θ sweep
    python3 bench_cuda.py --suite qp --dw      # double-word tol-1e-6 QP row
    python3 bench_cuda.py --cpu --quick        # on the CPU, a tiny batch

Prints one JSON object as its last line; see mcp_tpu_torch/bench/main.py.
"""

import sys

from mcp_tpu_torch.bench.main import main

if __name__ == "__main__":
    sys.exit(main())
