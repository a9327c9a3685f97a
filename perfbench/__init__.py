"""The benchmark of ``mcp_tpu_torch`` on NVIDIA GPUs (see ``run.py``)."""
