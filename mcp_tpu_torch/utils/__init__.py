"""Utility modules: double-word arithmetic (``twofloat``) and the device
helpers (``devices``). The program's tracing is ``mcp_tpu_torch.telemetry``."""
