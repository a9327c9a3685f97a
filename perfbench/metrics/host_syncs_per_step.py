"""Host synchronizations (cudaStreamSynchronize, cudaDeviceSynchronize)
inside the calls, per Newton step."""

from perfbench.metrics_common import steps


def read(trace, ctx):
    n = steps(trace)
    return trace.syncs_in_calls / n if n else None
