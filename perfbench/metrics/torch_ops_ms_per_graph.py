"""Device time of every kernel that is not one of the port's K1-K9 (the
torch ops of the model and its layers), per graph of the traced half of
the window."""

from perfbench.harness import KERNELS

NAME = "torch_ops_ms_per_graph"
UNIT = "ms/graph"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "model and layer"
MOVES = ("train_graphs_per_s", "serve_graphs_per_s", "serve_latency_p95_ms")


def read(run):
    graphs = sum(sp.graphs for sp in run.calls(traced=True))
    if run.trace is None or not graphs:
        return None
    return 1e3 * run.trace.other_kernel_s(KERNELS) / graphs
