"""The port's kernels K1-K9 against their rooflines in the traced half of
the window: the least time their launches could take (each launch's
frozen bytes and operations at its shapes, over the card's published
rates) over the device time of every kernel they launched, in percent."""

from perfbench import counts
from perfbench.harness import KERNELS

NAME = "kernel_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = ("train_graphs_per_s", "serve_graphs_per_s", "serve_latency_p95_ms")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    spent = run.trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    bound = 0.0
    for sp in run.calls(traced=True):
        for k, n in sp.launches.items():
            work = counts.launch_work(k, run.model, sp.batch, sp.pad,
                                      run.mode == "train", run.bf16)
            bound += n * work.bound_s(run.peaks, run.bf16)
    return 100.0 * bound / spent
