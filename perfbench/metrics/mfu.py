"""The whole step's share of the card's peak: the model's FLOPs (matrix
and attention products of the forward at each batch's pad, virtual nodes
included; three times that for a training step) of the graphs that the
untraced half of the window's calls into the program handled, over the
seconds of those calls and the card's published dense peak, in percent.
Over the calls and not the window, so that a cell offered a fixed rate
reads the program and not the offered load; in the untraced half, so that
the profiler's own cost does not slow it."""

from perfbench import counts

NAME = "mfu"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "step"
MOVES = ("train_graphs_per_s", "serve_graphs_per_s", "serve_latency_p95_ms")


def read(run):
    if run.peaks is None:
        return None
    calls = run.calls(traced=False)
    busy = sum(sp.t1 - sp.t0 for sp in calls) * 1e-9
    if busy <= 0:
        return None
    mult = 3.0 if run.mode == "train" else 1.0
    flops = sum(sp.graphs * mult * counts.forward_flops_per_graph(run.model,
                                                                   sp.pad)
                for sp in calls)
    peak = run.peaks[1] if run.bf16 else run.peaks[2]
    return 100.0 * flops / busy / peak
