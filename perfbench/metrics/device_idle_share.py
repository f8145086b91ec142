"""The share of the time the program was at work in the traced half of
the window (inside the benchmark's spans: a batch fetch and its step, or
a request from its call to its answer) in which no kernel, copy or memset
ran on the card, in percent. The wait of an open loop for its next due
request is not the program's, and is left out."""

NAME = "device_idle_share"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = ("train_graphs_per_s", "serve_graphs_per_s", "serve_latency_p95_ms")


def read(run):
    if run.trace is None:
        return None
    spans = [(sp.t0, sp.t1) for sp in run.part(traced=True)]
    total = sum(t1 - t0 for t0, t1 in spans) * 1e-9
    if total <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_within(spans) / total)
