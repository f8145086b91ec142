"""Device time of the host-to-card and card-to-host copies in the traced
half of the window, per request."""

NAME = "copy_ms_per_request"
UNIT = "ms/request"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "entry"
MOVES = ("serve_graphs_per_s", "serve_latency_p95_ms")


def read(run):
    requests = len(run.calls(traced=True))
    if run.trace is None or not requests:
        return None
    return 1e3 * run.trace.copy_s() / requests
