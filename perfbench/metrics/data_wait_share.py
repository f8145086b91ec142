"""The share of the untraced half of the window that the training loop
spent waiting for its next batch (the feed's `Prefetcher.waited`), in
percent."""

NAME = "data_wait_share"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "data"
MOVES = ("train_graphs_per_s",)


def read(run):
    if run.wait_s is None or run.untraced_s <= 0:
        return None
    return 100.0 * run.wait_s / run.untraced_s
