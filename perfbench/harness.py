"""What every cell shares: finding its files by name, the run's record
(spans, counters, the device trace), the per-layer metrics' readers, and
the result line.

A cell is `workloads/<cell>.json`: its configuration's name, its mode
(`train` or `serve`), its traffic (the parameters the generator in
`traffic/` reads), the chips it needs, the end-to-end metrics it reports
besides `setup_s`, why it exists, who sends such traffic, and the limits
of the numbers that decide `correct`. A
configuration is `configs/<config>.json`: the run config as it is run,
each key changed from its source and why, what was reduced or assumed,
the deployment it stands for, and the reference model's settings. A
per-layer metric is `metrics/<metric>.py`: its name, unit, whether higher
or lower is better, source, layer, `MOVES` (the end-to-end metrics it can
move) and `read(run)`, which returns a number or None when the run has
nothing to read. It is read in every cell that reports one of `MOVES`,
and reported there as `<name>.<that end-to-end metric>`. An end-to-end
metric `<metric>.<qualifier>` is the mode's `<metric>` under a name (and a
bound) of the cell's own; the metrics that move it are matched by
`<metric>`. `python3 -m perfbench.harness` prints the `per_layer` list of
`BENCHMARK.json` that these files and the cells give.
"""

from __future__ import annotations

import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the benchmark's spans around the program's timed calls
CALLS = ("train_into", "predict")
# device kernels of the port's CUDA sources (csrc/), by name
KERNELS = ("egt_attention_fwd", "egt_attention_bwd", "fused_layer_fwd",
           "tail_bwd", "bwd_attn", "mono_head", "edge_block_fwd",
           "sum_partials")

# the port's kernels as the launch counters name them: module, attribute
KERNEL_COUNTERS = {
    "K1": ("egt_torch.ops.egt_attention", "KERNEL"),
    "K2": ("egt_torch.ops.egt_attention", "BWD_KERNEL"),
    "K3": ("egt_torch.ops.fused_layer", "KERNEL"),
    "K4": ("egt_torch.ops.fused_layer", "BWD_TAIL_KERNEL"),
    "K5": ("egt_torch.ops.fused_layer", "BWD_ATTN_KERNEL"),
    "K6": ("egt_torch.ops.fused_layer", "BWD_MONO_KERNEL"),
    "K7": ("egt_torch.ops.fused_layer", "BWD_MERGED_KERNEL"),
    "K8": ("egt_torch.ops.edge_block", "KERNEL"),
    "K9": ("egt_torch.ops.edge_block", "BWD_KERNEL"),
}


def load_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


@dataclass
class Cell:
    name: str
    spec: dict           # the cell's file
    config: dict         # its configuration's file

    @property
    def mode(self) -> str:
        return self.spec["mode"]

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "workloads" / f"{name}.json")
    if spec["mode"] not in ("train", "serve"):
        raise ValueError(f"{name}: mode must be train or serve")
    config = load_json(root / "configs" / f"{spec['config']}.json")
    return Cell(name, spec, config)


@dataclass
class Metric:
    name: str            # as reported: <file's NAME>.<end-to-end metric>
    unit: str
    better: str
    source: str
    layer: str
    moves: str
    read: object


def _metric_modules(root: Path):
    for path in sorted((root / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{path.stem.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod


def load_metrics(end_to_end, root: Path = ROOT) -> list[Metric]:
    """The per-layer metrics of a cell that reports `end_to_end`: each
    metric file once for each of these that it moves."""
    out = []
    for mod in _metric_modules(root):
        for e2e in end_to_end:
            if e2e.split(".")[0] in mod.MOVES:
                out.append(Metric(f"{mod.NAME}.{e2e}", mod.UNIT, mod.BETTER,
                                  mod.SOURCE, mod.LAYER, e2e, mod.read))
    return out


def per_layer_entries(root: Path = ROOT) -> list[dict]:
    """`BENCHMARK.json`'s `per_layer`: every metric of every cell, with
    the cells that report it."""
    entries = {}
    for path in sorted((root / "workloads").glob("*.json")):
        cell = path.name[:-len(".json")]
        for m in load_metrics(load_json(path)["end_to_end"], root):
            e = entries.setdefault(m.name, {
                "name": m.name, "unit": m.unit, "better": m.better,
                "source": m.source, "layer": m.layer, "moves": m.moves,
                "workloads": []})
            e["workloads"].append(cell)
    return [entries[k] for k in sorted(entries)]


@dataclass
class Span:
    name: str
    t0: int              # perf_counter_ns
    t1: int
    graphs: int = 0
    pad: int = 0         # rows a graph, virtual nodes included
    batch: int = 0       # graphs a launch
    launches: dict = field(default_factory=dict)


class Spans:
    """Spans the benchmark records around its calls into the program."""

    def __init__(self, counters: dict | None = None):
        self.items: list[Span] = []
        self.counters = counters or {}

    def launches(self) -> dict:
        return {k: c.launches for k, c in self.counters.items()}

    def run(self, name, fn, graphs=0, pad=0, batch=0):
        before = self.launches()
        t0 = time.perf_counter_ns()
        out = fn()
        t1 = time.perf_counter_ns()
        after = self.launches()
        self.items.append(Span(name, t0, t1, graphs, pad, batch,
                               {k: after[k] - before[k] for k in after
                                if after[k] != before[k]}))
        return out


def kernel_counters() -> dict:
    out = {}
    for k, (mod, attr) in KERNEL_COUNTERS.items():
        out[k] = getattr(importlib.import_module(mod), attr)
    return out


@dataclass
class Run:
    """What the per-layer metrics read. Under `--trace 1` the window's
    first half is not traced (the rates that the profiler's own cost would
    slow) and its second half is (the device); `split_ns` is where the
    traced half starts, None without a trace."""
    mode: str
    model: dict              # the reference's settings (widths, heights)
    bf16: bool
    peaks: tuple | None      # (bytes/s, bf16 FLOP/s, f32 FLOP/s)
    t0_ns: int               # the window, perf_counter ns
    t1_ns: int
    spans: list
    split_ns: int | None = None
    wait_s: float | None = None   # the feed's wait in the untraced part
    trace: object = None     # `trace.Summary` of the traced part

    @property
    def untraced_s(self) -> float:
        return ((self.split_ns or self.t1_ns) - self.t0_ns) * 1e-9

    def part(self, traced: bool) -> list:
        """The spans of the traced or the untraced part of the window."""
        if self.split_ns is None:
            return [] if traced else list(self.spans)
        return [sp for sp in self.spans
                if (sp.t0 >= self.split_ns) == traced]

    def calls(self, traced: bool) -> list:
        return [sp for sp in self.part(traced) if sp.name in CALLS]


if __name__ == "__main__":
    print(json.dumps(per_layer_entries(), indent=1))
