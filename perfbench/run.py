"""Run one benchmark cell once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (`egt_torch/`). The
cell's files (`workloads/<cell>.json`, its `configs/<config>.json`) and
the per-layer metrics (`metrics/*.py`) are found by name. The run needs
as many CUDA devices as the cell asks for and exits with an error, with
no result, otherwise. Set-up (imports, kernel builds, weights, corpus,
model, warm-up) is timed apart and printed on standard error; then the
window measures for `--seconds`, with the card traced under `--trace 1`;
then the reference checks what the window's path produced. The last
lines of standard error give each number compared with its limit, and the
last line of standard output is the result, a JSON object whose last key,
`checks`, repeats them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "egt_tpu")
CHECKOUT = Path(__file__).resolve().parents[1]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """One run: its cell, seeds, device, set-up timings and window."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        import numpy as np
        import torch

        from .reference import rng

        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = bool(trace) and device.type == "cuda"
        self.device = torch.device(device)
        self.cfg_seed = self.seed % 2 ** 62
        self.weight_seed = rng.fold_seed(self.cfg_seed, 1)
        self._np = np
        self.cleanup = []
        self.parts: dict[str, float] = {}
        self._last = T_START
        self.bf16 = cell.config["run_config"].get(
            "compute_dtype", "bfloat16") == "bfloat16"
        self.peaks = None
        if self.device.type == "cuda":
            from .counts import card_peaks
            self.peaks = card_peaks(torch.cuda.get_device_name(0))

    def log(self, msg: str) -> None:
        _log(msg)

    def traffic_rng(self):
        return self._np.random.default_rng([self.cfg_seed, 2])

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._last
        self._last = now

    @contextlib.contextmanager
    def phase(self, name: str):
        self.lap("other")
        yield
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()
        self.lap(name)

    def start_window(self) -> float:
        """Ends set-up; returns the window's start (perf_counter s)."""
        import torch
        self.lap("other")
        self.setup_s = time.perf_counter() - T_START
        split = ", ".join(f"{k} {v:.3f}" for k, v in self.parts.items())
        self.log(f"setup_s {self.setup_s:.3f}: {split}")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.tracer = self.split_ns = None
        self.t0_ns = time.perf_counter_ns()
        return self.t0_ns * 1e-9

    def tick(self) -> bool:
        """Between calls: under `--trace 1`, start tracing the card once
        half the window has passed (the card drained first). True when it
        started now."""
        if (not self.trace or self.tracer is not None
                or time.perf_counter_ns() - self.t0_ns
                < self.seconds * 5e8):
            return False
        from .trace import DeviceTrace
        self.tracer = DeviceTrace()
        self.tracer.start()
        self.split_ns = self.tracer.t0
        return True

    def end_window(self):
        """Waits for the card; returns (the trace's `Summary` or None, the
        window's end in perf_counter ns)."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t1_ns = time.perf_counter_ns()
        return (None if self.tracer is None else self.tracer.stop()), t1_ns


def build(cell) -> None:
    """Build the cell's kernels and the native batch assembler."""
    from egt_torch import native
    from egt_torch.ops import _cuda

    logs = _cuda.build(cell.config.get("kernel_sources", []))
    if logs:
        _log(f"built {', '.join(logs)}")
    if cell.mode == "train":
        native.available()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = harness.ROOT,
             readings: bool = False) -> dict:
    """Run cell `name` once; returns the result object (see the module's
    docstring). On the CPU the kernels' plain versions run and the device
    metrics are not measured. With `readings`, the result also holds
    every number the check computed, compared or not."""
    import torch

    cell = harness.load_cell(name, root)
    if device == "cuda":
        # the program's own kernels build into build/egt_torch/; any other
        # build or kernel cache stays in the checkout too, at a fixed path
        for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                         ("TRITON_CACHE_DIR", "triton")):
            os.environ[var] = str(CHECKOUT / "build" / sub)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    ctx = Context(cell, seed, seconds, trace, torch.device(device))
    try:
        ctx.lap("imports")
        if device == "cuda":
            with ctx.phase("kernel build"):
                build(cell)
        if cell.mode == "train":
            from . import train as mode
        else:
            from . import serve as mode
        out = mode.run(ctx)
    finally:
        for fn in ctx.cleanup:
            fn()
    line = result(ctx, cell, out, root)
    if readings:
        line["readings"] = out["numbers"]
    return line


def result(ctx, cell, out: dict, root: Path) -> dict:
    from .reference.compare import judge

    correct, checks = judge(out["numbers"], cell.spec["limits"])
    if ctx.trace or ctx.device.type != "cuda":
        metrics, missing = {}, []
        for m in harness.load_metrics(cell.spec["end_to_end"], root):
            v = m.read(out["run"])
            if v is None:
                missing.append(m.name)
            else:
                metrics[m.name] = {"value": v, "unit": m.unit}
        if missing:
            _log("not measured: " + ", ".join(missing))
        if not ctx.trace:
            metrics = {**_e2e(ctx, out), **metrics}
    else:
        metrics = _e2e(ctx, out)
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": _kind(ctx), "count": 1,
              "memory_peak_bytes": int(out["peak"])}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device}
    summary = out["run"].trace
    if summary is not None:
        r = out["run"]
        _log(f"untraced half: {len(r.calls(False))} calls in "
             f"{r.untraced_s:.3f} s; traced half: {len(r.calls(True))} "
             f"calls in {summary.window_s:.3f} s")
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        line["breakdown"] = {
            "device_ops": summary.top_ops(10),
            "idle_gaps": summary.idle_gaps(out["run"].spans, 10)}
    line["checks"] = checks
    return line


def _e2e(ctx, out: dict) -> dict:
    """The cell's end-to-end metrics; `<metric>.<qualifier>` is the
    mode's `<metric>` under a name of the cell's own, whose bound is its
    own (a cell that the host paces, for one)."""
    m = {}
    for name in ctx.cell.spec["end_to_end"]:
        v, u = out["e2e"][name.split(".")[0]]
        m[name] = {"value": v, "unit": u}
    m["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    return m


def _kind(ctx) -> str:
    if ctx.device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        cell = harness.load_cell(args.workload)
    except (ImportError, OSError, KeyError, ValueError) as exc:
        _log(f"perfbench: cannot run {args.workload}: {exc!r}")
        return 2
    want = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        _log(f"perfbench: {args.workload} needs {want} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if not (CHECKOUT / "egt_torch").is_dir():
        _log("perfbench: run from a checkout that holds egt_torch/")
        return 2
    sys.path.insert(0, str(CHECKOUT))
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if bad:
        _log(f"perfbench: modules that must not load were loaded: {bad[:10]}")
        return 3
    for name, (v, limit) in line["checks"].items():
        _log(f"check {name}: {v!r} (limit {limit!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
