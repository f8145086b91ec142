"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
with tiny configurations and cells beside the real ones, which the harness
runs on the CPU with the kernels' plain versions."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]

# the real configurations cut to a size a CPU test holds; widths are the
# tiny ones, everything else (virtual nodes, dropout, the random mask, the
# degree scaler, the readouts, the losses) as the real ones have it
TINY = {
    "egt-large": dict(model_width=16, edge_width=8, model_height=2,
                      num_heads=4, batch_size=8, grad_accum_steps=2),
    "pattern-500k": dict(model_width=16, edge_width=8, model_height=2,
                         num_heads=4, batch_size=8, upto_hop=4),
}
# the real widths and depths with small batches (at 64 graphs a PATTERN
# step, the least at which the control fails on each seed the test takes)
SMALL = {"egt-large": dict(batch_size=8, grad_accum_steps=2),
         "pattern-500k": dict(batch_size=64)}
REF = {"model_width": "width", "edge_width": "edge_width",
       "model_height": "height", "num_heads": "heads", "upto_hop": "upto_hop"}
TRAFFIC = {
    "egt-large.train": {"groups": [[48, 4, 12]], "warm_steps": 3},
    "pattern-500k.train": {"groups": [[32, 45, 60], [16, 61, 70]],
                           "warm_steps": 6},
    "egt-large.serve": {"pool": [{"groups": [[8, 4, 12]], "pad": 16}] * 2},
    "pattern-500k.serve": {"pool": [{"groups": [[8, 45, 60]], "pad": 64},
                                    {"groups": [[8, 61, 70]], "pad": 72}]},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


SMALL_TRAFFIC = dict(TRAFFIC, **{
    "pattern-500k.train": {"groups": [[128, 45, 60], [64, 61, 70]],
                           "warm_steps": 3}})


def tiny_root(dest: Path, dtype: str | None = None, sizes=None,
              traffic=None) -> Path:
    """A copy of the benchmark's files with `tiny-<config>` configurations
    and `tiny-<cell>` cells (compute in `dtype` where given; `sizes` and
    `traffic` in place of `TINY` and `TRAFFIC`)."""
    root = dest / "perfbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for name, over in (sizes or TINY).items():
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        cfg["name"] = f"tiny-{name}"
        cfg["run_config"].update(over)
        if dtype:
            cfg["run_config"]["compute_dtype"] = dtype
        for k, v in over.items():
            if k in REF:
                cfg["reference"][REF[k]] = v
        (root / "configs" / f"tiny-{name}.json").write_text(json.dumps(cfg))
    for cell, tr in (traffic or TRAFFIC).items():
        spec = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
        spec["config"] = f"tiny-{spec['config']}"
        spec["traffic"].update(tr)
        (root / "workloads" / f"tiny-{cell}.json").write_text(
            json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_bf16(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp("bf16"))


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp("small"), sizes=SMALL,
                     traffic=SMALL_TRAFFIC)


@pytest.fixture(scope="session")
def tiny_f32(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp("f32"), "float32")


@pytest.fixture
def gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
