"""The plain reference against the program on the CPU at small widths, in
float32 with the draws live: forward, loss and training steps through the
harness's own check of every tiny cell; the parameter names and shapes
against the program's model; and, on the card, every cell at its own
widths."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, run, traffic
from perfbench.reference import batch as rbatch
from perfbench.reference import model as rmodel

HERE = Path(__file__).resolve().parents[1]
CELLS = ["egt-large.train", "pattern-500k.train", "egt-large.serve",
         "pattern-500k.serve"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program_in_f32(cell, tiny_f32):
    """The harness's numbers (losses of 3 steps, the first gradient, the
    change, or the served predictions) at round-off."""
    line = run.run_cell(f"tiny-{cell}", 2 ** 31 + 11, 0.5, False,
                        device="cpu", root=tiny_f32)
    assert line["correct"]
    for name, (v, _) in line["checks"].items():
        assert v < 1e-4, (name, v)


@pytest.mark.parametrize("config", ["egt-large", "pattern-500k"])
def test_parameter_names_and_shapes(config):
    """The reference's parameters are the program's, name for name, at the
    configuration's full widths."""
    from egt_torch import schemes
    from egt_torch.models.graph_model import EGTGraphModel

    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    spec = rmodel.Spec.from_dict(cfg["reference"])
    ref = {n: tuple(s) for n, s, _ in rmodel.param_spec(spec)}
    mc = schemes.model_config_from_config(cfg["run_config"])
    with torch.device("meta"):
        m = EGTGraphModel(mc, device="meta")
    prog = {k.replace(".", "/"): tuple(p.shape)
            for k, p in m.named_parameters()}
    assert ref == prog


def test_forward_with_draws_against_the_program():
    """One forward in training mode (attention dropout and the random mask
    drawn) of the program's plain path and the reference."""
    from egt_torch import schemes
    from egt_torch.models.graph_model import EGTGraphModel
    from egt_torch.weights import load_flat_params

    cfg = json.loads((HERE / "configs" / "egt-large.json").read_text())
    rc = dict(cfg["run_config"], model_width=16, edge_width=8,
              model_height=2, num_heads=4, compute_dtype="float32",
              random_mask_prob=0.2)
    ref_cfg = dict(cfg["reference"], width=16, edge_width=8, height=2,
                   heads=4, random_mask_prob=0.2)
    spec = rmodel.Spec.from_dict(ref_cfg)
    w = rmodel.init_params(spec, 5, "cpu")
    m = EGTGraphModel(schemes.model_config_from_config(rc), device="cpu")
    load_flat_params(m, {k: v.numpy() for k, v in w.items()})
    recs = traffic.records("pcqm", [[6, 4, 10]], np.random.default_rng(1))
    b = rbatch.collate(recs, 8, 16)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    seeds = [123456789 + i for i in range(2)]
    prog = m(t, training=True, seeds=seeds)
    ref = rmodel.Forward(spec, w)(t, seeds)
    assert torch.allclose(prog, ref, atol=1e-5)
    assert not torch.allclose(ref, rmodel.Forward(spec, w)(t), atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_correct_on_the_card(cell, gpu):
    """Each cell at its own widths and sizes, a short window."""
    line = run.run_cell(cell, 2 ** 31 + 101, 2.0, False)
    assert line["correct"], line["checks"]


def test_cells_and_configs_are_found_by_name():
    for cell in CELLS:
        c = harness.load_cell(cell)
        assert c.config["name"] == c.spec["config"]
