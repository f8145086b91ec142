"""The port's analysis capture (`EGTGraphModel.analyze`, `capture_analysis`,
`combine_layer_repr`), its `do_analysis` and `save_results` against the JAX
package's on the CPU, at a small size (2 layers, width 16, edge width 8, 4
heads, f32, pad 12):

- every capture (`mha_{i}/e` h_hat, `mha_{i}/mat` a_tild,
  `attention_gates_{i}/gates`, `dense_edge_b_{i}/e`) of the residual,
  `bias`, constrained and `none` channels (the last without an edge
  embedding, where both write None, and with one for the distance head,
  where both write the raw e), and of a residual model with 2 virtual
  nodes (the captures keep the virtual rows), against JAX's `analyze`
  within 1e-5; the `combine_layer_repr` lists against JAX's; the output
  with capture equal to the output without, and to JAX's;
- capture on a config that runs the three forward kernels (paths A, B, C)
  takes the plain path: no kernel op is called, and the output equals the
  kernel path's within 1e-5;
- `python -m egt_torch.do_analysis <config> test 2 --device cpu` writes
  JAX's `testset_analysis.npz` (keys with `.`, arrays within 1e-5); with
  the `none` channel and no edge embedding JAX's `do_analysis` raises on
  the None capture and the port leaves that key out; without a GPU and
  without `--device`, the CLI refuses;
- `save_results` writes JAX's JSON fields, apart from `timestamp`.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from egt_torch import do_analysis
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.ops import custom_ops
from egt_torch.training.results import save_results as tsave
from egt_tpu.models.graph_model import EGTGraphModel as JModel
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training.results import save_results as jsave
from egt_tpu.training.schemes import import_scheme as jimport
from tests.synth import make_zinc_like
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_model import jax_params, port_model
from tests.test_torch_predictions import save_seeded_weights, tiny_config

CASES = {
    "residual": dict(),
    "bias": dict(edge_channel_type="bias"),
    "constrained": dict(edge_channel_type="constrained"),
    "none": dict(edge_channel_type="none"),
    "none_with_e": dict(edge_channel_type="none", distance_loss=0.1),
    "virtual_nodes": dict(num_virtual_nodes=2),
}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_captures_match_jax(case):
    jcfg = small_cfg(combine_layer_repr=True, **CASES[case])
    params = jax_params(jcfg)
    batch = random_zinc_batch(np.random.default_rng(7), b=4, l=12)
    ref = JModel(jcfg).analyze(params, batch)
    ref_out, _ = JModel(jcfg).apply(params, batch)
    model = port_model(jcfg, jckpt._flatten_params(params))
    with torch.no_grad():
        out, ctx = model(batch, with_context=True, capture_analysis=True)
        plain = model(batch)
    got = ctx.analysis
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        if isinstance(r, list):
            assert len(g) == len(r), key
            for i, (gi, ri) in enumerate(zip(g, r)):
                np.testing.assert_allclose(_np(gi), np.asarray(ri),
                                           atol=1e-5, rtol=0,
                                           err_msg=f"{key}[{i}]")
        elif r is None:
            assert g is None, key
        else:
            assert tuple(g.shape) == tuple(r.shape), key
            np.testing.assert_allclose(_np(g), np.asarray(r), atol=1e-5,
                                       rtol=0, err_msg=key)
    k = jcfg.num_virtual_nodes
    assert got["mha_01/mat"].shape == (4, 12 + k, 12 + k, 4)
    assert len(got["all_node_repr"]) == 2
    assert len(got["all_edge_repr"]) == (2 if jcfg.edge_channel_type in (
        "residual", "constrained") else 0)
    assert torch.equal(out, plain)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5,
                               rtol=0)


KERNEL_PATHS = {
    "A": dict(fused_layer=True),
    "B": dict(fused_attention=True),
    "C": dict(fused_attention=True, fused_edge_block=True, edge_width=64),
}


@pytest.mark.parametrize("path", sorted(KERNEL_PATHS))
def test_capture_takes_the_plain_path(path, monkeypatch):
    model = TModel(TCfg(**dataclasses.asdict(small_cfg(
        **KERNEL_PATHS[path]))), device="cpu").eval()
    batch = random_zinc_batch(np.random.default_rng(8), b=4, l=12)
    with torch.no_grad():
        kernel_out = model(batch)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel op ran under capture")

    for fn in ("layer_forward", "attention_forward", "edge_forward"):
        monkeypatch.setattr(custom_ops, fn, refuse)
    with torch.no_grad():
        with pytest.raises(AssertionError):
            model(batch)
        analysis = model.analyze(batch)
        out, _ = model(batch, with_context=True, capture_analysis=True)
    assert "mha_01/mat" in analysis
    np.testing.assert_allclose(out.numpy(), kernel_out.numpy(), atol=1e-5,
                               rtol=0)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("analysis")
    make_zinc_like(str(d / "zinc.h5"), n_records=20)
    return d


def _cli(d: Path, cfg: dict, *args):
    path = d / f"{cfg['model_name']}.json"
    path.write_text(json.dumps(cfg))
    return do_analysis.main([str(path), *args])


def _load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_do_analysis_cli_matches_jax(workdir):
    jcfg, tcfg = tiny_config(workdir, "jax"), tiny_config(workdir, "port")
    save_seeded_weights(jcfg, tcfg)
    ref = _load(jimport("zinc.svd")(jcfg).do_analysis("test", 2))
    _cli(workdir, tcfg, "test", "2", "--device", "cpu")
    got = _load(Path(tcfg["save_path"]) / "predictions" /
                "testset_analysis.npz")
    assert sorted(got) == sorted(ref) and "mha_00.mat" in got
    for k, r in ref.items():
        assert got[k].shape == r.shape and r.shape[0] == 32, k   # 2 x 16
        np.testing.assert_allclose(got[k], r, atol=1e-5, rtol=0, err_msg=k)


def test_do_analysis_skips_a_none_capture(workdir):
    kw = dict(edge_channel_type="none")
    jcfg, tcfg = (tiny_config(workdir, "jax_none", **kw),
                  tiny_config(workdir, "port_none", **kw))
    save_seeded_weights(jcfg, tcfg)
    # JAX captures e = None and cannot concatenate it
    with pytest.raises(ValueError):
        jimport("zinc.svd")(jcfg).do_analysis("test", 1)
    got = _load(_cli(workdir, tcfg, "--device", "cpu").config.predictions_path
                + "/testset_analysis.npz")
    assert sorted(got) == ["mha_00.e", "mha_00.mat", "mha_01.e", "mha_01.mat"]


def test_do_analysis_cli_refuses_without_gpu(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        _cli(workdir, tiny_config(workdir, "refused"))
    assert err.value.code == 2


def test_results_saver_matches_jax(tmp_path):
    kw = dict(configs={"a": 1, "b": [2, 3]},
              state={"current_epoch": 3, "lr": 1e-3, "skip": [1]})
    paths = [save("zinc", "tiny", "testset", {"mae": 0.1}, **kw,
                  parent_dir=str(tmp_path / name))
             for name, save in (("port", tsave), ("jax", jsave))]
    got, ref = (json.loads(Path(p).read_text()) for p in paths)
    assert got.pop("timestamp") and ref.pop("timestamp")
    assert got == ref
    assert got["metrics"]["mae"] == 0.1 and got["state"] == {
        "current_epoch": 3, "lr": 1e-3}
    assert [Path(p).relative_to(tmp_path).parts[:2] for p in paths] == [
        ("port", "results"), ("jax", "results")]
    assert Path(paths[0]).name.startswith("zinc_tiny_testset_")
