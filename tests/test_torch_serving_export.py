"""The port's serving export (`egt_torch/serving.py`: `batch_spec`,
`export_predict`, `save_serving`, `load_serving`; `TrainingBase.export_serving`
and `python -m egt_torch.export_serving`) on the CPU, at a small size (2
layers, width 16, edge width 8, 4 heads, f32), from seeded JAX weights saved
as the run's final weights:

- the `torch.export` artifact of a ZINC run serves the test split's first
  batch within 1e-6 of the live model (`predict_split`) and within 1e-4 of
  the JAX package's own artifact (`egt_tpu.serving.load_serving`) on the
  same weights;
- the exported graph holds `model_height` nodes of the forward kernel's
  custom op on each path: K3 (`egt.fused_layer_fwd`) with the whole-layer
  kernel, K1 (`egt.attention_fwd`) on an `egt_simple`-shaped (`bias`
  channel) model with the attention kernel, K1 and K8
  (`egt.edge_block_fwd`) with the edge block (edge width 64), no no-op
  node (a metadata assertion, a cast to the tensor's own dtype but the
  output's), and serves as the eager model does;
- a fresh process loads and serves the artifact importing no
  `egt_torch.models`, `egt_torch.schemes`, `egt_torch.training`,
  `egt_torch.utils` or `jax`;
- a request of another shape or dtype, or without a key, raises;
- the three custom ops pass `torch.library.opcheck` (schema, fake kernel
  against the CPU kernel);
- `python -m egt_torch.export_serving <config> --device cpu` writes
  `<save_path>/serving/model.pt2`; without a GPU and without `--device` it
  refuses.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from egt_torch import export_serving, serving
from egt_torch.models.graph_model import EGTGraphModel as TModel
from egt_torch.models.graph_model import GraphModelConfig as TCfg
from egt_torch.ops import custom_ops
from egt_torch.ops import edge_block as teb
from egt_torch.ops import egt_attention as tatt
from egt_torch.ops import fused_layer as tfl
from egt_torch.ops.rng import OFF
from egt_torch.training.schemes import import_scheme as timport
from egt_tpu import serving as jserving
from egt_tpu.training.schemes import import_scheme as jimport
from tests.synth import make_zinc_like
from tests.test_model_forward import random_zinc_batch, small_cfg
from tests.test_torch_predictions import save_seeded_weights, tiny_config

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_export")
    make_zinc_like(str(d / "zinc.h5"), n_records=20)
    return d


@pytest.fixture(scope="module")
def artifact(workdir):
    """(path, the test split's first batch, its live predictions)."""
    jcfg, tcfg = tiny_config(workdir, "jax"), tiny_config(workdir, "port")
    save_seeded_weights(jcfg, tcfg)
    path = timport("zinc.svd")(tcfg, device="cpu").export_serving()
    ts = timport("zinc.svd")(tcfg, device="cpu")
    ts.pred_flag = True
    ts.prepare_for_test()
    batch, live = next(ts.predict_split("test"))
    jpath = jimport("zinc.svd")(jcfg).export_serving(
        str(workdir / "jax_model.bin"))
    feed = {k: v for k, v in batch.items() if k != "target"}
    return path, batch, live, np.asarray(jserving.load_serving(jpath)(feed))


def test_artifact_matches_live_and_jax(artifact):
    path, batch, live, jax_out = artifact
    assert path.endswith("serving/model.pt2")
    fn = serving.load_serving(path)
    out = fn(batch)
    assert out.shape == (16, 1) and out.dtype == np.float32
    np.testing.assert_allclose(out, live, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, jax_out, atol=1e-4, rtol=0)
    # the defaults ("auto") take the whole-layer kernel
    assert serving.kernel_ops(fn.program) == {"K3": 2, "K1": 0, "K8": 0}


PATHS = {
    "A": (dict(fused_layer=True), {"K3": 2, "K1": 0, "K8": 0}),
    "B": (dict(edge_channel_type="bias", fused_attention=True),
          {"K3": 0, "K1": 2, "K8": 0}),
    "C": (dict(fused_attention=True, fused_edge_block=True, edge_width=64),
          {"K3": 0, "K1": 2, "K8": 2}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_exported_graph_holds_kernel_ops(path):
    kw, want = PATHS[path]
    model = TModel(TCfg(**dataclasses.asdict(small_cfg(**kw))),
                   device="cpu").eval()
    batch = random_zinc_batch(np.random.default_rng(4), b=4, l=12)
    batch["graph_matrix"] = batch["graph_matrix"].astype(np.uint8)
    spec = {k: (v.shape, v.dtype.name) for k, v in batch.items()
            if k != "target"}
    program = serving.export_predict(model, spec)
    assert serving.kernel_ops(program) == want
    # the no-op nodes are gone: metadata assertions and same-dtype casts
    targets = [n.target for n in program.graph.nodes]
    assert torch.ops.aten._assert_tensor_metadata.default not in targets
    assert not any(t is torch.ops.aten.to.dtype
                   and n.args[0].meta["val"].dtype == n.args[1]
                   and all(u.op != "output" for u in n.users)
                   for n, t in zip(program.graph.nodes, targets))
    feed = {k: torch.from_numpy(batch[k]) for k in model.input_keys}
    with torch.no_grad():
        np.testing.assert_allclose(program.module()(feed).numpy(),
                                   model(feed).numpy(), atol=1e-6, rtol=0)


LOADER = """
import json, sys
import numpy as np
from egt_torch.serving import load_serving
fn = load_serving(sys.argv[1])
with np.load(sys.argv[2]) as data:
    out = fn({k: data[k] for k in data.files})
np.save(sys.argv[3], out)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] == "jax"
                        or m.startswith(("egt_torch.models", "egt_torch.schemes",
                                         "egt_torch.training", "egt_torch.utils",
                                         "egt_tpu")))))
"""


def test_loader_imports_no_model_code(artifact, tmp_path):
    path, batch, live, _ = artifact
    np.savez(tmp_path / "batch.npz", **batch)
    res = subprocess.run(
        [sys.executable, "-c", LOADER, path, str(tmp_path / "batch.npz"),
         str(tmp_path / "out.npy")], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), live,
                               atol=1e-6, rtol=0)


def test_wrong_request_raises(artifact):
    path, batch, _, _ = artifact
    fn = serving.load_serving(path)
    short = {k: v[:8] for k, v in batch.items()}
    with pytest.raises(ValueError, match="node_features"):
        fn(short)
    with pytest.raises(ValueError, match="graph_matrix"):
        fn({**batch, "graph_matrix": batch["graph_matrix"].astype(np.int64)})
    with pytest.raises(KeyError):
        fn({k: v for k, v in batch.items() if k != "feature_matrix"})


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    b, l, ew, h, dh, hid = 2, 5, 8, 4, 16, 16
    spec = tfl.LayerSpec(l=l, ew=ew, h=h, dh=dh, hidden=hid, gated=True,
                         constrained=False, clip=(-5.0, 5.0), edge_act=None,
                         act="elu", scale=0.5)
    w = dict(wg=rnd(ew, h), bg=rnd(h), wb=rnd(ew, h), bb=rnd(h),
             g1=rnd(ew), b1=rnd(ew), wr=rnd(h, ew), br=rnd(ew), g2=rnd(ew),
             b2=rnd(ew), w1=rnd(ew, hid), bb1=rnd(hid), w2=rnd(hid, ew),
             bb2=rnd(ew))
    mask = torch.ones(b, l)
    e, qkv = rnd(b, l, l, ew), rnd(b, l, 3 * dh)
    q, k, v = (rnd(b, h, l, 4) for _ in range(3))
    madd = (mask - 1.0) * 1e9
    eh, gh = rnd(b, h, l, l), rnd(b, h, l, l)
    hh = rnd(b, h, l, l).permute(0, 2, 3, 1)      # head-major view
    tail = {key: w[key] for key in teb.KEYS}
    return {
        "K3": (torch.ops.egt.fused_layer_fwd.default,
               (e, qkv, mask, None, *(w[key] for key in tfl.W_KEYS), h,
                True, -5.0, 5.0, "", "elu", 0, 0.0, 0.0),
               lambda: tfl.fused_layer_plain(spec, e, qkv, mask, None, w),
               lambda: custom_ops.layer_forward(spec, e, qkv, mask, None,
                                                w)),
        "K1": (torch.ops.egt.attention_fwd.default,
               (q, k, v, eh, gh, madd, None, True, -5.0, 5.0, 0, 0.0, 0.0),
               lambda: tatt.egt_core_fwd_plain(q, k, v, eh, gh, madd, None,
                                               (-5.0, 5.0)),
               lambda: custom_ops.attention_forward(q, k, v, eh, gh, madd,
                                                    None, (-5.0, 5.0), OFF)),
        "K8": (torch.ops.egt.edge_block_fwd.default,
               (hh, e, *(tail[key] for key in teb.KEYS)),
               lambda: (teb.edge_block_fwd_plain(hh, e, tail),),
               lambda: (custom_ops.edge_forward(hh, e, tail),)),
    }


@pytest.mark.parametrize("kernel", ["K3", "K1", "K8"])
def test_custom_ops_pass_opcheck(kernel):
    op, args, plain, via_op = _op_cases()[kernel]
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_faketensor"))
    for got, ref in zip(via_op(), plain()):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


def _write_config(d: Path, cfg: dict) -> str:
    path = d / f"{cfg['model_name']}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_export_serving_cli(workdir, artifact):
    cfg = tiny_config(workdir, "port")
    scheme = export_serving.main([_write_config(workdir, cfg), "--device",
                                  "cpu"])
    path = Path(cfg["save_path"]) / "serving" / "model.pt2"
    assert path.is_file() and scheme.pad_len == artifact[1]["node_features"].shape[1]
    np.testing.assert_allclose(serving.load_serving(str(path))(artifact[1]),
                               artifact[2], atol=1e-6, rtol=0)


def test_export_serving_cli_refuses_without_gpu(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        export_serving.main([_write_config(workdir,
                                           tiny_config(workdir, "refused"))])
    assert err.value.code == 2
