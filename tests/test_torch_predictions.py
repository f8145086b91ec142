"""The port's prediction dump (`TrainingBase.make_predictions`) against the
JAX package's on the CPU, at a small size (2 layers, width 16, edge width
8, 4 heads, f32), from seeded JAX weights saved as the run's final weights
(`weight_file` ""), without training:

- ZINC: the three `<split>_predictions.npz` files equal JAX's within 1e-5,
  the test split's rows those of `predict_split`;
- PATTERN with length buckets 24 / 32 (a node readout, so each batch's
  predictions have its own pad): JAX's `make_predictions` raises on the
  concatenation, and so does its `do_analysis` over every batch; the
  port writes each batch's rows padded with NaN to the split's largest pad,
  equal to JAX's `predict_split` of that batch within 1e-5;
- `concat_padded` alone.
"""

from pathlib import Path

import numpy as np
import pytest

from egt_torch.training.schemes import import_scheme as timport
from egt_torch.training.trainer import concat_padded
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training.schemes import import_scheme as jimport
from tests.synth import make_pattern_like, make_zinc_like
from tests.test_torch_model import jax_params

SPLITS = ("trainset", "valset", "testset")


def tiny_config(d: Path, name: str, scheme: str = "zinc.svd",
                data: str = "zinc.h5", **kw) -> dict:
    cfg = {
        "scheme": scheme,
        "model_name": name,
        "dataset_path": str(d / data),
        "cache_dir": str(d / "cache" / name),
        "save_path": str(d / "models" / name),
        "batch_size": 8,
        "num_epochs": 1,
        "model_width": 16,
        "edge_width": 8,
        "model_height": 2,
        "num_heads": 4,
        "use_svd": False,
        "upto_hop": 2,
        "log_tensorboard": False,
        "compute_dtype": "float32",
        "weight_file": "",
    }
    cfg.update(kw)
    return cfg


def save_seeded_weights(*cfgs) -> None:
    """Seeded JAX params of the first config's model, saved as every
    config's final weights (`<save_path>/saved/<model_name>.npz`)."""
    params = jax_params(jimport(cfgs[0]["scheme"])(cfgs[0]).get_model_config())
    for cfg in cfgs:
        jckpt.save_weights(params, str(Path(cfg["save_path"]) / "saved" /
                                       f"{cfg['model_name']}.npz"))


def _predictions(cfg, split):
    path = Path(cfg["save_path"]) / "predictions" / f"{split}_predictions.npz"
    with np.load(path) as data:
        return data["predictions"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("predictions")
    make_zinc_like(str(d / "zinc.h5"), n_records=20)
    # 20 records a split at batch 8 x prediction_bmult 2: each bucket gets
    # a full batch and a partial one
    make_pattern_like(str(d / "pattern.h5"), n_records=20, n_min=10,
                      n_max=30)
    return d


def test_make_predictions_matches_jax(workdir):
    jcfg, tcfg = tiny_config(workdir, "jax"), tiny_config(workdir, "port")
    save_seeded_weights(jcfg, tcfg)
    jimport("zinc.svd")(jcfg).make_predictions()
    ts = timport("zinc.svd")(tcfg, device="cpu")
    ts.make_predictions()
    for split in SPLITS:
        got, ref = _predictions(tcfg, split), _predictions(jcfg, split)
        assert got.shape == ref.shape == (20, 1), split
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, err_msg=split)
    rows = np.concatenate([out[batch["sample_mask"] > 0]
                           for batch, out in ts.predict_split("test")])
    np.testing.assert_array_equal(_predictions(tcfg, "testset"), rows)


def test_mixed_pads_padded_with_nan(workdir):
    kw = dict(scheme="pattern.svd", data="pattern.h5", length_buckets=[24, 32])
    jcfg, tcfg = tiny_config(workdir, "jax_sbm", **kw), tiny_config(
        workdir, "port_sbm", **kw)
    save_seeded_weights(jcfg, tcfg)
    js = jimport("pattern.svd")(jcfg)
    with pytest.raises(ValueError):
        js.make_predictions()
    with pytest.raises(ValueError):
        jimport("pattern.svd")(jcfg).do_analysis("test", 4)

    ts = timport("pattern.svd")(tcfg, device="cpu")
    ts.make_predictions()
    got = _predictions(tcfg, "testset")
    start, pads = 0, set()
    for batch, out in js.predict_split("test"):
        ref = np.asarray(out)[batch["sample_mask"] > 0]
        n, l = ref.shape[:2]
        pads.add(l)
        np.testing.assert_allclose(got[start:start + n, :l], ref, atol=1e-5,
                                   rtol=0)
        assert np.isnan(got[start:start + n, l:]).all()
        start += n
    assert start == got.shape[0] == 20
    assert pads == {24, 32} and got.shape[1] == 32

    # the analysis over every batch (of both pads): NaN-padded alike
    with np.load(ts.do_analysis("test", 4)) as data:
        mat = data["mha_00.mat"]
    assert mat.shape[1:3] == (32, 32)
    assert np.isnan(mat[:, 24:]).any() and np.isfinite(mat[:, :24, :24]).all()


def test_concat_padded():
    a = np.ones((2, 3, 3), np.float32)
    b = 2 * np.ones((1, 2, 2), np.float32)
    out = concat_padded([a, b])
    assert out.shape == (3, 3, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:2], a)
    np.testing.assert_array_equal(out[2, :2, :2], b[0])
    assert np.isnan(out[2, 2]).all() and np.isnan(out[2, :, 2]).all()
    same = [a, a]
    np.testing.assert_array_equal(concat_padded(same), np.concatenate(same))
