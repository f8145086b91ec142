"""The port's data reader against the JAX package's on the CPU: batches
equal element for element with equal dtypes (fixed pad, length buckets,
shuffled epochs, the last partial batch), each package reading the other's
cache, a cache written from records equal to one built from HDF5, the
native batch assembler against the numpy path, and the schedules,
`SaveWhen` and TensorBoard writer against their JAX counterparts. All of
these are exact: the same integer and f32 operations in the same order."""

import glob
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egt_torch import native as tnative
from egt_torch.data import datasets as tD
from egt_torch.data.dataset import GraphDataset as TDataset
from egt_torch.training import checkpoint as tckpt
from egt_torch.training import schedules as tsched
from egt_torch.utils import tbevents as ttb
from egt_tpu.data import datasets as jD
from egt_tpu.data.dataset import GraphDataset as JDataset
from egt_tpu.training import checkpoint as jckpt
from egt_tpu.training import schedules as jsched
from egt_tpu.utils import tbevents as jtb
from tests.synth import make_pattern_like, make_tsp_like, make_zinc_like
from tests.test_pcqm4mv2 import make_pcqm_like

SPLITS = ["training", "validation"]


def assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for bg, br in zip(got, ref):
        assert sorted(bg) == sorted(br)
        for k in br:
            assert bg[k].dtype == br[k].dtype, k
            np.testing.assert_array_equal(bg[k], br[k], err_msg=k)


@pytest.fixture(scope="module")
def zinc_h5(tmp_path_factory):
    d = tmp_path_factory.mktemp("zinc_data")
    # 21 records at batch 8: two full batches and a partial one of 5
    return make_zinc_like(str(d / "zinc.h5"), n_records=21)


BATCH_CASES = {
    "fixed_pad": dict(),
    "buckets": dict(buckets=[8, 16]),
    "shuffle_epoch0": dict(shuffle=True, seed=3, epoch=0),
    "shuffle_epoch1": dict(shuffle=True, seed=3, epoch=1),
    "shuffle_buckets": dict(shuffle=True, seed=3, epoch=1, buckets=[8, 16]),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batches_match_jax(zinc_h5, tmp_path, case):
    kw = BATCH_CASES[case]
    tds = TDataset(tD.ZINC, zinc_h5, str(tmp_path / "t"), splits=SPLITS)
    jds = JDataset(jD.ZINC, zinc_h5, str(tmp_path / "j"), splits=SPLITS)
    got = list(tds.batches("training", 8, **kw))
    assert_batches_equal(got, jds.batches("training", 8, **kw))
    if "buckets" not in kw:
        # the last partial batch: 5 real graphs, padded to 8
        last = got[-1]
        np.testing.assert_array_equal(last["sample_mask"],
                                      [1, 1, 1, 1, 1, 0, 0, 0])
        assert (last["num_nodes"][5:] == 0).all()
        assert last["node_features"].dtype == np.int8
        assert last["graph_matrix"].dtype == np.uint8


def test_each_package_reads_the_others_cache(zinc_h5, tmp_path):
    # the port builds the cache, JAX reads it without the HDF5 file, and
    # back: the same files, the same batches
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tds = TDataset(tD.ZINC, zinc_h5, port_dir, splits=SPLITS)
    jds = JDataset(jD.ZINC, zinc_h5, jax_dir, splits=SPLITS)
    ref = list(jds.batches("training", 8, shuffle=True, seed=1))
    assert_batches_equal(tds.batches("training", 8, shuffle=True, seed=1), ref)
    missing = str(tmp_path / "no.h5")
    assert_batches_equal(
        JDataset(jD.ZINC, missing, port_dir, splits=SPLITS).batches(
            "training", 8, shuffle=True, seed=1), ref)
    assert_batches_equal(
        TDataset(tD.ZINC, missing, jax_dir, splits=SPLITS).batches(
            "training", 8, shuffle=True, seed=1), ref)
    a, b = (np.load(f"{d}/training_raw.npz") for d in (port_dir, jax_dir))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _zinc_records(rng, n):
    recs = []
    for _ in range(n):
        nn = int(rng.integers(6, 15))
        edges = np.unique(rng.integers(0, nn, size=(2 * nn, 2)), axis=0)
        tokens = rng.integers(0, 28, size=nn).astype(np.int64)
        recs.append(dict(num_nodes=nn, edges=edges, node_features=tokens,
                         edge_features=rng.integers(0, 4, size=len(edges)),
                         value=np.array([nn / 10 + tokens.mean() / 30],
                                        np.float32)))
    return recs


@pytest.mark.parametrize("pe", [None, "svd"])
def test_cache_written_from_records_equals_hdf5_cache(tmp_path, pe):
    from egt_torch.data.hdf5_io import write_records

    recs = _zinc_records(np.random.default_rng(4), 13)
    h5 = str(tmp_path / "z.h5")
    write_records(h5, "ZINC", "training", recs)
    kw = dict(splits=["training"], pe=pe, num_features=4)
    TDataset(tD.ZINC, str(tmp_path / "none.h5"), str(tmp_path / "rec"),
             **kw).write_cache("training", recs)
    from_h5 = JDataset(jD.ZINC, h5, str(tmp_path / "h5"), **kw)
    from_recs = TDataset(tD.ZINC, str(tmp_path / "none.h5"),
                         str(tmp_path / "rec"), **kw)
    a, b = from_recs.ensure_cache("training"), from_h5.ensure_cache("training")
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_buckets_cover_all_records(tmp_path):
    f = make_pattern_like(str(tmp_path / "p.h5"), n_records=30, n_min=6,
                          n_max=24)
    ds = TDataset(tD.SBM_PATTERN, f, str(tmp_path / "c"), splits=["training"])
    jds = JDataset(jD.SBM_PATTERN, f, str(tmp_path / "j"),
                   splits=["training"])
    total, seen_lens = 0, set()
    for batch in ds.batches("training", 4, buckets=[12, 24]):
        total += int(batch["sample_mask"].sum())
        seen_lens.add(batch["node_features"].shape[1])
        nn = batch["num_nodes"][batch["sample_mask"] > 0]
        assert (nn <= batch["node_features"].shape[1]).all()
    assert total == 30
    assert seen_lens <= {12, 24} and len(seen_lens) == 2
    assert_batches_equal(ds.batches("training", 4, buckets=[12, 24]),
                         jds.batches("training", 4, buckets=[12, 24]))


def test_bucket_shuffle_deterministic(tmp_path):
    f = make_pattern_like(str(tmp_path / "p2.h5"), n_records=20)
    ds = TDataset(tD.SBM_PATTERN, f, str(tmp_path / "c2"), splits=["training"])

    def order(epoch):
        return [b["num_nodes"].tolist() for b in ds.batches(
            "training", 4, shuffle=True, seed=1, epoch=epoch, buckets=[24])]

    assert order(0) == order(0)
    assert order(0) != order(1)


# --------------------------------------------------- native against numpy


def _native_and_numpy(ds, monkeypatch, bs):
    assert tnative.available()
    nat = list(ds.batches("training", bs))
    with monkeypatch.context() as m:
        m.setattr(tnative, "available", lambda: False)
        ref = list(ds.batches("training", bs))
    return nat, ref


def test_native_builds_from_the_ports_source():
    assert tnative.available()
    path = tnative.library_path()
    assert path.is_file() and path.parent.parts[-2:] == ("build", "egt_torch")
    assert tnative._SRC.parent.parts[-2:] == ("egt_torch", "native")


@pytest.mark.parametrize("kind", ["zinc", "tsp", "pcqm"])
def test_native_batches_match_numpy(tmp_path, monkeypatch, kind):
    if kind == "zinc":
        f = make_zinc_like(str(tmp_path / "z.h5"), n_records=20)
        ds = TDataset(tD.ZINC, f, str(tmp_path / "c"), splits=["training"],
                      pe="svd", num_features=4)
        bs = 8
    elif kind == "tsp":
        f = make_tsp_like(str(tmp_path / "t.h5"), n_records=6)
        ds = TDataset(tD.TSP, f, str(tmp_path / "c"), splits=["training"])
        bs = 4
    else:
        # (E, 3) integer bond features: the multi-column int path
        f = make_pcqm_like(str(tmp_path / "p.h5"), n_records=18)
        ds = TDataset(tD.PCQM4MV2, f, str(tmp_path / "c"),
                      splits=["training"], pe="svd", num_features=4)
        bs = 8
    nat, ref = _native_and_numpy(ds, monkeypatch, bs)
    assert_batches_equal(nat, ref)
    if kind == "pcqm":
        assert any(b["feature_matrix"].ndim == 4 for b in nat)
    if kind == "tsp":
        assert any(b["target"].any() for b in nat)


# ---------------------------------------- schedules, SaveWhen, TensorBoard


def test_warmup_cosine_matches_jax():
    for kw in (dict(warmup_steps=10, max_lr=1.0),
               dict(warmup_steps=10, max_lr=1e-3, min_lr=1e-5,
                    total_steps=110)):
        for step in range(0, 125, 3):
            assert tsched.warmup_cosine_lr(step, **kw) == \
                jsched.warmup_cosine_lr(step, **kw)
    lr, _ = tsched.warmup_cosine_lr(110, warmup_steps=10, max_lr=1.0,
                                    total_steps=110)
    assert abs(lr - math.cos(0.5 * math.pi)) < 1e-12


def test_plateau_matches_jax():
    kw = dict(monitor="val_mae", rlr_factor=0.5, rlr_patience=3,
              min_lr=0.01, stopping_lr=0.03)
    values = [1.0, 2.0, 2.0, 2.0, 0.9, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]
    runs = []
    for sched in (tsched, jsched):
        st, lr, out, logs = sched.default_plateau_state(), 0.1, [], []
        for epoch, v in enumerate(values, 1):
            lr, improved, stop = sched.plateau_update(
                st, sched.PlateauConfig(**kw), lr, epoch, {"val_mae": v},
                logs.append)
            out.append((lr, improved, stop, dict(st)))
        runs.append((out, logs))
    assert runs[0] == runs[1]
    assert runs[0][0][-1][2]              # the run reached the stop


def test_save_when_matches_jax(tmp_path):
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.arange(3.0))
    when = "epoch;val_mae<=save_best_value;epoch{epoch:0>4d}"
    t = tckpt.SaveWhen(str(tmp_path / "t"), when)
    j = jckpt.SaveWhen(str(tmp_path / "j"), when)
    for scope in ({"val_mae": 0.5, "save_best_value": 1.0, "epoch": 7},
                  {"val_mae": 2.0, "save_best_value": 1.0, "epoch": 8},
                  {"epoch": 9}):
        got = t.maybe_save("epoch", scope, model)
        ref = j.maybe_save("epoch", scope, {"w": jnp.arange(3.0)})
        assert [p.rsplit("/", 1)[1] for p in got] == \
            [p.rsplit("/", 1)[1] for p in ref]
    a, b = (np.load(str(tmp_path / d / "epoch0007.npz")) for d in "tj")
    assert a.files == b.files and np.array_equal(a["w"], b["w"])


def test_tbevents_bytes_match_jax(tmp_path, monkeypatch):
    for mod in (ttb, jtb):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    for mod, sub in ((ttb, "t"), (jtb, "j")):
        w = mod.EventWriter(str(tmp_path / sub))
        w.add_scalar("loss", 0.5, 1)
        w.add_scalar("val_mae", 0.25, 2)
        w.close()
    (ft,), (fj,) = (glob.glob(str(tmp_path / s / "events.out.tfevents.*"))
                    for s in ("t", "j"))
    data = open(ft, "rb").read()
    assert data == open(fj, "rb").read()
    assert b"brain.Event:2" in data and np.float32(0.25).tobytes() in data
    assert ttb._crc32c(b"123456789") == 0xE3069283
