"""The frozen work counts reproduce the bounds the port's chip smoke test
printed, and the model FLOPs of both configurations."""

import json
from pathlib import Path

import pytest

from perfbench import counts

HERE = Path(__file__).resolve().parents[1]

H100 = counts.CARDS["H100"]


def model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())[
        "reference"]


def test_k3_at_the_flagship_shape():
    # ZINC 500k: b 128, l 40, ew 64, h 8, width 64, hidden 128, training
    w = counts.k3(128, 40, 64, 8, 64, 128, 2, training=True)
    assert w.nbytes / 1e6 == pytest.approx(58.4, abs=0.05)
    assert w.mm_flops / 1e9 == pytest.approx(7.4, abs=0.05)
    assert w.bound_s(H100, True) * 1e3 == pytest.approx(0.0174, abs=1e-4)


@pytest.mark.parametrize("kernel,mb,bound_ms", [("K1", 60.8, 0.0181),
                                                ("K2", 117.4, 0.0350)])
def test_k1_k2_at_pcqm_l36(kernel, mb, bound_ms):
    w = counts.launch_work(kernel, model("egt-large"), 128, 36, True, True)
    assert w.nbytes / 1e6 == pytest.approx(mb, abs=0.05)
    assert w.bound_s(H100, True) * 1e3 == pytest.approx(bound_ms, abs=1e-4)


@pytest.mark.parametrize("kernel,l,bound_ms", [
    ("K3", 192, 0.0714), ("K3", 128, 0.0326), ("K4", 192, 0.1127),
    ("K4", 128, 0.0501), ("K5", 192, 0.1212), ("K5", 128, 0.0557)])
def test_whole_layer_kernels_at_the_sbm_buckets(kernel, l, bound_ms):
    w = counts.launch_work(kernel, model("pattern-500k"), 128, l, True, True)
    assert w.bound_s(H100, True) * 1e3 == pytest.approx(bound_ms, abs=1e-4)


def test_model_flops_per_graph():
    # EGT-Large: 26.6 GFLOP a training graph at l 36 (32 atoms + 4 VN)
    assert 3 * counts.forward_flops_per_graph(model("egt-large"), 36) / 1e9 \
        == pytest.approx(26.64, abs=0.01)
    p = model("pattern-500k")
    assert counts.forward_flops_per_graph(p, 128) / 1e9 == \
        pytest.approx(0.504, abs=1e-3)
    assert counts.forward_flops_per_graph(p, 192) / 1e9 == \
        pytest.approx(1.104, abs=1e-3)


def test_peaks_by_device_name():
    assert counts.card_peaks("NVIDIA H100 80GB HBM3") == H100
    with pytest.raises(KeyError):
        counts.card_peaks("NVIDIA A100")
