"""Frozen work counts: the bytes and operations of one launch of each of
the port's kernels K1-K9 at its shapes, the model's FLOPs per graph, and
the card's published peaks.

A launch's bytes count each input read once and each output written once;
its operations count the matrix products (at the tensor-core rate in
bfloat16, the CUDA-core rate in float32) and, apart, the element-wise
work (always at the float32 rate). The least time a launch can take is
the larger of bytes over the memory rate and operations over their
rates. These are the formulas the port's chip smoke test printed its
bounds with; they count the work, whatever body of a kernel does it.

The model's FLOPs per graph count the matrix and attention products of
the forward at the batch's pad (virtual nodes included), the k-hop
products of the hop stack and the input and readout denses; a training
step counts three times the forward (no recomputation). Token lookups
count nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

# published dense peaks (NVIDIA data sheets): memory B/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores; matched on the device name
CARDS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),
    "H200": (4.8e12, 989e12, 67e12),
}


def card_peaks(name: str) -> tuple[float, float, float]:
    for key, peaks in CARDS.items():
        if key in name:
            return peaks
    raise KeyError(f"no published peaks for {name!r}")


@dataclass(frozen=True)
class Work:
    nbytes: float
    mm_flops: float      # matrix products
    ew_flops: float      # element-wise

    def bound_s(self, peaks, bf16: bool) -> float:
        bw, mm_bf16, f32 = peaks
        mm = mm_bf16 if bf16 else f32
        return max(self.nbytes / bw, self.mm_flops / mm + self.ew_flops / f32)


def k1(b, h, lq, lk, d, it, gated=True, hard=False) -> Work:
    """Attention forward: q, k, v, e (and g) read; v_att, h_hat (and the
    degrees) written."""
    pairs = b * h * lq * lk
    nbytes = (b * h * (lq + 2 * lk) * d + (2 if gated else 1) * pairs
              + b * h * lq * d + pairs) * it + b * lk * 4 + \
        (b * h * lq * 4 if gated else 0) + (b * lq * lk * 4 if hard else 0)
    return Work(nbytes, 4 * pairs * d, 15 * pairs)


def k2(b, h, lq, lk, d, it, gated=True, hard=False) -> Work:
    """Attention backward: q, k, v, the cotangents, h_hat (and g, the
    degrees' cotangent) read; dq, de (and dg) written, dk, dv in f32."""
    pairs = b * h * lq * lk
    nbytes = (b * h * (2 * lq + 2 * lk) * d + (3 if gated else 2) * pairs
              + b * h * lq * d + (2 if gated else 1) * pairs) * it + \
        2 * b * h * lk * d * 4 + b * lk * 4 + \
        (b * h * lq * 4 if gated else 0) + (b * lq * lk * 4 if hard else 0)
    return Work(nbytes, 10 * pairs * d, 30 * pairs)


def k3(b, l, ew, h, dh, hid, it, training, constrained=False) -> Work:
    """Whole-layer forward: e, qkv read; e out, v_att (and in training
    h_hat) written."""
    pairs = b * l * l
    wbytes = (2 * ew * h + h * ew + 2 * ew * hid) * it
    nbytes = (2 * pairs * ew + b * l * 3 * dh + b * l * dh) * it + wbytes + \
        b * l * 4 + (pairs * 4 if constrained else 0) + \
        (pairs * h * it if training else 0)
    mm = pairs * (2 * ew * 2 * h + 2 * dh + 2 * dh + 2 * h * ew
                  + 2 * 2 * ew * hid)
    return Work(nbytes, mm, pairs * (20 * ew + hid + 15 * h))


def k4(b, l, ew, h, hid, it) -> Work:
    """Whole-layer backward, the edge tail (also K9's work)."""
    pairs = b * l * l
    nw = h * ew + 3 * ew + 2 * ew * hid + hid + ew
    nbytes = (3 * pairs * ew + 2 * pairs * h) * it + \
        (h * ew + 2 * ew * hid) * it + (4 * ew + hid) * 4 + nw * 4
    return Work(nbytes, pairs * 2 * (3 * h * ew + 5 * ew * hid),
                pairs * (30 * ew + 5 * hid))


def k5(b, l, ew, h, dh, it, constrained=False) -> Work:
    """Whole-layer backward, the attention and the edge head."""
    pairs = b * l * l
    nproj = 2 * h
    nbytes = (3 * pairs * ew + 2 * pairs * h + b * l * 3 * dh
              + 2 * b * l * dh + 2 * ew * h) * it + \
        (2 * b * l * dh + ew * nproj + nproj + 2 * ew) * 4 + b * l * 4 + \
        (pairs * 4 if constrained else 0)
    return Work(nbytes, pairs * (6 * ew * nproj + 8 * dh),
                pairs * (20 * ew + 40 * h))


def k8(b, l, ew, h, hid, it) -> Work:
    """Edge-block forward: h_hat and e read, e out written."""
    n = b * l * l
    wbytes = (h * ew + 2 * ew * hid) * it + (4 * ew + hid) * 4
    return Work(n * (h + 2 * ew) * it + wbytes,
                n * 2 * (h * ew + 2 * ew * hid), n * (12 * ew + 2 * hid))


def k9(b, l, ew, h, hid, it) -> Work:
    """Edge-block backward (K4's work on the edge block's inputs)."""
    n = b * l * l
    wbytes = (h * ew + 2 * ew * hid) * it + (4 * ew + hid) * 4
    nw = h * ew + 3 * ew + 2 * ew * hid + hid + ew
    return Work(n * (2 * h + 3 * ew) * it + wbytes + nw * 4,
                n * 2 * (3 * h * ew + 5 * ew * hid),
                n * (30 * ew + 5 * hid))


def k7(b, l, ew, h, dh, hid, it, constrained=False) -> Work:
    """Merged backward (K4 then K5 in one launch): the composition floor,
    which also reads h_hat."""
    w6 = k6(b, l, ew, h, dh, hid, it, constrained)
    return Work(w6.nbytes + b * l * l * h * it, w6.mm_flops - b * l * l * 2 * dh,
                w6.ew_flops)


def k6(b, l, ew, h, dh, hid, it, constrained=False) -> Work:
    """Mono backward (h_hat recomputed from q.k): the composition floor."""
    pairs = b * l * l
    nproj = 2 * h
    nw = h * ew + 3 * ew + 2 * ew * hid + hid + ew
    nbytes = (3 * pairs * ew + b * l * 3 * dh + 2 * b * l * dh) * it + \
        (h * ew + 2 * ew * hid + 2 * ew * h) * it + \
        (2 * b * l * dh + nw + ew * nproj + nproj + 2 * ew) * 4 + \
        b * l * 4 + (pairs * 4 if constrained else 0)
    mm = pairs * 2 * (3 * h * ew + 5 * ew * hid) + \
        pairs * (6 * ew * nproj + 8 * dh) + pairs * 2 * dh
    return Work(nbytes, mm, pairs * (50 * ew + 5 * hid + 40 * h))


def launch_work(kernel: str, model: dict, b: int, l: int, training: bool,
                bf16: bool) -> Work:
    """The work of one launch of `kernel` (K1-K9) in a batch of b graphs
    at pad l (virtual nodes included), for a model of `model`'s widths
    (width, edge_width, heads, ffn_multiplier)."""
    it = 2 if bf16 else 4
    w, ew, h = model["width"], model["edge_width"], model["heads"]
    hid = round(ew * model["ffn_multiplier"])
    d = w // h
    if kernel == "K1":
        return k1(b, h, l, l, d, it)
    if kernel == "K2":
        return k2(b, h, l, l, d, it)
    if kernel == "K3":
        return k3(b, l, ew, h, w, hid, it, training)
    if kernel == "K4":
        return k4(b, l, ew, h, hid, it)
    if kernel == "K5":
        return k5(b, l, ew, h, w, it)
    if kernel == "K6":
        return k6(b, l, ew, h, w, hid, it)
    if kernel == "K7":
        return k7(b, l, ew, h, w, hid, it)
    if kernel == "K8":
        return k8(b, l, ew, h, hid, it)
    if kernel == "K9":
        return k9(b, l, ew, h, hid, it)
    raise KeyError(kernel)


def forward_flops_per_graph(model: dict, l: int) -> float:
    """Matrix and attention products of one graph's forward at pad l
    (virtual nodes included)."""
    w, ew, h = model["width"], model["edge_width"], model["heads"]
    hn = round(w * model["ffn_multiplier"])
    he = round(ew * model["ffn_multiplier"])
    k = model["num_virtual_nodes"]
    n = l - k                                   # the graph's own rows
    layer = (2 * l * w * 3 * w + 2 * l * w * w + 2 * (l * w * hn + l * hn * w)
             + 2 * 2 * l * l * w
             + 2 * 2 * l * l * ew * h + 2 * l * l * h * ew
             + 2 * (l * l * ew * he + l * l * he * ew))
    hops = model["upto_hop"]
    embed = 2 * (hops - 1) * n ** 3 + 2 * n * n * hops * ew
    din = w * max(1, k) if model["readout"] == "graph" else w
    rows = 1 if model["readout"] == "graph" else n
    readout = 0
    for f in model["mlp_layers"]:
        dout = round(f * w)
        readout += 2 * rows * din * dout
        din = dout
    readout += 2 * rows * din * model["num_targets"]
    return float(layer * model["height"] + embed + readout)
