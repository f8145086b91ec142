"""Dataset bindings for the 7 GNN benchmarking datasets and PCQM4Mv2.

The port's own copy of `egt_tpu/data/datasets/__init__.py`; only ZINC has a
scheme in the port so far, the others are kept for the schemes to come.

Record schemas, pad values and max lengths mirror the reference bindings under
`lib/data/datasets/*.py`:
  ZINC / ZINC-full: int node tokens, int edge-feature matrix, scalar regression target,
    max_length 40 (`datasets/zinc.py:50`).
  MNIST: 3-dim float node features, 1-dim float edge features, class label,
    max_length 75 (`datasets/mnist.py:50`).
  CIFAR10: 5-dim float node features, 1-dim float edge features, class label,
    max_length 150 (`datasets/cifar10.py:49`).
  PATTERN / CLUSTER: int node tokens, no edge features, per-node labels, dynamic
    length (`datasets/sbm_pattern.py:44`).
  TSP: 2-dim float node features, 1-dim float edge features, N x N edge-label target
    matrix, dynamic length (`datasets/tsp.py:50,117-121`).
"""

from ..dataset import DatasetSpec

ZINC = DatasetSpec(
    name="ZINC", node_feat_kind="int", node_feat_dim=None,
    edge_feat_kind="int", edge_feat_dim=None,
    target_kind="graph_value", max_length=40)

ZINC_FULL = DatasetSpec(
    name="ZINC_full", node_feat_kind="int", node_feat_dim=None,
    edge_feat_kind="int", edge_feat_dim=None,
    target_kind="graph_value", max_length=40)

MNIST = DatasetSpec(
    name="MNIST", node_feat_kind="float", node_feat_dim=3,
    edge_feat_kind="float", edge_feat_dim=1,
    target_kind="graph_label", max_length=75)

CIFAR10 = DatasetSpec(
    name="CIFAR10", node_feat_kind="float", node_feat_dim=5,
    edge_feat_kind="float", edge_feat_dim=1,
    target_kind="graph_label", max_length=150)

SBM_PATTERN = DatasetSpec(
    name="SBM_PATTERN", node_feat_kind="int", node_feat_dim=None,
    edge_feat_kind=None, edge_feat_dim=None,
    target_kind="node_labels", max_length=None)

SBM_CLUSTER = DatasetSpec(
    name="SBM_CLUSTER", node_feat_kind="int", node_feat_dim=None,
    edge_feat_kind=None, edge_feat_dim=None,
    target_kind="node_labels", max_length=None)

TSP = DatasetSpec(
    name="TSP", node_feat_kind="float", node_feat_dim=2,
    edge_feat_kind="float", edge_feat_dim=1,
    target_kind="edge_matrix", max_length=None)

# PCQM4Mv2 (OGB-LSC): multi-column categorical atom/bond features, HOMO-LUMO gap
# regression. The reference repo defers this task to its companion PyTorch repo
# (README.md:14); here it is a first-class binding.
PCQM4MV2 = DatasetSpec(
    name="PCQM4MV2", node_feat_kind="int", node_feat_dim=9,
    edge_feat_kind="int", edge_feat_dim=3,
    target_kind="graph_value", max_length=None)

# standard OGB atom/bond categorical vocab sizes
OGB_ATOM_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
OGB_BOND_DIMS = (5, 6, 2)

SPECS = {
    "pcqm4mv2": PCQM4MV2,
    "zinc": ZINC,
    "zinc_full": ZINC_FULL,
    "mnist": MNIST,
    "cifar10": CIFAR10,
    "sbm_pattern": SBM_PATTERN,
    "sbm_cluster": SBM_CLUSTER,
    "tsp": TSP,
}
