"""Analysis CLI of the port: python -m egt_torch.do_analysis <config.json>
[split] [max_batches] [--device cpu]

The counterpart of the root `do_analysis.py`: dumps the per-layer attention
logits, matrices, gates and edge biases of the weights that `weight_file`
names on the split's first `max_batches` batches (default: test, 1) to
predictions/<split>_analysis.npz. Runs on the GPU unless `--device` names
another device; capture runs the plain path, no kernel.
"""

import sys

from .training.schemes import cli_scheme


def main(argv=None):
    scheme, args = cli_scheme(argv, __doc__, (
        ("split", str, "test", "split to analyse (default: test)"),
        ("max_batches", int, 1, "batches to analyse (default: 1)")))
    scheme.do_analysis(args.split, args.max_batches)
    return scheme


if __name__ == "__main__":
    main(sys.argv[1:])
