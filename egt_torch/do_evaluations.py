"""Eval CLI of the port: python -m egt_torch.do_evaluations <config.json>
[--device cpu]

The counterpart of the root `do_evaluations.py`: evaluates the weights that
`weight_file` names (":" the newest epoch snapshot, "" the final weights,
"-" the training checkpoint) on the training, validation and test splits,
and writes predictions/<split>_evals.txt. Runs on the GPU unless `--device`
names another device.
"""

import sys

from .training.schemes import scheme_from_args


def main(argv=None):
    scheme = scheme_from_args(argv, __doc__)
    scheme.do_evaluations()
    return scheme


if __name__ == "__main__":
    main(sys.argv[1:])
