"""Finalize CLI of the port: python -m egt_torch.end_training <config.json>
[--device cpu]

The counterpart of the root `end_training.py`: rebuilds the model, restores
the latest checkpoint and saves the final weights. Runs on the GPU unless
`--device` names another device.
"""

import sys

from .training.schemes import scheme_from_args


def main(argv=None):
    scheme = scheme_from_args(argv, __doc__)
    scheme.finalize_training()
    return scheme


if __name__ == "__main__":
    main(sys.argv[1:])
