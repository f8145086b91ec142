"""Export CLI of the port: python -m egt_torch.export_serving <config.json>
[output_path] [--device cpu]

The counterpart of the root `export_serving.py`: exports the weights that
`weight_file` names (":" the newest epoch snapshot, "" the final weights,
"-" the training checkpoint) as a self-contained `torch.export` artifact
(default <save_path>/serving/model.pt2), which
`egt_torch.serving.load_serving` loads without the model, scheme or config
code. The artifact runs on the device it was exported on: the GPU unless
`--device` names another device.
"""

import sys

from .training.schemes import cli_scheme


def main(argv=None):
    scheme, args = cli_scheme(argv, __doc__, (
        ("output_path", str, None,
         "artifact path (default: <save_path>/serving/model.pt2)"),))
    scheme.export_serving(args.output_path)
    return scheme


if __name__ == "__main__":
    main(sys.argv[1:])
