"""Scheme registry: resolve '<dataset>.<pe>' names to scheme classes.

Port of `egt_tpu/training/schemes/__init__.py` (the reference's
`lib/training/importer.py:4-12`) for the schemes ported so far: zinc.svd and
zinc.eig. The others raise NotImplementedError (ROADMAP §A item 6).
"""

from __future__ import annotations

import argparse
import importlib

import torch

from ...utils.hparams import read_config_from_file

_MODULES = {
    "zinc": ".zinc",
}


def import_scheme(scheme_name: str):
    """'zinc.svd' -> scheme class."""
    ds, _, pe = scheme_name.partition(".")
    if ds not in _MODULES:
        raise NotImplementedError(
            f"scheme {scheme_name!r} is not ported yet (ported: "
            f"{', '.join(available_schemes())}; ROADMAP §A item 6)")
    mod = importlib.import_module(_MODULES[ds], package=__name__)
    schemes = getattr(mod, "SCHEMES")
    if pe not in schemes:
        raise KeyError(f"unknown scheme variant {scheme_name!r}; "
                       f"known for {ds}: {sorted(schemes)}")
    return schemes[pe]


def available_schemes() -> list[str]:
    names = []
    for ds, modpath in _MODULES.items():
        mod = importlib.import_module(modpath, package=__name__)
        names.extend(f"{ds}.{pe}" for pe in mod.SCHEMES)
    return sorted(names)


def scheme_from_args(argv, description: str):
    """The scheme of a CLI's `<config.json> [--device DEV]` arguments: the
    config's scheme class on that config, on the card unless `--device`
    names another device."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("config", help="run config (JSON)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the GPU)")
    args = parser.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --device cpu to run "
                     "on the CPU")
    config = read_config_from_file(args.config)
    return import_scheme(config["scheme"])(config, device=args.device)
