"""Scheme registry: resolve '<dataset>.<pe>' names to scheme classes.

Port of `egt_tpu/training/schemes/__init__.py` (the reference's
`lib/training/importer.py:4-12`), with every scheme of the JAX package:
zinc, zinc_full, pattern and cluster, each .svd and .eig, mnist.svd,
cifar10.svd, tsp.svd, and pcqm4mv2.base and .svd.
"""

from __future__ import annotations

import argparse
import importlib

import torch

from ...utils.hparams import read_config_from_file

_MODULES = {
    "zinc": ".zinc",
    "zinc_full": ".zinc_full",
    "pattern": ".pattern",
    "cluster": ".cluster",
    "mnist": ".mnist",
    "cifar10": ".cifar10",
    "tsp": ".tsp",
    "pcqm4mv2": ".pcqm4mv2",
}


def import_scheme(scheme_name: str):
    """'zinc.svd' -> scheme class."""
    ds, _, pe = scheme_name.partition(".")
    if ds not in _MODULES:
        raise KeyError(f"unknown scheme dataset {ds!r}; "
                       f"known: {sorted(_MODULES)}")
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
    return cli_scheme(argv, description)[0]


def cli_scheme(argv, description: str, optional=()):
    """(scheme, arguments) of a CLI's `<config.json> [optional ...]
    [--device DEV]`: `optional` holds (name, type, default, help) of the
    positional arguments after the config. Without a GPU and without
    `--device`, a usage error."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("config", help="run config (JSON)")
    for name, kind, default, text in optional:
        parser.add_argument(name, type=kind, default=default, nargs="?",
                            help=text)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the GPU)")
    args = parser.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --device cpu to run "
                     "on the CPU")
    config = read_config_from_file(args.config)
    return import_scheme(config["scheme"])(config, device=args.device), args
