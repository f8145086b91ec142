"""Hierarchical hyper-parameter dictionaries with lazy derived defaults.

The port's own copy of `egt_tpu/utils/hparams.py` (the port imports nothing from
`egt_tpu`). A re-design of the reference's config system (`lib/base/dotdict/dotdict.py:3-117`
and the strict unknown-key merge in `lib/training/training_base.py:24-31`).  The reference
stores derived defaults as string-lambda macros evaluated against the config; here the same
capability is provided by `Derived`, a first-class callable wrapper, so configs stay plain
Python (no `eval` of user strings) while the *behavior* — lazily computed defaults that see
user overrides — is identical.
"""

from __future__ import annotations

import json
import posixpath
from typing import Any, Callable


class Derived:
    """A lazily-evaluated config value: ``fn(config) -> value``.

    Mirrors `HDict.L('c: expr')` of the reference (`dotdict.py:23-37`): the function is
    re-evaluated against the *current* config every time the key is read, so derived
    defaults (paths, distributed batch sizes, ...) pick up user overrides automatically.
    """

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[["HParams"], Any]):
        self.fn = fn

    def __call__(self, config: "HParams") -> Any:
        return self.fn(config)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Derived({self.fn!r})"


def join_path(*parts: str) -> str:
    """posix join, exposed for use inside Derived lambdas (as `path.join` was)."""
    return posixpath.join(*parts)


class HParams(dict):
    """Attribute-access dict whose values may be `Derived` macros.

    Reading an attribute (or calling :meth:`resolved`) evaluates macros against `self`;
    reading via plain ``[]`` returns the raw stored value.
    """

    def __getattr__(self, key: str) -> Any:
        try:
            value = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(value, Derived):
            value = value(self)
        return value

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __dir__(self):
        return list(super().__dir__()) + list(self.keys())

    def strict_update(self, overrides: dict | None) -> "HParams":
        """Merge user overrides, raising on unknown keys.

        Mirrors `TrainingBase.__init__` (`training_base.py:26-31`): every key in
        `overrides` must already exist in the default config.
        """
        if overrides is None:
            return self
        for k in overrides:
            if k not in self:
                raise KeyError(f'Unknown config "{k}"')
        self.update(overrides)
        return self

    def resolved(self) -> dict:
        """Return a plain dict with every `Derived` macro evaluated (for serialization)."""
        out = {}
        for key, value in self.items():
            if isinstance(value, Derived):
                value = value(self)
            if isinstance(value, HParams):
                value = value.resolved()
            out[key] = value
        return out


def read_config_from_file(config_file: str) -> dict:
    with open(config_file, "r") as fp:
        return json.load(fp)


def save_config_to_file(config: dict, config_file: str) -> None:
    with open(config_file, "w") as fp:
        json.dump(config, fp, indent="\t")
