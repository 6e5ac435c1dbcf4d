"""Config system: YAML-section union + typed CLI overrides.

Behavior parity with the reference config system (reference: tools.py:37-46
`read_yamls`, launch.py:22-41 argparse override generation):

  * every ``*.yaml`` in a config dir is loaded; each top-level key is a named
    *section* of flat key->value pairs
  * ``--configs defaults atari atari_pong`` unions the sections left-to-right
  * every resulting key becomes a typed ``--key`` CLI flag (bools parsed from
    strings, ints/floats by example value)
  * the result is one flat namespace object passed everywhere

Design note: we keep the flat-namespace contract (models read ``conf.*``
directly) because it is the API surface users of the reference know, but we
implement it as a frozen dataclass-like object that is hashable.

The PyTorch port keeps its own copy of this framework-free loader so that it
imports nothing of the JAX package; both read the same ``config/*.yaml``.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Any, Dict, List, Optional

import yaml

__all__ = ["Conf", "read_yamls", "build_conf", "apply_overrides", "parse_args"]


def _strtobool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("y", "yes", "t", "true", "on", "1"):
        return True
    if v in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid bool literal: {s!r}")


class Conf:
    """Flat, immutable, hashable configuration namespace.

    Hashability lets a ``Conf`` key caches; immutability keeps modules that
    read it at construction honest.
    """

    __slots__ = ("_d", "_h")

    def __init__(self, d: Dict[str, Any]):
        object.__setattr__(self, "_d", dict(d))
        object.__setattr__(
            self, "_h", hash(tuple(sorted((k, _freeze(v)) for k, v in d.items())))
        )

    def __getattr__(self, name: str) -> Any:
        try:
            return self._d[name]
        except KeyError:
            raise AttributeError(f"Conf has no key {name!r}") from None

    def __getitem__(self, name: str) -> Any:
        return self._d[name]

    def __contains__(self, name: str) -> bool:
        return name in self._d

    def get(self, name: str, default: Any = None) -> Any:
        return self._d.get(name, default)

    def __setattr__(self, name: str, value: Any):
        raise AttributeError("Conf is immutable; use conf.replace(key=value)")

    def replace(self, **kwargs: Any) -> "Conf":
        d = dict(self._d)
        d.update(kwargs)
        return Conf(d)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._d)

    def keys(self):
        return self._d.keys()

    def __reduce__(self):
        # Needed because __slots__ + immutable __setattr__ breaks the default
        # pickle path; Conf objects cross multiprocessing spawn boundaries.
        return (Conf, (self._d,))

    def __hash__(self) -> int:
        return self._h

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Conf) and self._d == other._d

    def __repr__(self) -> str:
        items = ", ".join(f"{k}={v!r}" for k, v in sorted(self._d.items()))
        return f"Conf({items})"


def _freeze(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def read_yamls(config_dir: str) -> Dict[str, Dict[str, Any]]:
    """Load and merge *all* YAML files in a directory into named sections.

    Same contract as the reference loader (tools.py:37-46): later files may
    extend earlier sections; sections are flat dicts.
    """
    sections: Dict[str, Dict[str, Any]] = {}
    paths = sorted(pathlib.Path(config_dir).glob("*.yaml"))
    if not paths:
        raise FileNotFoundError(f"No *.yaml files in {config_dir}")
    for p in paths:
        with open(p) as f:
            doc = yaml.safe_load(f) or {}
        for name, section in doc.items():
            sections.setdefault(name, {}).update(section or {})
    return sections


def build_conf(config_dir: str, configs: List[str]) -> Dict[str, Any]:
    """Union named sections left-to-right into one flat dict."""
    sections = read_yamls(config_dir)
    out: Dict[str, Any] = {}
    for name in configs:
        if name not in sections:
            raise KeyError(f"Config section {name!r} not found in {config_dir}; "
                           f"available: {sorted(sections)}")
        out.update(sections[name])
    return out


def apply_overrides(conf: Dict[str, Any], overrides: Dict[str, str]) -> Dict[str, Any]:
    """Apply string overrides with types inferred from existing values."""
    out = dict(conf)
    for key, sval in overrides.items():
        if key not in out:
            raise KeyError(f"Unknown config key {key!r}")
        cur = out[key]
        out[key] = _coerce(sval, cur)
    return out


def _coerce(sval: Any, example: Any) -> Any:
    if not isinstance(sval, str):
        return sval
    if example is None:
        # untyped key: try int, float, bool, yaml list/dict, else string;
        # empty string -> None
        if sval == "" or sval.lower() == "none":
            return None
        for conv in (int, float):
            try:
                return conv(sval)
            except ValueError:
                pass
        try:
            return _strtobool(sval)
        except ValueError:
            pass
        if sval[:1] in "[{":  # e.g. --reward_decoder_categorical "[-10,0,10]"
            try:
                return yaml.safe_load(sval)
            except yaml.YAMLError:
                pass
        return sval
    if isinstance(example, bool):
        return _strtobool(sval)
    if isinstance(example, int):
        return int(float(sval))
    if isinstance(example, float):
        return float(sval)
    if isinstance(example, (list, tuple)):
        return yaml.safe_load(sval)
    return sval


def parse_args(argv: Optional[List[str]] = None,
               config_dir: str = "./config") -> Conf:
    """Reference-compatible CLI: ``--configs a b c`` plus per-key overrides.

    (reference: launch.py:16-41 — every merged key becomes a typed flag.)
    """
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--configs", nargs="+", required=True)
    pre.add_argument("--config_dir", default=config_dir)
    args, remaining = pre.parse_known_args(argv)

    # 'a,b' entries expand to ['a', 'b'] (reference: launch.py:27-31).
    names = [n for entry in args.configs for n in entry.split(",")]
    merged = build_conf(args.config_dir, names)

    parser = argparse.ArgumentParser(parents=[pre])
    for key, value in merged.items():
        # Every conversion goes through _coerce with the merged value as the
        # type example: bools parse "true/false", ints accept "1e5", None-
        # typed keys infer int/float/bool/None, list-typed keys yaml-parse
        # ("[1,2,3]") instead of argparse's char-splitting.
        parser.add_argument(f"--{key}", type=lambda s, ex=value: _coerce(s, ex),
                            default=value)
    final = parser.parse_args(argv)
    d = vars(final)
    d.pop("config_dir", None)
    d.pop("configs", None)
    return Conf(d)
