"""YAML configs with dotted CLI overrides (the port's copy of what its CLIs
need from garmentnets_tpu/core/config.py: load_config and parse_cli).

Configs are read from the repository's configs/ directory. `yaml` is
imported when a config is loaded, so the rest of the port does not need
pyyaml.
"""
from __future__ import annotations

import pathlib
from typing import Optional, Sequence

CONFIG_DIR = pathlib.Path(__file__).resolve().parents[2] / "configs"


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("loading a YAML config needs the pyyaml package "
                          "(import yaml failed)") from e
    return yaml


def apply_override(cfg: dict, dotted_key: str, value) -> None:
    parts = dotted_key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def load_config(name: str, overrides: Optional[Sequence[str]] = None,
                config_dir: Optional[pathlib.Path] = None) -> dict:
    """Load configs/<name>.yaml and apply key=value dotted overrides (each
    value parsed as YAML)."""
    yaml = _yaml()
    path = pathlib.Path(config_dir or CONFIG_DIR) / f"{name}.yaml"
    with path.open() as f:
        cfg = yaml.safe_load(f) or {}
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        apply_override(cfg, key.strip(), yaml.safe_load(val))
    return cfg


def parse_cli(argv: Sequence[str]) -> list:
    """All arguments of the form key=value are overrides."""
    return [a for a in argv if "=" in a and not a.startswith("-")]
