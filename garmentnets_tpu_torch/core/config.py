"""YAML configs with dotted CLI overrides (the port's copy of what its CLIs
need from garmentnets_tpu/core/config.py: load_config, load_yaml,
parse_cli, make_run_dir and dump_config).

Configs are read from the repository's configs/ directory. `yaml` is
imported when a config is loaded, so the rest of the port does not need
pyyaml.
"""
from __future__ import annotations

import copy
import datetime
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


def load_yaml(path) -> dict:
    """A YAML file as a dict (the eval CLI reads predict's config.yaml)."""
    with pathlib.Path(path).expanduser().open() as f:
        return _yaml().safe_load(f) or {}


def parse_cli(argv: Sequence[str]) -> list:
    """All arguments of the form key=value are overrides."""
    return [a for a in argv if "=" in a and not a.startswith("-")]


def make_run_dir(base: str = "outputs",
                 run_dir: Optional[str] = None) -> pathlib.Path:
    """`run_dir`, or a new timestamped directory base/YYYY-MM-DD/HH-MM-SS
    (with a -1, -2, ... suffix when that one exists); created."""
    if run_dir is not None:
        out = pathlib.Path(run_dir).expanduser()
    else:
        now = datetime.datetime.now()
        out = (pathlib.Path(base) / now.strftime("%Y-%m-%d")
               / now.strftime("%H-%M-%S"))
        i = 0
        while out.exists():
            i += 1
            out = out.parent / f"{now.strftime('%H-%M-%S')}-{i}"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _to_container(v):
    if isinstance(v, dict):
        return {k: _to_container(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_container(x) for x in v]
    return v


def dump_config(cfg: dict, run_dir, extra: Optional[dict] = None,
                name: str = "config.yaml") -> dict:
    """Write the resolved config snapshot {'config': ..., 'output_dir':
    ..., **extra} to run_dir/name (the eval CLI reads predict's)."""
    payload = {"config": _to_container(copy.deepcopy(dict(cfg))),
               "output_dir": str(run_dir)}
    if extra:
        payload.update(extra)
    with (pathlib.Path(run_dir) / name).open("w") as f:
        _yaml().dump(payload, f, default_flow_style=False)
    return payload
