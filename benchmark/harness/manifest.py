"""BENCHMARK.json and the files it names: a cell's configuration, traffic
mix and limits, and each metric's reader, all found by name."""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell_: dict, root: pathlib.Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell_["config"]:
            return read_json(root / c["file"])
    raise KeyError(f"no config named {cell_['config']!r}")


def traffic_of(cell_: dict) -> dict:
    return read_json(BENCH_DIR / "traffic" / f"{cell_['traffic']}.json")


def limits_of(cell_: dict) -> dict:
    return read_json(BENCH_DIR / "limits" / f"{cell_['name']}.json")


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in moved]


def reader(name: str):
    """The `read(ctx)` of the metric's own module, metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(bench: dict, root: pathlib.Path = ROOT) -> list:
    """What in BENCHMARK.json breaks the naming and wiring rules."""
    out = []
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            names.append((kind, e["name"]))
            if not NAME_RE.match(e["name"]):
                out.append(f"{kind} name {e['name']!r}")
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                out.append(f"unit {e['unit']!r} of {e['name']}")
            if "source" in e and kind != "configs" and (
                    e["source"] not in SOURCES):
                out.append(f"source {e['source']!r} of {e['name']}")
    for kind in ("configs", "workloads"):
        seen = [n for k, n in names if k == kind]
        if len(seen) != len(set(seen)):
            out.append(f"duplicate {kind} names")
    metric_names = [n for k, n in names if k in ("end_to_end", "per_layer")]
    if len(metric_names) != len(set(metric_names)):
        out.append("duplicate metric names")
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        if not (root / c["file"]).exists():
            out.append(f"config file {c['file']} missing")
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                out.append(f"reduced key {k!r}")
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        if w["config"] not in configs:
            out.append(f"{w['name']}: config {w['config']!r} unknown")
        if not (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"{w['name']}: traffic file missing")
        if not (BENCH_DIR / "limits" / f"{w['name']}.json").exists():
            out.append(f"{w['name']}: limits file missing")
        if not NAME_RE.match(w["traffic"]):
            out.append(f"{w['name']}: traffic name")
        e2e = metrics_of(bench, w["name"], False)
        if not any(m["name"] == "setup_s" for m in e2e) or len(e2e) < 2:
            out.append(f"{w['name']}: needs setup_s and one more end-to-end "
                       "metric")
        if not metrics_of(bench, w["name"], True):
            out.append(f"{w['name']}: reports no per-layer metric")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    if len(pairs) != len(set(pairs)):
        out.append("a (config, traffic) pair appears twice")
    e2e_names = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not (BENCH_DIR / "metrics" / f"{m['name']}.py").exists():
            out.append(f"metric {m['name']}: reader missing")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"metric {m['name']}: cell {w!r} unknown")
    for m in bench["per_layer"]:
        target = e2e_names.get(m["moves"])
        if target is None:
            out.append(f"{m['name']} moves unknown {m['moves']!r}")
            continue
        for w in m.get("workloads", list(cells)):
            if w not in target.get("workloads", [w]):
                out.append(f"{m['name']}: cell {w} does not report "
                           f"{m['moves']}")
    return out
