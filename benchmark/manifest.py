"""BENCHMARK.json and the files it names, found by name:

- a configuration: the file of its `configs` entry (benchmark/configs/<name>.json);
- a traffic mix: benchmark/traffic/<traffic>.json;
- a metric, end-to-end or per-layer: its reader benchmark/metrics/<name>.py,
  a module with `read(run) -> float | None` (None: nothing to read here,
  and the metric is left out of the line).

`problems(manifest, root)` checks the manifest against the benchmark's
contract as far as the files can show it; benchmark/tests run it.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def reader(name: str, here: Path = HERE) -> Callable:
    """The `read` function of benchmark/metrics/<name>.py."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reported(manifest: dict, cell: str) -> Dict[str, List[dict]]:
    """The metrics a cell reports: {"end_to_end": [...], "per_layer": [...]}.
    An end-to-end metric without `workloads` is every cell's; a per-layer one
    without it is every cell's that reports the metric it moves."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def problems(manifest: dict, root: Path = ROOT, here: Optional[Path] = None) -> List[str]:
    """What in the manifest and the files it names breaks the contract."""
    here = here or root / "benchmark"
    out = []
    if set(manifest) != TOP_KEYS:
        out.append(f"top-level keys {sorted(manifest)}")
    if not (isinstance(manifest.get("run_seconds"), int) and 1 <= manifest["run_seconds"] <= 51):
        out.append("run_seconds must be a whole number from 1 to 51")
    names = []

    def named(entry, what, keys, extra=()):
        if not set(keys) <= set(entry) or set(entry) - set(keys) - set(extra):
            out.append(f"{what} {entry.get('name')!r} has keys {sorted(entry)}")
        name = entry.get("name", "")
        if not NAME.match(name):
            out.append(f"{what} name {name!r}")
        names.append((what, name))

    for c in manifest["configs"]:
        named(c, "configuration", CONFIG_KEYS)
        if not (root / c["file"]).exists():
            out.append(f"configuration file {c['file']} is missing")
        elif _json(root / c["file"]).get("reduced") != c["reduced"]:
            out.append(f"configuration {c['name']!r}: reduced differs from its file's")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"reduced key {key!r}")
    cells = manifest["workloads"]
    for w in cells:
        named(w, "workload", WORKLOAD_KEYS)
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']!r} asks for {w['chips']} chips")
        if w["config"] not in {c["name"] for c in manifest["configs"]}:
            out.append(f"workload {w['name']!r} names no configuration")
        if not NAME.match(w["traffic"]) or not (here / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"workload {w['name']!r}: no traffic file for {w['traffic']!r}")
        if len(w["why"]) > 200:
            out.append(f"workload {w['name']!r}: why over 200 characters")
    pairs = [(w["config"], w["traffic"]) for w in cells]
    if len(set(pairs)) != len(pairs):
        out.append("a pair of configuration and traffic appears twice")
    four = sum(w["chips"] == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        out.append(f"{four} four-chip cells of {len(cells)}")
    unused = {c["name"] for c in manifest["configs"]} - {w["config"] for w in cells}
    if unused:
        out.append(f"configurations no cell uses: {sorted(unused)}")
    e2e_names = {m["name"] for m in manifest["end_to_end"]}
    if "setup_s" not in e2e_names:
        out.append("no setup_s")
    for m in manifest["end_to_end"]:
        named(m, "end-to-end metric", E2E_KEYS, extra=("workloads",))
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"end-to-end metric {m['name']!r} from {m.get('source')!r}")
        if not 0.01 <= m.get("bound", 0) <= 0.25:
            out.append(f"end-to-end metric {m['name']!r} bound {m.get('bound')}")
    for m in manifest["per_layer"]:
        named(m, "per-layer metric", LAYER_KEYS, extra=("workloads",))
        if m.get("source") not in SOURCES:
            out.append(f"per-layer metric {m['name']!r} from {m.get('source')!r}")
        if m["moves"] not in e2e_names:
            out.append(f"per-layer metric {m['name']!r} moves {m['moves']!r}, not end to end")
        for cell in m.get("workloads", []):
            if cell not in {w["name"] for w in cells}:
                out.append(f"per-layer metric {m['name']!r} lists {cell!r}, no cell")
            elif m["moves"] not in {x["name"] for x in reported(manifest, cell)["end_to_end"]}:
                out.append(f"{cell!r} lists {m['name']!r} but does not report {m['moves']!r}")
        if "\n" in m["layer"] or "\t" in m["layer"] or not 1 <= len(m["layer"]) <= 200:
            out.append(f"per-layer metric {m['name']!r} layer")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(m.get("unit", "")):
            out.append(f"metric {m['name']!r} unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']!r} better {m.get('better')!r}")
        if not (here / "metrics" / f"{m['name']}.py").exists():
            out.append(f"metric {m['name']!r} has no reader")
    seen = {}
    for what, name in names:
        kind = "metric" if "metric" in what else what
        if (kind, name) in seen:
            out.append(f"two {kind}s named {name!r}")
        seen[(kind, name)] = True
    for w in cells:
        rep = reported(manifest, w["name"])
        if len(rep["end_to_end"]) < 2 or not rep["per_layer"]:
            out.append(f"cell {w['name']!r} reports {len(rep['end_to_end'])} end-to-end and "
                       f"{len(rep['per_layer'])} per-layer metrics")
    return out
