"""What the harness finds by name: the manifest, a cell's configuration,
traffic and limits, and the per-layer metric readers.

``BENCHMARK.json`` (at the checkout's root) names the cells as
(configuration, traffic, chips) and the metrics. Everything that belongs to
one of them lives in a file of its own under this folder:

    configs/<config>.json   a deployment (frame, views, profile, rounds)
    traffic/<traffic>.json  a mix: round, pass, the problems the window
                            cycles over, scene options
    limits/<cell>.json      the limits of the numbers that decide ``correct``
    metrics/<metric>.py     a per-layer metric's reader: ``LAYER``,
                            ``MOVES`` and ``read(ctx)``

so that a new cell or metric is new files and a new manifest entry, with no
edit to the harness.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
# Top-level module names the benchmark's process may never hold: the JAX
# package and JAX itself. Compared whole, so the port (whose name begins
# with the JAX package's) is not one of them.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "dpe_mvs_tpu"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The names among ``names`` (e.g. ``sys.modules``) whose top-level
    package, the part before the first dot, is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / config_entry(manifest, name)["file"])


def load_traffic(name: str, here: Path = HERE) -> dict:
    return _json(Path(here) / "traffic" / f"{name}.json")


def load_limits(cell_name: str, here: Path = HERE) -> Dict[str, float]:
    return _json(Path(here) / "limits" / f"{cell_name}.json")["limits"]


def metric_file(name: str, here: Path = HERE) -> Path:
    return Path(here) / "metrics" / f"{name}.py"


def load_metric(name: str, here: Path = HERE) -> ModuleType:
    """The reader module of per-layer metric ``name`` (its file name holds
    dots, so it is loaded by path)."""
    path = metric_file(name, here)
    spec = importlib.util.spec_from_file_location(
        "mvs_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_files(here: Path = HERE) -> List[str]:
    """The names of every metric file in ``metrics/``."""
    return sorted(p.stem for p in (Path(here) / "metrics").glob("*.py"))


def metrics_for(manifest: dict, kind: str, cell_name: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those without ``workloads`` and those that list it."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell_name in m["workloads"]]

