"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's file is the entry's ``file``; the mix is
``traffic/<traffic>.json``; the mix's ``kind`` is the driver
``drivers/<kind>.py``; the cell's limits are ``limits/<workload>.json``; a
per-layer metric is ``metrics/<name>.py``; a family's reference is
``reference/<family>.py``. A new cell, mix or metric is new files and an
entry, never an edit.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; known: {sorted(e['name'] for e in entries)}")


def load_module(path: Path, prefix: str) -> ModuleType:
    """The module of a file found by name (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = f"portbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything found by its names."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        self.bench, self.root, self.here = bench, root, root / HERE.name
        self.entry = _by_name(bench["workloads"], workload, "workload")
        self.name = workload
        conf = _by_name(bench["configs"], self.entry["config"], "configuration")
        self.cfg = dict(load_json(root / conf["file"]), name=conf["name"])
        self.traffic = load_json(self.here / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.here / "limits" / f"{workload}.json")

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self) -> ModuleType:
        return load_module(self.here / "drivers" / f"{self.traffic['kind']}.py", "driver")

    def reference(self) -> ModuleType:
        return importlib.import_module(f"portbench.reference.{self.cfg['family']}")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        names = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def reader(self, metric: str) -> ModuleType:
        """The reader of a metric, ``metrics/<metric>.py``."""
        return load_module(self.here / "metrics" / f"{metric}.py", "metric")

    def metric_readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: self.reader(m["name"]) for m in self.per_layer()}
