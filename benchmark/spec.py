"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a metric is a reader of its
own.  Each lives in a file of its own, so a later change adds a cell, a
mix or a metric by adding files and entries, and edits none:

* ``configs/<config>.json``, the configuration's ``file``: the scene
  document as it is rendered, the ``RenderConfig`` fields it sets and its
  provenance; where it names ``assets`` (a directory from the root of the
  checkout), the scene's files are read from there and each file that
  ``sha256`` lists has to hash to its value, so the data the benchmark
  renders cannot change under it;
* ``traffic/<traffic>.json``: the parameters of a mix, which the one
  generator in ``loops.py`` reads;
* ``metrics/<metric>.py``: ``read(rec)``, the metric's value from a run's
  record, or None where the record has nothing to read; a metric
  ``<base>.<variant>`` without a file of its own, such as one named apart
  to carry a bound of its own, is read by ``metrics/<base>.py``;
* ``limits/<cell>.json``: each number the output check compares, with its
  limit and the readings the limit was set from.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(Exception):
    """A name that ``BENCHMARK.json`` or the benchmark's files do not hold."""


def _load_json(path: pathlib.Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"{path} is missing") from None


class Spec:
    def __init__(self, doc: dict, root: pathlib.Path = ROOT, here: pathlib.Path = HERE):
        self.doc, self.root, self.here = doc, root, here

    @classmethod
    def load(cls, root: pathlib.Path = ROOT, here: pathlib.Path = HERE) -> "Spec":
        return cls(_load_json(root / "BENCHMARK.json"), root, here)

    def _named(self, key: str, name: str) -> dict:
        for entry in self.doc[key]:
            if entry["name"] == name:
                return entry
        raise SpecError(f"BENCHMARK.json has no {key[:-1] if key.endswith('s') else key} {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._named("configs", name)
        doc = _load_json(self.root / entry["file"])
        base = self.root / doc["assets"] if "assets" in doc else (self.root / entry["file"]).parent
        for rel, want in doc.get("sha256", {}).items():
            try:
                got = hashlib.sha256((base / rel).read_bytes()).hexdigest()
            except FileNotFoundError:
                raise SpecError(f"{base / rel} is missing") from None
            if got != want:
                raise SpecError(f"{base / rel} has changed: sha256 {got}, not {want}")
        doc["dir"] = str(base)
        return doc

    def traffic(self, name: str) -> dict:
        return _load_json(self.here / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _load_json(self.here / "limits" / f"{cell}.json")

    def end_to_end(self, cell: dict) -> list:
        """The end-to-end metrics ``cell`` reports: those that list it or
        list no cells."""
        return [m for m in self.doc["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list:
        """The per-layer metrics ``cell`` reports: those that list it, and
        those that list no cells where the metric they move is reported."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if cell["name"] in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``, or of ``metrics/<base>.py``
        for a metric ``<base>.<variant>`` without a file of its own."""
        path = self.here / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.here / "metrics" / f"{metric.split('.')[0]}.py"
        if not path.exists():
            raise SpecError(f"{self.here / 'metrics' / metric}.py is missing")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
