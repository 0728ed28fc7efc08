"""What a run is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and each
metric; the files behind those names sit under ``perfbench/``:

* ``configs/<config>.json``: the deployment (dataset and its sizes, ``d``,
  the execution policy, the guarantee and the check's limits);
* ``traffic/<traffic>.json``: the parameters the one traffic generator
  (``perfbench.harness.traffic``) reads;
* ``clients/<client>.py``: how one request is issued to the program,
  ``make(db, d, mix)``, named by a mix's ``client``;
* ``metrics/<metric>.py``: one reader per metric, ``read(obs)``, which
  returns the metric's value or ``None`` where it finds nothing to read.

A new cell, configuration, mix or metric is new files and entries; no
code here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]      # perfbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # metric entries this cell reports with --trace 0
    per_layer: list       # ... and with --trace 1


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = _load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(ROOT / configs[w["config"]]["file"])
    traffic = _load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def _module(folder: str, name: str):
    """``perfbench/<folder>/<name>.py``, loaded from its file."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def client(name: str):
    """The ``make`` function of ``clients/<name>.py``."""
    return _module("clients", name).make
