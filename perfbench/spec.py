"""The benchmark's description (``BENCHMARK.json`` at the root of the
checkout) and the files each of its names stands for. Everything of one
configuration, traffic mix or metric sits in files of its own, found by
name:

  configs/<config>.json     the configuration as it is run; its "module"
                            names the two files below (default: <config>)
  configs/<module>.py       builds the program's problem; θ's sampler
  reference/<module>.py     the plain reference
  traffic/<traffic>.json    the traffic's parameters; "loop" names its loop
  loops/<loop>.py           the driving loop
  end_to_end/<metric>.py    reader of an end-to-end metric, over the window
  metrics/<metric>.py       reader of a per-layer metric, over the trace

A metric split by group of cells, ``<metric>.<group>`` (each group's cells
report their own end-to-end metric), takes ``<metric>.py`` where it has no
reader of its own.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module, by its path (names may hold
    dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = "perfbench._by_name." + path.relative_to(HERE).with_suffix("").as_posix().replace(
        "/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def make_cell(name: str, config: str, traffic: str, chips: int = 1,
              end_to_end=(), per_layer=()) -> Cell:
    """A cell from the names of its configuration and traffic files."""
    return Cell(name=name, config_name=config, traffic_name=traffic, chips=int(chips),
                config=read_json(HERE / "configs" / f"{config}.json"),
                traffic=read_json(HERE / "traffic" / f"{traffic}.json"),
                end_to_end=tuple(end_to_end), per_layer=tuple(per_layer))


def cell(name: str, bench: dict) -> Cell:
    """The workload ``name`` of ``bench`` with its files read."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    w = entries[0]
    return make_cell(name, w["config"], w["traffic"], w["chips"],
                     (m for m in bench["end_to_end"] if _reports(m, name)),
                     (m for m in bench["per_layer"] if _reports(m, name)))


def _module_name(cell: Cell) -> str:
    return cell.config.get("module", cell.config_name)


def config_module(cell: Cell) -> ModuleType:
    return load_module(HERE / "configs" / f"{_module_name(cell)}.py")


def reference_module(cell: Cell) -> ModuleType:
    return load_module(HERE / "reference" / f"{_module_name(cell)}.py")


def loop_module(cell: Cell) -> ModuleType:
    return load_module(HERE / "loops" / f"{cell.traffic['loop']}.py")


def _reader(folder: str, metric: str) -> ModuleType:
    path = HERE / folder / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = HERE / folder / f"{metric.rsplit('.', 1)[0]}.py"
    return load_module(path)


def end_to_end_reader(metric: str) -> ModuleType:
    return _reader("end_to_end", metric)


def per_layer_reader(metric: str) -> ModuleType:
    return _reader("metrics", metric)
