"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) resolves by name to its configuration file
(``configs`` entry ``file``), its traffic file ``traffic/<traffic>.json``
(which names the driver, ``drivers/<driver>.py``), its limits file
``limits/<cell>.json``, and the per-layer metrics that list it, each read by
``layer_metrics/<metric>.py``.  Adding a cell, a configuration or a metric
adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    """One workload entry of the manifest with everything it resolves to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)   # manifest entries this cell reports
    per_layer: list = field(default_factory=list)


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found: run from the root of a checkout")
    return json.loads(path.read_text())


def _check_name(kind: str, name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def _reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or listed
    nowhere (every cell)."""
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(cell_name: str, root: Path = ROOT, manifest: dict | None = None) -> Cell:
    """The cell ``cell_name`` of the manifest under ``root``."""
    man = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; one of {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in man["configs"]}
    conf = configs[w["config"]]
    traffic = _check_name("traffic", w["traffic"])
    bench = root / "perfbench"
    e2e = [m for m in man["end_to_end"] if _reports(m, cell_name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=cell_name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{traffic}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{_check_name('cell', cell_name)}.json").read_text()),
        end_to_end=e2e, per_layer=layer)


def _load_file(kind: str, name: str, root: Path):
    path = root / "perfbench" / kind / f"{_check_name(kind, name)}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"perfbench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    """The driver module ``drivers/<name>.py`` (its ``run(ctx)``)."""
    return _load_file("drivers", name, root)


def layer_reader(name: str, root: Path = ROOT):
    """The reader of per-layer metric ``name``: ``layer_metrics/<name>.py``'s
    ``read(rec)``, which returns a number or None when it finds nothing."""
    return _load_file("layer_metrics", name, root).read
