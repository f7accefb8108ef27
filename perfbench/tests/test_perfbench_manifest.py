"""The manifest and the files it names: every entry keeps the benchmark's
contract, every cell resolves to its files, every reader and driver is found
by name, and a cell, a configuration and a metric are added by adding files
and entries alone."""

import json
import re
import shutil

import pytest

from _cells import ROOT  # noqa: F401  (puts the repo on sys.path)

from perfbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest()


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) <= 64 * 1024


def test_budget_fits_the_full_check(man):
    # 24 cells, each run run_seconds + 60 s, 2 x 90 s of compile a cell, 1200 s spare
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keep_their_keys_and_names(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in man["end_to_end"] + man["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end"):
        assert len({e["name"] for e in man[group]}) == len(man[group])
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(man["workloads"])
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}


def test_each_cell_resolves_and_reports_enough(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    for w in man["workloads"]:
        cell = manifest.resolve(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported and m["moves"] in e2e
            assert callable(manifest.layer_reader(m["name"]))
        assert hasattr(manifest.driver(cell.traffic["driver"]), "run")
        assert cell.limits["limits"]


def test_configs_are_used_and_name_their_cuts(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert set(c["reduced"]) == set(conf["reduced"])
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank")) and "hidden" not in k


def test_a_cell_config_and_metric_are_added_by_files_alone(tmp_path, man):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell and
    a per-layer metric by new files and new manifest entries; every file the
    benchmark had stays byte for byte."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", ".traces", "__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = tmp_path / "perfbench"
    conf = json.loads((ROOT / man["configs"][0]["file"]).read_text())
    conf.update(name="granite-34b-extra", n_layers=1)
    (bench / "configs" / "granite-34b-extra.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "spectral-adam.json").read_text())
    traffic["optimizer"]["spectral_rank"] = 16
    (bench / "traffic" / "extra-rank16.json").write_text(json.dumps(traffic))
    (bench / "limits" / "granite-extra.rank16.json").write_text(
        (bench / "limits" / "granite34b.spectral-adam.json").read_text())
    (bench / "layer_metrics" / "train.extra_count.py").write_text(
        "def read(rec):\n    return rec.get('extra')\n")
    new = json.loads(json.dumps(man))
    new["configs"].append({"name": "granite-34b-extra", "source": man["configs"][0]["source"],
                           "file": "perfbench/configs/granite-34b-extra.json",
                           "reduced": ["n_layers"], "why": "a test's extra configuration"})
    new["workloads"].append({"name": "granite-extra.rank16", "config": "granite-34b-extra",
                             "traffic": "extra-rank16", "chips": 1, "why": "a test's extra cell"})
    for m in new["end_to_end"]:
        if m.get("workloads") and "granite34b.spectral-adam" in m["workloads"]:
            m["workloads"].append("granite-extra.rank16")
    new["per_layer"].append({"name": "train.extra_count", "unit": "count", "better": "lower",
                             "source": "program_counter", "layer": "optimizer",
                             "moves": "train_tokens_per_s", "workloads": ["granite-extra.rank16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    cell = manifest.resolve("granite-extra.rank16", root=tmp_path)
    assert cell.config["n_layers"] == 1 and cell.traffic["optimizer"]["spectral_rank"] == 16
    assert [m["name"] for m in cell.per_layer] == ["train.extra_count"]
    assert [m["name"] for m in cell.end_to_end] == ["train_tokens_per_s", "setup_s"]
    assert manifest.layer_reader("train.extra_count", root=tmp_path)({"extra": 3}) == 3
    assert manifest.driver(cell.traffic["driver"], root=tmp_path).run
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*") if p.is_file() and
             p.relative_to(tmp_path) in before}
    assert after == before


def test_an_unknown_cell_or_bad_name_is_refused():
    with pytest.raises(KeyError):
        manifest.resolve("no-such-cell")
    with pytest.raises(ValueError):
        manifest.layer_reader("../run")
