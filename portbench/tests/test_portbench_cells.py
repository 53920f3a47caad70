"""BENCHMARK.json against the contract, and a cell added by new files
and new entries alone."""

import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import REPO, rehearse

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    assert list(MAN) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_budget():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [m["bound"] for m in MAN["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]
    cells, s = 24, MAN["run_seconds"]
    assert 2 + 14 * cells * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_files(cell):
    spec = harness.cell_spec(cell)
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    assert spec.limits, "no limits file"
    assert harness.driver(spec.traffic["driver"]).run


def test_a_cell_takes_new_files_and_entries_alone(tiny_root):
    """``tiny_root`` got its configurations, traffic, limits and cells by
    new files and new entries: every file the benchmark had is as it was,
    and every entry of BENCHMARK.json is still there, unchanged."""
    for f in (REPO / "portbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            copy = tiny_root / f.relative_to(REPO)
            assert copy.read_bytes() == f.read_bytes(), f
    new = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for key, old in MAN.items():
        if isinstance(old, list) and old and isinstance(old[0], dict):
            assert [x["name"] for x in new[key][:len(old)]] == \
                [x["name"] for x in old]
            for a, b in zip(old, new[key]):
                assert {k: v for k, v in b.items() if k != "workloads"} == \
                    {k: v for k, v in a.items() if k != "workloads"}
                assert b.get("workloads", [])[:len(a.get("workloads", []))] \
                    == a.get("workloads", [])
        else:
            assert new[key] == old
    res, forbidden, _ = rehearse(tiny_root, "tiny.train.t2", 2 ** 31 + 303)
    assert res["correct"] is True and forbidden == []
