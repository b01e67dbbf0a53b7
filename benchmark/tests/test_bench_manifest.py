"""BENCHMARK.json against the benchmark's contract: its keys, names,
units, references between entries and the files it names."""
import json
import re

from conftest import ROOT

from benchmark import manifest

MAN = manifest.load()
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]
TEXT = re.compile(r"[^\t\n]{1,200}")


def test_top_level_keys_and_size():
    assert list(MAN) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["command"][:2] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_no_problems():
    assert manifest.problems(MAN) == []


def test_entries_have_only_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for kind, want in keys.items():
        for e in MAN[kind]:
            assert set(e) - {"workloads"} == want, e["name"]


def test_text_fields():
    for e in MAN["configs"] + MAN["workloads"]:
        assert TEXT.fullmatch(e["why"])
    for e in MAN["configs"]:
        assert TEXT.fullmatch(e["source"])
    for m in MAN["per_layer"]:
        assert TEXT.fullmatch(m["layer"])
    for word in MAN["command"]:
        assert TEXT.fullmatch(word) and not word.startswith("/")


def test_every_moves_target_is_reported_where_listed():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(MAN, "end_to_end",
                                                      w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(MAN, "per_layer", w["name"])


def test_configs_state_their_cuts_and_limits_their_readings():
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"]
    for w in MAN["workloads"]:
        lim = manifest.limits(w["name"])
        assert set(lim["limits"]) == set(lim["readings"])


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in MAN["end_to_end"]}[
        "setup_s"] == 0.25


def test_problems_sees_a_broken_manifest():
    bad = json.loads(json.dumps(MAN))
    bad["workloads"][0]["name"] = "has space"
    bad["per_layer"][0]["moves"] = "no_such_metric"
    bad["end_to_end"][0]["unit"] = "member steps per s"
    found = manifest.problems(bad)
    assert any("has space" in p for p in found)
    assert any("no_such_metric" in p for p in found)
    assert any("unit" in p for p in found)
