"""A new cell needs only new files and new entries: a throwaway
configuration, traffic mix, limits file and per-layer metric, added to a
copy of the benchmark, are found by name and run, and no file that was
there changes."""
import hashlib
import json
import shutil

from conftest import ROOT

from benchmark import manifest

DATA = ("configs", "traffic", "limits", "layer_metrics")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for d in DATA for p in (root / "benchmark" / d).glob("*")}


def test_new_cell_from_new_files_only(tmp_path, run_cell):
    for d in DATA:
        shutil.copytree(ROOT / "benchmark" / d, tmp_path / "benchmark" / d)
    (tmp_path / "trained_models").symlink_to(ROOT / "trained_models")
    before = _digests(tmp_path)
    here = tmp_path / "benchmark"

    cfg = json.loads((here / "configs" / "eddy_gan_64.json").read_text())
    cfg["name"] = "throwaway_gan"
    (here / "configs" / "throwaway_gan.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "ensemble10_2000.json").read_text())
    mix["snapshots"] = 5
    (here / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (here / "limits" / "throwaway_cell.json").write_text(
        (here / "limits" / "gan64_online.json").read_text())
    (here / "layer_metrics" / "throwaway.members.py").write_text(
        "def read(ctx):\n    return float(ctx.traffic['members'])\n")

    man = manifest.load()
    man["configs"].append({"name": "throwaway_gan", "source": "a test",
                           "file": "benchmark/configs/throwaway_gan.json",
                           "reduced": cfg["reduced"], "why": "a test"})
    man["workloads"].append({"name": "throwaway_cell",
                             "config": "throwaway_gan",
                             "traffic": "throwaway_mix", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if "workloads" in m and "gan64_online" in m["workloads"]:
            m["workloads"].append("throwaway_cell")
    man["per_layer"].append({
        "name": "throwaway.members", "unit": "members", "better": "higher",
        "source": "program_counter", "layer": "a test",
        "moves": "online_member_steps_per_s",
        "workloads": ["throwaway_cell"]})
    assert manifest.problems(man, tmp_path) == []

    out = run_cell("throwaway_cell", trace=1, man=man, root=tmp_path)
    assert out["metrics"]["throwaway.members"]["value"] == 2.0  # shrunk
    assert out["correct"]
    out = run_cell("throwaway_cell", trace=0, man=man, root=tmp_path)
    assert set(out["metrics"]) == {"online_member_steps_per_s", "setup_s"}
    after = _digests(tmp_path)
    assert {k: after[k] for k in before} == before
