"""BENCHMARK.json against the contract, and a cell, a configuration, a
traffic mix and a metric added from new files only."""

import json
import shutil

from benchmark import manifest


def test_manifest_meets_contract():
    bench = manifest.load()
    assert manifest.problems(bench) == []


def test_names_and_units():
    bench = manifest.load()
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    assert all(manifest.NAME.match(n) for n in names)
    assert all(manifest.UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    assert not manifest.NAME.match("a b") and not manifest.NAME.match("a/b")
    assert not manifest.UNIT.match("tokens per second")


def test_each_moves_is_reported_where_listed():
    bench = manifest.load()
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in manifest.reported(bench, cell)["end_to_end"]}
            assert m["moves"] in e2e, (m["name"], cell)
    for w in bench["workloads"]:
        rep = manifest.reported(bench, w["name"])
        assert "setup_s" in {m["name"] for m in rep["end_to_end"]}
        assert len(rep["end_to_end"]) >= 2 and rep["per_layer"]


def test_four_chip_share():
    bench = manifest.load()
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    broken = json.loads(json.dumps(bench))
    for w in broken["workloads"][:2]:
        w["chips"] = 4
    assert any("four-chip" in p for p in manifest.problems(broken))


def test_bad_entries_are_named():
    bench = json.loads(json.dumps(manifest.load()))
    bench["per_layer"][0]["moves"] = "nothing"
    bench["end_to_end"][0]["unit"] = "m s"
    bench["workloads"][0]["why"] = "x" * 201
    found = " | ".join(manifest.problems(bench))
    assert "moves 'nothing'" in found and "unit 'm s'" in found and "why over 200" in found


def test_added_files_are_found(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    metric as new files and entries; the harness lists and validates them
    without an edit to any file it already has."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load()
    cfg = json.loads((root / "benchmark/configs/kitti25-rot.json").read_text())
    cfg["name"] = "kitti25-rot-b"
    (root / "benchmark/configs/kitti25-rot-b.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark/traffic/stream-b8.json").read_text())
    traffic["batch"] = 16
    (root / "benchmark/traffic/stream-b16.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/calls.stream.py").write_text(
        "def read(run):\n    return float(len(run.window.calls))\n")
    bench["configs"].append({"name": "kitti25-rot-b", "source": "https://arxiv.org/abs/1905.04153",
                             "file": "benchmark/configs/kitti25-rot-b.json", "reduced": [],
                             "why": "a second configuration"})
    bench["workloads"].append({"name": "kitti25-rot-b.stream-b16", "config": "kitti25-rot-b",
                               "traffic": "stream-b16", "chips": 1, "why": "16 pairs a call"})
    bench["end_to_end"][2]["workloads"].append("kitti25-rot-b.stream-b16")
    bench["per_layer"].append({"name": "calls.stream", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "registration",
                               "moves": "pairs_per_s", "workloads": ["kitti25-rot-b.stream-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = manifest.load(root)
    assert manifest.problems(loaded, root) == []
    assert manifest.config(loaded, "kitti25-rot-b", root)["name"] == "kitti25-rot-b"
    assert manifest.traffic("stream-b16", root / "benchmark")["batch"] == 16
    rep = manifest.reported(loaded, "kitti25-rot-b.stream-b16")
    assert [m["name"] for m in rep["per_layer"]] == ["calls.stream"]
    assert {m["name"] for m in rep["end_to_end"]} == {"pairs_per_s", "setup_s"}

    class Run:
        class window:
            calls = [0, 1, 2]

    assert manifest.reader("calls.stream", root / "benchmark")(Run) == 3.0
