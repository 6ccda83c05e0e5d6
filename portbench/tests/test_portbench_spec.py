"""The benchmark finds every part of a cell by name, and its
BENCHMARK.json keeps to the contract's shape."""
import json
import re

import pytest

from _tiny import ROOT
from portbench.harness import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_parts_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.mix["plane"] in ("device", "per_round")
    assert set(cell.limits) >= {"ids_mismatch"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names
    assert any(n.startswith("round_ms.") for n in names)
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("what, call", [
    ("workload", lambda: spec.load_cell("no-such-cell")),
    ("traffic mix", lambda: spec.load_mix("no-such-mix")),
    ("per-layer metric", lambda: spec.reader("no_such_metric")),
    ("cell limits", lambda: spec.load_limits("no-such-cell")),
])
def test_unknown_name_refused(what, call):
    with pytest.raises(KeyError, match=what):
        call()


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["moves"].startswith("round_ms.")
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        assert callable(spec.reader(m["name"]))


def test_config_files_and_sources():
    for c in BENCH["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/")


def test_mix_check_rounds_follow_the_chunking(tmp_path):
    """A chunked plane's checked rounds are one round and one whole chunk,
    the window's own graphs; a mix that asks otherwise is refused."""
    (tmp_path / "traffic").mkdir()
    bad = {"plane": "device", "chunk_rounds": 10, "check_rounds": 3}
    (tmp_path / "traffic" / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="check_rounds 3, want 11"):
        spec.load_mix("bad", bench_dir=tmp_path)
    ok = dict(bad, check_rounds=11)
    (tmp_path / "traffic" / "ok.json").write_text(json.dumps(ok))
    assert spec.load_mix("ok", bench_dir=tmp_path) == ok


def test_split_metric_reads_its_quantitys_file():
    assert spec.reader("mfu.device_plane").__name__ == "mfu"
    assert spec.reader("server_step_ms.per_round")(
        {"ranks": [{"timings": {"server_step_ms": 2.5}}]}) == 2.5
