"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names every cell (``workloads``),
configuration and metric.  The parts live in files of their own under
``portbench/``, found by name:

* a configuration: the ``file`` its entry in ``configs`` gives;
* a traffic mix: ``traffic/<traffic>.json``;
* a per-layer metric: ``metrics/<name>.py``, or, for a metric
  ``<quantity>.<variant>`` (one quantity split by the end-to-end metric
  it moves), ``metrics/<quantity>.py``; its ``read(rec)`` returns the
  metric's value or ``None`` where the run has nothing to read;
* a cell's correctness limits: ``limits/<workload>.json``.

An unknown name raises ``KeyError``.  Adding a cell, a configuration, a
mix or a metric is adding its file and its entry: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list       # the cell's end-to-end metric entries
    per_layer: list        # the cell's per-layer metric entries

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"unknown {what} {name!r}: known "
                   f"{sorted(e['name'] for e in entries)}")


def _json(path: Path, what: str, name: str) -> dict:
    if not path.is_file():
        raise KeyError(f"unknown {what} {name!r}: no file {path}")
    return json.loads(path.read_text())


def load_mix(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """A traffic mix.  Its ``check_rounds`` follow the window's chunking:
    on a chunked plane one round and then one whole chunk."""
    mix = _json(bench_dir / "traffic" / f"{name}.json", "traffic mix", name)
    n = int(mix["check_rounds"])
    want = (1 + int(mix["chunk_rounds"]) if mix["plane"] != "per_round"
            else max(n, 2))
    if n != want:
        raise ValueError(f"traffic mix {name!r}: check_rounds {n}, want "
                         f"{want}")
    return mix


def load_limits(workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "limits" / f"{workload}.json", "cell limits",
                 workload)


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """``read(rec)`` of ``metrics/<metric>.py``, else of the file of the
    quantity before the metric's first dot."""
    for stem in (metric, metric.split(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.is_file():
            break
    else:
        raise KeyError(f"unknown per-layer metric {metric!r}: no reader "
                       f"{path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    w = _named(bench["workloads"], workload, "workload")
    c = _named(bench["configs"], w["config"], "configuration")
    config = _json(root / c["file"], "configuration", w["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, w, config, load_mix(w["traffic"]),
                load_limits(workload), e2e, layer)
