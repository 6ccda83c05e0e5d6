"""The span readers and the recorded slices (``harness/recorded.py``,
``harness/span_readers.py``): each reader on a synthetic record, nothing
read where nothing was recorded, the card's idle time put under the
innermost host span, and a stamped slice of a tiny cell's program on the
CPU."""
from collections import namedtuple

import pytest
import torch

from _tiny import LENET, one_thread, tiny  # noqa: F401
from portbench.harness import cell as cell_lib
from portbench.harness import recorded, span_readers
from portbench.harness.spec import reader

S = namedtuple("Span", "name start_ns end_ns parent id thread seq")


def _rec(stamped=None, profiled=None):
    return {"ranks": [{"recorded": {"stamped": stamped,
                                    "profiled": profiled}}]}


def test_readers_on_a_synthetic_record():
    c = {"rounds": 4, "span_ns": {"run": 40e6, "chunk.wait": 10e6,
                                  "round.wait": 2e6, "chunk.dispatch": 5e6},
         "device_ns": {"sample": 8e6, "moe": 20e6}, "device_rounds": 4}
    d = {"idle": {"window_s": 2.0, "on_host_s": 0.5}}
    rec = _rec(c, d)
    assert reader("host_busy_ms.device_plane")(rec) == 7.0
    assert reader("idle_on_host_pct.per_round")(rec) == 25.0
    assert reader("sample_span_ms.device_plane")(rec) == 2.0
    assert reader("moe_span_ms.per_round")(rec) == 5.0
    assert reader("gather_span_ms.device_plane")(rec) is None


@pytest.mark.parametrize("rec", [
    {}, {"ranks": []}, {"ranks": [{"wall_s": 1.0}]}, _rec(),
    _rec({"rounds": 0, "span_ns": {}, "device_ns": {}, "device_rounds": 0},
         {"idle": None})])
def test_nothing_recorded_reads_nothing(rec):
    for q in ("host_busy_ms", "idle_on_host_pct", "sample_span_ms",
              "gather_span_ms", "local_update_span_ms", "aggregate_span_ms",
              "server_step_span_ms", "moe_span_ms"):
        assert reader(q)(rec) is None, q


def test_idle_goes_under_the_innermost_span():
    """run [0, 100) with chunk.dispatch [10, 30) and chunk.wait [40, 90);
    a producer thread's span is not the trainer's; kernels [0, 20),
    [50, 60) and [95, 110): idle [20, 30) dispatch, [30, 40) run, [40, 50)
    and [60, 90) wait, [90, 95) run."""
    host = [S("run", 0, 100, None, None, 1, 0),
            S("chunk.dispatch", 10, 30, 0, 0, 1, 1),
            S("producer.assemble", 0, 100, None, 0, 2, 2),
            S("chunk.wait", 40, 90, 0, 0, 1, 3)]
    events = [(0, 20, "k0"), (50, 60, "k1"), (95, 110, "k2")]
    got = recorded.idle_split(host, events)
    ns = {k: round(v * 1e9) for k, v in got["by_span_s"].items()}
    assert ns == {"chunk.dispatch": 10, "run": 15, "chunk.wait": 40}
    assert round(got["window_s"] * 1e9) == 110
    assert round(got["on_host_s"] * 1e9) == 25
    names = [n for _, n in got["gaps"]]
    assert names[0].startswith("chunk.wait: after k1 before k2")
    assert all(n.split(":")[0] in ns for n in names)


def test_stamped_slice_of_a_tiny_cell():
    prog = cell_lib.Program(tiny(LENET), 3_000_000_123, torch.device("cpu"))
    prog.checked_rounds()
    n = 1 + 2 * prog.chunk
    c = recorded.stamped(prog, n)
    rec = _rec(c)
    assert c["rounds"] == c["device_rounds"] == n
    assert c["counters"].get("graph.captures", 0) == 0
    assert 0 < reader("host_busy_ms.device_plane")(rec) \
        <= c["wall_s"] * 1e3 / n
    spans = sum(reader(f"{q}_span_ms.device_plane")(rec)
                for q in ("sample", "gather", "local_update", "aggregate",
                          "server_step"))
    assert 0 < spans <= c["wall_s"] * 1e3 / n
    assert span_readers.device_span_ms("moe")(rec) is None
