"""The port's recorder (``repro_torch/spans.py``) on the CPU.

Off, nothing is recorded, no stamp buffer is made and no stamp is taken;
on, host spans nest per thread and carry the chunk or round they serve
(the scanned plane's producer thread its own), each span lies inside the
``torch.profiler`` event it opened (one clock with the device trace), the
trajectory is bit-equal with device stamps on every plane, the MoE layer
is stamped in its forward and its backward, the cache's counters equal
the history's ``cache_*`` records, and a kernel build is counted only
when it compiles.
"""
import os
import threading

import numpy as np
import pytest
import torch

from _trajectory import make_clients
from _trajectory_torch import rcfg, run_torch, torch_flat_w
from repro_torch import spans
from repro_torch.core import fedmom
from repro_torch.kernels import _build
from repro_torch.models import layers as L

CLIENTS = make_clients(n=8, lo=4, hi=40)
LANE_SPANS = {"per-round": {"local_update", "aggregate", "server_step"},
              "scanned": {"local_update", "aggregate", "server_step"},
              "device": {"sample", "gather", "local_update", "aggregate",
                         "server_step"},
              "streaming": {"sample", "gather", "local_update", "aggregate",
                            "server_step"}}


def _run(lane, n=6, chunk=3):
    opt = fedmom(eta=1.0, beta=0.9, use_fused_kernel=True)
    return run_torch(lane, opt, rcfg(), CLIENTS, n, chunk_rounds=chunk)


def test_off_records_nothing_and_makes_no_buffer(monkeypatch):
    made, metrics = [], []
    stamps = spans.stamps

    def watch(n, device):
        out = stamps(n, device)
        made.append(out)
        return out
    monkeypatch.setattr(spans, "stamps", watch)
    monkeypatch.setattr(spans, "_stamp", lambda *a: pytest.fail("stamped"))
    from repro_torch.launch import train
    read_back = train.FederatedTrainer._read_back

    def keep(self, m, draws):
        metrics.append(set(m))
        return read_back(self, m, draws)
    monkeypatch.setattr(train.FederatedTrainer, "_read_back", keep)
    for lane in ("per-round", "device"):
        _run(lane)
    assert made and all(b is None for b in made)
    assert metrics and not any("stamps" in m for m in metrics)
    assert spans._rec is None and not spans.device_on()
    assert spans.span("run") is spans._NULL
    assert spans.device_span("sample") is spans._NULL
    x = torch.ones(3, requires_grad=True)
    assert spans.backward_span(x, "moe", True) is x


def test_spans_nest_per_thread_and_carry_their_ids():
    with spans.recording() as rec:
        hist, _ = _run("scanned", n=7, chunk=3)
    by_seq = {s.seq: s for s in rec.spans}
    (run,) = [s for s in rec.spans if s.name == "run"]
    starts = {0, 3, 6}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_seq[s.parent]
            assert p.thread == s.thread
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        if s.name.startswith(("chunk.", "graph.")):
            assert s.id in starts and s.thread == run.thread, s
        if s.name.startswith("graph."):
            assert by_seq[s.parent].name == "chunk.dispatch"
            assert by_seq[s.parent].id == s.id
    assembled = [s for s in rec.spans if s.name == "producer.assemble"]
    assert sorted(s.id for s in assembled) == sorted(starts)
    assert all(s.thread != run.thread and s.parent is None
               for s in assembled)
    for name in ("run.resolve", "run.finish"):
        (s,) = [s for s in rec.spans if s.name == name]
        assert s.parent == run.seq and s.id is None
    assert {s.id for s in rec.spans if s.name == "chunk.wait"} == starts
    assert rec.counters["rounds"] == len(hist) == 7


def test_span_lies_inside_its_profiler_event():
    """One clock with the device trace: the recorder's span and the
    ``record_function`` event it opened, on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            _run("per-round", n=2)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    seen = 0
    for name in {s.name for s in rec.spans}:
        mine = [s for s in rec.spans if s.name == name]
        theirs = sorted(events[name], key=lambda e: e.start_ns())
        assert len(mine) == len(theirs), name
        for s, e in zip(mine, theirs):
            assert e.start_ns() <= s.start_ns <= s.end_ns <= e.end_ns()
            seen += 1
    assert seen >= 2 + 4 * 2


@pytest.mark.parametrize("lane", sorted(LANE_SPANS))
def test_recorder_leaves_the_trajectory_bit_equal(lane):
    off = _run(lane)
    with spans.recording(device=True) as rec:
        on = _run(lane)
    assert [r["loss"] for r in on[0]] == [r["loss"] for r in off[0]]
    assert np.array_equal(torch_flat_w(on[1]), torch_flat_w(off[1]))
    assert sorted(rec.device) == list(range(6))
    for row in rec.device.values():
        assert set(row) == LANE_SPANS[lane] and min(row.values()) >= 0
    if lane == "streaming":
        for key in ("hits", "misses", "evictions"):
            assert rec.counters[f"cache.{key}"] == sum(
                r.get(f"cache_{key}", 0) for r in on[0])


def test_moe_stamped_in_forward_and_backward(monkeypatch):
    """Under the round engine's vmap of ``grad_and_value``: the forward
    stamps the ``moe`` span directly, the backward through the marks on
    the layer's output (its start) and input (its end); the gradients
    are bit-equal to the recorder off."""
    from torch.func import grad_and_value, vmap
    g = torch.Generator().manual_seed(0)
    D, E, F = 16, 4, 8
    p = {"router": torch.randn(D, E, generator=g),
         "wi_gate": torch.randn(E, D, F, generator=g) * 0.1,
         "wi_up": torch.randn(E, D, F, generator=g) * 0.1,
         "wo": torch.randn(E, F, D, generator=g) * 0.1}
    xs = torch.randn(2, 2, 8, D, generator=g)

    def loss(p, x):
        y, aux = L.moe_apply(p, x, n_experts=E, top_k=2,
                             capacity_factor=2.0, act="swiglu")
        return (y ** 2).mean() + aux

    def grads(p):
        return vmap(lambda x: grad_and_value(
            lambda q: loss(q, x * q["router"].sum()))(p))(xs)
    off = grads(p)
    calls = []
    stamp = spans._stamp
    monkeypatch.setattr(spans, "_stamp", lambda rec, name, end: (
        calls.append((name, end)), stamp(rec, name, end)))
    with spans.recording(device=True) as rec:
        buf = spans.stamps(1, "cpu")
        with spans.frame(buf, 0):
            on = grads(p)
        spans.device_rounds(0, buf.numpy())
    assert calls == [("moe", False), ("moe", True)] * 2
    assert rec.device[0]["moe"] > 0
    for a, b in zip(torch.utils._pytree.tree_leaves(on),
                    torch.utils._pytree.tree_leaves(off)):
        assert torch.equal(a, b)


def test_kernel_builds_counted_only_when_compiled(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with spans.recording() as rec:
        _build.build("stamp")
        _build.build("stamp")
    assert rec.counters["kernel.builds"] == 1
    assert os.listdir(tmp_path / "kernels")


def test_recording_is_one_at_a_time_and_ends_off():
    with spans.recording():
        with pytest.raises(RuntimeError, match="already active"):
            with spans.recording():
                pass
    assert spans._rec is None
    done = []

    def other():
        with spans.span("elsewhere"):
            done.append(threading.get_ident())
    with spans.recording() as rec:
        with spans.span("here"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
    assert not t.is_alive() and done
    (here,) = [s for s in rec.spans if s.name == "here"]
    (there,) = [s for s in rec.spans if s.name == "elsewhere"]
    assert there.parent is None and there.thread == done[0] != here.thread
