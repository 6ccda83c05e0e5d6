"""The port's fleet traces (``repro_torch.traces``) and on-disk corpora
(``repro_torch.data.DiskShardProvider``) against the JAX package's, on the
CPU.

Files are the interface: a trace recorded by either package loads and
replays in the other (npz arrays equal, json manifests equal as parsed
JSON), and a corpus written by either opens in the other, in both layouts
(``npy-packed``, ``npz-per-client``).  Bit-equal (no tolerance):
``summarize``, ``TraceReplay`` caps under every out-of-range policy and a
changed H, ``TraceAvailability`` cutoffs on the host and the device,
``parse_leaf_dir`` and ``leaf_to_corpus`` on the committed LEAF fixture,
and the port's training: a replayed trace against its recording run on
every plane and lane, a disk corpus against the provider it was written
from.
"""
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _trajectory import make_clients, run_trajectory  # noqa: E402
from _trajectory import default_rcfg as jax_rcfg  # noqa: E402
from _trajectory_torch import opts, rcfg, run_torch, torch_flat_w  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import scenario as jscen  # noqa: E402
from repro import traces as jtraces  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import scenario as tscen  # noqa: E402
from repro_torch import traces as ttraces  # noqa: E402
from repro_torch.core import RoundConfig, fedmom  # noqa: E402
from repro_torch.launch.plan import CacheSpec, ExecutionPlan  # noqa: E402
from repro_torch.launch.train import FederatedTrainer  # noqa: E402

CLIENTS = make_clients(n=8, lo=8, hi=16)
ROUNDS, C, H = 12, 3, 4
LEAF_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "leaf")


def _spec(pkg, **kw):
    return pkg.ScenarioSpec(dropout=pkg.UniformDropout(rate=0.35),
                            stragglers=pkg.LatencyStragglers(deadline_s=5.0),
                            seed=7, **kw)


def _record(pkg, core, spec, n_rounds=ROUNDS):
    """Record over the sampler ``run_trajectory`` / ``run_torch`` build
    (dataset seed 1, sampler seed 2), so replayed cohorts are recorded
    ones."""
    ds = (tdata if pkg is ttraces else jdata).FederatedDataset(
        [dict(c) for c in CLIENTS], seed=1)
    sampler = core.DeviceUniformSampler(ds.population(), C, seed=2)
    return pkg.record_trace(spec, sampler, n_rounds, H)


def _files(stem):
    with np.load(stem + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(stem + ".json") as f:
        return arrays, json.load(f)


@pytest.mark.parametrize("case", ["synthetic", "adaptive", "availability"])
def test_recorded_trace_files_equal_and_cross_load(tmp_path, case):
    """Both packages record the same scenario into the same two files; each
    loads the other's."""
    extra = {"synthetic": lambda p: {},
             "adaptive": lambda p: {"cohort": p.AdaptiveCohort(goal=2)},
             "availability": lambda p: {
                 "availability": p.DiurnalAvailability(1, 3, 5)}}[case]
    tt = _record(ttraces, tcore, _spec(tscen, **extra(tscen)))
    jt = _record(jtraces, jcore, _spec(jscen, **extra(jscen)))
    t_stem = str(tmp_path / "torch_trace")
    j_stem = str(tmp_path / "jax_trace")
    assert tt.save(t_stem + ".json") == t_stem + ".json"
    jt.save(j_stem)
    (ta, tm), (ja, jm) = _files(t_stem), _files(j_stem)
    assert sorted(ta) == sorted(ja) == ["ev_client", "ev_latency",
                                        "ev_round", "ev_steps", "m"]
    for k in ta:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    tm.pop("arrays"), jm.pop("arrays")
    assert tm == jm and tm["format"] == ttraces.TRACE_FORMAT
    assert tm["version"] == ttraces.TRACE_VERSION == jtraces.TRACE_VERSION
    for loaded in (ttraces.FleetTrace.load(j_stem + ".npz"),
                   jtraces.FleetTrace.load(t_stem)):
        for k in ("m", "ev_round", "ev_client", "ev_steps", "ev_latency",
                  "row_splits"):
            np.testing.assert_array_equal(getattr(loaded, k),
                                          getattr(jt, k), err_msg=k)
    if case == "adaptive":
        assert (np.asarray(tt.m) < C).any()        # the cohort moved


def _same_summary(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


def test_summarize_matches_reference():
    traces = [(_record(ttraces, tcore, _spec(tscen)),
               _record(jtraces, jcore, _spec(jscen)))]
    tiny = dict(n_rounds=3, n_clients=4, local_steps=10, m=[2, 1, 3],
                ev_round=[0, 0, 1], ev_client=[1, 3, 0], ev_steps=[4, 10, 0])
    traces.append((ttraces.FleetTrace(**tiny), jtraces.FleetTrace(**tiny)))
    for tt, jt in traces:
        _same_summary(tt.summarize(), jt.summarize())
        for t in range(tt.n_rounds):
            a, b = tt.round_events(t), jt.round_events(t)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("bad", [
    {"m": [1, 2]}, {"ev_round": [0, 3]}, {"ev_client": [0, 9]},
    {"ev_steps": [0, 11]}, {"ev_client": [1, 1], "ev_round": [0, 0]},
    {"n_clients": 0}])
def test_fleet_trace_validation_matches_reference(bad):
    kw = dict(n_rounds=3, n_clients=4, local_steps=10, m=[2, 1, 3],
              ev_round=[0, 1], ev_client=[1, 3], ev_steps=[4, 10])
    kw.update(bad)
    msgs = []
    for pkg in (ttraces, jtraces):
        with pytest.raises(ValueError) as err:
            pkg.FleetTrace(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_replay_policies_and_availability_match_reference():
    """``TraceReplay`` caps under each policy, at the recorded H and at
    others, and ``TraceAvailability`` cutoffs (host, and device: an int
    and a tensor of rounds) equal to the reference's."""
    kw = dict(n_rounds=3, n_clients=6, local_steps=10, m=[2, 1, 3],
              ev_round=[0, 0, 1, 2], ev_client=[1, 3, 0, 5],
              ev_steps=[4, 10, 0, 7])
    tt, jt = ttraces.FleetTrace(**kw), jtraces.FleetTrace(**kw)
    cids = np.arange(6)
    for policy in ttraces.POLICIES:
        tr, jr = (ttraces.TraceReplay(tt, policy),
                  jtraces.TraceReplay(jt, policy))
        ta, ja = (ttraces.TraceAvailability(tt, policy),
                  jtraces.TraceAvailability(jt, policy))
        rounds = range(-2, 8) if policy != "raise" else range(3)
        dev = ta.m_device(torch.as_tensor(list(rounds)))
        for i, t in enumerate(rounds):
            for h in (3, 10, 12):
                np.testing.assert_array_equal(tr.step_caps(0, t, cids, h),
                                              jr.step_caps(0, t, cids, h))
            assert ta.m_at(t) == ja.m_at(t) == int(dev[i])
            assert ta.m_device(t) == int(ja.m_device(t))
        if policy == "raise":
            for pkg_obj in (tr, jr):
                with pytest.raises(IndexError, match="policy='raise'"):
                    pkg_obj.step_caps(0, 3, cids, 10)
            # the device twin cannot raise: it clamps, as the reference's
            assert int(ta.m_device(torch.tensor(5))) == int(ja.m_device(5))
    assert ta.peak == ja.peak == 3
    with pytest.raises(ValueError, match="policy"):
        ttraces.TraceSpec(trace=tt, policy="loop")
    with pytest.raises(ValueError, match="exactly one"):
        ttraces.TraceSpec()


@pytest.fixture(scope="module")
def jax_replays(tmp_path_factory):
    """The reference's synthetic run and its replay of the PORT's
    recorded trace, through its own padded streaming plane."""
    tmp = tmp_path_factory.mktemp("traces")
    path = _record(ttraces, tcore, _spec(tscen)).save(str(tmp / "t"))
    jopt, _ = opts("fedmom")
    syn = run_trajectory("streaming", jopt, jax_rcfg(), CLIENTS, ROUNDS,
                         chunk_rounds=4, scenario=_spec(jscen))
    rep = run_trajectory("streaming", jopt, jax_rcfg(), CLIENTS, ROUNDS,
                         chunk_rounds=4, scenario=jscen.ScenarioSpec(
                             trace=jtraces.TraceSpec(path=path)))
    return syn, rep


def test_reference_replays_a_port_trace(jax_replays):
    (s_hist, s_state), (r_hist, r_state) = jax_replays
    from _trajectory import flat_w
    assert [r["loss"] for r in s_hist] == [r["loss"] for r in r_hist]
    assert [r["completed"] for r in s_hist] == [r["completed"]
                                                for r in r_hist]
    np.testing.assert_array_equal(flat_w(s_state), flat_w(r_state))


@pytest.mark.parametrize("lane", ["per-round", "scanned", "device",
                                  "streaming", "streaming-bucketed"])
def test_port_replays_a_reference_trace_bit_equal(tmp_path, lane):
    """A trace the JAX package recorded, saved and loaded by the port,
    replays on every plane and lane bit-equal to the port's synthetic run
    of the scenario it recorded."""
    path = _record(jtraces, jcore, _spec(jscen)).save(str(tmp_path / "j"))
    _, topt = opts("fedmom")
    syn = run_torch(lane, topt, rcfg(), CLIENTS, ROUNDS, chunk_rounds=4,
                    scenario=_spec(tscen))
    rep = run_torch(lane, topt, rcfg(), CLIENTS, ROUNDS, chunk_rounds=4,
                    scenario=tscen.ScenarioSpec(
                        trace=ttraces.TraceSpec(path=path)))
    for key in ("loss", "completed"):
        assert [r[key] for r in syn[0]] == [r[key] for r in rep[0]]
    assert min(r["completed"] for r in rep[0]) < C
    np.testing.assert_array_equal(torch_flat_w(syn[1]), torch_flat_w(rep[1]))


def test_replay_resume_bit_equal(tmp_path):
    trace = _record(ttraces, tcore, _spec(tscen))
    spec = tscen.ScenarioSpec(trace=ttraces.TraceSpec(trace=trace))
    _, topt = opts("fedmom")
    whole = run_torch("device", topt, rcfg(), CLIENTS, ROUNDS,
                      chunk_rounds=4, scenario=spec)
    resumed = run_torch("device", topt, rcfg(), CLIENTS, ROUNDS,
                        chunk_rounds=4, scenario=spec, resume_at=5,
                        tmp_path=tmp_path)
    assert [r["loss"] for r in whole[0]] == [r["loss"] for r in resumed[0]]
    np.testing.assert_array_equal(torch_flat_w(whole[1]),
                                  torch_flat_w(resumed[1]))


# ---------------------------------------------------------------------------
# on-disk corpora
# ---------------------------------------------------------------------------
def _corpus_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".json"):
                out[rel] = json.load(open(path))
            elif name.endswith(".npy"):
                out[rel] = np.load(path)
            else:
                with np.load(path) as z:
                    out[rel] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("layout", ["npy-packed", "npz-per-client"])
def test_disk_corpus_cross_package(tmp_path, layout):
    """The port and the reference write the same corpus files; each reads
    the other's, shard for shard, bit for bit."""
    tsrc = tscen.ZipfLinregProvider(40, dim=4, n_min=2, n_max=16, seed=5)
    jsrc = jscen.ZipfLinregProvider(40, dim=4, n_min=2, n_max=16, seed=5)
    t_root = tdata.write_disk_corpus(str(tmp_path / "t"), tsrc, layout)
    j_root = jdata.write_disk_corpus(str(tmp_path / "j"), jsrc, layout)
    tf, jf = _corpus_files(t_root), _corpus_files(j_root)
    assert tf.keys() == jf.keys()
    for rel in tf:
        if isinstance(tf[rel], dict) and rel.endswith(".npz"):
            for k in jf[rel]:
                np.testing.assert_array_equal(tf[rel][k], jf[rel][k])
        elif rel.endswith(".npy"):
            assert tf[rel].dtype == jf[rel].dtype
            np.testing.assert_array_equal(tf[rel], jf[rel])
        else:
            assert tf[rel] == jf[rel], rel
    for reader, root in ((tdata.DiskShardProvider, j_root),
                         (jdata.DiskShardProvider, t_root),
                         (tdata.DiskShardProvider, t_root)):
        disk = reader(root)
        assert disk.layout == layout and disk.fields == tsrc.fields
        np.testing.assert_array_equal(disk.counts, tsrc.counts)
        for cid in range(40):
            got, want = disk.shard(cid), tsrc.shard(cid)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    assert isinstance(tdata.DiskShardProvider(t_root), tdata.ShardProvider)
    with pytest.raises(IndexError, match="outside corpus"):
        tdata.DiskShardProvider(t_root).shard(40)


def test_disk_corpus_schema_errors_match_reference(tmp_path):
    src = tscen.ZipfLinregProvider(4, dim=2, n_min=2, n_max=4, seed=0)
    with pytest.raises(tdata.CorpusSchemaError, match="neither"):
        tdata.DiskShardProvider(str(tmp_path))
    with pytest.raises(ValueError, match="layout"):
        tdata.write_disk_corpus(str(tmp_path / "x"), src, layout="tar")
    root = tdata.write_disk_corpus(str(tmp_path / "c"), src,
                                   layout="npz-per-client")
    mpath = os.path.join(root, "manifest.json")
    blob = json.load(open(mpath))
    for field, value in (("format", "other"), ("version", 2),
                         ("layout", "tar"), ("n_clients", 7)):
        with open(mpath, "w") as f:
            json.dump({**blob, field: value}, f)
        msgs = []
        for pkg in (tdata, jdata):
            with pytest.raises(pkg.CorpusSchemaError) as err:
                pkg.DiskShardProvider(root)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], field
    with open(mpath, "w") as f:
        json.dump(blob, f)
    os.remove(os.path.join(root, "shards", "3.npz"))
    with pytest.raises(tdata.CorpusSchemaError, match="missing shard") as e:
        tdata.DiskShardProvider(root)
    assert e.value.client == 3


def test_leaf_parse_and_convert_match_reference(tmp_path):
    t, j = tdata.parse_leaf_dir(LEAF_DIR), jdata.parse_leaf_dir(LEAF_DIR)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1] == j[1] and t[3] == j[3] and len(t[3]) == 12
    for a, b in zip(t[2], j[2]):
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    leaf = tdata.DiskShardProvider.from_leaf(LEAF_DIR)
    assert leaf.layout == "leaf-json" and leaf.users == j[3]
    for layout in ("npy-packed", "npz-per-client"):
        tout = tdata.leaf_to_corpus(LEAF_DIR, str(tmp_path / f"t-{layout}"),
                                    layout=layout)
        jout = jdata.leaf_to_corpus(LEAF_DIR, str(tmp_path / f"j-{layout}"),
                                    layout=layout)
        assert json.load(open(os.path.join(tout, "manifest.json"))) == \
            json.load(open(os.path.join(jout, "manifest.json")))
        conv = tdata.DiskShardProvider(jout)
        np.testing.assert_array_equal(conv.counts, leaf.counts)
        for cid in range(leaf.n_clients):
            for k, v in leaf.shard(cid).items():
                np.testing.assert_array_equal(conv.shard(cid)[k], v)


def test_disk_corpus_trains_bit_equal_to_its_provider(tmp_path):
    """A streaming run over a disk corpus, with a cache small enough to
    evict and re-read from disk, equals the run over the provider the
    corpus was written from; a trace recorded over it replays bit-equal
    (BENCH_9's certification at a CPU size)."""
    src = tscen.ZipfLinregProvider(60, dim=5, n_min=4, n_max=16, seed=3)
    root = tdata.write_disk_corpus(str(tmp_path / "corpus"), src,
                                   layout="npy-packed")

    def train(provider, scenario):
        ds = tdata.StreamingFederatedDataset.from_provider(provider, seed=9)
        opt = fedmom(eta=2.0, beta=0.9, use_fused_kernel=True)
        tr = FederatedTrainer(
            loss_fn=_linreg_loss, server_opt=opt,
            rcfg=RoundConfig(3, 4, 0.05, compute_dtype="float32"),
            dataset=ds,
            sampler=tcore.DeviceUniformSampler(ds.population(), 3, seed=2),
            state=opt.init({"w": torch.zeros(5), "b": torch.zeros(())}),
            local_batch=4, device="cpu")
        plan = ExecutionPlan(plane="streaming", chunk_rounds=3,
                             cache=CacheSpec(clients=9, tiers=1),
                             scenario=scenario)
        hist = tr.run(12, plan=plan, verbose=False)
        assert tr.stream_cache.evictions > 0
        return ([(r["loss"], r["completed"]) for r in hist],
                torch_flat_w(tr.state), ds)

    spec = _spec(tscen)
    disk = tdata.DiskShardProvider(root)
    got, want = train(disk, spec), train(src, spec)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    sampler = tcore.DeviceUniformSampler(got[2].population(), 3, seed=2)
    trace = ttraces.FleetTrace.load(ttraces.TraceRecorder(spec, 4).record(
        sampler, 12).save(str(tmp_path / "trace")))
    rep = train(disk, tscen.ScenarioSpec(trace=ttraces.TraceSpec(
        trace=trace)))
    assert rep[0] == got[0]
    np.testing.assert_array_equal(rep[1], got[1])


def _linreg_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean(torch.square(pred - batch["y"])), {}
