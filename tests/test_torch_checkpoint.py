"""Checkpoints cross packages: a state the port saves restores in the JAX
package and the other way round, bit for bit (same npz + json manifest,
same leaf path strings in the same order)."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.core import server_opt as jso  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.core import server_opt as tso  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


def _w0():
    return jax.tree.map(np.asarray, jsmall.lenet_init(jax.random.PRNGKey(3)))


def _states(name, rounds=2):
    """The same optimizer state advanced ``rounds`` times in each package."""
    w0 = _w0()
    jopt, topt = jso.get(name), tso.get(name)
    js, ts = jopt.init(jax.tree.map(jnp.asarray, w0)), topt.init(
        tree_from_numpy(w0, "cpu"))
    for r in range(rounds):
        d = jax.tree.map(lambda x: np.full(np.shape(x), 0.01 * (r + 1),
                                           np.float32), w0)
        js = jopt.update(js, jax.tree.map(jnp.asarray, d))
        ts = topt.update(ts, tree_from_numpy(d, "cpu"))
    return js, ts


@pytest.mark.parametrize("name", ["fedavg", "fedmom", "fedadam"])
def test_leaf_paths_match_reference(name):
    js, ts = _states(name, rounds=0)
    want = ["/".join(str(p) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert flatten_with_paths(ts)[0] == want


@pytest.mark.parametrize("name", ["fedavg", "fedmom"])
def test_torch_save_restores_in_jax(tmp_path, name):
    js, ts = _states(name)
    path = str(tmp_path / "torch.npz")
    tio.save_state(path, ts, {"round": 7})
    assert jio.latest_round(path) == 7
    like = jax.tree.map(jnp.zeros_like, js)
    got, meta = jio.restore_state(path, like)
    assert meta == {"round": 7}
    assert int(got.t) == ts.t and np.asarray(got.t).dtype == np.int32
    for a, b in zip(jax.tree.leaves((got.w, got.extra)),
                    jax.tree.leaves(tree_to_numpy((ts.w, ts.extra)))):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("name", ["fedavg", "fedmom"])
def test_jax_save_restores_in_torch(tmp_path, name):
    js, ts = _states(name)
    path = str(tmp_path / "jax.npz")
    jio.save_state(path, js, {"round": 4})
    assert tio.latest_round(path) == 4
    like = tso.get(name).init(tree_from_numpy(_w0(), "cpu"))
    got, meta = tio.restore_state(path, like)
    assert meta == {"round": 4} and got.t == int(js.t)
    for a, b in zip(jax.tree.leaves(tree_to_numpy((got.w, got.extra))),
                    jax.tree.leaves((js.w, js.extra))):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert all(x.dtype == torch.float32 for x in got.w.values())


def test_restore_rejects_other_structure(tmp_path):
    _, ts = _states("fedmom", rounds=1)
    path = str(tmp_path / "mom.npz")
    tio.save_state(path, ts)
    like = tso.fedavg().init(tree_from_numpy(_w0(), "cpu"))
    with pytest.raises(ValueError, match="structure mismatch"):
        tio.restore_state(path, like)


def test_latest_round_of_missing_or_corrupt_file_is_minus_one(tmp_path):
    assert tio.latest_round(str(tmp_path / "none.npz")) == -1
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    assert tio.latest_round(str(bad)) == -1


def test_async_writer_snapshots_before_later_mutation(tmp_path):
    _, ts = _states("fedmom", rounds=1)
    want = {k: v.clone() for k, v in ts.w.items()}
    path = str(tmp_path / "async.npz")
    writer = tio.AsyncCheckpointWriter()
    writer.submit(path, ts, {"round": 1})
    for v in ts.w.values():          # the next round mutating in place
        v.add_(1.0)
    writer.close()
    got, _ = tio.restore_state(path, ts)
    for k in want:
        assert torch.equal(got.w[k], want[k])


def test_async_writer_reraises_write_failure(tmp_path):
    _, ts = _states("fedavg", rounds=0)
    blocker = tmp_path / "file"
    blocker.write_text("x")
    writer = tio.AsyncCheckpointWriter()
    writer.submit(str(blocker / "sub" / "ck.npz"), ts)
    with pytest.raises(OSError):
        writer.close()


def test_metrics_append_and_prune_match_reference(tmp_path):
    recs = [{"round": t, "loss": 1.0 / (t + 1)} for t in range(6)]
    recs.insert(2, {"event": "plan", "plane": "per_round"})
    for mod, name in ((jio, "jax.jsonl"), (tio, "torch.jsonl")):
        path = str(tmp_path / name)
        mod.append_metrics(path, recs)
        with open(path, "a") as f:
            f.write('{"round": 9, "lo')          # torn trailing write
        mod.prune_metrics(path, 3)
    with open(tmp_path / "jax.jsonl") as a, open(tmp_path / "torch.jsonl") as b:
        ja, tb = a.read(), b.read()
    assert ja == tb
    kept = [json.loads(ln) for ln in tb.splitlines()]
    assert [r.get("round") for r in kept] == [0, 1, None, 2, 3]
    tio.prune_metrics(str(tmp_path / "absent.jsonl"), 0)
    assert not os.path.exists(tmp_path / "absent.jsonl")
