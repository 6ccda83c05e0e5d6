"""The paper's task 2 in the port: the char-LSTM on synthetic Shakespeare
under the round engine and the trainer, against the JAX package's, on the
CPU.

* FedAvg (H=2) and FedMom (H=2, beta 0.9) with eta = K/M, 8 clients, M=2,
  b=10, lr 0.8, 5 rounds on the per-round plane, from the reference's
  ``lstm_init`` carried over: the same keyed cohorts, per-round losses
  within rtol 1e-4 and the final server state within rtol 1e-4 / atol
  1e-5 of ``examples/paper_shakespeare.py``'s trainer;
* the device and auto planes (the 80-step Python loop of the LSTM inside
  a chunk) bit-equal to the per-round plane under the keyed sampler;
* ``examples/paper_shakespeare_torch.py``'s ``main`` at a few rounds.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.data import synthetic_shakespeare as j_shakespeare  # noqa: E402
from repro.data.federated import lm_clients_to_dataset as j_lm_ds  # noqa: E402,E501
from repro.launch.train import FederatedTrainer as JTrainer  # noqa: E402
from repro.models import small as jsmall  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.data.synthetic import SHAKESPEARE_SEQ  # noqa: E402
from repro_torch.interop import tree_from_numpy, tree_to_numpy  # noqa: E402,E501
from repro_torch.launch.plan import ExecutionPlan  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import paper_shakespeare_torch as example  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
K, M, ROUNDS = 8, 2, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora():
    streams, _ = j_shakespeare(n_clients=K, seed=0)
    jds = j_lm_ds([c["text"] for c in streams], SHAKESPEARE_SEQ, seed=1)
    tds = example.dataset(K)
    for a, b in zip(jds.data, tds.data):
        np.testing.assert_array_equal(np.asarray(a["tokens"]), b["tokens"])
    return jds, tds


def _opts(name):
    if name == "fedmom":
        return (jcore.fedmom(eta=K / M, beta=0.9),
                tcore.fedmom(eta=K / M, beta=0.9))
    return jcore.fedavg(eta=K / M), tcore.fedavg(eta=K / M)


@pytest.mark.parametrize("name", ["fedavg", "fedmom"])
def test_lstm_trajectory_matches_reference(corpora, name):
    jds, tds = corpora
    jopt, topt = _opts(name)
    w0 = jsmall.lstm_init(jax.random.PRNGKey(0))
    jtr = JTrainer(
        loss_fn=jsmall.lstm_loss, server_opt=jopt,
        rcfg=jcore.RoundConfig(clients_per_round=M, local_steps=2, lr=0.8,
                               placement="mesh", compute_dtype="float32"),
        dataset=jds, sampler=jcore.UniformSampler(jds.population(), M,
                                                  seed=2),
        state=jopt.init(w0), local_batch=10)
    jhist = jtr.run(ROUNDS, log_every=10_000, verbose=False)
    ttr = example.make_trainer(tds, topt, 2, 0.8, "per_round", "cpu", M)
    # the example's keyed init is the reference's within the erfinv
    # tolerance of repro_torch.random.normal; start from the same weights
    ttr.state = topt.init(tree_from_numpy(jax.tree.map(np.asarray, w0),
                                          "cpu"))
    hist = ttr.run(ROUNDS, verbose=False)
    np.testing.assert_allclose([r["loss"] for r in hist],
                               [r["loss"] for r in jhist], rtol=RTOL)
    np.testing.assert_allclose([r["delta_norm"] for r in hist],
                               [r["delta_norm"] for r in jhist], rtol=RTOL)
    got = leaves(tree_to_numpy((ttr.state.w, ttr.state.extra)))
    want = jax.tree.leaves((jtr.state.w, jtr.state.extra))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_lstm_graphed_planes_equal_per_round(corpora):
    _, tds = corpora
    runs = {}
    for plane in ("per_round", "device", "auto"):
        tr = example.make_trainer(
            tds, tcore.fedmom(eta=K / M, beta=0.9), 2, 0.8, "device", "cpu",
            M)
        plan = (None if plane == "per_round"
                else ExecutionPlan(plane=plane, chunk_rounds=ROUNDS))
        tr.run(ROUNDS, plan=plan, verbose=False)
        runs[plane] = ([r["loss"] for r in tr.history if "loss" in r],
                       leaves((tr.state.w, tr.state.extra)))
        if plane == "auto":
            assert tr.session.plan_log[-1]["plane"] == "device"
    for plane in ("device", "auto"):
        assert runs[plane][0] == runs["per_round"][0], plane
        assert all(torch.equal(a, b) for a, b in zip(runs[plane][1],
                                                     runs["per_round"][1]))


def test_example_main_runs(capsys):
    trainers, final = example.main(["--device", "cpu", "--rounds", "2",
                                    "--clients", "4"])
    assert set(final) == {"FedSGD", "FedAvg", "FedMom"}
    assert all(np.isfinite(v) for v in final.values())
    assert "rounds-to-loss summary" in capsys.readouterr().out
