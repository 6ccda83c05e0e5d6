"""The port's host data layer against the JAX package: the numpy copies
(synthetic corpora, partitioners) give identical arrays for the same seed,
and ``round_batches`` — threefry-keyed minibatch draws plus the gather —
is bit-equal."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import federated as jfed  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _assert_clients_equal(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert sorted(ca) == sorted(cb)
        for k in ca:
            assert ca[k].dtype == cb[k].dtype
            np.testing.assert_array_equal(ca[k], cb[k])


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_femnist_identical(seed):
    a, ca = jsyn.synthetic_femnist(n_clients=7, seed=seed)
    b, cb = tsyn.synthetic_femnist(n_clients=7, seed=seed)
    np.testing.assert_array_equal(ca, cb)
    _assert_clients_equal(a, b)


def test_synthetic_text_corpora_identical():
    a, ca = jsyn.synthetic_shakespeare(n_clients=3, seed=1, mean=60, std=20)
    b, cb = tsyn.synthetic_shakespeare(n_clients=3, seed=1, mean=60, std=20)
    np.testing.assert_array_equal(ca, cb)
    _assert_clients_equal(a, b)
    for x, y in zip(jsyn.synthetic_token_clients(4, 50, 33, seed=2),
                    tsyn.synthetic_token_clients(4, 50, 33, seed=2)):
        np.testing.assert_array_equal(x, y)


def test_partitioners_identical():
    labels = np.random.default_rng(0).integers(0, 10, size=500)
    for a, b in zip(jpart.dirichlet_partition(labels, 9, alpha=0.2, seed=4),
                    tpart.dirichlet_partition(labels, 9, alpha=0.2, seed=4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jpart.label_shard_partition(labels, 8, seed=5),
                    tpart.label_shard_partition(labels, 8, seed=5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpart.lognormal_sizes(50, 224.5, 87.8, 6),
                                  tpart.lognormal_sizes(50, 224.5, 87.8, 6))


@pytest.mark.parametrize("t", [0, 1, 9, 321])
@pytest.mark.parametrize("H,b", [(3, 10), (1, 1), (4, 7)])
def test_round_batches_bit_equal(t, H, b):
    clients, _ = jsyn.synthetic_femnist(n_clients=9, seed=2)
    jds = jfed.FederatedDataset(clients, seed=1)
    tds = tfed.FederatedDataset(clients, seed=1)
    ids = np.random.default_rng(t).choice(9, size=4, replace=False)
    want = jds.round_batches(ids, H, b, t=t)
    got = tds.round_batches(ids, H, b, t=t)
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].shape == (4, H, b) + clients[0][k].shape[1:]
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_lm_clients_to_dataset_and_population_identical():
    streams = [np.arange(n, dtype=np.int32) % 17 for n in (5, 40, 81)]
    a = jfed.lm_clients_to_dataset(streams, seq_len=8, seed=3)
    b = tfed.lm_clients_to_dataset(streams, seq_len=8, seed=3)
    _assert_clients_equal(a.data, b.data)
    np.testing.assert_array_equal(a.counts(), b.counts())
    np.testing.assert_array_equal(a.population().weights,
                                  b.population().weights)
    np.testing.assert_array_equal(a.round_batches([2, 0], 2, 3, t=5)["tokens"],
                                  b.round_batches([2, 0], 2, 3, t=5)["tokens"])


@pytest.mark.parametrize("bad,match", [
    ([], "empty corpus"),
    ([{"x": np.zeros((3, 2), np.float32)},
      {"y": np.zeros((3,), np.float32)}], "declared schema"),
    ([{"x": np.zeros((3, 2), np.float32), "y": np.zeros((2,), np.int32)}],
     "ragged"),
    ([{"x": np.zeros((3, 2), np.float32)},
      {"x": np.zeros((0, 2), np.float32)}], "no samples"),
    ([{"x": np.zeros((3, 2), np.float32)},
      {"x": np.zeros((3, 4), np.float32)}], "declared schema says"),
])
def test_corpus_schema_errors_match_reference(bad, match):
    with pytest.raises(jfed.CorpusSchemaError, match=match):
        jfed.validate_client_data(bad)
    with pytest.raises(tfed.CorpusSchemaError, match=match) as err:
        tfed.FederatedDataset(bad)
    assert isinstance(err.value, ValueError)


def test_check_shard_declared_count():
    shard = {"x": np.zeros((4, 2), np.float32)}
    fields = tfed.shard_schema(shard)
    assert tfed.check_shard(shard, fields, client=3) == 4
    with pytest.raises(tfed.CorpusSchemaError, match="n_k = 5") as err:
        tfed.check_shard(shard, fields, client=3, n_k=5)
    assert err.value.client == 3
