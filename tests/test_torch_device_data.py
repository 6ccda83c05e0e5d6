"""The port's device-resident data plane against the JAX package's:
``DeviceFederatedDataset`` packing (shapes, counts, zero padding, per-field
dtypes, a client at n_max, the reference's refusals) and
``gather_round_batch``, bit-equal to the port's host assembly
(``FederatedDataset.round_batches``) and to the reference's gather on the
same seed, with an int or an int64 tensor round index, and with
replacement for a client smaller than H*b.  Everything here is exact:
keyed integer draws and gathered rows."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _trajectory import make_clients  # noqa: E402
from repro.data import DeviceFederatedDataset as JDevice  # noqa: E402
from repro_torch.core import DeviceUniformSampler  # noqa: E402
from repro_torch.data import (CorpusSchemaError,  # noqa: E402
                              DeviceFederatedDataset, FederatedDataset)


def _pack(clients, seed=1):
    return DeviceFederatedDataset.pack(clients, seed=seed, device="cpu")


def test_pack_shapes_counts_and_padding():
    clients = make_clients(seed=3)
    counts = np.array([len(c["x"]) for c in clients])
    dds = _pack(clients)
    K, n_max = len(clients), counts.max()
    assert dds.n_clients == K and dds.n_max == n_max
    assert tuple(dds.arrays["x"].shape) == (K, n_max, 5)
    assert tuple(dds.arrays["y"].shape) == (K, n_max)
    assert dds.counts.dtype == torch.int32
    np.testing.assert_array_equal(dds.counts.numpy(), counts)
    for k, c in enumerate(clients):
        got = dds.arrays["x"][k].numpy()
        np.testing.assert_array_equal(got[: counts[k]], c["x"])
        assert np.all(got[counts[k]:] == 0)
    assert dds.nbytes == sum(a.numel() * a.element_size()
                             for a in dds.arrays.values())
    jdds = JDevice.pack(clients, seed=1)
    assert dds.nbytes == jdds.nbytes and dds.n_max == jdds.n_max
    np.testing.assert_array_equal(dds.population().counts,
                                  jdds.population().counts)


def test_pack_boundary_client_at_n_max():
    clients = make_clients(seed=5, n=4)
    k_max = int(np.argmax([len(c["x"]) for c in clients]))
    dds = _pack(clients, seed=0)
    np.testing.assert_array_equal(dds.arrays["x"][k_max].numpy(),
                                  clients[k_max]["x"])


def test_pack_preserves_nonuniform_leaf_dtypes():
    rng = np.random.default_rng(11)
    clients = [{"tokens": rng.integers(0, 90, size=(n, 8)).astype(np.int32),
                "x": rng.normal(size=(n, 4)).astype(np.float32)}
               for n in (7, 12, 9)]
    dds = _pack(clients, seed=0)
    assert dds.arrays["tokens"].dtype == torch.int32
    assert dds.arrays["x"].dtype == torch.float32
    assert tuple(dds.arrays["tokens"].shape) == (3, 12, 8)


@pytest.mark.parametrize("data,match", [
    ([{"x": np.zeros((3, 2)), "y": np.zeros(4)}], "ragged"),
    ([{"x": np.zeros((3, 2))}, {"x": np.zeros((0, 2))}], "no samples"),
], ids=["ragged", "empty-client"])
def test_pack_rejects_what_the_reference_rejects(data, match):
    with pytest.raises(ValueError, match=match):
        JDevice.pack(data)
    with pytest.raises(CorpusSchemaError, match=match):
        _pack(data)


def test_pack_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFederatedDataset.pack(make_clients(seed=3))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int-t",
                                                          "tensor-t"])
def test_gather_round_batch_bit_equals_host_and_reference(as_tensor):
    clients = make_clients(seed=7)
    ds = FederatedDataset([dict(c) for c in clients], seed=1)
    dds = DeviceFederatedDataset.from_federated(ds, device="cpu")
    jdds = JDevice.pack(clients, seed=1)
    sampler = DeviceUniformSampler(ds.population(), 3, seed=2)
    for t in range(12):
        idx, _ = sampler.sample(t)
        tt = torch.tensor(t, dtype=torch.int64) if as_tensor else t
        got = dds.gather_round_batch(dds.base_key(), tt,
                                     torch.as_tensor(idx), 4, 3)
        host = ds.round_batches(idx, 4, 3, t=t)
        ref = jdds.gather_round_batch(jdds.base_key(), jnp.int32(t),
                                      jnp.asarray(idx), 4, 3)
        for name in host:
            assert tuple(got[name].shape) == host[name].shape
            np.testing.assert_array_equal(got[name].numpy(), host[name])
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(ref[name]))


def test_gather_with_replacement_small_client():
    rng = np.random.default_rng(13)
    clients = [{"x": rng.normal(size=(3, 2)).astype(np.float32)},
               {"x": rng.normal(size=(30, 2)).astype(np.float32)}]
    dds = _pack(clients, seed=4)
    H, b = 4, 2                                   # need 8 > n_0 = 3
    batch = dds.gather_round_batch(dds.base_key(), 0,
                                   torch.tensor([0, 1]), H, b)
    for r in batch["x"][0].reshape(-1, 2).numpy():
        assert any(np.array_equal(r, s) for s in clients[0]["x"])
    host = FederatedDataset(clients, seed=4).round_batches([0, 1], H, b, t=0)
    np.testing.assert_array_equal(host["x"], batch["x"].numpy())
    jdds = JDevice.pack(clients, seed=4)
    ref = jdds.gather_round_batch(jdds.base_key(), 0, jnp.asarray([0, 1]),
                                  H, b)
    np.testing.assert_array_equal(np.asarray(ref["x"]), batch["x"].numpy())
