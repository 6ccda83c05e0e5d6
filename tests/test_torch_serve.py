"""The port's serving engine (``serve/engine.py``) and its keyed sampling
(``random.gumbel`` / ``categorical``) against the JAX package's, on the
CPU.

``generate`` on reduced gemma3-1b in fp32 (prompts of 128 tokens, so each
prefill layer takes the flash path under ``attention_impl="pallas"``; 6 new
tokens) on weights carried from JAX: greedy tokens equal to the reference's
and logprobs within 1e-4; with ``temperature=0.7`` and the same key, the
same tokens (the key schedule is the reference's and the Gumbel noise
equal to ``jax.random.gumbel``'s within 4 float32 ulps of ``max(|g|, 1)``,
the two ``log``s).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import generate as jgenerate  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.interop import tree_from_numpy  # noqa: E402
from repro_torch.serve import GenerateResult, generate  # noqa: E402

B, S0, NEW = 2, 128, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread here: the suite runs in several worker
    processes at once, and each one's default thread pool oversubscribes
    the host (a reduced keyed init then takes minutes, not seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    """Reduced gemma3-1b (fp32) weights from the reference's init, carried
    to the port, and a batch of prompts."""
    cfg = jget("gemma3-1b").reduced().replace(dtype="float32")
    jp, _ = JT.init(cfg, jax.random.PRNGKey(0))
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (B, S0))
    return jp, tp, prompts.astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_greedy_generate_matches_reference(served, impl):
    jp, tp, prompts = served
    jcfg = jget("gemma3-1b").reduced().replace(dtype="float32",
                                               attention_impl=impl)
    tcfg = tget("gemma3-1b").reduced().replace(dtype="float32",
                                               attention_impl=impl)
    want = jgenerate(jp, jcfg, jnp.asarray(prompts), NEW)
    got = generate(tp, tcfg, prompts, NEW)
    assert isinstance(got, GenerateResult)
    assert got.tokens.shape == (B, S0 + NEW) and got.logprobs.shape == (B,
                                                                        NEW)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               atol=1e-4, rtol=0)
    assert (got.logprobs[:, -1] == 0).all()


def test_temperature_generate_matches_reference(served):
    jp, tp, prompts = served
    jcfg = jget("gemma3-1b").reduced().replace(dtype="float32")
    tcfg = tget("gemma3-1b").reduced().replace(dtype="float32")
    want = jgenerate(jp, jcfg, jnp.asarray(prompts), NEW, temperature=0.7,
                     key=jax.random.PRNGKey(2))
    got = generate(tp, tcfg, torch.as_tensor(prompts), NEW, temperature=0.7,
                   key=prng.PRNGKey(2))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               atol=1e-4, rtol=0)
    greedy = generate(tp, tcfg, prompts, NEW)
    assert not np.array_equal(greedy.tokens, got.tokens)


@pytest.mark.parametrize("seed,shape", [(0, (4096,)), (7, (3, 512)),
                                        (2 ** 31 - 1, (2, 5, 7))])
def test_gumbel_matches_jax(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got, want, rtol=4 * eps, atol=4 * eps)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed).normal(size=(8, 1000)).astype(
        np.float32) * 3
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                             jnp.asarray(logits), axis=-1))
    got = prng.categorical(prng.PRNGKey(seed), torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="float32"):
        prng.categorical(prng.PRNGKey(seed), torch.as_tensor(logits).double())


def test_large_draws_are_sliced_without_changing_values(monkeypatch):
    """A float draw larger than the slice size is hashed slice by slice of
    its counter (bounded memory at full width); the values are those of
    the whole draw, and JAX's."""
    key = prng.PRNGKey(5)
    assert torch.equal(prng.random_bits(key, (37, 100), (1000, 2000)),
                       prng.random_bits(key, (37, 100)).reshape(-1)[1000:2000])
    whole_n, whole_g = prng.normal(key, (37, 100)), prng.gumbel(key, (3700,))
    monkeypatch.setattr(prng, "_CHUNK", 1000)
    assert torch.equal(prng.normal(key, (37, 100)), whole_n)
    assert torch.equal(prng.gumbel(key, (3700,)), whole_g)
    assert torch.equal(prng.uniform(key, (3701,)),
                       torch.as_tensor(np.asarray(jax.random.uniform(
                           jax.random.PRNGKey(5), (3701,)))))
