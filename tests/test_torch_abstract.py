"""Abstract mode of the port against the JAX package's, at full size.

``abstract_params``, ``logical_axes`` and ``init_cache(..., abstract=True)``
of every configuration of the zoo must equal the reference's in tree
paths, shapes, dtypes and logical axes; the port's leaves are empty
meta tensors (nothing allocated, nothing drawn).  The JAX side builds
``ShapeDtypeStruct``s only, so both sides are cheap at full size.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as jax_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _same_leaves(jax_tree, torch_tree):
    fj, ft = _flat(jax_tree), _flat(torch_tree)
    assert sorted(fj) == sorted(ft)
    for path, j in fj.items():
        t = ft[path]
        assert tuple(t.shape) == tuple(j.shape), path
        assert t.dtype == getattr(torch, str(j.dtype)), path
        assert t.device.type == "meta", path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_the_reference(arch):
    jp, ja = JT.abstract_params(jax_config(arch))
    tp, ta = TT.abstract_params(get_config(arch))
    _same_leaves(jp, tp)
    assert _flat(ta) == _flat(ja)
    assert TT.logical_axes(get_config(arch)) == ta
    assert _flat(JT.logical_axes(jax_config(arch))) == _flat(ta)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("batch,max_len", [(8, 4096), (1, 524_288)])
def test_abstract_cache_equals_the_reference(arch, batch, max_len):
    jc, ja = JT.init_cache(jax_config(arch), batch, max_len, abstract=True)
    tc, ta = TT.init_cache(get_config(arch), batch, max_len, abstract=True)
    _same_leaves(jc, tc)
    assert _flat(ta) == _flat(ja)
    # device="meta" is the same abstract cache
    mc, ma = TT.init_cache(get_config(arch), batch, max_len, device="meta")
    _same_leaves(jc, mc)
    assert ma == ta


def test_keygen_none_is_abstract_and_draws_nothing():
    kg = B.KeyGen(None)
    assert kg.abstract and kg.device.type == "meta" and kg() is None
    cfg = get_config("recurrentgemma-9b")
    # the RG-LRU block's lam would draw a key in materialized mode
    p, axes = B.init_block(kg, cfg, "rglru", torch.bfloat16)
    assert all(t.device.type == "meta" for t in _flat(p).values())
    assert axes["lam"] == ("rnn",)


def test_keyed_init_is_unchanged_by_abstract_mode():
    """``init`` with a key still draws: the reduced tree matches the
    abstract one leaf for leaf, with values."""
    from repro_torch import random as prng
    cfg = get_config("gemma3-1b").reduced()
    p, axes = TT.init(cfg, prng.PRNGKey(0), device="cpu")
    ap, aaxes = TT.abstract_params(cfg)
    assert axes == aaxes
    fp, fa = _flat(p), _flat(ap)
    assert sorted(fp) == sorted(fa)
    for k in fp:
        assert fp[k].device.type == "cpu"
        assert fp[k].shape == fa[k].shape and fp[k].dtype == fa[k].dtype
    assert float(fp[("embed",)].abs().sum()) > 0
