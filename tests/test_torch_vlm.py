"""The port's VLM family (qwen2-vl-72b: stubbed patch embeddings projected
over the first positions, M-RoPE, qkv bias) against the JAX package's, on
the CPU.

* ``layers.mrope_tables`` at the full config's sections and the reduced
  config's, fp32 within 1e-5;
* the keyed ``init`` of reduced qwen2-vl-72b, stacked and unstacked;
* ``apply`` logits (fp32 within 1e-4), ``loss_fn`` (the patch positions
  masked out) and its grads against ``jax.grad`` (rtol 1e-4 / atol 1e-5),
  with a t/h/w grid of M-RoPE ids; patches written over the first
  positions; text without M-RoPE ids takes 1-D rope;
* prefill + decode against the full forward (the reference's property,
  rtol/atol 2e-3) and against JAX's own prefill and decode;
* greedy ``generate`` with ``patches`` and ``mrope_positions``: tokens
  equal to JAX's;
* one FedMom ``round_step`` against JAX's (rtol 1e-4 / atol 1e-5), its
  M-RoPE ids laid out [C, H, 3, b, S];
* ``examples/serve_demo_torch.py --arch qwen2-vl-72b`` on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _zoo_pairs as Z  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "qwen2-vl-72b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = dict(dtype="float32", **kw)
    return (jget(ARCH).reduced().replace(**kw),
            tget(ARCH).reduced().replace(**kw))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_mrope_tables_match_reference(reduced):
    cfg = tget(ARCH).reduced() if reduced else tget(ARCH)
    pos = Z.mrope_grid(2, 300, 256)
    pos[1] += 7                       # the streams differ
    ts, tc = TL.mrope_tables(torch.as_tensor(pos), cfg.d_head,
                             cfg.rope_theta, cfg.mrope_sections)
    js, jc = JL.mrope_tables(jnp.asarray(pos), cfg.d_head, cfg.rope_theta,
                             cfg.mrope_sections)
    assert tuple(ts.shape) == (2, 300, cfg.d_head // 2)
    np.testing.assert_allclose(Z.np32(ts), Z.np32(js), atol=1e-5)
    np.testing.assert_allclose(Z.np32(tc), Z.np32(jc), atol=1e-5)
    # one stream on all three sections is 1-D rope
    flat = np.broadcast_to(pos[0][None], pos.shape).copy()
    s1, c1 = TL.mrope_tables(torch.as_tensor(flat), cfg.d_head,
                             cfg.rope_theta, cfg.mrope_sections)
    s2, c2 = TL.rope_tables(torch.as_tensor(pos[0]), cfg.d_head,
                            cfg.rope_theta)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_init_matches_reference(stacked):
    kw = dict(scan_layers=True) if stacked else {}
    tp = Z.check_init(jget(ARCH).reduced().replace(**kw),
                      tget(ARCH).reduced().replace(**kw))
    assert "frontend_proj" in tp and "pos_emb" not in tp


def test_apply_loss_and_grads_match_reference():
    jcfg, tcfg = _cfgs()
    batch = Z.make_batch(jcfg, 2, 64, 5)
    tp, _ = Z.check_apply_and_grads(jcfg, tcfg, batch)
    # the patches replace the first positions' embeddings: changing them
    # moves the logits
    tb = Z.tbatch(batch)
    base, _ = TT.apply(tp, tcfg, tb)
    moved, _ = TT.apply(tp, tcfg, dict(tb, patches=tb["patches"] + 1.0))
    assert float((moved - base).abs().max()) > 1e-3


def test_prefill_decode_matches_full_forward():
    cfg = tget(ARCH).reduced().replace(dtype="float32")
    Z.check_decode_against_forward(cfg, Z.make_batch(cfg, 2, 40, 9), 32)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_prefill_and_decode_match_reference(stacked):
    jcfg, tcfg = _cfgs(**(dict(scan_layers=True) if stacked else {}))
    Z.check_decode_against_reference(jcfg, tcfg,
                                     Z.make_batch(jcfg, 2, 40, 10), 32)


def test_generate_matches_reference():
    jcfg, tcfg = _cfgs()
    Z.check_generate(jcfg, tcfg, Z.make_batch(jcfg, 2, 32, 11), 32, 6,
                     extras=("patches", "mrope_positions"))


def test_federated_round_matches_reference():
    jcfg, tcfg = _cfgs()
    assert Z.round_batches(tcfg, 2, 2, 2, 32, 0)["mrope_positions"].shape \
        == (2, 2, 3, 2, 32)
    Z.check_round(jcfg, tcfg)


def test_text_only_batch_takes_1d_rope():
    """Without ``mrope_positions`` the VLM falls back to 1-D positions, as
    the reference's config comment says; with ids all equal to the 1-D
    positions M-RoPE gives the same logits."""
    cfg = tget(ARCH).reduced().replace(dtype="float32")
    params, _ = TT.init(cfg, prng.PRNGKey(2), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 24)))
    plain, _ = TT.apply(params, cfg, {"tokens": toks})
    ids = torch.arange(24)[None, None].expand(3, 2, 24)
    same, _ = TT.apply(params, cfg, {"tokens": toks, "mrope_positions": ids})
    assert torch.equal(plain, same)


def test_serve_demo_serves_it():
    """``examples/serve_demo_torch.py --arch qwen2-vl-72b --reduced --device
    cpu``: the demo feeds the stubbed patches and serves."""
    outs = Z.serve_demo_torch.main([
        "--arch", "qwen2-vl-72b", "--reduced", "--device", "cpu",
        "--batch", "1", "--prompt-len", "32", "--max-new", "3"])
    assert outs["qwen2-vl-72b"].tokens.shape == (1, 35)
    assert np.isfinite(outs["qwen2-vl-72b"].logprobs).all()
