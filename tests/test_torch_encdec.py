"""The port's encoder-decoder family (whisper-medium: learned positions, the
stubbed frame frontend, a non-causal encoder, cross-attention in every
decoder block) against the JAX package's, on the CPU.

* the keyed ``init`` of reduced whisper-medium, with stacked decoder groups
  and encoder and without;
* ``apply`` logits (fp32 within 1e-4), ``loss_fn`` and its grads against
  ``jax.grad`` (rtol 1e-4 / atol 1e-5);
* prefill + decode against the full forward (the reference's property,
  rtol/atol 2e-3) and against JAX's own prefill and decode, the cross
  caches sized to the encoder's 64 frames as the reference's prefill
  returns them;
* greedy ``generate`` with ``frames`` (a numpy array, placed on the
  params' device by the engine): tokens equal to JAX's; an extra that is
  neither a tensor nor an array is refused;
* one FedMom ``round_step`` against JAX's (rtol 1e-4 / atol 1e-5);
* remat of the decoder groups (with the encoder output an input of each
  remat node) and of the stacked encoder: grads bit-equal without it;
* ``examples/serve_demo_torch.py --arch whisper-medium`` on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import _zoo_pairs as Z  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import generate  # noqa: E402

ARCH = "whisper-medium"


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


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_init_matches_reference(stacked):
    kw = dict(scan_layers=True) if stacked else {}
    jcfg = jget(ARCH).reduced().replace(**kw)
    tcfg = tget(ARCH).reduced().replace(**kw)
    tp = Z.check_init(jcfg, tcfg)
    D = tcfg.d_model
    assert tp["pos_emb"].shape == (tcfg.max_position, D)
    assert tp["enc_pos_emb"].shape == (TT.ENC_LEN, D)
    assert tp["frontend_proj"].shape == (tcfg.d_frontend, D)
    block = tp["groups"]["b0"] if stacked else tp["rem"]["l0"]
    assert block["xattn"]["wk"].shape[-2] == tcfg.n_heads
    enc = tp["encoder"]
    assert ("l0" in enc) != stacked
    assert "xattn" not in (enc["l0"] if "l0" in enc else enc)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_apply_loss_and_grads_match_reference(stacked):
    jcfg, tcfg = _cfgs(**(dict(scan_layers=True) if stacked else {}))
    Z.check_apply_and_grads(jcfg, tcfg, Z.make_batch(jcfg, 2, 32, 5))


def test_prefill_decode_matches_full_forward():
    cfg = tget(ARCH).reduced().replace(dtype="float32")
    Z.check_decode_against_forward(cfg, Z.make_batch(cfg, 2, 40, 9), 32)


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
def test_prefill_and_decode_match_reference(stacked):
    jcfg, tcfg = _cfgs(**(dict(scan_layers=True) if stacked else {}))
    Z.check_decode_against_reference(jcfg, tcfg,
                                     Z.make_batch(jcfg, 2, 36, 10), 32)


def test_cross_cache_takes_the_encoder_length():
    """``init_cache`` allocates ENC_LEN cross positions; prefill over 64
    frames leaves K/V of 64 (the reference's prefill returns them so), and
    over ENC_LEN frames writes the allocated tensors in place."""
    cfg = tget(ARCH).reduced().replace(dtype="float32", scan_layers=True)
    params, _ = TT.init(cfg, prng.PRNGKey(0), device="cpu")
    batch = Z.tbatch(Z.make_batch(cfg, 1, 16, 3))
    cache, _ = TT.init_cache(cfg, 1, 20, device="cpu")
    xk = cache["groups"]["b0"]["cross"]["xk"]
    assert xk.shape == (cfg.n_groups, 1, TT.ENC_LEN, cfg.n_heads, cfg.d_head)
    _, cache = TT.prefill(params, cfg, batch, cache)
    assert cache["groups"]["b0"]["cross"]["xk"].shape[2] == Z.FRAMES
    cache, _ = TT.init_cache(cfg, 1, 20, device="cpu")
    xk = cache["groups"]["b0"]["cross"]["xk"]
    long = dict(batch, frames=torch.as_tensor(np.random.default_rng(4).normal(
        size=(1, TT.ENC_LEN, cfg.d_frontend)).astype(np.float32)))
    _, cache = TT.prefill(params, cfg, long, cache)
    assert cache["groups"]["b0"]["cross"]["xk"] is xk
    assert float(xk.abs().max()) > 0


def test_generate_matches_reference():
    jcfg, tcfg = _cfgs()
    Z.check_generate(jcfg, tcfg, Z.make_batch(jcfg, 2, 16, 11), 16, 6,
                     extras=("frames",))


def test_generate_refuses_other_extras():
    cfg = tget(ARCH).reduced().replace(dtype="float32")
    params, _ = TT.init(cfg, prng.PRNGKey(0), device="cpu")
    frames = Z.make_batch(cfg, 1, 8, 1)["frames"]
    with pytest.raises(TypeError, match="frames"):
        generate(params, cfg, np.zeros((1, 8), np.int32), 2,
                 extras={"frames": frames.tolist()})


def test_federated_round_matches_reference():
    jcfg, tcfg = _cfgs()
    Z.check_round(jcfg, tcfg)


def test_remat_grads_bit_equal():
    """4 stacked decoder layers (each remat node takes the encoder output
    as an input it differentiates) and a stacked 2-layer encoder."""
    cfg = tget(ARCH).reduced().replace(dtype="float32", n_layers=4,
                                       scan_layers=True, remat=True)
    params = Z.check_remat_bit_equal(cfg, Z.make_batch(cfg, 2, 32, 12))
    assert "l0" not in params["encoder"] and "groups" in params


def test_serve_demo_serves_it():
    """``examples/serve_demo_torch.py --arch whisper-medium --reduced
    --device cpu``: the demo feeds the stubbed frames and serves."""
    outs = Z.serve_demo_torch.main([
        "--arch", "whisper-medium", "--reduced", "--device", "cpu",
        "--batch", "1", "--prompt-len", "32", "--max-new", "3"])
    assert outs["whisper-medium"].tokens.shape == (1, 35)
    assert np.isfinite(outs["whisper-medium"].logprobs).all()
