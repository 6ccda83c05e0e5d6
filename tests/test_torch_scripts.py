"""The port's reference scripts, ``scripts/dev_smoke_torch.py`` and
``scripts/profile_combo_torch.py``, against the JAX package's on the CPU.

``dev_smoke_torch``'s ``(n_params, loss, gnorm)`` of a dense and a
recurrent reduced architecture equal the reference script's, computed as
its ``main`` does from its own ``make_batch`` (the script is imported by
path and not changed): the parameter count exactly; in fp32 the loss
within 1e-4 and the gradient norm within rtol 1e-3 (the two inits agree to
the ``erfinv`` tolerance of ``repro_torch.random.normal``, measured: 5e-7
in loss and gnorm); in the reduced configs' bf16 within one bf16 ulp
relative (rtol 2**-7: the weights' last-bit differences move bf16
roundings, measured up to 5e-4 in loss and 1.5e-3 in gnorm).
``profile_combo_torch``'s flops equal ``launch.dryrun.dry_run``'s record of
the same combination, and its rows' bytes sum to no more than the total.
"""
import importlib.util
import math
import pathlib

import pytest

pytest.importorskip("torch")

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
LOSS_ATOL, GNORM_RTOL = 1e-4, 1e-3        # fp32
BF16_RTOL = 2.0 ** -7                     # one bf16 ulp


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_smoke(arch, dtype):
    """The reference script's ``main`` body for one architecture."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import transformer as T
    ref = _load("dev_smoke")
    cfg = get_config(arch).reduced()
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    params, _ = T.init(cfg, jax.random.PRNGKey(1))
    n = sum(x.size for x in jax.tree.leaves(params))
    batch = ref.make_batch(cfg)
    loss, _ = T.loss_fn(params, cfg, batch)
    g = jax.grad(lambda p: T.loss_fn(p, cfg, batch)[0])(params)
    gn = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                      for x in jax.tree.leaves(g)))
    return n, float(loss), float(gn)


@pytest.mark.parametrize("dtype", ["float32", None], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-9b"])
def test_dev_smoke_matches_reference_script(arch, dtype):
    got = _load("dev_smoke_torch").smoke(arch, "cpu", dtype)
    want = _reference_smoke(arch, dtype)
    assert got[0] == want[0]
    if dtype == "float32":
        assert abs(got[1] - want[1]) <= LOSS_ATOL
        assert math.isclose(got[2], want[2], rel_tol=GNORM_RTOL)
    else:
        assert math.isclose(got[1], want[1], rel_tol=BF16_RTOL)
        assert math.isclose(got[2], want[2], rel_tol=BF16_RTOL)


def test_dev_smoke_prints_one_line_an_architecture(capsys):
    assert _load("dev_smoke_torch").main(
        ["qwen3-1.7b", "rwkv6-7b", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["OK", "qwen3-1.7b"],
                                                ["OK", "rwkv6-7b"]]
    assert all("params=" in ln and "gnorm=" in ln for ln in lines)


def test_profile_combo_counts_what_the_dry_run_counts(capsys):
    from repro_torch.launch import dryrun
    pc = _load("profile_combo_torch")
    res, rows = pc.profile_combo("gemma3-1b", "decode_32k")
    rec = dryrun.dry_run("gemma3-1b", "decode_32k", verbose=False)
    assert rec["status"] == "ok"
    assert res["flops"] == rec["flops_per_rank"]
    assert res["bytes"] == rec["hbm_bytes_per_rank"]
    assert 0 < len(rows) <= 30
    assert sum(b for _, b, _ in rows) <= res["bytes"]
    assert sum(f for _, _, f in rows) <= res["flops"]
    pc.main("gemma3-1b", "decode_32k")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("== gemma3-1b x decode_32k [zero]  flops=")
    assert out[1].startswith("   collectives: ")
    assert len(out) == 3 + len(rows)
