"""The port's cost model (``launch/cost.py``) on the meta device.

Flops are held to the JAX package's loop-aware ``hlo_cost.analyze`` of the
same jitted step on the CPU, by equality: the forward loss of all ten
reduced configurations, ``round_step`` for a dense and a MoE
configuration, ``prefill`` and ``decode_step`` for an attention, an RWKV
and an RG-LRU configuration.  Two steps differ by construction, and the
tests hold the named difference exactly (ROADMAP Queue 3):

  * remat: the port's recompute (of the group, by plain autograd) runs
    each group's last weight product (the MLP's ``wo``), whose output no
    gradient needs; XLA drops it from the checkpointed recompute;
  * the MoE dispatch and combine: the reference multiplies by dense
    one-hot [G, E, C] tensors, the port moves rows by index
    (``kernels/moe_route``), which does none of the products
    ``FlopCounterMode`` counts.  The reference's count of those products
    is the difference: in the forward the two tensors' einsums (2 G k E C
    flops each) and the two products (2 G E C D each); in the backward the
    products' three gradients (dx, d ye, d combine: 2 G E C D each), the
    combine tensor's gradient (2 G k E C) and the gate dot (2 G k C).

Then ``tests/test_hlo_cost.py``'s contracts in the port's terms, the bytes
and peak models on a step whose traffic is known, and the collectives of a
recording mesh.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS, get_config as jax_config  # noqa: E402
from repro.core import RoundConfig as JRoundConfig  # noqa: E402
from repro.core import round_step as jax_round_step  # noqa: E402
from repro.core import server_opt as jso  # noqa: E402
from repro.launch import hlo_analysis, hlo_cost  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import RoundConfig, round_step  # noqa: E402
from repro_torch.core import server_opt as so  # noqa: E402
from repro_torch.launch import cost, hw, roofline  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.sharding import FED_MESH_RULES, axis_rules  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

META = torch.device("meta")


def _jax_flops(fn, *args):
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())[
        "flops"]


def _meta(sds):
    return torch.empty(sds.shape, dtype=getattr(torch, str(sds.dtype)),
                       device=META)


def _jax_batch(cfg, lead, S):
    i32 = jnp.int32
    b = {"tokens": jax.ShapeDtypeStruct(lead + (S,), i32),
         "labels": jax.ShapeDtypeStruct(lead + (S,), i32)}
    if cfg.family == "vlm":
        b["patches"] = jax.ShapeDtypeStruct(
            lead + (JT.VLM_PATCHES, cfg.d_frontend), jnp.float32)
        b["mrope_positions"] = jax.ShapeDtypeStruct(
            lead[:-1] + (3,) + lead[-1:] + (S,), i32)
    if cfg.enc_dec:
        b["frames"] = jax.ShapeDtypeStruct(
            lead + (JT.ENC_LEN, cfg.d_frontend), jnp.float32)
    return b


def _moe_shape(cfg, G):
    """(G, E, k, C, D) of a MoE layer routing one group of G tokens."""
    m = cfg.moe
    C = math.ceil(m.top_k * G * m.capacity_factor / m.n_experts)
    return G, m.n_experts, m.top_k, C, cfg.d_model


def _dense_forward(cfg, G):
    """The reference's dense dispatch and combine flops in one MoE layer's
    forward: the two [G, E, C] tensors' einsums and the two products."""
    G, E, k, C, D = _moe_shape(cfg, G)
    return 2 * 2 * G * k * E * C + 2 * 2 * G * E * C * D


def _dense_backward(cfg, G):
    """...and in its backward: the products' three gradients, the combine
    tensor's gradient and the gate dot."""
    G, E, k, C, D = _moe_shape(cfg, G)
    return 3 * 2 * G * E * C * D + 2 * G * k * E * C + 2 * G * k * C


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_flops_equal_the_reference(arch):
    """Equal, but for the MoE configurations' dense dispatch and combine,
    which only the reference counts (the module note)."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    # the VLM's 256 patches replace the first positions: S above them
    S = 320 if jcfg.family == "vlm" else 64
    jp, _ = JT.abstract_params(jcfg)
    tp, _ = TT.abstract_params(tcfg)
    jb = _jax_batch(jcfg, (2,), S)
    want = _jax_flops(lambda p, b: JT.loss_fn(p, jcfg, b)[0], jp, jb)
    got = cost.analyze(lambda p, b: TT.loss_fn(p, tcfg, b), tp,
                       {k: _meta(v) for k, v in jb.items()})["flops"]
    dense = (tcfg.n_layers * _dense_forward(tcfg, 2 * S)
             if tcfg.family == "moe" else 0)
    assert got > 0 and want - got == dense


def _rounds(arch, cfg_kw, C, H, b, S, placement="mesh"):
    """(reference flops, port flops, port config) of one FedMom round."""
    jcfg = jax_config(arch).reduced().replace(**cfg_kw)
    tcfg = get_config(arch).reduced().replace(**cfg_kw)
    jp, jaxes = JT.abstract_params(jcfg)
    jw = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                      jp)
    jstate = jso.ServerState(w=jw, extra={"v": jw},
                             t=jax.ShapeDtypeStruct((), jnp.int32))
    jb = _jax_batch(jcfg, (C, H, b), S)
    jwts = jax.ShapeDtypeStruct((C,), jnp.float32)
    jrcfg = JRoundConfig(clients_per_round=C, local_steps=H, lr=0.01,
                         placement=placement, compute_dtype=jcfg.dtype)
    jopt = jso.fedmom(eta=1.0, beta=0.9)
    want = _jax_flops(
        lambda st, bt, wt: jax_round_step(
            lambda p, x: JT.loss_fn(p, jcfg, x), jopt, st, bt, wt, jrcfg,
            param_axes=jaxes), jstate, jb, jwts)
    got = _round_cost(tcfg, C, H, b, S, placement)["flops"]
    return want, got, tcfg


def _round_cost(tcfg, C, H, b, S, placement="mesh", delta_dtype="float32"):
    tp, taxes = TT.abstract_params(tcfg)

    def f32():
        return tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                              device=META), tp)

    state = so.ServerState(w=f32(), extra={"v": f32()},
                           t=torch.empty((), dtype=torch.int32, device=META))
    batch = {"tokens": torch.empty((C, H, b, S), dtype=torch.int32,
                                   device=META)}
    batch["labels"] = torch.empty_like(batch["tokens"])
    weights = torch.empty((C,), dtype=torch.float32, device=META)
    rcfg = RoundConfig(clients_per_round=C, local_steps=H, lr=0.01,
                       placement=placement, compute_dtype=tcfg.dtype,
                       delta_dtype=delta_dtype)
    opt = so.fedmom(eta=1.0, beta=0.9)

    def step(st, bt, wt):
        return round_step(lambda p, x: TT.loss_fn(p, tcfg, x), opt, st, bt,
                          wt, rcfg, param_axes=taxes, device=META)

    return cost.analyze(step, state, batch, weights)


def test_round_flops_dense_with_remat_hold_the_recompute_difference():
    C, H, b, S = 2, 2, 2, 32
    want, got, cfg = _rounds("qwen3-1.7b", {"remat": True,
                                            "scan_layers": True}, C, H, b, S)
    assert cfg.n_groups == 2
    # each group's recomputed MLP output product, once a group and step
    wo = 2 * (b * S) * cfg.d_ff * cfg.d_model
    assert got - want == cfg.n_groups * C * H * wo
    # scan placement, no remat: equal
    want, got, _ = _rounds("qwen3-1.7b", {}, 3, 2, 2, 32, placement="scan")
    assert got == want > 0


def test_round_flops_moe_hold_the_dense_dispatch_difference():
    C, H, b, S = 2, 2, 3, 32
    want, got, cfg = _rounds("granite-moe-1b-a400m", {}, C, H, b, S)
    G = b * S
    assert got > 0
    assert want - got == C * H * cfg.n_layers * (
        _dense_forward(cfg, G) + _dense_backward(cfg, G))


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b",
                                  "recurrentgemma-9b"])
def test_prefill_and_decode_flops_equal_the_reference(arch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    B, S, L = 2, 64, 128
    jp, _ = JT.abstract_params(jcfg)
    tp, _ = TT.abstract_params(tcfg)
    jcache, _ = JT.init_cache(jcfg, B, L, abstract=True)
    jtok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    want = _jax_flops(lambda p, bt, c: JT.prefill(p, jcfg, bt, c), jp,
                      {"tokens": jtok}, jcache)
    tcache, _ = TT.init_cache(tcfg, B, L, abstract=True)
    got = cost.analyze(lambda p, bt, c: TT.prefill(p, tcfg, bt, c), tp,
                       {"tokens": _meta(jtok)}, tcache)["flops"]
    assert got == want > 0
    jt1 = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    want = _jax_flops(
        lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos), jp, jcache,
        jt1, jax.ShapeDtypeStruct((), jnp.int32))
    for pos in (S, L - 1):
        got = cost.analyze(
            lambda p, c, t: TT.decode_step(p, tcfg, c, t, pos), tp, tcache,
            _meta(jt1))["flops"]
        assert got == want > 0, pos


# ---------------------------------------------------------------------------
# tests/test_hlo_cost.py's contracts, in the port's terms
# ---------------------------------------------------------------------------
def _loss_flops(cfg, B=2, S=32, grad=False):
    tp, _ = TT.abstract_params(cfg)
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    batch["labels"] = torch.empty_like(batch["tokens"])

    def fn(p, b):
        if grad:
            return torch.func.grad(lambda q: TT.loss_fn(q, cfg, b)[0])(p)
        return TT.loss_fn(p, cfg, b)

    return cost.analyze(fn, tp, batch)["flops"]


def test_flops_scale_linearly_with_layers_and_steps():
    cfg = get_config("qwen3-1.7b").reduced()
    f = {n: _loss_flops(cfg.replace(n_layers=n)) for n in (1, 2, 3, 5)}
    per_layer = f[2] - f[1]
    assert per_layer > 0
    assert f[3] - f[2] == per_layer and f[5] - f[3] == 2 * per_layer
    # local steps: one device, mesh placement; the delta's reduction is
    # one [C] x [C, n] product a round whatever H
    g = {h: _round_cost(cfg, 2, h, 2, 32)["flops"] for h in (1, 2, 4)}
    assert g[4] - g[2] == 2 * (g[2] - g[1]) > 0


def test_nested_loops_multiply():
    """Scan placement runs C clients of H steps each: C x H times one
    step's flops, and nothing else (the accumulation and the server step
    have no products)."""
    cfg = get_config("qwen3-1.7b").reduced()
    one = _round_cost(cfg, 1, 1, 2, 32, "scan")["flops"]
    assert one == _loss_flops(cfg, 2, 32, grad=True) > 0
    for C, H in ((2, 3), (3, 2), (4, 1)):
        assert _round_cost(cfg, C, H, 2, 32, "scan")["flops"] == C * H * one


def test_stacked_groups_count_equal_to_unstacked_layers():
    cfg = get_config("gemma3-1b").reduced()
    stacked = cfg.replace(scan_layers=True, remat=False)
    assert stacked.n_groups == 2
    assert _loss_flops(stacked) == _loss_flops(cfg) > 0
    assert _loss_flops(stacked, grad=True) == _loss_flops(cfg, grad=True)


def test_remat_recompute_is_counted():
    """With remat each stacked group's forward runs again in the backward:
    the count grows by exactly the groups' whole forward flops, their last
    product included (the reference's drops it: the module's
    docstring)."""
    cfg = get_config("qwen3-1.7b").reduced().replace(scan_layers=True)
    B, S = 2, 32
    plain = _loss_flops(cfg.replace(remat=False), B, S, grad=True)
    remat = _loss_flops(cfg.replace(remat=True), B, S, grad=True)
    per_layer = (_loss_flops(cfg.replace(n_layers=3, scan_layers=False))
                 - _loss_flops(cfg.replace(n_layers=2, scan_layers=False)))
    wo = 2 * B * S * cfg.d_ff * cfg.d_model
    assert remat - plain == cfg.n_groups * per_layer > cfg.n_groups * wo


def test_bytes_and_peak_of_a_known_step():
    """tanh(x @ w), fp32 n x n: the product reads 2 and writes 1 n^2
    tensor, the tanh reads 1 and writes 1; at the peak x, w, the product
    and the tanh's result are alive."""
    for n in (128, 256):
        x = torch.empty((n, n), device=META)
        w = torch.empty((n, n), device=META)
        res = cost.analyze(lambda a, b: torch.tanh(a @ b), x, w)
        assert res["flops"] == 2 * n ** 3
        assert res["bytes"] == 5 * 4 * n * n
        assert res["peak_bytes"] == 4 * 4 * n * n
        assert res["collectives"] == {} and res["collective_count"] == 0


def test_bytes_are_positive_and_scale_with_size():
    cfg = get_config("qwen3-1.7b").reduced()
    tp, _ = TT.abstract_params(cfg)
    out = []
    for S in (32, 64):
        b = {"tokens": torch.empty((2, S), dtype=torch.int32, device=META)}
        b["labels"] = torch.empty_like(b["tokens"])
        out.append(cost.analyze(lambda p, x: TT.loss_fn(p, cfg, x), tp, b))
    assert 0 < out[0]["bytes"] < out[1]["bytes"]
    assert 0 < out[0]["peak_bytes"] <= out[1]["peak_bytes"]


def test_views_and_in_place_results_move_no_bytes():
    x = torch.empty((64, 64), device=META)
    assert cost.analyze(lambda a: a.t()[:10].unsqueeze(0), x)["bytes"] == 0
    # a reshape of a transposed tensor is a copy: read once, written once
    assert cost.analyze(lambda a: a.t().reshape(-1), x)["bytes"] == \
        2 * 4 * 64 * 64
    # add_: reads both operands, its result aliases the first
    assert cost.analyze(lambda a, b: a.add_(b), x, x.clone())[
        "bytes"] == 2 * 4 * 64 * 64


@pytest.mark.parametrize("delta_dtype", ["float32", "bfloat16"])
def test_recording_mesh_sees_the_rounds_collectives(delta_dtype):
    """A 4-rank recording mesh: rank 0 trains its block of the cohort, then
    one all_reduce_ of the delta (fp32 whatever delta_dtype: the partials
    are reduced in fp32 and rounded once after, as the reference's
    program also reduces them, ROADMAP Queue 3) and one all-gather of the
    losses."""
    cfg = get_config("qwen3-1.7b").reduced()
    C = 8
    mesh = cost.RecordingMesh({"data": 4})
    with axis_rules(mesh, FED_MESH_RULES):
        res = _round_cost(cfg, C, 2, 2, 32, delta_dtype=delta_dtype)
    n = sum(x.numel() for x in leaves(TT.abstract_params(cfg)[0]))
    assert res["collectives"] == {
        "all-reduce": {"count": 1, "bytes": 4 * n},
        "all-gather": {"count": 1, "bytes": 4 * C}}
    assert res["collective_count"] == 2
    assert res["collective_bytes"] == 4 * n + 4 * C
    # rank 0 trains 2 of the 8 clients: a quarter of one device's steps
    alone = _round_cost(cfg, C, 2, 2, 32)
    assert alone["collectives"] == {}
    delta = 2 * C * n      # the [C] x [C, n] weighted reduction on one device
    block = 2 * 2 * n      # the same over rank 0's block of 2
    assert (alone["flops"] - delta) == 4 * (res["flops"] - block)


def test_recording_mesh_all_gather_and_all_to_all_shapes():
    mesh = cost.RecordingMesh({"pod": 2, "data": 2})
    assert mesh.size == 4 and mesh.shape == {"pod": 2, "data": 2}
    a = torch.empty((2, 3), device=META)
    b = torch.empty((1, 3), device=META)
    wa, wb = mesh.all_gather_blocks([(a, 7), (b, 3)])
    assert wa.shape == (7, 3) and wb.shape == (3, 3)
    assert mesh.all_to_all(torch.empty((8, 5), device=META)).shape == (8, 5)
    assert mesh.calls == [("all-gather", 4 * (2 + 1) * 3 * 4),
                          ("all-to-all", 8 * 5 * 4)]


def test_flops_equal_flop_counter_mode_and_profile_sums_them():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    tp, _ = TT.abstract_params(cfg)
    b = {"tokens": torch.empty((2, 64), dtype=torch.int32, device=META)}
    b["labels"] = torch.empty_like(b["tokens"])

    def fn(p, x):
        return torch.func.grad(lambda q: TT.loss_fn(q, cfg, x)[0])(p)

    with FlopCounterMode(display=False) as fc:
        fn(tp, b)
    res = cost.analyze(fn, tp, b)
    assert res["flops"] == fc.get_total_flops() > 0
    rows = cost.profile(fn, tp, b, top=10 ** 6, by="flops")
    assert sum(r[2] for r in rows) == res["flops"]
    assert sum(r[1] for r in rows) == res["bytes"]
    assert rows[0][2] >= rows[-1][2]
    # the experts' products, in the MoE node's forward and backward
    assert any(site in r[0] for r in rows[:5]
               for site in ("_group_forward", "_group_backward"))
    with pytest.raises(ValueError):
        cost.profile(fn, tp, b, by="time")


def test_a_kernel_on_meta_tensors_raises():
    cfg = get_config("gemma3-1b").reduced().replace(attention_impl="pallas")
    tp, _ = TT.abstract_params(cfg)
    # 128 positions: the kernel's dispatch rule takes multiples of 128
    b = {"tokens": torch.empty((2, 128), dtype=torch.int32, device=META)}
    b["labels"] = torch.empty_like(b["tokens"])
    with pytest.raises(NotImplementedError, match="flash_attention"):
        cost.analyze(lambda p, x: TT.loss_fn(p, cfg, x), tp, b)
    w = {"a": torch.empty((4,), device=META)}
    opt = so.fedmom(eta=1.0, beta=0.9, use_fused_kernel=True)
    with pytest.raises(NotImplementedError, match="fedmom_update"):
        opt.update(opt.init(w), w)


def test_roofline_terms_and_model_flops_match_the_reference_formulas():
    assert roofline.model_flops(10, 7, backward=True) == \
        hlo_analysis.model_flops(10, 7, backward=True) == 420.0
    assert roofline.model_flops(10, 7, backward=False) == \
        hlo_analysis.model_flops(10, 7, backward=False)
    t = roofline.roofline_terms(hw.PEAK_FLOPS_BF16, 2 * hw.HBM_BW,
                                0.5 * hw.NVLINK_BW)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (
        1.0, 2.0, 0.5)
    assert t["dominant"] == "memory" and t["bound_s"] == 2.0
    assert t["compute_fraction"] == 0.5
    assert hw.NVLINK_BW == 450e9 and hw.HBM_BYTES == 80e9
    for dtype, n in hw.BYTES.items():
        assert torch.empty((), dtype=dtype).element_size() == n, dtype
