"""Architecture assembly of the zoo: embedding, the (optionally stacked)
heterogeneous block stack, enc-dec wiring, KV / ring-buffer / cross-
attention, RG-LRU and RWKV recurrent-state caches, the forward loss,
prefill and decode.

The port's counterpart of the JAX package's ``models/transformer.py``:

    init(cfg, key, device=None)              -> (params, logical_axes)
    abstract_params(cfg)                     -> (meta tensors, logical_axes)
    logical_axes(cfg)                        -> logical_axes
    apply(params, cfg, batch)                -> (logits, aux)
    loss_fn(params, cfg, batch)              -> (loss, metrics)  # trains
    init_cache(cfg, batch, max_len, device=None, abstract=False)
                                             -> (cache, logical_axes)
    prefill(params, cfg, batch, cache)       -> (logits_last, cache)
    decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

Parameter and cache trees have the reference's structure, keys, shapes and
dtypes: with ``cfg.scan_layers`` and more than one whole pattern period,
``groups`` holds every leaf stacked ``[n_groups, ...]`` and ``rem`` the
trailing layers (an encoder's ``encoder`` stack likewise, or ``l{i}``
layers unstacked), so a tree carries across packages as numpy
(``repro_torch.interop``).  The stacked groups run as a Python loop over
views of the stack (the counterpart of ``lax.scan``), and caches are
written in place.  ``init`` and ``init_cache`` run on ``cuda`` unless the
caller passes ``device``; the other functions run where their tensors lie.

Every family of the zoo runs: dense (ATTN / LOCAL blocks, 1-D rope), MoE
(the MLP through ``layers.moe_apply``; the load-balance aux enters the
loss as ``aux_loss_weight * aux / n_layers``), the RG-LRU hybrids (the
recurrence runs the log-depth ``layers.rglru_scan`` as in the reference,
which wires its ``rglru_scan`` kernel into no model), RWKV6
(``rwkv_impl="pallas"`` sends the forward's recurrence through the CUDA
``rwkv6_scan`` kernel, prefill and decode keep the plain
``rwkv6_chunked`` / ``rwkv6_step`` as in the reference), the
encoder-decoder (whisper: learned positions, a stubbed frame frontend
``frontend_proj``, a non-causal encoder stack, cross-attention in every
decoder block) and the VLM (qwen2-vl: stubbed patch embeddings projected
over the first positions, M-RoPE from ``batch['mrope_positions']``
[3, B, S]).  Abstract mode (``abstract_params``, ``logical_axes``,
``init_cache(..., abstract=True)``) builds every leaf on the meta device
with its real shape and dtype and draws nothing, as the reference's
``_build(cfg, None)`` builds ShapeDtypeStructs; the dry run
(``launch/dryrun.py``) runs the model on such trees.

``loss_fn`` trains under ``torch.func`` (the round engine's
``vmap(grad_and_value)``) and plain autograd alike.  With ``cfg.remat``
each stacked group is rematerialized as the reference's
``jax.checkpoint`` does: one ``autograd.Function`` (``_RematGroup``, with
``generate_vmap_rule``, so ``torch.func`` transforms it, which
``torch.utils.checkpoint`` does not allow) keeps the group's inputs and
recomputes the group in the backward, differentiated by plain autograd
(under the round engine's ``vmap``, of the vmapped group); a MoE
group's aux is a differentiable output of it, so the router keeps its
load-balance gradient.  ``remat_policy="dots"`` also keeps the outputs of
the group's weight products (``layers.proj``), which the recompute reads
instead of multiplying again.  A stacked encoder is rematerialized layer
by layer under the full policy, as the reference's ``_encode`` does.
Remat changes memory, not values: the grads are the ones without it, bit
for bit on the CPU.  The remainder layers are not rematerialized, as in
the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.tree import leaves, tree_map, unflatten_like

# encoder sequence length for the stubbed audio frontend (whisper-medium
# natively produces 1500 frames; the reference rounds it to 1536)
ENC_LEN = 1536
# number of (stubbed) image patch embeddings prepended for VLM inputs
VLM_PATCHES = 256


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack_axes(axes_tree):
    if isinstance(axes_tree, dict):
        return {k: _stack_axes(v) for k, v in axes_tree.items()}
    return ("layers",) + axes_tree


def _stacked(make, key: Optional[torch.Tensor], n: int):
    """``make(key) -> (params, axes)`` drawn for each of ``split(key, n)``
    and stacked ``[n, ...]``: a loop stands in for the reference's vmap
    over the keys; each draw is copied into its slot of the stack.  With
    no key, one abstract probe, stacked on the meta device."""
    if key is None:
        one, axes = make(None)
        return tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)),
                        one), _stack_axes(axes)
    keys = prng.split(key, n)
    one, axes = make(keys[0])
    stack = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), one)
    for i in range(n):
        if i:
            one, _ = make(keys[i])
        tree_map(lambda dst, src: dst[i].copy_(src), stack, one)
    return stack, _stack_axes(axes)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _build(cfg: ModelConfig, key: Optional[torch.Tensor]):
    kg = B.KeyGen(key)
    dtype = _dtype(cfg)
    f32 = torch.float32
    D, V = cfg.d_model, cfg.vocab
    pairs = {
        "embed": B._normal(kg, (V, D), ("vocab", "embed"), f32, stddev=0.02),
        "final_norm": B._zeros((D,), ("embed",), f32, kg=kg),
    }
    if not cfg.tie_embeddings:
        pairs["lm_head"] = B._dense(kg, (D, V), ("embed", "vocab"), dtype)
    if cfg.pos == "learned":
        pairs["pos_emb"] = B._normal(kg, (cfg.max_position, D),
                                     (None, "embed"), f32, stddev=0.02)
    if cfg.d_frontend:
        pairs["frontend_proj"] = B._dense(
            kg, (cfg.d_frontend, D), (None, "embed"), dtype)
        if cfg.enc_dec and cfg.pos == "learned":
            pairs["enc_pos_emb"] = B._normal(
                kg, (ENC_LEN, D), (None, "embed"), f32, stddev=0.02)

    def group_params(key):
        kg2 = B.KeyGen(key)
        sub = {f"b{i}": B.init_block(kg2, cfg, kind, dtype, cross=cfg.enc_dec)
               for i, kind in enumerate(cfg.layer_pattern)}
        return B.split_pt(sub)

    if cfg.scan_layers and cfg.n_groups > 1:
        pairs["groups"] = _stacked(group_params, kg(), cfg.n_groups)
        rem_kinds = cfg.kinds_of_remainder()
    else:
        rem_kinds = tuple(cfg.layer_pattern[i % cfg.pattern_period]
                          for i in range(cfg.n_layers))
    if rem_kinds:
        rem = {f"l{i}": B.init_block(B.KeyGen(kg()), cfg, kind, dtype,
                                     cross=cfg.enc_dec)
               for i, kind in enumerate(rem_kinds)}
        pairs["rem"] = B.split_pt(rem)

    if cfg.enc_dec:
        def enc_params(key):
            return B.init_block(B.KeyGen(key), cfg, ATTN, dtype, cross=False)
        n_enc = cfg.n_enc_layers
        if cfg.scan_layers and n_enc > 1:
            pairs["encoder"] = _stacked(enc_params, kg(), n_enc)
        else:
            pairs["encoder"] = B.split_pt(
                {f"l{i}": enc_params(kg()) for i in range(n_enc)})
        pairs["enc_final_norm"] = B._zeros((D,), ("embed",), f32, kg=kg)
    return B.split_pt(pairs)


def init(cfg: ModelConfig, key: torch.Tensor, *, device=None):
    """Keyed random weights, the reference's ``init`` draw for draw: the
    same key schedule (embedding, final norm, lm_head, learned positions,
    frontend projection, encoder positions, then ``split(kg(), n_groups)``
    with one key per stacked group, one ``KeyGen(kg())`` per remainder
    layer, then the encoder's keys and its final norm), so every leaf
    equals the reference's within the ``erfinv`` tolerance of
    ``repro_torch.random.normal``."""
    return _build(cfg, key.to(resolve_device(device)))


def abstract_params(cfg: ModelConfig):
    """(params, logical_axes) with every leaf an empty meta tensor of the
    real shape and dtype; nothing is drawn or allocated."""
    return _build(cfg, None)


def logical_axes(cfg: ModelConfig):
    return _build(cfg, None)[1]


# ---------------------------------------------------------------------------
# rope helpers
# ---------------------------------------------------------------------------
def _make_rope(cfg: ModelConfig, positions: torch.Tensor,
               mrope_positions: Optional[torch.Tensor] = None):
    if cfg.pos != "rope":
        return None
    if cfg.mrope and mrope_positions is not None:
        return L.mrope_tables(mrope_positions, cfg.d_head, cfg.rope_theta,
                              cfg.mrope_sections)
    return L.rope_tables(positions, cfg.d_head, cfg.rope_theta)


# ---------------------------------------------------------------------------
# remat: one stacked group recomputed in the backward
# ---------------------------------------------------------------------------
class _RematGroup(torch.autograd.Function):
    """``run(x, *diff_rest, *extras) -> (x, [aux])`` as one node: the
    forward saves its inputs (and, under ``"dots"``, the weight products
    it recorded); the backward (``_RematGrads``) recomputes ``run`` from
    them.  The first ``n_diff`` inputs (x; a decoder group's encoder
    output, twice, see ``blocks._cross_mix``; the group's weights) get
    grads; the extras (rope tables) do not.  The first ``n_out`` outputs
    are differentiable (x, and a MoE group's aux).

    ``torch.func.grad`` always differentiates with ``create_graph=True``,
    which would keep the recompute's graph, and so every group's
    activations, alive through the whole backward: the recompute runs on
    detached inputs, so each group's is freed when its backward returns.
    The backward is therefore not differentiable again; nothing in the
    port takes a second derivative."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, policy, n_diff, n_out, *inputs):
        if policy != "dots":
            return run(*inputs)
        with L.recorded_products() as ys:
            outs = run(*inputs)
        return (*outs, *ys)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run, ctx.policy, ctx.n_diff, ctx.n_out = inputs[:4]
        ctx.n_in = len(inputs) - 4
        ctx.mark_non_differentiable(*output[ctx.n_out:])
        ctx.save_for_backward(*inputs[4:], *output[ctx.n_out:])

    @staticmethod
    def backward(ctx, *gouts):
        n_extra = ctx.n_in - ctx.n_diff
        grads = _RematGrads.apply(ctx.run, ctx.policy, ctx.n_diff, ctx.n_out,
                                  n_extra, torch.is_grad_enabled(),
                                  *gouts[:ctx.n_out], *ctx.saved_tensors)
        return (None,) * 4 + tuple(grads) + (None,) * n_extra


def _rerun(run, policy, n_diff, n_extra):
    """``run`` on (diff, extras, products), the products replayed under
    ``"dots"``."""
    def rerun(*a):
        diff, extras = a[:n_diff], a[n_diff:n_diff + n_extra]
        if policy != "dots":
            return run(*diff, *extras)
        with L.replayed_products(a[n_diff + n_extra:]):
            return run(*diff, *extras)
    return rerun


class _RematGrads(torch.autograd.Function):
    """``_RematGroup``'s backward as one node: the recompute and its
    gradients by plain autograd on detached inputs, with the grad mode of
    the backward that called it (``torch.func.grad`` differentiates with
    ``create_graph``, under which autograd takes another formula for some
    operations, ``silu``'s among them: the grads stay bit-equal to the
    ones without remat), and returned detached.  Its ``vmap`` rule
    (the round engine's clients) recomputes under one ``vmap`` of the
    group and differentiates that by plain autograd, so the recompute pays
    ``torch.func``'s wrappers of one level and its backward none, where a
    ``torch.func.vjp`` under the generated rule paid those of three levels
    an operation.  An unbatched input (the weights every client shares at
    its first step) is expanded before it is differentiated: each client
    gets its own grads, as ``vmap`` of the backward gives them."""

    @staticmethod
    def forward(run, policy, n_diff, n_out, n_extra, graph, *args):
        gouts, rest = args[:n_out], args[n_out:]
        with torch.enable_grad():
            d = [a.detach().requires_grad_() for a in rest[:n_diff]]
            outs = _rerun(run, policy, n_diff, n_extra)(*d, *rest[n_diff:])
            grads = torch.autograd.grad(outs[:n_out], d, gouts,
                                        create_graph=graph,
                                        allow_unused=True,
                                        materialize_grads=True)
        return tuple(g.detach() for g in grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("a remat group's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, run, policy, n_diff, n_out, n_extra, graph,
             *args):
        B, dims = info.batch_size, in_dims[6:]

        def first(a, d):
            return a.expand(B, *a.shape) if d is None else a.movedim(d, 0)

        gouts = [first(a, d) for a, d in zip(args[:n_out], dims[:n_out])]
        rest, dims = args[n_out:], dims[n_out:]
        with torch.enable_grad():
            d = [first(a, dd).detach().requires_grad_()
                 for a, dd in zip(rest[:n_diff], dims[:n_diff])]
            outs = torch.func.vmap(
                _rerun(run, policy, n_diff, n_extra),
                in_dims=(0,) * n_diff + tuple(dims[n_diff:]),
                randomness=info.randomness)(*d, *rest[n_diff:])
            grads = torch.autograd.grad(outs[:n_out], d, gouts,
                                        create_graph=graph,
                                        allow_unused=True,
                                        materialize_grads=True)
        return tuple(g.detach() for g in grads), (0,) * n_diff


def _remat_group(gp: dict, cfg: ModelConfig, kinds, x: torch.Tensor,
                 ctx: dict, policy: str):
    """The blocks ``gp['b{i}']`` of ``kinds`` through ``_RematGroup``.
    Returns (x, aux): under MoE the blocks' summed aux, a differentiable
    output, else 0.0."""
    if policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                         f"{policy!r}")
    ws = leaves(gp)
    rope = tuple(ctx["rope"]) if ctx.get("rope") is not None else ()
    enc = tuple(ctx.get("enc_vk", ()))
    n_enc, n_ws = len(enc), len(ws)
    with_aux = cfg.moe is not None

    def run(x, *rest):
        p = unflatten_like(gp, list(rest[n_enc:n_enc + n_ws]))
        bctx = dict(ctx, rope=tuple(rest[n_enc + n_ws:]) or None, cache=None)
        if n_enc:
            bctx["enc_vk"] = rest[:n_enc]
        a = 0.0
        for i, kind in enumerate(kinds):
            x, _, da = B.apply_block(p[f"b{i}"], cfg, kind, x, bctx)
            a = a + da
        return (x, a) if with_aux else (x,)

    outs = _RematGroup.apply(run, policy, 1 + n_enc + n_ws,
                             2 if with_aux else 1, x, *enc, *ws, *rope)
    return outs[0], (outs[1] if with_aux else 0.0)


def _grads_flow(stack: dict, x: torch.Tensor) -> bool:
    """Whether a forward through ``stack`` is differentiated: the
    reference checkpoints the scanned stacks only where it differentiates
    (no cache); so does the port."""
    return torch.is_grad_enabled() and any(
        a.requires_grad for a in leaves(stack) + [x])


# ---------------------------------------------------------------------------
# stack application (shared by train / prefill / decode)
# ---------------------------------------------------------------------------
def _apply_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
                 cache: Optional[dict]):
    """Runs all decoder blocks.  Returns (x, cache, moe_aux): with a cache,
    its tensors are written in place and the same tree is returned.  The
    aux sums each stacked group's blocks, then the groups, then the
    remainder's blocks, as the reference's scan does."""
    aux = 0.0
    new_cache = {}
    use_cache = cache is not None

    if "groups" in params:
        kinds = cfg.layer_pattern
        remat = cfg.remat and not use_cache and _grads_flow(
            params["groups"], x)
        # one unbind a leaf: its backward stacks the groups' grads in one
        # op, where indexing each group would add n_groups full-size
        # zero-padded grads
        stack = params["groups"]
        cols = [torch.unbind(a) for a in leaves(stack)]
        for g in range(cfg.n_groups):
            gp = unflatten_like(stack, [c[g] for c in cols])
            if remat:
                x, a = _remat_group(gp, cfg, kinds, x, ctx, cfg.remat_policy)
                aux = aux + a
                continue
            gc = (tree_map(lambda t: t[g], cache["groups"]) if use_cache
                  else None)
            a = 0.0
            for i, kind in enumerate(kinds):
                bctx = dict(ctx, cache=(gc[f"b{i}"] if gc else None))
                x, _, da = B.apply_block(gp[f"b{i}"], cfg, kind, x, bctx)
                a = a + da
            aux = aux + a
        if use_cache:
            new_cache["groups"] = cache["groups"]
        rem_kinds = cfg.kinds_of_remainder()
    else:
        rem_kinds = tuple(cfg.layer_pattern[i % cfg.pattern_period]
                          for i in range(cfg.n_layers))

    if "rem" in params:
        rem_cache = cache.get("rem") if use_cache else None
        for i, kind in enumerate(rem_kinds):
            bctx = dict(ctx, cache=(rem_cache[f"l{i}"] if rem_cache else None))
            x, _, da = B.apply_block(params["rem"][f"l{i}"], cfg, kind, x,
                                     bctx)
            aux = aux + da
        if rem_cache:
            new_cache["rem"] = rem_cache

    return x, (new_cache or None), aux


def _encode(params: dict, cfg: ModelConfig, frames: torch.Tensor):
    """Whisper-style encoder over stubbed frame embeddings [B, T,
    d_frontend]: the frontend projection, learned encoder positions, the
    non-causal ATTN stack (a stacked one rematerialized layer by layer
    under the full policy when ``cfg.remat`` and grads flow, as the
    reference checkpoints its scan), the final norm."""
    x = L.proj(frames.to(_dtype(cfg)), params["frontend_proj"])
    if "enc_pos_emb" in params:
        x = x + params["enc_pos_emb"][:x.shape[1]].to(x.dtype)[None]
    ctx = {"mode": "train", "rope": None, "causal": False}
    enc = params["encoder"]
    if "l0" in enc:                  # unstacked per-layer dict
        for i in range(cfg.n_enc_layers):
            x, _, _ = B.apply_block(enc[f"l{i}"], cfg, ATTN, x, ctx)
    else:
        remat = cfg.remat and _grads_flow(enc, x)
        cols = [torch.unbind(a) for a in leaves(enc)]
        for i in range(cfg.n_enc_layers):
            lp = unflatten_like(enc, [c[i] for c in cols])
            if remat:
                x, _ = _remat_group({"b0": lp}, cfg, (ATTN,), x, ctx, "full")
            else:
                x, _, _ = B.apply_block(lp, cfg, ATTN, x, ctx)
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings (gather, then cast: bit-equal to the reference's
    cast-then-gather, without copying the whole fp32 table on every
    call), plus learned positions; a VLM's ``batch['patches']`` [B, P,
    d_frontend] projected by ``frontend_proj`` replace the first P
    positions."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    if cfg.pos == "learned":
        x = x + params["pos_emb"][:tokens.shape[1]].to(x.dtype)[None]
    if cfg.family == "vlm" and "patches" in batch:
        proj = L.proj(batch["patches"].to(_dtype(cfg)),
                      params["frontend_proj"])
        x = torch.cat([proj, x[:, proj.shape[1]:]], dim=1)
    return x


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    else:
        logits = x @ params["lm_head"]
    return logits.to(torch.float32)


def _positions(batch: dict, tokens: torch.Tensor) -> torch.Tensor:
    positions = batch.get("positions")
    if positions is None:
        Bsz, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(Bsz, S)
    return positions


def _context(params: dict, cfg: ModelConfig, batch: dict, mode: str,
             **kw) -> dict:
    """The blocks' context of a full-sequence pass: rope tables (M-RoPE
    from ``batch['mrope_positions']`` where the config has it) and, for an
    encoder-decoder, the encoder's output over ``batch['frames']`` as
    ``enc_vk`` (see ``blocks._cross_mix``)."""
    rope = _make_rope(cfg, _positions(batch, batch["tokens"]),
                      batch.get("mrope_positions"))
    ctx = dict(mode=mode, rope=rope, **kw)
    if cfg.enc_dec:
        enc = _encode(params, cfg, batch["frames"])
        ctx["enc_vk"] = (enc, enc)
    return ctx


# ---------------------------------------------------------------------------
# forward + loss
# ---------------------------------------------------------------------------
def apply(params: dict, cfg: ModelConfig, batch: dict,
          *, q_chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    ctx = _context(params, cfg, batch, "train", causal=True, q_chunk=q_chunk)
    x = _embed_inputs(params, cfg, batch)
    x, _, aux = _apply_stack(params, cfg, x, ctx, cache=None)
    # aux is a Python 0.0 without MoE: a fill, not a copy from the host
    # (which a CUDA-graph capture refuses)
    aux = (aux.to(torch.float32) if isinstance(aux, torch.Tensor)
           else torch.full((), aux, dtype=torch.float32, device=x.device))
    return _logits(params, cfg, x), aux


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    """Mean next-token cross entropy over ``loss_mask``, plus the MoE
    load-balance term ``aux_loss_weight * aux / n_layers``; differentiable
    under ``torch.func`` and autograd (the kernels of
    ``attention_impl="pallas"`` and ``rwkv_impl="pallas"`` are forward
    only, in both packages, and raise under grad)."""
    logits, aux = apply(params, cfg, batch)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - true_logit) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll) / denom
    if cfg.moe:
        loss = loss + cfg.moe.aux_loss_weight * aux / max(cfg.n_layers, 1)
    metrics = {"loss": loss, "aux": aux, "tokens": torch.sum(mask)}
    return loss, metrics


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               *, dtype: Optional[torch.dtype] = None, device=None,
               abstract: bool = False):
    """(cache, logical_axes) twin trees for the whole stack, on ``device``
    (``cuda`` unless given; the meta device when ``abstract``): ATTN
    blocks a linear [B, max_len, Hkv, Dh] K/V cache, LOCAL blocks a [B, min(window, max_len), Hkv, Dh] ring
    buffer with its slot positions (int32, -1 = empty), RGLRU blocks the
    fp32 recurrent state h [B, R] and the conv tail [B, conv_width - 1, R]
    in the cache dtype, RWKV blocks the fp32 recurrent state
    [B, H, Dh, Dh] and the two token-shift rows [B, D]; an
    encoder-decoder's blocks also the cross-attention K/V [B, ENC_LEN, H,
    Dh].  With stacked groups every leaf is one [n_groups, ...] tensor,
    which the blocks write through views."""
    dev = B.META if abstract else resolve_device(device)
    dtype = dtype or _dtype(cfg)
    cross_len = ENC_LEN if cfg.enc_dec else 0

    def one(kind):
        return B.init_block_cache(cfg, kind, batch, max_len, dtype,
                                  cross_len=cross_len, device=dev)

    pairs = {}
    if cfg.scan_layers and cfg.n_groups > 1:
        sub_p, sub_a = {}, {}
        for i, kind in enumerate(cfg.layer_pattern):
            c, a = one(kind)
            sub_p[f"b{i}"] = tree_map(
                lambda z: z.expand((cfg.n_groups,) + tuple(z.shape))
                .contiguous(), c)
            sub_a[f"b{i}"] = _stack_axes(a)
        pairs["groups"] = (sub_p, sub_a)
        rem_kinds = cfg.kinds_of_remainder()
    else:
        rem_kinds = tuple(cfg.layer_pattern[i % cfg.pattern_period]
                          for i in range(cfg.n_layers))
    if rem_kinds:
        rp, ra = {}, {}
        for i, kind in enumerate(rem_kinds):
            rp[f"l{i}"], ra[f"l{i}"] = one(kind)
        pairs["rem"] = (rp, ra)
    return B.split_pt(pairs)


def _fit_cross(node, length: int):
    """Size every cross-attention K/V of a cache to the encoder's
    ``length`` (axis -3), replacing the tensors in place in the tree: the
    reference's prefill returns them at the encoder's length, whatever
    ``init_cache`` allocated."""
    if not isinstance(node, dict):
        return
    for key, sub in node.items():
        if key == "cross":
            for name, t in sub.items():
                if t.shape[-3] != length:
                    shape = t.shape[:-3] + (length,) + t.shape[-2:]
                    sub[name] = t.new_zeros(shape)
        else:
            _fit_cross(sub, length)


# ---------------------------------------------------------------------------
# prefill & decode
# ---------------------------------------------------------------------------
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
            *, q_chunk: int = 1024):
    """Runs the prompt ``batch['tokens']`` [B, S] (with ``frames``,
    ``patches`` and ``mrope_positions`` where the family takes them)
    through the stack, writing the caches.  Returns (logits of the last
    position [B, V] fp32, cache)."""
    ctx = _context(params, cfg, batch, "prefill", q_chunk=q_chunk)
    if cfg.enc_dec:
        _fit_cross(cache, ctx["enc_vk"][0].shape[1])
    x = _embed_inputs(params, cfg, batch)
    x, new_cache, _ = _apply_stack(params, cfg, x, ctx, cache=cache)
    logits = _logits(params, cfg, x[:, -1:])
    return logits[:, 0], new_cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos):
    """One token step.  tokens [B,1] int, pos the absolute position (a host
    int; a tensor is read back).  Learned positions add row ``pos``;
    M-RoPE takes ``pos`` on all three streams, as the reference does.
    Returns (logits [B,V] fp32, cache)."""
    Bsz = tokens.shape[0]
    pos = int(pos)
    positions = torch.full((Bsz, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    mpos = (torch.full((3, Bsz, 1), pos, dtype=torch.int32,
                       device=tokens.device) if cfg.mrope else None)
    rope = _make_rope(cfg, positions, mpos)
    ctx = {"mode": "decode", "rope": rope, "pos": pos}
    x = params["embed"][tokens.long()].to(_dtype(cfg))
    if cfg.pos == "learned":
        x = x + params["pos_emb"][pos:pos + 1].to(x.dtype)[None]
    x, new_cache, _ = _apply_stack(params, cfg, x, ctx, cache=cache)
    logits = _logits(params, cfg, x)
    return logits[:, 0], new_cache
