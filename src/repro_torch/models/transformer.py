"""Architecture assembly of the zoo's ported families: embedding, the
(optionally stacked) heterogeneous block stack, KV / ring-buffer, RG-LRU
and RWKV recurrent-state caches, the forward loss, prefill and decode.

The port's counterpart of the JAX package's ``models/transformer.py``:

    init(cfg, key, device=None)              -> (params, logical_axes)
    apply(params, cfg, batch)                -> (logits, aux)
    loss_fn(params, cfg, batch)              -> (loss, metrics)  # trains
    init_cache(cfg, batch, max_len, device=None) -> (cache, logical_axes)
    prefill(params, cfg, batch, cache)       -> (logits_last, cache)
    decode_step(params, cfg, cache, tokens, pos) -> (logits, cache)

Parameter and cache trees have the reference's structure, keys, shapes and
dtypes: with ``cfg.scan_layers`` and more than one whole pattern period,
``groups`` holds every leaf stacked ``[n_groups, ...]`` and ``rem`` the
trailing layers, so a tree carries across packages as numpy
(``repro_torch.interop``).  The stacked groups run as a Python loop over
views of the stack (the counterpart of ``lax.scan``), and caches are
written in place.  ``init`` and ``init_cache`` run on ``cuda`` unless the
caller passes ``device``; the other functions run where their tensors lie.

``loss_fn`` trains under ``torch.func`` (the round engine's
``vmap(grad_and_value)``) and plain autograd alike.  With ``cfg.remat``
each stacked group is rematerialized as the reference's
``jax.checkpoint`` does: one ``autograd.Function`` (``_RematGroup``, with
``generate_vmap_rule``, so ``torch.func`` transforms it, which
``torch.utils.checkpoint`` does not allow) keeps the group's inputs and
recomputes the group under ``torch.func.vjp`` in the backward.
``remat_policy="dots"`` also keeps the outputs of the group's weight
products (``layers.proj``), which the recompute reads instead of
multiplying again.  Remat changes memory, not values: the grads are the
ones without it, bit for bit on the CPU.  The remainder layers are not
rematerialized, as in the reference.

Dense families (ATTN / LOCAL blocks, 1-D rope), the RG-LRU hybrids
(RGLRU and LOCAL blocks; the recurrence runs the log-depth
``layers.rglru_scan`` as in the reference, which wires its ``rglru_scan``
kernel into no model) and RWKV6 (RWKV blocks, no positions;
``rwkv_impl="pallas"`` sends the forward's recurrence through the CUDA
``rwkv6_scan`` kernel, prefill and decode keep the plain
``rwkv6_chunked`` / ``rwkv6_step`` as in the reference).  MoE,
encoder-decoder, learned positions and the VLM frontend raise
``NotImplementedError`` naming their ROADMAP items.  Abstract mode,
``abstract_params`` and ``logical_axes`` come with the dry-run tools
(ROADMAP Queue 1, tooling and benchmarks).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves, tree_map, unflatten_like


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stack_axes(axes_tree):
    if isinstance(axes_tree, dict):
        return {k: _stack_axes(v) for k, v in axes_tree.items()}
    return ("layers",) + axes_tree


def _check_supported(cfg: ModelConfig):
    if cfg.enc_dec:
        raise NotImplementedError(
            "encoder-decoder models come with the enc-dec slice (ROADMAP "
            "Queue 1, the rest of the zoo: encoder-decoder)")
    if cfg.pos == "learned":
        raise NotImplementedError(
            "learned positions come with the enc-dec slice (ROADMAP Queue 1, "
            "the rest of the zoo: encoder-decoder)")
    if cfg.d_frontend:
        raise NotImplementedError(
            "the stubbed VLM / audio frontends come with their slices "
            "(ROADMAP Queue 1, the rest of the zoo: encoder-decoder and "
            "VLM)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init(cfg: ModelConfig, key: torch.Tensor, *, device=None):
    """Keyed random weights, the reference's ``init`` draw for draw: the
    same key schedule (embedding, lm_head, then ``split(kg(), n_groups)``
    with one key per stacked group, then one ``KeyGen(kg())`` per
    remainder layer), so every leaf equals the reference's within the
    ``erfinv`` tolerance of ``repro_torch.random.normal``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    kg = B.KeyGen(key.to(dev))
    dtype = _dtype(cfg)
    D, V = cfg.d_model, cfg.vocab
    pairs = {
        "embed": B._normal(kg, (V, D), ("vocab", "embed"), torch.float32,
                           stddev=0.02),
        "final_norm": B._zeros((D,), ("embed",), torch.float32, kg=kg),
    }
    if not cfg.tie_embeddings:
        pairs["lm_head"] = B._dense(kg, (D, V), ("embed", "vocab"), dtype)

    def group_params(key):
        kg2 = B.KeyGen(key)
        sub = {f"b{i}": B.init_block(kg2, cfg, kind, dtype)
               for i, kind in enumerate(cfg.layer_pattern)}
        return B.split_pt(sub)

    scanned = cfg.scan_layers and cfg.n_groups > 1
    if scanned:
        # a loop stands in for the reference's vmap over the group keys;
        # each group is drawn, then copied into its slot of the stack
        keys = prng.split(kg(), cfg.n_groups)
        gp, g_axes = group_params(keys[0])
        stack = tree_map(
            lambda x: x.new_empty((cfg.n_groups,) + tuple(x.shape)), gp)
        for g in range(cfg.n_groups):
            if g:
                gp, _ = group_params(keys[g])
            tree_map(lambda dst, src: dst[g].copy_(src), stack, gp)
        del gp
        pairs["groups"] = (stack, _stack_axes(g_axes))
        rem_kinds = cfg.kinds_of_remainder()
    else:
        rem_kinds = tuple(cfg.layer_pattern[i % cfg.pattern_period]
                          for i in range(cfg.n_layers))
    if rem_kinds:
        rem = {f"l{i}": B.init_block(B.KeyGen(kg()), cfg, kind, dtype)
               for i, kind in enumerate(rem_kinds)}
        pairs["rem"] = B.split_pt(rem)
    return B.split_pt(pairs)


# ---------------------------------------------------------------------------
# rope helpers
# ---------------------------------------------------------------------------
def _make_rope(cfg: ModelConfig, positions: torch.Tensor,
               mrope_positions: Optional[torch.Tensor] = None):
    if cfg.pos != "rope":
        return None
    if cfg.mrope and mrope_positions is not None:
        raise NotImplementedError(
            "M-RoPE positions come with the VLM slice (ROADMAP Queue 1, the "
            "rest of the zoo: VLM)")
    return L.rope_tables(positions, cfg.d_head, cfg.rope_theta)


# ---------------------------------------------------------------------------
# remat: one stacked group recomputed in the backward
# ---------------------------------------------------------------------------
class _RematGroup(torch.autograd.Function):
    """``run(x, *weights, *extras) -> x`` as one node: the forward saves its
    inputs (and, under ``"dots"``, the weight products it recorded); the
    backward recomputes ``run`` under ``torch.func.vjp`` from them.  The
    first ``n_diff`` inputs (x and the group's weights) get grads; the
    extras (rope tables) do not.

    ``torch.func.grad`` always differentiates with ``create_graph=True``,
    which would keep the recompute's graph, and so every group's
    activations, alive through the whole backward: the grads leave the
    backward detached, so each group's recompute is freed when its
    backward returns.  The backward is therefore not differentiable
    again; nothing in the port takes a second derivative."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, policy, n_diff, *inputs):
        if policy != "dots":
            return (run(*inputs),)
        with L.recorded_products() as ys:
            x = run(*inputs)
        return (x, *ys)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run, ctx.policy, ctx.n_diff = inputs[:3]
        ctx.n_in = len(inputs) - 3
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(*inputs[3:], *output[1:])

    @staticmethod
    def backward(ctx, gx, *_):
        saved = ctx.saved_tensors
        diff, extras = saved[:ctx.n_diff], saved[ctx.n_diff:ctx.n_in]
        products = saved[ctx.n_in:]

        def rerun(*d):
            if ctx.policy != "dots":
                return ctx.run(*d, *extras)
            with L.replayed_products(products):
                return ctx.run(*d, *extras)

        _, vjp_fn = torch.func.vjp(rerun, *diff)
        grads = tuple(g.detach() for g in vjp_fn(gx))
        return (None, None, None) + grads + (None,) * len(extras)


def _remat_group(gp: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict):
    """One group's blocks through ``_RematGroup``.  The blocks' aux is a
    constant 0.0 here: MoE, the only source of one, raises at ``init``."""
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                         f"{cfg.remat_policy!r}")
    ws = leaves(gp)
    rope = tuple(ctx["rope"]) if ctx.get("rope") is not None else ()

    def run(x, *rest):
        p = unflatten_like(gp, list(rest[:len(ws)]))
        bctx = dict(ctx, rope=tuple(rest[len(ws):]) or None, cache=None)
        for i, kind in enumerate(cfg.layer_pattern):
            x, _, _ = B.apply_block(p[f"b{i}"], cfg, kind, x, bctx)
        return x

    return _RematGroup.apply(run, cfg.remat_policy, 1 + len(ws), x, *ws,
                             *rope)[0]


# ---------------------------------------------------------------------------
# stack application (shared by train / prefill / decode)
# ---------------------------------------------------------------------------
def _apply_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
                 cache: Optional[dict]):
    """Runs all decoder blocks.  Returns (x, cache, moe_aux): with a cache,
    its tensors are written in place and the same tree is returned."""
    aux = 0.0
    new_cache = {}
    use_cache = cache is not None

    if "groups" in params:
        # the reference checkpoints the scanned groups only where it
        # differentiates (no cache); so does the port, when grads flow
        remat = (cfg.remat and not use_cache and torch.is_grad_enabled()
                 and any(a.requires_grad
                         for a in leaves(params["groups"]) + [x]))
        # one unbind a leaf: its backward stacks the groups' grads in one
        # op, where indexing each group would add n_groups full-size
        # zero-padded grads
        stack = params["groups"]
        cols = [torch.unbind(a) for a in leaves(stack)]
        for g in range(cfg.n_groups):
            gp = unflatten_like(stack, [c[g] for c in cols])
            if remat:
                x = _remat_group(gp, cfg, x, ctx)
                continue
            gc = (tree_map(lambda a: a[g], cache["groups"]) if use_cache
                  else None)
            for i, kind in enumerate(cfg.layer_pattern):
                bctx = dict(ctx, cache=(gc[f"b{i}"] if gc else None))
                x, _, da = B.apply_block(gp[f"b{i}"], cfg, kind, x, bctx)
                aux = aux + da
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


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    if "patches" in batch:
        raise NotImplementedError(
            "VLM patch inputs come with the VLM slice (ROADMAP Queue 1, the "
            "rest of the zoo: VLM)")
    # gather, then cast: bit-equal to the reference's cast-then-gather, and
    # it does not copy the whole fp32 table on every call
    return params["embed"][batch["tokens"].long()].to(_dtype(cfg))


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


# ---------------------------------------------------------------------------
# forward + loss
# ---------------------------------------------------------------------------
def apply(params: dict, cfg: ModelConfig, batch: dict,
          *, q_chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    tokens = batch["tokens"]
    rope = _make_rope(cfg, _positions(batch, tokens),
                      batch.get("mrope_positions"))
    ctx = {"mode": "train", "rope": rope, "causal": True, "q_chunk": q_chunk}
    x = _embed_inputs(params, cfg, batch)
    x, _, aux = _apply_stack(params, cfg, x, ctx, cache=None)
    # aux is a Python 0.0 without MoE: a fill, not a copy from the host
    # (which a CUDA-graph capture refuses)
    aux = (aux.to(torch.float32) if isinstance(aux, torch.Tensor)
           else torch.full((), aux, dtype=torch.float32, device=x.device))
    return _logits(params, cfg, x), aux


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    """Mean next-token cross entropy over ``loss_mask``; differentiable
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
    metrics = {"loss": loss, "aux": aux, "tokens": torch.sum(mask)}
    return loss, metrics


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               *, dtype: Optional[torch.dtype] = None, device=None):
    """(cache, logical_axes) twin trees for the whole stack, on ``device``
    (``cuda`` unless given): ATTN blocks a linear [B, max_len, Hkv, Dh]
    K/V cache, LOCAL blocks a [B, min(window, max_len), Hkv, Dh] ring
    buffer with its slot positions (int32, -1 = empty), RGLRU blocks the
    fp32 recurrent state h [B, R] and the conv tail [B, conv_width - 1, R]
    in the cache dtype, RWKV blocks the fp32 recurrent state
    [B, H, Dh, Dh] and the two token-shift rows [B, D].  With stacked
    groups every leaf is one [n_groups, ...] tensor, which the blocks
    write through views."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)

    def one(kind):
        return B.init_block_cache(cfg, kind, batch, max_len, dtype,
                                  device=dev)

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


# ---------------------------------------------------------------------------
# prefill & decode
# ---------------------------------------------------------------------------
def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict,
            *, q_chunk: int = 1024):
    """Runs the prompt ``batch['tokens']`` [B, S] through the stack, writing
    the caches.  Returns (logits of the last position [B, V] fp32, cache)."""
    tokens = batch["tokens"]
    rope = _make_rope(cfg, _positions(batch, tokens),
                      batch.get("mrope_positions"))
    ctx = {"mode": "prefill", "rope": rope, "q_chunk": q_chunk}
    x = _embed_inputs(params, cfg, batch)
    x, new_cache, _ = _apply_stack(params, cfg, x, ctx, cache=cache)
    logits = _logits(params, cfg, x[:, -1:])
    return logits[:, 0], new_cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos):
    """One token step.  tokens [B,1] int, pos the absolute position (a host
    int; a tensor is read back).  Returns (logits [B,V] fp32, cache)."""
    Bsz = tokens.shape[0]
    pos = int(pos)
    positions = torch.full((Bsz, 1), pos, dtype=torch.int32,
                           device=tokens.device)
    rope = _make_rope(cfg, positions)
    ctx = {"mode": "decode", "rope": rope, "pos": pos}
    x = _embed_inputs(params, cfg, {"tokens": tokens})
    x, new_cache, _ = _apply_stack(params, cfg, x, ctx, cache=cache)
    logits = _logits(params, cfg, x)
    return logits[:, 0], new_cache
