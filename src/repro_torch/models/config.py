"""Model configuration for every architecture family in the zoo.

The port's copy of the JAX package's ``models/config.py``: the same
fields with the same defaults and values, so one config means the same
model in both packages.  A single ``ModelConfig`` describes dense GQA
transformers, MoE, RG-LRU hybrids, RWKV6 (attention-free),
encoder-decoder (whisper) and the paper's own small models (LeNet /
char-LSTM use their own tiny configs in ``repro_torch.models.small``).

The two kernel knobs keep the reference's values.  In the port
``attention_impl="pallas"`` selects the hand-written CUDA flash-attention
kernel (``csrc/flash_attention.cu``) for CUDA tensors, under the
reference's dispatch rule (self-attention with equal query and key
lengths, a multiple of 128); CPU tensors take the kernel's plain PyTorch
version.  ``"xla"`` selects the plain PyTorch path (``layers.attention``).
``rwkv_impl="pallas"`` selects the hand-written CUDA ``rwkv6_scan`` kernel
(``csrc/rwkv6_scan.cu``) for the forward's RWKV6 recurrence (train mode
only, the reference's rule: the kernel returns no state, so prefill and
decode keep ``layers.rwkv6_chunked`` / ``rwkv6_step``); ``"xla"`` the
plain ``layers.rwkv6_chunked``.

Layer heterogeneity (hybrids such as recurrentgemma's 2:1 recurrent:attention
or gemma3's 5:1 local:global) is expressed with ``layer_pattern`` — a cycle of
block kinds that tiles the depth.  Layer stacks are scanned over whole pattern
periods to bound HLO size (see models/transformer.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Block kinds usable in layer_pattern.
ATTN = "attn"          # global causal attention
LOCAL = "local"        # sliding-window causal attention (cfg.window)
RGLRU = "rglru"        # RecurrentGemma recurrent block (conv1d + RG-LRU)
RWKV = "rwkv"          # RWKV6 time-mix (channel-mix replaces the MLP too)

VALID_KINDS = (ATTN, LOCAL, RGLRU, RWKV)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # weight of the load-balance auxiliary loss (Shazeer-style)
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None     # default d_model // n_heads
    layer_pattern: Tuple[str, ...] = (ATTN,)
    window: int = 0                  # sliding window size for LOCAL blocks
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False              # multimodal 3D rope (qwen2-vl); falls
                                     # back to 1D positions when only text ids
                                     # are given, sections kept for fidelity
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    act: str = "swiglu"              # swiglu | geglu (3-matrix gated) | gelu (plain 2-matrix)
    pos: str = "rope"                # rope | learned | none
    max_position: int = 32_768       # size of the learned position table
    enc_dec: bool = False            # whisper-style encoder-decoder
    n_enc_layers: int = 0
    d_frontend: Optional[int] = None  # stubbed modality frontend embed dim
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # rwkv6 specifics
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64        # rank of the data-dependent decay LoRA
    rwkv_chunk: int = 32             # chunk length of the chunked scan
    # rg-lru specifics
    rnn_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4
    rglru_dtype: str = "float32"     # recurrence compute dtype (hillclimb:
                                     # bfloat16 halves the scan's HBM traffic)
    rglru_gate_gather: bool = False  # gather u before gate matmuls (kills
                                     # the fp32 partial-sum all-reduces)
    # MoE dispatch loop: 'map' = sequential groups (bounded memory, for
    # client-replica placement); 'vmap' = parallel groups sharded over the
    # data axes (scan/FSDP placement — keeps routing shard-local)
    moe_dispatch: str = "map"
    # kernel dispatch: 'xla' = the plain PyTorch paths; 'pallas' = the
    # hand-written CUDA kernels on CUDA tensors (their plain versions on
    # CPU tensors)
    attention_impl: str = "xla"      # xla | pallas
    rwkv_impl: str = "xla"           # xla | pallas
    # numerics / compilation
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master dtype (server side)
    remat: bool = True               # rematerialize each block in grads
    remat_policy: str = "full"       # full | dots (save matmul outputs;
                                     # trades HBM residency for recompute)
    scan_layers: bool = True
    # citation for the config numbers
    source: str = ""

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        for k in self.layer_pattern:
            if k not in VALID_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # ------------------------------------------------------------------
    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        """Number of whole layer-pattern periods (scanned)."""
        return self.n_layers // self.pattern_period

    @property
    def n_remainder(self) -> int:
        """Trailing layers that do not fill a period (unscanned)."""
        return self.n_layers % self.pattern_period

    def kinds_of_group(self) -> Tuple[str, ...]:
        return self.layer_pattern

    def kinds_of_remainder(self) -> Tuple[str, ...]:
        return self.layer_pattern[: self.n_remainder]

    @property
    def attention_free(self) -> bool:
        return all(k in (RGLRU, RWKV) for k in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True when no block attends over unbounded context (so a 500k
        decode cache stays bounded for those blocks).  Global-attention
        blocks make the arch quadratic unless they are LOCAL."""
        return all(k != ATTN for k in self.layer_pattern)

    @property
    def has_global_attention(self) -> bool:
        return any(k == ATTN for k in self.layer_pattern)

    @property
    def rnn_d(self) -> int:
        return self.rnn_width or self.d_model

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Analytic parameter count (used for 6ND roofline terms)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hq = self.n_heads * self.d_head
        hkv = self.n_kv_heads * self.d_head
        per_kind = {}
        attn = d * hq + 2 * d * hkv + hq * d
        if self.qkv_bias:
            attn += hq + 2 * hkv
        mlp = (3 if self.act in ("swiglu", "geglu") else 2) * d * ff
        if self.moe:
            mlp = self.moe.n_experts * mlp + d * self.moe.n_experts
        per_kind[ATTN] = attn + mlp
        per_kind[LOCAL] = attn + mlp
        r = self.rnn_d
        per_kind[RGLRU] = (2 * d * r + r * self.conv_width + 3 * r + r * d
                           + mlp)
        # rwkv: time-mix (r,k,v,g,o projections + decay lora) + channel mix
        per_kind[RWKV] = (4 * d * d + d * d
                          + 2 * d * self.rwkv_decay_lora
                          + self.rwkv_decay_lora * d
                          + 2 * d * ff)
        total = 0
        for i in range(self.n_layers):
            total += per_kind[self.layer_pattern[i % self.pattern_period]]
        total += 2 * self.n_layers * d  # norms
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        if self.enc_dec:
            enc_layer = attn + mlp + 2 * d
            total += self.n_enc_layers * enc_layer
            # decoder cross-attention per decoder layer
            total += self.n_layers * (attn + d)
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE uses top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        dense_mlp = (3 if self.act in ("swiglu", "geglu") else 2) * self.d_model * self.d_ff
        inactive = (self.moe.n_experts - self.moe.top_k) * dense_mlp
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if self.layer_pattern[i % self.pattern_period] in (ATTN, LOCAL))
        return self.n_params() - n_moe_layers * inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 pattern-periods deep, d_model<=256,
        <=4 experts — runs a real forward/backward on CPU."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = min(self.n_kv_heads, n_heads)
        while n_heads % n_kv:
            n_kv -= 1
        new_head = max(8, d_model // n_heads)
        sections = self.mrope_sections
        if self.mrope:
            half = new_head // 2
            tot = sum(sections)
            sections = [max(1, s * half // tot) for s in sections]
            sections[-1] += half - sum(sections)
            sections = tuple(sections)
        moe = None
        if self.moe:
            moe = MoEConfig(n_experts=min(self.moe.n_experts, 4),
                            top_k=min(self.moe.top_k, 2),
                            capacity_factor=self.moe.capacity_factor)
        return self.replace(
            name=self.name + "-reduced",
            n_layers=2 * self.pattern_period,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=new_head,
            mrope_sections=sections,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            window=min(self.window, 64) if self.window else 0,
            moe=moe,
            n_enc_layers=2 if self.enc_dec else 0,
            rnn_width=min(self.rnn_d, 256),
            rwkv_decay_lora=16,
            d_frontend=(min(self.d_frontend, 128) if self.d_frontend else None),
            remat=False,
            scan_layers=False,
        )
