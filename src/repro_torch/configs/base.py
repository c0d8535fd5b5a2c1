"""Configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a :class:`ModelConfig`; every
assigned input shape as a :class:`ShapeConfig`.  Configs are frozen
dataclasses so they hash and can key compilation caches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    Field groups further down only apply to the family named in the comment;
    they default to inert values for other families.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # -- attention ----------------------------------------------------------
    head_dim: Optional[int] = None          # default: d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # -- moe -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- ssm (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 256

    # -- hybrid (RG-LRU + local attention) ------------------------------------
    lru_width: int = 0
    local_window: int = 0
    # pattern of one block group, e.g. ("rec", "rec", "attn"); repeated over depth
    block_pattern: Tuple[str, ...] = ()

    # -- encoder/decoder ------------------------------------------------------
    encoder_layers: int = 0
    decoder_layers: int = 0

    # -- vlm (M-RoPE) ----------------------------------------------------------
    mrope_sections: Tuple[int, ...] = ()

    # -- frontend stubs --------------------------------------------------------
    # When True, ``input_specs`` provides precomputed frame/patch embeddings for
    # the (audio/vision) frontend instead of token ids (backbone-only mandate).
    embeds_input: bool = False

    # -- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "bfloat16"  # stored parameter dtype

    # -- sharding overrides (hillclimbing hooks) --------------------------------
    # attention TP strategy: "head" (shard q+kv heads), "kv_repl" (shard q heads,
    # replicate kv), "uneven" (shard both, GSPMD pads), "seq" (shard q sequence).
    attn_shard: str = "auto"
    # q-head padding: attention heads are zero-padded (with masked outputs,
    # mathematically exact — see models/attention.py) up to a multiple of
    # this so head-TP shards evenly on the 16-way model axis (40 q heads on
    # 16 devices would otherwise replicate attention entirely)
    head_pad_multiple: int = 16
    # remat policy: "full" (recompute everything; the 16 GB/chip
    # HBM budget at 4k x 256 batch demands it — see EXPERIMENTS.md
    # §Perf iteration 0), "dots", "none"
    remat: str = "full"

    # -------------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_heads(self) -> int:
        m = max(self.head_pad_multiple, 1)
        return ((self.num_heads + m - 1) // m) * m

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple so the vocab dim shards over
        any reasonable TP degree (pad logits are masked in the loss)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs run the long_500k shape; full-attention skip it."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    # -- parameter counting ----------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        p = self.d_model * (self.q_dim + 2 * self.kv_dim)          # qkv
        p += self.q_dim * self.d_model                              # out proj
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        return p

    def _mlp_params(self, d_ff: int) -> int:
        # SwiGLU: gate + up + down
        return 3 * self.d_model * d_ff

    def _ssm_params(self) -> int:
        di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
        p = self.d_model * (2 * di + 2 * ns + nh)   # in_proj (z,x,B,C,dt)
        p += self.conv_width * (di + 2 * ns)          # conv over x,B,C
        p += nh * 2                                    # A_log, D
        p += di * self.d_model                         # out proj
        p += di                                        # gate norm
        return p

    def _rglru_params(self) -> int:
        w = self.lru_width
        p = self.d_model * 2 * w                       # in proj (x, gate branch)
        p += self.conv_width * w                       # temporal conv
        # RG-LRU gates: input gate + recurrence gate (diagonal) + a_param
        p += 2 * w + w
        p += w * self.d_model                          # out proj
        return p

    def num_params(self) -> int:
        """Total parameter count N (embedding included once, lm head extra
        unless tied)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        if self.embeds_input:
            pass  # frontend stubbed; token path kept for decoder text side
        per_layer = 0
        if self.family == "ssm":
            per_layer = self._ssm_params() + d          # + norm
            return emb + head + L * per_layer
        if self.family == "hybrid":
            pat = self.block_pattern or ("rec", "rec", "attn")
            groups, rem = divmod(L, len(pat))
            counts = {k: groups * pat.count(k) for k in ("rec", "attn")}
            for k in pat[:rem]:
                counts[k] += 1
            total = counts["rec"] * (self._rglru_params() + self._mlp_params(self.d_ff) + 2 * d)
            total += counts["attn"] * (self._attn_params() + self._mlp_params(self.d_ff) + 2 * d)
            return emb + head + total
        if self.family == "encdec":
            enc = self.encoder_layers * (self._attn_params() + self._mlp_params(self.d_ff) + 2 * d)
            dec = self.decoder_layers * (2 * self._attn_params() + self._mlp_params(self.d_ff) + 3 * d)
            return emb + head + enc + dec
        # dense / moe / vlm share a decoder-only skeleton
        attn = self._attn_params()
        if self.is_moe:
            mlp = self.num_experts * self._mlp_params(self.d_ff) + self.d_model * self.num_experts
        else:
            mlp = self._mlp_params(self.d_ff)
        per_layer = attn + mlp + 2 * d
        return emb + head + L * per_layer

    def active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        attn = self._attn_params()
        mlp = self.experts_per_token * self._mlp_params(self.d_ff) + d * self.num_experts
        return emb + head + L * (attn + mlp + 2 * d)

    # -- smoke-test reduction ----------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        kv = max(1, min(self.num_kv_heads, 2))
        heads = max(kv, min(self.num_heads, 4))
        updates = dict(
            name=self.name + "-smoke",
            head_pad_multiple=1,
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            dtype="float32",
            param_dtype="float32",
        )
        if self.is_moe:
            updates.update(num_experts=4, experts_per_token=2)
        if self.family == "ssm":
            updates.update(ssm_state=16, ssm_head_dim=16, ssd_chunk=8)
        if self.family == "hybrid":
            updates.update(lru_width=64, local_window=16, num_layers=3)
        if self.family == "encdec":
            updates.update(encoder_layers=1, decoder_layers=1)
        if self.family == "vlm":
            updates.update(mrope_sections=(4, 6, 6))
        return dataclasses.replace(self, **updates)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len x global_batch) input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long_decode"

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, name=self.name + "-smoke", seq_len=min(self.seq_len, 32),
            global_batch=min(self.global_batch, 2))


def applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether this (arch x shape) cell is runnable; returns (ok, reason)."""
    if shape.kind == "long_decode" and not model.supports_long_context:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
