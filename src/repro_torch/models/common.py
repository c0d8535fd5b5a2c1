"""Shared model substrate: initialisers, norms, embeddings, RoPE.

Parameters are plain nested dicts of tensors in the JAX package's layouts,
so :mod:`repro_torch.convert` copies JAX parameters in without reshaping.
Initialisers draw from an explicit ``torch.Generator``; they reproduce the
JAX shapes and scales, not its random numbers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` -> the torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Initializers (shapes and scales of repro/models/common.py)
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
           scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else (
        shape[0] ** -0.5 if len(shape) > 1 else 0.02)
    v = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return v.to(dtype)


def zeros(shape: Sequence[int], dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape: Sequence[int], dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    return normal(gen, (cfg.padded_vocab, cfg.d_model),
                  torch_dtype(cfg.param_dtype), scale=0.02)


class _EmbedLookup(torch.autograd.Function):
    """Row gather whose backward scatters the gradient into an fp32 table
    and casts it to the table's dtype once (the JAX package's
    ``_embed_lookup`` custom VJP): repeated tokens sum in fp32, not in
    bf16."""

    @staticmethod
    def forward(ctx, emb, tokens):
        ctx.save_for_backward(tokens)
        ctx.table = (emb.shape, emb.dtype)
        return emb[tokens]

    @staticmethod
    def backward(ctx, dy):
        (tokens,) = ctx.saved_tensors
        shape, dtype = ctx.table
        g = torch.zeros(shape, dtype=torch.float32, device=dy.device)
        g.index_add_(0, tokens.reshape(-1),
                     dy.reshape(-1, shape[-1]).float())
        return g.to(dtype), None


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Embedding lookup, cast to the compute dtype."""
    return _EmbedLookup.apply(emb, tokens).to(torch_dtype(cfg.dtype))


def lm_head_init(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    return normal(gen, (cfg.d_model, cfg.padded_vocab),
                  torch_dtype(cfg.param_dtype))


class _MatmulF32Out(torch.autograd.Function):
    """``x @ h`` of two bf16 CUDA matrices with an fp32 product
    (``torch.mm(..., out_dtype=float32)``, which has no derivative of its
    own).  The gradients are bf16 products of the fp32 cotangent rounded to
    bf16, in the operands' dtype."""

    @staticmethod
    def forward(ctx, x, h):
        ctx.save_for_backward(x, h)
        return torch.mm(x, h, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, h = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ h.t(), x.t() @ g


def lm_logits(x: torch.Tensor, head: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) -> fp32 logits (B, S, padded_vocab), pad columns -1e30.

    The product accumulates and returns fp32 from x's dtype, as the JAX
    einsum's ``preferred_element_type=float32`` does: on the card through
    ``torch.mm``'s ``out_dtype`` (:class:`_MatmulF32Out`), on the CPU by
    upcasting (exact for bf16 products)."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    h = head.to(x.dtype)
    if x.dtype == torch.float32:
        logits = x2 @ h
    elif x.is_cuda:
        logits = _MatmulF32Out.apply(x2, h)
    else:
        logits = x2.float() @ h.float()
    logits = logits.reshape(B, S, -1)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Rotary embeddings (standard; M-RoPE belongs to the vlm family)
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (B, S) int -> (B, S, head_dim // 2) fp32 angles."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].float() * freqs


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); angles: (B, S, D//2).  Rotate-half, in fp32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, cfg: ModelConfig,
                      device) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1 (M-RoPE's (3, B, S) streams come with
    the vlm family)."""
    if cfg.mrope_sections:
        raise NotImplementedError(
            "M-RoPE positions are not ported yet (ROADMAP queue 1, item 1)")
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos[None, :].expand(batch, seq)
