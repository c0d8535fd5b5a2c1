"""A configuration file (``configs/<name>.json``) as the port runs it, and
the weights the benchmark makes for it.

The file keeps the published ``config.json``'s keys (``hidden_size``,
``num_hidden_layers``, ...) and adds ``harness``: the port's family, the
block's choices the published keys do not name, and options of the
port's ``ModelConfig`` that make it run the configuration as stated.
:func:`port_config` maps the file onto the port's ``ModelConfig``; the
plain reference (``reference/decoder.py``) reads the same file.

:func:`make_weights` draws every leaf from the seed on the device, in the
dtype it is served in, one stacked tensor a kind of leaf (all layers'
``wq`` in one), and hands the program per-layer views of them in its
parameter layout.  The reference reads the stacked tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

#: Keys of a configuration that the rehearsal on the CPU shrinks, and to
#: what (a tiny model of the same family; never used on the card).
REHEARSAL_SIZES = {"hidden_size": 64, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 16,
                   "intermediate_size": 128, "vocab_size": 512,
                   "num_hidden_layers": 2, "num_local_experts": 4}


def rehearsal(conf: Dict[str, Any]) -> Dict[str, Any]:
    """``conf`` at the rehearsal's tiny sizes (same family and block).  A
    configuration whose heads the port keeps unpadded keeps them unpadded
    at the tiny size too."""
    out = dict(conf)
    for k, v in REHEARSAL_SIZES.items():
        if k in conf or k == "head_dim":
            out[k] = v
    cfg = port_config(conf)
    if cfg.padded_heads == cfg.num_heads:
        h = dict(conf["harness"])
        h["port_options"] = dict(h.get("port_options", {}),
                                 head_pad_multiple=1)
        out["harness"] = h
    return out


def head_dim(conf: Dict[str, Any]) -> int:
    return int(conf.get("head_dim")
               or conf["hidden_size"] // conf["num_attention_heads"])


def port_config(conf: Dict[str, Any]):
    """The port's ``ModelConfig`` of ``conf``."""
    from repro_torch.configs.base import ModelConfig
    h = conf["harness"]
    moe = int(conf.get("num_local_experts", 0))
    kw = dict(
        name=conf["name"], family=h["family"],
        num_layers=int(conf["num_hidden_layers"]),
        d_model=int(conf["hidden_size"]),
        num_heads=int(conf["num_attention_heads"]),
        num_kv_heads=int(conf["num_key_value_heads"]),
        d_ff=int(conf["intermediate_size"]),
        vocab_size=int(conf["vocab_size"]),
        head_dim=head_dim(conf),
        qkv_bias=bool(h.get("qkv_bias", False)),
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf.get("tie_word_embeddings", False)),
        num_experts=moe,
        experts_per_token=int(conf.get("num_experts_per_tok", 0)),
        dtype=conf["torch_dtype"], param_dtype=conf["torch_dtype"])
    kw.update(h.get("port_options", {}))
    return ModelConfig(**kw)


def matmul_params(conf: Dict[str, Any]) -> int:
    """Weights a token multiplies through, as published: attention's four
    projections over the real heads, the feed-forward (a moe layer: its
    ``num_experts_per_tok`` routed experts and the router) and the head.
    The embedding is a lookup and counts nothing."""
    d, L = int(conf["hidden_size"]), int(conf["num_hidden_layers"])
    hd = head_dim(conf)
    q = int(conf["num_attention_heads"]) * hd
    kv = int(conf["num_key_value_heads"]) * hd
    attn = d * (2 * q + 2 * kv)
    f = int(conf["intermediate_size"])
    e = int(conf.get("num_local_experts", 0))
    ffn = (int(conf["num_experts_per_tok"]) * 3 * d * f + d * e if e
           else 3 * d * f)
    return L * (attn + ffn) + d * int(conf["vocab_size"])


def _fill(t: torch.Tensor, gen: torch.Generator, scale: float,
          mean: float = 0.0) -> torch.Tensor:
    """Fill ``t`` in place with N(mean, scale**2) from ``gen``, in chunks
    of at most 2**30 elements."""
    flat = t.view(-1) if t.dim() else t.view(1)
    step = 1 << 30
    for i in range(0, flat.numel(), step):
        flat[i:i + step].normal_(mean, scale, generator=gen)
    return t


def make_weights(conf: Dict[str, Any], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every weight of ``conf`` from ``seed``, stacked over layers:
    ``embed`` (Vp, d), ``lm_head`` (d, Vp) unless tied, ``ln_f`` (d,), ``ln1``/``ln2``
    (L, d), ``wq`` (L, d, Hp, hd), ``wk``/``wv`` (L, d, Hkv, hd), ``wo``
    (L, Hp, hd, d), with QKV bias ``bq`` (L, Hp, hd), ``bk``/``bv``; a
    dense layer ``wi_gate``/``wi_up`` (L, d, f), ``w_down`` (L, f, d); a
    moe layer ``router`` (L, d, E) fp32 and ``wi_gate``/``wi_up`` (L, E,
    d, f), ``w_down`` (L, E, f, d).  Vp and Hp are the port's padded
    vocabulary and heads (pad heads zero).  The scales are the port's
    initialiser's, norms and biases drawn around theirs so that a path
    that drops one shows."""
    cfg = port_config(conf)
    dt = getattr(torch, conf["torch_dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    H, Hp, Hkv = cfg.num_heads, cfg.padded_heads, cfg.num_kv_heads
    Vp, f = cfg.padded_vocab, cfg.d_ff

    def new(shape, scale, dtype=dt, mean=0.0):
        return _fill(torch.empty(shape, dtype=dtype, device=device), gen,
                     scale, mean)

    w = {"embed": new((Vp, d), 0.02),
         "ln_f": new((d,), 0.1, mean=1.0),
         "ln1": new((L, d), 0.1, mean=1.0),
         "ln2": new((L, d), 0.1, mean=1.0),
         "wq": new((L, d, Hp, hd), d ** -0.5),
         "wk": new((L, d, Hkv, hd), d ** -0.5),
         "wv": new((L, d, Hkv, hd), d ** -0.5),
         "wo": new((L, Hp, hd, d), (H * hd) ** -0.5)}
    if not cfg.tie_embeddings:
        w["lm_head"] = new((d, Vp), d ** -0.5)
    if cfg.qkv_bias:
        w["bq"] = new((L, Hp, hd), 0.3)
        w["bk"] = new((L, Hkv, hd), 0.3)
        w["bv"] = new((L, Hkv, hd), 0.3)
    if Hp != H:
        for k in ("wq", "bq"):
            if k in w:
                w[k][..., H:, :].zero_()
        w["wo"][:, H:].zero_()
    if cfg.is_moe:
        E = cfg.num_experts
        w["router"] = new((L, d, E), 0.02, dtype=torch.float32)
        w["wi_gate"] = new((L, E, d, f), d ** -0.5)
        w["wi_up"] = new((L, E, d, f), d ** -0.5)
        w["w_down"] = new((L, E, f, d), f ** -0.5)
    else:
        w["wi_gate"] = new((L, d, f), d ** -0.5)
        w["wi_up"] = new((L, d, f), d ** -0.5)
        w["w_down"] = new((L, f, d), f ** -0.5)
    return w


def program_params(w: Dict[str, torch.Tensor], conf: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """The port's parameter tree over views of ``w`` (no copy)."""
    cfg = port_config(conf)
    layers = []
    for i in range(cfg.num_layers):
        attn = {k: w[k][i] for k in ("wq", "wk", "wv", "wo")}
        if cfg.qkv_bias:
            attn.update({k: w[k][i] for k in ("bq", "bk", "bv")})
        ffn = {"wi_gate": w["wi_gate"][i], "wi_up": w["wi_up"][i],
               "wo": w["w_down"][i]}
        if cfg.is_moe:
            ffn["router"] = w["router"][i]
        layers.append({"ln1": w["ln1"][i], "attn": attn, "ln2": w["ln2"][i],
                       ("moe" if cfg.is_moe else "mlp"): ffn})
    params = {"embed": w["embed"], "ln_f": w["ln_f"], "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = w["lm_head"]
    return params

