"""The plain reference of the decoder LMs the benchmark serves: float32
PyTorch with TF32 off, no kernels, no cache, no batching across requests.

It reads a configuration file (``configs/<name>.json``) and the weights the
benchmark made (``harness/modelcfg.py::make_weights``: stacked over layers),
and imports nothing of the program.  The block is the one the file states:

* token embedding; per layer RMSNorm, attention with rotary positions
  (rotate-half, ``rope_theta``), grouped KV heads (query head ``h`` reads KV
  head ``h // (heads / kv_heads)``), optional QKV bias, an output
  projection, a residual; RMSNorm and a SwiGLU feed-forward or a mixture of
  SwiGLU experts (softmax router over ``num_local_experts``, the top
  ``num_experts_per_tok`` renormalised), a residual; a final RMSNorm and
  the head over the real vocabulary.

It runs layer by layer over every sequence at once, so that one layer's
weights are held in float32 at a time.  ``quant="fp8"`` computes the same
model with every projection's operands rounded to float8 e4m3 (weights per
output column, activations per row): the control that a comparison must
fail.  ``quant="bf16"`` rounds every projection's operands, the router's
input and the residual stream to bfloat16, the precision the cells serve
in: a plain witness of what that precision alone does to a gap.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

#: Block choices this reference implements, by the configuration's
#: ``harness`` keys.
NORMS = ("rmsnorm",)
ROUTERS = ("softmax_topk_renorm",)
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and convolutions inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax over ``dim`` maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Mm:
    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8", "bf16"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def __call__(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (T, k) @ w (k, n), both float32."""
        if self.quant == "fp8":
            a, w = fp8_round(a, -1), fp8_round(w, 0)
        elif self.quant == "bf16":
            a, w = self.round(a), self.round(w)
        return a @ w

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to bfloat16 under ``quant="bf16"``, else as is."""
        return x.bfloat16().float() if self.quant == "bf16" else x


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), pos (S,): rotate-half with inverse frequencies
    ``theta ** (-2i / D)``."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = (pos.to(torch.float64)[:, None] * inv).to(torch.float32)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, groups: int) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, D), k/v (S, Hkv, D)."""
    S, H, D = q.shape
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) * D ** -0.5
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def check_block(conf: Dict[str, Any]) -> None:
    h = conf["harness"]
    if h.get("norm") not in NORMS:
        raise ValueError(f"reference: norm {h.get('norm')!r} not in {NORMS}")
    if conf.get("num_local_experts") and h.get("router") not in ROUTERS:
        raise ValueError(f"reference: router {h.get('router')!r} not in "
                         f"{ROUTERS}")


def logits_at(conf: Dict[str, Any], w: Dict[str, torch.Tensor],
              seqs: Sequence[Sequence[int]],
              wanted: Sequence[Sequence[int]], *,
              quant: Optional[str] = None,
              routes: Optional[list] = None) -> List[torch.Tensor]:
    """Float32 logits over the real vocabulary at positions ``wanted[i]``
    of sequence ``seqs[i]``, each (len(wanted[i]), vocab_size), computed
    on the weights' device.  ``routes`` (a list), for a moe model,
    receives per sequence the experts each layer chose at each wanted
    position, (positions, layers, k), ascending."""
    check_block(conf)
    with exact_fp32(), torch.no_grad():
        return _logits_at(conf, w, seqs, wanted, _Mm(quant), routes)


def _logits_at(conf, w, seqs, wanted, mm, routes=None) -> List[torch.Tensor]:
    dev = w["embed"].device
    d, L = int(conf["hidden_size"]), int(conf["num_hidden_layers"])
    H, Hkv = int(conf["num_attention_heads"]), int(conf["num_key_value_heads"])
    D = int(conf.get("head_dim") or d // H)
    V, eps = int(conf["vocab_size"]), float(conf["rms_norm_eps"])
    theta = float(conf["rope_theta"])
    E = int(conf.get("num_local_experts", 0))
    K = int(conf.get("num_experts_per_tok", 0))
    lens = [len(s) for s in seqs]
    starts = [sum(lens[:i]) for i in range(len(lens))]
    tokens = torch.tensor([t for s in seqs for t in s], dtype=torch.int64,
                          device=dev)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    x = w["embed"][tokens].float()                       # (T, d)
    T = x.shape[0]
    chosen = []
    for li in range(L):
        h = _rmsnorm(x, w["ln1"][li].float(), eps)
        proj = {}
        for name, heads in (("q", H), ("k", Hkv), ("v", Hkv)):
            wm = w["w" + name][li][:, :heads].float().reshape(d, heads * D)
            y = mm(h, wm).reshape(T, heads, D)
            if "b" + name in w:
                y = y + w["b" + name][li][:heads].float()
            proj[name] = y
        q = _rope(proj["q"], pos, theta)
        k = _rope(proj["k"], pos, theta)
        a = torch.empty((T, H, D), dtype=torch.float32, device=dev)
        for s0, n in zip(starts, lens):
            a[s0:s0 + n] = _attention(q[s0:s0 + n], k[s0:s0 + n],
                                      proj["v"][s0:s0 + n], H // Hkv)
        wo = w["wo"][li][:H].float().reshape(H * D, d)
        x = mm.round(x + mm(a.reshape(T, H * D), wo))
        h = _rmsnorm(x, w["ln2"][li].float(), eps)
        x = mm.round(x + (_moe(h, w, li, E, K, mm, chosen) if E else
                          _swiglu(h, w["wi_gate"][li], w["wi_up"][li],
                                  w["w_down"][li], mm)))
        del h, proj, q, k, a
    rows = torch.tensor([starts[i] + p for i, ps in enumerate(wanted)
                         for p in ps], dtype=torch.int64, device=dev)
    if routes is not None and E:
        routes.extend(torch.split(torch.stack([c[rows] for c in chosen], 1),
                                  [len(p) for p in wanted]))
    hf = _rmsnorm(x[rows], w["ln_f"].float(), eps)
    head = w["lm_head"] if "lm_head" in w else w["embed"].T
    logits = mm(hf, head[:, :V].float())
    return list(torch.split(logits, [len(p) for p in wanted]))


def _swiglu(h, wg, wu, wd, mm):
    return mm(F.silu(mm(h, wg.float())) * mm(h, wu.float()), wd.float())


def _moe(h, w, li, E, K, mm, chosen):
    probs = torch.softmax(mm.round(h) @ w["router"][li].float(), dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)
    chosen.append(topi.sort(-1).values)
    topv = topv / topv.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(E):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        out = _swiglu(h[rows], w["wi_gate"][li, e], w["wi_up"][li, e],
                      w["w_down"][li, e], mm)
        y.index_add_(0, rows, out * topv[rows, slot][:, None])
    return y
