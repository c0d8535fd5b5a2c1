"""Operations and bytes of the kernels and steps the benchmark reads, from
shapes and the window's lengths alone.  The benchmark's own copy of the
program's ``launch/opcost.py::kernel_cost`` (paged decode) and
``chip_smoke.py``'s model-FLOP arithmetic, which may change with the
program.

Each count is what the inputs need, whatever a kernel reads again: a
decode over a paged cache reads each live token's K and V once (not the
cache's capacity, as ``kernel_cost`` counts it), its query and writes its
output once.
"""
from __future__ import annotations

from typing import Iterable


def paged_decode_bytes(contexts: Iterable[int], heads: int, kv_heads: int,
                       head_dim: int, elem: int, page_table_row: int = 0
                       ) -> float:
    """Bytes one paged decode call must move: for each active row of
    context ``c`` (the keys it attends, its own token included), K and V
    of ``c`` tokens over ``kv_heads`` heads, its query and its output over
    ``heads``, and its page-table row (``page_table_row`` bytes)."""
    total = 0.0
    for c in contexts:
        total += (2 * c * kv_heads + 2 * heads) * head_dim * elem
        total += page_table_row
    return total


def paged_decode_flops(contexts: Iterable[int], heads: int,
                       head_dim: int) -> float:
    """Multiply-adds of scores and of the weighted sum, 2 FLOPs each: 4
    FLOPs a (head, key, dim)."""
    return 4.0 * heads * head_dim * float(sum(contexts))


def serve_flops(matmul_params: int, tokens: int, context_sum: int,
                layers: int, heads: int, head_dim: int) -> float:
    """Useful FLOPs of decoding ``tokens`` tokens whose contexts sum to
    ``context_sum``: 2 a matmul weight a token, and attention's 4 a (layer,
    head, key, dim)."""
    return (2.0 * matmul_params * tokens
            + 4.0 * layers * heads * head_dim * context_sum)

