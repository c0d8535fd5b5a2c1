"""Paper Fig. 10: SPEC OMP 2012 analogues, 358.botsalgn, 359.botsspar and
372.smithwa (the JAX package's ``benchmarks/spec_bench.py``).

* botsalgn: pairwise sequence alignment tasks.  Under the GPU OpenMP
  runtime tasks run at once on the encountering thread, so parallelism is
  capped by the number of sequences; the rewrite (as in the paper) turns
  task spawning into a data-parallel loop over pairs.
* botsspar: blocked sparse LU, one thread producing tasks and the others
  consuming them, rewritten as a parallel loop over the independent
  blocks of each elimination step.  JAX's manual column (``lu_step``)
  multiplies ``(A[i,k] inv)(A[k,j] inv)``, its serial and gpu_first blocks
  ``A[r,k] inv A[k,c]``: two functions, kept so.  The pivot's inverse is
  ``torch.linalg.inv_ex``: ``linalg.inv`` checks for a singular input on
  the host, a read back a call, where JAX's ``inv`` never raises.
* smithwa: Smith-Waterman with producer-consumer wavefronts and barriers:
  the anti-diagonal dependence makes parallelism proportional to the
  diagonal's length, and the barriers' cost grows with the sequence
  length.  JAX's ``lax.scan`` over the diagonals is a Python loop here,
  about 15 launches a diagonal.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.expand import parallel_for, serial_for
from repro_torch.evaluation.common import Region

SEQ_LEN = 64
N_PAIRS = 64
MATCH, MISMATCH, GAP = 2, -1, -1
NB, BS = 8, 16          # botsspar: an 8 x 8 grid of 16 x 16 blocks
SMITHWA_LENGTHS = (32, 64, 128)

I32 = torch.int32


def sw_score(a, b):
    """Smith-Waterman local-alignment score of int sequences ``a`` and
    ``b`` by an anti-diagonal sweep (JAX's ``_sw_score``): a 0-d int32."""
    La, Lb = a.shape[0], b.shape[0]
    dev = a.device
    i = torch.arange(La + 1, device=dev)
    a_i = a.index_select(0, (i - 1).clamp(0, La - 1))
    up_at = (i - 1).clamp(0, La)
    i_ok = i >= 1
    match, mismatch, zero = (torch.full((), v, dtype=I32, device=dev)
                             for v in (MATCH, MISMATCH, 0))
    prev2 = prev1 = torch.zeros(La + 1, dtype=I32, device=dev)
    best = zero
    for d in range(2, La + Lb + 1):                # diagonals d-2, d-1
        j = d - i
        valid = i_ok & (j >= 1) & (j <= Lb)
        sub = torch.where(a_i == b.index_select(0, (j - 1).clamp(0, Lb - 1)),
                          match, mismatch)
        diag_val = prev2.index_select(0, up_at) + sub
        up_val = prev1.index_select(0, up_at) + GAP
        left_val = prev1 + GAP
        h = torch.maximum(torch.maximum(diag_val, up_val),
                          torch.clamp(left_val, min=0))
        h = torch.where(valid, h, zero)
        best = torch.maximum(best, h.max())
        prev2, prev1 = prev1, h
    return best


def botsalgn_region(seqs_a, seqs_b, n_serial: Optional[int] = None
                    ) -> Region:
    n = seqs_a.shape[0]

    def body(i, a, b):
        return sw_score(a[i], b[i])

    return Region(
        "fig10a/botsalgn", n,
        serial=lambda m: serial_for(body, m, seqs_a, seqs_b),
        gpu_first=lambda: parallel_for(body, n, seqs_a, seqs_b),
        manual=lambda: torch.vmap(sw_score)(seqs_a, seqs_b),
        n_serial=n if n_serial is None else n_serial, kind="integer")


def _inv(m):
    return torch.linalg.inv_ex(m).inverse


def lu_step(A, k: int):
    """One elimination step (JAX's manual column): factor the pivot,
    update the row, the column and the trailing blocks."""
    nb = A.shape[0]
    inv = _inv(A[k, k])
    row = torch.einsum("jab,bc->jac", A[k], inv)        # U row
    col = torch.einsum("iab,bc->iac", A[:, k], inv)     # L col
    upd = torch.einsum("iab,jbc->ijac", col, row)
    ar = torch.arange(nb, device=A.device)
    mask = (ar[:, None] > k) & (ar[None, :] > k)
    return A - upd * mask[:, :, None, None]


def lu_manual(A):
    for k in range(A.shape[0]):
        A = lu_step(A, k)
    return torch.sum(torch.abs(A))


def lu_block(i, A, k: int, piv_inv):
    """Block ``i`` (row-major over the NB x NB grid) after step ``k``:
    ``A[r,c] - A[r,k] inv A[k,c]`` in the trailing blocks, else as it
    was."""
    nb = A.shape[0]
    r, c = i // nb, i % nb
    upd = A[r, k] @ piv_inv @ A[k, c]
    take = (r > k) & (c > k)
    if isinstance(take, bool):                 # a Python int index
        return A[r, c] - upd if take else A[r, c]
    return torch.where(take, A[r, c] - upd, A[r, c])


def _lu_loop(A, loop):
    nb, bs = A.shape[0], A.shape[2]
    for k in range(nb):
        piv_inv = _inv(A[k, k])

        def blk(i, A=A, k=k, piv_inv=piv_inv):
            return lu_block(i, A, k, piv_inv)

        A = loop(blk, nb * nb, A.device).reshape(nb, nb, bs, bs)
    return torch.sum(torch.abs(A))


def lu_serial(A):
    """Single team: the trailing blocks updated one at a time."""
    return _lu_loop(A, lambda blk, n, dev: serial_for(blk, n))


def lu_gpu_first(A):
    return _lu_loop(A, lambda blk, n, dev: parallel_for(blk, n, device=dev))


def botsspar_region(A) -> Region:
    """The whole factorisation is one iteration of every column.  Gated
    in float64: the fp32 Schur complements cancel to ~1%."""
    return Region(
        "fig10b/botsspar", 1,
        serial=lambda m: lu_serial(A).reshape(1),
        gpu_first=lambda: lu_gpu_first(A).reshape(1),
        manual=lambda: lu_manual(A).reshape(1),
        n_serial=1, kind="inverse", manual_agrees=False,
        gate=None if A.dtype == torch.float64 else
        lambda: botsspar_region(A.double()),
        gate_note="float64")


def botsspar_matrix(nb: int = NB, bs: int = BS, *,
                    generator: torch.Generator, device):
    """(nb, nb, bs, bs) fp32 blocks ``randn + eye * nb * 4`` (the identity
    lands on every block, as JAX's broadcast puts it)."""
    A = torch.randn((nb, nb, bs, bs), generator=generator) \
        + torch.eye(bs) * nb * 4
    return A.to(device)


def sequences(n: int, length: int, *, generator: torch.Generator, device):
    """``n`` sequences of ``length`` bases in 0..3 (int32)."""
    return torch.randint(0, 4, (n, length), generator=generator,
                         dtype=I32).to(device)


def regions(device, *, seq_len: int = SEQ_LEN, n_pairs: int = N_PAIRS,
            nb: int = NB, bs: int = BS, serial_pairs: Optional[int] = None,
            seed: int = 0) -> List[Region]:
    gen = torch.Generator().manual_seed(seed)
    a = sequences(n_pairs, seq_len, generator=gen, device=device)
    b = sequences(n_pairs, seq_len, generator=gen, device=device)
    A = botsspar_matrix(nb, bs, device=device,
                        generator=torch.Generator().manual_seed(seed))
    return [botsalgn_region(a, b, serial_pairs), botsspar_region(A)]


def smithwa_pairs(lengths=SMITHWA_LENGTHS, *, device, seed: int = 3):
    """One pair of sequences of each length in ``lengths``."""
    gen = torch.Generator().manual_seed(seed)
    return {L: (sequences(1, L, generator=gen, device=device)[0],
                sequences(1, L, generator=gen, device=device)[0])
            for L in lengths}
