"""The port's evaluation (``repro_torch/evaluation``) against the JAX
package's (``benchmarks/``) on the CPU: every region of Figs. 8-10, its
three columns on the same numpy inputs through both packages, and Fig.
6's pointers and Fig. 7's drained records and replies.

The JAX side runs the benchmark modules' own functions through
``repro.core.expand``; where JAX's body is a closure inside ``run()``, the
test restates it verbatim and names its file and lines.  Tolerances (fp32,
relative unless said): 2e-5 for elementwise bodies, 1e-4 for chained,
stencil and inverse bodies, integers bit for bit.  The bodies' sums
cancel (a lookup's nuclides, a record's fields), so a value is also
within the tolerance times the column's largest value; hypterm's plane
sums cancel to ~1e-5 and get an absolute tolerance of 1e-4 times the sum
of the plane's absolute terms instead.

botsspar's serial and gpu_first columns cancel catastrophically (every
block carries ``32 I``, so the first Schur complement is noise and later
pivots near singular): two fp32 implementations part by ~1% at JAX's 8 x
8 blocks (caveat D).  They are held in fp32 at 4 x 4 blocks and in float64
(``jax.enable_x64``) at 8 x 8.

The history regions' chains amplify a rounding difference up to 777x a
step (``d e_next / d e = 0.999 * 777 * cos``), so two correct
implementations part after two steps; their columns are held at depth 1,
and ``test_reference_caveats_pinned`` pins the divergence at depth 16 in
JAX's own columns (caveat C), beside caveats A and B.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import allocator_bench as jab  # noqa: E402
from benchmarks import hypterm_bench as jhy  # noqa: E402
from benchmarks import interleaved_bench as jil  # noqa: E402
from benchmarks import rsbench_bench as jrs  # noqa: E402
from benchmarks import spec_bench as jsp  # noqa: E402
from benchmarks import xsbench_bench as jxs  # noqa: E402
from repro.core import allocator as jalloc  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.core.expand import parallel_for as jpf  # noqa: E402
from repro.core.expand import serial_for as jsf  # noqa: E402
from repro_torch.evaluation import allocator as tab  # noqa: E402
from repro_torch.evaluation import amgmk_pagerank as tap  # noqa: E402
from repro_torch.evaluation import hypterm as thy  # noqa: E402
from repro_torch.evaluation import interleaved as til  # noqa: E402
from repro_torch.evaluation import rpc as trpc_eval  # noqa: E402
from repro_torch.evaluation import rsbench as trs  # noqa: E402
from repro_torch.evaluation import spec as tsp  # noqa: E402
from repro_torch.evaluation import xsbench as txs  # noqa: E402
from repro_torch.evaluation.common import aten_ops, region  # noqa: E402
from repro_torch.evaluation.run import main as run_main  # noqa: E402

ELEMENTWISE, CHAINED = 2e-5, 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jcols(body, n, arrays, manual):
    """JAX's serial and gpu_first columns of ``body`` over ``arrays`` and
    its manual column, as numpy."""
    js = [jnp.asarray(a) for a in arrays]
    ser = jax.jit(lambda *a: jsf(body, n, *a))(*js)
    par = jax.jit(lambda *a: jpf(body, n, *a))(*js)
    return np.asarray(ser), np.asarray(par), np.asarray(jax.jit(manual)(*js))


def _allclose(got, want, rtol):
    """Within ``rtol`` of each value or of the largest (sums cancel)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _close(region_, jser, jpar, jman, rtol, m=None):
    m = region_.n if m is None else m
    _allclose(region_.serial(m).numpy(), jser[:m], rtol)
    _allclose(region_.gpu_first().numpy(), jpar, rtol)
    _allclose(region_.manual().numpy(), jman, rtol)


def _xs_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    egrid = np.sort(rng.random(jxs.N_GRID).astype(np.float32))
    xs = rng.random((jxs.N_NUCLIDES, jxs.N_GRID, jxs.XS)).astype(np.float32)
    conc = rng.random(jxs.N_NUCLIDES).astype(np.float32)
    e = (rng.random(n) * 0.998 + 1e-3).astype(np.float32)
    return e, egrid, xs, conc


def _rs_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    shape = (jrs.N_NUCLIDES, jrs.N_WINDOWS, jrs.POLES_PER_WINDOW, 2)
    poles = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
    fit = rng.standard_normal((jrs.N_NUCLIDES, jrs.N_WINDOWS,
                               jrs.FIT_ORDER)).astype(np.float32)
    conc = rng.random(jrs.N_NUCLIDES).astype(np.float32)
    e = (rng.random(n) * 0.998 + 1e-3).astype(np.float32)
    return e, poles, fit, conc


# ---------------------------------------------------------------------------
# Fig. 8: XSBench and RSBench
# ---------------------------------------------------------------------------

def test_xsbench_event_matches_jax():
    e, egrid, xs, conc = _xs_data(512)
    data = [jnp.asarray(a) for a in (egrid, xs, conc)]
    body = lambda i, e: jxs.lookup_one(e[i], *data)[0]  # noqa: E731
    cols = _jcols(body, 512, [e], lambda e: jax.vmap(
        lambda ee: jxs.lookup_one(ee, *data)[0])(e))
    reg = txs.event_region(*_t(e, egrid, xs, conc))
    _close(reg, *cols, ELEMENTWISE)


def test_xsbench_history_one_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jxs, "N_HISTORY", 1)
    s, egrid, xs, conc = _xs_data(64, seed=1)
    data = [jnp.asarray(a) for a in (egrid, xs, conc)]
    body = lambda i, s: jxs.history_chain(s[i], *data)  # noqa: E731
    cols = _jcols(body, 64, [s], lambda s: jax.vmap(
        lambda ss: jxs.history_chain(ss, *data))(s))
    reg = txs.history_region(*_t(s, egrid, xs, conc), n_history=1)
    _close(reg, *cols, CHAINED)


def test_xsbench_history_step_map_matches_jax():
    """The update every history step applies, next energy from a lookup,
    on 512 energies (elementwise tolerance), and the host-driven
    contrast's step."""
    e, egrid, xs, conc = _xs_data(512, seed=2)
    data = [jnp.asarray(a) for a in (egrid, xs, conc)]

    def jstep(ee):
        macro = jxs.lookup_one(ee, *data)
        return jnp.abs(jnp.sin(ee * 1000.0 + macro[0])) * 0.999 + 5e-4

    want = np.asarray(jax.jit(jax.vmap(jstep))(jnp.asarray(e)))
    got = txs.history_step(0, *_t(e, egrid, xs, conc))
    _allclose(got.numpy(), want, CHAINED)


def test_rsbench_event_matches_jax():
    e, poles, fit, conc = _rs_data(512)
    data = [jnp.asarray(a) for a in (poles, fit, conc)]
    body = lambda i, e: jrs.lookup_one(e[i], *data)  # noqa: E731
    cols = _jcols(body, 512, [e], lambda e: jax.vmap(
        lambda ee: jrs.lookup_one(ee, *data))(e))
    reg = trs.event_region(*_t(e, poles, fit, conc))
    _close(reg, *cols, ELEMENTWISE)


def test_rsbench_history_one_step_matches_jax(monkeypatch):
    monkeypatch.setattr(jrs, "N_HISTORY", 1)
    s, poles, fit, conc = _rs_data(64, seed=1)
    data = [jnp.asarray(a) for a in (poles, fit, conc)]
    body = lambda i, s: jrs.history_chain(s[i], *data)  # noqa: E731
    cols = _jcols(body, 64, [s], lambda s: jax.vmap(
        lambda ss: jrs.history_chain(ss, *data))(s))
    reg = trs.history_region(*_t(s, poles, fit, conc), n_history=1)
    _close(reg, *cols, CHAINED)


@pytest.mark.parametrize("suite", ["xsbench", "rsbench"])
def test_history_update_matches_jax(monkeypatch, suite):
    """The energy update between a history's lookups
    (``xsbench_bench.py:51-58``, ``rsbench_bench.py:48-54``): two-step
    chains, whose second lookup reads the updated energy, in float64
    (``jax.enable_x64``), where the first step's rounding difference,
    grown by the update's slope (up to 1000x or 777x) and the lookup's,
    stays far below rtol 1e-9."""
    jmod, tmod, data_fn = {"xsbench": (jxs, txs, _xs_data),
                           "rsbench": (jrs, trs, _rs_data)}[suite]
    monkeypatch.setattr(jmod, "N_HISTORY", 2)
    s, *data = (a.astype(np.complex128 if np.iscomplexobj(a)
                         else np.float64) for a in data_fn(64, seed=3))
    with jax.enable_x64(True):
        jdata = [jnp.asarray(a) for a in data]
        want = np.asarray(jax.jit(jax.vmap(
            lambda ss: jmod.history_chain(ss, *jdata)))(jnp.asarray(s)))
    assert want.dtype == np.float64
    reg = tmod.history_region(*_t(s, *data), n_history=2)
    for got in (reg.serial(64), reg.gpu_first(), reg.manual()):
        assert got.dtype == torch.float64
        _allclose(got.numpy(), want, 1e-9)


def test_gate_regions():
    """The card's gates hold the histories at depth 1 and botsspar in
    float64, on the same data; every other region is its own gate."""
    for build in (txs.regions, trs.regions):
        event, history = build("cpu", n_lookups=8, n_particles=4)
        assert event.gate_region() is event
        gate = history.gate_region()
        assert history.gate_note == "depth 1"
        e = history.manual()      # depth 16
        one = gate.manual()
        assert one.shape == e.shape and not torch.equal(one, e)
        assert gate.gate_region() is gate
    algn, spar = tsp.regions("cpu", n_pairs=2, seq_len=8, nb=2, bs=4)
    assert algn.gate_region() is algn
    gate = spar.gate_region()
    assert spar.gate_note == "float64"
    assert gate.manual().dtype == torch.float64
    np.testing.assert_allclose(float(gate.manual()[0]),
                               float(spar.manual()[0]), rtol=1e-5)


# ---------------------------------------------------------------------------
# Fig. 9: interleaved, hypterm, AMGmk and page rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_interleaved_matches_jax(layout):
    n = 2048
    aos = np.random.default_rng(3).standard_normal(
        (n, jil.FIELDS)).astype(np.float32)
    if layout == "aos":
        body = lambda i, a: jil.compute_fields(a[i])  # noqa: E731
        cols = _jcols(body, n, [aos], jax.vmap(jil.compute_fields))
        reg = til.aos_region(*_t(aos))
    else:
        soa = aos.T.copy()
        body = lambda i, a: jil.compute_fields(a[:, i])  # noqa: E731
        cols = _jcols(body, n, [soa], jil.compute_fields)
        reg = til.soa_region(*_t(soa))
    _close(reg, *cols, ELEMENTWISE)


def _jax_plane_body(i, qq, axis):
    """``benchmarks/hypterm_bench.py:47-51``, verbatim."""
    return jhy.flux_region(
        jax.lax.dynamic_slice_in_dim(
            jnp.roll(qq, 4, 0), i, 9, 0), axis)[4].sum()


def _hypterm_q(seed=4, n=jhy.NX):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n, n, jhy.VARS)) + 1.0).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_hypterm_matches_jax(axis):
    q = _hypterm_q()
    body = lambda i, qq: _jax_plane_body(i, qq, axis)  # noqa: E731
    jser, jpar, jman = _jcols(body, jhy.NX, [q],
                              lambda qq: jhy.flux_region(qq, axis).sum())
    reg = thy.flux_regions(*_t(q))[axis]
    assert reg.name == f"fig9b/hypterm_pr{axis + 1}" and not reg.manual_agrees
    atol = CHAINED * reg.magnitude(reg.n).numpy()
    for got, want in ((reg.serial(reg.n), jser), (reg.gpu_first(), jpar)):
        assert np.all(np.abs(got.numpy() - want) <= atol), (got, want, atol)
    man_atol = CHAINED * float(reg.manual_magnitude())
    assert abs(float(reg.manual()) - float(jman)) <= man_atol


def test_amgmk_relax_matches_jax():
    """JAX's closures ``benchmarks/amgmk_pagerank_bench.py:27-39``."""
    rng = np.random.default_rng(5)
    n = 20
    u, f = (rng.random((n, n, n)).astype(np.float32) for _ in range(2))

    def relax_manual(u, f):
        nb = (jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0) +
              jnp.roll(u, 1, 1) + jnp.roll(u, -1, 1) +
              jnp.roll(u, 1, 2) + jnp.roll(u, -1, 2))
        return (f + nb) / 6.0

    def relax_row(i, u, f):
        up = jnp.roll(u, 1, 0)[i]
        dn = jnp.roll(u, -1, 0)[i]
        nb = (up + dn + jnp.roll(u[i], 1, 0) + jnp.roll(u[i], -1, 0) +
              jnp.roll(u[i], 1, 1) + jnp.roll(u[i], -1, 1))
        return (f[i] + nb) / 6.0

    cols = _jcols(relax_row, n, [u, f], relax_manual)
    _close(tap.relax_region(*_t(u, f)), *cols, CHAINED)


def test_pagerank_matches_jax():
    """JAX's closures ``benchmarks/amgmk_pagerank_bench.py:55-61``."""
    N, DEG = 1 << 10, 8
    rng = np.random.default_rng(0)
    src_np = rng.integers(0, N, (N, DEG)).astype(np.int32)
    deg_np = rng.integers(1, DEG + 1, (N,)).astype(np.float32)
    rank_np = np.full((N,), 1.0 / N, np.float32)
    src, out_deg = jnp.asarray(src_np), jnp.asarray(deg_np)

    def pr_node(i, rank):
        return 0.15 / N + 0.85 * jnp.sum(
            rank[src[i]] / out_deg[src[i]])

    def pr_manual(rank):
        return 0.15 / N + 0.85 * jnp.sum(
            rank[src] / out_deg[src], axis=1)

    cols = _jcols(pr_node, N, [rank_np], pr_manual)
    reg = tap.pagerank_region(*_t(rank_np, src_np, deg_np))
    _close(reg, *cols, ELEMENTWISE)


def test_fig9c_regions_build_from_a_seed():
    relax, pr = tap.regions("cpu", n3=6, n_nodes=64)
    assert (relax.n, pr.n) == (6, 64)
    _allclose(relax.gpu_first().numpy(), relax.manual().numpy(), CHAINED)
    _allclose(pr.serial(64).numpy(), pr.manual().numpy(), ELEMENTWISE)


# ---------------------------------------------------------------------------
# Fig. 10: botsalgn, smithwa and botsspar
# ---------------------------------------------------------------------------

def _seqs(n, L, seed):
    return np.random.default_rng(seed).integers(0, 4, (n, L)).astype(
        np.int32)


def test_botsalgn_matches_jax():
    a, b = _seqs(16, jsp.SEQ_LEN, 6), _seqs(16, jsp.SEQ_LEN, 7)
    body = lambda i, a, b: jsp._sw_score(a[i], b[i])  # noqa: E731
    cols = _jcols(body, 16, [a, b], jax.vmap(jsp._sw_score))
    reg = tsp.botsalgn_region(*_t(a, b))
    for got, want in ((reg.serial(16), cols[0]), (reg.gpu_first(), cols[1]),
                      (reg.manual(), cols[2])):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("La,Lb", [(32, 32), (64, 64), (128, 128), (5, 9)])
def test_smithwa_matches_jax(La, Lb):
    a, b = _seqs(1, La, 8)[0], _seqs(1, Lb, 9)[0]
    want = int(jax.jit(jsp._sw_score)(jnp.asarray(a), jnp.asarray(b)))
    assert int(tsp.sw_score(*_t(a, b))) == want


def _jax_lu(NB):
    """JAX's ``lu_step``, ``lu_manual``, ``lu_serial`` and ``lu_gpu_first``,
    ``benchmarks/spec_bench.py:76-117`` verbatim (NB from the caller)."""
    def lu_step(A, k):
        piv = A[k, k]
        inv = jnp.linalg.inv(piv)
        row = jnp.einsum("jab,bc->jac", A[k], inv)
        col = jnp.einsum("iab,bc->iac", A[:, k], inv)
        upd = jnp.einsum("iab,jbc->ijac", col, row)
        mask = (jnp.arange(NB)[:, None] > k) & (jnp.arange(NB)[None, :] > k)
        A = A - upd * mask[:, :, None, None]
        return A

    def lu_manual(A):
        for k in range(NB):
            A = lu_step(A, k)
        return jnp.sum(jnp.abs(A))

    def lu_loop(loop):
        def lu(A):
            BS = A.shape[-1]
            for k in range(NB):
                piv_inv = jnp.linalg.inv(A[k, k])

                def blk(i, A=A, k=k, piv_inv=piv_inv):
                    r, c = i // NB, i % NB
                    upd = A[r, k] @ piv_inv @ A[k, c]
                    take = (r > k) & (c > k)
                    return jnp.where(take, A[r, c] - upd, A[r, c])

                blocks = loop(blk, NB * NB)
                A = blocks.reshape(NB, NB, BS, BS)
            return jnp.sum(jnp.abs(A))
        return lu

    return lu_manual, lu_loop(jsf), lu_loop(jpf)


def _botsspar_A(NB, BS, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NB, NB, BS, BS))
            + np.eye(BS) * NB * 4).astype(np.float32)


@pytest.mark.parametrize("NB,BS,dtype,rtol", [
    (4, 8, np.float32, CHAINED), (tsp.NB, tsp.BS, np.float64, 1e-9)])
def test_botsspar_matches_jax(NB, BS, dtype, rtol):
    A = _botsspar_A(NB, BS, 10).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        jman, jser, jgf = (float(jax.jit(f)(jnp.asarray(A)))
                           for f in _jax_lu(NB))
    reg = tsp.botsspar_region(*_t(A))
    assert reg.n == reg.n_serial == 1 and not reg.manual_agrees
    np.testing.assert_allclose(float(reg.serial(1)[0]), jser, rtol=rtol)
    np.testing.assert_allclose(float(reg.gpu_first()[0]), jgf, rtol=rtol)
    np.testing.assert_allclose(float(reg.manual()[0]), jman, rtol=rtol)


def test_reference_caveats_pinned():
    """The JAX programs' columns that compute other functions, kept as
    they are in both packages.  A: hypterm's clamped slab (planes 16-23
    all read the slab at 15; serial sums to ~757.86 on the JAX module's
    data, manual to ~-1.8e-4).  B: botsspar's manual column is another
    factorisation (42846.3 against ~680784 on the module's data).  C:
    rsbench's history chain at depth 16 is chaotic, so JAX's own serial
    and gpu_first columns part.  D: botsspar's serial column in fp32 is
    ~0.4% off its float64 value in JAX's own package."""
    q = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (jhy.NX, jhy.NY, jhy.NZ, jhy.VARS)) + 1.0)
    reg = thy.flux_regions(*_t(q))[0]
    planes = reg.serial(reg.n)
    assert torch.equal(planes[16:], planes[15].expand(8))
    np.testing.assert_allclose(float(planes.sum()), 757.86, rtol=1e-4)
    assert abs(float(reg.manual())) < 1e-3

    A = np.asarray(jax.random.normal(
        jax.random.PRNGKey(2), (tsp.NB, tsp.NB, tsp.BS, tsp.BS))
        + jnp.eye(tsp.BS) * tsp.NB * 4)
    bs = tsp.botsspar_region(*_t(A))
    np.testing.assert_allclose(float(bs.manual()[0]), 42846.3, rtol=1e-4)
    assert float(bs.serial(1)[0]) == float(bs.gpu_first()[0])
    assert float(bs.serial(1)[0]) > 10 * float(bs.manual()[0])
    jman, jser, _ = (float(jax.jit(f)(jnp.asarray(A)))
                     for f in _jax_lu(tsp.NB))
    np.testing.assert_allclose(jman, 42846.3, rtol=1e-4)
    np.testing.assert_allclose(jser, 680784.1, rtol=1e-4)
    A64 = _botsspar_A(tsp.NB, tsp.BS, 10)
    with jax.enable_x64(True):
        j64 = float(jax.jit(_jax_lu(tsp.NB)[1])(jnp.asarray(
            A64.astype(np.float64))))
    j32 = float(jax.jit(_jax_lu(tsp.NB)[1])(jnp.asarray(A64)))
    assert abs(j32 - j64) / j64 > 1e-3

    s, poles, fit, conc = _rs_data(64, seed=1)
    data = [jnp.asarray(x) for x in (poles, fit, conc)]
    body = lambda i, s: jrs.history_chain(s[i], *data)  # noqa: E731
    jser, jpar, _ = _jcols(body, 64, [s], lambda s: s)
    assert jrs.N_HISTORY == 16
    assert np.max(np.abs(jser - jpar) / np.abs(jpar)) > 1e-3


# ---------------------------------------------------------------------------
# Fig. 6: the allocators' pointers and find_obj
# ---------------------------------------------------------------------------

def _jax_grid(threads, teams):
    """JAX's four contestants, ``benchmarks/allocator_bench.py:62-101``,
    returning (ptrs, watermark)."""
    BA, GA, SC = (jalloc.BalancedAllocator, jalloc.GenericAllocator,
                  jalloc.SizeClassAllocator)
    n = threads * teams
    N_SLOTS, M_SLOTS = min(threads, 8), min(teams, 4)
    cap = max(n // 4, 8) * 4
    sg = jnp.full((threads, teams), 8, jnp.int32)
    sf = jnp.full((n,), 8, jnp.int32)

    def balanced_v2(sizes):
        st = BA.init(n * 64, N_SLOTS, M_SLOTS, cap=cap)
        st, ptrs = BA.malloc_grid(st, threads, teams, sizes)
        st = BA.free_grid(st, threads, teams, ptrs)
        return ptrs, st.watermark

    def balanced_v1(sizes):
        st = BA.init(n * 64, N_SLOTS, M_SLOTS, cap=cap)
        st, ptrs = BA.malloc_grid_scan(st, threads, teams, sizes)
        st = BA.free_grid_scan(st, threads, teams, ptrs)
        return ptrs, st.watermark

    def generic_serial(sizes):
        st = GA.init(n * 64, cap=4 * n)
        st, ptrs = GA.malloc_many_serial(st, sizes)
        st = GA.free_many_serial(st, ptrs)
        return ptrs, st.watermark

    def sizeclass_bulk(sizes):
        st = SC.init(n * 64, cap=4 * n)
        st, ptrs = SC.malloc_many(st, sizes)
        st = SC.free_many(st, ptrs)
        return ptrs, st.watermark

    return {"balanced_v2": (balanced_v2, sg), "balanced_v1": (balanced_v1, sg),
            "generic": (generic_serial, sf),
            "sizeclass_bulk": (sizeclass_bulk, sf)}


@pytest.mark.parametrize("grid", [(1, 1), (8, 4), (16, 8)])
def test_fig6_grid_pointers_match_jax(grid):
    jfns = _jax_grid(*grid)
    tfns = tab.grid_contestants(*grid, "cpu")
    assert sorted(jfns) == sorted(tfns)
    for name, (fn, sizes) in jfns.items():
        jp, jw = jax.jit(fn)(sizes)
        tp, tw = tfns[name]()
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp), name)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw), name)
    assert sorted(tab.grid_contestants(*grid, "cpu", serial=False)) == [
        "balanced_v2", "sizeclass_bulk"]


@pytest.mark.parametrize("cap", tab.FIND_OBJ_CAPS)
def test_fig6_find_obj_marshalling_matches_jax(cap):
    """The marshalled objects (JAX's ``_marshal_probe``), and the linear
    and the sorted lookup alone, on the same heap and probes."""
    GA = jalloc.GenericAllocator
    heap = 8 * cap
    jst, jptrs = GA.malloc_many(GA.init(heap, cap=cap),
                                jnp.full((cap - 1,), 8, jnp.int32))
    rng = np.random.default_rng(0)
    probes = (rng.choice(np.asarray(jptrs), 256)
              + rng.integers(0, 8, 256)).astype(np.int32)
    jbase, jsize, jfound = jab._marshal_probe()(
        jst, jnp.zeros((heap,), jnp.float32), jnp.asarray(probes))
    tst, tptrs = tab.GA.malloc_many(tab.GA.init(heap, cap=cap, device="cpu"),
                                    torch.full((cap - 1,), 8,
                                               dtype=torch.int32))
    np.testing.assert_array_equal(tptrs.numpy(), np.asarray(jptrs))
    want = np.stack([np.asarray(jbase), np.asarray(jsize),
                     np.asarray(jfound).astype(np.int32)], 1)
    tprobes = torch.from_numpy(probes)
    got = tab.marshal_probe(torch.zeros((heap,)), tst, tprobes)
    np.testing.assert_array_equal(got.numpy(), want)
    for lookup in (tab.find_obj, tab.find_obj_linear):
        np.testing.assert_array_equal(
            tab.lookup_probe(tst, tprobes, lookup).numpy(), want)


def test_fig6_sections_run_and_agree():
    """The find_obj and sharded sections on the CPU: the sharded heap's
    pointers are JAX's (``allocator_bench.py:162-178``), and the funneled
    and sharded queues deliver the same records in the same order."""
    rec, ev = tab.sharded_section("cpu", rounds=1, warmup=0, iters=1)
    BA, SA = jalloc.BalancedAllocator, jalloc.ShardedAllocator
    T, G, D = 32, 16, 4
    n = T * G
    cap = max(n // 4, 8) * 4
    sizes = jnp.full((T, G), 8, jnp.int32)
    st = jalloc.shard_heap(BA.init(n * 64 // D, 8, 4, cap=cap // D), D,
                           span=n * 64 // D)
    st, jptrs = SA.malloc_grid(st, T // D, G, sizes.reshape(D, T // D, G))
    st = SA.free_grid(st, T // D, G, jptrs)
    np.testing.assert_array_equal(ev["sharded"][0].numpy(), np.asarray(jptrs))
    np.testing.assert_array_equal(ev["sharded"][1].numpy(),
                                  np.asarray(st.shards.watermark))
    want = [(i, 0.5) for i in range(D * 64)]
    assert ev["queue_records"] == {"funneled": want, "sharded": want}
    assert rec["heap_target"] == 0.9
    frec, fev = tab.find_obj_section("cpu", caps=[256], warmup=0, iters=1)
    assert fev["cap256"]["rpc"] == 0
    assert frec["cap256"]["linear_us_per_lookup"] > 0


# ---------------------------------------------------------------------------
# Fig. 7: records and replies
# ---------------------------------------------------------------------------

def _jax_fig7_evidence():
    """JAX's Fig. 7 programs (``benchmarks/rpc_bench.py:136-163,183-209,
    240-254,292-317``) at their sizes, with recording callees: what the
    host received."""
    from jax import lax
    from repro.core.libc import LogRing, drain_log_lines
    N_CALLS, N_QUEUED = 200, 64
    sink = []

    @jrpc.host_rpc(name="test_eval.fprintf_like",
                   result_shape=jax.ShapeDtypeStruct((), jnp.int32))
    def fprintf_like(tag, buf):
        sink.append((int(tag), float(buf[0])))
        buf[:] = buf + 1.0
        return np.int32(128)

    def rpc_loop(x):
        def body(i, buf):
            _, (buf,) = fprintf_like.rpc(i, jrpc.Ref(buf))
            return buf
        return lax.fori_loop(0, N_CALLS, body, x)

    def buffered_loop(x):
        ring = LogRing.create(N_CALLS)

        def body(i, carry):
            buf, ring = carry
            buf = buf + 1.0
            return buf, ring.log(i, buf[0])

        buf, ring = lax.fori_loop(0, N_CALLS, body, (x, ring))
        ring.flush()
        return buf

    x = jnp.zeros((32,), jnp.float32)
    out = {"buf": np.asarray(jax.jit(rpc_loop)(x))}
    jax.effects_barrier()
    out["sink"] = list(sink)
    drain_log_lines()
    out["buffered_buf"] = np.asarray(jax.jit(buffered_loop)(x))
    jax.effects_barrier()
    out["log"] = drain_log_lines()

    tally = []
    jrpc.REGISTRY.register("test_eval.record", lambda i, x: tally.append(
        (int(i), float(x))) or np.int32(0))

    def batched_loop(s):
        q = jrpc.RpcQueue.create(N_QUEUED, width=2)

        def body(i, carry):
            s, q = carry
            return s + 1.0, q.enqueue("test_eval.record", i, s)

        s, q = lax.fori_loop(0, N_QUEUED, body, (s, q))
        q.flush()
        return s

    jax.jit(batched_loop)(jnp.float32(0.0))
    jax.effects_barrier()
    out["batched"] = list(tally)

    got = []
    jrpc.REGISTRY.register("test_eval.payload", lambda i, arr: got.append(
        (int(i), len(arr), float(np.asarray(arr).sum()))) or np.int32(0))
    P = 64

    def payload_loop(s):
        q = jrpc.RpcQueue.create(N_QUEUED, width=2,
                                 payload_capacity=N_QUEUED * P)

        def body(i, carry):
            s, q = carry
            arr = s + jnp.arange(P, dtype=jnp.float32)
            return s + 1.0, q.enqueue("test_eval.payload", i, arr)

        s, q = lax.fori_loop(0, N_QUEUED, body, (s, q))
        q.flush()
        return s

    jax.jit(payload_loop)(jnp.float32(0.0))
    jax.effects_barrier()
    out["payload64"] = list(got)

    jrpc.REGISTRY.register("test_eval.reply", lambda i, p: np.arange(
        int(p), dtype=np.int32) + int(i))
    shape = jax.ShapeDtypeStruct((P,), jnp.int32)

    def reply_loop(s):
        q = jrpc.RpcQueue.create(N_QUEUED, width=2,
                                 reply_capacity=N_QUEUED * P)

        def body(i, q):
            q, _ = q.enqueue_ticketed("test_eval.reply", i, jnp.int32(P),
                                      returns=shape)
            return q

        q = lax.fori_loop(0, N_QUEUED, body, q).flush()
        return lax.fori_loop(0, N_QUEUED, lambda i, s: s + q.result(
            i, (P,), jnp.int32)[0], s)

    out["reply64"] = int(jax.jit(reply_loop)(jnp.int32(0)))
    jax.effects_barrier()
    return out


def test_fig7_records_and_replies_match_jax():
    want = _jax_fig7_evidence()
    dev = torch.device("cpu")
    _, ev = trpc_eval.roundtrip_section(dev, warmup=0, iters=1)
    assert ev["sink"] == want["sink"]
    assert ev["log"] == want["log"]
    np.testing.assert_array_equal(ev["buf"].numpy(), want["buf"])
    np.testing.assert_array_equal(ev["buffered_buf"].numpy(),
                                  want["buffered_buf"])
    _, ev = trpc_eval.batched_section(dev, warmup=0, iters=1)
    assert ev["percall"] == ev["batched"] == want["batched"]
    _, ev = trpc_eval.payload_section(dev, warmup=0, iters=1)
    assert ev["elems64/percall"] == ev["elems64/batched"] == \
        want["payload64"]
    _, ev = trpc_eval.reply_section(dev, rounds=1, warmup=0, iters=1)
    assert ev["elems64"] == (want["reply64"], want["reply64"])
    assert all(a == b == sum(range(64)) for a, b in ev.values())


def test_fig7_reply_section_calls_one_callee_at_every_size():
    """As benchmarks/rpc_bench.py: one callee, ``bench.reply``, answers
    1, 64 and 1024 elements through one landing pad (on a card a staging
    region a result shape, F6), and every sum is the reply's first
    elements'."""
    from repro_torch.core import rpc as trpc
    _, ev = trpc_eval.reply_section(torch.device("cpu"), rounds=1,
                                    warmup=0, iters=1)
    assert sorted(ev) == sorted(f"elems{P}" for P in trpc_eval.REPLY_ELEMS)
    assert all(a == b == sum(range(trpc_eval.N_QUEUED))
               for a, b in ev.values())
    assert [n for n in trpc.REGISTRY.hosts if n.startswith("bench.reply")] \
        == ["bench.reply"]
    assert trpc.rpc_stats("bench.reply")["pads"] == 1


def test_fig7_other_sections_deliver_every_record():
    dev = torch.device("cpu")
    _, ev = trpc_eval.sharded_section(dev, warmup=0, iters=1)
    want = [(i, 0.5) for i in range(4 * 64)]
    assert ev == {"funneled": want, "sharded": want}
    rec, ev = trpc_eval.fault_overhead_section(dev, rounds=1, warmup=0,
                                               iters=1)
    assert ev == {"fast": 2016, "guarded": 2016, "timeout": 2016}
    rec, ev = trpc_eval.async_section(dev, iters=2)
    assert ev == {"sync_callee_calls": 3 * 64, "async_callee_calls": 3 * 64}
    assert rec["overlap"] > 0


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

def test_region_scales_a_serial_prefix():
    rec = region("fig0/x", 2.0, 0.5, 0.25, n_serial=8, n=64)
    assert rec["serial_scaled"] and rec["serial_s"] == 16.0
    assert rec["speedup_vs_serial"] == 32.0
    assert rec["gpu_first_vs_manual"] == 2.0
    assert not region("fig0/y", 1.0, 1.0, 1.0, n_serial=4,
                      n=4)["serial_scaled"]


def test_aten_ops_counts_an_iteration():
    """The serial column's ops an iteration (views not counted): the 9
    arithmetic ops of ``compute_fields``, and under vmap the lane index
    and its gather besides."""
    aos, soa = til.regions("cpu", n=64)
    for reg in (aos, soa):
        one = aten_ops(lambda: reg.serial(1))
        assert aten_ops(lambda: reg.serial(2)) - one == 9
        assert aten_ops(reg.gpu_first) == 11


def test_run_cli_prints_jax_rows(capsys):
    assert run_main(["--device", "cpu", "--only", "fig9c"]) == 0
    rows = capsys.readouterr().out.splitlines()
    names = [r.split(",")[0] for r in rows if r.startswith("fig")]
    assert names == [f"fig9c/{reg}/{col}" for reg in ("amgmk_relax",
                                                      "pagerank")
                     for col in ("serial", "gpu_first", "manual")]


def test_run_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_main(["--only", "fig9c"])
