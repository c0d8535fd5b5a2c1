"""The port's analyzer (``repro_torch.analysis``) against the JAX package's.

(a) rules: the same recorded event dicts through both ``analyze_events``
give byte-equal ``to_json()``; (b) the capacity math on hypothesis-drawn
scope stacks; (c) the 34 ported corpus cases give JAX's codes and the
golden file's, sited on the port corpus's ``# BUG`` lines; (d) the fold's
boundary at ``capacity`` and ``capacity + 1`` enqueues; (e) the export-
graph walker; (f) the lint CLI's exit codes in subprocesses; (g) the
serving engine's spill ticks and a hooked ``device_run`` (chip_smoke.py's
``analysis`` programs) give the same codes in both packages; and the
event sites skip the analysis package but its corpus."""
import importlib
import importlib.util
import inspect
import json
import math
import os
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.analysis import capacity as jcap  # noqa: E402
from repro.analysis import corpus as jcorpus  # noqa: E402
from repro.analysis.rules import analyze_events as j_analyze  # noqa: E402
from repro.core import device_main as jdm  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import rpc as jrpc  # noqa: E402
from repro.core.expand import serial_for as j_serial_for  # noqa: E402
from repro_torch.analysis import (analyze, analyze_graph, capture,  # noqa: E402
                                  corpus, walk_graph)
from repro_torch.analysis import capacity as tcap  # noqa: E402
from repro_torch.analysis.capture import fold  # noqa: E402
from repro_torch.analysis.rules import analyze_events as t_analyze  # noqa: E402
from repro_torch.core import device_main as tdm  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.core.expand import serial_for  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "hazard_corpus.json")
with open(GOLDEN) as _f:
    GOLDEN_CODES = json.load(_f)["cases"]
PORTED = [c.name for c in corpus.CASES]
J_CASES = {c.name: c for c in jcorpus.CASES}
T_CASES = {c.name: c for c in corpus.CASES}


def _chip_smoke():
    """chip_smoke.py as a module (its ``analysis`` programs and codes)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()
#: JAX's capture module (``repro.analysis.capture`` is also a function's
#: name in its package).
jcapture = importlib.import_module("repro.analysis.capture")


def _jax_stream(fn):
    """JAX's events for ``fn()`` as its analyzer records them (its capture
    scopes the lax loops)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with jcapture.capture() as cap:
            fn()
        jax.effects_barrier()
    return cap.events


# ---------------------------------------------------------------------------
# (a) the rules: one stream, both packages, byte-equal reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(J_CASES))
def test_rules_match_jax_on_jax_corpus_streams(name):
    case = J_CASES[name]
    stream = [] if case.mode == "trace" else _jax_stream(case.fn)
    assert t_analyze(stream).to_json() == j_analyze(stream).to_json()
    if case.mode == "run":
        assert t_analyze(stream).codes == sorted(case.expect)


def test_rules_match_jax_on_the_events_program_stream():
    """tests/test_torch_events.py's program (heaps, a sanitized queue, a
    loop and a cond scope, an ArenaRef call), both packages' streams."""
    import test_torch_events as te
    jstream, tstream = [], []
    with jev.record(jstream):
        te._jax_program()
    with tev.record(tstream):
        te._port_program()
    for stream in (jstream, tstream):
        assert t_analyze(stream).to_json() == j_analyze(stream).to_json()
    assert t_analyze(tstream).codes == j_analyze(jstream).codes


@pytest.mark.parametrize("name", PORTED)
def test_rules_match_jax_on_port_corpus_streams(name):
    with capture() as cap:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            T_CASES[name].fn(device="cpu")
    for stream in (cap.events, cap.folded()):
        assert t_analyze(stream).to_json() == j_analyze(stream).to_json()


# ---------------------------------------------------------------------------
# (b) capacity math
# ---------------------------------------------------------------------------

_frames = st.tuples(st.sampled_from(["loop", "cond"]),
                    st.integers(0, 5),
                    st.one_of(st.none(), st.integers(0, 40)))


@settings(max_examples=300, deadline=None)
@given(st.lists(_frames, max_size=5), st.lists(_frames, max_size=5),
       st.integers(0, 5))
def test_multiplicity_matches_jax(event, anchor, shared):
    anchor = event[:shared] + anchor
    got = _or_error(tcap.multiplicity, event, anchor)
    want = _or_error(jcap.multiplicity, event, anchor)
    assert got == want or all(isinstance(v, float) and math.isnan(v)
                              for v in (got, want))
    assert tcap.common_prefix(event, anchor) == \
        jcap.common_prefix(event, anchor)
    if not isinstance(got, str):
        assert _or_error(tcap.fmt_count, got) == \
            _or_error(jcap.fmt_count, want)


def _or_error(fn, *args):
    """``fn(*args)``, or the ``ValueError`` it raises as its repr: NaN (an
    unbounded loop around a loop of 0 trips) makes ``fmt_count`` raise,
    and a ``cond`` inside such loops makes ``multiplicity`` raise, in both
    packages."""
    try:
        return fn(*args)
    except ValueError as exc:
        return repr(exc)


# ---------------------------------------------------------------------------
# (c) the corpus
# ---------------------------------------------------------------------------

def _bug_line(fn):
    """The line of ``fn``'s source whose comment says ``# BUG``."""
    lines, first = inspect.getsourcelines(fn)
    hits = [first + i for i, ln in enumerate(lines) if "# BUG" in ln]
    return hits[0] if hits else None, first, first + len(lines) - 1


@pytest.mark.parametrize("name", PORTED)
def test_corpus_case_matches_jax_and_golden(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jcorpus.run_case(J_CASES[name]).codes
    report = corpus.run_case(T_CASES[name], device="cpu")
    assert report.codes == want == GOLDEN_CODES[name], report.summary()
    assert report.codes == sorted(T_CASES[name].expect)
    bug, first, last = _bug_line(T_CASES[name].fn)
    corpus_file = corpus.__file__
    for h in report.hazards:
        path, _, line = h.site.rpartition(":")
        assert path == corpus_file and first <= int(line) <= last, h
    if report:
        assert bug is not None
        assert any(h.site == f"{corpus_file}:{bug}" for h in report.hazards)


def test_corpus_is_jax_but_the_mesh_case():
    assert set(PORTED) | set(corpus.NOT_PORTED) == set(J_CASES)
    assert len(PORTED) == 34 and corpus.NOT_PORTED == ()
    for name in PORTED:
        assert T_CASES[name].expect == J_CASES[name].expect
        assert T_CASES[name].mode == J_CASES[name].mode


# ---------------------------------------------------------------------------
# (d) the fold's boundary
# ---------------------------------------------------------------------------

def _jax_loop(calls, trips, capacity):
    def prog():
        q = jrpc.RpcQueue.create(capacity, 4, 64)
        for _ in range(calls):
            j_serial_for(lambda i: q.enqueue("corpus.note", i).head, trips)
        q.flush()
    return jcapture.analyze(prog, jaxpr=False).codes


def _port_loop(calls, trips, capacity):
    q = trpc.RpcQueue.create(capacity, 4, 64, device="cpu")
    xs = torch.arange(trips, dtype=torch.int32)
    with capture() as cap:
        for _ in range(calls):
            serial_for(lambda i: q.enqueue("corpus.note", xs[i]).head, trips)
        q.flush()
    return cap


@pytest.mark.parametrize("calls,trips,capacity", [
    (1, 4, 4), (1, 5, 4),
    # a scoped loop called from a bare Python loop: each call is its own
    # loop (JAX traces each), so the calls' records add up
    (2, 4, 8), (3, 4, 8)])
def test_fold_boundary_in_both_packages(calls, trips, capacity):
    want = ["CAPACITY_RECORDS"] if calls * trips > capacity else []
    assert _jax_loop(calls, trips, capacity) == want
    cap = _port_loop(calls, trips, capacity)
    assert cap.report().codes == want
    enqueues = [e for e in cap.events if e["kind"] == "rpc_enqueue"]
    assert len(enqueues) == calls * trips
    assert [e["kind"] for e in cap.folded()].count("rpc_enqueue") == calls
    # unfolded, each of the eager loop's enqueues counts trips times
    assert t_analyze(cap.events).codes == ["CAPACITY_RECORDS"]


def test_fold_keeps_unscoped_and_heap_events():
    ev = [{"kind": "rpc_enqueue", "site": "a:1", "scopes": (), "qid": i,
           "name": "f"} for i in range(3)]
    assert fold(ev) == ev
    heap = [{"kind": "heap_malloc", "site": "a:2",
             "scopes": (("loop", 0, 4),), "ptr": 8, "ptr_id": i}
            for i in range(3)]
    assert fold(heap) == heap
    loop = [dict(e, scopes=(("loop", 0, 3),), trips=(i,))
            for i, e in enumerate(ev)]
    assert fold(loop) == loop[:1]
    # repeats within one run stay: as often as in the run with the most
    runs = [dict(e, trips=(t,)) for e, t in zip(loop * 2, (0, 1, 1, 2, 2, 2))]
    assert fold(runs) == [runs[0], runs[2], runs[5]]


def _jax_inner(trips, inner, capacity):
    def prog():
        q = jrpc.RpcQueue.create(capacity, 4, 64)

        def body(i):
            for _ in range(inner):
                q.enqueue("corpus.note", i)
            return i
        j_serial_for(body, trips)
        q.flush()
    return jcapture.analyze(prog, jaxpr=False).codes


def _port_inner(trips, inner, capacity):
    q = trpc.RpcQueue.create(capacity, 4, 64, device="cpu")
    xs = torch.arange(trips, dtype=torch.int32)

    def body(i):
        for _ in range(inner):
            q.enqueue("corpus.note", xs[i])
        return xs[i]
    with capture() as cap:
        serial_for(body, trips)
        q.flush()
    return cap


@pytest.mark.parametrize("trips,inner,capacity", [
    (3, 2, 4), (3, 1, 4), (1, 3, 4), (2, 2, 4)])
def test_fold_counts_a_bare_inner_loop_in_both_packages(trips, inner,
                                                        capacity):
    """F7: the enqueues of a bare loop inside one trip of a scoped loop
    all count (JAX unrolls it in its one trace of the body)."""
    want = ["CAPACITY_RECORDS"] if trips * inner > capacity else []
    assert _jax_inner(trips, inner, capacity) == want
    cap = _port_inner(trips, inner, capacity)
    assert cap.report().codes == want
    enq = [e for e in cap.folded() if e["kind"] == "rpc_enqueue"]
    assert len(enq) == inner
    assert [e["trips"] for e in enq] == [(0,)] * inner


def test_fold_keeps_a_hook_that_first_fires_late():
    """A hook firing from the third trip on (``every=3``) keeps its event,
    once, beside JAX's one traced firing."""
    def hooks(HostHook):
        return [HostHook(every=3, extract=lambda s, st: st,
                         host_fn=lambda s, x: None, name="tan.late",
                         batched=True)]
    with jcapture.capture() as jc:
        jdm.device_run(lambda s, st: st + 1.0, jnp.zeros(3), 7,
                       hooks=hooks(jdm.HostHook))
        jax.effects_barrier()
    with capture() as tc:
        tdm.device_run(lambda s, st: st + 1.0, torch.zeros(3), 7,
                       hooks=hooks(tdm.HostHook))
    t_enq = [e for e in tc.folded() if e["kind"] == "rpc_enqueue"]
    j_enq = [e for e in jc.events if e["kind"] == "rpc_enqueue"]
    assert len(t_enq) == len(j_enq) == 1
    assert t_enq[0]["trips"] == (2,)
    assert sorted(map(_key, tc.folded())) == sorted(map(_key, jc.events))
    assert tc.report().codes == jc.report().codes


def test_device_run_hook_frames_are_one_a_hook():
    """Each hook's cond frame is one frame for the whole run (JAX's one
    trace), so its firings fold into one event."""
    hooks = [tdm.HostHook(every=1, extract=lambda s, st: st,
                          host_fn=lambda s, x: None, name=f"tan.h{i}",
                          batched=True) for i in range(2)]
    with capture() as cap:
        tdm.device_run(lambda s, st: st + 1, torch.zeros(3), 6, hooks=hooks)
    enq = [e for e in cap.events if e["kind"] == "rpc_enqueue"]
    assert len(enq) == 12
    conds = {e["name"]: e["scopes"][-1] for e in enq}
    assert len(set(conds.values())) == 2
    assert all(e["scopes"][-1] == conds[e["name"]] for e in enq)
    assert len([e for e in cap.folded() if e["kind"] == "rpc_enqueue"]) == 2


# ---------------------------------------------------------------------------
# (e) the export-graph walker
# ---------------------------------------------------------------------------

def _post_node(x):
    """A raw rpc_post op on ``x`` (never run: export traces its fake)."""
    out = torch.empty((), dtype=torch.int32)
    torch.ops.repro_torch.rpc_post(x, 1, [x], [0], [], [out], [1])
    return out


class _M(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _walk(fn, x):
    ep = torch.export.export(_M(fn), (x,), strict=False)
    counts = {}
    return walk_graph(ep.graph_module, counts=counts), counts


def test_walker_flags_op_in_a_loop_subgraph():
    from torch._higher_order_ops.scan import scan

    def prog(x):
        def body(c, xi):
            return c + _post_node(xi), xi.clone()
        return scan(body, torch.zeros((), dtype=torch.int32), x)[0]

    report, counts = _walk(prog, torch.arange(4, dtype=torch.int32))
    assert report.codes == ["CALLBACK_IN_LOOP"]
    assert counts == {"rpc_post": 1}


def test_walker_flags_op_in_a_while_loop_body():
    from torch._higher_order_ops.while_loop import while_loop

    def prog(x):
        def cond(i, c):
            return i < 3

        def body(i, c):
            return i + 1, c + _post_node(c)
        return while_loop(cond, body, (torch.zeros((), dtype=torch.int64),
                                       x.sum()))[1]

    report, _ = _walk(prog, torch.arange(4, dtype=torch.int32))
    assert report.codes == ["CALLBACK_IN_LOOP"]


def test_walker_exempts_cond_confined_op():
    """An op in a taken branch (device_run's immediate-hook shape) is
    data-dependent — not the every-iteration pathology."""
    from torch._higher_order_ops.scan import scan

    def prog(x):
        def body(c, xi):
            r = torch.cond(xi % 2 == 0, _post_node,
                           lambda v: torch.zeros((), dtype=torch.int32),
                           (xi,))
            return c + r, xi.clone()
        return scan(body, torch.zeros((), dtype=torch.int32), x)[0]

    report, counts = _walk(prog, torch.arange(4, dtype=torch.int32))
    assert not report and counts == {"rpc_post": 1}


def _echo(x):
    return np.int32(x)


trpc.REGISTRY.register("tan.echo", _echo)
_I32 = trpc.ShapeDtype((), torch.int32)


def _three_calls(x):
    for i in range(3):
        x = x + trpc.rpc_call("tan.echo", x, result_shape=_I32)[0]
    return x


def test_walker_flags_an_unrolled_python_loop():
    report = analyze_graph(_three_calls, torch.zeros((), dtype=torch.int32))
    (h,) = report.hazards
    assert h.code == "CALLBACK_IN_LOOP"
    line = inspect.getsourcelines(_three_calls)[1] + 2
    assert h.site == f"{__file__}:{line}"
    assert h.details["unrolled_calls"] == 3


def _call(x):
    return trpc.rpc_call("tan.echo", x, result_shape=_I32)[0]


def _two_sites(x):
    a = _call(x)
    return a + _call(x + 1)


def test_walker_keeps_apart_one_line_reached_from_two():
    assert not analyze_graph(_two_sites, torch.zeros((), dtype=torch.int32))


def _clean(x):
    q = trpc.RpcQueue.create(8, 4, 64, device="cpu")
    for i in range(4):
        q.enqueue("tan.echo", x + i)
    q.flush()
    return x + 1


def test_walker_clean_program_and_op_counts():
    """Enqueues in a loop and one flush: the batching the lint asks for."""
    ep = torch.export.export(_M(_clean), (torch.zeros((), dtype=torch.int32),),
                             strict=False)
    counts = {}
    assert not walk_graph(ep.graph_module, counts=counts)
    assert counts == {"rpc_enqueue": 4, "rpc_post": 1}


# ---------------------------------------------------------------------------
# (f) the lint CLI
# ---------------------------------------------------------------------------

def _lint(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_lint_cli_exit_codes(tmp_path):
    bad = _lint("repro_torch.analysis.corpus:never_flushed", "--device",
                "cpu", "--no-graph")
    assert bad.returncode == 1 and "NEVER_FLUSHED" in bad.stdout, bad
    ok = _lint("repro_torch.analysis.corpus:never_flushed_fixed",
               "--device", "cpu")
    assert ok.returncode == 0 and "no hazards" in ok.stdout, ok
    missing = _lint("repro_torch.analysis.corpus:no_such_case")
    assert missing.returncode == 2, missing
    refused = _lint("--corpus", "--device", "cpu", "--write-golden",
                    GOLDEN)
    assert refused.returncode == 2, refused
    out = tmp_path / "port.json"
    wrote = _lint("--corpus", "--device", "cpu", "--write-golden", str(out))
    assert wrote.returncode == 0, wrote
    port = json.loads(out.read_text())["cases"]
    assert port == {n: GOLDEN_CODES[n] for n in PORTED}


def test_lint_cli_corpus_against_jax_golden():
    run = _lint("--corpus", "--golden", GOLDEN, "--device", "cpu")
    assert run.returncode == 0, run
    assert "corpus: 34/34 ported cases match" in run.stdout
    assert "MISMATCH" not in run.stdout


# ---------------------------------------------------------------------------
# (g) chip_smoke.py's analysis programs: the engine's ticks and the loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama():
    from repro.configs import CONFIGS
    from repro.models import build_model as j_build
    from repro.models.common import split_params
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model
    import dataclasses
    jcfg = CONFIGS["llama3.2-3b"].reduced()
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    values, _ = split_params(jparams)
    tmodel = build_model(ModelConfig(**dataclasses.asdict(jcfg)),
                         device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, values),
                              device="cpu")
    return jmodel, jparams, tmodel, tparams


def _ticks(engine, rec, capture_fn):
    for p in CHIP.ANALYSIS_PROMPTS:
        engine.submit(p, max_new=2)
    with capture_fn() as cap:
        for _ in range(CHIP.ANALYSIS_TICKS):
            engine.step()
    assert len(engine.spill_acks) == len(CHIP.ANALYSIS_PROMPTS)
    assert len(rec) == len(CHIP.ANALYSIS_PROMPTS)
    return cap


def test_engine_ticks_give_jax_codes(llama):
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.serving.engine import ServingEngine
    jmodel, jparams, tmodel, tparams = llama
    jrec, trec = [], []
    jeng = JaxEngine(jmodel, jparams, batch_slots=4, max_len=64,
                     page_size=16, spill_sink=lambda *a: jrec.append(a))
    teng = ServingEngine(tmodel, tparams, batch_slots=4, max_len=64,
                         page_size=16, device="cpu",
                         spill_sink=lambda *a: trec.append(a))
    jcap = _ticks(jeng, jrec, jcapture.capture)
    tcap = _ticks(teng, trec, capture)
    kinds = [e["kind"] for e in tcap.events]
    assert kinds.count("rpc_enqueue") == len(CHIP.ANALYSIS_PROMPTS)
    assert kinds == [e["kind"] for e in jcap.events]
    assert tcap.report().codes == jcap.report().codes == \
        CHIP.ANALYSIS_ENGINE_CODES


def _key(ev):
    return (ev["kind"], ev.get("name"),
            tuple((k, v) for k, _, v in ev["scopes"]))


def test_hooked_device_run_codes_beside_jax():
    """The same events as JAX's trace, folded (in order of first firing,
    not of trace), and the port's codes.  JAX's differ by one false
    positive: its returning hook flushes inside a ``lax.cond``, whose
    branch sees a fresh tracer, so the flush joins no lineage and the
    hook's ticketed enqueues count against the whole run (10 reply words
    over a 1-word reply arena).  The port's flush is the enqueues' queue
    object, so the epoch holds one reply.  The rules agree on either
    stream: the difference is the stream's lineage."""
    jhooks = CHIP.analysis_hooks(jdm.HostHook, jax.ShapeDtypeStruct,
                                 jnp.float32)
    thooks = CHIP.analysis_hooks(tdm.HostHook, trpc.ShapeDtype,
                                 torch.float32)
    steps = CHIP.ANALYSIS_STEPS
    with jcapture.capture() as jcap:
        jdm.device_run(lambda i, s: s + 1.0, jnp.zeros(256), steps,
                       hooks=jhooks)
        jax.effects_barrier()
    with capture() as tcap:
        final = tdm.device_run(lambda i, s: s + 1.0, torch.zeros(256),
                               steps, hooks=thooks)
    assert jcap.events and len(tcap.folded()) < len(tcap.events)
    assert float(final[0]) == steps + steps // 100
    assert sorted(map(_key, tcap.folded())) == sorted(map(_key, jcap.events))
    assert jcap.report().codes == t_analyze(jcap.events).codes == \
        ["CAPACITY_REPLY"]
    assert tcap.report().codes == j_analyze(tcap.folded()).codes == \
        CHIP.ANALYSIS_LOOP_CODES == []


# ---------------------------------------------------------------------------
# the event sites skip the analysis package, but its corpus
# ---------------------------------------------------------------------------

def _site_from(filename):
    """``events._user_site()`` called from a function whose code claims
    ``filename``."""
    ns = {"site": tev._user_site}
    exec(compile("def f():\n    return site()\n", filename, "exec"), ns)
    return ns["f"]()


def test_user_site_skips_analysis_frames_but_the_corpus():
    here = f"{__file__}:"
    got = _site_from("/x/repro_torch/analysis/capture.py")
    assert got.startswith(here), got
    got = _site_from("/x/repro_torch/analysis/corpus.py")
    assert got == "/x/repro_torch/analysis/corpus.py:2", got


def test_corpus_hazard_site_is_the_corpus_line_not_capture():
    report = analyze(corpus.never_flushed, device="cpu", graph=False)
    (h,) = report.hazards
    bug, _, _ = _bug_line(corpus.never_flushed)
    assert h.site == f"{corpus.__file__}:{bug}"
    assert "capture.py" not in h.site
