"""The batched queue's enqueue plan (``kernels/rpc_queue/kernel.py::
EnqueuePlan``) on the CPU, against the record that ``RpcQueue.record``
builds from scratch.

A card queue's eager enqueue launches ``rpc_enqueue`` through a plan
cached on the queue: the record's static fields packed once a signature,
a call patching its words, its sources and ``where``.  There is no card here, so these tests
make a CPU queue take that route with a stand-in for its launch
(:class:`_Launches`: ``QueueLaunch.run`` itself, its C entry replaced by
one that keeps the bytes of the lanes and the record it is passed) and
hold it against ``pack_record`` of
``record()``'s record, the parameters the op's CUDA kernel packs: byte for
byte for hypothesis-drawn records; a plan a signature; the lanes'
``sanitize`` that of the record, also when the queue's flag is set after
it is made; every error of ``record()`` on a first and on a later call;
the op under ``torch.export`` and dispatch modes.  An immediate's word is
held against JAX's lane value.  The lanes themselves are held against JAX's queue by
``tests/test_torch_rpc_queue.py``."""
import ctypes
import math
import threading

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import events  # noqa: E402
from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.core.expand import _with_sanitize  # noqa: E402
from repro_torch.core.rpc import ShapeDtype  # noqa: E402
from repro_torch.kernels.rpc_queue import kernel as qkernel  # noqa: E402
from repro_torch.kernels.rpc_queue.kernel import (  # noqa: E402
    DTYPES, QueueLaunch, _QueueLanes, _Record, _RecordArg, pack_record)
from repro_torch.kernels.rpc_queue.ops import flatten  # noqa: E402

CPU = torch.device("cpu")
NAME = "plan.sink"
trpc.REGISTRY.register(NAME, lambda *a: None)
OP = torch.ops.repro_torch.rpc_enqueue.default


class _Launches(QueueLaunch):
    """A card queue's ``QueueLaunch`` on the CPU: its own ``run``, with
    lanes of no addresses and a C entry that keeps, each launch, the
    record's bytes and a copy of the lanes (``ticket``, ``sanitize``)."""

    def __init__(self):
        self.lanes = _QueueLanes()
        self._lanes_at = ctypes.addressof(self.lanes)
        self._index = None
        self._entry = self._keep
        self._stream = lambda index: 0
        self._lock = threading.Lock()
        self.records = []

    def _keep(self, lanes_at, record_at, stream):
        self.records.append((
            ctypes.string_at(record_at, ctypes.sizeof(_Record)),
            _QueueLanes.from_buffer_copy(
                ctypes.string_at(lanes_at, ctypes.sizeof(_QueueLanes)))))
        return 0


@pytest.fixture(autouse=True)
def _launch_count():
    """The stand-in's launches count in ``rpc_enqueue.launches``: kept
    out of the count that other tests read."""
    before = qkernel.rpc_enqueue.launches
    yield
    qkernel.rpc_enqueue.launches = before


def _direct(**kw) -> trpc.RpcQueue:
    """A CPU queue that takes a card queue's route to the launch."""
    q = trpc.RpcQueue.create(device="cpu", **kw)
    q._direct, q._launch = True, _Launches()
    return q


def _packed(q, args, returns=None, where=None) -> bytes:
    """The parameters that today's path packs from scratch."""
    return bytes(pack_record(*flatten(q.record(NAME, args, returns, where)),
                             CPU))


# ---------------------------------------------------------------------------
# an immediate's word
# ---------------------------------------------------------------------------

_NP_SCALARS = (np.int8, np.int16, np.int32, np.uint8, np.float16,
               np.float32, np.float64, np.bool_)


@settings(max_examples=200, deadline=None)
@given(st.one_of(
    st.integers(-2 ** 40, 2 ** 40), st.floats(width=64), st.booleans(),
    st.tuples(st.sampled_from(_NP_SCALARS), st.integers(0, 100)).map(
        lambda t: t[0](t[1]))))
def test_an_immediates_word_is_jaxs(a):
    """``_immediate`` (numpy only for what is not a Python bool, an int in
    int32's range or a float) gives the lane and the 32 bits that JAX's
    ``RpcQueue._enqueue`` writes for ``a`` (``jnp.asarray``, then int32
    or float32), and raises where JAX does."""
    jnp = pytest.importorskip("jax.numpy")
    with np.errstate(over="ignore"):       # a float past float32's range
        try:
            s = jnp.asarray(a)
        except OverflowError:
            with pytest.raises(OverflowError):
                trpc._immediate(a)
            return
        is_int = bool(jnp.issubdtype(s.dtype, jnp.integer)
                      or s.dtype == jnp.bool_)
        got_int, word = trpc._immediate(a)
    want = np.asarray(s.astype(jnp.int32 if is_int else jnp.float32))
    assert got_int == is_int
    if not is_int and math.isnan(float(want)):
        assert math.isnan(np.uint32(word).view(np.float32))
    else:
        assert word == int(want.view(np.uint32))


# ---------------------------------------------------------------------------
# a patched record is the record packed from scratch
# ---------------------------------------------------------------------------

_KINDS = ("int", "float", "bool", "np", "dev", "pay", "ndpay")


def _value(draw, kind, dtype, length):
    if kind == "int":
        return draw(st.integers(-2 ** 31, 2 ** 31 - 1))
    if kind == "float":
        return draw(st.floats(width=64))
    if kind == "bool":
        return draw(st.booleans())
    if kind == "np":
        return np.float32(draw(st.floats(width=32)))
    if kind == "ndpay":
        return np.asarray(draw(st.lists(st.integers(-99, 99), min_size=length,
                                        max_size=length)), np.int32)
    shape = () if kind == "dev" else (length,)
    vals = np.asarray(draw(st.lists(st.integers(-99, 99),
                                    min_size=max(length, 1),
                                    max_size=max(length, 1))))
    return torch.as_tensor(vals[:int(np.prod(shape))].reshape(shape)) \
        .to(dtype)


@st.composite
def _two_calls(draw):
    """Two calls of one signature: (args, where) twice, returns,
    sanitize."""
    n = draw(st.integers(0, 8))
    spec = [(draw(st.sampled_from(_KINDS)), draw(st.sampled_from(list(DTYPES))),
             draw(st.integers(0, 12))) for _ in range(n)]
    wmode = draw(st.sampled_from(["none", "const", "tensor"]))
    nrep = draw(st.integers(0, 4))
    returns = ShapeDtype((nrep,), draw(st.sampled_from(
        [torch.int32, torch.float32]))) if nrep else None

    flag = draw(st.booleans())

    def call(flag):
        args = [_value(draw, k, dt, ln) for k, dt, ln in spec]
        where = None if wmode == "none" else flag
        if wmode == "tensor":
            where = torch.tensor(where)
        return args, where

    # the second call's where is the other constant
    return call(flag), call(not flag), returns, draw(st.booleans())


@settings(max_examples=150, deadline=None)
@given(_two_calls())
def test_patched_record_is_byte_equal_to_a_fresh_one(calls):
    (a1, w1), (a2, w2), returns, sanitize = calls
    q = _direct(capacity=16, width=8, payload_capacity=4096,
                reply_capacity=16, sanitize=sanitize)
    for args, where in ((a1, w1), (a2, w2)):
        q.enqueue_ticketed(NAME, *args, returns=returns, where=where)
        assert q._launch.records[-1][0] == _packed(q, args, returns, where)
    assert len(q._plans) == 1


def test_a_payload_not_on_the_queue_as_the_kernel_reads_it_is_copied():
    """A strided payload is made contiguous, a where of another dtype made
    bool: the record equals a fresh one but for the copies' addresses."""
    q = _direct(capacity=8, width=3, payload_capacity=64)
    strided = torch.arange(12, dtype=torch.int32)[::2]
    for i in range(2):
        q.enqueue(NAME, i, strided, where=torch.tensor(1))
    got = q._launch.records[-1][0]
    want = _packed(q, [1, strided], where=torch.tensor(1))
    src = _Record.args.offset + ctypes.sizeof(_RecordArg) + \
        _RecordArg.src.offset                 # argument 1's address
    where = _Record.where.offset
    mask = set(range(where, where + 8)) | set(range(src, src + 8))
    assert len(q._plans) == 1
    assert bytes(b for k, b in enumerate(got) if k not in mask) == \
        bytes(b for k, b in enumerate(want) if k not in mask)


# ---------------------------------------------------------------------------
# one plan a signature
# ---------------------------------------------------------------------------

def test_a_signature_reuses_its_plan_and_a_new_one_makes_one():
    q = _direct(capacity=64, width=4, payload_capacity=256,
                reply_capacity=16)
    x = torch.tensor(3, dtype=torch.int32)
    pay = torch.arange(4, dtype=torch.int32)
    for i in range(3):
        q.enqueue(NAME, i, 0.5 * i, x, pay + i)
    assert len(q._plans) == 1
    steps = [
        ((1, 0.5, x, torch.arange(5, dtype=torch.int32)), {}),   # length
        ((1, 0.5, x, torch.arange(4.0)), {}),                     # dtype
        ((1, 0.5, x.to(torch.int16), pay), {}),                   # 0-d dtype
        ((1, 0.5, 2, pay), {}),                                   # a number
        ((1.0, 0.5, x, pay), {}),                                 # its lane
        ((1, 0.5, x, pay), {"where": True}),                      # where
        ((1, 0.5, x, pay), {"where": torch.tensor(True)}),        # its mode
        ((1, 0.5, x, pay), {"returns": ShapeDtype((2,), torch.int32)}),
        ((1, 0.5, x, pay), {"returns": ShapeDtype((3,), torch.int32)}),
        ((1, 0.5, x), {}),                                        # fewer
    ]
    for n, (args, kw) in enumerate(steps, start=2):
        q.enqueue_ticketed(NAME, *args, **kw)
        q.enqueue_ticketed(NAME, *args, **kw)
        assert len(q._plans) == n
    # where's value, a constant's included, is the call's
    q.enqueue(NAME, 1, 0.5, x, pay, where=False)
    assert len(q._plans) == len(steps) + 1
    assert q._launch.records[-1][0] == _packed(q, [1, 0.5, x, pay],
                                               where=False)


def test_a_sanitized_queue_keys_its_own_plans():
    plain, san = _direct(capacity=8, width=2, payload_capacity=64), \
        _direct(capacity=8, width=2, payload_capacity=64, sanitize=True)
    pay = torch.arange(3, dtype=torch.int32)
    for q in (plain, san):
        q.enqueue(NAME, 1, pay)
    assert [k[-1] for k in plain._plans] == [False]
    assert [k[-1] for k in san._plans] == [True]
    assert plain._launch.records[0][0] != san._launch.records[0][0]


def test_a_sanitize_flag_set_after_create_reaches_the_lanes():
    """``expand(queue=True, sanitize=True)`` sets the flag on a queue
    already made (``expand.py::_with_sanitize``): each launch's lanes
    carry the ``sanitize`` of its record, the op route's
    (``kernel.py::rpc_enqueue`` writes ``header[5]``), so the kernel
    places the payload and writes the canaries that the record counts."""
    q = _direct(capacity=8, width=2, payload_capacity=64)
    pay = torch.arange(3, dtype=torch.int32)
    q.enqueue(NAME, 1, pay)
    _with_sanitize(q)
    q.enqueue(NAME, 2, pay)
    q.sanitize = False
    q.enqueue(NAME, 3, pay)
    for k, (rec, lanes) in enumerate(q._launch.records):
        q.sanitize = k == 1
        header = flatten(q.record(NAME, [k + 1, pay]))[0]
        assert lanes.sanitize == header[5] == int(k == 1)
        assert rec == _packed(q, [k + 1, pay])
    assert sorted(k[-1] for k in q._plans) == [False, True]


def test_only_a_ticketed_record_or_an_event_gets_a_ticket():
    q = _direct(capacity=8, width=2, reply_capacity=4)
    q.enqueue(NAME, 1)
    _, t = q.enqueue_ticketed(NAME, 1)
    assert q._launch.records[0][1].ticket is None
    assert q._launch.records[1][1].ticket == t.data_ptr() and \
        t.dtype == torch.int32 and t.dim() == 0
    sink = []
    with events.record(sink):
        q.enqueue(NAME, 1)
    assert q._launch.records[2][1].ticket
    enq = [e for e in sink if e["kind"] == "rpc_enqueue"]
    assert len(enq) == 1 and not enq[0]["ticketed"]


# ---------------------------------------------------------------------------
# record()'s errors, on a first and on a later call
# ---------------------------------------------------------------------------

_ERRORS = {
    "unregistered": (dict(), ("plan.nobody", 1), {}),
    "over_width": (dict(width=1), (NAME, 1, 2), {}),
    "wide_reply": (dict(reply_capacity=4), (NAME, 1),
                   {"returns": ShapeDtype((1,), torch.int64)}),
    "no_reply_arena": (dict(), (NAME, 1),
                       {"returns": ShapeDtype((1,), torch.int32)}),
    "reply_too_long": (dict(reply_capacity=2), (NAME, 1),
                       {"returns": ShapeDtype((3,), torch.int32)}),
    "complex_reply": (dict(reply_capacity=4), (NAME, 1),
                      {"returns": ShapeDtype((1,), torch.complex32)}),
    "complex_arg": (dict(), (NAME, torch.zeros(2, dtype=torch.complex64)),
                    {}),
    "complex_scalar": (dict(), (NAME, torch.tensor(1j)), {}),
    "no_payload_arena": (dict(payload_capacity=0), (NAME, torch.zeros(3)),
                         {}),
    "payload_too_long": (dict(payload_capacity=4), (NAME, torch.zeros(5)),
                         {}),
    "where_not_a_scalar": (dict(), (NAME, 1),
                           {"where": torch.tensor([True, False])}),
    "out_of_int32": (dict(), (NAME, 2 ** 40), {}),
    "list_arg_over_width": (dict(width=1), (NAME, [1, 2], 3), {}),
}


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_every_record_error_is_raised_first_and_later(case):
    kw, args, call_kw = _ERRORS[case]
    kw = dict(dict(capacity=4, width=4, payload_capacity=16), **kw)
    with pytest.raises(Exception) as today:
        trpc.RpcQueue.create(device="cpu", **kw).enqueue_ticketed(
            *args, **call_kw)
    q = _direct(**kw)
    for _ in range(2):
        with pytest.raises(type(today.value)) as got:
            q.enqueue_ticketed(*args, **call_kw)
        assert str(got.value) == str(today.value)
    assert not q._plans and not q._launch.records


def test_errors_of_a_call_whose_plan_exists():
    """A plan does not vouch for the callee's registration or ``where``'s
    rank: both are checked every call, with ``record()``'s messages."""
    trpc.REGISTRY.register("plan.gone", lambda *a: None)
    q = _direct(capacity=4, width=2)
    q.enqueue("plan.gone", 1, where=torch.tensor(True))
    with pytest.raises(ValueError, match="^where must be a scalar$"):
        q.enqueue("plan.gone", 1, where=torch.tensor([True]))
    trpc.REGISTRY.unregister("plan.gone")
    with pytest.raises(KeyError) as got:
        q.enqueue("plan.gone", 1, where=torch.tensor(True))
    with pytest.raises(KeyError) as today:
        q.record("plan.gone", (1,), where=torch.tensor(True))
    assert str(got.value) == str(today.value)
    # registered again, the plan serves, and the drain knows the id again
    trpc.REGISTRY.register("plan.gone", lambda *a: None)
    q.enqueue("plan.gone", 2, where=torch.tensor(True))
    assert len(q._plans) == 1 and len(q._launch.records) == 2
    assert "plan.gone" in trpc.REGISTRY.batch_ids
    trpc.REGISTRY.unregister("plan.gone")


@pytest.mark.parametrize("dtype", [torch.uint16, torch.float8_e4m3fn])
def test_a_dtype_the_kernel_does_not_read_is_refused_every_call(dtype):
    q = _direct(capacity=4, width=2)
    for _ in range(2):
        with pytest.raises(ValueError, match="is not a contiguous tensor of"):
            q.enqueue(NAME, torch.zeros((), dtype=dtype))
    assert not q._plans


# ---------------------------------------------------------------------------
# the route: the op wherever something would see it
# ---------------------------------------------------------------------------

class _Seen(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


class _Fn(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def test_eager_is_false_under_modes_and_export():
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert trpc._eager()
    with torch.device("cpu"):          # a DeviceContext: factory defaults
        assert trpc._eager()
        with _Fn():
            assert not trpc._eager()
    with _Fn():
        assert not trpc._eager()
    with _Seen():
        assert not trpc._eager()
    with FakeTensorMode():
        assert not trpc._eager()
    seen = []

    class M(torch.nn.Module):
        def forward(self, x):
            seen.append(trpc._eager())
            return x + 1

    torch.export.export(M(), (torch.zeros(2),), strict=False)
    assert seen and not any(seen)


def test_a_dispatch_mode_sees_the_op_of_a_card_route_queue():
    q = _direct(capacity=4, width=2, reply_capacity=4)
    with _Seen() as mode:
        q.enqueue(NAME, 1, torch.tensor(2.0))
        q.enqueue_ticketed(NAME, 3, torch.tensor(4.0))
    assert mode.ops.count(OP) == 2 and not q._launch.records
    assert int(q.head) == 2
    q.enqueue(NAME, 5, torch.tensor(6.0))
    assert len(q._launch.records) == 1


def test_export_keeps_the_op_of_a_card_route_queue():
    launches = []

    def body(x):
        q = trpc.RpcQueue.create(8, 4, 64, device="cpu")
        q._direct, q._launch = True, _Launches()
        launches.append(q._launch)
        for i in range(4):
            q.enqueue(NAME, x + i)
        return x + 1

    class M(torch.nn.Module):
        def forward(self, x):
            return body(x)

    ep = torch.export.export(M(), (torch.zeros((), dtype=torch.int32),),
                             strict=False)
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(OP) == 4
    assert launches and not any(la.records for la in launches)
