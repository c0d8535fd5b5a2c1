"""The async queue's flush plan (``kernels/rpc_async/kernel.py::
AsyncFlushPlan``) on the CPU, against the parameter block that
``pack_flush`` builds from scratch.

A card queue's eager async flush issues ``rpc_async_post`` and
``rpc_async_collect`` in one C call, through a plan cached on the queue:
the block packed once, each flush patching its epoch, parity,
``have_prev`` and deadline.  There is no card here, so these tests give a
CPU queue a card's route (``_direct``) with stand-ins: a ring whose mapped
memory is ordinary host memory at made-up device addresses, with no
ingest thread, and a plan whose C entry keeps the bytes of each block it
is passed (the ``kept`` fixture).  They hold the kept blocks byte for byte
against ``pack_flush`` for the same ring, state and epoch, for a single
queue and a 4-row sharded queue; a ``shard_deadline`` set after the first
flush; the copy route against ``COPY_LIMIT`` and the post grid; the ring's
row pitches; a failed launch; and the two ops under a dispatch mode and
``torch.export``.  The kernels themselves are held against their plain
versions on the card by ``chip_smoke.py``'s ``rpc_async_time`` line, and
the queue's flushes against JAX's by ``tests/test_torch_rpc_async.py``."""
import ctypes

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.core import rpc as trpc  # noqa: E402
from repro_torch.kernels.rpc_async import kernel as akernel  # noqa: E402
from repro_torch.kernels.rpc_async.kernel import (  # noqa: E402
    ROW_WORDS, AsyncFlushPlan, AsyncRing, _AsyncFlush, pack_flush)
from repro_torch.kernels.rpc_channel.kernel import (  # noqa: E402
    ALIGN, BLOCK_BYTES, COPY_LIMIT)

POST = torch.ops.repro_torch.rpc_async_post.default
COLLECT = torch.ops.repro_torch.rpc_async_collect.default
#: Where the stand-in ring's "device view" of its host memory lies.
DEV_OFFSET = 1 << 44
SMS = 132
GEOMETRY = dict(capacity=64, width=4, payload_capacity=512,
                reply_capacity=96)


class _Kept(list):
    """The kept blocks, and the stand-in plan's ``bind`` (its ``err`` the
    code each launch returns)."""


@pytest.fixture
def kept(monkeypatch):
    """The stand-ins (see the module docstring); yields the list of
    ``(plan, block bytes)`` that each plan launch appends to.  The launch
    counters are restored afterwards."""
    buffers, blocks = [], _Kept()

    def host_alloc(nbytes):
        # page-aligned, as cudaHostAlloc's
        buf = (ctypes.c_uint8 * (nbytes + 4096))()
        buffers.append(buf)
        host = -(-ctypes.addressof(buf) // 4096) * 4096
        return host, host + DEV_OFFSET

    def bind(plan):
        def entry(address, stream):
            blocks.append((plan, ctypes.string_at(
                address, ctypes.sizeof(_AsyncFlush))))
            return bind.err
        plan._entry, plan._stream = entry, lambda index: 0

    bind.err = 0
    monkeypatch.setattr(akernel, "_lib", lambda: None)
    monkeypatch.setattr(akernel, "_host_alloc", host_alloc)
    monkeypatch.setattr(akernel, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(AsyncRing, "_ingest", lambda self: None)
    monkeypatch.setattr(AsyncFlushPlan, "_bind", bind)
    counts = (akernel.rpc_async_post.launches,
              akernel.rpc_async_collect.launches)
    blocks.bind = bind
    yield blocks
    akernel.rpc_async_post.launches, akernel.rpc_async_collect.launches = \
        counts


def _queue(**kw) -> trpc.RpcQueue:
    """An async CPU queue that takes a card queue's flush route."""
    q = trpc.RpcQueue.create(**dict(GEOMETRY, **kw), mode="async",
                             device="cpu")
    q._direct = True
    return q


def _sharded(rows: int, **kw) -> trpc.ShardedRpcQueue:
    sq = trpc.ShardedRpcQueue.create(rows, **dict(GEOMETRY, **kw),
                                     mode="async", device="cpu")
    sq.shards[0]._direct = True
    return sq


def _ring(q) -> AsyncRing:
    first = q.shards[0] if isinstance(q, trpc.ShardedRpcQueue) else q
    return trpc._slot(first.qslot).ring


def _deadline(q):
    first = q.shards[0] if isinstance(q, trpc.ShardedRpcQueue) else q
    return first.shard_deadline


def _fresh(q, epoch: int) -> bytes:
    """The block that the op route packs for ``epoch``'s flush of ``q``,
    both halves' parameters."""
    L = q.layout
    return bytes(pack_flush(_ring(q), q.state, epoch, L.out_start,
                            bool(L.reply_capacity), L.rslots,
                            L.reply_capacity, _deadline(q)))


# ---------------------------------------------------------------------------
# a patched block is the block packed from scratch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [None, 4], ids=["single", "sharded_4"])
def test_patched_block_is_byte_equal_to_a_fresh_one(kept, rows):
    q = _queue() if rows is None else _sharded(rows)
    for epoch in range(1, 7):
        q.flush()
        plan, got = kept[-1]
        assert got == _fresh(q, epoch)
        b = _AsyncFlush.from_buffer_copy(got)
        assert (b.epoch, b.prev, b.parity, b.have_prev) == (
            epoch, (epoch - 1) & 0xFFFFFFFF, epoch & 1, int(epoch > 1))
        assert b.rows == (rows or 1) and b.deadline_ns == 0
    # one plan, made at the first flush; one block a flush
    assert len(kept) == 6 and len({id(p) for p, _ in kept}) == 1


def test_a_block_holds_the_ring_and_the_state(kept):
    q = _sharded(4)
    q.flush()
    ring, L = _ring(q), q.layout
    b = _AsyncFlush.from_buffer_copy(kept[-1][1])
    assert list(b.rec) == ring._rec_dev and list(b.in_) == ring._in_dev
    assert list(b.in_host) == ring._in_host
    assert list(b.out) == ring._out_dev
    assert b.rec[0] == ring.host + DEV_OFFSET
    assert b.rec[1] - b.rec[0] == 4 * akernel.RECORD_BYTES
    assert b.state == q.state.data_ptr() and b.pitch == q.state.shape[1]
    assert b.arrivals == ring.arrivals.data_ptr()
    assert (b.out_start, b.rslots, b.rc, b.has_reply) == (
        L.out_start, L.rslots, L.reply_capacity, 1)
    assert b.in_bytes == 4 * L.in_end
    assert b.timeout_ns == int(trpc.TIMEOUT_S * 1e9)


@settings(max_examples=50, deadline=None)
@given(st.integers(1, 2 ** 40), st.one_of(
    st.none(), st.floats(1e-3, 60.0, allow_nan=False)))
def test_set_epoch_is_pack_flushs_at_any_epoch(epoch, deadline):
    """The plan's patch of a block made at epoch 1 gives
    ``pack_flush``'s block at any epoch (past 2**32 too) and deadline."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(akernel, "_lib", lambda: None)
        buf = (ctypes.c_uint8 * 4096)()
        mp.setattr(akernel, "_host_alloc",
                   lambda n: (ctypes.addressof(buf),
                              ctypes.addressof(buf) + DEV_OFFSET))
        mp.setattr(akernel, "_sm_count", lambda device: SMS)
        mp.setattr(AsyncRing, "_ingest", lambda self: None)
        ring = AsyncRing(torch.device("cpu"), 40, 9, None)
    state = torch.zeros(64, dtype=torch.int32)
    block = pack_flush(ring, state, 1, 20, True, 2, 2, None)
    akernel._set_epoch(block, epoch, deadline)
    assert bytes(block) == bytes(pack_flush(ring, state, epoch, 20, True, 2,
                                            2, deadline))
    assert block.prev == (epoch - 1) % 2 ** 32


# ---------------------------------------------------------------------------
# what each flush reads from the queue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [None, 4], ids=["single", "sharded_4"])
def test_a_deadline_set_after_the_first_flush_reaches_the_next_block(
        kept, rows):
    q = _queue() if rows is None else _sharded(rows)
    shards = q.shards if rows else [q]
    q.flush()
    for deadline, want in ((0.25, 250_000_000), (None, 0), (1.5,
                                                            1_500_000_000)):
        for s in shards:
            s.shard_deadline = deadline
        q.flush()
        got = kept[-1][1]
        assert _AsyncFlush.from_buffer_copy(got).deadline_ns == want
        assert got == _fresh(q, len(kept))


def test_each_flush_counts_one_launch_of_each_kernel(kept):
    q = _queue()
    for _ in range(3):
        before = (akernel.rpc_async_post.launches,
                  akernel.rpc_async_collect.launches)
        q.flush()
        assert (akernel.rpc_async_post.launches,
                akernel.rpc_async_collect.launches) == (before[0] + 1,
                                                        before[1] + 1)


def test_a_failed_launch_raises_and_counts_nothing(kept):
    q = _queue()
    q.flush()
    counts = (akernel.rpc_async_post.launches,
              akernel.rpc_async_collect.launches)
    kept.bind.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        q.flush()
    assert (akernel.rpc_async_post.launches,
            akernel.rpc_async_collect.launches) == counts


# ---------------------------------------------------------------------------
# the copy route and the post grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,payload", [
    (None, 512), (None, 200_000), (None, 262_000), (4, 512), (4, 60_000),
    (4, 70_000), (40, 512), (140, 64)])
def test_the_copy_route_is_chosen_by_the_rows_bytes(kept, rows, payload):
    """The copy engines above ``COPY_LIMIT`` bytes of rows in all (one
    post block), the kernel at or below it, with about a block per
    ``BLOCK_BYTES``, at least one a row and at most one an SM."""
    q = (_queue(payload_capacity=payload) if rows is None
         else _sharded(rows, payload_capacity=payload))
    q.flush()
    b = _AsyncFlush.from_buffer_copy(kept[-1][1])
    n = (rows or 1) * 4 * q.layout.in_end
    assert b.engine == int(n > COPY_LIMIT)
    want = 1 if n > COPY_LIMIT else min(max(-(-n // BLOCK_BYTES),
                                            rows or 1), SMS)
    assert b.grid == want


def test_both_routes_and_both_grid_limits_are_reached(kept):
    """The cases above reach both routes, a grid set by the rows and one
    set by the SMs."""
    seen = set()
    for rows, payload in ((None, 512), (None, 262_000), (4, 512),
                          (None, 200_000), (140, 64)):
        q = (_queue(payload_capacity=payload) if rows is None
             else _sharded(rows, payload_capacity=payload))
        q.flush()
        b = _AsyncFlush.from_buffer_copy(kept[-1][1])
        seen.add("engine" if b.engine else
                 "rows" if b.grid == b.rows else
                 "sms" if b.grid == SMS else "bytes")
    assert seen == {"engine", "rows", "bytes", "sms"}


def test_a_rings_rows_are_16_bytes_apart(kept):
    for in_words, out_words, rows in ((41, 9, 1), (1606, 289, 4),
                                      (8, 4, 3)):
        ring = AsyncRing(torch.device("cpu"), in_words, out_words, None,
                         rows=rows)
        assert ring.in_pitch % ROW_WORDS == 0 <= ring.in_pitch - in_words \
            < ROW_WORDS
        assert ring.out_pitch % ROW_WORDS == 0 <= ring.out_pitch \
            - out_words < ROW_WORDS
        for p in (0, 1):
            assert ring._in_dev[p] % ALIGN == ring._out_dev[p] % ALIGN == 0
            assert ring._in[p].shape == (rows, in_words)
            assert ring._out[p].shape == (rows, out_words)
            ring._out[p][rows - 1] = 7
            assert int(ring._out[p].sum()) == 7 * out_words
        assert ring._out_dev[1] - ring._out_dev[0] >= 4 * rows \
            * ring.out_pitch


# ---------------------------------------------------------------------------
# export and dispatch modes see the two ops
# ---------------------------------------------------------------------------

class _Seen(TorchDispatchMode):
    """Records every op; the two async ops are recorded and not run (a
    CPU queue's collect takes the drain's words, which the card's route
    does not pass)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        if func in (POST, COLLECT):
            return None
        return func(*args, **(kwargs or {}))


def test_a_dispatch_mode_sees_both_ops_of_a_card_route_queue(kept):
    q = _queue()
    with _Seen() as mode:
        q.flush()
    assert mode.ops.count(POST) == mode.ops.count(COLLECT) == 1
    assert mode.ops.index(POST) < mode.ops.index(COLLECT) and not kept
    q.flush()
    assert len(kept) == 1 and kept[0][1] == _fresh(q, 2)


def test_export_keeps_both_ops_of_a_card_route_queue(kept):
    def body(x):
        q = _queue()
        q.flush()
        return x + 1

    class M(torch.nn.Module):
        def forward(self, x):
            return body(x)

    ep = torch.export.export(M(), (torch.zeros(()),), strict=False)
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(POST) == targets.count(COLLECT) == 1
    assert targets.index(POST) < targets.index(COLLECT) and not kept
