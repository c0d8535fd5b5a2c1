"""The five kernels and the four transport launches as ``torch.library``
custom ops, on the CPU.

``torch.ops.repro_torch.{decode_attention, paged_attention,
flash_attention, ssd_scan, rglru_scan}``: ``torch.library.opcheck`` on
each at small sizes (the schema, the fake kernel against the CPU kernel,
which is the plain version, the autograd registration, and AOT dispatch
with dynamic shapes); each public function traced by ``torch.export`` with
fake tensors to a graph that holds its op, whose module gives the eager
result bit for bit; and the public functions equal to their plain versions
bit for bit (the op adds nothing on the CPU), gradients included.  The
transport's ops (``rpc_post``, ``rpc_enqueue``, ``rpc_async_post``,
``rpc_async_collect``) mutate their queue or outputs: ``opcheck`` on each,
and ``torch.export`` keeps each call as a node (marked side-effectful)
whose exported module mutates its inputs as the eager op does."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_reference)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, plain_attention)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_attention_reference)
from repro_torch.kernels.rglru_scan.ops import linear_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_reference)
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_reference  # noqa: E402

OPS = torch.ops.repro_torch


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _inputs(name, grad=False):
    """(op args, public call, plain call) of ``name`` at a small size."""
    g = _gen()

    def rn(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(grad)

    if name == "decode_attention":
        q, k, v = rn(2, 4, 16), rn(2, 12, 2, 16), rn(2, 12, 2, 16)
        lengths = torch.tensor([5, 12], dtype=torch.int32)
        return ((q, k, v, lengths, 4, None),
                lambda: decode_attention(q, k, v, lengths, window=4),
                lambda: decode_attention_reference(q, k, v, lengths,
                                                   window=4))
    if name == "paged_attention":
        q, kp, vp = rn(2, 4, 16), rn(6, 4, 2, 16), rn(6, 4, 2, 16)
        table = torch.tensor([[0, 1, 2], [5, 4, 3]], dtype=torch.int32)
        lengths = torch.tensor([7, 12], dtype=torch.int32)
        return ((q, kp, vp, table, lengths, None, 0.3),
                lambda: paged_decode_attention(q, kp, vp, table, lengths,
                                               scale=0.3),
                lambda: paged_decode_attention_reference(
                    q, kp, vp, table, lengths, scale=0.3))
    if name == "flash_attention":
        q, k, v = rn(2, 8, 4, 16), rn(2, 10, 2, 16), rn(2, 10, 2, 16)
        return ((q, k, v, True, 3, 2, None),
                lambda: flash_attention(q, k, v, window=3, q_offset=2),
                lambda: plain_attention(q, k, v, True, 3, 2, None))
    if name == "ssd_scan":
        x, B, C = rn(2, 8, 2, 4), rn(2, 8, 8), rn(2, 8, 8)
        dt = torch.rand(2, 8, 2, generator=g).requires_grad_(grad)
        A = (-torch.rand(2, generator=g)).requires_grad_(grad)
        D = rn(2)
        return ((x, dt, A, B, C, D, 4),
                lambda: ssd_scan(x, dt, A, B, C, D, chunk=4),
                lambda: ssd_scan_reference(x, dt, A, B, C, D, chunk=4))
    a = torch.rand(2, 8, 4, generator=g).requires_grad_(grad)
    b = rn(2, 8, 4)
    return ((a, b), lambda: linear_scan(a, b),
            lambda: linear_scan_reference(a, b))


NAMES = ("decode_attention", "paged_attention", "flash_attention",
         "ssd_scan", "rglru_scan")
WITH_GRAD = ("flash_attention", "ssd_scan", "rglru_scan")
TRANSPORT = ("rpc_post", "rpc_enqueue", "rpc_async_post",
             "rpc_async_collect")


def _plus_one_staging():
    """A staging region on this thread's host channel whose serve writes
    slot 0's int32 word plus the first scalar word into slot 1."""
    import numpy as np
    from repro_torch.kernels.rpc_channel import host_channel

    def make():
        staging = host_channel().new_staging([4, 4])

        def serve():
            staging.slot(1).view(np.int32)[0] = \
                staging.slot(0).view(np.int32)[0] + \
                staging.word(0).view(np.int32)[0]
        return staging, serve

    return host_channel().stagings.get(("test_library_ops", "plus"),
                                       make)[0]


def _transport_args(name):
    """Op args of a transport op on a CPU queue (or the host channel)."""
    from repro_torch.core.rpc import REGISTRY, RpcQueue
    from repro_torch.kernels.rpc_queue.ops import flatten
    REGISTRY.register("test_library_ops.note", lambda *a: None)
    if name == "rpc_post":
        x = torch.tensor([41], dtype=torch.int32)
        out = torch.zeros(1, dtype=torch.int32)
        return (x, _plus_one_staging(), [x], [0], [1], [out], [1])
    q = RpcQueue.create(8, 4, 64, reply_capacity=8, mode="async",
                        device="cpu")
    L = q.layout
    if name == "rpc_enqueue":
        rec = q.record("test_library_ops.note",
                       (3, 2.5, torch.arange(4, dtype=torch.int32)))
        header, args, srcs, where = flatten(rec)
        return (q.state, q.arrivals, L.lanes, header, args, srcs, where)
    if name == "rpc_async_post":
        return (q.state, 0, 0, L.out_start, True)
    words = torch.arange(L.words - L.out_start - 9, dtype=torch.int32)
    return (q.state, 0, 0, L.out_start, L.rslots, L.reply_capacity, None,
            words)


@pytest.mark.parametrize("name", NAMES + TRANSPORT)
def test_opcheck(name):
    if name in TRANSPORT:
        args = _transport_args(name)
    else:
        args, _, _ = _inputs(name, grad=name in WITH_GRAD)
    result = torch.library.opcheck(getattr(OPS, name).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("name", NAMES)
def test_public_function_equals_the_plain_version(name):
    _, public, plain = _inputs(name)
    got, want = public(), plain()
    for g_, w in zip(*(t if isinstance(t, tuple) else (t,)
                       for t in (got, want))):
        assert g_.dtype == w.dtype
        assert torch.equal(g_, w)


@pytest.mark.parametrize("name", WITH_GRAD)
def test_op_gradients_are_the_plain_versions(name):
    """register_autograd recomputes through the plain version: gradients
    equal the plain version's own, bit for bit."""
    args, public, plain = _inputs(name, grad=True)
    tensors = [t for t in args if isinstance(t, torch.Tensor)
               and t.requires_grad]
    g_op = torch.autograd.grad(_first(public()).square().sum(), tensors)
    g_plain = torch.autograd.grad(_first(plain()).square().sum(), tensors)
    for a, b in zip(g_op, g_plain):
        assert torch.equal(a, b)


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def test_ssd_gradient_with_one_undefined_output_gradient():
    """Only the final state feeds the loss: y's gradient is undefined and
    stays so (set_materialize_grads(False)); the result equals the plain
    version's."""
    args, public, plain = _inputs("ssd_scan", grad=True)
    tensors = [t for t in args if isinstance(t, torch.Tensor)
               and t.requires_grad]
    g_op = torch.autograd.grad(public()[1].sum(), tensors, allow_unused=True)
    g_plain = torch.autograd.grad(plain()[1].sum(), tensors,
                                  allow_unused=True)
    for a, b in zip(g_op, g_plain):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *tensors):
        return self.fn(*tensors)


@pytest.mark.parametrize("name", NAMES)
def test_export_traces_the_op_with_fake_tensors(name):
    """torch.export traces each public function to a graph that calls its
    op (the fake kernel gives the shapes; no kernel runs), and the
    exported module gives the eager result bit for bit."""
    args, _, _ = _inputs(name)
    tensors = [t for t in args if isinstance(t, torch.Tensor)]
    rest = [a for a in args if not isinstance(a, torch.Tensor)]
    op = getattr(OPS, name)

    def call(*ts):
        return op(*ts, *rest)

    program = torch.export.export(_Call(call), tuple(tensors), strict=False)
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert op.default in targets
    got, want = program.module()(*tensors), call(*tensors)
    for g_, w in zip(*(t if isinstance(t, tuple) else (t,)
                       for t in (got, want))):
        assert torch.equal(g_, w)


@pytest.mark.parametrize("name", TRANSPORT)
def test_export_keeps_the_transport_op(name):
    """torch.export keeps the transport op as a node though nothing reads
    its result, and the exported module mutates its inputs as the eager
    op does (same words of the queue's state, or the same output)."""
    args = _transport_args(name)
    op = getattr(OPS, name)
    if name == "rpc_post":
        anchor, sid, _, in_slots, words, outputs, out_slots = args
        inputs = (anchor, outputs[0])

        def call(x, out):
            op(x, sid, [x], in_slots, words, [out], out_slots)
            return x + 0
    else:
        at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        inputs = tuple(args[i] for i in at)

        def call(*ts):
            full = list(args)
            for i, t in zip(at, ts):
                full[i] = t
            op(*full)
            return ts[0] + 0

    eager = [t.clone() for t in inputs]
    exported = [t.clone() for t in inputs]
    program = torch.export.export(_Call(call), tuple(exported),
                                  strict=False)
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(op.default) == 1
    call(*eager)
    program.module()(*exported)
    assert not all(torch.equal(a, b) for a, b in zip(eager, inputs))
    for a, b in zip(eager, exported):
        assert torch.equal(a, b)


def test_ops_dispatch_by_device():
    """Dispatch is by device: the op has a CPU kernel (the plain version)
    and a CUDA kernel (the launch); a meta tensor takes the fake kernel,
    for shapes only."""
    q = torch.randn(1, 2, 16, device="meta")
    k = torch.randn(1, 4, 1, 16, device="meta")
    out = OPS.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32,
                                                   device="meta"), None, None)
    assert out.device.type == "meta" and out.shape == q.shape
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            OPS.decode_attention.default.name(), key)
