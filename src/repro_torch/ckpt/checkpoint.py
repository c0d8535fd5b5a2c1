"""Checkpoints through a host RPC from inside the device loop.

The JAX package's design, kept here:

* **The save is a host RPC from inside the device loop** (GPU First: the
  training program never leaves the device; persistence is a library
  call that happens to live on the host).  :meth:`CheckpointManager.
  host_hook` is an immediate :class:`~repro_torch.core.device_main.
  HostHook`: on a card its payload rides the RPC channel in stream order,
  and its host function copies the staged leaves and queues the write.
* **Async, bounded**: a writer thread services a bounded queue, so a slow
  filesystem stalls the device loop only when the queue is full
  (backpressure instead of unbounded memory).
* **Atomic manifests**: the data files land first, then
  ``manifest-<step>.json`` is renamed into place; restore picks the newest
  complete manifest, so a failure mid-write never yields a torn
  checkpoint.

The format is the JAX package's byte for byte: one ``.npy`` file a leaf,
named ``step{N}-{sha256(path)[:15]}.npy`` after its path (see
:func:`~repro_torch.tree.flatten_with_paths`), and a JSON manifest with
``step``, ``entries`` (file, shape, dtype of each path), ``time`` and an
optional ``transport`` section (an :class:`~repro_torch.core.rpc.
RpcManifest`).  A bf16 leaf is written as numpy writes an
``ml_dtypes.bfloat16`` array (descr ``'<V2'``, the raw bits; the
manifest says ``"bfloat16"``) and read back by the manifest's dtype; a
Python int (the port's ``OptState.step``) as a 0-d int32 file, as JAX
writes its int32 step.  Two differences from the JAX package:

* the port keeps layers as a list of per-layer dicts, so its own trees
  have keys such as ``values/layers/0/wq`` where JAX's stacked trees have
  ``values/layers/wq`` (:mod:`repro_torch.convert` turns one layout into
  the other);
* the JAX package cannot restore a bf16 leaf (``np.load`` gives raw
  ``V2`` records, which numpy does not cast); the port can.

On a mesh, as JAX's "elastic restore": the manifest keeps full (logical)
shapes, and :func:`restore_checkpoint` with ``shardings=`` reads each
rank's block of each leaf through a memory map of its ``.npy``, so a
checkpoint saved by a world of any size restores on a world of any other
(a pure resharding).  :meth:`CheckpointManager.mesh_save` saves from a
sharded run's step: the state is all-gathered to full leaves and the
first rank alone queues their write, so the files are the ones a run
without a mesh writes.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_main import HostHook
from repro_torch.core.rpc import RpcManifest, ShapeDtype, _torch_dtype
from repro_torch.distributed.sharding import block
from repro_torch.models.model_zoo import resolve_device
from repro_torch.tree import flatten_with_paths, tree_map, unflatten

_BF16 = "bfloat16"

#: One leaf ready to write: (path, host array, the manifest's dtype name);
#: a bf16 leaf's array holds its raw bits as uint16.
Entry = Tuple[str, np.ndarray, str]


def _dtype_name(leaf) -> str:
    """The manifest's dtype name of a leaf (a Python int is JAX's int32
    step)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        return "int32"
    return str(np.asarray(leaf).dtype)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a fresh host array; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        return a.view(np.uint16) if leaf.dtype == torch.bfloat16 else a
    if isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        return np.asarray(np.int32(leaf))
    a = np.array(leaf)
    return a.view(np.uint16) if a.dtype.name == _BF16 else a


def _entries(tree: Any) -> List[Entry]:
    return [(key, _host_array(leaf), _dtype_name(leaf))
            for key, leaf in flatten_with_paths(tree).items()]


def _file_name(step: int, key: str) -> str:
    digest = hashlib.sha256(key.encode("utf-8")).hexdigest()[:15]
    return f"step{step}-{digest}.npy"


def _write_npy(path: str, arr: np.ndarray, dtype_name: str) -> None:
    if dtype_name != _BF16:
        np.save(path, arr)
        return
    # what np.save writes for an ml_dtypes.bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr, dtype="<u2").tobytes())


def _write(directory: str, step: int, entries: List[Entry],
           transport: Optional[RpcManifest] = None) -> int:
    """Write the data files, then rename the manifest into place.  Returns
    the bytes of data written."""
    os.makedirs(directory, exist_ok=True)
    files, nbytes = {}, 0
    for key, arr, dtype_name in entries:
        fname = _file_name(step, key)
        _write_npy(os.path.join(directory, fname), arr, dtype_name)
        files[key] = {"file": fname, "shape": list(arr.shape),
                      "dtype": dtype_name}
        nbytes += arr.nbytes
    manifest = {"step": step, "entries": files, "time": time.time()}
    if transport is not None:
        manifest["transport"] = json.loads(transport.to_json())
    tmp = os.path.join(directory, f".manifest-{step}.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(directory, f"manifest-{step}.json"))
    return nbytes


def save_checkpoint(directory: str, step: int, tree: Any,
                    transport: Optional[RpcManifest] = None) -> None:
    """Synchronous save of ``tree`` (tensors on any device, numpy arrays,
    Python ints) with an atomic manifest.  ``transport`` embeds the RPC
    transport's durable identity as the manifest's ``"transport"``
    section (:func:`load_transport` reads it back)."""
    _write(directory, step, _entries(tree), transport)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete manifest's step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for n in os.listdir(directory):
        if n.startswith("manifest-") and n.endswith(".json"):
            try:
                steps.append(int(n[len("manifest-"):-len(".json")]))
            except ValueError:
                pass
    return max(steps) if steps else None


def read_manifest(directory: str, step: Optional[int] = None
                  ) -> Tuple[int, dict]:
    """``(step, manifest)`` of ``step``, by default the newest."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    with open(os.path.join(directory, f"manifest-{step}.json")) as f:
        return step, json.load(f)


def load_transport(directory: str,
                   step: Optional[int] = None) -> Optional[RpcManifest]:
    """The checkpoint's transport section as an :class:`RpcManifest`, or
    None when it was written without one."""
    _, manifest = read_manifest(directory, step)
    section = manifest.get("transport")
    if section is None:
        return None
    return RpcManifest.from_json(json.dumps(section))


def _load_leaf(directory: str, ent: dict, want, device,
               sharding=None) -> Any:
    arr = np.load(os.path.join(directory, ent["file"]), mmap_mode="r")
    if list(arr.shape) != list(want.shape if hasattr(want, "shape")
                               else ()):
        raise ValueError(f"checkpoint leaf {ent['file']} has shape "
                         f"{list(arr.shape)}, the tree wants "
                         f"{list(getattr(want, 'shape', ()))}")
    if isinstance(want, int) and not isinstance(want, bool):
        return int(arr)
    if sharding is not None:
        arr = block(arr, sharding)
    if ent["dtype"] == _BF16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(want, torch.Tensor):
        device = want.device
    return t.to(device=device, dtype=_torch_dtype(want.dtype))


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       shardings: Any = None, device="cuda"
                       ) -> Tuple[int, Any]:
    """Restore into the structure of ``like``: a tree of tensors (each
    restored leaf lands on its tensor's device), of
    :class:`~repro_torch.core.rpc.ShapeDtype` stand-ins (on ``device``,
    the card unless the caller asks for the CPU) or of Python ints.
    ``shardings`` (the same structure, ``distributed.sharding.
    NamedSharding`` leaves, or None for a leaf restored whole) gives this
    rank its block of each leaf, read through a memory map; ``like``
    keeps the full shapes.  Returns ``(step, tree)``."""
    step, manifest = read_manifest(directory, step)
    flat_like = flatten_with_paths(like)
    flat_sh = flatten_with_paths(shardings) if shardings is not None else {}
    if any(isinstance(w, ShapeDtype) for w in flat_like.values()):
        device = resolve_device(device)
    loaded = [_load_leaf(directory, manifest["entries"][key], want, device,
                         flat_sh.get(key))
              for key, want in flat_like.items()]
    return step, unflatten(like, loaded)


class CheckpointManager:
    """Async bounded-queue checkpointing and a device-loop hook factory.

    ``writes`` lists ``(step, seconds, bytes)`` of each finished save (the
    writer thread's time), ``hook_s`` ``(step, seconds)`` of each firing
    of :meth:`host_hook`'s host function (the copy out of the transport
    and the wait for room in the queue: on a card the device waits that
    long) or of :meth:`mesh_save` (the gather, the wait for the device
    and the copy); ``errors`` the exceptions of failed saves."""

    def __init__(self, directory: str, *, queue_depth: int = 2):
        self.directory = directory
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self.errors: list = []
        self.writes: List[Tuple[int, float, int]] = []
        self.hook_s: List[Tuple[int, float]] = []
        self._dtypes: Any = None
        self._writer = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._writer.start()

    def _run(self) -> None:
        while True:
            item = self.queue.get()
            try:
                if item is None:
                    return
                step, entries = item
                t0 = time.perf_counter()
                nbytes = _write(self.directory, step, entries)
                self.writes.append((step, time.perf_counter() - t0, nbytes))
            except Exception as e:   # kept for the caller, the thread goes on
                self.errors.append(e)
            finally:
                self.queue.task_done()

    def submit(self, step: int, tree: Any) -> None:
        """Copy ``tree`` to host memory and queue its write (blocks only
        while the queue is full)."""
        self.queue.put((int(step), _entries(tree)))

    def wait(self) -> None:
        """Return once every submitted save is written."""
        self.queue.join()

    def close(self) -> None:
        self.queue.put(None)
        self._writer.join(timeout=60)

    # -- device-loop integration --------------------------------------------
    def host_hook(self, every: int, extract) -> HostHook:
        """An immediate ``HostHook`` that checkpoints ``extract(step,
        state)`` every ``every`` steps from inside the device loop.  The
        transport stages bf16 leaves as float32 (exact) and 64-bit ones as
        32-bit; the host function writes each leaf in the dtype it had on
        the device."""
        def host_fn(step, *arrays):
            t0 = time.perf_counter()
            entries = []
            for (key, dtype_name), a in zip(self._dtypes, arrays):
                a = np.asarray(a)
                if dtype_name == _BF16:
                    a = (a.astype(np.float32).view(np.uint32)
                         >> 16).astype(np.uint16)
                else:
                    a = np.array(a, dtype=dtype_name)
                entries.append((key, a, dtype_name))
            self.queue.put((int(step), entries))
            self.hook_s.append((int(step), time.perf_counter() - t0))

        def extract_and_remember(step, state):
            payload = extract(step, state)
            self._dtypes = list(flatten_with_paths(
                tree_map(_dtype_name, payload)).items())
            return payload

        return HostHook(every=every, extract=extract_and_remember,
                        host_fn=host_fn)

    def mesh_save(self, step: int, tree: Any, gather, first: bool
                  ) -> None:
        """The save of a run under ``device_run(mesh=)``, called from its
        step on every rank: ``gather(tree)`` (a collective: full leaves),
        then, on the first rank alone (``first``), :meth:`submit`.  Its
        seconds go to ``hook_s``.

        The save does not ride the run's sharded queue, which drains only
        at the program boundary (JAX's rule for callbacks in a
        partitioned region): a save there would land when the run ends
        and the queue would hold every one.  So the first rank copies the
        full leaves to the host at the save's step (the host waits for
        the device there) and the writer thread writes them while the
        loop goes on, as in a run without a mesh."""
        t0 = time.perf_counter()
        full = gather(tree)
        if first:
            self.submit(step, full)
            self.hook_s.append((int(step), time.perf_counter() - t0))
