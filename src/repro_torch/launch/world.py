"""Process worlds on the CPU: run one program as every rank of a ``gloo``
world on this host (the mesh tests' harness, and Fig. 6's mesh section
on the CPU).

:func:`run_world` starts ``world_size`` fresh Python processes, each of
which joins rank ``RANK`` of a world whose ``FileStore`` lives in a
directory of the caller's (never a fixed port, so worlds run side by side)
with :mod:`~repro_torch.launch.mesh`'s collective timeout, runs the code,
and reports with ``report(obj)`` (one JSON line).  A rank that fails
kills the others at once, and the world is killed at :data:`DEADLINE_S`,
so a rank that dies cannot leave its peers waiting in a collective.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, List

from repro_torch.launch.mesh import TIMEOUT_S

PREFIX = "WORLD_REPORT "
#: Seconds a world may run: twice a collective's wait, so a rank stuck in
#: a collective fails with the collective's own error first.
DEADLINE_S = 2 * TIMEOUT_S

_PRELUDE = f"""
import json, sys
RANK, WORLD, STORE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
def report(obj):
    print({PREFIX!r} + json.dumps(obj), flush=True)
from repro_torch.launch.mesh import close_world, init_world
init_world(RANK, WORLD, store_path=STORE, device="cpu")
"""

_EPILOGUE = """
close_world()
"""


def _src() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_world(code: str, world_size: int, workdir: str) -> List[Any]:
    """Run ``code`` as every rank of a world of ``world_size`` on the CPU
    (``RANK``, ``WORLD`` and ``report`` are defined for it, the world is
    joined before it runs and left after).  Returns each rank's reports,
    a list a rank, in rank order.  Raises, with the failing rank's
    output, when a rank exits with an error or the world outlives
    :data:`DEADLINE_S`."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store_{world_size}_{time.time_ns()}")
    penv = dict(os.environ)
    penv["PYTHONPATH"] = os.pathsep.join(
        [_src()] + [p for p in [penv.get("PYTHONPATH")] if p])
    penv.setdefault("OMP_NUM_THREADS", "1")
    program = _PRELUDE + code + _EPILOGUE
    procs = []
    outs = []
    for rank in range(world_size):
        out = open(os.path.join(workdir, f"rank{rank}.log"), "w+")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", program, str(rank), str(world_size),
             store],
            stdout=out, stderr=subprocess.STDOUT, env=penv))
    t0 = time.monotonic()
    failed, culprit = None, 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                culprit = bad[0]
                failed = f"rank {culprit} exited with {codes[culprit]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() - t0 > DEADLINE_S:
                failed = f"the world outlived its {DEADLINE_S} s deadline"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = []
    for out in outs:
        out.seek(0)
        logs.append(out.read())
        out.close()
    if failed:
        raise RuntimeError(f"{failed}; rank {culprit}'s output:\n"
                           f"{logs[culprit][-6000:]}")
    return [[json.loads(line[len(PREFIX):]) for line in log.splitlines()
             if line.startswith(PREFIX)] for log in logs]
