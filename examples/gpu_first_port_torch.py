"""The paper's workflow, end to end, on the PyTorch/CUDA port: take a
"legacy" single-team program, run it unmodified under expansion, and use
the measurement to decide whether a manual port pays off (GPU First §5.3).
The program of ``gpu_first_port.py`` (the JAX package's), through
``repro_torch.core``.

The program: a Monte-Carlo cross-section lookup loop (XSBench-style)
written in single-team semantics — a sequential loop over lookups with
library calls (rand from the device libc, a host RPC for "file output").
Its data comes from the port's threefry, bit-exact with
``jax.random.uniform``, so its inputs are the JAX example's.

  PYTHONPATH=src python examples/gpu_first_port_torch.py [--device cpu]

``--device`` defaults to ``cuda`` and refuses to run without a card;
``--device cpu`` runs the plain versions.  ``--save PATH`` writes the
three result vectors and the RPC count to an ``.npz``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (READ, Ref, ShapeDtype, effects_barrier,
                              host_rpc, parallel_for, rpc_stats, serial_for)
from repro_torch.core.libc import key_uniform, rand_init, rand_uniform

N_LOOKUPS = 2048
N_GRID = 512
N_NUCLIDES = 32


@host_rpc(result_shape=ShapeDtype((), torch.int32))
def write_results(buf):
    """Host-only library function (think fwrite): receives the result block."""
    return np.int32(len(buf))


def make_data(n_grid=N_GRID, n_nuclides=N_NUCLIDES, *, device):
    egrid = torch.sort(key_uniform(0, (n_grid,), device=device)).values
    xs = key_uniform(1, (n_nuclides, n_grid), device=device)
    return egrid, xs


def energies(n_lookups=N_LOOKUPS, *, device):
    """The lookups' energies from the "legacy" RNG of the device libc."""
    _, e = rand_uniform(rand_init(42, device=device), (n_lookups,))
    return e


def lookup(e, egrid, xs):
    """One lookup: interpolate every nuclide's cross section at energy e
    and sum.  It reads the grid with ``index_select``, since indexing with
    a 0-d tensor reads its value back to the host."""
    idx = (torch.searchsorted(egrid, e) - 1).clamp(0, egrid.shape[0] - 2)
    at = torch.stack([idx, idx + 1])
    lo, hi = egrid.index_select(0, at)
    x0, x1 = xs.index_select(1, at).unbind(1)
    f = (e - lo) / (hi - lo).clamp(min=1e-9)
    return (x0 + f * (x1 - x0)).sum()


def manual_port(e, egrid, xs):
    """The manual port you would write if the numbers say "go": the same
    lookup written for the whole vector of energies at once."""
    idx = (torch.searchsorted(egrid, e) - 1).clamp(0, egrid.shape[0] - 2)
    lo, hi = egrid[idx], egrid[idx + 1]
    f = (e - lo) / (hi - lo).clamp(min=1e-9)
    x0, x1 = xs[:, idx], xs[:, idx + 1]
    return (x0 + f * (x1 - x0)).sum(0)


def _timed(fn, device):
    """(result, seconds) of ``fn()``, waiting for the device."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def run(n_lookups=N_LOOKUPS, n_grid=N_GRID, n_nuclides=N_NUCLIDES, *,
        device, serial_lookups=None):
    """The three executions of the program.  ``serial_lookups`` runs the
    single-team loop on the first that many lookups only (its time is then
    per lookup times all of them).  Returns the results, the seconds of
    each and the RPC's answer."""
    device = torch.device(device)
    egrid, xs = make_data(n_grid, n_nuclides, device=device)
    e = energies(n_lookups, device=device)
    n_serial = n_lookups if serial_lookups is None else serial_lookups

    def body(i, e):
        return lookup(e[i], egrid, xs)

    # --- 1. run the program AS IS (single-team semantics) ------------------
    r1, t1 = _timed(lambda: serial_for(body, n_serial, e), device)
    # --- 2. GPU First: expand the parallel region, zero source changes -----
    parallel_for(body, n_lookups, e)                      # warm up
    r2, t2 = _timed(lambda: parallel_for(body, n_lookups, e), device)
    # --- 3. the manual port ------------------------------------------------
    manual_port(e, egrid, xs)
    r3, t3 = _timed(lambda: manual_port(e, egrid, xs), device)
    # --- 4. the host-only library call still works, via generated RPC ------
    n, _ = write_results.rpc(Ref(r2, access=READ))
    effects_barrier()
    return {"serial": r1, "expanded": r2, "manual": r3,
            "t_legacy": t1 * n_lookups / n_serial, "t_serial_run": t1,
            "n_serial": n_serial, "t_expanded": t2, "t_manual": t3,
            "rpc_wrote": int(n)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card; "
                           "pass --device cpu to run its plain versions")
    out = run(device=args.device)
    r1, r2, r3 = (out[k].cpu().numpy() for k in
                  ("serial", "expanded", "manual"))
    np.testing.assert_allclose(r1, r2, rtol=1e-5)
    np.testing.assert_allclose(r1, r3, rtol=1e-5)
    calls = rpc_stats("write_results")["calls"]
    if args.save:
        np.savez(args.save, serial=r1, expanded=r2, manual=r3,
                 rpc_calls=calls, rpc_wrote=out["rpc_wrote"])
    t_legacy, t_expanded, t_manual = (out[k] for k in
                                      ("t_legacy", "t_expanded", "t_manual"))
    print(f"[port] RPC wrote {out['rpc_wrote']} results to the 'file'")
    print(f"[port] single-team (legacy):   {t_legacy*1e3:8.2f} ms")
    print(f"[port] expanded (GPU First):   {t_expanded*1e3:8.2f} ms  "
          f"({t_legacy/t_expanded:.2f}x)")
    print(f"[port] manual port:            {t_manual*1e3:8.2f} ms  "
          f"(prediction error "
          f"{abs(t_expanded-t_manual)/t_manual*100:.1f}%)")
    verdict = "PORT" if t_expanded < t_legacy * 0.8 else "DON'T PORT"
    print(f"[port] verdict from GPU First measurement: {verdict}")


if __name__ == "__main__":
    main()
