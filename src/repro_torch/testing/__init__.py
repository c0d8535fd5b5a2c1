"""Deterministic testing seams for the port's GPU First runtime.

:mod:`repro_torch.testing.faults` — seeded fault plans injected at the RPC
drain (see :func:`repro_torch.core.rpc.set_fault_injector`).
"""
from repro_torch.testing.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    InjectedFault,
    inject,
)
