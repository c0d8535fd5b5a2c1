"""Analysis layer of the port: so far the runtime sanitizer's heap side
(:mod:`repro_torch.analysis.sanitize`).  The static analyzer over captured
events (JAX's ``repro/analysis``) is ROADMAP item 5."""
from repro_torch.analysis.sanitize import (CANARY, POISON, poison_free,
                                           reset_sanitize_stats,
                                           sanitize_stats)

__all__ = ["CANARY", "POISON", "poison_free", "reset_sanitize_stats",
           "sanitize_stats"]
