"""Mesh-aware collectives (the JAX package's ``repro/distributed``) on
``torch.distributed``.  The logical-axis sharding rules are
``repro_torch.distributed.sharding`` (imported by name: it builds on
``core/expand.py``, which imports these collectives)."""
from repro_torch.distributed.collectives import (
    all_to_all_tokens, barrier, broadcast_from_first, gather_blocks,
    global_norm_sq, hierarchical_psum, team_index)

__all__ = ["all_to_all_tokens", "barrier", "broadcast_from_first",
           "gather_blocks", "global_norm_sq", "hierarchical_psum",
           "team_index"]
