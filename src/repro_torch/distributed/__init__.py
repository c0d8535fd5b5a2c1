"""Mesh-aware collectives (the JAX package's ``repro/distributed``) on
``torch.distributed``.  The sharding rules of ``distributed/sharding.py``
are ROADMAP queue 1, item 5.5."""
from repro_torch.distributed.collectives import (
    all_to_all_tokens, barrier, broadcast_from_first, gather_blocks,
    global_norm_sq, hierarchical_psum, team_index)

__all__ = ["all_to_all_tokens", "barrier", "broadcast_from_first",
           "gather_blocks", "global_norm_sq", "hierarchical_psum",
           "team_index"]
