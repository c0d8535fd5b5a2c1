from repro_torch.serving.kvcache import PagedKV, paged_cache_init
from repro_torch.serving.engine import ServingEngine

__all__ = ["PagedKV", "paged_cache_init", "ServingEngine"]
