from repro_torch.data.pipeline import SyntheticLM, make_synthetic_batch

__all__ = ["SyntheticLM", "make_synthetic_batch"]
