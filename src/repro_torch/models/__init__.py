"""The port's model zoo: dense, moe, ssm and hybrid decoder LMs."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
