"""The port's model zoo: dense, moe, vlm, ssm, hybrid and encdec LMs."""
from repro_torch.models.model_zoo import Model, build_model, input_specs

__all__ = ["Model", "build_model", "input_specs"]
