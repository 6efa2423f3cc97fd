"""Model stack: the dense decoder family so far, as ``nn.Module``s whose
attention runs through the port's flash kernels on the card."""
from repro_torch.models.base import Model
from repro_torch.models.registry import build_model

__all__ = ["Model", "build_model"]
