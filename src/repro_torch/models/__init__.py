"""Model stack: the dense decoder family and the Mamba2 / shared-attention
hybrid so far, as ``nn.Module``s whose attention and SSD scan run through
the port's kernels on the card."""
from repro_torch.models.base import Model
from repro_torch.models.registry import build_model

__all__ = ["Model", "build_model"]
