"""Model stack: the decoders (dense, MoE, the vision-language backbone),
the Mamba2 / shared-attention hybrid, the encoder-decoder and the xLSTM,
as ``nn.Module``s whose attention and SSD scan run through the port's
kernels on the card (the xLSTM's cells, like the reference's, through
none)."""
from repro_torch.models.base import Model
from repro_torch.models.registry import build_model

__all__ = ["Model", "build_model"]
