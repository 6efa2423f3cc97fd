"""Public wrapper for the flash-attention kernel."""
from repro_torch.kernels.flash_attention.kernel import flash_attention

__all__ = ["flash_attention"]
