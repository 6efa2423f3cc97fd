"""Public wrapper for the flash-decode kernel."""
from repro_torch.kernels.flash_decode.kernel import flash_decode

__all__ = ["flash_decode"]
