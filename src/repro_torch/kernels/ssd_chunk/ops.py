"""Public wrapper for the SSD chunked-scan kernel: ``ssd_scan`` over
(B, T, H, ...) tensors, as ``repro/kernels/ssd_chunk/ops.py`` names it.
The kernel takes the whole scan (B and C shared across heads, chunks
carried inside a block), so no lane layout is built here."""
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk as ssd_scan

__all__ = ["ssd_scan"]
