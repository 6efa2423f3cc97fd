"""Public wrapper for the SSD chunked-scan kernels: ``ssd_scan`` over
(B, T, H, ...) tensors, as ``repro/kernels/ssd_chunk/ops.py`` names it.
The kernels take the whole scan (B and C shared across heads, the state
handed from chunk to chunk on the card), so no lane layout is built
here."""
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk as ssd_scan

__all__ = ["ssd_scan"]
