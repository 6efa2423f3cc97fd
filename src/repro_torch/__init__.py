"""repro_torch: the aggregation service of ``repro`` in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

Import-light: importing the package or any subpackage builds, loads and
starts nothing. Entry points run on the card unless the caller passes
``device="cpu"`` (``repro_torch.utils.device.resolve_device``).

Subpackages mirror ``repro``:
    repro_torch.core     — the aggregation service (store, monitor,
                           planner, local engine, fusions, compression)
    repro_torch.kernels  — CUDA kernels (``csrc/``) with their plain
                           PyTorch versions
    repro_torch.configs  — the paper's Table-I update sizes
    repro_torch.launch   — ``python -m repro_torch.launch.aggregate``
    repro_torch.convert  — carry numpy state of ``repro`` across
"""
__version__ = "0.1.0"
