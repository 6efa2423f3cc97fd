"""Paper Table I: the CNN model-update suite used in every aggregation
benchmark (CNN4.6 ... CNN956, ResNet50, VGG16).

The aggregation service never runs these models — it fuses their *parameter
pytrees* (exactly as IBMFL fuses lists of ndarrays). So each entry here is a
pytree SPEC whose fp32 byte size matches the paper's Table I, with
conv/dense-shaped leaves so the pytree structure is realistic (many small
tensors + a few big ones), which stresses the flatten/partition path the
same way the paper's pickled keras weights stress Spark's binaryFiles.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class UpdateSpec:
    """A federated model-update workload (the paper's w_s)."""

    name: str
    target_mb: float
    leaves: Tuple[Tuple[str, Tuple[int, ...]], ...]

    @property
    def num_params(self) -> int:
        return int(sum(np.prod(s) for _, s in self.leaves))

    @property
    def bytes_fp32(self) -> int:
        return self.num_params * 4


def _cnn_spec(name: str, target_mb: float, convs: List[int], dense: List[int],
              in_ch: int = 3, img: int = 32, classes: int = 10) -> UpdateSpec:
    """Build conv+dense leaf shapes, then pad with a trailing blob so the
    fp32 total matches the paper's reported MB (decimal MB, as sizes of
    pickled weight files are reported)."""
    leaves: List[Tuple[str, Tuple[int, ...]]] = []
    ch = in_ch
    spatial = img
    for i, c in enumerate(convs):
        leaves.append((f"conv{i}/w", (3, 3, ch, c)))
        leaves.append((f"conv{i}/b", (c,)))
        ch = c
        if i % 2 == 1 and spatial > 4:
            spatial //= 2
    flat = ch * max(spatial // 2, 1) ** 2
    prev = flat
    for i, d in enumerate(dense):
        leaves.append((f"dense{i}/w", (prev, d)))
        leaves.append((f"dense{i}/b", (d,)))
        prev = d
    leaves.append(("head/w", (prev, classes)))
    leaves.append(("head/b", (classes,)))
    target_params = int(target_mb * 1e6 / 4)

    def total() -> int:
        return int(sum(np.prod(s) for _, s in leaves))

    # Shrink the largest leaves row-by-row until we are at or under target,
    # then pad with a trailing blob to hit the byte count exactly.
    while total() > target_params:
        over = total() - target_params
        idx = max(range(len(leaves)), key=lambda i: np.prod(leaves[i][1]))
        nm, shape = leaves[idx]
        row = int(np.prod(shape[1:])) or 1
        drop_rows = min(shape[0] - 1, max(1, over // row))
        if shape[0] <= 1 or drop_rows < 1:
            leaves.pop(idx)
            continue
        leaves[idx] = (nm, (shape[0] - drop_rows,) + shape[1:])
        if shape[0] - drop_rows == shape[0]:  # no progress
            leaves.pop(idx)
    pad = target_params - total()
    if pad > 0:
        leaves.append(("pad/blob", (pad,)))
    return UpdateSpec(name=name, target_mb=target_mb, leaves=tuple(leaves))


# Table I of the paper. Conv widths are the paper's; dense layer is 128-wide.
CNN_SUITE: Dict[str, UpdateSpec] = {
    "CNN4.6": _cnn_spec("CNN4.6", 4.6, [32, 64], [128]),
    "CNN73": _cnn_spec("CNN73", 73.0, [32, 256, 512, 1024], [128]),
    "CNN179": _cnn_spec("CNN179", 179.0, [32, 512, 1024, 1900], [128]),
    "CNN239": _cnn_spec("CNN239", 239.0, [32, 1024, 1900, 2400], [128]),
    "CNN478": _cnn_spec("CNN478", 478.0, [32, 32, 1024, 1024, 1900, 1900, 2400, 2400], [128, 128]),
    "CNN717": _cnn_spec("CNN717", 717.0, [32] * 3 + [1024] * 3 + [1900] * 3 + [2400] * 3, [128] * 3),
    "CNN956": _cnn_spec("CNN956", 956.0, [32, 32, 1024, 1024, 1900, 1900, 2400, 2400], [128] * 4),
    "Resnet50": _cnn_spec("Resnet50", 91.0, [64, 256, 512, 1024, 2048], [1000]),
    "VGG16": _cnn_spec("VGG16", 528.0, [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512], [4096, 4096], classes=1000),
}
