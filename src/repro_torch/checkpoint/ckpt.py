"""Adaptive-controller state <-> a JSON sidecar, as
``repro.checkpoint.ckpt`` writes it.

``save_controller_state`` / ``load_controller_state`` persist an
:class:`repro_torch.core.adaptive.AdaptiveController`'s learned arrival
curves (per-tenant models + the cross-tenant prior) next to the model
checkpoint, so an aggregator restart resumes with its learned gates
instead of re-learning from static-timeout rounds. The file is the
controller's ``state_dict`` as plain JSON at ``<path>.controller.json``,
the same name and keys as the reference package's, so either package
loads what the other wrote.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict


def _controller_path(path: str) -> str:
    """Canonical on-disk name: ``<path>.controller.json`` (``path`` may
    be the model checkpoint path — the controller state lands beside
    it)."""
    if path.endswith(".controller.json"):
        return path
    return path.removesuffix(".npz") + ".controller.json"


def save_controller_state(path: str, controller: Any) -> str:
    """Persist an ``AdaptiveController`` (or a raw ``state_dict``) as
    JSON at ``<path>.controller.json``. Returns the written path."""
    state = (
        controller.state_dict()
        if hasattr(controller, "state_dict") else controller
    )
    out = _controller_path(path)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(state, f, indent=1)
    return out


def load_controller_state(path: str, controller: Any = None) -> Dict:
    """Load controller state saved by :func:`save_controller_state` (by
    either package). Returns the raw state dict; with ``controller``
    given (anything exposing ``load_state_dict``), the state is also
    restored into it."""
    with open(_controller_path(path)) as f:
        state = json.load(f)
    if controller is not None:
        controller.load_state_dict(state)
    return state
