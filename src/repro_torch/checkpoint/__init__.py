"""Checkpointing: trees of tensors <-> ``.npz`` (``save_pytree`` /
``load_pytree``), and the adaptive controller's learned state <-> JSON,
in the reference package's formats."""
from repro_torch.checkpoint.ckpt import (
    load_controller_state,
    load_pytree,
    save_controller_state,
    save_pytree,
)

__all__ = ["save_pytree", "load_pytree", "save_controller_state",
           "load_controller_state"]
