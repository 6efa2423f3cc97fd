"""Checkpointing of the adaptive controller's learned state (the model
pytree's ``save_pytree`` / ``load_pytree`` come with the training
slice)."""
from repro_torch.checkpoint.ckpt import (
    load_controller_state,
    save_controller_state,
)

__all__ = ["save_controller_state", "load_controller_state"]
