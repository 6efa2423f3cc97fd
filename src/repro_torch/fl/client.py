"""FL client: local training on private data, emits a model update, as
``repro.fl.client``.

Update semantics (IBMFL-compatible):
  * fedavg/iteravg/robust fusions — the update is the client's POST-
    training weights (the paper aggregates weights, Eq. (1)).
  * gradavg/fedavgm/fedadam — the update is the weight DELTA (pseudo-
    gradient) after local steps, ``new.f32 - old.f32``.

Parameters travel as a ``state_dict``-keyed tree of tensors. A step
evaluates ``model.loss`` at the client's tree with
``torch.func.functional_call`` on leaf tensors that require grad, so the
served module's own parameters (``requires_grad=False``) are never
touched; the optimizer state is made fresh each round, as in the
reference. On the card the decoder's attention runs the forward and
backward flash-attention kernels.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.models.base import Model
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.utils.pytree import tree_map

PyTree = Any


def batch_to_device(batch: Dict[str, Any], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy token arrays) as int64 tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device=device,
                                                  dtype=torch.int64)
            for k, v in batch.items()}


@dataclasses.dataclass(eq=False)
class Client:
    client_id: int
    model: Model
    optimizer: Optimizer
    local_steps: int = 1
    clip_norm: Optional[float] = None
    send_delta: bool = False     # True for gradavg-family fusions

    def _step(self, params, opt_state, batch, step):
        leaves = collections.OrderedDict(
            (k, v.detach().requires_grad_(True)) for k, v in params.items())
        loss, _ = functional_call(self.model, leaves, (batch,))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = collections.OrderedDict(zip(leaves, grads))
        del leaves
        with torch.no_grad():
            if self.clip_norm:
                grads = clip_by_global_norm(grads, self.clip_norm)
            ups, opt_state = self.optimizer.update(grads, opt_state, step,
                                                   params)
            return apply_updates(params, ups), opt_state, loss.detach()

    def train_round(
        self, global_params: PyTree, batch_fn: Callable[[int], Dict],
        round_idx: int,
    ) -> Tuple[PyTree, float]:
        """Runs ``local_steps`` steps from the global params (a
        ``state_dict``-keyed tree). Returns (update, last_loss)."""
        device = self.model.device
        params = global_params
        opt_state = self.optimizer.init(params)
        loss = float("inf")
        for s in range(self.local_steps):
            batch = batch_to_device(batch_fn(s), device)
            params, opt_state, loss = self._step(params, opt_state, batch, s)
        if self.send_delta:
            with torch.no_grad():
                update = tree_map(lambda new, old: new.float() - old.float(),
                                  params, global_params)
        else:
            update = params
        return update, float(loss)
