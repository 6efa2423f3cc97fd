"""Carry state of the JAX package (``repro``) into this one.

What crosses between the two packages is data — a streamed round's
reducer carry, a server optimizer's state, the pytree an update is
shaped like, and a model's parameters (the decoders', dense, MoE or
vision-language, Zamba2's, the encoder-decoder's and the xLSTM's).
Each comes over as numpy arrays, which is how a ``repro`` caller holds
them (``np.asarray`` of its leaves; bf16 leaves as ``ml_dtypes.bfloat16``
arrays, read as raw 16-bit words), so nothing here imports JAX.
"""
from __future__ import annotations

import collections
from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fusion.serveropt import FedAdam, FedAvgM
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.dtypes import to_device
from repro_torch.utils.pytree import PyTree, tree_leaves, tree_unflatten


def _f32(x, device: torch.device) -> torch.Tensor:
    return to_device(np.asarray(x, np.float32), device)


def carry_from_numpy(acc_state, device: DeviceLike = None
                     ) -> Tuple[torch.Tensor, ...]:
    """A ``repro`` ``StreamReport.acc_state`` (a tuple of ndarrays: the
    (P,) weighted sum and the weight total for the sum family; the sum,
    count and ascending (K, P) top / bottom buffers, +/-inf sentinels
    included, for the order-statistic carve) as this package's carry,
    for ``LocalEngine.fuse_stream(init=...)``. A JAX caller's Zeno
    validation gradient needs no helper: ``Zeno.with_val_grad`` and
    ``aggregate(val_grad=)`` take the ndarray."""
    dev = resolve_device(device)
    return tuple(_f32(leaf, dev) for leaf in acc_state)


def load_server_state(fusion, arrays: Mapping[str, object],
                      device: DeviceLike = None) -> None:
    """Set a server optimizer's state from ``repro``'s: FedAvgM takes
    ``{"velocity": (P,)}``; FedAdam takes ``{"m": (P,), "v": (P,),
    "t": step count}`` (its ``_velocity`` / ``_m``, ``_v``, ``_t``)."""
    dev = resolve_device(device)
    if isinstance(fusion, FedAvgM):
        fusion._velocity = _f32(arrays["velocity"], dev)
    elif isinstance(fusion, FedAdam):
        fusion._m = _f32(arrays["m"], dev)
        fusion._v = _f32(arrays["v"], dev)
        fusion._t = int(arrays["t"])
    else:
        raise TypeError(f"{fusion.name} keeps no server state")


def tree_from_numpy(tree: PyTree, device: DeviceLike = None) -> PyTree:
    """A numpy pytree as tensors on ``device``, same structure, with every
    dict rebuilt in JAX's leaf order (sorted keys), so iterating it
    visits leaves in the order both packages flatten them."""
    dev = resolve_device(device)
    leaves = [to_device(np.asarray(leaf), dev) for leaf in tree_leaves(tree)]
    return tree_unflatten(tree, iter(leaves))


def _field(node, name: str):
    """``node.name`` for ``repro``'s NamedTuples, ``node[name]`` for dicts."""
    return node[name] if isinstance(node, Mapping) else getattr(node, name)


_MLP_FIELDS = ("w_gate", "w_up", "w_down")


def decoder_state_from_numpy(params, cfg: ModelConfig,
                             device: DeviceLike = None
                             ) -> "collections.OrderedDict[str, torch.Tensor]":
    """``repro``'s ``init_decoder`` tree (numpy leaves) as the
    ``state_dict`` of this package's ``Decoder``, on ``device``.

    The JAX layer stack is stacked on axis 0 (``jax.vmap`` init); each
    layer's slice becomes ``layers.<i>``. ``AttnParams`` /
    ``MLPParams`` arrive as NamedTuples (or dicts) whose biases are
    ``None`` without ``qkv_bias``. An MoE config's layers hold a stacked
    ``MoEParams`` (router, the expert stacks, the shared ``MLPParams`` or
    ``None``) under ``"moe"``, which become ``layers.<i>.moe.*``."""
    dev = resolve_device(device)
    dt = lambda x: to_device(np.asarray(x), dev)   # noqa: E731
    state = collections.OrderedDict()   # in Model.state_dict()'s order
    state["embed"] = dt(params["embed"])
    state["final_norm"] = dt(params["final_norm"])
    if not cfg.tie_embeddings:
        state["head"] = dt(params["head"])
    layers = params["layers"]
    attn = layers["attn"]
    names = ["wq", "wk", "wv", "wo"]
    if cfg.qkv_bias:
        names += ["bq", "bk", "bv"]
    # (key under the layer, stacked leaf) of the MLP or the MoE
    if cfg.moe is not None:
        moe = layers["moe"]
        ffn = [("moe." + name, _field(moe, name))
               for name in ("router",) + _MLP_FIELDS]
        shared = _field(moe, "shared")
        if shared is not None:
            ffn += [("moe.shared." + name, _field(shared, name))
                    for name in _MLP_FIELDS]
    else:
        ffn = [("mlp." + name, _field(layers["mlp"], name))
               for name in _MLP_FIELDS]
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        state[pre + "ln1"] = dt(np.asarray(layers["ln1"])[i])
        state[pre + "ln2"] = dt(np.asarray(layers["ln2"])[i])
        for name in names:
            state[pre + "attn." + name] = dt(np.asarray(_field(attn, name))[i])
        for key, leaf in ffn:
            state[pre + key] = dt(np.asarray(leaf)[i])
    return state


def _model_holding(state, cfg: ModelConfig, device: DeviceLike):
    from repro_torch.models.registry import build_model

    model = build_model(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model


def decoder_from_numpy(params, cfg: ModelConfig, device: DeviceLike = None):
    """A ``Decoder`` (dense, MoE, or a vision-language backbone, whose
    patches are an input and hold no parameters) holding ``repro``'s
    decoder parameters."""
    return _model_holding(decoder_state_from_numpy(params, cfg, device), cfg,
                          device)


_MAMBA2_FIELDS = ("w_in", "conv_w", "dt_bias", "a_log", "d_skip",
                  "norm_scale", "w_out")


def zamba_state_from_numpy(params, cfg: ModelConfig,
                           device: DeviceLike = None
                           ) -> "collections.OrderedDict[str, torch.Tensor]":
    """``repro``'s ``init_zamba`` tree (numpy leaves) as the
    ``state_dict`` of this package's ``Zamba``, on ``device``, keys in
    ``Model.state_dict()``'s order.

    The JAX ``params["mamba"]`` is stacked on axis 0 (``jax.vmap`` init);
    each layer's slice becomes ``mamba.<i>.norm`` and
    ``mamba.<i>.cell.<field>`` (``Mamba2Params`` arrives as a NamedTuple
    or a dict). The shared block, when the config has one, becomes
    ``shared.*``."""
    dev = resolve_device(device)
    dt = lambda x: to_device(np.asarray(x), dev)   # noqa: E731
    state = collections.OrderedDict()   # in Model.state_dict()'s order
    state["embed"] = dt(params["embed"])
    state["final_norm"] = dt(params["final_norm"])
    mamba = params["mamba"]
    cell = mamba["cell"]
    for i in range(cfg.n_layers):
        pre = f"mamba.{i}."
        state[pre + "norm"] = dt(np.asarray(mamba["norm"])[i])
        for name in _MAMBA2_FIELDS:
            state[pre + "cell." + name] = dt(np.asarray(_field(cell, name))[i])
    if cfg.hybrid_shared_every:
        shared = params["shared"]
        state["shared.ln1"] = dt(shared["ln1"])
        state["shared.ln2"] = dt(shared["ln2"])
        for name in ("wq", "wk", "wv", "wo"):
            state["shared.attn." + name] = dt(_field(shared["attn"], name))
        for name in _MLP_FIELDS:
            state["shared.mlp." + name] = dt(_field(shared["mlp"], name))
    return state


def zamba_from_numpy(params, cfg: ModelConfig, device: DeviceLike = None):
    """A ``Zamba`` holding ``repro``'s hybrid parameters."""
    return _model_holding(zamba_state_from_numpy(params, cfg, device), cfg,
                          device)


_ATTN_FIELDS = ("wq", "wk", "wv", "wo")


def encdec_state_from_numpy(params, cfg: ModelConfig,
                            device: DeviceLike = None
                            ) -> "collections.OrderedDict[str, torch.Tensor]":
    """``repro``'s ``init_encdec`` tree (numpy leaves) as the
    ``state_dict`` of this package's ``EncDec``, on ``device``, keys in
    ``Model.state_dict()``'s order (a module's own parameters before its
    submodules'): ``embed``, ``enc_norm``, ``final_norm``, then
    ``enc_layers.<i>.*`` (ln1, ln2, attn, mlp) and ``dec_layers.<i>.*``
    (ln1, lnx, ln2, attn, xattn, mlp). Both layer stacks are stacked on
    axis 0 (``jax.vmap`` init); attention has no biases."""
    dev = resolve_device(device)
    dt = lambda x: to_device(np.asarray(x), dev)   # noqa: E731
    state = collections.OrderedDict()   # in Model.state_dict()'s order
    for name in ("embed", "enc_norm", "final_norm"):
        state[name] = dt(params[name])
    for prefix, n, norms, attns in (
            ("enc_layers", cfg.n_encoder_layers, ("ln1", "ln2"), ("attn",)),
            ("dec_layers", cfg.n_layers, ("ln1", "lnx", "ln2"),
             ("attn", "xattn"))):
        layers = params[prefix]
        leaves = [(norm, layers[norm]) for norm in norms]
        leaves += [(f"{part}.{name}", _field(layers[part], name))
                   for part in attns for name in _ATTN_FIELDS]
        leaves += [("mlp." + name, _field(layers["mlp"], name))
                   for name in _MLP_FIELDS]
        for i in range(n):
            for key, leaf in leaves:
                state[f"{prefix}.{i}.{key}"] = dt(np.asarray(leaf)[i])
    return state


def encdec_from_numpy(params, cfg: ModelConfig, device: DeviceLike = None):
    """An ``EncDec`` holding ``repro``'s encoder-decoder parameters."""
    return _model_holding(encdec_state_from_numpy(params, cfg, device), cfg,
                          device)


_MLSTM_FIELDS = ("w_up", "w_z", "conv_w", "w_q", "w_k", "w_v", "w_if",
                 "b_if", "gn_scale", "w_out")
_SLSTM_FIELDS = ("w_in", "r", "b", "gn_scale", "w_gate", "w_upp", "w_down")


def xlstm_state_from_numpy(params, cfg: ModelConfig,
                           device: DeviceLike = None
                           ) -> "collections.OrderedDict[str, torch.Tensor]":
    """``repro``'s ``init_xlstm`` tree (numpy leaves) as the
    ``state_dict`` of this package's ``XLSTM``, on ``device``, keys in
    ``Model.state_dict()``'s order: ``embed``, ``final_norm``, then
    ``blocks.<i>.norm`` and ``blocks.<i>.cell.<field>`` in block order.

    The JAX tree stacks the mLSTM leaves as (n_seg, m_per, ...) and the
    sLSTM leaves as (n_seg, ...) (``jax.vmap`` init); segment ``s`` is
    blocks ``s * k`` to ``s * k + k - 1``, its sLSTM last. With
    ``slstm_every = 0`` the tree has no ``"slstm"`` key. Every leaf keeps
    its dtype (``w_if``, ``b_if``, ``r`` and ``b`` are fp32 in a bf16
    model)."""
    from repro_torch.models.xlstm import _segment_shape

    dev = resolve_device(device)
    dt = lambda x: to_device(np.asarray(x), dev)   # noqa: E731
    state = collections.OrderedDict()   # in Model.state_dict()'s order
    state["embed"] = dt(params["embed"])
    state["final_norm"] = dt(params["final_norm"])
    n_seg, m_per = _segment_shape(cfg)
    kinds = [("mlstm", _MLSTM_FIELDS, lambda a, s, j: a[s, j])] * m_per
    if cfg.xlstm.slstm_every:
        kinds.append(("slstm", _SLSTM_FIELDS, lambda a, s, j: a[s]))
    i = 0
    for s in range(n_seg):
        for j, (key, fields, pick) in enumerate(kinds):
            tree = params[key]
            pre = f"blocks.{i}."
            state[pre + "norm"] = dt(pick(np.asarray(tree["norm"]), s, j))
            for name in fields:
                leaf = np.asarray(_field(tree["cell"], name))
                state[pre + "cell." + name] = dt(pick(leaf, s, j))
            i += 1
    return state


def xlstm_from_numpy(params, cfg: ModelConfig, device: DeviceLike = None):
    """An ``XLSTM`` holding ``repro``'s xLSTM parameters."""
    return _model_holding(xlstm_state_from_numpy(params, cfg, device), cfg,
                          device)
