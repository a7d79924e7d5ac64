"""Carry Llama, Mixtral, BERT, MNIST and ResNet weights (and ResNet's
BatchNorm statistics) and Llama/Mixtral KV caches between flax trees and the
port.

The flax tree (``tf_operator_tpu/models/llama.py``) stacks every block
parameter on a leading ``layers`` axis (``nn.scan``) under ``blocks/`` and
stores ``Dense`` kernels as [in, out]; the port keeps one module per layer
and [out, in] weights. The decode cache has one layout in both, [layers,
batch, max_seq_len, kv_heads, head_dim], under ``blocks/attn/{k,v}`` in
the flax ``cache`` collection and ``{"k", "v"}`` in the port. A Mixtral
tree is a Llama one with ``blocks/moe/`` (the router ``Dense`` and the
expert tensors ``w_gate``/``w_up`` [E, H, M] and ``w_down`` [E, M, H],
whose layout the port keeps) in place of ``blocks/mlp/``; its cache is
the Llama cache, so ``llama_cache_{from,to}_flax`` carry it. A BERT tree
scans its blocks the same way; its ``Dense`` layers have a ``bias`` beside
the kernel and its LayerNorms a ``bias`` beside the ``scale``, all carried
as they are, as is ``pos_embed``. The JAX
pipeline trainer's tree stages the blocks as [pp, L/pp, ...]
(``parallel/llama_pp.py``); ``llama_stage_params_{from,to}_flax`` carry
it to and from the port's stages, whose ``state_dict`` names are the
``Llama``'s (each stage its own layers, every stage the embedding and
head). Both
directions take and give plain arrays (numpy on the flax side, torch
tensors on the port's), and raise on any leaf left over or missing.

The MNIST models (``models/mnist.py``) have one flax module per layer:
``Conv`` kernels are HWIO where torch's are OIHW, ``Dense`` kernels [in,
out] where torch's are [out, in]; biases are the same.

The ResNet (``models/resnet.py``) mirrors the flax module tree, so a flax
path is a state_dict name with ``/`` for ``.``: conv ``kernel`` HWIO <->
``weight`` OIHW, the ``classifier`` kernel [in, out] <-> [out, in], norm
``scale``/``bias`` as they are (GroupNorm's one level deeper, under
``GroupNorm_0``), and the ``batch_stats`` collection's ``mean``/``var``
<-> the BatchNorm buffers of the same layer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tf_operator_tpu_torch.models.bert import BertConfig
from tf_operator_tpu_torch.models.llama import LlamaConfig
from tf_operator_tpu_torch.models.mixtral import MixtralConfig

# flax path under blocks/ -> (port name under layers.{i}., transposed?)
_BLOCK_LEAVES = {
    ("attn", "wq", "kernel"): ("attn.wq.weight", True),
    ("attn", "wk", "kernel"): ("attn.wk.weight", True),
    ("attn", "wv", "kernel"): ("attn.wv.weight", True),
    ("attn", "wo", "kernel"): ("attn.wo.weight", True),
    ("attn_norm", "scale"): ("attn_norm.scale", False),
    ("mlp", "gate", "kernel"): ("mlp.gate.weight", True),
    ("mlp", "up", "kernel"): ("mlp.up.weight", True),
    ("mlp", "down", "kernel"): ("mlp.down.weight", True),
    ("mlp_norm", "scale"): ("mlp_norm.scale", False),
}
# A Mixtral block: the Llama block's attention and norms, and the MoE layer.
_MIXTRAL_BLOCK_LEAVES = {
    **{path: leaf for path, leaf in _BLOCK_LEAVES.items()
       if path[0] != "mlp"},
    ("moe", "router", "kernel"): ("moe.router.weight", True),
    ("moe", "w_gate"): ("moe.w_gate", False),
    ("moe", "w_up"): ("moe.w_up", False),
    ("moe", "w_down"): ("moe.w_down", False),
}
_TOP_LEAVES = {
    ("embed_tokens", "embedding"): ("embed_tokens.weight", False),
    ("final_norm", "scale"): ("final_norm.scale", False),
    ("lm_head", "kernel"): ("lm_head.weight", True),
}


def _dense(*path: str) -> Dict[tuple, Tuple[str, bool]]:
    """The leaves of a biased flax ``Dense`` at ``path``."""
    name = ".".join(path)
    return {path + ("kernel",): (f"{name}.weight", True),
            path + ("bias",): (f"{name}.bias", False)}


def _layer_norm(name: str) -> Dict[tuple, Tuple[str, bool]]:
    return {(name, "scale"): (f"{name}.scale", False),
            (name, "bias"): (f"{name}.bias", False)}


# A BERT block: biased projections and flax LayerNorms.
_BERT_BLOCK_LEAVES = {
    **_dense("attn", "wq"), **_dense("attn", "wk"), **_dense("attn", "wv"),
    **_dense("attn", "wo"), **_layer_norm("attn_ln"),
    **_dense("mlp_in"), **_dense("mlp_out"), **_layer_norm("mlp_ln"),
}
_BERT_TOP_LEAVES = {
    ("embed_tokens", "embedding"): ("embed_tokens.weight", False),
    ("pos_embed",): ("pos_embed", False),
    **_layer_norm("embed_ln"), **_dense("mlm_transform"),
    **_layer_norm("mlm_ln"), **_dense("mlm_head"),
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[tuple, object]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = value
    return flat


def _unflatten(flat: Mapping[tuple, object]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _stacked_from_flax(params: Mapping, n_layers: int, block_leaves: Mapping,
                       top_leaves: Mapping = _TOP_LEAVES
                       ) -> Dict[str, torch.Tensor]:
    """flax ``params`` with ``blocks/`` scanned over ``n_layers`` -> the
    port's state_dict, by the leaf tables."""
    flat = _flatten(params)
    state: Dict[str, torch.Tensor] = {}

    def take(path):
        if path not in flat:
            raise KeyError(f"flax params lack {'/'.join(path)}")
        return np.asarray(flat.pop(path), dtype=np.float32)

    def to_torch(arr, transpose):
        return torch.from_numpy(np.array(arr.T if transpose else arr,
                                         order="C", copy=True))

    for path, (name, transpose) in top_leaves.items():
        state[name] = to_torch(take(path), transpose)
    for path, (name, transpose) in block_leaves.items():
        stacked = take(("blocks",) + path)
        if stacked.shape[0] != n_layers:
            raise ValueError(f"blocks/{'/'.join(path)} stacks "
                             f"{stacked.shape[0]} layers, config has "
                             f"{n_layers}")
        for i in range(n_layers):
            state[f"layers.{i}.{name}"] = to_torch(stacked[i], transpose)
    if flat:
        raise KeyError("flax params left over: " + ", ".join(
            "/".join(p) for p in sorted(flat)))
    return state


def _stacked_to_flax(state: Mapping[str, torch.Tensor], n_layers: int,
                     block_leaves: Mapping,
                     top_leaves: Mapping = _TOP_LEAVES) -> Dict:
    """The port's state_dict -> flax ``params`` (nested dict of numpy),
    the blocks stacked on a leading ``layers`` axis."""
    state = {k: v.detach().float().cpu().numpy() for k, v in state.items()}
    flat = {}

    def take(name, transpose):
        if name not in state:
            raise KeyError(f"state_dict lacks {name}")
        arr = state.pop(name)
        return np.ascontiguousarray(arr.T) if transpose else arr

    for path, (name, transpose) in top_leaves.items():
        flat[path] = take(name, transpose)
    for path, (name, transpose) in block_leaves.items():
        flat[("blocks",) + path] = np.stack(
            [take(f"layers.{i}.{name}", transpose)
             for i in range(n_layers)])
    if state:
        raise KeyError("state_dict entries left over: "
                       + ", ".join(sorted(state)))
    return _unflatten(flat)


def llama_params_from_flax(params: Mapping, cfg: LlamaConfig
                           ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (nested dict of arrays) -> the port's state_dict."""
    return _stacked_from_flax(params, cfg.n_layers, _BLOCK_LEAVES)


def llama_params_to_flax(state: Mapping[str, torch.Tensor],
                         cfg: LlamaConfig) -> Dict:
    """The port's state_dict -> flax ``params`` (nested dict of numpy)."""
    return _stacked_to_flax(state, cfg.n_layers, _BLOCK_LEAVES)


def _restage(params: Mapping, shape) -> Dict:
    """A copy of ``params`` with every ``blocks/`` leaf reshaped by
    ``shape(leaf)``."""
    return _unflatten({path: (np.asarray(v).reshape(shape(np.asarray(v)))
                              if path[0] == "blocks" else v)
                       for path, v in _flatten(params).items()})


def llama_stage_params_from_flax(params: Mapping, cfg: LlamaConfig,
                                 stage: int, pp: int
                                 ) -> Dict[str, torch.Tensor]:
    """flax ``params`` with staged blocks [pp, L/pp, ...] -> the
    state_dict of the port's stage ``stage`` of ``pp``
    (``parallel/llama_pp.py`` ``LlamaStage``)."""
    state = llama_params_from_flax(
        _restage(params, lambda a: (a.shape[0] * a.shape[1],) + a.shape[2:]),
        cfg)
    per = cfg.n_layers // pp
    own = {f"layers.{i}." for i in range(stage * per, (stage + 1) * per)}
    return {n: t for n, t in state.items()
            if not n.startswith("layers.")
            or n[:n.index(".", len("layers.")) + 1] in own}


def llama_stage_params_to_flax(states: Sequence[Mapping[str, torch.Tensor]],
                               cfg: LlamaConfig) -> Dict:
    """The state_dicts of the port's pp stages, in stage order -> flax
    ``params`` with staged blocks [pp, L/pp, ...] (numpy)."""
    merged = {}
    for state in states:
        merged.update(state)
    pp = len(states)
    return _restage(llama_params_to_flax(merged, cfg),
                    lambda a: (pp, a.shape[0] // pp) + a.shape[1:])


def mixtral_params_from_flax(params: Mapping, cfg: MixtralConfig
                             ) -> Dict[str, torch.Tensor]:
    """flax Mixtral ``params`` -> the port's state_dict (expert tensors in
    the flax [E, in, out] layout, the router Dense transposed)."""
    return _stacked_from_flax(params, cfg.n_layers, _MIXTRAL_BLOCK_LEAVES)


def mixtral_params_to_flax(state: Mapping[str, torch.Tensor],
                           cfg: MixtralConfig) -> Dict:
    """The port's Mixtral state_dict -> flax ``params`` (numpy)."""
    return _stacked_to_flax(state, cfg.n_layers, _MIXTRAL_BLOCK_LEAVES)


def bert_params_from_flax(params: Mapping, cfg: BertConfig
                          ) -> Dict[str, torch.Tensor]:
    """flax BERT ``params`` -> the port's state_dict: kernels transposed,
    biases, LayerNorm scales and biases and ``pos_embed`` as they are."""
    return _stacked_from_flax(params, cfg.n_layers, _BERT_BLOCK_LEAVES,
                              _BERT_TOP_LEAVES)


def bert_params_to_flax(state: Mapping[str, torch.Tensor],
                        cfg: BertConfig) -> Dict:
    """The port's BERT state_dict -> flax ``params`` (numpy)."""
    return _stacked_to_flax(state, cfg.n_layers, _BERT_BLOCK_LEAVES,
                            _BERT_TOP_LEAVES)


_CACHE_LEAVES = {("blocks", "attn", "k"): "k", ("blocks", "attn", "v"): "v"}


def llama_cache_from_flax(cache: Mapping, cfg: LlamaConfig
                          ) -> Dict[str, torch.Tensor]:
    """flax ``cache`` collection -> the port's cache, in ``cfg.dtype``."""
    flat = _flatten(cache)
    out = {}
    for path, name in _CACHE_LEAVES.items():
        if path not in flat:
            raise KeyError(f"flax cache lacks {'/'.join(path)}")
        arr = np.asarray(flat.pop(path), dtype=np.float32)
        out[name] = torch.from_numpy(arr.copy()).to(cfg.dtype)
    if flat:
        raise KeyError("flax cache left over: " + ", ".join(
            "/".join(p) for p in sorted(flat)))
    return out


def llama_cache_to_flax(cache: Mapping[str, torch.Tensor]) -> Dict:
    """The port's cache -> the flax ``cache`` collection (numpy, f32)."""
    if set(cache) != set(_CACHE_LEAVES.values()):
        raise KeyError(f"cache has {sorted(cache)}, expected ['k', 'v']")
    return _unflatten({path: cache[name].detach().float().cpu().numpy()
                       for path, name in _CACHE_LEAVES.items()})


def mnist_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax MNIST ``params`` ({layer: {kernel, bias}}) -> the port's
    state_dict (``MnistCNN`` or ``MnistMLP``)."""
    state: Dict[str, torch.Tensor] = {}
    for layer, leaves in params.items():
        if set(leaves) != {"kernel", "bias"}:
            raise KeyError(f"flax layer {layer} has {sorted(leaves)}, "
                           "expected ['bias', 'kernel']")
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        if kernel.ndim == 4:
            kernel = kernel.transpose(3, 2, 0, 1)       # HWIO -> OIHW
        elif kernel.ndim == 2:
            kernel = kernel.T
        else:
            raise ValueError(f"flax layer {layer}: kernel of rank "
                             f"{kernel.ndim}")
        state[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel))
        state[f"{layer}.bias"] = torch.from_numpy(
            np.array(leaves["bias"], dtype=np.float32))
    return state


def mnist_params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The port's MNIST state_dict -> flax ``params`` (numpy)."""
    params: Dict = {}
    for name, value in state.items():
        layer, leaf = name.rsplit(".", 1)
        arr = value.detach().float().cpu().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            params.setdefault(layer, {})["kernel"] = np.ascontiguousarray(arr)
        elif leaf == "bias":
            params.setdefault(layer, {})["bias"] = arr
        else:
            raise KeyError(f"state_dict entry {name} is no weight or bias")
    return params


# The leaves of a flax ResNet layer -> its kind.
_RESNET_LAYERS = {("kernel",): "conv", ("bias", "kernel"): "dense",
                  ("bias", "scale"): "norm"}


def resnet_params_from_flax(params: Mapping,
                            batch_stats: Optional[Mapping] = None
                            ) -> Dict[str, torch.Tensor]:
    """flax ResNet ``params`` and ``batch_stats`` (nested dicts of arrays)
    -> the port's state_dict, parameters and buffers. Every flax layer is a
    conv (``kernel``), the classifier (``kernel``, ``bias``) or a norm
    (``scale``, ``bias``); statistics must belong to a norm layer, and
    every batch-norm layer has both or, for a model without them, none."""
    state: Dict[str, torch.Tensor] = {}
    layers: Dict[tuple, Dict[str, np.ndarray]] = {}
    for path, value in _flatten(params).items():
        layers.setdefault(path[:-1], {})[path[-1]] = np.asarray(
            value, dtype=np.float32)
    stats: Dict[tuple, Dict[str, np.ndarray]] = {}
    for path, value in _flatten(batch_stats or {}).items():
        stats.setdefault(path[:-1], {})[path[-1]] = np.asarray(
            value, dtype=np.float32)
    for layer, leaves in sorted(layers.items()):
        name = ".".join(layer)
        kind = _RESNET_LAYERS.get(tuple(sorted(leaves)))
        rank = leaves["kernel"].ndim if "kernel" in leaves else None
        if kind is None or rank not in (None, 4 if kind == "conv" else 2):
            raise KeyError(f"flax layer {'/'.join(layer)} has "
                           f"{sorted(leaves)} (rank "
                           f"{[v.ndim for v in leaves.values()]}), expected "
                           "a 4-d ['kernel'], a 2-d ['bias', 'kernel'] or "
                           "['bias', 'scale']")
        if kind == "conv":
            state[name + ".weight"] = _tensor(
                leaves["kernel"].transpose(3, 2, 0, 1))   # HWIO -> OIHW
        elif kind == "dense":
            state[name + ".weight"] = _tensor(leaves["kernel"].T)
            state[name + ".bias"] = _tensor(leaves["bias"])
        else:
            state[name + ".scale"] = _tensor(leaves["scale"])
            state[name + ".bias"] = _tensor(leaves["bias"])
    batch_norms = [layer for layer, leaves in layers.items()
                   if "scale" in leaves and layer[-1] != "GroupNorm_0"]
    for layer in batch_norms if stats else ():
        if layer not in stats:
            raise KeyError(f"flax batch_stats lack {'/'.join(layer)}")
    for layer, leaves in sorted(stats.items()):
        if layer not in batch_norms or set(leaves) != {"mean", "var"}:
            raise KeyError(f"flax batch_stats {'/'.join(layer)} "
                           f"{sorted(leaves)} left over: no batch-norm layer "
                           "of that name, or not ['mean', 'var']")
        for leaf, value in leaves.items():
            state[".".join(layer + (leaf,))] = _tensor(value)
    return state


def resnet_params_to_flax(state: Mapping[str, torch.Tensor]
                          ) -> Tuple[Dict, Dict]:
    """The port's ResNet state_dict -> flax ``(params, batch_stats)``
    (numpy; ``batch_stats`` empty for a model without statistics)."""
    params, stats = {}, {}
    for name, value in state.items():
        path = tuple(name.split("."))
        arr = value.detach().float().cpu().numpy()
        leaf = path[-1]
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            params[path[:-1] + ("kernel",)] = np.ascontiguousarray(arr)
        elif leaf in ("bias", "scale"):
            params[path] = arr
        elif leaf in ("mean", "var"):
            stats[path] = arr
        else:
            raise KeyError(f"state_dict entry {name} is no weight, bias, "
                           "scale, mean or var")
    return _unflatten(params), _unflatten(stats)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C",
                                     copy=True))
