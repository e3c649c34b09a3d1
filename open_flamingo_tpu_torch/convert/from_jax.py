"""Weight bridge: the JAX package's flax `params` tree, as numpy arrays,
to this package's `state_dict`.

Give it `jax.tree.map(np.asarray, params)` for a whole `Flamingo` or for
any of its sub-modules; it never imports JAX. Naming rules:
  * `blocks_3` / `xattn_3` / `layers_3_attn` -> `blocks.3` / `xattn.3` /
    `layers.3.attn` (ModuleList / ModuleDict entries);
  * Dense `kernel` (in, out) -> Linear `weight` (out, in), transposed;
  * LayerNorm `scale` and Embed `embedding` -> `weight`;
  * everything else (`bias`, gates, latents, CLIP embeddings) keeps its
    name. The ViT patch embedding stays a Dense over (p, p, C) features.

The JAX package's scanned LM layout (`scan_layers=True`, made by
`models/lm.py` `to_scanned_layout`) is read too: `groups/block_k` and
`groups/xattn` carry a leading group axis, and group g's entries are
unstacked into `blocks.{g*n + k}` and `xattn.{g*n + n - 1}` (n = the number
of `block_k` entries, the cross-attention interval). The port keeps one
per-layer layout: a PyTorch loop over layers has no compile step to save.

`decode_weights_from_jax` reads the JAX package's `qparams` side-car
(`quantize_decode_params`, both layouts) into the quantized copies that
`quantize.attach_decode_weights` puts on the port's modules.
`kv_cache_from_jax` reads a JAX `KVCache` (either layout, model-dtype or
int8) into the port's `KVCache`, so that both packages can take a decode
step from one state.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.decoders.common import KVCache, LayerKV
from ..quantize import pack_int4

_INDEXED = re.compile(r"^(blocks|xattn|layers)_(\d+)(?:_(\w+))?$")
_LEAF = {"scale": "weight", "embedding": "weight"}


def _module_name(name: str) -> str:
    m = _INDEXED.match(name)
    if not m:
        return name
    return ".".join(p for p in m.groups() if p is not None)


def _unstack_groups(tree: Mapping) -> dict:
    """Replace a scanned `groups` entry by per-layer `blocks_i` / `xattn_i`
    entries, recursively."""
    out = {}
    for name, val in tree.items():
        if not isinstance(val, Mapping):
            out[name] = val
        elif name == "groups":
            n = sum(1 for key in val if key.startswith("block_"))

            def layer(sub, g):
                return {k: layer(v, g) if isinstance(v, Mapping) else np.asarray(v)[g] for k, v in sub.items()}

            groups = len(np.asarray(next(_leaves(val["block_0"]))))
            for g in range(groups):
                for k in range(n):
                    out[f"blocks_{g * n + k}"] = layer(val[f"block_{k}"], g)
                if "xattn" in val:
                    out[f"xattn_{g * n + n - 1}"] = layer(val["xattn"], g)
        else:
            out[name] = _unstack_groups(val)
    return out


def _leaves(tree: Mapping):
    for val in tree.values():
        if isinstance(val, Mapping):
            yield from _leaves(val)
        else:
            yield val


def state_dict_from_jax(params: Mapping, dtype=None) -> Dict[str, torch.Tensor]:
    """Flatten a numpy flax params tree (with or without the top-level
    "params" key) into a torch state_dict, optionally cast to `dtype`."""
    if "params" in params:
        params = params["params"]
    params = _unstack_groups(params)
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + [_module_name(name)])
                continue
            arr = np.asarray(val)
            if name == "kernel":
                arr = arr.T
            key = ".".join(prefix + [_LEAF.get(name, "weight" if name == "kernel" else name)])
            t = torch.tensor(arr)  # a copy: numpy views of JAX arrays are read-only
            out[key] = t if dtype is None else t.to(dtype)

    walk(params, [])
    return out


def state_dict_from_flat(flat: Mapping[Tuple[str, ...], Any], dtype=None) -> Dict[str, torch.Tensor]:
    """`state_dict_from_jax` for a flat dict keyed by path tuples, the form of
    the JAX package's `split_params` partitions and of gradients taken over
    them: the port's names for the same tensors."""
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return state_dict_from_jax(tree, dtype)


def decode_weights_from_jax(variables: Mapping) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The JAX package's `qparams` collection (as numpy; the variables dict
    that holds it, or the collection itself), unrolled or scanned, as
    {port module name: (weight_q, weight_s)}, names from the Flamingo model
    down (`lm.blocks.0.Wqkv`). `kernel_q` (K, N) int8 becomes (N, K);
    `kernel_q4` (int4-grid values stored as int8) becomes the port's packed
    (N, K/2) uint8; `embedding_q` (V, D) stays as it is; the scales
    (`kernel_s`, `embedding_s`) are (N,) fp32 either way."""
    tree = _unstack_groups(variables.get("qparams", variables))
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def walk(node, prefix):
        if "kernel_s" in node or "embedding_s" in node:
            if "embedding_q" in node:
                q, s = torch.tensor(np.asarray(node["embedding_q"])), node["embedding_s"]
            else:
                q4 = "kernel_q4" in node
                q = torch.tensor(np.asarray(node["kernel_q4" if q4 else "kernel_q"]).T)
                q, s = (pack_int4(q) if q4 else q), node["kernel_s"]
            out[".".join(prefix)] = (q, torch.tensor(np.asarray(s, dtype=np.float32)))
            return
        for name, val in node.items():
            walk(val, prefix + [_module_name(name)])

    walk(tree, [])
    return out


def kv_cache_from_jax(cache) -> KVCache:
    """A JAX `KVCache` with numpy leaves (`jax.tree.map(np.asarray, cache)`)
    as the port's. The scanned layout's stacked entries, `layers[k]` (G, B,
    H_kv, S, Dh) and one media entry with a leading G, unstack as the
    weights do: layer g*n + k, xattn block g. int8 scales go from the JAX
    package's head-leading (..., H, B, S) to the port's (B, H, S)."""

    def layer(kv, g=None):
        pick = (lambda a: a) if g is None else (lambda a: a[g])
        k_s = None if kv.k_s is None else torch.tensor(np.swapaxes(pick(np.asarray(kv.k_s)), -3, -2).copy())
        v_s = None if kv.v_s is None else torch.tensor(np.swapaxes(pick(np.asarray(kv.v_s)), -3, -2).copy())
        return LayerKV(torch.tensor(pick(np.asarray(kv.k))), torch.tensor(pick(np.asarray(kv.v))), k_s, v_s)

    scanned = np.asarray(cache.layers[0].k).ndim == 5
    if scanned:
        groups = np.asarray(cache.layers[0].k).shape[0]
        layers = tuple(layer(cache.layers[k], g) for g in range(groups) for k in range(len(cache.layers)))
        media = None if cache.media is None else tuple(layer(cache.media[0], g) for g in range(groups))
    else:
        layers = tuple(layer(kv) for kv in cache.layers)
        media = None if cache.media is None else tuple(layer(kv) for kv in cache.media)
    index = int(np.asarray(cache.index))
    return KVCache(layers=layers, index=index, slot=torch.tensor([index], dtype=torch.int32),
                   pad_mask=torch.tensor(np.asarray(cache.pad_mask, dtype=bool)), media=media)
