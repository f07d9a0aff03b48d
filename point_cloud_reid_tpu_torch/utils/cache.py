"""Derived copies of weights, made once and reused while the weights stand.

A bf16 model keeps float32 parameters (as the JAX package does) and casts
them at each product. `derived(sources, tag, fn)` returns fn() computed once
for these source tensors: the key is each source's address, shape, strides,
device and dtype, and the entry holds the sources themselves, so no other
tensor can take their addresses while it is cached, and their in-place
versions. An in-place update of a source (an optimizer step,
load_state_dict) bumps its version: the next call recomputes and replaces
the entry, so a weight keeps one copy of each kind however often it is
updated. Under autograd, with a source that requires grad, nothing is
cached: the copy must stay in the graph.
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Callable, Sequence

import torch

_MAX_ENTRIES = 4096
_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()


def _key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), str(t.device),
            t.dtype)


def derived(sources: Sequence[torch.Tensor], tag, fn: Callable[[], torch.Tensor]
            ) -> torch.Tensor:
    """fn(), a tensor derived from `sources`, cached under `tag`."""
    if torch.is_grad_enabled() and any(s.requires_grad for s in sources):
        return fn()
    key = (tag,) + tuple(_key(s) for s in sources)
    versions = tuple(s._version for s in sources)
    hit = _CACHE.get(key)
    if hit is not None and hit[1] == versions:
        _CACHE.move_to_end(key)
        return hit[2]
    with torch.no_grad():
        out = fn()
    _CACHE[key] = (tuple(sources), versions, out)
    _CACHE.move_to_end(key)
    if len(_CACHE) > _MAX_ENTRIES:
        _CACHE.popitem(last=False)
    return out


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`; a parameter's copy is made once (see `derived`)."""
    if t.dtype == dtype:
        return t
    return derived((t,), ("cast", dtype), lambda: t.to(dtype))


def model_on(model: torch.nn.Module, device) -> torch.nn.Module:
    """`model` on `device`: the model itself on its own device, else a
    copy made once per set of weights (see `derived`: an update of any
    parameter or buffer makes the next call copy again). The sharded
    scorer's weights for each mesh entry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    own = next(model.parameters()).device
    if device == own:
        return model
    sources = tuple(model.parameters()) + tuple(model.buffers())
    return derived(sources, ("model_on", str(device)),
                   lambda: copy.deepcopy(model).to(device))
