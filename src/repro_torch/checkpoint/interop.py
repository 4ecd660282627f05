"""Parameters across the JAX checkpoint format.

The reference stores a model's parameters as a flat dict of numpy arrays
keyed by the ``/``-joined pytree path (``repro/checkpoint/ckpt.py``
``_flatten``), e.g. ``segments/seg0/stacked/p0/inner/wq``, with each
segment's layers stacked on a leading axis. The port's ``state_dict``
names are the same paths with ``.`` separators plus the layer index after
the pattern position (``segments.seg0.stacked.p0.3.inner.wq``), and its
weights keep the reference's (d_in, d_out) layout, so the mapping is
one-to-one: ``jax_key`` drops the index and the stacked leaf's slice
``[index]`` is that layer's tensor. npz has no bf16, so bf16 leaves cross
as f32 arrays and are cast back on load (exactly: bf16 ⊂ f32).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.models.lm import LM

_LAYER = re.compile(r"^(segments\.seg\d+\.stacked\.p\d+)\.(\d+)\.(.+)$")


def _split(name: str):
    """port parameter name -> (reference key, layer index or None)."""
    m = _LAYER.match(name)
    if m is None:
        return name.replace(".", "/"), None
    return f"{m.group(1)}.{m.group(3)}".replace(".", "/"), int(m.group(2))


def jax_key(name: str) -> str:
    """The reference checkpoint key a port parameter lives under."""
    return _split(name)[0]


def params_to_numpy(lm: LM) -> dict:
    """The port's parameters as the reference's flat dict: per-layer
    tensors stacked back on the leading axis, bf16 as f32."""
    groups = {}
    for name, p in lm.named_parameters():
        key, layer = _split(name)
        arr = p.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        groups.setdefault(key, {})[layer] = arr.numpy()
    out = {}
    for key, by_layer in groups.items():
        if None in by_layer:
            out[key] = by_layer[None]
        else:
            out[key] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


@torch.no_grad()
def load_params(lm: LM, flat: dict) -> LM:
    """Copy a reference flat dict into ``lm``'s parameters (cast to each
    parameter's dtype). Every parameter must be present with its shape."""
    names = dict(lm.named_parameters())
    want = {jax_key(n) for n in names}
    if set(flat) != want:
        raise KeyError(f"checkpoint keys differ: missing "
                       f"{sorted(want - set(flat))}, unexpected "
                       f"{sorted(set(flat) - want)}")
    for name, p in names.items():
        key, layer = _split(name)
        value = np.asarray(flat[key])
        if layer is not None:
            value = value[layer]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{key}[{layer}]: shape {value.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value)).to(p.dtype))
    return lm


def params_from_numpy(flat: dict, cfg, device) -> LM:
    """Build the port's ``LM`` for ``cfg`` on ``device`` holding the
    parameters of a reference flat dict (inverse of ``params_to_numpy``)."""
    return load_params(LM(cfg, device), flat)
