"""Parameters and the train state across the JAX checkpoint format.

The reference stores a model's parameters as a flat dict of numpy arrays
keyed by the ``/``-joined pytree path (``repro/checkpoint/ckpt.py``
``_flatten``), e.g. ``segments/seg0/stacked/p0/inner/wq``, with each
segment's layers stacked on a leading axis. The port's ``state_dict``
names are the same paths with ``.`` separators plus the layer index after
the pattern position (``segments.seg0.stacked.p0.3.inner.wq``), and its
weights keep the reference's (d_in, d_out) layout, so the mapping is
one-to-one: ``jax_key`` drops the index and the stacked leaf's slice
``[index]`` is that layer's tensor. ``params_to_numpy`` hands bf16 leaves
over as f32 arrays (exactly: bf16 ⊂ f32); a checkpoint keeps them bf16
(``checkpoint.ckpt``).

The whole train state (``train_payload`` / ``load_train_state``) crosses
under the reference's names: ``params/<key>``, ``opt/{master,m,v}/<key>``
(``mu`` for SGD), each stacked per layer like the params;
``ctrl/.tau_ema``, ``ctrl/.steps_is``, ``ctrl/.steps_total``; ``step``
(int32); and ``rng`` (uint32[2]), the reference's ``PRNGKey(0)``, which
it never advances. The port's draws come from a ``torch.Generator``,
whose state goes under the port-only key ``torch_rng`` (the reference
restores only the keys of its own state, so it never reads it). A
checkpoint without that key (the reference's), or one whose generator
was on another device type, reseeds the generator from ``(run.seed,
step)`` (``reseed``): the draws after such a resume are a fresh stream,
the same for every resume at that step.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Stacked
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


def stacked(named: dict) -> dict:
    """``{port name: tensor}`` -> ``{reference key: tensor | Stacked}``."""
    groups = {}
    for name, t in named.items():
        key, layer = _split(name)
        groups.setdefault(key, {})[layer] = t
    return {key: (by_layer[None] if None in by_layer else
                  Stacked(by_layer[i] for i in range(len(by_layer))))
            for key, by_layer in groups.items()}


def params_to_numpy(lm: LM) -> dict:
    """The port's parameters as the reference's flat dict: per-layer
    tensors stacked back on the leading axis, bf16 as f32."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {key: (np.stack([host(t) for t in v]) if isinstance(v, Stacked)
                  else host(v))
            for key, v in stacked(dict(lm.named_parameters())).items()}


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


JAX_RNG = np.zeros(2, np.uint32)   # the reference's PRNGKey(0)
TORCH_RNG = "torch_rng"            # the port's generator state (uint8)


def train_payload(state) -> dict:
    """The train state as the reference's checkpoint tree (the part under
    ``train/``); tensor leaves are the live tensors, so the tree is both
    what ``Checkpointer.save`` snapshots and the template ``restore``
    fills in place."""
    return {"params": stacked(state["params"]),
            "opt": {k: stacked(v) for k, v in state["opt"].items()},
            "ctrl": state["ctrl"],
            "step": np.asarray(state["step"], np.int32),
            "rng": JAX_RNG.copy(),
            TORCH_RNG: state["rng"].get_state().numpy()}


def reseed(gen: torch.Generator, seed: int, step: int) -> None:
    """The generator of a resume that carries no state for it."""
    ss = np.random.SeedSequence([int(seed), 0x7EED, int(step)])
    gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))


def load_train_state(ckpt, state, seed: int, step=None):
    """Restore a checkpoint's ``train/`` tree into ``state`` (a fresh
    ``train_state_init``: params and optimizer tensors are filled in
    place) -> ``(state, step)``."""
    tmpl = train_payload(state)
    gen_state = tmpl.pop(TORCH_RNG)
    payload, step = ckpt.restore({"train": tmpl}, step=step)
    train = payload["train"]
    state = dict(state, ctrl=train["ctrl"], step=int(train["step"]))
    try:
        got, _ = ckpt.restore({"train": {TORCH_RNG: gen_state}}, step=step,
                              check_topology=False)
        state["rng"].set_state(torch.from_numpy(
            np.ascontiguousarray(got["train"][TORCH_RNG], np.uint8)))
    except (KeyError, ValueError):
        reseed(state["rng"], seed, step)
    return state, step
