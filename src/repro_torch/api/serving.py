"""One-call serving: prefill + batched greedy decode (``repro.api.serving``).

``serve`` builds the model, prefills a batch of prompts into per-layer KV
caches and decodes greedily against them, all under
``torch.inference_mode``, on one CUDA device unless given ``device="cpu"``:

    import repro_torch
    out = repro_torch.serve("llama3.2-3b", batch=8, prompt_len=4096, gen=64)

The caches are global (one slot per position, ``cap >= prompt_len + gen``)
and filled from slot 0, so every step passes its position offset down and
attention runs through the flash kernel (``LM.serve_step``'s
``q_offset``). Sharded serving (``mesh=``) is not ported yet.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.experiment import resolve_device
from repro_torch.configs.base import (ModelConfig, RunConfig, SHAPES,
                                      reduced)
from repro_torch.models.lm import LM


def _resolve_model(cfg) -> ModelConfig:
    if isinstance(cfg, RunConfig):
        return cfg.model
    if isinstance(cfg, ModelConfig):
        return cfg
    from repro_torch.configs import get_config
    return get_config(cfg)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg="lm-tiny", *, params=None, prompts=None, batch=2,
          prompt_len=32, gen=32, cap=None, shape=None, mesh=None,
          smoke=False, seed=1, log=None, device=None):
    """Prefill + batched greedy decode in one call.

    ``cfg`` is an arch id, ``ModelConfig`` or ``RunConfig``; ``shape``
    optionally names a serving cell (``decode_32k`` etc.) that sets batch
    and prompt length; ``smoke`` reduces the model to CPU scale. ``params``
    is a ``{name: tensor}`` dict of the port's parameters (default: the
    model initialised from seed 0); ``prompts`` (batch, prompt_len) token
    ids, else drawn from a ``torch.Generator`` seeded with ``seed`` (not the
    reference's draws). Returns ``{"tokens", "prefill_s", "decode_s",
    "tok_per_s"}``; tokens are the ``gen`` greedy continuations,
    ``(batch, gen)``."""
    if mesh is not None:
        raise NotImplementedError("sharded serving (mesh=) is the "
                                  "distributed slice's work, not ported yet")
    model = _resolve_model(cfg)
    if smoke:
        model = reduced(model, repeats=1)
    if shape is not None:
        if isinstance(shape, str):
            shape = SHAPES[shape]
        batch, prompt_len = shape.global_batch, shape.seq_len
    device = resolve_device(device)
    if prompts is None:
        g = torch.Generator().manual_seed(seed)
        prompts = torch.randint(0, model.vocab_size, (batch, prompt_len),
                                generator=g)
    else:
        # caller-supplied prompts define the cache geometry
        prompts = torch.as_tensor(np.asarray(prompts))
        batch, prompt_len = prompts.shape
    # the cache must hold prompt + every generated token (a smaller cap
    # would clamp decode's insert onto the last slot)
    cap = cap or prompt_len + gen
    if cap < prompt_len + gen:
        raise ValueError(f"cap={cap} cannot hold prompt_len={prompt_len} "
                         f"+ gen={gen} tokens")
    lm = LM(model, device)
    if params is not None:
        lm.load_state_dict(params, strict=True)

    with torch.inference_mode():
        prompts = prompts.to(device)
        caches = lm.caches(batch, cap)
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = lm.serve_step(caches, {"tokens": prompts},
                                       q_offset=0)
        tok = logits[:, -1].argmax(-1)[:, None]
        _sync(device)
        prefill_s = time.perf_counter() - t0
        if log:
            log(f"prefill b={batch} len={prompt_len}: {prefill_s:.2f}s",
                flush=True)

        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, caches = lm.serve_step(caches, {"tokens": tok},
                                           q_offset=prompt_len + i)
            tok = logits[:, -1].argmax(-1)[:, None]
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
        tokens = torch.cat(out, dim=1).cpu().numpy()
    tok_per_s = batch * gen / max(decode_s, 1e-9)
    if log:
        log(f"decode {gen} steps: {decode_s:.2f}s ({tok_per_s:.1f} tok/s)",
            flush=True)
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": decode_s,
            "tok_per_s": tok_per_s}
