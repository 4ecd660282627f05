"""Optimizers (``repro.optim.api``).

Contract:
    opt = get_optimizer(OptimConfig, schedule_fn)
    state = opt.init(params)                 # params: {name: tensor}
    params, state, metrics = opt.update(grads, state, params, step)

Mixed precision: parameters may be bf16; the optimizer keeps an f32 master
copy + f32 moments and casts back to the parameter dtype after the
update. Unlike the reference, the update writes the parameters, master
copy and moments IN PLACE (the returned ``params`` are the same tensors):
at llama3.2-3b a functional update would hold a second 51 GB of state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _global_norm(grads: dict):
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def constant_schedule(lr):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def adamw(cfg, schedule=None):
    sched = schedule or constant_schedule(cfg.lr)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return {
            "master": {n: p.detach().float().clone()
                       for n, p in params.items()},
            "m": {n: z(p) for n, p in params.items()},
            "v": {n: z(p) for n, p in params.items()},
        }

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = _global_norm(grads)
        dev = gn.device
        lr = sched(step).to(dev)
        scale = None
        if cfg.grad_clip > 0:
            scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                                max=1.0)
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32, device=dev)
        c1 = 1.0 - torch.pow(cfg.b1, t)
        c2 = 1.0 - torch.pow(cfg.b2, t)
        for n, p in params.items():
            g = grads[n].float()
            if scale is not None:
                g = g * scale
            ms, m, v = state["master"][n], state["m"][n], state["v"][n]
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            upd = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
            upd.add_(ms, alpha=cfg.weight_decay).mul_(lr)
            ms.sub_(upd)
            p.copy_(ms)
        return params, state, {"grad_norm": gn, "lr": lr}

    return Optimizer(init, update)


def get_optimizer(cfg, schedule=None) -> Optimizer:
    if cfg.name == "adamw":
        return adamw(cfg, schedule)
    raise NotImplementedError(f"optimizer {cfg.name!r} is not ported yet "
                              f"(have 'adamw')")
