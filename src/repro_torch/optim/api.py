"""Optimizers and lr schedules (``repro.optim.api``).

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


def step_drop_schedule(lr, drops, factor=0.2):
    """The paper's CIFAR schedule: lr divided at fixed update counts."""
    def f(step):
        mult = torch.ones((), dtype=torch.float32)
        for d in drops:
            if step >= d:
                mult = mult * factor
        return lr * mult
    return f


def warmup_cosine_schedule(lr, warmup, total):
    """Linear warm-up over ``warmup`` steps, then a cosine to 0 at
    ``total``."""
    def f(step):
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(torch.pi * prog))
        return lr * torch.where(step < warmup, warm, cos)
    return f


def _clip_scale(cfg, gn):
    """The global-norm clip's factor min(1, clip/‖g‖), or None unclipped."""
    if cfg.grad_clip > 0:
        return torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                           max=1.0)
    return None


def sgd(cfg, schedule=None):
    """SGD with momentum (+ optional Nesterov) and the reference's weight
    decay g + wd·master; f32 master copy and momentum."""
    sched = schedule or constant_schedule(cfg.lr)

    def init(params):
        return {
            "master": {n: p.detach().float().clone()
                       for n, p in params.items()},
            "mu": {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in params.items()},
        }

    @torch.no_grad()
    def update(grads, state, params, step):
        gn = _global_norm(grads)
        lr = sched(step).to(gn.device)
        scale = _clip_scale(cfg, gn)
        for n, p in params.items():
            g = grads[n].float()
            if scale is not None:
                g = g * scale
            ms, mu = state["master"][n], state["mu"][n]
            if cfg.weight_decay:
                g = g + cfg.weight_decay * ms
            mu.mul_(cfg.momentum).add_(g)
            d = g + cfg.momentum * mu if cfg.nesterov else mu
            ms.sub_(lr * d)
            p.copy_(ms)
        return params, state, {"grad_norm": gn, "lr": lr}

    return Optimizer(init, update)


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
        scale = _clip_scale(cfg, gn)
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
    if cfg.name == "sgd":
        return sgd(cfg, schedule)
    if cfg.name == "adamw":
        return adamw(cfg, schedule)
    raise ValueError(cfg.name)
