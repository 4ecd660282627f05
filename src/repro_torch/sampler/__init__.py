"""Example selection: schemes, score store, selection math, assembly."""
from repro_torch.sampler.schemes import make_sampler

__all__ = ["make_sampler"]
