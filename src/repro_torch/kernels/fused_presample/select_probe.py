"""Probe where one ``pool_select`` launch spends its time on the card.

The shipped kernel is timed on inputs that skip parts of its work: the
whole launch at cell E's pool (12, 1024) and prod's (768, 4096); prod's
with k >= B (stage 1, Σs and the keys, no selection); the scores given
(one block, no stage 1) at B = 768 with k = 256 (the whole of stage 2),
k = 1 (the radix select and the winners' scan, a two-winner sort) and
k >= B (Σs and the keys); at B = 256 with k = 64 (the direct ranking's
largest pool) and B = 12 with k = 4; and a one-element ``zero_()``, the
floor under any launch. Each is its device time under ``torch.profiler``,
per launch, over 200 launches; g2 and the mask rotate through copies that
exceed the L2 cache. Run from the repo root on a machine with an H100 and
``nvcc``::

    PYTHONPATH=src python3 -m repro_torch.kernels.fused_presample.select_probe
"""
import json

import torch

from repro_torch.kernels.fused_presample import fused_presample as fp

N = 200


def device_ms(fn, n=N):
    """Device time per call in ms: the device activity of n calls over n
    (as ``chip_smoke.py`` times launches shorter than their dispatch)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy == 0:
        raise RuntimeError("the profiler saw no device activity")
    return busy / 1e3 / n


def _g2_sets(B, T, gen):
    n_sets = max(2, -(-125_000_000 // (B * T * 5)))
    return [(torch.rand((B, T), generator=gen, device="cuda").mul_(2.0),
             torch.rand((B, T), generator=gen, device="cuda") >= 0.2)
            for _ in range(n_sets)]


def main():
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    one = torch.zeros((1,), device="cuda")
    res["launch floor: one-element zero_()"] = device_ms(one.zero_)
    for B, T, ks in ((12, 1024, (4,)), (768, 4096, (256, 768))):
        sets = _g2_sets(B, T, gen)
        for k in ks:
            turn = iter(range(10 ** 9))
            res[f"g2 ({B}, {T}) k {k}"] = device_ms(
                lambda: fp.pool_select_cuda(*sets[next(turn) % len(sets)],
                                            77, k))
            res[f"g2 ({B}, {T}) k {k}, L2-warm"] = device_ms(
                lambda: fp.pool_select_cuda(*sets[0], 77, k))
        del sets
    for B, ks in ((12, (4,)), (256, (64,)), (768, (1, 256, 768))):
        s = torch.rand((B,), generator=gen, device="cuda").mul_(5.0)
        for k in ks:
            res[f"scores given ({B},) k {k}"] = device_ms(
                lambda: fp.pool_select_scores_cuda(s, 77, k))
    for name, ms in res.items():
        print(f"[select_probe] {name}: {ms * 1e3:.2f} us", flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "ms": res}))


if __name__ == "__main__":
    main()
