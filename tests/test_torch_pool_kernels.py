"""``pool_select`` (K2 and K3 as one launch, with the selection tail) on the
card against its plain version, and ``select_pool`` / ``fused_presample``
on the card against their plain routes. Every case needs an NVIDIA Hopper
GPU and ``nvcc`` (``gpu`` marker) and skips elsewhere; the module imports
no jax, so it runs where the card is:

    python -m pytest -q -m gpu tests/test_torch_pool_kernels.py

Each stage is held on its own, fed the kernel's own earlier outputs: the
scores against ``row_score_math`` to rtol 1e-5 (f32 row sums in another
order); 1/Σs to 1e-6 relative (Σs in another order); the keys bitwise
against ``pool_keys_plain`` on the kernel's scores and 1/Σs; the indices
and threshold equal to ``_bottom_k`` of the kernel's keys; probs and
weights to 1e-6 relative against ``ht_weights`` on the kernel's indices
and threshold. (The plain version's own selection from its own Σs may
order keys that lie within an ulp of each other the other way: at 70 000
rows it does.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_presample.ops import (  # noqa: E402
    fused_presample, select_pool)
from repro_torch.kernels.fused_presample.ref import (  # noqa: E402
    fused_presample_ref)

RTOL = 1e-5       # scores vs plain: f32 row sums in another order
SEL_RTOL = 1e-6   # probs, weights, threshold, 1/Σs on identical scores


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (the kernels are sm_90a "
                    "CUDA)")
    return torch.device("cuda")


def _g2_mask(B, T, device, seed, offset=0):
    """Seeded (B, T) ĝ² and a 20 % mask; ``offset`` floats off the
    allocation's 16-byte alignment (the kernel's scalar route)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand((B * T + offset,), generator=gen, device=device) * 2.0
    mask = torch.rand((B, T), generator=gen, device=device) >= 0.2
    return flat[offset:].view(B, T), mask


def _check_stages(out, ctx, k):
    """Each of the launch's outputs against the plain version fed the
    kernel's own earlier outputs."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.topk_keys.ops import _bottom_k
    s, inv_total, keys, idx, probs, w, thr = out
    B = s.shape[0]
    total = torch.clamp(s.sum(), min=1e-20)
    torch.testing.assert_close(inv_total, (1.0 / total).reshape(1),
                               rtol=SEL_RTOL, atol=0)
    assert torch.equal(keys, fp.pool_keys_plain(s, ctx, inv_total))
    if k < B:
        vals, slots = _bottom_k(keys, k + 1)
        assert torch.equal(idx, slots[:k])
        assert torch.equal(thr, vals[k])
        want = fp.ht_weights(s, total, idx, thr)
    else:
        assert torch.equal(idx, torch.arange(B, device=s.device))
        assert float(thr) == float("inf")
        want = s / total, torch.full_like(s, 1.0 / max(B, 1))
    for a, b in zip((probs, w), want):
        torch.testing.assert_close(a, b, rtol=SEL_RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kk", ["1", "B/4", "B-1", "B"])
@pytest.mark.parametrize("B,T,offset", [(12, 1024, 0), (768, 4096, 0),
                                        (37, 13, 0), (70000, 8, 0),
                                        (12, 1024, 1)])
def test_pool_select_stages_match_plain_on_gpu(cuda, B, T, offset, kk):
    """Scores, keys, selection and weights at cell E's pool (12, 1024),
    prod's (768, 4096), a ragged (37, 13), 70 000 rows (keys and winners
    beyond shared memory) and a g2 off 16-byte alignment."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    k = {"1": 1, "B/4": B // 4, "B-1": B - 1, "B": B}[kk]
    g2, mask = _g2_mask(B, T, cuda, seed=B + offset)
    before = fp.pool_select_launches
    out = fp.pool_select_cuda(g2, mask, 777, k)
    assert fp.pool_select_launches == before + 1
    torch.testing.assert_close(out[0], fp.row_score_math(g2, mask),
                               rtol=RTOL, atol=0)
    _check_stages(out, 777, k)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [12, 100, 768, 1024])
@pytest.mark.parametrize("ctx", [0, 0xFFFFFFFF])
def test_pool_select_given_scores_match_plain_on_gpu(cuda, B, ctx):
    """The launch with the scores given, a −1 pad lane: keys bitwise, and
    ``select_pool`` on the card equal to its plain route."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    s = torch.from_numpy(np.random.default_rng(B).uniform(
        0.01, 5.0, B).astype(np.float32)).to(cuda)
    s[B // 2] = -1.0
    k = B // 4
    out = fp.pool_select_scores_cuda(s, ctx, k)
    assert out[0] is s
    _check_stages(out, ctx, k)
    before = fp.pool_select_launches
    on_card = select_pool(s, ctx, k=k)
    assert fp.pool_select_launches == before + 1
    plain = select_pool(s, ctx, k=k, interpret=True)
    assert torch.equal(on_card[0], plain[0])
    for a, b in zip(on_card[1:], plain[1:]):
        torch.testing.assert_close(a, b, rtol=SEL_RTOL, atol=0)


@pytest.mark.gpu
def test_pool_select_pad_ties_go_to_the_lower_row_on_gpu(cuda):
    """70 of 100 rows padded, k + 1 = 51 > 30 live rows: the +inf ties
    among the winners go to the lowest pad rows, in row order."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    B, k = 100, 50
    rng = np.random.default_rng(7)
    s = rng.uniform(5.0, 10.0, B).astype(np.float32)
    pads = np.sort(rng.permutation(B)[:70])
    s[pads] = -1.0
    out = fp.pool_select_scores_cuda(torch.from_numpy(s).to(cuda), 4211, k)
    _check_stages(out, 4211, k)
    assert float(out[6]) == float("inf")
    np.testing.assert_array_equal(out[3][30:].cpu().numpy(), pads[:k - 30])


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,k", [(12, 1024, 4), (768, 4096, 256),
                                   (70000, 8, 20000)])
def test_pool_select_two_launches_give_the_same_bits(cuda, B, T, k):
    """Σs and the row sums run in a fixed order: the same bits twice."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    g2, mask = _g2_mask(B, T, cuda, seed=5)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    first = fp.pool_select_cuda(g2, mask, 31, k)
    second = fp.pool_select_cuda(g2, mask, 31, k)
    for a, b in zip(first, second):
        assert torch.equal(bits(a), bits(b))


@pytest.mark.gpu
def test_fused_presample_on_gpu_matches_plain(cuda):
    """The whole op on the card (K1, then one pool_select launch) against
    its plain version on the same tensors: equal indices and rows, scores
    and weights to 1e-5."""
    from repro_torch.kernels.ce_score import ce_score as k1
    from repro_torch.kernels.fused_presample import fused_presample as fp
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, T, V, k = 12, 64, 32003, 4
    z = (torch.randn((B, T, V), generator=gen, device=cuda)
         * torch.linspace(0.5, 4.0, B, device=cuda)[:, None, None])
    z = z.to(torch.bfloat16)
    y = torch.randint(0, V, (B, T), generator=gen, device=cuda,
                      dtype=torch.int32)
    y[:, ::7] = -1
    rows = {"tokens": torch.arange(B * T, device=cuda).reshape(B, T),
            "labels": y}
    before = (k1.ce_score_launches, fp.pool_select_launches)
    sel, idx, w, s = fused_presample(z, y, rows, 777, k=k)
    assert (k1.ce_score_launches, fp.pool_select_launches) == \
        tuple(n + 1 for n in before)
    sel_r, idx_r, w_r, s_r = fused_presample_ref(z, y, rows, 777, k=k)
    assert torch.equal(idx, idx_r)
    for name in rows:
        assert torch.equal(sel[name], sel_r[name])
    torch.testing.assert_close(s, s_r, rtol=RTOL, atol=1e-6)
    torch.testing.assert_close(w, w_r, rtol=RTOL, atol=0)
