"""K2 (``row_score``) and K3 (``pool_keys``) on the card against their
plain versions, and ``select_pool`` / ``fused_presample`` on the card
against their plain routes. Every case needs an NVIDIA Hopper GPU and
``nvcc`` (``gpu`` marker) and skips elsewhere; the module imports no jax,
so it runs where the card is:

    python -m pytest -q -m gpu tests/test_torch_pool_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_presample.ops import (  # noqa: E402
    fused_presample, select_pool)
from repro_torch.kernels.fused_presample.ref import (  # noqa: E402
    fused_presample_ref)

RTOL = 1e-5       # K2 vs plain: f32 row sums in another order
SEL_RTOL = 1e-6   # probs, weights, threshold on identical score bytes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (the kernels are sm_90a "
                    "CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(12, 1024), (768, 4096), (37, 13)])
def test_row_score_kernel_matches_plain_on_gpu(cuda, B, T):
    """K2 against its plain version on the card, a 20 % mask."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.fused_presample.ops import _row_score
    gen = torch.Generator(device=cuda).manual_seed(B)
    g2 = torch.rand((B, T), generator=gen, device=cuda) * 2.0
    mask = torch.rand((B, T), generator=gen, device=cuda) >= 0.2
    before = fp.row_score_launches
    got = _row_score(g2, mask)
    assert fp.row_score_launches == before + 1
    torch.testing.assert_close(got, fp.row_score_math(g2, mask), rtol=RTOL,
                               atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [12, 100, 768, 1024])
@pytest.mark.parametrize("ctx", [0, 0xFFFFFFFF])
def test_pool_keys_kernel_matches_plain_on_gpu(cuda, B, ctx):
    """K3 against its plain version on the card, fed the same scores and
    1/Σs, with a −1 pad lane: the keys bitwise, and ``select_pool`` on
    the card equal to its plain route."""
    from repro_torch.kernels.fused_presample import fused_presample as fp
    from repro_torch.kernels.fused_presample.ops import _pool_keys
    s = torch.from_numpy(np.random.default_rng(B).uniform(
        0.01, 5.0, B).astype(np.float32)).to(cuda)
    s[B // 2] = -1.0
    inv_total = (1.0 / torch.clamp(s.clamp(min=0).sum(), min=1e-20)) \
        .reshape(1)
    before = fp.pool_keys_launches
    got = _pool_keys(s, ctx, inv_total)
    assert fp.pool_keys_launches == before + 1
    assert torch.equal(got, fp.pool_keys_plain(s, ctx, inv_total))
    k = B // 4
    on_card = select_pool(s, ctx, k=k)
    plain = select_pool(s, ctx, k=k, interpret=True)
    assert torch.equal(on_card[0], plain[0])
    for a, b in zip(on_card[1:], plain[1:]):
        torch.testing.assert_close(a, b, rtol=SEL_RTOL, atol=0)


@pytest.mark.gpu
def test_fused_presample_on_gpu_matches_plain(cuda):
    """The whole op on the card (K1, K2, K3) against its plain version on
    the same tensors: equal indices and rows, scores and weights to 1e-5."""
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
    before = (k1.ce_score_launches, fp.row_score_launches,
              fp.pool_keys_launches)
    sel, idx, w, s = fused_presample(z, y, rows, 777, k=k)
    assert (k1.ce_score_launches, fp.row_score_launches,
            fp.pool_keys_launches) == tuple(n + 1 for n in before)
    sel_r, idx_r, w_r, s_r = fused_presample_ref(z, y, rows, 777, k=k)
    assert torch.equal(idx, idx_r)
    for name in rows:
        assert torch.equal(sel[name], sel_r[name])
    torch.testing.assert_close(s, s_r, rtol=RTOL, atol=1e-6)
    torch.testing.assert_close(w, w_r, rtol=RTOL, atol=0)
