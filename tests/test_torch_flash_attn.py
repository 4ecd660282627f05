"""K5, ``flash_attention``: the port's op (its plain version on the CPU) and
its oracle ``flash_attention_ref`` against the JAX op (Pallas kernel in
interpret mode) and the JAX oracle, on the same seeded inputs: the grid of
``tests/test_kernels.py`` (MHA, GQA, padding, sliding window; f32 to 2e-4,
bf16 to 3e-2), the decode offset, and the port's own ``online_attention``.
The CUDA kernel is held against the plain version on the card (the ``gpu``
cases below, and ``chip_smoke.py``). The JAX package loads in a fixture,
so the ``gpu`` cases also run on a card's machine that has no JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attn.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro_torch.models.attention import online_attention  # noqa: E402


@pytest.fixture(scope="module")
def jax_k5():
    """(jax.numpy, the JAX op, the JAX oracle)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attn.ops import flash_attention as jax_op
    from repro.kernels.flash_attn.ref import flash_attention_ref as jax_ref
    return jnp, jax_op, jax_ref


def _qkv(b, sq, skv, hq, hkv, hd, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, hd).astype(np.float32),
            rng.randn(b, skv, hkv, hd).astype(np.float32),
            rng.randn(b, skv, hkv, hd).astype(np.float32))


def _fold(q, k, v):
    """numpy fold of (b, s, h, hd) GQA into the oracle's (B, s, hd)."""
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, sq, hkv, g, hd).transpose(0, 2, 3, 1, 4) \
        .reshape(-1, sq, hd)

    def kv(t):
        return np.broadcast_to(t.transpose(0, 2, 1, 3)[:, :, None],
                               (b, hkv, g, skv, hd)).reshape(-1, skv, hd)
    return qf, kv(k), kv(v)


def _unfold(o, b, sq, hq, hkv, hd):
    return o.reshape(b, hkv, hq // hkv, sq, hd).transpose(0, 3, 1, 2, 4) \
        .reshape(b, sq, hq, hd)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("s,hq,hkv,hd,bq,bk,window", [
    (32, 4, 4, 16, 16, 16, 0),     # MHA, exact tiles
    (48, 4, 2, 16, 16, 16, 0),     # GQA
    (33, 2, 1, 8, 16, 16, 0),      # padding
    (64, 2, 2, 16, 16, 16, 24),    # sliding window
])
def test_flash_attention_matches_reference(jax_k5, s, hq, hkv, hd, bq, bk,
                                           window, dtype, tol):
    jnp, jax_op, jax_ref = jax_k5
    q, k, v = _qkv(2, s, s, hq, hkv, hd, seed=s + hq)
    jdt = getattr(jnp, dtype)
    want_op = np.asarray(jax_op(*(jnp.asarray(t).astype(jdt)
                                  for t in (q, k, v)),
                                window=window, block_q=bq, block_k=bk),
                         np.float32)
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(t).to(tdt) for t in (q, k, v))
    got = flash_attention(qt, kt, vt, window=window, block_q=bq, block_k=bk)
    assert got.dtype == tdt and got.shape == (2, s, hq, hd)
    # the oracle on the rounded inputs, as tests/test_kernels.py holds it
    qr, kr, vr = (t.float().numpy() for t in (qt, kt, vt))
    want_ref = _unfold(np.asarray(jax_ref(*map(jnp.asarray,
                                               _fold(qr, kr, vr)),
                                          causal=True, window=window)),
                       2, s, hq, hkv, hd)
    got_ref = _unfold(flash_attention_ref(
        *map(torch.from_numpy, _fold(qr, kr, vr)), causal=True,
        window=window).numpy(), 2, s, hq, hkv, hd)
    np.testing.assert_allclose(got_ref, want_ref, rtol=2e-4, atol=2e-4)
    for want in (want_op, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_flash_attention_decode_offset(jax_k5):
    """Decode: one query at the cache end equals full-cache attention."""
    jnp, jax_op, jax_ref = jax_k5
    S = 40
    q, k, v = _qkv(1, 1, S, 2, 2, 16, seed=7)
    want = np.asarray(jax_op(*map(jnp.asarray, (q, k, v)), q_offset=S - 1,
                             block_q=8, block_k=16))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=S - 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    oref = jax_ref(*map(jnp.asarray, _fold(q, k, v)), causal=True,
                   q_offset=S - 1)
    np.testing.assert_allclose(got.numpy().ravel(), np.asarray(oref).ravel(),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_matches_online_attention():
    """The kernel's plain version and the model's blockwise online softmax
    compute the same causal attention (GQA, ragged chunks)."""
    b, s, hq, hkv, hd = 2, 70, 6, 2, 16
    q, k, v = map(torch.from_numpy, _qkv(b, s, s, hq, hkv, hd, seed=3))
    pos = torch.arange(s)[None].expand(b, s)
    want = online_attention(q, k, v, pos, pos, q_chunk=16, kv_chunk=32)
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_plain_route_is_chosen_by_device_or_interpret():
    q, k, v = map(torch.from_numpy, _qkv(1, 9, 9, 4, 2, 16, seed=5))
    want = flash_attention(q, k, v, interpret=True)
    for interp in (None, False):
        assert torch.equal(flash_attention(q, k, v, interpret=interp), want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (the kernel is sm_90a CUDA)")
    return torch.device("cuda")


GPU_CASES = [
    # b, sq, skv, hq, hkv, hd, window, q_offset, cache slots (0: no cache)
    (2, 77, 77, 6, 2, 64, 0, 0, 0),        # ragged prefill, g = 3
    (2, 1, 300, 6, 2, 128, 0, 299, 320),   # decode from a cache view, split
    (1, 130, 130, 4, 4, 32, 40, 0, 0),     # sliding window
    (3, 5, 70, 8, 2, 16, 0, 65, 96),       # a block at a cache's end
    (1, 200, 200, 2, 1, 128, 0, 0, 0),     # several row blocks, g = 2
]


# Each query row's worst error against the largest |output| of that row,
# the oracle in f32 on the kernel's (rounded) inputs: the bf16 kernel
# rounds its output (at most 2^-8 of an element) and P for the PV product;
# the f32 kernel differs by summation order and __expf. An absolute bound
# alone is about one typical output late in a long causal row (rms about
# sqrt(e / n) for randn inputs), so it would miss a fault in late tiles.
ROW_REL = {"bfloat16": 1.5e-2, "float32": 1e-5}


def _row_rel_err(got, want):
    """max over query rows of max|got − want| / max|want| (over hd)."""
    err = (got.float() - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("q_scale", [1.0, 6.0])   # 6: a peaked softmax
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 3e-2), ("float32", 2e-4)])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,hd,window,q_offset,slots",
                         GPU_CASES)
def test_kernel_matches_plain_on_gpu(cuda, dtype, tol, q_scale, b, sq, skv,
                                     hq, hkv, hd, window, q_offset, slots):
    """The CUDA kernel against its plain version on the card, k and v read
    through their strides (a prefix view of a larger cache where
    ``slots``): within ``tol`` of every output and within ``ROW_REL`` of
    each row's scale."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to(cuda, tdt)
               for t in _qkv(b, sq, max(skv, slots), hq, hkv, hd, seed=sq))
    q = (q.float() * q_scale).to(tdt)
    if slots:
        k, v = k[:, :skv], v[:, :skv]
    before = k5.launches
    got = flash_attention(q, k, v, window=window, q_offset=q_offset)
    assert k5.launches == before + 1
    want = flash_attention(q.float(), k.float(), v.float(), window=window,
                           q_offset=q_offset, interpret=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert _row_rel_err(got, want) <= ROW_REL[dtype]


@pytest.mark.gpu
def test_forward_only_route_is_chosen_on_cuda(cuda, monkeypatch):
    """On CUDA tensors a forward-only pass without explicit positions runs
    every layer's attention through the kernel with q_offset 0 (the CPU
    keeps the plain paths: ``test_torch_models``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attn as k5
    from repro_torch.kernels.flash_attn import ops as k5_ops
    from repro_torch.models.lm import LM
    calls = []
    real = k5_ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw["q_offset"])
        return real(*a, **kw)
    monkeypatch.setattr(k5_ops, "flash_attention", spy)
    lm = LM(get_config("lm-tiny"), cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, lm.cfg.vocab_size, (2, 40))).to(cuda)
    before = k5.launches
    with torch.inference_mode():
        lm({"tokens": toks})
    n = lm.cfg.segments[0].repeats
    assert calls == [0] * n and k5.launches == before + n
