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


# --- the two CUDA kernels: the dispatch rule and the wgmma kernel ----------
# The rule, the checks and the tensor-map geometry are plain Python: they
# run here.
@pytest.mark.parametrize("dtype,hd,sq,aligned,kernel", [
    ("bfloat16", 128, 4096, True, "wgmma"),   # cell C prefill
    ("bfloat16", 128, 1024, True, "wgmma"),   # cells A, D and E
    ("bfloat16", 128, 1, True, "mma"),        # cell C decode
    ("bfloat16", 128, 63, True, "mma"),       # under WGMMA_MIN_ROWS
    ("bfloat16", 128, 64, True, "wgmma"),
    ("bfloat16", 128, 65, True, "wgmma"),
    ("bfloat16", 128, 64, False, "mma"),      # not TMA-aligned
    ("bfloat16", 128, 333, False, "mma"),
    ("bfloat16", 64, 1024, True, "mma"),      # other head dims
    ("bfloat16", 32, 64, True, "mma"),
    ("float32", 128, 1024, True, "mma"),      # f32
    ("float32", 16, 64, True, "mma"),         # lm-tiny
])
def test_dispatch_rule(dtype, hd, sq, aligned, kernel):
    from repro_torch.kernels.flash_attn.flash_attn import kernel_for
    assert kernel_for(getattr(torch, dtype), hd, sq, aligned) == kernel


@pytest.mark.parametrize("scale", [0.0, -0.1, float("nan")])
def test_dispatch_rule_sends_other_scales_to_mma(scale):
    """The wgmma kernel takes its row max on the unscaled scores, so only
    a positive softmax scale goes to it; the mma kernel takes any other."""
    from repro_torch.kernels.flash_attn.flash_attn import kernel_for, plan
    assert kernel_for(torch.bfloat16, 128, 1024, True, 0.05) == "wgmma"
    assert kernel_for(torch.bfloat16, 128, 1024, True, scale) == "mma"
    q = torch.zeros(2, 128, 6, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 128, 2, 128, dtype=torch.bfloat16)
    assert plan(q, k, k) == "wgmma"
    assert plan(q, k, k, scale) == "mma"


def _view_at(shape, offset, dtype=torch.bfloat16):
    """A contiguous tensor of ``shape`` whose base sits ``offset`` elements
    into a larger buffer (misaligned when offset·itemsize % 16 != 0)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def test_plan_names_the_kernel_from_the_tensors():
    from repro_torch.kernels.flash_attn.flash_attn import plan
    q = torch.zeros(2, 128, 6, 128, dtype=torch.bfloat16)
    cache = torch.zeros(2, 300, 2, 128, dtype=torch.bfloat16)
    k, v = cache[:, :128], cache[:, :128]
    assert plan(q, k, v) == "wgmma"
    assert plan(q[:, :1], k, v) == "mma"                  # decode
    # q 4-byte aligned (the mma kernel's rule), not 16 (TMA's)
    assert plan(_view_at(q.shape, 2), k, v) == "mma"
    # q's row stride 8 bytes off a multiple of 16
    qs = torch.zeros(2, 128, 6, 132, dtype=torch.bfloat16)[..., :128]
    assert plan(qs, k, v) == "mma"
    assert plan(q.float(), k.float(), v.float()) == "mma"


@pytest.mark.parametrize("case", ["bf16 hd 80", "f32 hd 256",
                                  "k rows misaligned", "hd stride",
                                  "k and v differ", "mixed dtypes",
                                  "not grouped"])
def test_plan_raises_for_a_call_neither_kernel_takes(case):
    from repro_torch.kernels.flash_attn.flash_attn import plan
    bf = torch.bfloat16
    q = torch.zeros(2, 128, 4, 128, dtype=bf)
    k = torch.zeros(2, 128, 2, 128, dtype=bf)
    v = k
    if case == "bf16 hd 80":
        q, k = q[..., :80].contiguous(), k[..., :80].contiguous()
        v = k
    elif case == "f32 hd 256":
        q = torch.zeros(2, 128, 4, 256)
        k = v = torch.zeros(2, 128, 2, 256)
    elif case == "k rows misaligned":
        k = v = _view_at(k.shape, 4)
    elif case == "hd stride":
        k = v = torch.zeros(2, 128, 2, 256, dtype=bf)[..., ::2]
    elif case == "k and v differ":
        v = torch.zeros(2, 100, 2, 128, dtype=bf)
    elif case == "mixed dtypes":
        v = k.float()
    elif case == "not grouped":
        k = v = torch.zeros(2, 128, 3, 128, dtype=bf)
    with pytest.raises(ValueError):
        plan(q, k, v)


def test_tma_geometry():
    """dims (hd, s, heads, b), then byte strides of s, heads and b; a
    prefix view of a cache maps its prefix n, not the cache's capacity."""
    from repro_torch.kernels.flash_attn.flash_attn import plan, tma_geometry
    q = torch.zeros(2, 100, 6, 128, dtype=torch.bfloat16)
    assert tma_geometry(q) == (128, 100, 6, 2, 6 * 256, 256, 100 * 6 * 256)
    # cell C: the serve path's prefix view of a 4160-slot cache
    cache = torch.zeros(3, 4160, 8, 128, dtype=torch.bfloat16)
    view = cache[:, :4096]
    assert tma_geometry(view) == (
        128, 4096, 8, 3, 8 * 256, 256, 4160 * 8 * 256)
    assert plan(torch.zeros(3, 4096, 24, 128, dtype=torch.bfloat16), view,
                view) == "wgmma"
    # a size-1 dim is never stepped over: contiguous strides stand in
    one = torch.zeros(5, 1, 2, 128, dtype=torch.bfloat16)[:1]
    assert tma_geometry(one) == (128, 1, 2, 1, 256, 256, 512)
    odd = torch.zeros(1, 64, 1, 128, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 128), (7, 128, 3, 1))
    assert tma_geometry(odd) == (128, 64, 1, 1, 256, 64 * 256, 64 * 256)


WGMMA_CASES = [
    # b, sq, skv, hq, hkv, window, q_offset, cache slots (0: no cache),
    # softmax scale (None: hd^-0.5)
    (2, 64, 64, 6, 2, 0, 0, 0, None),         # the rule's least sq, g = 3
    (2, 127, 127, 6, 2, 0, 0, 0, None),       # tile edges
    (2, 128, 128, 6, 2, 0, 0, 0, None),
    (2, 129, 129, 6, 2, 0, 0, 0, None),
    (3, 333, 333, 6, 2, 0, 0, 0, None),
    (2, 64, 127, 6, 2, 0, 63, 0, None),       # sq and skv on other edges
    (1, 127, 333, 6, 2, 0, 206, 400, None),
    (2, 77, 177, 4, 2, 0, 100, 300, None),    # sq > 1 at q_offset 100, k
                                              # and v prefix views of a
                                              # cache, g = 2
    (1, 300, 300, 4, 4, 100, 0, 0, None),     # a window, g = 1
    (2, 200, 456, 6, 3, 64, 256, 512, None),  # window and offset, a cache
    # windows at other scales: rows whose block's first kv tile is wholly
    # masked for them must stay finite
    (1, 300, 300, 4, 4, 100, 0, 0, 0.1),
    (2, 200, 456, 6, 3, 64, 256, 512, 0.2),
    # more work tiles (b·hq·⌈sq/128⌉ = 144) than an H100 has SMs (132),
    # so blocks of the persistent grid walk two tiles each
    (8, 333, 333, 6, 2, 0, 0, 0, None),
    (12, 200, 456, 6, 3, 64, 256, 512, 0.2),
]


def _wgmma_inputs(cuda, b, sq, skv, hq, hkv, q_offset, slots, q_scale=1.0):
    q, k, v = (torch.from_numpy(t).to(cuda, torch.bfloat16)
               for t in _qkv(b, sq, max(skv, slots), hq, hkv, 128,
                             seed=sq + q_offset))
    q = (q.float() * q_scale).bfloat16()
    if slots:
        k, v = k[:, :skv], v[:, :skv]
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("q_scale", [1.0, 6.0])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,window,q_offset,slots,scale",
                         WGMMA_CASES)
def test_wgmma_kernel_matches_plain_on_gpu(cuda, q_scale, b, sq, skv, hq,
                                           hkv, window, q_offset, slots,
                                           scale):
    """The wgmma kernel (bf16, hd 128) against the plain version on the
    card, within the bf16 ``tol`` of every output and ``ROW_REL`` of each
    row's scale, no NaN; its counter moves and the mma kernel's does not."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    tol = 3e-2
    q, k, v = _wgmma_inputs(cuda, b, sq, skv, hq, hkv, q_offset, slots,
                            q_scale)
    kw = dict(window=window, q_offset=q_offset, scale=scale)
    before = dict(k5.launches_by_kernel)
    got = flash_attention(q, k, v, **kw)
    assert k5.launches_by_kernel == dict(before, wgmma=before["wgmma"] + 1)
    want = flash_attention(q.float(), k.float(), v.float(), interpret=True,
                           **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert _row_rel_err(got, want) <= ROW_REL["bfloat16"]


@pytest.mark.gpu
def test_negative_scale_runs_on_the_mma_kernel_on_gpu(cuda):
    """A bf16 hd-128 prefill at a negative softmax scale goes to the mma
    kernel, which takes its row max on the scaled scores, and matches the
    plain version."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    q, k, v = _wgmma_inputs(cuda, 2, 200, 200, 6, 2, 0, 0)
    before = dict(k5.launches_by_kernel)
    got = flash_attention(q, k, v, scale=-0.1)
    assert k5.launches_by_kernel == dict(before, mma=before["mma"] + 1)
    want = flash_attention(q.float(), k.float(), v.float(), interpret=True,
                           scale=-0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    assert _row_rel_err(got, want) <= ROW_REL["bfloat16"]


@pytest.mark.gpu
def test_wgmma_two_launches_give_the_same_bits(cuda):
    """No atomics: the same inputs give the same bits, launch after launch
    (serve's tokens are reproduced through the K5 route on that)."""
    q, k, v = _wgmma_inputs(cuda, 2, 1000, 1000, 24, 8, 0, 0, 6.0)
    first = flash_attention(q, k, v)
    assert torch.equal(flash_attention(q, k, v), first)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bf16 hd 80", "f32 hd 256"])
def test_cuda_call_neither_kernel_takes_raises(cuda, case):
    """A CUDA call that neither kernel takes raises: no fallback to the
    other kernel or to the plain version."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    if case == "bf16 hd 80":
        q = torch.zeros(2, 128, 4, 80, dtype=torch.bfloat16, device=cuda)
        k = torch.zeros(2, 128, 2, 80, dtype=torch.bfloat16, device=cuda)
    else:
        q = torch.zeros(2, 128, 4, 256, device=cuda)
        k = torch.zeros(2, 128, 2, 256, device=cuda)
    before = k5.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    assert k5.launches == before
