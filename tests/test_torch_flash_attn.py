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
    ("bfloat16", 256, 1024, True, "wgmma"),   # gemma3's prefill: hd 256
    ("bfloat16", 256, 64, True, "wgmma"),
    ("bfloat16", 256, 63, True, "mma"),       # under WGMMA_MIN_ROWS
    ("bfloat16", 256, 1024, False, "mma"),    # not TMA-aligned
    ("bfloat16", 256, 1, True, "decode"),     # gemma3's decode: the
    ("bfloat16", 256, 1, False, "decode"),    # decode kernel, any alignment
    ("bfloat16", 256, 2, True, "mma"),        # a short hd-256 prefill
    ("float32", 128, 1024, True, "f32"),      # f32 prefill: the f32 kernel
    ("float32", 16, 64, True, "f32"),         # lm-tiny
    ("float32", 64, 1024, True, "f32"),       # lm-100m's pool (cell I)
    ("float32", 32, 16, True, "f32"),         # F32_MIN_ROWS
    ("float32", 16, 40, True, "f32"),         # reduced gemma3's prompt
    ("float32", 64, 15, True, "mma"),         # under F32_MIN_ROWS
    ("float32", 64, 1024, False, "mma"),      # not 16-byte aligned
    ("float32", 80, 1024, True, "mma"),       # a head dim it has no tile for
    ("float32", 64, 1, True, "mma"),          # f32 decode (lm-100m)
    ("float32", 16, 1, True, "mma"),          # lm-tiny's decode
])
def test_dispatch_rule(dtype, hd, sq, aligned, kernel):
    from repro_torch.kernels.flash_attn.flash_attn import kernel_for
    assert kernel_for(getattr(torch, dtype), hd, sq, aligned) == kernel


@pytest.mark.parametrize("scale", [0.0, -0.1, float("nan")])
def test_dispatch_rule_sends_other_scales_to_mma(scale):
    """The wgmma kernel takes its row max on the unscaled scores, so only
    a positive softmax scale goes to it; the mma kernel takes any other.
    The decode kernel takes its max on the scaled scores: any scale."""
    from repro_torch.kernels.flash_attn.flash_attn import kernel_for, plan
    assert kernel_for(torch.bfloat16, 128, 1024, True, 0.05) == "wgmma"
    assert kernel_for(torch.bfloat16, 128, 1024, True, scale) == "mma"
    assert kernel_for(torch.bfloat16, 256, 1, True, scale) == "decode"
    q = torch.zeros(2, 128, 6, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 128, 2, 128, dtype=torch.bfloat16)
    assert plan(q, k, k) == "wgmma"
    assert plan(q, k, k, scale) == "mma"


@pytest.mark.parametrize("scale", [0.0, -0.1, 0.05, float("nan")])
def test_f32_route_takes_any_scale(scale):
    """The f32 kernel takes its row max on the scaled scores, as the mma
    kernel does: the scale does not move an f32 call off its route."""
    from repro_torch.kernels.flash_attn.flash_attn import kernel_for, plan
    assert kernel_for(torch.float32, 64, 1024, True, scale) == "f32"
    q = torch.zeros(2, 64, 10, 64)
    k = torch.zeros(2, 64, 5, 64)
    assert plan(q, k, k, scale) == "f32"


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
    # f32: the f32 kernel for a prefill with 16-byte aligned q, k, v; the
    # mma kernel for a decode, a short call and views off 16 bytes
    assert plan(q.float(), k.float(), v.float()) == "f32"
    cache32 = torch.zeros(2, 300, 2, 128)
    assert plan(q.float(), cache32[:, :128], cache32[:, :128]) == "f32"
    assert plan(q[:, :1].float(), k.float(), v.float()) == "mma"
    assert plan(q[:, :15].float(), k.float(), v.float()) == "mma"
    assert plan(q[:, :16].float(), k.float(), v.float()) == "f32"
    assert plan(_view_at(q.shape, 2, torch.float32), k.float(),
                v.float()) == "mma"                     # base 8 bytes off
    rows = torch.zeros(2, 300, 2, 132)[..., :128]      # strides 264, 132
    assert plan(q.float(), rows[:, :128], rows[:, :128]) == "f32"
    rows = torch.zeros(2, 300, 2, 130)[..., :128]      # head stride 130
    assert plan(q.float(), rows[:, :128], rows[:, :128]) == "mma"
    # a size-1 dim's stride is never stepped over
    one = torch.zeros(3, 128, 6, 128)[:1]
    assert plan(one.as_strided(one.shape, (7, 768, 128, 1)),
                cache32[:1, :128], cache32[:1, :128]) == "f32"
    # gemma3's head dim: the wgmma kernel for the prefill over a prefix
    # view, the mma kernel for the decode and for a q off TMA's alignment
    q256 = torch.zeros(2, 128, 16, 256, dtype=torch.bfloat16)
    ring = torch.zeros(2, 1024, 8, 256, dtype=torch.bfloat16)
    assert plan(q256, ring[:, :128], ring[:, :128]) == "wgmma"
    assert plan(q256[:, :1], ring, ring) == "decode"
    assert plan(_view_at(q256.shape, 2), ring[:, :128], ring[:, :128]) \
        == "mma"
    # the decode kernel over a prefix view, and for a q 4-byte aligned
    # only (it reads q by 4-byte words); hd 128's decode stays on mma
    assert plan(q256[:, :1], ring[:, :701], ring[:, :701]) == "decode"
    assert plan(_view_at((2, 1, 16, 256), 2), ring, ring) == "decode"
    assert plan(q[:, :1], k, v) == "mma"


@pytest.mark.parametrize("case", ["bf16 hd 80", "f32 hd 256",
                                  "f32 hd 256 decode",
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
    elif case == "f32 hd 256 decode":
        q = torch.zeros(2, 1, 4, 256)
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
    # hd 256 (gemma3): the prefix view of a 1088-slot cache, 8 kv heads
    cache = torch.zeros(8, 1088, 8, 256, dtype=torch.bfloat16)
    view = cache[:, :1024]
    assert tma_geometry(view) == (
        256, 1024, 8, 8, 8 * 512, 512, 1088 * 8 * 512)
    assert plan(torch.zeros(8, 1024, 16, 256, dtype=torch.bfloat16), view,
                view) == "wgmma"


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
@pytest.mark.parametrize("case", ["bf16 hd 80", "f32 hd 256",
                                  "f32 hd 256 decode"])
def test_cuda_call_neither_kernel_takes_raises(cuda, case):
    """A CUDA call that neither kernel takes raises: no fallback to the
    other kernel or to the plain version."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    if case == "bf16 hd 80":
        q = torch.zeros(2, 128, 4, 80, dtype=torch.bfloat16, device=cuda)
        k = torch.zeros(2, 128, 2, 80, dtype=torch.bfloat16, device=cuda)
    else:
        q = torch.zeros(2, 128 if case == "f32 hd 256" else 1, 4, 256,
                        device=cuda)
        k = torch.zeros(2, 128, 2, 256, device=cuda)
    before = k5.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    assert k5.launches == before


# --- hd 256 (gemma3-12b: 16/8 heads, sliding window 1024) ------------------
HD256_CASES = [
    # b, sq, skv, window, q_offset, cache slots, causal, q scale
    (8, 1024, 1024, 1024, 0, 0, True, 1.0),     # prefill, window = sq
    (8, 1024, 1024, 0, 0, 0, True, 1.0),        # global layer's prefill
    (8, 1024, 1024, 1024, 0, 0, True, 6.0),     # peaked
    (2, 4096, 4096, 1024, 0, 0, True, 1.0),     # the window cuts
    (8, 1, 701, 1024, 700, 1024, True, 1.0),    # decode before the wrap
    (8, 1, 1024, 0, 0, 0, False, 1.0),          # decode over a full ring
    (8, 1, 1024, 0, 0, 0, False, 6.0),
    (2, 77, 177, 64, 100, 300, True, 1.0),      # ragged, offset, window
]


def _off_tma(t):
    """A copy of ``t`` whose base sits 4 bytes off a 16-byte boundary: TMA
    refuses it, so the dispatch rule sends a prefill to the mma kernel."""
    buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
    return buf[2:].view(t.shape).copy_(t)


def _hd256_check(q, k, v, kernel, **kw):
    """K5 at hd 256 on the card against its plain version in f32 on the
    same inputs (two batch rows at a time): within 3e-2 of every output
    and 1.5e-2 of each row's largest |output|, ``kernel``'s count alone
    moving; returns the output."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    before = dict(k5.launches_by_kernel)
    got = flash_attention(q, k, v, **kw)
    assert k5.launches_by_kernel == dict(before,
                                         **{kernel: before[kernel] + 1})
    want = torch.cat([flash_attention(q[i:i + 2].float(), k[i:i + 2].float(),
                                      v[i:i + 2].float(), interpret=True,
                                      **kw) for i in range(0, q.shape[0], 2)])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    assert _row_rel_err(got, want) <= ROW_REL["bfloat16"]
    return got


def _hd256_inputs(cuda, b, sq, skv, slots, q_scale, hq=16, hkv=8):
    q, k, v = (torch.from_numpy(t).to(cuda, torch.bfloat16) for t in
               _qkv(b, sq, max(skv, slots), hq, hkv, 256, seed=sq + skv))
    q = (q.float() * q_scale).to(torch.bfloat16)
    return q, k[:, :skv], v[:, :skv]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,window,q_offset,slots,causal,q_scale",
                         HD256_CASES)
def test_hd256_kernel_matches_plain_on_gpu(cuda, b, sq, skv, window,
                                           q_offset, slots, causal, q_scale):
    """K5 at hd 256 in bf16 against its plain version in f32 on the same
    inputs, at the shapes of ``chip_smoke.py``'s phase 23, on the kernel
    the dispatch rule names (wgmma for the prefill shapes, mma for the
    decode); a prefill also on the mma kernel (Q staged in shared memory)
    through a copy of q off TMA's alignment."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    q, k, v = _hd256_inputs(cuda, b, sq, skv, slots, q_scale)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    kernel = k5.kernel_for(q.dtype, 256, sq, True)
    counter = {"wgmma": "wgmma256", "decode": "decode256"}.get(kernel,
                                                              kernel)
    _hd256_check(q, k, v, counter, **kw)
    if sq > 1:
        _hd256_check(_off_tma(q), k, v, "mma", **kw)


WGMMA256_CASES = [
    # b, sq, skv, hq, hkv, window, q_offset, cache slots, softmax scale
    # (None: hd^-0.5), causal
    (1, 64, 64, 2, 1, 0, 0, 0, None, True),         # the rule's least sq
    (2, 150, 150, 16, 8, 0, 0, 0, None, True),      # group 1 of the 2nd
                                                    # tile wholly past sq
    (2, 77, 177, 16, 8, 64, 100, 300, None, True),  # ragged, offset,
                                                    # window, prefix views
    (8, 1024, 1024, 16, 8, 1024, 0, 1088, None, True),  # gemma3's prefill
                                                        # over a 1088-slot
                                                        # cache's prefix
    (2, 4096, 4096, 16, 8, 1024, 0, 0, None, True),  # the window cuts (the
                                                     # walk row block first)
    (12, 200, 456, 16, 8, 64, 256, 512, 0.2, True),  # batch 12, blocks walk
                                                     # two tiles; rows whose
                                                     # first kv tile is
                                                     # wholly masked
    (2, 300, 300, 16, 8, 0, 0, 0, None, False),     # not causal
]


@pytest.mark.gpu
@pytest.mark.parametrize("q_scale", [1.0, 6.0])
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,window,q_offset,slots,scale,causal", WGMMA256_CASES)
def test_wgmma256_kernel_matches_plain_on_gpu(cuda, q_scale, b, sq, skv, hq,
                                              hkv, window, q_offset, slots,
                                              scale, causal):
    """The wgmma kernel at hd 256 (``flash_attn_fwd_wgmma256.cu``) against
    the plain version on the card: windows, offsets, prefix views of a
    cache, peaked q, batch 12, a softmax scale of 0.2, not causal; the
    wgmma256 count alone moving."""
    q, k, v = _hd256_inputs(cuda, b, sq, skv, slots, q_scale, hq, hkv)
    _hd256_check(q, k, v, "wgmma256", window=window, q_offset=q_offset,
                 scale=scale, causal=causal)


@pytest.mark.gpu
def test_wgmma256_two_launches_give_the_same_bits(cuda):
    """No atomics and a static walk: gemma3's prefill on the same inputs
    gives the same bits, launch after launch."""
    q, k, v = _hd256_inputs(cuda, 8, 1024, 1024, 0, 6.0)
    first = flash_attention(q, k, v, window=1024)
    for _ in range(2):
        assert torch.equal(flash_attention(q, k, v, window=1024), first)


# --- the hd-256 decode kernel (flash_attn_decode.cu) -------------------------
# The split rule and the key walk are plain Python: they run here.
H100_SMS = 132


def _decode_tiles(split, nsplit, n_keys, tile=32):
    """The tiles [t0, t1) of split ``split`` of ``nsplit`` over ``n_keys``
    keys, as flash_attn_decode.cu cuts them (``tile``: its kTile)."""
    tiles = -(-n_keys // tile)
    return split * tiles // nsplit, (split + 1) * tiles // nsplit


def _decode_walk(lo, hi, nsplit, warps=8, keys=4):
    """The keys the decode kernel visits, as its index math walks them
    (``warps`` and ``keys``: flash_attn_decode.cu's kWarps, kKeys): split
    s takes the tiles ``_decode_tiles`` gives it (clipped to hi); warp w
    of a split takes chunks of ``keys`` keys at w·keys + c·warps·keys."""
    from repro_torch.kernels.flash_attn.flash_attn import DECODE_TILE
    tile = warps * keys
    assert tile == DECODE_TILE
    seen = []
    for s in range(nsplit):
        t0, t1 = _decode_tiles(s, nsplit, hi - lo)
        k0, k1 = lo + t0 * tile, min(hi, lo + t1 * tile)
        assert t1 > t0 and k0 < k1, (s, t0, t1)  # at least one tile, a key
        for w in range(warps):
            first = k0 + w * keys
            nchunks = -(-(k1 - first) // tile) if first < k1 else 0
            for c in range(nchunks):
                key0 = first + c * tile
                assert key0 < k1                 # a chunk's first key is real
                seen += [key0 + i for i in range(keys) if key0 + i < k1]
    return seen


@pytest.mark.parametrize("b,n_keys", [
    (8, 1024),                                  # cell F: a full ring
    (8, 1), (8, 7), (8, 700),                   # rings before the wrap
    (8, 1025), (8, 1060), (8, 1087),            # the global caches
    (1, 1024), (1, 1087), (1, 1), (1, 17),      # one sequence
    (2, 4160), (64, 1024), (128, 1024),         # more pairs than slots
])
def test_decode_split_covers_every_key_once(b, n_keys):
    """At gemma3's geometry (8 kv heads, g 2: one head chunk) on 132 SMs:
    every split covers at least one 32-key tile, split sizes differ by one
    tile at most, the kernel's walk visits each key of the range once, and
    the grid is at most one block an SM, as full as whole splits make it
    (one split when the pairs alone outnumber the SMs)."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    pairs = b * 8 * (2 // k5.decode_heads(2))
    nsplit = k5.decode_split(pairs, n_keys, H100_SMS)
    tiles = -(-n_keys // k5.DECODE_TILE)
    assert 1 <= nsplit <= min(tiles, k5.DECODE_MAX_SPLIT)
    sizes = [t1 - t0 for t0, t1 in (_decode_tiles(s, nsplit, n_keys)
                                    for s in range(nsplit))]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for lo in (0, 300):                         # a window's cut start
        assert sorted(_decode_walk(lo, lo + n_keys, nsplit)) == \
            list(range(lo, lo + n_keys))
    if pairs <= H100_SMS:
        assert pairs * nsplit <= H100_SMS       # one block an SM at most
        if nsplit < min(tiles, k5.DECODE_MAX_SPLIT):
            assert pairs * (nsplit + 1) > H100_SMS  # one more: past it
    else:
        assert nsplit == 1


def test_decode_split_at_cell_f():
    """Cell F's decode (b 8, 8 kv heads, g 2) over a full ring and the
    longest global prefix: 64 pairs x 2 splits = 128 blocks, one on each
    of 128 of an H100's 132 SMs; one sequence takes the most splits a
    cluster holds, 8."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    assert k5.decode_split(64, 1024, H100_SMS) == 2
    assert k5.decode_split(64, 1087, H100_SMS) == 2
    assert k5.decode_split(8, 1024, H100_SMS) == k5.DECODE_MAX_SPLIT == 8
    assert k5.decode_split(32, 1024, H100_SMS) == 4
    assert k5.decode_split(88, 1024, H100_SMS) == 1
    assert k5.decode_split(8, 40, H100_SMS) == 2     # two tiles: 2 splits
    assert [_decode_tiles(s, 2, 1087) for s in (0, 1)] == [(0, 17),
                                                           (17, 34)]


@pytest.mark.parametrize("g,g_block", [(1, 1), (2, 2), (3, 3), (4, 4),
                                       (6, 3), (7, 1), (8, 4), (16, 4)])
def test_decode_heads(g, g_block):
    from repro_torch.kernels.flash_attn.flash_attn import decode_heads
    assert decode_heads(g) == g_block


@pytest.mark.parametrize("skv,causal,window,q_offset,want", [
    (1024, False, 0, 0, (0, 1024)),           # a full ring after the wrap
    (701, True, 1024, 700, (0, 701)),         # a ring before the wrap
    (1087, True, 0, 1086, (0, 1087)),         # a global cache's prefix
    (1024, True, 100, 1023, (924, 1024)),     # the window cuts
    (1024, True, 0, 500, (0, 501)),           # causal, q_offset < skv − 1
    (1024, False, 100, 500, (401, 1024)),     # a window, not causal
])
def test_decode_keys(skv, causal, window, q_offset, want):
    from repro_torch.kernels.flash_attn.flash_attn import decode_keys
    assert decode_keys(skv, causal, window, q_offset) == want


DECODE_PARITY = [
    # name, cache slots, skv (the view), causal, window, q_offset
    ("full ring, not causal", 64, 64, False, 0, 0),
    ("ring before the wrap", 64, 41, True, 64, 40),
    ("window cuts", 96, 96, True, 32, 95),
    ("prefix of a longer cache", 128, 100, True, 0, 99),
]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("name,slots,skv,causal,window,q_offset",
                         DECODE_PARITY)
def test_hd256_decode_matches_reference(jax_k5, name, slots, skv, causal,
                                        window, q_offset, dtype, tol):
    """gemma3's decode geometry, reduced (b 2, hkv 2, g 2, hd 256): the
    port's op against the JAX op (Pallas in interpret mode, 32-key tiles)
    on the same inputs, k and v a prefix view of a ``slots``-slot cache;
    and attention over the keys [lo, hi) alone (``decode_keys``: what the
    decode kernel reads), unmasked, equal to the masked call."""
    from repro_torch.kernels.flash_attn.flash_attn import decode_keys
    jnp, jax_op, _ = jax_k5
    q, k, v = _qkv(2, 1, slots, 4, 2, 256, seed=slots + skv)
    k, v = k[:, :skv], v[:, :skv]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(jax_op(*(jnp.asarray(t).astype(jdt) for t in (q, k, v)),
                             block_q=8, block_k=32, **kw), np.float32)
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(t)).to(tdt)
                  for t in (q, k, v))
    got = flash_attention(qt, kt, vt, **kw)
    assert got.dtype == tdt and got.shape == (2, 1, 4, 256)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    lo, hi = decode_keys(skv, causal, window, q_offset)
    cut = flash_attention(qt.float(), kt[:, lo:hi].float(),
                          vt[:, lo:hi].float(), causal=False)
    torch.testing.assert_close(
        cut, flash_attention(qt.float(), kt.float(), vt.float(), **kw),
        rtol=1e-6, atol=1e-6)


DECODE_GPU_CASES = [
    # b, skv, hq, hkv, window, q_offset (None: skv − 1), causal, cache
    # slots (0: none), q scale, softmax scale (None: hd^-0.5)
    *[(3, n, 2 * h, 2, 0, None, True, n + 5, 1.0, None)
      for n in (1, 7, 63, 64, 65, 1024, 1087, 4160) for h in (1, 2, 3, 8)],
    (8, 1024, 16, 8, 0, 0, False, 0, 1.0, None),     # cell F's full ring
    (8, 1024, 16, 8, 0, 0, False, 0, 6.0, None),     # peaked
    (8, 1087, 16, 8, 0, None, True, 1088, 1.0, None),  # the global prefix
    (8, 701, 16, 8, 1024, 700, True, 1024, 1.0, None),  # before the wrap
    (2, 1024, 16, 8, 100, 1023, True, 0, 1.0, None),  # the window cuts
    (2, 1024, 16, 8, 0, 500, True, 0, 1.0, None),   # causal, q_offset < skv-1
    (2, 1024, 16, 8, 100, 500, False, 0, 1.0, None),  # a window, not causal
    (2, 1024, 16, 8, 0, 0, False, 0, 1.0, 0.2),      # other softmax scales
    (2, 1024, 16, 8, 0, 0, False, 0, 1.0, -0.1),
    (2, 1087, 16, 8, 0, None, True, 1088, 6.0, 0.2),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,skv,hq,hkv,window,q_offset,causal,slots,q_scale,scale",
    DECODE_GPU_CASES)
def test_decode256_kernel_matches_plain_on_gpu(cuda, b, skv, hq, hkv,
                                               window, q_offset, causal,
                                               slots, q_scale, scale):
    """The decode kernel (bf16, hd 256, one query row) against the plain
    version in f32 on the card: skv from 1 to 4160, g 1, 2, 3, 8 (two head
    chunks), prefix views of a cache, peaked q, softmax scales 0.2 and
    −0.1, causal edges before the last key, windows that cut; within the
    unchanged tolerances, the ``decode256`` count alone moving."""
    q, k, v = _hd256_inputs(cuda, b, 1, skv, slots, q_scale, hq, hkv)
    _hd256_check(q, k, v, "decode256", causal=causal, window=window,
                 q_offset=skv - 1 if q_offset is None else q_offset,
                 scale=scale)


@pytest.mark.gpu
def test_decode256_two_launches_give_the_same_bits(cuda):
    """The splits merge in a fixed order: cell F's decode on the same
    inputs gives the same bits, launch after launch."""
    q, k, v = _hd256_inputs(cuda, 8, 1, 1024, 0, 6.0)
    first = flash_attention(q, k, v, causal=False)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v, causal=False), first)


@pytest.mark.gpu
def test_decode256_occupancy_is_the_split_rule_s(cuda):
    """The split rule counts ``DECODE_BLOCKS_PER_SM`` resident blocks an
    SM: the occupancy calculator agrees for every block width, and the
    card holds cell F's 64 clusters of 2 blocks at once."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    occ = [k5.decode_occupancy(g, 2) for g in range(1, k5.DECODE_MAX_G + 1)]
    assert [n for n, _ in occ] == [k5.DECODE_BLOCKS_PER_SM] * 4
    assert min(c for _, c in occ) >= 64, occ


# --- f32 prefill and scoring (lm-100m's pool, lm-tiny, the reduced configs)
@pytest.mark.parametrize("b,hkv,sq,g,skv,causal,window,q_offset", [
    (2, 2, 77, 3, 77, True, 0, 0),         # ragged, g = 3
    (1, 5, 1024, 2, 1024, True, 0, 0),     # cell I's pool, one batch row
    (2, 1, 200, 2, 456, True, 64, 256),    # window and offset, a cache
    (1, 2, 130, 1, 130, True, 40, 0),      # window < a tile, g = 1
    (2, 2, 33, 4, 90, False, 0, 0),        # not causal, past a tile edge
    (1, 1, 64, 1, 1000, True, 0, 936),     # a short block at a cache's end
    (1, 3, 16, 2, 64, True, 0, 48),        # F32_MIN_ROWS
])
def test_f32_walk_visits_every_block_once_and_every_unmasked_key(
        b, hkv, sq, g, skv, causal, window, q_offset):
    """``f32_walk``, the f32 kernel's walk: every (batch, kv head, row
    block) once, the row blocks in non-increasing order (heaviest first);
    each block's tiles hold every unmasked key of each of its rows, and
    a tile the walk leaves unmasked holds only keys unmasked for every row
    of the block."""
    from repro_torch.kernels.flash_attn.flash_attn import (
        F32_ROWS, F32_TILE, f32_walk)
    walk = f32_walk(b, hkv, sq, g, skv, causal, window, q_offset)
    nrows = sq * g
    nrb = -(-nrows // F32_ROWS)
    blocks = [(bi, h, row0) for bi, h, row0, _, _ in walk]
    assert sorted(blocks) == sorted(
        (bi, h, r * F32_ROWS) for bi in range(b) for h in range(hkv)
        for r in range(nrb))
    assert [r for _, _, r in blocks] == sorted(
        (r for _, _, r in blocks), reverse=True)
    key = np.arange(skv)
    for _, _, row0, tiles, masked in walk:
        rows = np.arange(row0, min(row0 + F32_ROWS, nrows))
        qpos = q_offset + rows // g
        ok = np.ones((len(rows), skv), bool)
        if causal:
            ok &= key[None] <= qpos[:, None]
        if window:
            ok &= key[None] > qpos[:, None] - window
        seen = np.zeros(skv, bool)
        for t in tiles:
            seen[t * F32_TILE:(t + 1) * F32_TILE] = True
            if t not in masked:
                assert (t + 1) * F32_TILE <= skv
                assert ok[:, t * F32_TILE:(t + 1) * F32_TILE].all()
        assert not (ok & ~seen[None]).any()
        assert all(t in tiles for t in masked)


F32_CASES = [
    # b, sq, skv, hq, hkv, window, q_offset, cache slots (0: no cache),
    # softmax scale (None: hd^-0.5)
    (2, 16, 16, 4, 2, 0, 0, 0, None),         # F32_MIN_ROWS, one tile
    (2, 64, 64, 4, 2, 0, 0, 0, None),         # lm-tiny's prefill
    (2, 77, 77, 6, 2, 0, 0, 0, None),         # ragged, g = 3
    (1, 200, 200, 2, 1, 0, 0, 0, None),       # several row blocks, g = 2
    (2, 77, 177, 4, 2, 0, 100, 300, None),    # offset over a cache view
    (2, 200, 456, 6, 3, 64, 256, 512, 0.2),   # window, offset, a scale
    (1, 300, 300, 4, 4, 100, 0, 0, None),     # a window, g = 1
    (3, 40, 104, 4, 2, 0, 64, 128, 0.3),      # a reduced prompt at 64
]


@pytest.mark.gpu
@pytest.mark.parametrize("q_scale", [1.0, 6.0])   # 6: a peaked softmax
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,window,q_offset,slots,scale",
                         F32_CASES)
def test_f32_kernel_matches_plain_on_gpu(cuda, hd, q_scale, b, sq, skv, hq,
                                         hkv, window, q_offset, slots,
                                         scale):
    """The f32 kernel against the plain version on the card, k and v
    prefix views of a cache where ``slots``: within 2e-4 of every output
    and ``ROW_REL`` of each row's largest |output|, finite; its counter
    alone moves."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    q, k, v = (torch.from_numpy(t).to(cuda)
               for t in _qkv(b, sq, max(skv, slots), hq, hkv, hd,
                             seed=sq + hd))
    q = q * q_scale
    k, v = k[:, :skv], v[:, :skv]
    kw = dict(window=window, q_offset=q_offset, scale=scale)
    before = dict(k5.launches_by_kernel)
    got = flash_attention(q, k, v, **kw)
    assert k5.launches_by_kernel == dict(before, f32=before["f32"] + 1)
    want = flash_attention(q, k, v, interpret=True, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert _row_rel_err(got, want) <= ROW_REL["float32"]


@pytest.mark.gpu
def test_f32_two_launches_give_the_same_bits(cuda):
    """No atomics: cell I's pool shape (one third of its batch), q peaked,
    gives the same bits launch after launch."""
    q, k, v = (torch.from_numpy(t).to(cuda)
               for t in _qkv(4, 1024, 1024, 10, 5, 64, seed=0))
    q = q * 6.0
    first = flash_attention(q, k, v)
    assert torch.equal(flash_attention(q, k, v), first)


@pytest.mark.gpu
def test_failed_f32_launch_raises(cuda, monkeypatch):
    """A launch the f32 kernel refuses raises: no other kernel and no plain
    version takes the call instead, and no count moves."""
    from repro_torch.kernels.flash_attn import flash_attn as k5
    monkeypatch.setattr(k5, "_lib_f32", lambda: lambda *a: 1)
    q = torch.zeros(2, 64, 4, 64, device=cuda)
    k = torch.zeros(2, 64, 2, 64, device=cuda)
    assert k5.plan(q, k, k) == "f32"
    before, by = k5.launches, dict(k5.launches_by_kernel)
    with pytest.raises(RuntimeError, match="f32"):
        flash_attention(q, k, k)
    assert k5.launches == before and k5.launches_by_kernel == by
