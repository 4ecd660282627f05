"""The checkpointer's device path on the card: the snapshot's pinned
ring (``checkpoint.ckpt._PinnedRing``) copies tensors of every size the
state holds (below one stage, across stage edges, bf16, 0-d, a stacked
layer slice) to host memory bit for bit, and a save and restore of CUDA
tensors round-trips them exactly, in place. Needs a CUDA GPU (``gpu``
marker) and skips elsewhere; the module imports no JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the snapshot's pinned ring)")
    return torch.device("cuda")


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("numel,dtype", [
    (1, torch.float32), (1000, torch.bfloat16),
    ((1 << 26) + 3, torch.float32),          # one stage and 12 bytes
    (3 * (1 << 27) - 1, torch.bfloat16),     # three stages less 2 bytes
    (1 << 27, torch.float32)],               # exactly two stages
    ids=["1-f32", "1000-bf16", "stage+12B", "3stages-2B", "2stages"])
def test_pinned_ring_copies_bitwise(numel, dtype, cuda):
    gen = torch.Generator(device=cuda).manual_seed(numel)
    src = torch.randn(numel, generator=gen, device=cuda).to(dtype)
    dst = torch.empty(numel, dtype=dtype)
    ckpt._PinnedRing().copy(dst, src)
    np.testing.assert_array_equal(_bits(dst), _bits(src))


@pytest.mark.gpu
def test_save_restore_cuda_state_in_place(tmp_path, cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    layers = ckpt.Stacked(torch.randn(300, 257, generator=gen, device=cuda)
                          .bfloat16() for _ in range(3))
    state = {"w": layers, "m": torch.randn(5000, 33, generator=gen,
                                           device=cuda),
             "s": torch.tensor(2.5, device=cuda),
             "step": np.asarray(9, np.int32)}
    ck = ckpt.Checkpointer(tmp_path)
    ck.save_async(4, state)
    for t in layers:
        t.zero_()                            # after the snapshot
    ck.wait()
    tmpl = {"w": ckpt.Stacked(torch.empty_like(t) for t in layers),
            "m": torch.empty_like(state["m"]),
            "s": torch.empty_like(state["s"]),
            "step": np.asarray(0, np.int32)}
    got, step = ck.restore(tmpl)
    assert step == 4 and int(got["step"]) == 9
    assert got["m"] is tmpl["m"] and got["m"].is_cuda
    torch.testing.assert_close(got["m"], state["m"], rtol=0, atol=0)
    assert float(got["s"]) == 2.5
    gen = torch.Generator(device=cuda).manual_seed(0)
    for t in tmpl["w"]:
        want = torch.randn(300, 257, generator=gen, device=cuda).bfloat16()
        np.testing.assert_array_equal(_bits(t), _bits(want))
