"""The data plane's device-put stage on the card: every uploaded batch a
consumer reads equals its host arrays bit for bit.

* With the compute stream kept busy by a long matmul loop, the consumer
  queues a read of each popped batch behind the matmuls and drops the
  batch; the plane's next uploads then run on its idle copy stream. A
  plane that did not mark the batch as used on the compute stream
  (``record_stream``) would let the caching allocator hand its memory to
  a later upload before the read runs.
* With an idle compute stream and large batches, the consumer reads each
  batch the moment it is popped, while its copy may still be in flight;
  a plane whose consumer side did not wait for the copy's event
  (``wait_event``) would read memory the copy has not written yet.

Needs a CUDA GPU (``gpu`` marker) and skips elsewhere; imports no JAX.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import DataPlane, PipelineState  # noqa: E402

POPS = 50


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the plane's copy stream)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(autouse=True)
def no_thread_outlives():
    """Every thread a test starts is gone when it ends, and the count of
    threads is back where it was (a bounded wait: the plane's ``stop``
    has joined its workers already)."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 5.0
    while (set(threading.enumerate()) - before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    left = [t.name for t in set(threading.enumerate()) - before]
    assert not left, left
    assert threading.active_count() <= len(before)


class _Plan:
    def __init__(self, step):
        self.step, self.epoch = step, 0


class _Counting:
    """A pure planner whose step-k batch is a seeded int32 array (and a
    second f32 one), so the consumer can rebuild it on the host."""

    plan_is_pure = True

    def __init__(self, rows, cols):
        self.rows, self.cols = rows, cols
        self.assembler = self

    def host(self, step):
        rng = np.random.default_rng(step)
        return {"tokens": rng.integers(0, 2 ** 31 - 1, (self.rows, self.cols),
                                       dtype=np.int32),
                "weights": rng.standard_normal(self.rows).astype(np.float32)}

    def plan(self, pstate, step):
        return _Plan(step), pstate

    def assemble(self, plan):
        return self.host(plan.step)

    def notify_consumed(self, plan):
        pass


def _check(reads, sampler):
    torch.cuda.synchronize()
    for step, got in reads:
        want = sampler.host(step)
        for k, v in got.items():
            np.testing.assert_array_equal(v.cpu().numpy(), want[k],
                                          err_msg=f"{k}, step {step}")


@pytest.mark.gpu
def test_uploads_survive_a_busy_compute_stream(cuda):
    sampler = _Counting(64, 4096)            # 1 MiB of tokens a batch
    plane = DataPlane(sampler, depth=3, device_put=True, device=cuda)
    a = torch.randn(4096, 4096, device=cuda)
    reads = []
    plane.start(PipelineState(), 0)
    try:
        for _ in range(POPS):
            for _ in range(8):               # keep the compute stream busy
                a = torch.tanh(a @ a * 1e-3)
            batch, plan, _ = plane.next()
            assert all(v.is_cuda for v in batch.values())
            reads.append((plan.step, {k: v.clone()
                                      for k, v in batch.items()}))
            del batch
    finally:
        plane.stop()
    assert [s for s, _ in reads] == list(range(POPS))
    _check(reads, sampler)


@pytest.mark.gpu
def test_uploads_are_waited_for_on_an_idle_compute_stream(cuda):
    sampler = _Counting(512, 65536)          # 128 MiB of tokens a batch
    plane = DataPlane(sampler, depth=3, device_put=True, device=cuda)
    reads = []
    plane.start(PipelineState(), 0)
    try:
        for _ in range(12):
            batch, plan, _ = plane.next()
            reads.append((plan.step, {k: v.clone()
                                      for k, v in batch.items()}))
            del batch
    finally:
        plane.stop()
    _check(reads, sampler)


@pytest.mark.gpu
def test_a_device_batch_skips_the_copy(cuda):
    sampler = _Counting(8, 16)
    host = sampler.assemble
    sampler.assemble = lambda plan: {k: torch.as_tensor(v, device=cuda)
                                     for k, v in host(plan).items()}
    plane = DataPlane(sampler, depth=2, device_put=True, device=cuda)
    plane.start(PipelineState(), 0)
    try:
        batch, plan, _ = plane.next()
    finally:
        plane.stop()
    assert plane._copy_stream is None        # nothing crossed
    _check([(plan.step, batch)], sampler)
