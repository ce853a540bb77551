"""The port's ``DataLoader(worker_mode="process")`` against its thread mode
and the JAX package's process mode, byte for byte, per process shard:
across an epoch change, a mid-epoch resume and a quarantined bad sample;
``close()`` ends the pool.
"""

import numpy as np
import pytest

from tpuframe.data import DataLoader as JaxDataLoader
from tpuframe.data.datasets import SyntheticImageDataset as JaxSynthetic
from tpuframe_torch.data import DataLoader, SyntheticImageDataset


class Flaky(SyntheticImageDataset):
    """Sample 5 is a corrupt record (a skippable ``ValueError``)."""

    def __getitem__(self, idx):
        if idx == 5:
            raise ValueError("corrupt record")
        return super().__getitem__(idx)


def _bytes(loader, n=None) -> list[list[bytes]]:
    out = []
    for i, batch in enumerate(loader):
        out.append([np.asarray(a).tobytes() for a in batch])
        if n is not None and i + 1 == n:
            break
    return out


SHARDS = [(0, 1), (0, 2), (1, 2)]


@pytest.mark.parametrize("index,count", SHARDS, ids=[f"shard{i}of{c}" for i, c in SHARDS])
def test_process_workers_yield_the_bytes_of_threads_and_of_jax(index, count):
    kw = dict(batch_size=8, shuffle=True, seed=5, drop_last=False, process_index=index,
              process_count=count)
    proc = DataLoader(SyntheticImageDataset(n=29, image_size=4, seed=3), num_workers=2,
                      worker_mode="process", **kw)
    thread = DataLoader(SyntheticImageDataset(n=29, image_size=4, seed=3), num_workers=2, **kw)
    jax = JaxDataLoader(JaxSynthetic(n=29, image_size=4, seed=3), num_workers=2,
                        worker_mode="process", **kw)
    try:
        for epoch in (0, 1):
            for loader in (proc, thread, jax):
                loader.set_epoch(epoch)
            got = _bytes(proc)
            assert got == _bytes(thread) == _bytes(jax) and len(got) == len(proc)
        # a mid-epoch resume: two batches, then a new loader from the state
        proc.set_epoch(2)
        head = _bytes(proc, 2)
        state = proc.state_dict()
        again = DataLoader(SyntheticImageDataset(n=29, image_size=4, seed=3), num_workers=2,
                           worker_mode="process", **kw)
        again.load_state_dict(state)
        tail = _bytes(again)
        again.close()
        thread.set_epoch(2)
        jax.set_epoch(2)
        assert head + tail == _bytes(thread) == _bytes(jax)
    finally:
        proc.close()
        jax.close()


def test_process_workers_quarantine_a_bad_sample_as_threads_do():
    kw = dict(batch_size=8, shuffle=False, num_workers=2)
    proc = DataLoader(Flaky(n=16, image_size=4), worker_mode="process", **kw)
    try:
        assert _bytes(proc) == _bytes(DataLoader(Flaky(n=16, image_size=4), **kw))
    finally:
        proc.close()


def test_close_ends_the_pool():
    loader = DataLoader(SyntheticImageDataset(n=16, image_size=4), 8, num_workers=2,
                        worker_mode="process")
    workers = list(loader._proc_pool._pool)
    assert len(workers) == 2 and all(w.is_alive() for w in workers)
    assert len(_bytes(loader)) == 2
    loader.close()
    assert loader._proc_pool is None
    for w in workers:
        w.join(timeout=10)
        assert not w.is_alive()
    loader.close()  # a second close is a no-op


def test_bad_worker_settings_raise_at_construction():
    ds = SyntheticImageDataset(n=16, image_size=4)
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(ds, 8, worker_mode="greenlet")
    with pytest.raises(ValueError):
        DataLoader(ds, 8, num_workers=2, worker_mode="process", mp_context="teleport")
