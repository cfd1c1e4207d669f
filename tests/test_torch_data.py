"""The port's data loaders and data service (``horovod_tpu_torch/data/``)
against the JAX package's: the sharded and async loaders give the same
batches on every rank of every world size, with and without the device
prefetch (on the CPU the prefetch is a copy to the same device); one
``DataServiceWorker`` → ``RemoteDataset`` round trip of tensor batches
in process, by static endpoint and through a registry.  Exact.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.data import (AsyncDataLoader as JAsync,
                              ShardedDataLoader as JSharded)
from horovod_tpu_torch.data import (AsyncDataLoader, AsyncDataLoaderMixin,
                                    RemoteDataset, ShardedDataLoader,
                                    serve_dataset)


def _batches(n=11):
    rng = np.random.RandomState(4)
    return [{"x": rng.randn(3, 2).astype(np.float32),
             "y": np.int64(i)} for i in range(n)]


def _np(b):
    return {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
            for k, v in b.items()}


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["sharded", "async"])
def test_loaders_match_jax(size, kind):
    batches = _batches()
    for rank in range(size):
        if kind == "sharded":
            j = JSharded(batches, rank=rank, size=size)
            t = ShardedDataLoader(batches, rank=rank, size=size)
        else:
            j = JAsync(batches, rank=rank, size=size,
                       async_loader_queue_size=2)
            t = AsyncDataLoader(batches, rank=rank, size=size,
                                async_loader_queue_size=2)
        assert len(t) == len(j)
        jl, tl = list(j), list(t)
        assert len(jl) == len(tl) == len(t)
        for a, b in zip(jl, tl):
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]))


def test_device_prefetch_copies_tensor_batches():
    batches = [{"x": torch.full((2, 2), float(i)), "i": i}
               for i in range(5)]
    t = ShardedDataLoader(batches, rank=1, size=2, device_prefetch=True,
                          device="cpu")
    got = list(t)
    assert [b["i"] for b in got] == [1, 3]
    for b in got:
        torch.testing.assert_close(b["x"], torch.full((2, 2),
                                                      float(b["i"])))
    # The JAX loader with its device prefetch gives the same batches.
    j = JSharded([{"x": b["x"].numpy(), "i": b["i"]} for b in batches],
                 rank=1, size=2, device_prefetch=True)
    for a, b in zip(j, got):
        np.testing.assert_array_equal(np.asarray(a["x"]), b["x"].numpy())


def test_async_loader_surfaces_producer_errors():
    class Boom(ShardedDataLoader):
        def _iterate(self):
            yield from super()._iterate()
            raise RuntimeError("producer failed")

    class AsyncBoom(AsyncDataLoaderMixin, Boom):
        pass

    it = iter(AsyncBoom([1, 2], async_loader_queue_size=1))
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_data_service_round_trip_static_endpoint():
    batches = [{"x": torch.arange(6.0).reshape(2, 3) + i, "i": i}
               for i in range(4)]
    worker = serve_dataset(batches)
    try:
        port = worker.httpd.server_address[1]
        got = list(RemoteDataset(endpoints=[f"127.0.0.1:{port}"]))
    finally:
        worker.stop()
    assert [b["i"] for b in got] == [0, 1, 2, 3]
    for a, b in zip(batches, got):
        torch.testing.assert_close(b["x"], a["x"], rtol=0, atol=0)


def test_data_service_round_trip_through_registry(monkeypatch):
    import socket
    from horovod_tpu_torch.runner.http_server import KVStoreServer
    # The producer registers its host's address; keep it on loopback.
    monkeypatch.setattr(socket, "gethostbyname", lambda _: "127.0.0.1")
    kv = KVStoreServer()
    kvport = kv.start()
    workers = [serve_dataset([torch.full((3,), 10.0 * w + i)
                              for i in range(3)], worker_id=w,
                             rendezvous_addr="127.0.0.1",
                             rendezvous_port=kvport) for w in range(2)]
    try:
        ds = RemoteDataset(rendezvous_addr="127.0.0.1",
                           rendezvous_port=kvport)
        assert len(ds.endpoints) == 2
        got = sorted(float(t[0]) for t in ds)
    finally:
        for w in workers:
            w.stop()
        kv.stop()
    assert got == [0.0, 1.0, 2.0, 10.0, 11.0, 12.0]
