"""The port's KV / rendezvous server: the C++ server of
``horovod_tpu_torch/csrc/kv_server.cc`` (the default backend) and the
Python ``_KVHandler`` (``HVD_TPU_KV_SERVER=python``), held to one wire
protocol and to the JAX package's servers.

* The KV endpoint tests of ``tests/test_runner.py`` and the concurrency
  tests of ``tests/test_http_server_concurrency.py``, each run against
  both backends of the port through the port's ``KVStoreClient``.
* The wire exchange of ``chip_smoke.py`` (``kv_wire_exchange``: every
  verb, long-polls woken and timed out, a put-wait fan-out to 16
  waiters, min-keys scans, escaped and unicode names, 404s and 400s,
  trace headers, a 1.18 MB fleet-tier block) gets byte-equal statuses and
  bodies from both backends of the port and from the JAX package's
  Python server.  The JAX package's C++ server lists a scan's keys in
  hash order with raw UTF-8, so its scan bodies are held equal as JSON
  and every other response byte for byte.
* A native build that fails raises, with the compiler's output, and
  starts no Python server in its place.
* ``stop()`` leaves no connection thread and no listening socket; a child
  forked while the server runs neither deadlocks on the store nor keeps
  the port bound.

No process world: every server runs in this process.
"""

import base64
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

import chip_smoke
from horovod_tpu_torch.csrc import native
from horovod_tpu_torch.runner import http_server
from horovod_tpu_torch.runner.http_server import (KVStoreClient,
                                                  KVStoreServer,
                                                  RendezvousServer)

BACKENDS = ["native", "python"]


def _start(monkeypatch, backend, server_cls=KVStoreServer):
    monkeypatch.setenv("HVD_TPU_KV_SERVER", backend)
    srv = server_cls()
    port = srv.start(0)
    # The backend asked for is the one running: no quiet fallback.
    assert (srv._native is not None) == (backend == "native")
    assert (srv.httpd is not None) == (backend == "python")
    return srv, port


@pytest.fixture(params=BACKENDS)
def kv_srv(request, monkeypatch):
    srv, port = _start(monkeypatch, request.param)
    yield srv, port
    srv.stop()


@pytest.fixture(params=BACKENDS)
def kv(request, monkeypatch):
    """A running server of either backend + a client factory."""
    srv, port = _start(monkeypatch, request.param)
    yield srv, (lambda: KVStoreClient("127.0.0.1", port))
    srv.stop()


def test_native_is_the_default_backend(monkeypatch):
    monkeypatch.delenv("HVD_TPU_KV_SERVER", raising=False)
    before = dict(http_server.STARTS)
    srv = KVStoreServer()
    port = srv.start()
    try:
        assert isinstance(srv._native, native.NativeKVServer)
        assert srv.httpd is None and srv.port == port
        assert http_server.STARTS["native"] == before["native"] + 1
        assert http_server.STARTS["python"] == before["python"]
        lib = native.library_path()
        assert os.path.dirname(lib) == os.path.join(
            os.path.dirname(native.__file__), "_build")
        assert native.KV_SOURCE.endswith(
            os.path.join("horovod_tpu_torch", "csrc", "kv_server.cc"))
    finally:
        srv.stop()


# -- the KV endpoint tests of tests/test_runner.py --------------------------

def test_kvstore_put_get_roundtrip(kv_srv):
    srv, port = kv_srv
    client = KVStoreClient("127.0.0.1", port)
    client.put("scope1", "key1", b"value1")
    assert client.get("scope1", "key1") == b"value1"
    assert client.get("scope1", "missing") is None
    assert client.get("other", "key1") is None


def test_kvstore_batch_put_and_scope_delete(kv_srv):
    srv, port = kv_srv
    client = KVStoreClient("127.0.0.1", port)
    client.put_batch("b", {"k1": b"v1", "k2": b"\x00\xffbin",
                           "sub/key": b"v3"})
    assert client.get("b", "k1") == b"v1"
    assert client.get("b", "k2") == b"\x00\xffbin"
    assert client.get("b", "sub/key") == b"v3"
    assert len(client.scan("b")) == 3
    client.delete_scope("b")
    assert client.scan("b") == {}
    client.delete_scope("b")  # idempotent on a missing scope


def test_kvstore_put_wait_roundtrip(kv_srv):
    srv, port = kv_srv
    client = KVStoreClient("127.0.0.1", port)
    out = client.put_wait("req", "0", b"sig", "resp_scope", "verdict",
                          wait=0.3)
    assert out is None
    assert client.get("req", "0") == b"sig"

    def publish():
        time.sleep(0.3)
        srv.put("resp_scope", "verdict", b"ok")

    threading.Thread(target=publish, daemon=True).start()
    t0 = time.time()
    out = KVStoreClient("127.0.0.1", port).put_wait(
        "req", "1", b"sig1", "resp_scope", "verdict", wait=10.0)
    assert out == b"ok"
    assert time.time() - t0 < 5.0  # woke on publish, not timeout


def test_kvstore_scan_min_keys_longpoll(kv_srv):
    srv, port = kv_srv
    client = KVStoreClient("127.0.0.1", port)
    srv.put("rq", "0", b"a")

    def add_more():
        time.sleep(0.25)
        srv.put("rq", "1", b"b")
        srv.put("rq", "2", b"c")

    threading.Thread(target=add_more, daemon=True).start()
    out = client.scan("rq", wait=10.0, min_keys=3)
    assert set(out) == {"0", "1", "2"}
    out = client.scan("rq", wait=0.2, min_keys=99)
    assert len(out) == 3


def test_kvstore_unicode_and_escaped_names(kv_srv):
    srv, port = kv_srv
    client = KVStoreClient("127.0.0.1", port)
    names = ['quote"backslash\\', "unicode-é中\U0001f600",
             "query?frag#pct%20", "nested/seg/ment", "spaces and\ttabs"]
    for i, n in enumerate(names):
        client.put("esc", n, f"v{i}".encode())
    for i, n in enumerate(names):
        assert client.get("esc", n) == f"v{i}".encode()
    assert list(client.scan("esc")) == names  # in insertion order
    assert srv.scan_scope("esc") == {n: f"v{i}".encode()
                                     for i, n in enumerate(names)}
    client.put_batch("escb", {n: b"x" for n in names})
    assert list(client.scan("escb")) == names
    client.put(names[1], "k", b"scoped")
    assert client.get(names[1], "k") == b"scoped"


def test_kvstore_longpoll_get_and_key_delete(kv_srv):
    srv, port = kv_srv
    client = KVStoreClient("127.0.0.1", port)
    assert client.get("lp", "k") is None  # immediate 404, no wait

    def put_later():
        time.sleep(0.25)
        srv.put("lp", "k", b"woken")

    threading.Thread(target=put_later, daemon=True).start()
    t0 = time.time()
    assert client.get("lp", "k", wait=10.0) == b"woken"
    assert time.time() - t0 < 5.0
    client.delete("lp", "k")
    assert client.get("lp", "k") is None
    assert client.scan("lp") == {}
    client.delete("lp", "k")  # idempotent


def test_kvstore_store_readable_after_stop(kv_srv):
    """``hvd.run`` gathers the ranks' results after the launcher stopped
    the server (``runner/__init__.py``)."""
    srv, port = kv_srv
    client = KVStoreClient("127.0.0.1", port)
    client.put("runresults", "0", b"rank0-result")
    srv.stop()
    assert srv.get("runresults", "0") == b"rank0-result"
    assert srv.scan_scope("runresults") == {"0": b"rank0-result"}


def test_rendezvous_publishes_slots_on_either_backend(monkeypatch):
    from horovod_tpu_torch.runner import hosts as H
    slots = H.get_host_assignments(H.parse_hosts("localhost:2"), 2)
    for backend in BACKENDS:
        srv, port = _start(monkeypatch, backend, RendezvousServer)
        try:
            srv.init(slots)
            client = KVStoreClient("127.0.0.1", port)
            assert client.get("rendezvous", "size") == b"2"
            got = json.loads(client.get("rendezvous", "slot/localhost/1"))
            assert got == slots[1].to_dict()
        finally:
            srv.stop()


# -- the concurrency tests of tests/test_http_server_concurrency.py ---------

def test_long_poll_wakes_only_its_scope(kv):
    server, mk_client = kv
    n_scopes = 8
    results, latencies = {}, {}
    barrier = threading.Barrier(n_scopes + 1)

    def waiter(i):
        c = mk_client()
        barrier.wait()
        t0 = time.monotonic()
        out = c.get(f"scope{i}", "key", wait=10.0)
        latencies[i] = time.monotonic() - t0
        results[i] = out

    threads = [threading.Thread(target=waiter, args=(i,))
               for i in range(n_scopes)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(0.1)
    writer = mk_client()
    for i in range(n_scopes):
        writer.put(f"scope{i}", "key", f"v{i}".encode())
    for t in threads:
        t.join(timeout=30)
    assert results == {i: f"v{i}".encode() for i in range(n_scopes)}
    assert all(lat < 8.0 for lat in latencies.values()), latencies


def test_put_wait_fanout_all_waiters_get_verdict(kv):
    server, mk_client = kv
    n = 16
    verdicts = [None] * n

    def worker(i):
        c = mk_client()
        verdicts[i] = c.put_wait("requests", f"rank{i}",
                                 f"req{i}".encode(),
                                 "verdicts", "round0", wait=20.0)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    coordinator = mk_client()
    announced = coordinator.scan("requests", wait=20.0, min_keys=n)
    assert len(announced) == n
    assert announced["rank3"] == b"req3"
    coordinator.put("verdicts", "round0", b"APPROVED")
    for t in threads:
        t.join(timeout=30)
    assert verdicts == [b"APPROVED"] * n


def test_scope_delete_wakes_waiters_who_reissue(kv):
    server, mk_client = kv
    got = []

    def waiter():
        c = mk_client()
        for _ in range(20):
            out = c.get("doomed", "answer", wait=1.0)
            if out is not None:
                got.append(out)
                return

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    admin = mk_client()
    admin.put("doomed", "other_key", b"x")
    admin.delete_scope("doomed")
    time.sleep(0.1)
    admin.put("doomed", "answer", b"42")
    t.join(timeout=30)
    assert got == [b"42"]


def test_put_wait_timeout_returns_none_but_stores_value(kv):
    server, mk_client = kv
    c = mk_client()
    t0 = time.monotonic()
    out = c.put_wait("announce", "k", b"payload", "never", "coming",
                     wait=0.3)
    assert out is None
    assert time.monotonic() - t0 < 5.0
    assert c.get("announce", "k") == b"payload"


def test_concurrent_mixed_load_no_lost_updates(kv):
    server, mk_client = kv
    n_writers, n_keys = 8, 25
    errors = []

    def writer(w):
        try:
            mk_client().put_batch(f"bulk{w % 4}",
                                  {f"w{w}k{k}": f"{w}:{k}".encode()
                                   for k in range(n_keys)})
        except Exception as e:  # pragma: no cover - diagnostic
            errors.append(repr(e))

    def poller(w):
        try:
            out = mk_client().get(f"bulk{w % 4}", f"w{w}k0", wait=15.0)
            if out != f"{w}:0".encode():
                errors.append(f"poller {w} got {out!r}")
        except Exception as e:  # pragma: no cover - diagnostic
            errors.append(repr(e))

    threads = [threading.Thread(target=poller, args=(w,))
               for w in range(n_writers)]
    threads += [threading.Thread(target=writer, args=(w,))
                for w in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    c = mk_client()
    for w in range(n_writers):
        scope = c.scan(f"bulk{w % 4}")
        for k in range(n_keys):
            assert scope[f"w{w}k{k}"] == f"{w}:{k}".encode()


def test_server_side_put_does_notify_waiters(kv):
    server, mk_client = kv
    out = {}

    def waiter():
        out["v"] = mk_client().get("rendezvous", "rank/0", wait=10.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    server.put("rendezvous", "rank/0", b"slotinfo")
    t.join(timeout=30)
    assert out["v"] == b"slotinfo"


# -- one wire protocol -------------------------------------------------------

def _blob():
    return np.random.RandomState(20).bytes(chip_smoke.KV_BLOB_BYTES)


def _exchange(monkeypatch, server_cls, backend, blob):
    monkeypatch.setenv("HVD_TPU_KV_SERVER", backend)
    srv = server_cls()
    port = srv.start(0)
    try:
        return chip_smoke.kv_wire_exchange(port, blob)
    finally:
        srv.stop()


def test_wire_exchange_is_byte_equal_across_servers(monkeypatch):
    """Both backends of the port and the JAX package's Python server give
    every response of the scripted exchange the same status and the same
    bytes."""
    from horovod_tpu.runner.http_server import KVStoreServer as JaxKV
    blob = _blob()
    port_native = _exchange(monkeypatch, KVStoreServer, "native", blob)
    port_python = _exchange(monkeypatch, KVStoreServer, "python", blob)
    jax_python = _exchange(monkeypatch, JaxKV, "python", blob)
    labels = [r[0] for r in port_native]
    assert len(labels) == len(set(labels)) > 70
    assert port_native == port_python
    assert port_native == jax_python
    statuses = {s for _, s, _ in port_native}
    assert statuses == {200, 400, 404}
    by_label = {label: (s, body) for label, s, body in port_native}
    assert by_label["get block"] == (200, blob)
    assert by_label["get batch block"] == (200, blob)
    assert by_label["long-poll woken"] == (200, b"woken")
    assert by_label["put-wait with + in the query"] == (200, b"spaced")
    assert [by_label[f"fan-out waiter {i}"] for i in range(16)] == \
        [(200, b"APPROVED")] * 16
    scan = json.loads(by_label["scan min fan-out"][1])
    assert list(scan) == [f"rank{i}" for i in range(16)]
    esc = json.loads(by_label["scan esc"][1])
    assert "unicode-é中\U0001f600" in esc and "nested/seg/ment" in esc
    assert by_label["scan after delete"][1] == json.dumps({
        k: base64.b64encode(v).decode() for k, v in (
            ("k", b"v1b"), ("empty", b""), ("traced", b"t"))}).encode()


def test_wire_exchange_matches_the_jax_native_server(monkeypatch):
    """The JAX package's C++ server answers the same exchange alike:
    scan bodies equal as JSON objects (it lists keys in hash order, with
    raw UTF-8), every other response byte for byte, but one: it reads a
    '+' in the query literally, where parse_qs (and so the Python
    servers) reads a space, so its put-wait on scope "a+b" times out.
    ``KVStoreClient`` quotes '+' as %2B, so no client of either package
    sends one."""
    from horovod_tpu.runner.http_server import KVStoreServer as JaxKV
    blob = _blob()
    port_native = _exchange(monkeypatch, KVStoreServer, "native", blob)
    jax_native = _exchange(monkeypatch, JaxKV, "native", blob)
    plus = "put-wait with + in the query"
    ours = {label: (status, body) for label, status, body in port_native}
    theirs = {label: (status, body) for label, status, body in jax_native}
    assert ours.pop(plus) == (200, b"spaced")
    assert theirs.pop(plus) == (404, b"")
    port_native = [r for r in port_native if r[0] != plus]
    jax_native = [r for r in jax_native if r[0] != plus]
    assert [r[:2] for r in port_native] == [r[:2] for r in jax_native]
    n_scans = 0
    for (label, _, ours), (_, _, theirs) in zip(port_native, jax_native):
        if label.startswith("scan"):
            n_scans += 1
            assert json.loads(ours) == json.loads(theirs), label
        else:
            assert ours == theirs, label
    assert n_scans >= 12


def test_python_listener_takes_a_burst_of_connections():
    """The Python backend queues 128 connections where the JAX package's
    (``socketserver``'s default) queues 5: a burst of 32 connects, as a
    world's ranks make at a rendezvous, completes at once, none waits
    out a dropped SYN's 1 s retransmit, before a single one is
    accepted."""
    from http.server import ThreadingHTTPServer
    assert ThreadingHTTPServer.request_queue_size == 5  # the JAX backend's
    httpd = http_server._KVHTTPServer(("127.0.0.1", 0),
                                      http_server._KVHandler)
    socks = []
    try:
        # No serve_forever: nothing accepts, the backlog holds them all.
        for _ in range(32):
            socks.append(socket.create_connection(httpd.server_address,
                                                  timeout=0.5))
        assert len(socks) == 32
    finally:
        for s in socks:
            s.close()
        httpd.server_close()


# -- build, stop and fork ----------------------------------------------------

def test_failed_native_build_raises_without_fallback(monkeypatch, tmp_path):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'kv_server.cc:1: error: broken build' "
                   ">&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: str(tmp_path / "_build" / "libhvdcore-x.so"))
    monkeypatch.delenv("HVD_TPU_KV_SERVER", raising=False)
    before = dict(http_server.STARTS)
    srv = KVStoreServer()
    with pytest.raises(RuntimeError, match="broken build") as e:
        srv.start(0)
    assert "kv_server.cc" in str(e.value)
    assert srv.httpd is None and srv._native is None
    assert http_server.STARTS == before
    # "python" never builds the library.
    monkeypatch.setenv("HVD_TPU_KV_SERVER", "python")
    srv = KVStoreServer()
    srv.start(0)
    srv.stop()
    assert native._lib is None


BUILD_RACE = """
import sys
from horovod_tpu_torch.csrc import native
native.library_path = lambda: sys.argv[1]
srv = native.NativeKVServer()
srv.start(0)
srv.put("s", "k", b"v")
assert srv.get("s", "k") == b"v" and srv.stop() == 0
print(native.lib()._name)
"""


def test_concurrent_first_uses_build_the_library_once(tmp_path):
    """Six processes (the test workers, a world's ranks) reach a library
    that is not built yet at once: one builds under the file lock, the
    others load its result, and every one serves."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = str(tmp_path / "_build" / "libhvdcore-race.so")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RACE, lib],
                              cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert {o.strip() for o, _ in outs} == {lib}
    assert sorted(os.listdir(tmp_path / "_build")) == [
        ".hvdcore.lock", "libhvdcore-race.so"]


def _threads():
    return len(os.listdir("/proc/self/task"))


def _free_to_bind(port):
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("0.0.0.0", port))
        s.listen(1)
        return True
    except OSError:
        return False
    finally:
        s.close()


def test_stop_leaves_no_thread_and_frees_the_port(monkeypatch):
    native.lib()
    base = _threads()
    srv, port = _start(monkeypatch, "native")
    polls = []
    connected = threading.Barrier(5)

    def poll():
        c = KVStoreClient("127.0.0.1", port)
        c.put("s", "k", b"v")  # this client's connection thread exists
        connected.wait()
        try:  # answered 404, or cut off by the shutdown
            polls.append(c.get("never", "k", wait=20.0))
        except OSError:
            polls.append(None)

    clients = [threading.Thread(target=poll) for _ in range(4)]
    for t in clients:
        t.start()
    connected.wait()
    time.sleep(0.2)  # the four long-polls are parked in the server
    assert not _free_to_bind(port)
    t0 = time.monotonic()
    assert srv._native.stop() == 0  # every connection thread has left
    for t in clients:
        t.join(timeout=10)
    assert time.monotonic() - t0 < 5 and polls == [None] * 4
    deadline = time.monotonic() + 5
    while _threads() > base and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _threads() <= base
    assert _free_to_bind(port)  # a respawned driver may take the port
    again = KVStoreServer()
    assert again.start(port) == port
    again.stop()
    srv.stop()  # idempotent


def test_forked_child_reads_the_store_and_drops_the_port(monkeypatch):
    """A child forked while a connection thread waits in a long-poll (and
    may hold the store's lock) reads and writes its copy of the store in
    process, and does not keep the parent's port bound."""
    srv, port = _start(monkeypatch, "native")
    srv.put("s", "k", b"before fork")

    def poll():
        try:  # answered 404, or cut off when the parent stops
            KVStoreClient("127.0.0.1", port).get("s", "never", wait=5.0)
        except OSError:
            pass

    poller = threading.Thread(target=poll)
    poller.start()
    stop_writer = threading.Event()

    def writer():  # keeps the store's lock busy around the fork
        c = KVStoreClient("127.0.0.1", port)
        i = 0
        while not stop_writer.is_set():
            c.put("busy", str(i % 50), b"x" * 4096)
            i += 1

    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.2)
    r, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:  # the child: no pytest machinery from here on
        code = 1
        try:
            srv.put("s", "child", b"mine")
            if srv.get("s", "k") == b"before fork" and \
                    srv.get("s", "child") == b"mine":
                code = 0
            os.write(wfd, b"ready")
            time.sleep(3)  # alive while the parent rebinds the port
        finally:
            os._exit(code)
    os.close(wfd)
    try:
        assert os.read(r, 5) == b"ready"
        stop_writer.set()
        w.join(timeout=10)
        srv.stop()
        poller.join(timeout=10)
        assert _free_to_bind(port)  # the living child holds no listener
        assert srv.get("s", "child") is None  # the child wrote its copy
    finally:
        _, status = os.waitpid(pid, 0)
        os.close(r)
    assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0
