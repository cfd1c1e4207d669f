"""Data service: host processes serve preprocessed batches to trainers.

Copy of ``horovod_tpu/data/service.py`` over the port's ``KVStoreClient``
(``runner/http_server.py``).  Batches may hold tensors: a producer sends
host copies (a CUDA tensor is copied to the host before it is pickled),
and ``RemoteDataset`` yields them on the host.  Only unpickle batches
from producers of the same job: unpickling runs code.

Reference: the Horovod-managed ``tf.data.experimental.service`` cluster
(runner/common/service/compute_service.py:99 ComputeService — an RPC
registry of dispatchers and workers with registration waits and shutdown
propagation — plus tensorflow/data/compute_service.py's send/read sides).
Here: dedicated CPU-heavy hosts run ``serve_dataset`` (a batch
producer + HTTP endpoint), and each trainer iterates ``RemoteDataset``,
which round-robins pickled batches across the registered producers —
decoupling input preprocessing from accelerator hosts the way the
reference's data service does.

Registry semantics (round 5, the ComputeService contract this module
implements over the rendezvous KV instead of an RPC service):

* producers REGISTER with a heartbeat — the record carries
  ``{addr, ts}`` and a daemon refreshes ``ts`` every
  ``HEARTBEAT_S``; ``stop()`` deregisters explicitly (graceful), a
  crashed producer just stops heartbeating;
* consumers discover producers FROM THE REGISTRY each sweep, so
  late-joining producers are picked up mid-epoch (the reference's
  WaitForDispatcherRegistration shape without the fixed-id slots);
* DEAD-PRODUCER EVICTION: a connection failure to a producer whose
  heartbeat is stale (older than ``alive_window_s``) evicts it — the
  trainer completes the epoch from the survivors (its undelivered
  batches are lost, exactly the reference's at-most-once data-service
  delivery); a failure with a FRESH heartbeat is treated as transient
  and retried.
"""

from __future__ import annotations

import json
import pickle
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterable, Iterator, List, Optional

from ..runner.http_server import KVStoreClient
from ..utils.logging import get_logger

REGISTRY_SCOPE = "dataservice"

#: Producer heartbeat period / consumer liveness window.
HEARTBEAT_S = 2.0
ALIVE_WINDOW_S = 10.0


def _to_host(item):
    """A batch with its tensors on the host."""
    import torch
    if isinstance(item, torch.Tensor):
        return item.detach().cpu()
    if isinstance(item, dict):
        return {k: _to_host(v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_to_host(v) for v in item)
    return item


class _BatchHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        if self.path != "/next":
            self.send_response(404)
            self.end_headers()
            return
        try:
            payload = self.server.batch_queue.get(timeout=30)
        except queue.Empty:
            # The None sentinel is consumed exactly once, so every reader
            # after the first must learn of exhaustion from the flag —
            # otherwise a second trainer retries 204s forever.
            code = 410 if self.server.exhausted else 204
            self.send_response(code)
            self.end_headers()
            return
        if payload is None:
            self.server.exhausted = True
            self.send_response(410)  # Gone: dataset exhausted
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class DataServiceWorker:
    """One producer endpoint (the reference's data-service *worker*): pulls
    batches from an iterable on a background thread, serves them over HTTP,
    registers itself — with a heartbeat — in the rendezvous KV store."""

    def __init__(self, dataset: Iterable[Any], worker_id: int = 0,
                 rendezvous_addr: Optional[str] = None,
                 rendezvous_port: Optional[int] = None,
                 queue_size: int = 8,
                 heartbeat_s: float = HEARTBEAT_S):
        self.dataset = dataset
        self.worker_id = worker_id
        self._rdv = (rendezvous_addr, rendezvous_port)
        self._queue_size = queue_size
        self._heartbeat_s = heartbeat_s
        self._stop_hb = threading.Event()
        self.httpd: Optional[ThreadingHTTPServer] = None

    def start(self) -> int:
        self.httpd = ThreadingHTTPServer(("0.0.0.0", 0), _BatchHandler)
        self.httpd.batch_queue = queue.Queue(maxsize=self._queue_size)
        self.httpd.exhausted = False
        port = self.httpd.server_address[1]

        def produce():
            # Sentinel goes out even if the dataset iterable raises, so
            # readers see 410 (exhausted) rather than polling 204 forever.
            try:
                for item in self.dataset:
                    self.httpd.batch_queue.put(pickle.dumps(_to_host(item)))
            finally:
                self.httpd.batch_queue.put(None)

        threading.Thread(target=produce, daemon=True,
                         name="hvd-data-producer").start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="hvd-data-server").start()
        addr, rport = self._rdv
        if addr and rport:
            import socket
            my = socket.gethostbyname(socket.gethostname())
            client = KVStoreClient(addr, int(rport))
            key = f"worker/{self.worker_id}"
            endpoint = f"{my}:{port}"

            def put_record():
                client.put(REGISTRY_SCOPE, key, json.dumps(
                    {"addr": endpoint, "ts": time.time()}).encode())

            put_record()  # registration IS the first heartbeat (sync, so
            # a consumer starting right after serve_dataset() returns
            # already sees this producer)

            def hb_loop():
                while not self._stop_hb.wait(self._heartbeat_s):
                    try:
                        put_record()
                    except Exception as e:
                        get_logger().debug(
                            "data-service heartbeat failed: %s", e)

            threading.Thread(target=hb_loop, daemon=True,
                             name=f"hvd-data-hb-{self.worker_id}").start()
        return port

    def stop(self):
        """Graceful shutdown: deregister, then stop serving.  A CRASHED
        producer never runs this — its registry record simply goes stale
        and consumers evict it after ``alive_window_s``."""
        self._stop_hb.set()
        addr, rport = self._rdv
        if addr and rport:
            try:
                KVStoreClient(addr, int(rport)).delete(
                    REGISTRY_SCOPE, f"worker/{self.worker_id}")
            except Exception:
                pass
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None


def serve_dataset(dataset: Iterable[Any], worker_id: int = 0,
                  rendezvous_addr: Optional[str] = None,
                  rendezvous_port: Optional[int] = None) -> DataServiceWorker:
    """Start serving ``dataset`` (compute_worker_fn analog)."""
    w = DataServiceWorker(dataset, worker_id, rendezvous_addr,
                          rendezvous_port)
    w.start()
    return w


class RemoteDataset:
    """Trainer-side iterator (send_to_data_service read side): round-robins
    /next across live producers until every one is exhausted or evicted.

    With a rendezvous address, producers are discovered from the registry
    EVERY sweep (late joiners serve the tail of the epoch; stale-heartbeat
    producers are skipped).  A connection failure evicts the producer when
    its heartbeat is stale, OR after ``max_failures`` consecutive
    connection errors even with a fresh heartbeat (a wedged serving side
    under a live heartbeat thread must not stall every sweep forever);
    short transient failure streaks of a live producer are retried.  With
    a static ``endpoints`` list (no registry), eviction uses the
    ``max_failures`` streak alone."""

    def __init__(self, endpoints: Optional[List[str]] = None,
                 rendezvous_addr: Optional[str] = None,
                 rendezvous_port: Optional[int] = None,
                 num_workers: int = 1,
                 alive_window_s: float = ALIVE_WINDOW_S,
                 max_failures: int = 5):
        self._client = None
        self._alive_window = alive_window_s
        self._max_failures = max_failures
        self._static = endpoints
        # Heartbeat freshness is judged on the CONSUMER's clock by watching
        # the ts VALUE change (endpoint -> (last ts seen, local time it
        # changed)) — comparing a producer-host timestamp against this
        # host's clock would mark live producers dead under clock skew
        # larger than the window.
        self._hb_seen: Dict[str, tuple] = {}
        if endpoints is None:
            if not (rendezvous_addr and rendezvous_port):
                raise ValueError("pass endpoints or a rendezvous address")
            self._client = KVStoreClient(rendezvous_addr,
                                         int(rendezvous_port))
            # num_workers is kept for API compat; the registry is
            # authoritative.  ``endpoints`` is the discovery snapshot at
            # construction — iteration re-discovers every sweep.
            snap = self._registry()
            if not snap:
                raise ValueError("no data-service endpoints registered")
            self.endpoints = list(snap)
        elif not endpoints:
            raise ValueError("no data-service endpoints registered")
        else:
            self.endpoints = list(endpoints)

    def _registry(self) -> Optional[List[str]]:
        """Fresh-heartbeat producer endpoints from the registry, or None
        when the registry itself is UNREACHABLE — callers must treat None
        as "unknown" (keep the last view, evict nothing), never as "all
        producers gone": a KV blip mid-epoch must not silently end the
        epoch with batches undelivered."""
        try:
            records = sorted(self._client.scan(REGISTRY_SCOPE).items())
        except Exception as e:
            get_logger().warning(
                "data-service registry unreachable (treating producer "
                "liveness as unknown this sweep): %s", e)
            return None
        now = time.monotonic()
        out = []
        for key, raw in records:
            if not key.startswith("worker/"):
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            ep = rec.get("addr")
            seen = self._hb_seen.get(ep)
            if seen is None or seen[0] != rec.get("ts"):
                self._hb_seen[ep] = (rec.get("ts"), now)
                out.append(ep)
            elif now - seen[1] <= self._alive_window:
                out.append(ep)
        return out

    def __iter__(self) -> Iterator[Any]:
        import urllib.error
        import urllib.request
        exhausted: set = set()
        evicted: set = set()
        failures: Dict[str, int] = {}
        known = list(self.endpoints if self._client is None
                     else self._registry() or [])
        while True:
            if self._client is not None:
                reg = self._registry()
                if reg is not None:
                    known = reg
                # reg None = registry unreachable: keep the last-known
                # view (evict nothing, end nothing) and keep trying.
            live = [ep for ep in known
                    if ep not in exhausted and ep not in evicted]
            if not live:
                return
            progress = False
            for ep in live:
                try:
                    resp = urllib.request.urlopen(f"http://{ep}/next",
                                                  timeout=60)
                    # Any answered request proves the producer alive:
                    # reset its failure streak BEFORE the status check
                    # (a 204 drained-but-alive reply is a success, not a
                    # step toward 'consecutive failures').
                    failures.pop(ep, None)
                    # 204 = queue empty for the server's wait window:
                    # retry later.  urllib raises HTTPError only for
                    # status >= 400, so this must be an explicit status
                    # check, not an except branch.
                    if resp.status == 204:
                        continue
                    progress = True
                    yield pickle.loads(resp.read())
                except urllib.error.HTTPError as e:
                    if e.code == 410:  # producer exhausted: drop endpoint
                        failures.pop(ep, None)
                        exhausted.add(ep)
                    else:
                        raise
                except (urllib.error.URLError, ConnectionError,
                        TimeoutError, OSError) as e:
                    if self._evict(ep, failures, e):
                        evicted.add(ep)
            if not progress:
                time.sleep(0.2)

    def _evict(self, ep: str, failures: Dict[str, int],
               err: Exception) -> bool:
        """Decide whether a connection failure means DEAD (evict) or
        transient (retry).  Registry mode evicts on a STALE heartbeat
        (crashed producer) — and, like static mode, on ``max_failures``
        consecutive connection errors even while the heartbeat stays
        fresh: the heartbeat thread and the serving socket are
        independent, so a wedged HTTP server under a healthy heartbeat
        would otherwise be retried forever and stall every sweep.
        Static mode counts consecutive failures only."""
        if self._client is not None:
            reg = self._registry()
            if reg is None:
                # Registry unreachable: liveness is UNKNOWN — this is as
                # likely the consumer's own network blip as the producer's
                # fault, so neither eviction rule may fire and the failure
                # does NOT count toward the streak (a blip-inflated streak
                # would evict a healthy producer on its first real
                # transient error after recovery).
                return False
            failures[ep] = failures.get(ep, 0) + 1
            if ep not in reg:
                get_logger().warning(
                    "data-service producer %s unreachable with a stale "
                    "heartbeat; evicting (its undelivered batches are "
                    "lost, the epoch completes from the survivors): %s",
                    ep, err)
                return True
            if failures[ep] >= self._max_failures:
                get_logger().warning(
                    "data-service producer %s refused %d consecutive "
                    "connections despite a fresh heartbeat (serving side "
                    "wedged); evicting: %s", ep, failures[ep], err)
                return True
            # Heartbeat fresh and the failure streak still short: retry.
            return False
        failures[ep] = failures.get(ep, 0) + 1
        if failures[ep] >= self._max_failures:
            get_logger().warning(
                "data-service producer %s failed %d consecutive "
                "connections; evicting: %s", ep, failures[ep], err)
            return True
        return False
