"""Shard transports: how protocol requests reach the shard fleet.

* :class:`SimTransport` — shards live as plain objects in the calling
  process and ``call`` is a direct method invocation on the caller's
  thread.  Zero concurrency of its own, which is the point: under the
  :class:`~repro_torch.workload.clock.VirtualClock` turn discipline
  every shard call executes synchronously inside the caller's turn, so
  sharded runs are byte-for-byte deterministic.
* :class:`ProcessTransport` — one OS process per shard (``spawn``
  context: the parent runs worker threads, and forking a threaded
  process is undefined behavior; a child forked from a parent that has
  initialised CUDA cannot use CUDA at all).  Each shard process builds
  its HBM tier on the configured device in a CUDA context of its own;
  a shard that cannot reach its device fails the readiness handshake,
  and the error is raised here in the parent.  Control messages
  (pickled Request/Response) travel over one duplex pipe per shard,
  guarded by a per-shard lock; bulk payloads travel as
  :class:`~repro_torch.cache.codecs.PayloadRef` files through the
  exchange directory (memmap + unlink — the page cache, not the pipe,
  carries the bytes), so no tensor is ever pickled across.

Both expose the same three members (``call``, ``close``,
``wants_refs``), so the client cannot tell them apart.
"""
from __future__ import annotations

import multiprocessing as mp
import threading
from typing import List, Sequence

from repro_torch.service import proto
from repro_torch.service.shard import CacheShard, ShardConfig

TRANSPORTS = ("sim", "process")


class ShardDownError(RuntimeError):
    """A call targeted a shard that is dead (killed by fault injection
    or lost mid-call).  The client catches this and fails the shard's
    key range over to storage."""


class SimTransport:
    """In-process shards; deterministic and free."""

    name = "sim"
    #: payloads stay live Python objects — no exchange-dir indirection
    wants_refs = False

    def __init__(self, configs: Sequence[ShardConfig]):
        self._configs = list(configs)
        self.shards: List[CacheShard] = []
        try:
            for cfg in configs:
                self.shards.append(CacheShard(cfg))
        except BaseException:
            self.close()
            raise

    def call(self, shard_id: int, req: proto.Request) -> proto.Response:
        shard = self.shards[shard_id]
        if shard is None:
            raise ShardDownError(f"shard {shard_id} is down")
        return shard.handle(req)

    def kill(self, shard_id: int) -> None:
        """Simulate shard death: drop the object (its spill files go
        with it, like a crashed process's would on restart)."""
        shard = self.shards[shard_id]
        if shard is not None:
            shard.close()
            self.shards[shard_id] = None

    def restart(self, shard_id: int) -> None:
        """Cold-restart a killed shard from its original config."""
        if self.shards[shard_id] is not None:
            return
        self.shards[shard_id] = CacheShard(self._configs[shard_id])

    def close(self) -> None:
        for shard in self.shards:
            if shard is not None:
                shard.close()


def _shard_main(cfg: ShardConfig, conn) -> None:
    """Child-process entry: build the shard, report readiness, then
    serve the pipe until CLOSE/EOF.  The cache is torn down on every
    exit path so a dying shard leaks no spill files."""
    try:
        shard = CacheShard(cfg)
    except BaseException as e:
        try:
            conn.send(proto.Response(
                False, error=f"{type(e).__name__}: {e}"))
        finally:
            conn.close()
        return
    conn.send(proto.Response(True, value="ready"))
    try:
        while True:
            try:
                req = conn.recv()
            except (EOFError, OSError):
                break
            resp = shard.handle(req)
            try:
                conn.send(resp)
            except (BrokenPipeError, OSError):
                break
            if req.op == proto.OP_CLOSE:
                break
    finally:
        shard.close()
        conn.close()


class ProcessTransport:
    """One spawned OS process per shard, request/response over a pipe.

    Thread-safe per shard: a lock serializes each pipe (concurrent
    callers to *different* shards proceed in parallel — that is the
    transport's entire performance story).  Construction blocks on a
    readiness handshake so a shard that fails to build (bad spill dir,
    unpicklable config) surfaces as an exception here, not a hang on
    first call; a partially built fleet is torn down before the raise.
    """

    name = "process"
    wants_refs = True

    def __init__(self, configs: Sequence[ShardConfig],
                 start_method: str = "spawn",
                 start_timeout: float = 120.0):
        ctx = mp.get_context(start_method)
        self._ctx = ctx
        self._configs = list(configs)
        self._start_timeout = start_timeout
        self._procs: list = []
        self._conns: list = []
        self._locks: List[threading.Lock] = []
        self._dead: set = set()
        self._closed = False
        try:
            for cfg in configs:
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_shard_main, args=(cfg, child),
                    name=f"seneca-shard-{cfg.shard_id}", daemon=True)
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
                self._locks.append(threading.Lock())
            for i, conn in enumerate(self._conns):
                if not conn.poll(start_timeout):
                    raise RuntimeError(
                        f"shard {i} not ready within {start_timeout}s")
                resp = conn.recv()
                if not resp.ok:
                    raise RuntimeError(
                        f"shard {i} failed to start: {resp.error}")
        except BaseException:
            self.close()
            raise

    def call(self, shard_id: int, req: proto.Request) -> proto.Response:
        if self._closed:
            raise RuntimeError("transport is closed")
        if shard_id in self._dead:
            raise ShardDownError(f"shard {shard_id} is down")
        with self._locks[shard_id]:
            conn = self._conns[shard_id]
            try:
                conn.send(req)
                return conn.recv()
            except (BrokenPipeError, EOFError, OSError) as e:
                # the shard died under us: mark it so callers fail over
                # instead of hammering a broken pipe
                self._dead.add(shard_id)
                raise ShardDownError(
                    f"shard {shard_id} lost mid-call: {e!r}") from e

    def kill(self, shard_id: int) -> None:
        """Hard-kill the shard process (fault injection)."""
        if shard_id in self._dead:
            return
        self._dead.add(shard_id)
        with self._locks[shard_id]:
            proc = self._procs[shard_id]
            proc.terminate()
            proc.join(timeout=10.0)
            try:
                self._conns[shard_id].close()
            except OSError:
                pass

    def restart(self, shard_id: int) -> None:
        """Spawn a fresh shard process from the original config (cold
        cache) and block on its readiness handshake."""
        if shard_id not in self._dead:
            return
        cfg = self._configs[shard_id]
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_shard_main, args=(cfg, child),
            name=f"seneca-shard-{cfg.shard_id}", daemon=True)
        proc.start()
        child.close()
        if not parent.poll(self._start_timeout):
            proc.terminate()
            raise RuntimeError(
                f"restarted shard {shard_id} not ready within "
                f"{self._start_timeout}s")
        resp = parent.recv()
        if not resp.ok:
            raise RuntimeError(
                f"shard {shard_id} failed to restart: {resp.error}")
        with self._locks[shard_id]:
            self._procs[shard_id] = proc
            self._conns[shard_id] = parent
        self._dead.discard(shard_id)

    def close(self) -> None:
        """Idempotent orderly shutdown: CLOSE every shard (so spill
        files are cleared by the owning process), then join, escalating
        to terminate for stragglers."""
        if self._closed:
            return
        self._closed = True
        for i, conn in enumerate(self._conns):
            if i in self._dead:
                continue
            with self._locks[i]:
                try:
                    conn.send(proto.Request(proto.OP_CLOSE))
                    if conn.poll(5.0):
                        conn.recv()
                except (BrokenPipeError, OSError):
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
        for proc in self._procs:
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)


def make_transport(name: str, configs: Sequence[ShardConfig], **kwargs):
    if name == "sim":
        return SimTransport(configs)
    if name == "process":
        return ProcessTransport(configs, **kwargs)
    raise ValueError(f"unknown shard transport {name!r}; "
                     f"expected one of {TRANSPORTS}")
