"""Pluggable cluster transports behind one ``ClusterBackend`` surface.

The coordinator never branches on deployment: it sends protocol
commands through a backend and the backend decides where the worker
lives.

* :class:`LocalBackend`: workers are in-process ``WorkerRuntime``
  objects, but every message still round-trips through the wire codec
  (encode -> decode on both legs), so "it works locally" proves the
  payloads are serializable, and, because the codec is lossless raw
  bytes, the local cluster is bit-identical to an in-process
  ``ShardedUBISDriver``.  The default backend and the equivalence
  oracle.
* :class:`MultiProcessBackend`: each worker is a ``python -m
  repro_torch.cluster.worker`` subprocess of this checkout (frames over
  its stdin/stdout pipes, a reader thread per worker feeding a reply
  queue so receives can time out).  On a one-card machine every worker
  process holds its own CUDA context on the card.  ``worker_devices=N``
  gives each worker N logical shards by default (the JAX package's
  worker gets N fake devices; here one device holds them).

Failure surface: a dead or unreachable worker raises :class:`WorkerLost`
(the coordinator's restart-and-replay path catches it); a handler
exception on a live worker raises :class:`WorkerError` (the command
failed, the worker is fine).

Both backends time every RPC into a per-worker
``distributed.straggler.StragglerMonitor``; a call that trips the EWMA
watermark fires the coordinator-installed ``on_slow`` hook (the
``worker_slow`` trace event).
"""
from __future__ import annotations

import os
import queue
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from ..distributed.straggler import StragglerMonitor
from . import protocol


class WorkerLost(RuntimeError):
    """The worker process or runtime is gone (crash, kill, EOF, timeout)."""

    def __init__(self, worker: int, reason: str):
        super().__init__(f"worker {worker} lost: {reason}")
        self.worker = int(worker)
        self.reason = reason


class WorkerError(RuntimeError):
    """A command failed on a live worker (its error reply, re-raised)."""

    def __init__(self, worker: int, command: str, error: str):
        super().__init__(f"worker {worker} {command!r} failed: {error}")
        self.worker = int(worker)
        self.command = command


class ClusterBackend:
    """Transport contract: seq-tagged send/recv plus lifecycle."""

    #: the logical shards a worker's default mesh may hold
    worker_devices: int = 1

    def __init__(self, n_workers: int):
        self.n_workers = int(n_workers)
        self._seq = 0
        self.monitors = [StragglerMonitor() for _ in range(n_workers)]
        #: installed by the coordinator: (worker, command, seconds,
        #: watermark) -> None, fired when an RPC trips the monitor
        self.on_slow: Optional[Callable] = None

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # lifecycle ---------------------------------------------------------

    def start(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        raise NotImplementedError

    def restart_worker(self, worker: int) -> None:
        """Bring up a fresh worker in slot ``worker`` (blank state: the
        coordinator re-inits and replays)."""
        raise NotImplementedError

    def kill_worker(self, worker: int) -> None:
        """Test hook: make the worker unreachable mid-stream."""
        raise NotImplementedError

    # messaging ---------------------------------------------------------

    def send(self, worker: int, kind: str, payload=None) -> int:
        raise NotImplementedError

    def recv(self, worker: int, seq: int,
             timeout: Optional[float] = None) -> dict:
        raise NotImplementedError

    def call(self, worker: int, kind: str, payload=None,
             timeout: Optional[float] = None) -> dict:
        """send + recv, timed into the worker's straggler monitor."""
        t0 = time.perf_counter()
        seq = self.send(worker, kind, payload)
        out = self.recv(worker, seq, timeout=timeout)
        dt = time.perf_counter() - t0
        mon = self.monitors[worker]
        if mon.record(dt) and self.on_slow is not None:
            self.on_slow(worker, kind, dt, mon.watermark)
        return out


class LocalBackend(ClusterBackend):
    """In-process workers behind the full wire codec (see module doc)."""

    def __init__(self, n_workers: int):
        super().__init__(n_workers)
        self._runtimes: list = [None] * n_workers
        self._dead = [False] * n_workers
        self._replies: list[dict] = [dict() for _ in range(n_workers)]

    def start(self) -> None:
        from .worker import WorkerRuntime
        self._runtimes = [WorkerRuntime(self.worker_devices)
                          for _ in range(self.n_workers)]
        self._dead = [False] * self.n_workers

    def stop(self) -> None:
        self._runtimes = [None] * self.n_workers

    def restart_worker(self, worker: int) -> None:
        from .worker import WorkerRuntime
        self._runtimes[worker] = WorkerRuntime(self.worker_devices)
        self._dead[worker] = False

    def kill_worker(self, worker: int) -> None:
        # drop the runtime entirely: its un-checkpointed state is gone,
        # exactly like a crashed process
        self._runtimes[worker] = None
        self._dead[worker] = True

    def runtime(self, worker: int):
        """The in-process ``WorkerRuntime`` of slot ``worker`` (tests and
        ``chip_smoke.py`` read its driver's replicas)."""
        return self._runtimes[worker]

    def send(self, worker: int, kind: str, payload=None) -> int:
        if self._dead[worker] or self._runtimes[worker] is None:
            raise WorkerLost(worker, "killed")
        seq = self._next_seq()
        # full wire round trip both ways: an unserializable payload fails
        # here, not first on the multi-process backend
        msg = protocol.decode_message(
            protocol.encode_message(kind, payload, seq))
        try:
            out = self._runtimes[worker].handle(msg["kind"],
                                                msg["payload"])
            reply = protocol.encode_message("ok", out, seq)
        except Exception as e:  # noqa: BLE001 - mirrors the serve loop
            reply = protocol.encode_message(
                "error", {"command": kind, "error": repr(e)}, seq)
        self._replies[worker][seq] = protocol.decode_message(reply)
        return seq

    def recv(self, worker: int, seq: int,
             timeout: Optional[float] = None) -> dict:
        msg = self._replies[worker].pop(seq)
        if msg["kind"] == "error":
            raise WorkerError(worker, msg["payload"]["command"],
                              msg["payload"]["error"])
        return msg["payload"]


class MultiProcessBackend(ClusterBackend):
    """Worker subprocesses over stdin/stdout pipe frames.

    ``worker_devices``: the logical shards of a worker's default mesh
    (``cluster.worker``); default timeouts are generous because a
    worker's first commands build its state and load the kernels."""

    def __init__(self, n_workers: int, *, worker_devices: int = 1,
                 timeout: Optional[float] = 600.0,
                 python: str = sys.executable):
        super().__init__(n_workers)
        self.worker_devices = int(worker_devices)
        self.timeout = timeout
        self.python = python
        self._procs: list = [None] * n_workers
        self._queues: list = [None] * n_workers

    # lifecycle ---------------------------------------------------------

    def _env(self) -> dict:
        env = os.environ.copy()
        # the worker must import repro_torch from this checkout
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
            else "")
        return env

    def _spawn(self, worker: int) -> None:
        proc = subprocess.Popen(
            [self.python, "-m", "repro_torch.cluster.worker",
             "--devices", str(self.worker_devices)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=self._env())
        q: queue.Queue = queue.Queue()

        def pump(stdout=proc.stdout, q=q):
            try:
                while True:
                    buf = protocol.read_frame(stdout)
                    if buf is None:
                        break
                    q.put(protocol.decode_message(buf))
            except Exception:   # noqa: BLE001 - EOF/teardown races
                pass
            q.put(None)         # EOF sentinel
        threading.Thread(target=pump, daemon=True).start()
        self._procs[worker] = proc
        self._queues[worker] = q

    def start(self) -> None:
        for w in range(self.n_workers):
            self._spawn(w)

    def stop(self) -> None:
        for proc in self._procs:
            if proc is None:
                continue
            try:
                protocol.write_frame(
                    proc.stdin,
                    protocol.encode_message("shutdown", {},
                                            self._next_seq()))
            except Exception:  # noqa: BLE001 - already dead is fine
                pass
        for proc in self._procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=30)
            except Exception:  # noqa: BLE001
                proc.kill()
                proc.wait()
        self._procs = [None] * self.n_workers

    def restart_worker(self, worker: int) -> None:
        self.kill_worker(worker)
        self._spawn(worker)

    def kill_worker(self, worker: int) -> None:
        proc = self._procs[worker]
        if proc is not None:
            proc.kill()
            proc.wait()
        self._procs[worker] = None

    def pid(self, worker: int) -> Optional[int]:
        """The worker's process id (None when it has none)."""
        proc = self._procs[worker]
        return None if proc is None else proc.pid

    # messaging ---------------------------------------------------------

    def send(self, worker: int, kind: str, payload=None) -> int:
        proc = self._procs[worker]
        if proc is None or proc.poll() is not None:
            raise WorkerLost(worker, "process dead")
        seq = self._next_seq()
        try:
            protocol.write_frame(
                proc.stdin, protocol.encode_message(kind, payload, seq))
        except (BrokenPipeError, OSError) as e:
            raise WorkerLost(worker, f"pipe: {e}") from e
        return seq

    def recv(self, worker: int, seq: int,
             timeout: Optional[float] = None) -> dict:
        timeout = self.timeout if timeout is None else timeout
        try:
            msg = self._queues[worker].get(timeout=timeout)
        except queue.Empty:
            raise WorkerLost(worker, f"no reply in {timeout}s") from None
        if msg is None:
            raise WorkerLost(worker, "EOF")
        if msg["seq"] != seq:
            raise WorkerLost(worker,
                             f"out-of-order reply {msg['seq']} != {seq}")
        if msg["kind"] == "error":
            raise WorkerError(worker, msg["payload"]["command"],
                              msg["payload"]["error"])
        return msg["payload"]
