"""The device server: the one process that holds the device runs the device
calls of its host-only worker processes.  Port-only, like ``device.py``.

The reference keeps its accelerator in the parent process: an alignment
worker sets ``JAX_PLATFORMS=cpu`` and builds its aligner without JAX
(``hla_la_tpu/models/parallel_host.py::_init_worker``), and the typing
workers taken from that pool run on the host too.  The port's workers are
host-only as well: they do not even import torch (the modules on their
path name it through ``_lazy.py``), so they hold no context and no
page-locked memory; and still every NW job of a card run runs on the card:
a worker sends each of
its device calls to one thread of the process that owns the device, which
runs it through the functions the one-process run calls:

  nw                 ``NWRunner.run``: K1, or K2 for bands above 32
  cluster_read_ll    ``ops/pair_ll.cluster_read_ll``: the cluster x read
                     products
  pair_ll_reduction  ``ops/pair_ll.pair_ll_reduction``: K3

So the card holds one context, and each result is the one-process run's.

``DeviceServer(device)`` listens on an abstract Unix socket (no file, so
nothing to clean up); a pool passes ``server.initargs`` to its initializer,
which calls ``connect`` once.  A request is a small pickled header; its
arrays travel through one shared region per worker, an anonymous shared
memory file (``memfd``, not bounded by the size of ``/dev/shm``) whose
descriptor the worker passes over the socket when it makes or grows the
region.  The worker lays a call's inputs and outputs out in its region, the
server maps the same pages, reads the inputs there and writes the outputs
there, on a card straight from the device (each region is page-locked in
the server's process with ``cudaHostRegister`` when it is mapped).  A reply
carries the jobs run, the device type they ran on, the launches of each
kernel and the device milliseconds of each launch (CUDA events), or the
server's exception text, which the worker raises.  While the worker's
task is traced, a request's header also carries the caller's span and the
time it was sent (``timing.clock()``), and the server records the request
as the span ``server.request``: its kind, the worker's pid, the jobs, the
bytes in and out, and ``wait_ns``, the time from the send to the start of
service (the request's wait in the server's queue).

One thread serves one request at a time, in arrival order across the
workers (``multiprocessing.connection.wait``).  A worker's connection that
closes before ``stop`` means the worker died: ``watch``, the parent's loop
over the pool's results, raises then instead of waiting for a result that
will not come.

Regions: an NW call is cut to the worker's share of ``NW_POINTER_BUDGET``
(``region_share``), so that the NW regions of all workers together hold
what one process would pin; NW results do not depend on how the jobs are
cut into calls.  A typing request goes whole, as the one-process run makes
it: the typer bounds its cluster x read chunks itself, and K3's read sum is
not cut.
"""

from __future__ import annotations

import mmap
import os
import secrets
import sys
import threading
import traceback
from dataclasses import dataclass
from multiprocessing.connection import Client, Listener, wait

import numpy as np

from .._lazy import torch
from ..utils import timing
from .aligner import MAX_JOBS, NWRunner, jobs_per_call

KERNELS = ("K1", "K2", "K3")
_ALIGN = 256        # byte alignment of each array in a region


def _wrappers() -> dict:
    from ..ops.cuda_nw import banded_nw_cuda
    from ..ops.cuda_nw_long import banded_nw_long_cuda
    from ..ops.cuda_pair import pair_ll_diff_cuda
    return {"K1": banded_nw_cuda, "K2": banded_nw_long_cuda,
            "K3": pair_ll_diff_cuda}


def _layout(specs) -> tuple[list[int], int]:
    """Byte offsets of arrays of (shape, dtype) laid out one after the
    other, each at a multiple of _ALIGN, and the bytes they take."""
    offs, end = [], 0
    for shape, dtype in specs:
        offs.append(end)
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        end += -(-n // _ALIGN) * _ALIGN
    return offs, end


class _Region:
    """A worker's region as the server maps it."""

    def __init__(self, fd: int, size: int, device: torch.device):
        from ..device import resolve
        resolve(device)
        self.mm = mmap.mmap(fd, size)
        self.buf = np.frombuffer(self.mm, dtype=np.uint8)
        self.registered = False
        if device.type == "cuda":
            cudart = torch.cuda.cudart()
            torch.cuda.check_error(cudart.cudaHostRegister(
                self.buf.ctypes.data, size, 0))
            self.registered = True

    def views(self, specs) -> list[np.ndarray]:
        return [np.ndarray(tuple(shape), np.dtype(dt), self.buf, off)
                for off, shape, dt in specs]

    def release(self) -> None:
        if self.registered:
            torch.cuda.check_error(
                torch.cuda.cudart().cudaHostUnregister(self.buf.ctypes.data))
            self.registered = False
        self.buf = None
        try:
            self.mm.close()
        except BufferError:     # a view still alive: unmapped when it goes
            pass


class _Peer:
    """The server's record of one connected worker."""

    def __init__(self):
        self.pid = None
        self.region: _Region | None = None

    def drop_region(self) -> None:
        if self.region is not None:
            self.region.release()
            self.region = None


class DeviceServer:
    """Serves the device calls of worker processes on `device`, from a
    thread of this process, until ``stop``."""

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self.authkey = secrets.token_bytes(16)
        self.address = (f"\0hla_la_tpu_torch-{os.getpid()}-"
                        f"{secrets.token_hex(8)}")
        self._listener = Listener(self.address, "AF_UNIX",
                                  authkey=self.authkey)
        self._lock = threading.Lock()
        self._accepted: list = []
        self._wake_r, self._wake_w = os.pipe()
        self._stopping = False
        self._nw = None         # its NWRunner, made at the first NW call
        # torch's intra-op thread count is per thread (OpenMP): the server
        # thread takes its creator's, so that a plain version on the CPU
        # sums in the order the one-process run does
        self._threads = torch.get_num_threads()
        # pids of workers whose connection closed before stop()
        self.lost: list[int] = []
        # what the server ran for the workers
        self.served = {"requests": 0, "nw_jobs": 0,
                       "launches": dict.fromkeys(KERNELS, 0)}
        # the largest region each worker held, by pid
        self.region_peak: dict[int, int] = {}
        self._acceptor = threading.Thread(target=self._accept, daemon=True,
                                          name="device server accept")
        self._server = threading.Thread(target=self._serve, daemon=True,
                                        name="device server")
        self._acceptor.start()
        self._server.start()

    @property
    def initargs(self) -> tuple:
        """What a pool's initializer passes to ``connect``."""
        return (self.address, self.authkey)

    # ------------------------------------------------------------ threads
    def _accept(self) -> None:
        while True:
            try:
                conn = self._listener.accept()
            except Exception:   # noqa: BLE001 — a client that failed auth
                if self._stopping:
                    return
                continue
            if self._stopping:
                conn.close()
                return
            with self._lock:
                self._accepted.append(conn)
            os.write(self._wake_w, b"c")

    def _serve(self) -> None:
        torch.set_num_threads(self._threads)
        peers: dict = {}
        while True:
            for conn in wait([self._wake_r, *peers]):
                if conn == self._wake_r:
                    os.read(self._wake_r, 4096)
                    with self._lock:
                        new, self._accepted = self._accepted, []
                    peers.update((c, _Peer()) for c in new)
                    if self._stopping:
                        for c, peer in peers.items():
                            peer.drop_region()
                            c.close()
                        return
                    continue
                peer = peers[conn]
                try:
                    msg = conn.recv()
                    # the span ends before the reply goes, inside the
                    # caller's own span
                    with _request_span(msg, peer.pid) as sp:
                        reply = self._handle(conn, peer, msg)
                        sp.set(jobs=reply.get("jobs", 0))
                    conn.send(reply)
                except Exception:   # noqa: BLE001 — the connection is lost
                    # the worker is gone, mid-request or idle (or sent what
                    # cannot be read): its connection goes, the server stays
                    if not self._stopping and peer.pid is not None:
                        self.lost.append(peer.pid)
                    peer.drop_region()
                    conn.close()
                    del peers[conn]

    # ----------------------------------------------------------- requests
    def _handle(self, conn, peer: _Peer, msg: dict) -> dict:
        kind = msg["kind"]
        if kind == "hello":
            peer.pid = msg["pid"]
            return {"ok": True, "device": self.device.type,
                    "pid": os.getpid()}
        if kind == "region":
            from multiprocessing.reduction import recv_handle
            fd = recv_handle(conn)
            try:
                peer.drop_region()
                peer.region = _Region(fd, msg["size"], self.device)
            except Exception as exc:    # noqa: BLE001 — sent back
                return self._failed(exc)
            finally:
                os.close(fd)
            self.region_peak[peer.pid] = max(
                self.region_peak.get(peer.pid, 0), msg["size"])
            return {"ok": True}
        self.served["requests"] += 1
        try:
            arrays = peer.region.views(msg["arrays"])
            return self._run(kind, msg, arrays[:msg["n_in"]],
                             arrays[msg["n_in"]:])
        except Exception as exc:    # noqa: BLE001 — sent back
            return self._failed(exc)

    @staticmethod
    def _failed(exc: Exception) -> dict:
        return {"ok": False, "error": f"{type(exc).__name__}: {exc}",
                "traceback": traceback.format_exc()}

    def _run(self, kind: str, msg: dict, ins: list, outs: list) -> dict:
        from ..device import resolve
        from ..ops.pair_ll import cluster_read_ll, pair_ll_reduction
        resolve(self.device)
        wrappers = _wrappers()
        before = {k: fn.launches for k, fn in wrappers.items()}
        timed = self.device.type == "cuda"
        saved = {k: fn.events for k, fn in wrappers.items()}
        if timed:
            for fn in wrappers.values():
                fn.events = []
        try:
            jobs = 0
            if kind == "nw":
                reads, lens, refs = ins
                if self._nw is None:
                    self._nw = NWRunner(self.device)
                self._nw.run(reads, lens, refs, msg["pointers"], out=outs)
                jobs = len(reads)
            elif kind == "cluster_read_ll":
                cluster_read_ll(*ins, self.device, out=outs)
            elif kind == "pair_ll_reduction":
                outs[0][...] = pair_ll_reduction(ins[0], self.device)
            else:
                raise ValueError(f"unknown request {kind!r}")
            if timed:
                torch.cuda.current_stream(self.device).synchronize()
            ms = {k: [s.elapsed_time(e) for s, e in fn.events or ()]
                  for k, fn in wrappers.items()}
        finally:
            for k, fn in wrappers.items():
                fn.events = saved[k]
        launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        self.served["nw_jobs"] += jobs
        for k, n in launches.items():
            self.served["launches"][k] += n
        return {"ok": True, "device": self.device.type, "jobs": jobs,
                "launches": launches, "ms": ms}

    # ------------------------------------------------------------ control
    def check(self) -> None:
        """Raise if a worker died while the server held its connection, or
        if the server's thread ended before ``stop``."""
        if not self._stopping and not self._server.is_alive():
            raise RuntimeError("the device server's thread ended")
        if self.lost:
            raise RuntimeError(
                f"worker process(es) {sorted(self.lost)} exited while the "
                f"device server held their connection")

    def watch(self, results, poll_s: float = 1.0):
        """Yield a pool's ``imap``/``imap_unordered`` results, checking
        between them that no worker died."""
        import multiprocessing as mp
        while True:
            try:
                item = results.next(timeout=poll_s)
            except StopIteration:
                return
            except mp.TimeoutError:
                self.check()
                continue
            yield item

    def stop(self) -> None:
        """End the server: its thread closes every connection and releases
        every region.  Idempotent."""
        if self._stopping:
            return
        self._stopping = True
        try:    # wake the acceptor, blocked in accept()
            Client(self.address, "AF_UNIX", authkey=self.authkey).close()
        except OSError:
            pass
        self._acceptor.join()
        self._listener.close()
        os.write(self._wake_w, b"s")
        self._server.join()
        os.close(self._wake_r)
        os.close(self._wake_w)


def _request_span(msg: dict, pid):
    """The span of a traced task's request, whose header carries the
    caller's span and the time it was sent; the no-op span otherwise."""
    if "sent_ns" not in msg:
        return timing.NOOP
    wait_ns = timing.clock() - msg["sent_ns"]
    n_in = msg["n_in"]
    sizes = [int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
             for _, shape, dt in msg["arrays"]]
    return timing.span("server.request", parent=msg["span"],
                       kind=msg["kind"], pid=pid, wait_ns=wait_ns,
                       bytes_in=sum(sizes[:n_in]),
                       bytes_out=sum(sizes[n_in:]))


# ----------------------------------------------------------- worker side
@dataclass(frozen=True)
class ServedDevice:
    """The server's device as a worker names it: its type alone, with no
    torch behind it."""
    type: str

    def __str__(self) -> str:
        return self.type


def torch_imported() -> bool:
    return sys.modules.get("torch") is not None


def cuda_initialized() -> bool:
    """Whether this process made a CUDA call (which pinning memory needs);
    never, where torch was not even imported."""
    return torch_imported() and sys.modules["torch"].cuda.is_initialized()


class DeviceClient:
    """A worker's connection to the server, and its region."""

    def __init__(self, address: str, authkey: bytes,
                 region_share: int | None = None):
        self.conn = Client(address, "AF_UNIX", authkey=authkey)
        hello = self._ask({"kind": "hello", "pid": os.getpid()})
        self.device = ServedDevice(hello["device"])
        self.server_pid = hello["pid"]
        # the bytes an NW call may take in the region
        self.region_share = region_share
        self.region_bytes = 0
        self._buf = None
        self.requests = 0
        self.launches = dict.fromkeys(KERNELS, 0)
        self.ms: dict[str, list[float]] = {k: [] for k in KERNELS}

    def _ask(self, msg: dict) -> dict:
        try:
            self.conn.send(msg)
            return self.conn.recv()
        except (EOFError, OSError) as exc:
            raise RuntimeError(f"the device server closed the connection "
                               f"({type(exc).__name__})") from exc

    def _grow(self, need: int) -> None:
        from multiprocessing.reduction import send_handle
        share = self.region_share or need
        size = -(-max(need, min(2 * self.region_bytes, share))
                 // mmap.PAGESIZE) * mmap.PAGESIZE
        if need <= share:
            size = min(size, share)
        fd = os.memfd_create("hla_la_tpu_torch-region", os.MFD_CLOEXEC)
        try:
            os.ftruncate(fd, size)
            buf = np.frombuffer(mmap.mmap(fd, size), dtype=np.uint8)
            self.conn.send({"kind": "region", "size": size})
            send_handle(self.conn, fd, self.server_pid)
            reply = self.conn.recv()
        except (EOFError, OSError) as exc:
            raise RuntimeError(f"the device server closed the connection "
                               f"({type(exc).__name__})") from exc
        finally:
            os.close(fd)
        self._raise(reply)
        self._buf = buf         # the old mapping goes with its last view
        self.region_bytes = size

    def _raise(self, reply: dict) -> None:
        if not reply["ok"]:
            raise RuntimeError(f"device server on {self.device}: "
                               f"{reply['error']}")

    def call(self, kind: str, inputs: list, outputs: list, **fields
             ) -> tuple[list[np.ndarray], dict]:
        """Run request `kind` on the server: `inputs` (numpy arrays) are
        copied into the region, `outputs` [(shape, dtype)] come back as
        views of it, which the next call overwrites."""
        specs = ([(a.shape, a.dtype) for a in inputs]
                 + [(tuple(s), np.dtype(d)) for s, d in outputs])
        offs, need = _layout(specs)
        if need > self.region_bytes or self._buf is None:
            self._grow(max(need, 1))
        arrays = [np.ndarray(shape, dtype, self._buf, off)
                  for off, (shape, dtype) in zip(offs, specs)]
        for dst, src in zip(arrays, inputs):
            np.copyto(dst, src)
        header = {"kind": kind, "n_in": len(inputs),
                  "arrays": [(off, shape, np.dtype(dt).str)
                             for off, (shape, dt) in zip(offs, specs)],
                  **fields}
        ctx = timing.context()
        if ctx is not None:
            header.update(span=ctx[1], sent_ns=timing.clock())
        reply = self._ask(header)
        self._raise(reply)
        self.requests += 1
        for k, n in reply["launches"].items():
            self.launches[k] += n
            self.ms[k] += reply["ms"].get(k, [])
        return arrays[len(inputs):], reply

    def report(self) -> dict:
        """What the worker tells the parent after a task: whether it
        imported torch and made a CUDA call, its requests, the device
        milliseconds of the launches made for it, and its region."""
        return {"pid": os.getpid(), "torch_imported": torch_imported(),
                "cuda_initialized": cuda_initialized(),
                "requests": self.requests,
                "device_ms": {k: sum(ms) for k, ms in self.ms.items()},
                "region_bytes": self.region_bytes}


_CLIENT: DeviceClient | None = None


def connect(address: str, authkey: bytes,
            region_share: int | None = None) -> DeviceClient:
    """Connect this worker process to the server (once, from the pool's
    initializer); the served functions below go through it."""
    global _CLIENT
    _CLIENT = DeviceClient(address, authkey, region_share)
    return _CLIENT


def client() -> DeviceClient:
    if _CLIENT is None:
        raise RuntimeError("this process is not connected to a device "
                           "server")
    return _CLIENT


class ServedNWRunner(NWRunner):
    """NWRunner's interface in a host-only worker: every forward call runs
    on the server's device, under the server's NWRunner's scoring (the
    aligner's, DEFAULT_SCORING).  Its host buffers are plain numpy (never
    page-locked), and a call's results are views of the worker's region,
    which the next call overwrites, as NWRunner's are of its own buffers."""

    def __init__(self, served: DeviceClient):
        from ..ops.banded_nw import DEFAULT_SCORING
        from ..utils.timing import Stats
        self.client = served
        self.device = served.device
        self.scoring = DEFAULT_SCORING
        self.stats = Stats()
        self.scratch: dict = {}

    def host_buffer(self, name: str, shape, dtype,
                    crosses: bool = False) -> np.ndarray:
        dtype = np.dtype(dtype)
        need = int(np.prod(shape)) * dtype.itemsize
        buf = self.scratch.get(name)
        if buf is None or buf.nbytes < need:
            buf = self.scratch[name] = np.empty(max(need, 1), np.uint8)
        return buf[:need].view(dtype).reshape(shape)

    def jobs_per_call(self, L: int, W: int) -> int:
        """NWRunner's rule, and at most what fits the worker's share of the
        regions: inputs (lengths as int64) and outputs of one call."""
        share = self.client.region_share
        if share is None:
            return jobs_per_call(L, W)
        per_job = L + 8 + (L + W) + 12 + (L + 1) * W
        return max(1, min(jobs_per_call(L, W), MAX_JOBS,
                          (share - 7 * _ALIGN) // per_job))

    def run(self, reads_arr, lens_arr, refs_arr, pointers: bool = True):
        B, L = reads_arr.shape
        W = refs_arr.shape[1] - L
        outs = [((B,), np.float32), ((B,), np.int32), ((B,), np.int32)]
        if pointers:
            outs.append(((B, L + 1, W), np.uint8))
        res, reply = self.client.call(
            "nw", [reads_arr, lens_arr, refs_arr], outs, pointers=pointers)
        self.stats.bump(f"nw_jobs_on_{reply['device']}", reply["jobs"])
        self.stats.bump("served_nw_calls")
        self.stats.bump("served_nw_jobs", reply["jobs"])
        for k, n in reply["launches"].items():
            if n:
                self.stats.bump(f"served_launches_{k}", n)
        return tuple(res) if pointers else (*res, None)


def served_cluster_read_ll(onehot: np.ndarray, contrib: np.ndarray,
                           mismatch: np.ndarray, device=None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """``ops/pair_ll.cluster_read_ll`` on the server's device (`device` is
    the server's); (LL, MM) are views of the region, overwritten by the
    next call."""
    C, R = onehot.shape[0], contrib.shape[0]
    (ll, mm), _ = client().call(
        "cluster_read_ll", [onehot, contrib, mismatch],
        [((C, R), np.float32), ((C, R), np.float32)])
    return ll, mm


def served_pair_ll_reduction(L: np.ndarray, device=None,
                             sharded=None) -> np.ndarray:
    """``ops/pair_ll.pair_ll_reduction`` on the server's device: K3 on a
    card.  The server is one device: `sharded` must be None."""
    if sharded is not None:
        raise ValueError("a served reduction runs on the server's device")
    C = L.shape[0]
    (pair,), _ = client().call("pair_ll_reduction", [L],
                               [((C, C), np.float64)])
    return pair.copy()
