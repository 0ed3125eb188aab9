"""Host-side cohort inputs and prefetchers (port of
``repro/data/prefetch.py``).

``stack_host`` and ``Cohort`` are one round's inputs. Two backends build
cohorts up to ``depth`` rounds ahead of the round loop
(``make_prefetcher`` picks one by ``FedConfig.prefetch_backend``):

* :class:`ProcessCohortPrefetcher` (``"process"``) — a child process
  builds cohorts and hands the numpy leaves to the consumer through a ring
  of shared-memory arena slots, so a builder that holds the GIL (numpy
  decode and copies) overlaps the round loop's Python. The child is
  started with ``spawn``, never ``fork``: the parent runs torch's and
  CUDA's threads, and a forked child of a multithreaded process can
  deadlock on a lock some thread held at the fork. So ``build_fn`` must
  pickle (probed at construction), the child imports what it needs afresh,
  produces numpy leaves only and never initialises CUDA.
* :class:`CohortPrefetcher` (``"thread"``) — in-process; any leaf types,
  but a builder that holds the GIL serializes with the round loop.

Both only *build* cohorts; ordering, staleness and server updates stay
with the consumer (``core.engine.RoundEngine``).

Multi-process feeding: with a mesh of ranks each rank builds only its own
rows of a cohort (``local_row_range``) and places them on its own device
(``host_shard_to_global`` / ``globalize_cohort_batches``); no batch bytes
cross ranks. ``replicate_global`` places the inputs every rank holds alike
(server state, ids, masks) on the rank's device. The reference assembles
global arrays from the per-host slices; the port has no global arrays, so
these are their rank-local counterparts, and the round program takes the
rank's rows as they are (``core/round_program.py``).
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import threading
import time
import traceback
import warnings
from multiprocessing import shared_memory
from multiprocessing.reduction import ForkingPickler
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def local_row_range(mesh, axes, global_rows: int):
    """The ``[lo, hi)`` leading-axis rows this rank runs when
    ``global_rows`` cohort rows split evenly over the mesh ``axes`` (a
    name or a tuple); ``ValueError`` when they do not divide."""
    # core.client_state imports this module's package: import late
    from repro_torch.core.client_state import cohort_rows  # noqa: PLC0415

    return cohort_rows(mesh, global_rows, axes)


def host_shard_to_global(local, mesh, axes, global_rows: int,
                         row_offset: int) -> torch.Tensor:
    """This rank's contiguous ``(rows, ...)`` slice of a ``(global_rows,
    ...)`` cohort array, checked to be exactly the rows
    :func:`local_row_range` gives the rank (the reference's callback
    raises on the same mismatch), on the rank's device."""
    lo, hi = local_row_range(mesh, axes, global_rows)
    rows = int(np.shape(local)[0])
    if (row_offset, row_offset + rows) != (lo, hi):
        raise RuntimeError(
            f"rows [{row_offset}, {row_offset + rows}) given to a rank "
            f"that runs [{lo}, {hi})")
    if isinstance(local, np.ndarray):
        local = torch.from_numpy(np.ascontiguousarray(local))
    return local.to(mesh.device)


def globalize_cohort_batches(batches, mesh, axes, global_rows: int,
                             row_offset: int):
    """This rank's stacked batches (its :func:`local_row_range` rows of
    the cohort) with every leaf checked and placed on its device by
    :func:`host_shard_to_global`."""
    return pytree.tree_map(
        lambda b: host_shard_to_global(b, mesh, axes, global_rows,
                                       row_offset), batches)


def replicate_global(tree, mesh):
    """A tree every rank holds alike (numpy or tensor leaves) on the
    rank's device; tensors already there pass through."""
    def place(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else x

    return pytree.tree_map(place, tree)


def stack_host(trees):
    """Stack identically-structured batch trees along a new leading
    (client) axis: numpy leaves with ``np.stack`` (they transfer to the
    device once, when the round consumes them), tensors with
    ``torch.stack``."""
    def stack(*xs):
        if isinstance(xs[0], np.ndarray):
            return np.stack(xs)
        return torch.stack(xs)

    return pytree.tree_map(stack, *trees)


class Cohort(NamedTuple):
    """One round's materialized inputs: ids are informational, ``batches``
    carries the (C, K, ...) stacked trees, ``weights`` is None for
    uniform.

    The trailing fields are the fault annotations of
    ``data.cohort_source.CohortSource``: ``survivors`` is the (C,) float
    0/1 mid-round dropout mask the round program threads into the
    aggregation (None = no mask faults this run), ``extra_staleness`` the
    straggler lateness in rounds the engine adds to the discount exponent,
    and ``dropped`` the count of masked-out cohort slots (for the round
    history).
    """

    round_idx: int
    client_ids: object
    batches: object
    weights: Optional[object] = None
    survivors: Optional[object] = None
    extra_staleness: int = 0
    dropped: int = 0


#: build_fn(round_idx) -> Cohort
BuildFn = Callable[[int], Cohort]


class CohortPrefetcher:
    """Iterates ``build_fn(start_round) .. build_fn(stop_round - 1)`` on a
    daemon thread, keeping at most ``depth`` finished cohorts queued.

    ``get(round_idx)`` returns cohorts strictly in round order; a builder
    exception is re-raised at the next ``get``, so failures surface in the
    consumer, not silently in a thread.
    """

    _DONE = object()

    def __init__(self, build_fn: BuildFn, start_round: int, stop_round: int,
                 depth: int = 2, close_timeout: float = 5.0):
        """Start the worker thread building rounds ``[start, stop)``."""
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._close_timeout = close_timeout
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()

        def put(item) -> bool:
            """Blocking put that gives up once close() is requested."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for r in range(start_round, stop_round):
                    if self._stop.is_set() or not put(build_fn(r)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in get()
                self._error = e
            put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="cohort-prefetch")
        self._thread.start()

    def get(self, round_idx: int) -> Cohort:
        """Blocking in-order fetch of round ``round_idx``'s cohort
        (re-raises a builder exception, refuses out-of-order reads)."""
        item = self._q.get()
        if item is self._DONE:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            raise RuntimeError(
                f"prefetcher exhausted before round {round_idx}")
        if item.round_idx != round_idx:
            raise RuntimeError(
                f"prefetcher out of order: expected round {round_idx}, "
                f"got {item.round_idx}")
        return item

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def close(self):
        """Stop the worker and drop queued cohorts (idempotent).

        Drain and join loop until the thread exits (a single
        drain-then-join races a worker mid-``put``); a worker that does not
        exit within ``close_timeout`` seconds — a hung ``build_fn`` —
        raises instead of staying behind as a silent zombie.
        """
        self._stop.set()
        deadline = time.monotonic() + self._close_timeout
        while self._thread.is_alive():
            self._drain()
            self._thread.join(timeout=0.05)
            if self._thread.is_alive() and time.monotonic() >= deadline:
                raise RuntimeError(
                    f"cohort-prefetch thread did not exit within "
                    f"{self._close_timeout}s of close() — build_fn is "
                    f"likely hung")
        self._drain()  # anything put between the last drain and exit

    def __enter__(self):
        """Context-manager entry: the prefetcher itself."""
        return self

    def __exit__(self, *exc):
        """Close on exit; a hung-worker error must not mask the with-body's
        own exception."""
        close_prefetcher(self, unwinding=exc[0] is not None)
        return False


# ---------------------------------------------------------------------------
# Process-based backend: a spawned builder + a shared-memory arena ring
# ---------------------------------------------------------------------------

#: Arena slot offsets are aligned so consumer views keep numpy's preferred
#: alignment (and cache lines don't straddle leaves).
_ALIGN = 64


class _ArenaLeaf:
    """Placeholder for one numpy leaf shipped through the arena; the pickled
    cohort skeleton carries these where the arrays were. A plain class, not
    a NamedTuple: the pytree must treat it as an opaque leaf."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        """Bind the position in the slot's ordered leaf list."""
        self.index = index

    def __getstate__(self):
        """Pickle as the bare slot index (sent over the worker pipe)."""
        return self.index

    def __setstate__(self, index):
        """Rebuild from the bare slot index."""
        self.index = index


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _strip_cohort(cohort: Cohort):
    """Split a cohort into (pickled skeleton, ordered numpy leaves).

    Containers and small Python leaves (ints, None, strings) stay in the
    skeleton; every ``np.ndarray`` leaf is replaced by an :class:`_ArenaLeaf`
    token and shipped through shared memory. Tensors are refused: the
    child builds numpy only.
    """
    leaves = []

    def strip(x):
        if isinstance(x, np.ndarray):
            leaves.append(np.ascontiguousarray(x))
            return _ArenaLeaf(len(leaves) - 1)
        if isinstance(x, torch.Tensor):
            raise TypeError(
                "the process-based cohort prefetcher requires numpy-leaf "
                "batch trees (its child builds on the host and never "
                "touches CUDA); this build_fn produced a torch.Tensor — "
                "use prefetch_backend='thread'")
        return x

    skeleton = pytree.tree_map(strip, cohort)
    return pickle.dumps(skeleton), leaves


def _fill_cohort(skeleton_bytes: bytes, views):
    """Rebuild a cohort from its pickled skeleton + arena leaf views."""
    skeleton = pickle.loads(skeleton_bytes)
    return pytree.tree_map(
        lambda x: views[x.index] if isinstance(x, _ArenaLeaf) else x,
        skeleton)


def _arena_worker(build_fn: BuildFn, start: int, stop: int, free_r, meta_w,
                  base_name: str) -> None:
    """Child-process loop: build cohorts into shared-memory arena slots.

    Waits for a free slot index (``None`` = stop), builds the round's
    cohort, writes its numpy leaves into the slot's segment (re-created
    larger under a fresh name when a cohort outgrows it), and sends the
    slot's metadata. The channels are raw ``Pipe`` connections, not
    ``mp.Queue``s: a queue ships every ``put`` through a feeder thread,
    and the parent's feeder would contend for the parent's GIL — the
    contention this backend exists to remove. A spawned child shares the
    parent's resource tracker, so a segment created here stays registered
    until the parent's ``close()`` unlinks it (which unregisters it once);
    the child only closes its mappings.
    """
    slots = {}          # slot idx -> SharedMemory
    gen = 0
    try:
        for r in range(start, stop):
            slot = free_r.recv()
            if slot is None:
                return
            cohort = build_fn(r)
            if torch.cuda.is_initialized():
                raise RuntimeError(
                    "build_fn initialised CUDA in the cohort-arena child; "
                    "the process backend builds numpy on the host (use "
                    "prefetch_backend='thread' for a builder that needs "
                    "the device)")
            skeleton, leaves = _strip_cohort(cohort)
            descs, total = [], 0
            for x in leaves:
                off = _align(total)
                descs.append((off, x.shape, x.dtype))
                total = off + x.nbytes
            shm = slots.get(slot)
            if shm is None or shm.size < total:
                if shm is not None:
                    shm.close()
                gen += 1
                shm = shared_memory.SharedMemory(
                    name=f"{base_name}-{slot}-{gen}", create=True,
                    size=max(total, 1))
                slots[slot] = shm
            for x, (off, shape, dtype) in zip(leaves, descs):
                dst = np.ndarray(shape, dtype, buffer=shm.buf, offset=off)
                dst[...] = x
            meta_w.send(("item", r, (slot, shm.name, skeleton, descs)))
        meta_w.send(("done", None, None))
    except BaseException:  # noqa: BLE001 — re-raised in the parent's get()
        meta_w.send(("error", None, traceback.format_exc()))
    finally:
        for shm in slots.values():
            shm.close()


def _require_picklable(build_fn: BuildFn) -> None:
    """Raise ``ValueError`` naming the thread backend when ``build_fn``
    cannot be sent to a spawned child (a lambda, a closure, an object
    holding either or a lock)."""
    try:
        ForkingPickler.dumps(build_fn)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise ValueError(
            f"prefetch_backend='process' starts its builder with spawn, so "
            f"build_fn must pickle, and {build_fn!r} does not ({e}); make "
            f"it a module-level function or callable object, or use "
            f"prefetch_backend='thread'") from e


class ProcessCohortPrefetcher:
    """Builds rounds ``[start, stop)`` in a spawned child process, handing
    cohorts to the consumer through a ring of ``depth`` shared-memory
    arena slots.

    Same consumer contract as :class:`CohortPrefetcher` — strictly in-order
    ``get(round_idx)``, builder exceptions re-raised at the next ``get`` —
    and the returned cohort owns its leaves (copied out of the arena: the
    engine fetches the next cohort while an earlier one may still be in
    flight, and ``torch.from_numpy`` would alias a slot about to be
    rewritten). ``build_fn`` must pickle; a script that uses this backend
    keeps its work under ``if __name__ == "__main__"``, since the child
    imports the parent's main module afresh. ``first`` is round
    ``start_round``'s cohort when the caller has built it already
    (``make_prefetcher``'s probe): the first ``get`` returns it and the
    child starts at the round after.
    """

    def __init__(self, build_fn: BuildFn, start_round: int, stop_round: int,
                 depth: int = 2, close_timeout: float = 5.0,
                 first: Optional[Cohort] = None):
        """Spawn the arena worker building rounds ``[start, stop)``."""
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        _require_picklable(build_fn)
        self._close_timeout = close_timeout
        self._first = first
        if first is not None:
            start_round += 1
        ctx = mp.get_context("spawn")   # never fork: the module docstring
        # the parent keeps all four connection ends open for the
        # prefetcher's lifetime, so sends never see a broken pipe and recvs
        # never EOF mid-protocol
        self._free_r, self._free_w = ctx.Pipe(duplex=False)
        self._meta_r, self._meta_w = ctx.Pipe(duplex=False)
        self._attached = {}        # shm name -> SharedMemory (parent side)
        self._closed = False
        base = f"coharena-{mp.current_process().pid}-{id(self):x}"
        for slot in range(depth):
            self._free_w.send(slot)
        self._proc = ctx.Process(
            target=_arena_worker,
            args=(build_fn, start_round, stop_round, self._free_r,
                  self._meta_w, base),
            daemon=True, name="cohort-arena")
        self._proc.start()

    def _attach(self, name: str) -> shared_memory.SharedMemory:
        shm = self._attached.get(name)
        if shm is None:
            shm = shared_memory.SharedMemory(name=name)
            self._attached[name] = shm
        return shm

    def get(self, round_idx: int) -> Cohort:
        """Blocking in-order fetch; leaves are COPIED out of the arena and
        the slot goes straight back to the child, so the ring pipelines
        at full depth."""
        if self._first is not None:
            first, self._first = self._first, None
            if first.round_idx != round_idx:
                raise RuntimeError(
                    f"prefetcher out of order: expected round {round_idx}, "
                    f"got {first.round_idx}")
            return first
        while True:
            if self._meta_r.poll(0.2):
                kind, r, payload = self._meta_r.recv()
                break
            if not self._proc.is_alive():
                if self._meta_r.poll(0):   # reported, then exited: drain it
                    continue
                raise RuntimeError(
                    "cohort-arena process died without reporting an "
                    "error (killed?)")
        if kind == "error":
            raise RuntimeError(
                f"cohort-arena build_fn failed:\n{payload}")
        if kind == "done":
            raise RuntimeError(f"prefetcher exhausted before round "
                               f"{round_idx}")
        if r != round_idx:
            raise RuntimeError(
                f"prefetcher out of order: expected round {round_idx}, "
                f"got {r}")
        slot, name, skeleton, descs = payload
        shm = self._attach(name)
        leaves = [np.ndarray(shape, dtype, buffer=shm.buf,
                             offset=off).copy()
                  for off, shape, dtype in descs]
        self._free_w.send(slot)
        return _fill_cohort(skeleton, leaves)

    def close(self):
        """Stop the child, detach, and unlink every arena segment once
        (idempotent; raises if the child outlives ``close_timeout``)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._free_w.send(None)          # poison: wake a waiting child
        except (OSError, ValueError):
            pass
        self._proc.join(timeout=self._close_timeout)
        hung = self._proc.is_alive()
        if hung:
            self._proc.terminate()
            self._proc.join(timeout=1.0)
        # collect the names of segments still in flight
        while True:
            try:
                if not self._meta_r.poll(0):
                    break
                kind, _, payload = self._meta_r.recv()
            except (EOFError, OSError):
                break
            if kind == "item":
                try:
                    self._attach(payload[1])
                except FileNotFoundError:
                    pass
        for shm in self._attached.values():
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
        self._attached = {}
        for conn in (self._free_r, self._free_w, self._meta_r, self._meta_w):
            conn.close()
        if hung:
            raise RuntimeError(
                f"cohort-arena process did not exit within "
                f"{self._close_timeout}s of close() — build_fn is likely "
                f"hung (terminated)")

    def __del__(self):
        """Best-effort cleanup for consumers that crashed before
        ``close()``."""
        try:
            self.close()
        except Exception:  # noqa: BLE001 — never raise from a finalizer
            pass

    def __enter__(self):
        """Context-manager entry: the prefetcher itself."""
        return self

    def __exit__(self, *exc):
        """Close on exit without masking the with-body's own exception."""
        close_prefetcher(self, unwinding=exc[0] is not None)
        return False


#: Prefetcher backends by ``FedConfig.prefetch_backend`` value.
PREFETCHERS = {"thread": CohortPrefetcher, "process": ProcessCohortPrefetcher}


def make_prefetcher(backend: str, build_fn: BuildFn, start_round: int,
                    stop_round: int, depth: int = 2,
                    close_timeout: float = 5.0):
    """Instantiate the prefetcher for a ``prefetch_backend`` value.

    The process backend is probed first: round ``start_round``'s cohort
    is built in the parent, and if any leaf is a ``torch.Tensor`` the call
    falls back to the thread backend with a warning (the child ships numpy
    only; the thread backend rebuilds the probe's round, as ``build_fn``
    is deterministic per round). Otherwise the probe is the process
    prefetcher's first cohort. A ``build_fn`` that does not pickle raises
    ``ValueError`` (no silent switch).
    """
    try:
        cls = PREFETCHERS[backend]
    except KeyError:
        raise ValueError(
            f"unknown prefetch_backend {backend!r}; "
            f"known: {tuple(PREFETCHERS)}") from None
    kw = dict(depth=depth, close_timeout=close_timeout)
    if cls is ProcessCohortPrefetcher and stop_round > start_round:
        probe = build_fn(start_round)
        if any(isinstance(leaf, torch.Tensor)
               for leaf in pytree.tree_leaves(probe)):
            warnings.warn(
                "prefetch_backend='process' needs numpy-leaf batch trees, "
                "but this build_fn produces torch tensors — falling back to "
                "the thread backend (set prefetch_backend='thread' to "
                "silence, or return numpy leaves from batch_fn to use the "
                "shared-memory arena)", RuntimeWarning, stacklevel=2)
            cls = CohortPrefetcher
        else:
            kw["first"] = probe
    return cls(build_fn, start_round, stop_round, **kw)


def close_prefetcher(prefetcher, unwinding: bool) -> None:
    """Close a prefetcher from a consumer's ``finally`` block.

    ``unwinding=True`` means the consumer's round loop is already
    propagating its own exception: the hung-worker ``RuntimeError`` that
    ``close()`` may raise is then demoted to a warning so it cannot mask
    the real error. On a clean exit it stays loud.
    """
    try:
        prefetcher.close()
    except RuntimeError:
        if not unwinding:
            raise
        warnings.warn(
            "cohort prefetcher did not shut down cleanly while handling a "
            "round-loop error", RuntimeWarning)
