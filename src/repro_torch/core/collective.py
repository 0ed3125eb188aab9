"""The rank-level collectives of a population-sharded round, as plain
functions on tensors that take the mesh (``launch.mesh.ProcessMesh``).

  * ``recv_tree`` / ``hand_on`` — the rank-ordered sum of a cohort split
    over ranks: the rank that runs shard ``s`` of the cohort receives the
    accumulator of shards ``0 .. s - 1`` from the rank before it, folds
    its own rows onto it (``round_program``) and hands it on; the last
    rank broadcasts the sum. Every rank ends with bitwise the same
    aggregate, summed in the one-process order (each client folded in
    cohort order), and each rank sends the accumulator's bytes once;
  * ``all_gather_rows`` — per-client rows (metrics, counts) of every rank,
    concatenated in rank order;
  * ``exchange_rows`` — an all-to-all of store rows with uneven splits,
    which moves each rank exactly the rows it asked for;
  * ``replicas_equal`` / ``check_replicas`` — a digest of a tree (the
    server state) on every rank, compared across ranks;
  * ``all_gather_flat`` / ``reduce_scatter_flat`` / ``all_reduce_small``
    — the FSDP round's collectives (``core/fsdp.py``): every rank's flat
    shard gathered into the whole vector, a whole vector summed over the
    ranks with each rank keeping its shard of the sum, and a small tensor
    (the DP's dot products, the losses) summed over the ranks;
  * ``all_reduce_codec`` — a payload codec's partials over the ranks of an
    FSDP round: the ``lowrank`` factors of a client's leaves summed, the
    ``int8`` maxima of its leaves' pieces maxed;
  * ``exchange_flat`` — the tensor-parallel FSDP round's params gather and
    gradient reduce (``core/fsdp.py``): one all-to-all with uneven splits
    that moves each rank exactly the elements it computes on (and back);
  * ``all_reduce_model`` — an activation (or its gradient) summed over the
    model ranks of a data slot (``sharding/tensor_parallel.py``), or
    maxed (the vocabulary-parallel cross entropy's shift).

A mesh without a group (one process) makes each of them the identity; a
group of one rank still runs its collective, so a one-rank NCCL group
exercises the NCCL calls. gloo's CUDA forms cover only some collectives,
so on a gloo group every collective on CUDA tensors is staged here
through pinned host memory: the tensor is copied to the host, the
collective runs on the CPU and the result is copied back. This is the
path a caller asks for by naming gloo for CUDA tensors (two ranks sharing
one card), not a fallback: NCCL groups run on the device tensors.

``traffic`` counts, for this rank, its collective calls (``calls``), the
bytes it sent to other ranks as store rows (``rows``), as the accumulator
(``accumulator``), as gathered rows and digests (``gathered``), as its
params shard (``params``: ``(W - 1) n`` elements per all-gather of an
``n``-element shard over W ranks), as gradients (``grads``: a
reduce-scatter of ``W n`` elements sends ``(W - 1) n``; gloo has none, so
its route all-reduces the whole vector, which a ring does by sending ``2
(W - 1) n``) and as small sums (``small``: ``(W - 1)`` times the
tensor's bytes), as codec partials (``codec``: ``(W - 1)`` times the
tensor's bytes, as ``small``), as activations summed over a model group
(``activations``: ``(M - 1)`` times the tensor's bytes), the bytes staged
between device and host (``staged``), the host seconds spent inside these
functions (``seconds``: on gloo every call blocks until its data has
moved; NCCL calls return once queued), the calls of the FSDP kinds
(``param_gathers``, ``grad_reduces``, ``small_reduces``,
``codec_reduces``, ``activation_reduces``), and the elements this rank
received in its params gathers (``param_elements``: ``W n`` an all-gather,
its compute elements an exchange, its own included) and sent in its
gradient reduces (``grad_elements``: ``W n``, or the compute elements it
returns: all of them from model index 0, the split leaves' from the
other model ranks);
``sent_bytes()`` sums the kinds sent.
"""
from __future__ import annotations

import functools
import math
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import tree_math as tm

#: This rank's collective calls, bytes sent to other ranks by kind, and
#: bytes staged through the host.
traffic = {"calls": 0, "rows": 0, "accumulator": 0, "gathered": 0,
           "params": 0, "grads": 0, "small": 0, "codec": 0,
           "activations": 0, "staged": 0, "seconds": 0.0,
           "param_gathers": 0, "grad_reduces": 0, "small_reduces": 0,
           "codec_reduces": 0, "activation_reduces": 0,
           "param_elements": 0, "grad_elements": 0}

#: The kinds of bytes sent to other ranks.
SENT_KINDS = ("rows", "accumulator", "gathered", "params", "grads", "small",
              "codec", "activations")

#: A Mersenne prime: the modulus of the digest's terms.
_P = 2**31 - 1


def reset_traffic() -> None:
    """Zero ``traffic``."""
    traffic.update(dict.fromkeys(traffic, 0))


def sent_bytes() -> int:
    """The bytes this rank has sent to other ranks, of every kind."""
    return sum(traffic[k] for k in SENT_KINDS)


def _timed(fn):
    """Add the host seconds of each call of ``fn`` to ``traffic``."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            traffic["seconds"] += time.perf_counter() - t0

    return timed


def _staged(mesh, x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` goes through pinned host memory."""
    return x.is_cuda and mesh.backend == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    traffic["staged"] += x.numel() * x.element_size()
    return h


def _from_host(h: torch.Tensor, device) -> torch.Tensor:
    traffic["staged"] += h.numel() * h.element_size()
    return h.to(device)


def _gather(mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on each), in rank order, on ``x``'s
    device."""
    x = x.contiguous()
    staged = _staged(mesh, x)
    src = _to_host(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    traffic["calls"] += 1
    traffic["gathered"] += (mesh.size - 1) * x.numel() * x.element_size()
    return [_from_host(p, x.device) for p in parts] if staged else parts


@_timed
def recv_tree(mesh, like, src: int):
    """A tree shaped like ``like`` received from rank ``src`` (``like``'s
    leaves are the receive buffers, on their device)."""
    def recv(x):
        if _staged(mesh, x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            dist.recv(h, src, group=mesh.group)
            traffic["calls"] += 1
            return _from_host(h, x.device)
        dist.recv(x, src, group=mesh.group)
        traffic["calls"] += 1
        return x

    return tm.tmap(recv, like)


@_timed
def hand_on(mesh, tree, dst: Optional[int], root: int):
    """Send ``tree`` to rank ``dst`` (none when None), then broadcast rank
    ``root``'s tree to every rank; returns it. ``tree`` itself without a
    group."""
    if mesh is None or mesh.group is None:
        return tree

    def send(x):
        x = x.contiguous()
        dist.send(_to_host(x) if _staged(mesh, x) else x, dst,
                  group=mesh.group)
        traffic["calls"] += 1
        traffic["accumulator"] += x.numel() * x.element_size()

    def bcast(x):
        x = x.contiguous()
        staged = _staged(mesh, x)
        buf = _to_host(x) if staged and mesh.rank == root else (
            torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if staged
            else x)
        dist.broadcast(buf, root, group=mesh.group)
        traffic["calls"] += 1
        if mesh.rank == root:
            traffic["accumulator"] += ((mesh.size - 1) * x.numel()
                                       * x.element_size())
        return _from_host(buf, x.device) if staged else buf

    if dst is not None:
        tm.tmap(send, tree)
    return tm.tmap(bcast, tree)


@_timed
def all_gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``(n, ...)`` rows concatenated in rank order (each
    rank gives the same ``n``); ``x`` itself without a group."""
    if mesh is None or mesh.group is None:
        return x
    return torch.cat(_gather(mesh, x))


@_timed
def exchange_rows(mesh, rows: torch.Tensor, send_counts: Sequence[int],
                  recv_counts: Sequence[int]) -> torch.Tensor:
    """All-to-all of ``rows``: its first ``send_counts[0]`` rows go to rank
    0, the next ``send_counts[1]`` to rank 1, ...; returns the rows
    received, ``recv_counts[p]`` from rank ``p`` in rank order."""
    send_counts, recv_counts = list(send_counts), list(recv_counts)
    if mesh is None or mesh.group is None:
        if send_counts != recv_counts:
            raise ValueError(f"one rank sends {send_counts} rows to itself "
                             f"but expects {recv_counts}")
        return rows
    row_bytes = rows.element_size() * math.prod(rows.shape[1:])
    traffic["rows"] += row_bytes * (sum(send_counts)
                                    - send_counts[mesh.rank])
    return _all_to_all(mesh, rows, send_counts, recv_counts)


def _all_to_all(mesh, x: torch.Tensor, send_counts: list,
                recv_counts: list) -> torch.Tensor:
    """``dist.all_to_all_single`` of ``x``'s rows with uneven splits on
    ``x``'s device, counted as one call. Staged through pinned host memory
    on gloo with CUDA, where only the rows to and from the other ranks
    cross the host: this rank's own rows are copied on the device."""
    x = x.contiguous()
    out = torch.empty((sum(recv_counts),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    traffic["calls"] += 1
    if not _staged(mesh, x):
        dist.all_to_all_single(out, x, output_split_sizes=recv_counts,
                               input_split_sizes=send_counts,
                               group=mesh.group)
        return out
    r = mesh.rank
    s0, r0 = sum(send_counts[:r]), sum(recv_counts[:r])
    s1, r1 = s0 + send_counts[r], r0 + recv_counts[r]
    src = _to_host(torch.cat([x[:s0], x[s1:]]))
    got = torch.empty((out.shape[0] - (r1 - r0),) + tuple(x.shape[1:]),
                      dtype=x.dtype, pin_memory=True)
    dist.all_to_all_single(
        got, src, output_split_sizes=recv_counts[:r] + [0]
        + recv_counts[r + 1:], input_split_sizes=send_counts[:r] + [0]
        + send_counts[r + 1:], group=mesh.group)
    got = _from_host(got, x.device)
    out[:r0], out[r0:r1], out[r1:] = got[:r0], x[s0:s1], got[r0:]
    return out


def digest(tree) -> torch.Tensor:
    """An int64 digest per leaf of ``tree``: the leaf's raw bits, each
    element weighted by its position, summed modulo ``2**31 - 1`` (on the
    leaf's device; a Python number becomes a one-element leaf)."""
    views = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for leaf in tm.tleaves(tree):
        t = torch.as_tensor(leaf).detach().reshape(-1)
        bits = t.view(views[t.element_size()]).to(torch.int64)
        w = torch.arange(1, t.numel() + 1, device=t.device,
                         dtype=torch.int64) % 65521 + 1
        out.append(torch.remainder(torch.remainder(bits, _P) * w, _P)
                   .sum().remainder(_P).reshape(1).to("cpu"))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)


@_timed
def replicas_equal(mesh, tree) -> bool:
    """Whether every rank holds bitwise the same ``tree`` (by
    :func:`digest`); True without a group."""
    if mesh is None or mesh.group is None:
        return True
    d = digest(tree)
    if mesh.backend == "nccl":
        d = d.to(mesh.device)
    parts = _gather(mesh, d)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def check_replicas(mesh, tree, what: str = "server state") -> None:
    """Raise ``RuntimeError`` unless :func:`replicas_equal`."""
    if not replicas_equal(mesh, tree):
        raise RuntimeError(f"the ranks' {what} differ (replica digests "
                           f"disagree)")


@_timed
def all_gather_flat(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``x`` (``n`` elements on each) concatenated in rank
    order: ``(W n,)`` on ``x``'s device, in its dtype; ``x`` itself
    without a group. NCCL gathers into one tensor on the device; gloo
    into the chunks of one host tensor (staged for CUDA)."""
    if mesh is None or mesh.group is None:
        return x
    x = x.contiguous().reshape(-1)
    W = mesh.size
    if mesh.backend == "nccl":
        out = torch.empty(W * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
    else:
        staged = _staged(mesh, x)
        src = _to_host(x) if staged else x
        out = torch.empty(W * x.numel(), dtype=x.dtype, device=src.device,
                          pin_memory=staged)
        dist.all_gather(list(out.chunk(W)), src, group=mesh.group)
        if staged:
            out = _from_host(out, x.device)
    traffic["calls"] += 1
    traffic["param_gathers"] += 1
    traffic["param_elements"] += W * x.numel()
    traffic["params"] += (W - 1) * x.numel() * x.element_size()
    return out


@_timed
def reduce_scatter_flat(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the sum over ranks of the 1-D ``x`` (``W n``
    elements on each): the ``n`` elements ``[r n, (r + 1) n)`` of the sum
    on rank ``r``, on ``x``'s device; ``x`` itself without a group. NCCL
    reduce-scatters on the device; gloo all-reduces ``x`` in place (on the
    host, staged for CUDA) and keeps the slice. ``x`` may be
    overwritten."""
    if mesh is None or mesh.group is None:
        return x
    x = x.reshape(-1)
    W = mesh.size
    if x.numel() % W:
        raise ValueError(f"a vector of {x.numel()} elements does not split "
                         f"over {W} ranks")
    n = x.numel() // W
    lo = mesh.rank * n
    if mesh.backend == "nccl":
        out = torch.empty(n, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=mesh.group)
        traffic["grads"] += (W - 1) * n * x.element_size()
    else:
        staged = _staged(mesh, x)
        buf = _to_host(x) if staged else x.contiguous()
        dist.all_reduce(buf, group=mesh.group)
        out = (_from_host(buf[lo:lo + n], x.device) if staged
               else buf[lo:lo + n].clone())
        traffic["grads"] += 2 * (W - 1) * n * x.element_size()
    traffic["calls"] += 1
    traffic["grad_reduces"] += 1
    traffic["grad_elements"] += W * n
    return out


def _all_reduce(mesh, x: torch.Tensor, op, kind: str) -> torch.Tensor:
    """``x`` reduced with ``op`` over the ranks, as a new tensor on
    ``x``'s device (``x`` itself without a group), counted as ``kind``."""
    if mesh is None or mesh.group is None:
        return x
    staged = _staged(mesh, x)
    buf = _to_host(x.contiguous()) if staged else x.clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    traffic["calls"] += 1
    traffic[f"{kind}_reduces"] += 1
    traffic[kind] += (mesh.size - 1) * x.numel() * x.element_size()
    return _from_host(buf, x.device) if staged else buf


@_timed
def all_reduce_small(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x`` (a few values: the DP's dot products,
    the losses), as a new tensor on ``x``'s device; ``x`` itself without
    a group."""
    return _all_reduce(mesh, x, dist.ReduceOp.SUM, "small")


@_timed
def all_reduce_codec(mesh, x: torch.Tensor, op: str) -> torch.Tensor:
    """The sum (``op="sum"``) or elementwise max (``"max"``) over ranks of
    a codec's partials ``x``, as a new tensor on ``x``'s device; ``x``
    itself without a group."""
    return _all_reduce(mesh, x, {"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op], "codec")


@_timed
def exchange_flat(mesh, x: torch.Tensor, send_counts: Sequence[int],
                  recv_counts: Sequence[int], kind: str) -> torch.Tensor:
    """All-to-all of the 1-D ``x``: its first ``send_counts[0]`` elements
    go to rank 0, the next ``send_counts[1]`` to rank 1, ...; returns the
    elements received, ``recv_counts[p]`` from rank ``p`` in rank order,
    in ``x``'s dtype on its device. ``kind`` is ``"params"`` (a gather:
    counted in ``param_gathers`` and ``param_elements``, the elements
    received) or ``"grads"`` (a reduce: ``grad_reduces`` and
    ``grad_elements``, the elements sent); the bytes to other ranks go to
    ``kind``. Staged through pinned host memory on gloo with CUDA; ``x``
    itself without a group."""
    send_counts, recv_counts = list(send_counts), list(recv_counts)
    x = x.reshape(-1)
    if mesh is None or mesh.group is None:
        if send_counts != recv_counts:
            raise ValueError(f"one rank sends {send_counts} elements to "
                             f"itself but expects {recv_counts}")
        return x
    out = _all_to_all(mesh, x, send_counts, recv_counts)
    traffic[kind] += x.element_size() * (sum(send_counts)
                                         - send_counts[mesh.rank])
    if kind == "params":
        traffic["param_gathers"] += 1
        traffic["param_elements"] += sum(recv_counts)
    else:
        traffic["grad_reduces"] += 1
        traffic["grad_elements"] += sum(send_counts)
    return out


@_timed
def all_reduce_model(group, x: torch.Tensor, op: str = "sum"
                     ) -> torch.Tensor:
    """The sum (``op="sum"``) or elementwise max (``"max"``) of ``x`` over
    the ranks of a model ``group`` (an activation, or its gradient), as a
    new tensor on ``x``'s device, in its dtype; staged through pinned host
    memory on gloo with CUDA."""
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    buf = (_to_host(x.contiguous()) if staged
           else x.clone(memory_format=torch.contiguous_format))
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    traffic["calls"] += 1
    traffic["activation_reduces"] += 1
    traffic["activations"] += ((dist.get_world_size(group) - 1) * x.numel()
                               * x.element_size())
    return _from_host(buf, x.device) if staged else buf
