"""Multi-process helpers of the port's tests: a gloo group of spawned
ranks on the CPU, and the least-squares problem of the population-sharding
matrix (``tests/_population_sharding_script.py``'s), in torch only.

Each rank is a child started with ``multiprocessing``'s ``spawn`` (a fresh
interpreter: never ``fork``, whose child would inherit the parent's
threads and JAX's runtime), joins the group within ``CONNECT_S`` seconds,
runs its target and writes what it found under an output directory; the
parent joins every child within a deadline and fails, killing the rest,
when one does not exit 0. This module imports torch and the port, never
JAX, so a child never loads it.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import socket
import traceback

import numpy as np
import torch

#: Seconds a rank waits for the group (and each collective for its peers).
CONNECT_S = 30.0

N, D, C, ROUNDS = 10, 3, 4, 4


def free_port() -> int:
    """A free TCP port on the loopback interface (bind to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, target, args) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=CONNECT_S))
    try:
        target(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        torch.distributed.destroy_process_group()


def start_group(target, world: int, args=()):
    """Start ``target(rank, *args)`` on each rank of a ``world``-rank gloo
    group of spawned children; returns the children for ``join_group``."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, target, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_group(procs, timeout: float = 45.0) -> None:
    """Join the children of ``start_group``; raises unless every child
    exits 0 within ``timeout`` seconds (the stragglers are killed)."""
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            p.join(max(left, 0.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise RuntimeError(f"ranks exited with {codes} "
                           f"({len(alive)} killed at the deadline)")


def run_group(target, world: int, args=(), timeout: float = 45.0) -> None:
    """Run ``target(rank, *args)`` on each rank of a ``world``-rank gloo
    group of spawned children; raises unless every child exits 0 within
    ``timeout`` seconds (the stragglers are killed)."""
    join_group(start_group(target, world, args), timeout)


# -- the population-sharding matrix's problem --------------------------------

def lsq_problem():
    """``(grad_fn, batch_fn)`` of the matrix: ``make_federated_lsq(10, 50,
    3, heterogeneity=20.0, seed=0)``, batches of 10 per step."""
    from repro_torch.data.synthetic_lsq import lsq_batches, make_federated_lsq

    _, data = make_federated_lsq(N, 50, D, heterogeneity=20.0, seed=0)

    def batch_fn(cid, r, steps):
        X, y = data[cid]
        return lsq_batches(X, y, 10, steps, seed=r * 131 + cid)

    def loss(p, batch):
        r = batch["x"] @ p - batch["y"]
        return 0.5 * (r * r).mean() * 50

    grad_and_value = torch.func.grad_and_value(loss)

    def grad_fn(p, batch):
        g, value = grad_and_value(p, batch)
        return value, g

    return grad_fn, batch_fn


#: The matrix's algorithms (the reference script's settings; the cohorts
#: are built on a thread, which changes no number).
BASE = {
    "scaffold": dict(algorithm="scaffold", clients_per_round=C,
                     local_steps=6, server_opt="sgd", server_lr=0.1,
                     client_opt="sgd", client_lr=0.01,
                     client_state_placement="device",
                     prefetch_backend="thread"),
    "fedep": dict(algorithm="fedep", clients_per_round=C, local_steps=6,
                  burn_in_steps=4, steps_per_sample=2, shrinkage_rho=0.5,
                  burn_in_rounds=2, fedep_damping=0.7, server_opt="sgd",
                  server_lr=0.1, client_opt="sgd", client_lr=0.01,
                  client_state_placement="device",
                  prefetch_backend="thread"),
}
PLACEMENTS = (("parallel", 0), ("sequential", 0), ("chunked", 3))
MODES = {"sync": {}, "async0": dict(async_rounds=True, max_staleness=0,
                                    prefetch_rounds=2)}
#: The aggregation cases run on two ranks: mid-round dropouts (two
#: cohorts lose clients) and q-FFL.
EXTRA = {"fedep dropout": ("fedep", dict(dropout_rate=0.4)),
         "scaffold qffl": ("scaffold", dict(qffl_q=1.0))}


def matrix():
    """``{name: FedConfig kwargs}`` of the 12 parity cases."""
    return {f"{alg} {place} {mode}": dict(
                base, round_placement=place, round_chunk_size=chunk, **over)
            for alg, base in BASE.items()
            for place, chunk in PLACEMENTS
            for mode, over in MODES.items()}


def extra_cases():
    """``{name: FedConfig kwargs}`` of the two-rank aggregation cases."""
    return {name: dict(BASE[alg], **over)
            for name, (alg, over) in EXTRA.items()}


def run_case(kw: dict, mesh=None):
    """One ``FedSim`` run of the matrix on the CPU: ``(sim, state)``."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core.round import FedSim

    grad_fn, batch_fn = lsq_problem()
    sim = FedSim(FedConfig(**kw), grad_fn, batch_fn, N, device="cpu",
                 mesh=mesh)
    state, _ = sim.run(torch.zeros(D), ROUNDS)
    return sim, state


def rank_cases(rank: int, out_dir: str, cases: dict) -> None:
    """A rank's share of the cases: each one through ``FedSim(mesh=)``;
    writes ``<out_dir>/<i>.rank<r>.npz`` with the final params, the rank's
    local store rows and offset, its raw stamps (padding included) and
    its store's buffer bytes."""
    from repro_torch.core import tree_math as tm
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh("cpu")
    for i, kw in enumerate(cases.values()):
        sim, state = run_case(kw, mesh)
        store = sim.client_store
        local, offset = store.local_state_dict()
        dev = store.device_state()
        np.savez(os.path.join(out_dir, f"{i}.rank{rank}.npz"),
                 params=state.params.numpy(), offset=offset,
                 stamps=local["stamps"],
                 raw_stamps=dev["stamps"].numpy(),
                 store_bytes=sum(b.numel() * b.element_size()
                                 for b in tm.tleaves(dev["buffers"])),
                 row_bytes=sum(b[0].numel() * b.element_size()
                               for b in tm.tleaves(dev["buffers"])),
                 **{f"buf_{j}": v for j, v in
                    enumerate(tm.tleaves(local["buffers"]))})


# -- the FSDP round's cases ---------------------------------------------------

def nest(flat: dict) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}`` (a params tree saved by
    path)."""
    out: dict = {}
    for path, x in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def fsdp_rank(rank: int, out_dir: str, shape: tuple) -> None:
    """A rank of the FSDP test (``tests/test_torch_fsdp_round.py``): the
    smoke fedlm-100m on a ``("data", "model")`` mesh of ``shape``, a
    FedAvg burn-in round then a FedPA round (fp32 compute), with batch and
    with streaming DP, from ``out_dir/inputs.npz`` (numpy params by path,
    the tokens of both rounds, the ``FedConfig`` kwargs). Writes
    ``<out_dir>/<dp>.rank<r>.npz``: the gathered params after each round
    (``r<i>/<path>``), the losses, this rank's traffic in each round, and
    the element counts of every parameter-shaped tensor it held (master,
    server momentum, accumulator, iterate, samples, ``v_hist``)."""
    import json

    from repro_torch import configs
    from repro_torch.algorithms import base, fedpa
    from repro_torch.configs.base import FedConfig, MeshConfig
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.core import collective, fsdp, sharded_round
    from repro_torch.core import tree_math as tm
    from repro_torch.core.server import init_server_state
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import mesh_from_config
    from repro_torch.optim import get_optimizer

    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    params = nest({k[2:]: inputs[k] for k in inputs.files
                   if k.startswith("p/")})
    kw = json.loads(str(inputs["round_kw"]))
    mesh = mesh_from_config(MeshConfig(shape=tuple(shape),
                                       axes=("data", "model")), "cpu")
    cfg = configs.get_smoke("fedlm-100m")
    held = {k: set() for k in ("accumulator", "iterate", "samples",
                               "v_hist")}

    def probe(key, fn, shape_of):
        def wrapped(*a, **k):
            held[key].add(shape_of(*a))
            return fn(*a, **k)
        return wrapped

    # every tensor shape the round hands to these is recorded
    base.FedAlgorithm.accumulate = probe(
        "accumulator", base.FedAlgorithm.accumulate,
        lambda self, acc, *_: tm.tree_size(acc))
    wrap_grad = fsdp.FlatShard.wrap_grad

    def probed_wrap_grad(self, grad_fn):
        step = wrap_grad(self, grad_fn)

        def probed(shard, batch):
            held["iterate"].add(shard.numel())
            return step(shard, batch)

        return probed

    fsdp.FlatShard.wrap_grad = probed_wrap_grad
    fedpa.dp_delta = probe("samples", fedpa.dp_delta,
                           lambda x0, samples, *_: samples[0, 0].numel())
    ops.dp_step_sharded = probe("v_hist", ops.dp_step_sharded,
                                lambda u, delta, V, *_: V[0, 0].numel())
    for dp in ("batch", "streaming"):
        fed = FedConfig(**kw, streaming_dp=dp == "streaming")
        opt = get_optimizer(fed.server_opt, fed.server_lr,
                            fed.server_momentum)
        layout = sharded_round.fsdp_layout(cfg, mesh)
        state = layout.shard_state(init_server_state(
            lm_params_from_jax(params, "cpu"), opt))
        out = {"n": layout.n, "d": layout.d}
        for r, use_sampling in enumerate((False, True)):
            fn = sharded_round.make_fed_round(
                cfg, fed, placement="sequential", compute_dtype=torch.float32,
                q_chunk=8, use_sampling=use_sampling, mesh=mesh)
            collective.reset_traffic()
            state, metrics = fn(state, {"tokens": inputs[f"tokens{r}"]})
            for k, v in collective.traffic.items():
                out[f"r{r}/traffic/{k}"] = v
            for k, v in metrics.items():
                out[f"r{r}/{k}"] = float(v)
            out[f"r{r}/master"] = state.params.numel()
            out[f"r{r}/momentum"] = state.opt_state["m"].numel()
            for path, leaf in fsdp._paths(layout.gather_state(state).params):
                out[f"r{r}/{path}"] = leaf.numpy()
        for k, v in held.items():
            out[f"held/{k}"] = np.array(sorted(v))
        np.savez(os.path.join(out_dir, f"{dp}.rank{rank}.npz"), **out)
