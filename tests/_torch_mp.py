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
    server momentum, accumulator, iterate, samples, ``v_hist``). Then one
    ``algo_round`` of each algorithm of the inputs' ``algo_kw``
    (``<name>.rank<r>.npz``) and each ``engine_run`` the inputs'
    ``engine_kw`` names (``<name>.rank<r>.npz``)."""
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
    ckpt_algo = str(inputs["ckpt_algo"]) if "ckpt_algo" in inputs.files \
        else None
    for name, algo_kw in json.loads(str(inputs["algo_kw"])).items():
        ckpt = os.path.join(out_dir, "ckpt") if name == ckpt_algo else None
        np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                 **algo_round(algo_kw, inputs, mesh, ckpt))
    if "engine_kw" in inputs.files:
        for name, engine_kw in json.loads(str(inputs["engine_kw"])).items():
            np.savez(os.path.join(out_dir, f"{name}.rank{rank}.npz"),
                     **engine_run(engine_kw, inputs, mesh))


def _tree(inputs, prefix: str):
    """The tensors saved under ``prefix/`` of ``inputs``, nested by path
    (None when there are none)."""
    from repro_torch.convert import params_from_jax

    flat = {k[len(prefix) + 1:]: inputs[k] for k in inputs.files
            if k.startswith(prefix + "/")}
    return params_from_jax(nest(flat), "cpu") if flat else None


def _flat(tree, prefix: str) -> dict:
    """``{prefix/path: numpy}`` of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v.detach().cpu().numpy()
    return out


def path_key(path: str) -> str:
    """A key path such as ``['a']['b']`` -> ``a/b``."""
    return "/".join(k.strip("'") for k in path.strip("[]").split("]["))


def wire_arrays(wires: list, layout=None) -> dict:
    """Each recorded client payload of a quantizing FedLoRA round (its
    delta's and precision's wire forms, as ``payload_accum`` saw them) as
    ``{wire/<client>/<delta|prec>/<path>/<q|scale>: numpy}``: whole trees
    in one process; under ``layout`` each rank's pieces gathered into
    whole leaves (one all-gather each: call it on every rank) and the
    factors held whole as they are."""
    from torch.utils import _pytree as pytree

    from repro_torch.compression.quant import is_qleaf
    from repro_torch.core import fsdp

    out = {}
    for k, payload in enumerate(wires):
        for part in ("delta", "prec"):
            wire = payload[part]
            if layout is None:
                pairs = [(pytree.keystr(p), w) for p, w in
                         pytree.tree_flatten_with_path(
                             wire, is_leaf=is_qleaf)[0]]
            else:
                q = [torch.zeros(p.size) if w["q"].dim() > 1
                     else w["q"].to(torch.float32)
                     for p, w in zip(layout.leaf_pieces(), wire)]
                whole = dict(fsdp._paths(layout.gather_tree(layout.join(q))))
                pairs = [(p.path, {"q": w["q"] if w["q"].dim() > 1 else
                                   whole[p.path].reshape(-1),
                                   "scale": w["scale"]})
                         for p, w in zip(layout.leaf_pieces(), wire)]
            for path, w in pairs:
                key = f"wire/{k}/{part}/{path_key(path)}"
                out[f"{key}/q"] = w["q"].to(torch.float32).reshape(
                    -1).numpy()
                out[f"{key}/scale"] = w["scale"].numpy()
    return out


def algo_round(kw: dict, inputs, mesh=None, ckpt=None) -> dict:
    """One round of the FSDP test's other algorithms: the smoke fedlm-100m
    at ``sequential`` (fp32 compute) from ``inputs``' params (``p/``) and
    the algorithm's starting state (SCAFFOLD's ``c`` under ``c/``, MIME's
    server momentum under ``m/``, the clients' states under
    ``cs/<algorithm>/``), with ``tokens1``; through FSDP over ``mesh``'s
    ranks when given, else in one process. A stateful algorithm's client
    states go through the store ``kw`` places (the device store's rows
    loaded first). Returns ``{params/<path>, c/<path>, states/<path>}``
    (gathered whole), the losses, this rank's traffic (``traffic/<kind>``)
    and the elements it held (``held/<what>``: the params, ``c``, MIME's
    broadcast momentum, a client state row, the store's rows); for a
    FedLoRA codec that quantizes, each client's wire payload
    (``wire_arrays``). With
    ``ckpt`` (a directory, under FSDP with a device store) the rank writes
    the new state and store with ``save_checkpoint_fsdp`` and reads them
    back at its own W (``ckpt/bitwise``: equal by digest)."""
    from repro_torch import configs
    from repro_torch.algorithms import fedlora, get_algorithm, mime
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import collective, sharded_round
    from repro_torch.core import tree_math as tm
    from repro_torch.core.client_state import make_client_store
    from repro_torch.core.server import init_server_state
    from repro_torch.optim import get_optimizer

    cfg = configs.get_smoke("fedlm-100m")
    fed = FedConfig(**kw)
    alg = get_algorithm(fed)
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    state = init_server_state(_tree(inputs, "p"), opt, algorithm=alg)
    if fed.algorithm == "scaffold":
        state = state._replace(algo_state=_tree(inputs, "c"))
    if fed.algorithm == "mime":
        state = state._replace(opt_state={"step": 0,
                                          "m": _tree(inputs, "m")})
    layout = None if mesh is None else sharded_round.fsdp_layout(cfg, mesh)
    if layout is not None:
        state = layout.shard_state(state)
    held = {"params": tm.tree_size(state.params)}
    if fed.algorithm == "scaffold":
        held["c"] = tm.tree_size(state.algo_state)
    seen = []
    broadcast = mime.Mime.broadcast

    def probed(self, st, server_opt):
        out = broadcast(self, st, server_opt)
        seen.append(tm.tree_size(out))
        return out

    mime.Mime.broadcast = probed
    wires = []
    payload_accum = fedlora.FedLoRA.payload_accum

    def recorded(self, payload):
        wires.append(payload)
        return payload_accum(self, payload)

    if fed.algorithm == "fedlora" and "int8" in fed.payload_codec:
        fedlora.FedLoRA.payload_accum = recorded
    fn = sharded_round.make_fed_round(
        cfg, fed, placement="sequential", compute_dtype=torch.float32,
        q_chunk=8, mesh=mesh)
    ids = np.arange(fed.clients_per_round)
    args, store = (), None
    if alg.stateful:
        cstates = _tree(inputs, f"cs/{fed.algorithm}")
        if layout is not None:
            cstates = layout.shard_rows(cstates)
        held["row"] = tm.tleaves(cstates)[0][0].numel()
        args = (cstates,)
        if fed.client_state_placement == "device":
            store = make_client_store("device", ids.shape[0], device="cpu",
                                      fsdp=layout)
            store.ensure(alg.init_client_state(state.params))
            store.scatter(ids, cstates)
            args = (store.device_state(), store.prepare_ids(ids))
            held["store_rows"] = [
                (b.shape[0], b[0].numel())
                for b in tm.tleaves(store.device_state()["buffers"])]
    collective.reset_traffic()
    try:
        res = fn(state, {"tokens": inputs["tokens1"]}, None, *args)
    finally:
        mime.Mime.broadcast = broadcast
        fedlora.FedLoRA.payload_accum = payload_accum
    state, metrics = res[:2]
    if seen:
        held["momentum"] = seen[0]
    out = {f"traffic/{k}": v for k, v in collective.traffic.items()}
    out.update({f"held/{k}": np.asarray(v) for k, v in held.items()})
    out.update({k: float(v) for k, v in metrics.items()})
    out.update(wire_arrays(wires, layout))
    if ckpt is not None:
        store.set_device_state(res[2])
        tree = {"server": state, "clients": store.state_dict()}
        ckpt_io.save_checkpoint_fsdp(ckpt, tree, 1, layout)
        torch.distributed.barrier()
        back, step, _ = ckpt_io.restore_checkpoint_fsdp(ckpt, tree, None,
                                                        layout)
        out["ckpt/bitwise"] = step == 1 and torch.equal(
            collective.digest(back), collective.digest(tree))
    if layout is not None:
        state = layout.gather_state(state)
    out.update(_flat(state.params, "params"))
    if fed.algorithm == "scaffold":
        out.update(_flat(state.algo_state, "c"))
    if alg.stateful:
        new = res[2]["buffers"] if store is not None else res[2]
        if layout is not None:
            new = layout.gather_rows(new)
        out.update(_flat(new, "states"))
    return out


def engine_run(kw: dict, inputs, mesh=None) -> dict:
    """The FSDP test's ``RoundEngine`` run: ``kw``'s stateful algorithm
    (FedEP, FedLoRA with error feedback) on the device store for
    ``inputs["engine_ids"]`` cohorts at
    window ``kw["max_staleness"] + 1`` (the stale rounds discounted), from
    ``inputs``' params and zero states, the tokens ``engine_tokens``;
    through FSDP over ``mesh``'s ranks when given. Returns the gathered
    params (``params/<path>``), the store's rows gathered
    (``states/<path>``), each record's ``state_drops`` and
    ``staleness``, and for a quantizing FedLoRA each cohort's clients'
    wire payloads in dispatch order (``wire_arrays``)."""
    from repro_torch import configs
    from repro_torch.algorithms import fedlora, get_algorithm
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import sharded_round
    from repro_torch.core.client_state import make_client_store
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.server import init_server_state
    from repro_torch.data.prefetch import Cohort
    from repro_torch.optim import get_optimizer

    cfg = configs.get_smoke("fedlm-100m")
    fed = FedConfig(**kw)
    alg = get_algorithm(fed)
    opt = get_optimizer(fed.server_opt, fed.server_lr, fed.server_momentum)
    state = init_server_state(_tree(inputs, "p"), opt, algorithm=alg)
    layout = None if mesh is None else sharded_round.fsdp_layout(cfg, mesh)
    if layout is not None:
        state = layout.shard_state(state)
    cohort_fn, server_fn = sharded_round.make_fed_round_split(
        cfg, fed, placement="sequential", compute_dtype=torch.float32,
        q_chunk=8, mesh=mesh)
    ids, toks = inputs["engine_ids"], inputs["engine_tokens"]
    store = make_client_store("device", int(ids.max()) + 1, device="cpu",
                              fsdp=layout)
    store.ensure(alg.init_client_state(state.params))
    engine = RoundEngine(cohort_fn, server_fn,
                         max_staleness=fed.max_staleness,
                         staleness_discount=fed.staleness_discount,
                         client_store=store, stateful=True)
    wires = []
    payload_accum = fedlora.FedLoRA.payload_accum

    def recorded(self, payload):
        wires.append(payload)
        return payload_accum(self, payload)

    if fed.algorithm == "fedlora" and "int8" in fed.payload_codec:
        fedlora.FedLoRA.payload_accum = recorded
    try:
        state, history = engine.run(
            state, lambda t: Cohort(t, ids[t], {"tokens": toks[t]}),
            len(ids))
    finally:
        fedlora.FedLoRA.payload_accum = payload_accum
    if layout is not None:
        state = layout.gather_state(state)
    rows = store.device_state()["buffers"]
    if layout is not None:
        rows = layout.gather_rows(rows)
    out = {"state_drops": np.array([h["state_drops"] for h in history]),
           "staleness": np.array([h["staleness"] for h in history])}
    out.update(wire_arrays(wires, layout))
    out.update(_flat(state.params, "params"))
    out.update(_flat(rows, "states"))
    return out
