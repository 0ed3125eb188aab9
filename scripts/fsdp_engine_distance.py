"""How far the port's FSDP ``RoundEngine`` run lands from the JAX
package's, against how far its one-process run does.

The case is ``tests/test_torch_fsdp_round.py``'s engine run: FedEP on the
smoke fedlm-100m at ``sequential`` (fp32 compute), window 2 over three
overlapping cohorts of 2 of 3 clients, the device store, the stale rounds
discounted by 0.9. The same params, zero client states, ids and tokens go
through

  * the JAX package's ``RoundEngine`` over its ``make_fed_round_split``
    stages and device store (one device);
  * the port's ``RoundEngine`` in one process (``_torch_mp.engine_run``,
    one thread, as the test's fixture runs it);
  * the port's ``RoundEngine`` under FSDP on a 1 x 2 ``("data", "model")``
    gloo group of two spawned ranks, without tensor parallelism.

For every leaf of the params and of the store's rows it prints each run's
largest difference from the JAX run, over the leaf's largest entry, and
the 1 x 2 run's from the one-process run; then the worst of each and on
how many leaves the 1 x 2 run is farther from JAX than one process.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/fsdp_engine_distance.py

How far the two port runs land from each other depends on the CPU
kernels ATen and MKL dispatch to (both runs use one thread): on an
AVX-512 host the 1 x 2 run is about 4e-8 from one process, under the
AVX2 kernels about 4e-6. Force a host's kernels with the environment,
which the spawned ranks inherit:

    ATEN_CPU_CAPABILITY=avx2 MKL_ENABLE_INSTRUCTIONS=AVX2 PYTHONPATH=src \
        JAX_PLATFORMS=cpu python scripts/fsdp_engine_distance.py
"""
import json
import os
import sys
import tempfile

import numpy as np

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "tests")


def _rank(rank: int, out_dir: str) -> None:
    """One rank of the 1 x 2 group: the engine run, written to
    ``engine.rank<r>.npz``."""
    sys.path.insert(0, TESTS)
    import _torch_mp as mpt
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.mesh import mesh_from_config

    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    kw = json.loads(str(inputs["engine_kw"]))["engine"]
    mesh = mesh_from_config(MeshConfig(shape=(1, 2),
                                       axes=("data", "model")), "cpu")
    np.savez(os.path.join(out_dir, f"engine.rank{rank}.npz"),
             **mpt.engine_run(kw, inputs, mesh))


def _jax_run(T) -> dict:
    """The JAX package's engine run: ``{params/<path>, states/<path>:
    array}``."""
    import jax
    import jax.numpy as jnp

    from repro.core.client_state import make_client_store
    from repro.core.engine import RoundEngine
    from repro.core.sharded_round import make_fed_round_split
    from repro.data.prefetch import Cohort
    from test_torch_lm_train import (JaxFedConfig, _fedlm_params,
                                     jax_configs, jax_get_algorithm,
                                     jax_get_optimizer,
                                     jax_init_server_state)

    fed = JaxFedConfig(**T.ENGINE_KW)
    alg = jax_get_algorithm(fed)
    opt = jax_get_optimizer(fed.server_opt, fed.server_lr,
                            fed.server_momentum)
    params = jax.tree_util.tree_map(jnp.asarray, _fedlm_params())
    state = jax_init_server_state(params, opt, algorithm=alg)
    cohort_fn, server_fn = make_fed_round_split(
        jax_configs.get_smoke("fedlm-100m"), fed, placement="sequential",
        compute_dtype=jnp.float32, q_chunk=8)
    ids, toks = T.ENGINE_IDS, T.ENGINE_TOKENS
    store = make_client_store("device", int(ids.max()) + 1)
    store.ensure(alg.init_client_state(params))
    engine = RoundEngine(cohort_fn=cohort_fn, server_fn=server_fn,
                         max_staleness=fed.max_staleness,
                         staleness_discount=fed.staleness_discount,
                         client_store=store, stateful=True)
    state, history = engine.run(
        state, lambda t: Cohort(t, ids[t], {"tokens": jnp.asarray(toks[t])}),
        len(ids))
    print("jax state_drops", [h["state_drops"] for h in history],
          "staleness", [h["staleness"] for h in history])
    out = {}
    for prefix, tree in (("params", state.params),
                         ("states", store.device_state()["buffers"])):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[f"{prefix}/{key}"] = np.asarray(x)
    return out


def main() -> None:
    """Run the three and print the distances."""
    sys.path.insert(0, TESTS)
    import jax
    jax.config.update("jax_enable_x64", False)
    import torch

    import _torch_mp as mpt
    import test_torch_fsdp_round as T

    with tempfile.TemporaryDirectory(prefix="fsdp_engine_distance_") as out:
        np.savez(os.path.join(out, "inputs.npz"), **T._inputs(True))
        procs = mpt.start_group(_rank, 2, (out,))
        inputs = np.load(os.path.join(out, "inputs.npz"))
        want = _jax_run(T)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        one = mpt.engine_run(T.ENGINE_KW, inputs)
        torch.set_num_threads(threads)
        mpt.join_group(procs, 300)
        two = dict(np.load(os.path.join(out, "engine.rank0.npz")))
    worst = {"one": 0.0, "1x2": 0.0, "1x2 vs one": 0.0}
    farther = 0
    for k, w in sorted(want.items()):
        scale = np.abs(w).max()
        e1 = float(np.abs(one[k] - w).max() / scale)
        e2 = float(np.abs(two[k] - w).max() / scale)
        e12 = float(np.abs(two[k] - one[k]).max() / np.abs(one[k]).max())
        print(f"{k:48s} one vs jax {e1:.3g}  1x2 vs jax {e2:.3g}  "
              f"1x2 vs one {e12:.3g}")
        worst = {"one": max(worst["one"], e1), "1x2": max(worst["1x2"], e2),
                 "1x2 vs one": max(worst["1x2 vs one"], e12)}
        farther += e2 > e1
    print("worst, over each leaf's largest entry:", worst)
    print(f"the 1 x 2 run is farther from JAX than one process on {farther} "
          f"of {len(want)} leaves")


if __name__ == "__main__":
    main()
