"""Tensor parallelism over ``model`` without a process group
(``sharding/rules.py``, ``sharding/tensor_parallel.py``): the plan's
blocks and element counts for the smoke and the full fedlm-100m (and
gemma3-27b at M = 16), its runs against the layout's ravel, the rule
override, and one attention block and one FFN block split into ``M``
simulated ranks (threads, whose all-reduces a barrier sums in rank order)
against the unsplit block, forward and under ``vmap(grad)``, in fp32 to
1e-6. The process-group runs are ``tests/test_torch_fsdp_round.py``'s.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import LayerSpec
from repro_torch.core import collective, fsdp
from repro_torch.core import tree_math as tm
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import model as model_lib
from repro_torch.models.model import init_params
from repro_torch.sharding import rules, tensor_parallel
from repro_torch.sharding.rules import TPPlan, tp_plan


def _cfg(arch: str):
    name, _, smoke = arch.partition(" ")
    return configs.get_smoke(name) if smoke else configs.get_config(name)


def _plan(arch: str, M: int) -> TPPlan:
    cfg = _cfg(arch)
    return TPPlan(cfg, init_params(None, cfg, device="meta"), M)


#: (arch, M, attention splits, FFN splits, d, split elements T, replicated
#: R, elements a model rank computes on R + T / M)
PLANS = [
    ("fedlm-100m smoke", 2, True, True, 1_312_256, 1_179_648, 132_608,
     722_432),
    ("fedlm-100m", 2, True, True, 100_684_032, 75_497_472, 25_186_560,
     62_935_296),
    ("fedlm-100m", 4, True, True, 100_684_032, 75_497_472, 25_186_560,
     44_060_928),
    # 4 kv heads do not split over 8 or 16: attention stays replicated,
    # the FFN splits into 256- and 128-column slices
    ("fedlm-100m", 8, False, True, 100_684_032, 56_623_104, 44_060_928,
     51_138_816),
    ("fedlm-100m", 16, False, True, 100_684_032, 56_623_104, 44_060_928,
     47_599_872),
    ("gemma3-27b", 16, True, True, 27_008_335_616, 25_598_361_600,
     1_409_974_016, 3_009_871_616),
]


@pytest.mark.parametrize("arch,M,attn,ffn,d,T,R,per", PLANS)
def test_plan_blocks_and_counts(arch, M, attn, ffn, d, T, R, per):
    plan = _plan(arch, M)
    assert (plan.attn, plan.ffn) == (attn, ffn)
    assert sum(s.size for s in plan.leaves) == d
    assert (plan.split_elements, plan.replicated_elements) == (T, R)
    assert plan.rank_elements == per == R + T // M
    if arch == "gemma3-27b":
        return
    total = 0
    for g in range(M):
        st, ln = plan.runs(g)
        assert ln.sum() == per and (ln > 0).all()
        # in ravel order, disjoint, merged
        assert (st[1:] > st[:-1] + ln[:-1]).all()
        total += ln.sum()
    assert total == R * M + T


def test_plan_runs_cut_the_layout_ravel():
    """Model rank g's runs, taken from the smoke params' flat ravel, are
    its compute tree's ravels in the template's leaf order: the columns
    of ``wq|wk|wv|w_gate|w_up`` and the rows of ``wo|w_down`` of its
    heads and FFN slice, the rest whole; every element belongs to some
    rank, the replicated ones to all."""
    cfg = _cfg("fedlm-100m smoke")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = fsdp.FlatShard(params).shard_tree(params)
    M = 2
    plan = _plan("fedlm-100m smoke", M)
    count = np.zeros(flat.numel(), np.int64)
    for g in range(M):
        tree = _compute_tree(plan, flat, g)
        p, w = tree["pattern"]["pos_1"], params["pattern"]["pos_1"]
        for name in ("wq", "wk", "wv"):
            c = w["mixer"][name].shape[-1] // M
            assert torch.equal(p["mixer"][name],
                               w["mixer"][name][..., g * c:(g + 1) * c])
        c = w["mixer"]["wo"].shape[-2] // M
        assert torch.equal(p["mixer"]["wo"],
                           w["mixer"]["wo"][..., g * c:(g + 1) * c, :])
        for name in ("w_gate", "w_up"):
            c = cfg.d_ff // M
            assert torch.equal(p["ffn"][name],
                               w["ffn"][name][..., g * c:(g + 1) * c])
        assert torch.equal(p["ffn"]["w_down"],
                           w["ffn"]["w_down"][..., g * c:(g + 1) * c, :])
        for name in ("q_scale", "k_scale"):
            assert torch.equal(p["mixer"][name], w["mixer"][name])
        assert torch.equal(tree["embed"], params["embed"])
        st, ln = plan.runs(g)
        count[fsdp._expand(st, ln)] += 1
    assert set(np.unique(count)) == {1, M}
    assert (count == M).sum() == plan.replicated_elements


def _compute_tree(plan: TPPlan, flat: torch.Tensor, g: int):
    """Model rank g's compute tree from a whole flat ravel (by the plan's
    runs), in the template's structure."""
    st, ln = plan.runs(g)
    x = flat[torch.from_numpy(fsdp._expand(st, ln))]
    out, off = [], 0
    for shape in plan.local_shapes():
        k = int(np.prod(shape))
        out.append(x[off:off + k].reshape(shape))
        off += k
    template = init_params(None, _cfg("fedlm-100m smoke"), device="meta")
    return torch.utils._pytree.tree_unflatten(
        out, torch.utils._pytree.tree_structure(template))


def test_plan_follows_the_rules():
    """The reference's rules put "tp" on "model"; the override ``{"tp":
    ()}`` maps it to no axis; a mesh without "model", a model extent of
    1, or one no block divides (smoke: 2 kv heads, d_ff 512 over 3) gives
    no plan; "tp" on another axis is refused."""
    cfg = _cfg("fedlm-100m smoke")
    template = init_params(None, cfg, device="meta")

    def mesh(axes, sizes):
        return ProcessMesh(axes, sizes, 0, torch.device("cpu"))

    dm = ("data", "model")
    assert rules.resolve("tp", mesh(dm, (2, 2))) == ("model",)
    assert rules.resolve("tp", mesh(dm, (2, 2)), {"tp": ()}) == ()
    assert rules.resolve("batch", mesh(dm, (2, 2))) == ("data",)
    plan = tp_plan(cfg, template, mesh(dm, (2, 2)))
    assert plan.M == 2 and plan.attn and plan.ffn
    assert tp_plan(cfg, template, mesh(dm, (2, 2)), {"tp": ()}) is None
    assert tp_plan(cfg, template, mesh(("data",), (4,))) is None
    assert tp_plan(cfg, template, mesh(dm, (4, 1))) is None
    assert tp_plan(cfg, template, mesh(dm, (1, 3))) is None
    assert tp_plan(cfg, template, None) is None
    with pytest.raises(ValueError, match="over 'model' only"):
        tp_plan(cfg, template, mesh(dm, (2, 2)), {"tp": ("data",)})


class _Barrier:
    """The all-reduce of M threads standing in for a model group (the
    group is the model rank's index): each rank's tensor summed in rank
    order, every rank handed the sum."""

    def __init__(self, M: int):
        self.M, self.wait = M, threading.Barrier(M).wait
        self.parts = [None] * M
        self.calls = [0] * M

    def all_reduce(self, group, x):
        self.parts[group] = x.clone()
        self.calls[group] += 1
        self.wait()
        total = self.parts[0]
        for p in self.parts[1:]:
            total = total + p
        self.wait()
        return total


def _on_ranks(M: int, plan: TPPlan, fn, monkeypatch):
    """``fn(g)`` on M threads, each under model rank g's ``ModelGroup``;
    returns ``([results], all-reduces per rank)``."""
    bar = _Barrier(M)
    monkeypatch.setattr(collective, "all_reduce_model", bar.all_reduce)
    out, errors = [None] * M, []

    def run(g):
        try:
            mg = tensor_parallel.ModelGroup(g, M, g, plan.attn, plan.ffn)
            with tensor_parallel.model_parallel(mg):
                out[g] = fn(g)
        except BaseException as e:      # noqa: BLE001 - reraised below
            errors.append(e)
            bar.wait.__self__.abort()

    threads = [threading.Thread(target=run, args=(g,)) for g in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    return out, bar.calls


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * max(1.0, want.abs().max().item()))


def _block(block: str, M: int):
    """One block of the smoke fedlm-100m (qk-norm attention with its
    residual, or the dense SwiGLU FFN with its) over M model ranks: ``(plan,
    params, their flat ravel, inputs x and weights w of two clients, layer_of(tree) ->
    the block's params of the two clients (the params and a scaled copy),
    apply(p, xc) -> its output, the split dim of each of its leaves)``."""
    cfg = _cfg("fedlm-100m smoke")
    plan = _plan("fedlm-100m smoke", M)
    assert plan.ffn and (plan.attn or block == "ffn")
    gen = torch.Generator().manual_seed(3)
    params = init_params(gen, cfg, device="cpu")
    # non-zero norm scales, so their gradients are not trivially shared
    params = tm.tmap(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen),
                     params)
    flat = fsdp.FlatShard(params).shard_tree(params)
    spec = LayerSpec(mixer="attn", ffn="none") if block == "attn" else \
        LayerSpec(mixer="attn", ffn="dense")
    x = torch.randn(2, 2, 8, cfg.d_model, generator=gen)
    w = torch.randn(2, 2, 8, cfg.d_model, generator=gen)
    prefix = "['pattern']['pos_0']"
    dims = {s.path[len(prefix):]: s.dim for s in plan.leaves
            if s.path.startswith(prefix)}

    def layer_of(tree):
        p = model_lib._unit(tree["pattern"], 0)["pos_0"]
        p = ({"norm": p["norm"], "mixer": p["mixer"]} if block == "attn"
             else {"ffn": p["ffn"]})
        return tm.tmap(lambda t: torch.stack([t, 0.9 * t]), p)

    def apply(p, xc):
        if block == "attn":
            return model_lib._apply_layer(dict(p, ffn={}), xc, cfg, spec, 4,
                                          False)[0]
        return model_lib._ffn(p, xc, cfg, spec)[0]

    return plan, params, flat, x, w, layer_of, apply, dims


def _check_ranks(got, want_y, want_gp, want_gx, dims):
    """Every rank's output and input gradient against the unsplit block's;
    the split leaves' gradients put together along their split dim, the
    replicated leaves' on every rank."""
    for y, (_, gx) in got:
        _close(y, want_y)
        _close(gx, want_gx)
    for path, want in fsdp._paths(want_gp):
        dim = dims[path]
        parts = [dict(fsdp._paths(gp))[path] for _, (gp, _) in got]
        if dim is None:
            for part in parts:
                _close(part, want)
        else:
            _close(torch.cat(parts, dim=dim), want)


@pytest.mark.parametrize("block,M,remat", [
    ("attn", 2, "none"), ("attn", 2, "full"), ("ffn", 2, "none"),
    ("ffn", 4, "full")])
def test_block_split_over_simulated_ranks(block, M, remat, monkeypatch):
    """One block cut by the plan for each of M simulated model ranks,
    against the unsplit block: the output on every rank, and under
    ``vmap(grad)`` over two clients (with ``remat="full"``, through
    ``model.recompute``) the split leaves' gradients put together along
    their split dim, the replicated leaves' (the norm, ``q_scale`` /
    ``k_scale``) and the input's on every rank, in fp32 to 1e-6; the
    all-reduces per rank: 1 forward and 1 (FFN) or 3 (attention: the
    input, ``q_scale``, ``k_scale``) backward, the forward again in the
    recompute."""
    plan, params, flat, x, w, layer_of, apply, dims = _block(block, M)

    def run(p, xs):
        def loss(p, xc, wc):
            if remat == "full":
                y = model_lib.recompute(lambda p, xc: (apply(p, xc),),
                                        p, xc)[0]
            else:
                y = apply(p, xc)
            return (y * wc).sum(), y

        grads, y = torch.func.vmap(torch.func.grad(
            loss, argnums=(0, 1), has_aux=True))(p, xs, w)
        return y, grads

    want_y, (want_gp, want_gx) = run(layer_of(params), x)
    got, calls = _on_ranks(
        M, plan, lambda g: run(layer_of(_compute_tree(plan, flat, g)), x),
        monkeypatch)
    per = (2 if remat == "full" else 1) + (3 if block == "attn" else 1)
    assert calls == [per] * M
    _check_ranks(got, want_y, want_gp, want_gx, dims)


@pytest.mark.parametrize("block", ["attn", "ffn"])
def test_recompute_replays_under_the_forwards_group(block, monkeypatch):
    """``remat="full"``'s backward run on a thread where no model group is
    active (as autograd runs a CUDA backward, on its device thread): the
    replay takes the forward's group, so each of 2 simulated ranks gets
    the unsplit block's gradients (``_check_ranks``, fp32 to 1e-6) and
    issues the same all-reduces as under ``vmap(grad)``."""
    plan, params, flat, x, w, layer_of, apply, dims = _block(block, 2)

    def run(p, xs):
        p = tm.tmap(lambda t: t.detach().requires_grad_(), p)
        xs = xs.detach().requires_grad_()
        ys, loss = [], 0
        for c in range(xs.shape[0]):
            pc = tm.tmap(lambda t: t[c], p)
            y = model_lib.recompute(lambda p, xc: (apply(p, xc),), pc,
                                    xs[c])[0]
            ys.append(y.detach())
            loss = loss + (y * w[c]).sum()
        leaves, spec = torch.utils._pytree.tree_flatten(p)
        out = []
        worker = threading.Thread(target=lambda: out.append(
            torch.autograd.grad(loss, [*leaves, xs])))
        worker.start()
        worker.join(60)
        *gp, gx = out[0]
        return torch.stack(ys), (torch.utils._pytree.tree_unflatten(
            gp, spec), gx)

    def want(p, xs):
        def loss(p, xc, wc):
            y = apply(p, xc)
            return (y * wc).sum(), y

        grads, y = torch.func.vmap(torch.func.grad(
            loss, argnums=(0, 1), has_aux=True))(p, xs, w)
        return y, grads

    want_y, (want_gp, want_gx) = want(layer_of(params), x)
    got, calls = _on_ranks(
        2, plan, lambda g: run(layer_of(_compute_tree(plan, flat, g)), x),
        monkeypatch)
    per = 2 * (2 + (3 if block == "attn" else 1))
    assert calls == [per] * 2
    _check_ranks(got, want_y, want_gp, want_gx, dims)
