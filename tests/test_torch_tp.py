"""Tensor, vocabulary and expert parallelism over ``model`` without a
process group (``sharding/rules.py``, ``sharding/tensor_parallel.py``):
the plan's blocks and element counts for the smoke archs, the full
fedlm-100m, gemma3-27b and qwen3-moe-30b-a3b (and its one-layer cut), its
runs against the layout's ravel (columns, rows, vocabulary rows and expert
blocks), the rule overrides, and one block (attention, dense FFN, MoE, MoE
with a shared expert) and the whole ``lm_grad_fn`` (the vocabulary, both
MoE routes with capacity drops, the shared expert, a frontend, untied
embeddings) split into ``M`` simulated ranks (threads, whose all-reduces a
barrier sums or maxes in rank order) against the unsplit model, forward
and under ``vmap(grad)``, in fp32 to 1e-6. The process-group runs are
``tests/test_torch_fsdp_round.py``'s.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import init_params
from repro_torch.models.steps import lm_grad_fn
from repro_torch.sharding import rules, tensor_parallel
from repro_torch.sharding.rules import TPPlan, tp_plan


def _cfg(arch: str):
    """``"name"``: the full config; ``"name smoke"``: its smoke variant;
    ``"name cut"``: the full widths cut to one repeat of the pattern."""
    name, _, kind = arch.partition(" ")
    if kind == "smoke":
        return configs.get_smoke(name)
    if kind == "cut":
        return configs.replace(configs.get_config(name), repeats=1)
    return configs.get_config(name)


def _plan(arch: str, M: int) -> TPPlan:
    cfg = _cfg(arch)
    return TPPlan(cfg, init_params(None, cfg, device="meta"), M)


#: (arch, M, the blocks that split (attention, dense FFN, vocabulary,
#: experts, shared expert), d, split elements T, replicated R, elements a
#: model rank computes on R + T / M)
PLANS = [
    ("fedlm-100m smoke", 2, "afv", 1_312_256, 1_310_720, 1_536, 656_896),
    ("fedlm-100m", 2, "afv", 100_684_032, 100_663_296, 20_736,
     50_352_384),
    ("fedlm-100m", 4, "afv", 100_684_032, 100_663_296, 20_736,
     25_186_560),
    # 4 kv heads do not split over 8 or 16: attention stays replicated,
    # the FFN splits into 256- and 128-column slices, the vocabulary
    # into 4,096 and 2,048 rows
    ("fedlm-100m", 8, "fv", 100_684_032, 81_788_928, 18_895_104,
     29_118_720),
    ("fedlm-100m", 16, "fv", 100_684_032, 81_788_928, 18_895_104,
     24_006_912),
    ("gemma3-27b", 16, "afv", 27_008_335_616, 27_007_647_744, 687_872,
     1_688_665_856),
    # 4 kv heads and no dense FFN: the experts and the vocabulary split,
    # attention and the router stay replicated
    ("qwen3-moe-30b-a3b", 16, "ve", 30_220_957_696, 29_302_194_176,
     918_763_520, 2_750_150_656),
    ("qwen3-moe-30b-a3b cut", 2, "ave", 934_287_616, 934_019_072,
     268_544, 467_278_080),
]


def _flags(plan: TPPlan) -> str:
    return "".join(c for c, on in zip("afves", (
        plan.attn, plan.ffn, plan.vocab, plan.experts, plan.shared)) if on)


@pytest.mark.parametrize("arch,M,blocks,d,T,R,per", PLANS,
                         ids=[f"{p[0]}-{p[1]}" for p in PLANS])
def test_plan_blocks_and_counts(arch, M, blocks, d, T, R, per):
    plan = _plan(arch, M)
    assert _flags(plan) == blocks
    assert sum(s.size for s in plan.leaves) == d
    assert (plan.split_elements, plan.replicated_elements) == (T, R)
    assert plan.rank_elements == per == R + T // M
    if d > 10**10:
        return
    total = 0
    for g in range(M):
        st, ln = plan.runs(g)
        assert ln.sum() == per and (ln > 0).all()
        # in ravel order, disjoint, merged
        assert (st[1:] > st[:-1] + ln[:-1]).all()
        total += ln.sum()
    assert total == R * M + T


#: The leaves each block splits, by name (the rules' regexes, written out)
_SPLIT_NAMES = {"a": ("wq", "wk", "wv", "wo"),
                "f": ("w_gate", "w_up", "w_down"),
                "v": ("embed", "unembed"),
                "e": ("w_gate", "w_up", "w_down"),
                "s": ("ws_gate", "ws_up", "ws_down")}


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_smoke_plan_counts(arch):
    """Every smoke arch over 2 model ranks: which blocks split, and the
    split elements counted leaf by leaf from the blocks' leaf names (the
    MoE banks under ``moe``, the dense FFN's outside it, the mixers'
    projections of the attention layers only)."""
    cfg = _cfg(f"{arch} smoke")
    plan = _plan(f"{arch} smoke", 2)
    specs = list(cfg.pattern) + list(cfg.tail)
    want = "".join(c for c, on in zip("afves", (
        cfg.num_kv_heads % 2 == 0
        and any(s.mixer in ("attn", "swa") for s in specs),
        any(s.ffn == "dense" for s in specs),
        True,
        any(s.ffn == "moe" for s in specs),
        cfg.moe.shared_expert_d_ff > 0)) if on)
    assert _flags(plan) == want
    T = 0
    for s in plan.leaves:
        parts = rules.normalize_path(s.path).split(".")
        block = ("v" if len(parts) == 1 else
                 "e" if "moe" in parts and not parts[-1].startswith("ws")
                 else "s" if "moe" in parts else
                 "f" if parts[2] == "ffn" else "a")
        if block == "a" and plan.attn:
            spec = rules._block_spec(cfg, parts)
            split = spec.mixer in ("attn", "swa")
        else:
            split = block in want
        split = split and parts[-1] in _SPLIT_NAMES[block]
        assert (s.dim is not None) == split, s.path
        T += s.size if split else 0
    assert plan.split_elements == T
    assert plan.rank_elements == plan.replicated_elements + T // 2


def test_plan_runs_cut_the_layout_ravel():
    """Model rank g's runs, taken from the smoke params' flat ravel, are
    its compute tree's ravels in the template's leaf order: the columns
    of ``wq|wk|wv|w_gate|w_up`` and the rows of ``wo|w_down`` of its
    heads and FFN slice, its rows of ``embed``, the rest whole; every
    element belongs to some rank, the replicated ones to all."""
    cfg = _cfg("fedlm-100m smoke")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = fsdp.FlatShard(params).shard_tree(params)
    M = 2
    plan = _plan("fedlm-100m smoke", M)
    count = np.zeros(flat.numel(), np.int64)
    for g in range(M):
        tree = _compute_tree(plan, flat, g, cfg)
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
        c = cfg.padded_vocab // M
        assert torch.equal(tree["embed"],
                           params["embed"][g * c:(g + 1) * c])
        assert torch.equal(tree["final_norm"], params["final_norm"])
        st, ln = plan.runs(g)
        count[fsdp._expand(st, ln)] += 1
    assert set(np.unique(count)) == {1, M}
    assert (count == M).sum() == plan.replicated_elements


def _compute_tree(plan: TPPlan, flat: torch.Tensor, g: int, cfg):
    """Model rank g's compute tree of ``cfg``'s params from a whole flat
    ravel (by the plan's runs), in the template's structure."""
    st, ln = plan.runs(g)
    x = flat[torch.from_numpy(fsdp._expand(st, ln))]
    out, off = [], 0
    for shape in plan.local_shapes():
        k = int(np.prod(shape))
        out.append(x[off:off + k].reshape(shape))
        off += k
    template = init_params(None, cfg, device="meta")
    return torch.utils._pytree.tree_unflatten(
        out, torch.utils._pytree.tree_structure(template))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_plan_runs_cut_experts_and_shared_expert(arch):
    """The MoE leaves of model rank g's runs: its experts ``[g E/M, (g +
    1) E/M)`` of each bank on dim -3 (one run of ``E/M d f`` per leading
    index), the shared expert's columns of ``ws_gate|ws_up`` and rows of
    ``ws_down``, the router whole; the runs of 2 ranks cover the ravel,
    the replicated elements twice."""
    cfg = _cfg(f"{arch} smoke")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = fsdp.FlatShard(params).shard_tree(params)
    M = 2
    plan = _plan(f"{arch} smoke", M)
    assert plan.experts and plan.shared == bool(cfg.moe.shared_expert_d_ff)
    dims = {s.path: s.dim for s in plan.leaves}
    count = np.zeros(flat.numel(), np.int64)
    for g in range(M):
        tree = _compute_tree(plan, flat, g, cfg)
        for pos in tree["pattern"]:
            p = tree["pattern"][pos]["ffn"]["moe"]
            w = params["pattern"][pos]["ffn"]["moe"]
            c = cfg.moe.num_experts // M
            for name in ("w_gate", "w_up", "w_down"):
                assert dims[f"['pattern']['{pos}']['ffn']['moe']"
                            f"['{name}']"] == -3
                assert torch.equal(p[name], w[name][:, g * c:(g + 1) * c])
            assert torch.equal(p["router"], w["router"])
            if plan.shared:
                c = cfg.moe.shared_expert_d_ff // M
                for name in ("ws_gate", "ws_up"):
                    assert torch.equal(p[name],
                                       w[name][..., g * c:(g + 1) * c])
                assert torch.equal(p["ws_down"],
                                   w["ws_down"][..., g * c:(g + 1) * c, :])
        st, ln = plan.runs(g)
        count[fsdp._expand(st, ln)] += 1
    assert set(np.unique(count)) == {1, M}
    assert (count == M).sum() == plan.replicated_elements


def test_plan_follows_the_rules():
    """The reference's rules put "tp", "vocab" and "experts" on "model";
    an override that maps one of them to no axis keeps its blocks
    replicated (``{"tp": ()}``: the vocabulary still splits), and with all
    three there is no plan; a mesh without "model", a model extent of 1,
    or one no block divides (smoke: 2 kv heads, d_ff 512 and the
    vocabulary's 512 rows over 3) gives no plan; a logical axis on another
    mesh axis is refused."""
    cfg = _cfg("fedlm-100m smoke")
    template = init_params(None, cfg, device="meta")
    moe = _cfg("qwen3-moe-30b-a3b smoke")
    moe_template = init_params(None, moe, device="meta")

    def mesh(axes, sizes):
        return ProcessMesh(axes, sizes, 0, torch.device("cpu"))

    dm = ("data", "model")
    for name in rules.LOGICAL:
        assert rules.resolve(name, mesh(dm, (2, 2))) == ("model",)
        assert rules.resolve(name, mesh(dm, (2, 2)), {name: ()}) == ()
    assert rules.resolve("batch", mesh(dm, (2, 2))) == ("data",)
    plan = tp_plan(cfg, template, mesh(dm, (2, 2)))
    assert plan.M == 2 and _flags(plan) == "afv"
    plan = tp_plan(cfg, template, mesh(dm, (2, 2)), {"tp": ()})
    assert _flags(plan) == "v"
    assert plan.split_elements == cfg.padded_vocab * cfg.d_model
    assert _flags(tp_plan(cfg, template, mesh(dm, (2, 2)),
                          {"vocab": ()})) == "af"
    assert _flags(tp_plan(moe, moe_template, mesh(dm, (1, 2)))) == "ave"
    assert _flags(tp_plan(moe, moe_template, mesh(dm, (1, 2)),
                          {"experts": ()})) == "av"
    assert _flags(tp_plan(moe, moe_template, mesh(dm, (1, 2)),
                          {"tp": (), "vocab": ()})) == "e"
    none = {"tp": (), "vocab": (), "experts": ()}
    assert tp_plan(cfg, template, mesh(dm, (2, 2)), none) is None
    assert tp_plan(moe, moe_template, mesh(dm, (1, 2)), none) is None
    assert tp_plan(cfg, template, mesh(("data",), (4,))) is None
    assert tp_plan(cfg, template, mesh(dm, (4, 1))) is None
    assert tp_plan(cfg, template, mesh(dm, (1, 3))) is None
    assert tp_plan(cfg, template, None) is None
    for name in rules.LOGICAL:
        with pytest.raises(ValueError, match="over 'model' only"):
            tp_plan(cfg, template, mesh(dm, (2, 2)), {name: ("data",)})


class _Barrier:
    """The all-reduce of M threads standing in for a model group (the
    group is the model rank's index): each rank's tensor summed (or
    maxed) in rank order, every rank handed the result."""

    def __init__(self, M: int):
        self.M, self.wait = M, threading.Barrier(M).wait
        self.parts = [None] * M
        self.calls = [0] * M

    def all_reduce(self, group, x, op="sum"):
        self.parts[group] = x.clone()
        self.calls[group] += 1
        self.wait()
        total = self.parts[0]
        for p in self.parts[1:]:
            total = total + p if op == "sum" else torch.maximum(total, p)
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
            mg = tensor_parallel.ModelGroup.of(g, g, plan)
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


#: block -> (arch, its layer spec, the shared expert's d_ff if changed:
#: 255 does not split over 2 ranks, so only the experts do)
_BLOCKS = {
    "attn": ("fedlm-100m", LayerSpec(mixer="attn", ffn="none"), None),
    "ffn": ("fedlm-100m", LayerSpec(mixer="attn", ffn="dense"), None),
    "moe": ("qwen3-moe-30b-a3b", LayerSpec(mixer="attn", ffn="moe"), None),
    "shared": ("llama4-scout-17b-a16e", LayerSpec(mixer="attn", ffn="moe"),
               None),
    "shared-whole": ("llama4-scout-17b-a16e",
                     LayerSpec(mixer="attn", ffn="moe"), 255),
}


def _backward_reduces(block: str, plan: TPPlan) -> int:
    """The all-reduces of a block's backward: the attention's input,
    ``q_scale`` and ``k_scale``; the FFN's input; the MoE's input (the
    experts and a split shared expert read one copy) and, when the
    experts split, its one chunk's gate values."""
    return {"attn": 3, "ffn": 1}.get(block, 1 + plan.experts)


def _block(block: str, M: int):
    """One block of a smoke arch (``_BLOCKS``: the qk-norm attention with
    its residual, or the dense SwiGLU FFN, the MoE FFN, the MoE FFN with a
    shared expert, each with its) over M model ranks: ``(plan, params,
    their flat ravel, inputs x and weights w of two clients,
    layer_of(tree) -> the block's params of the two clients (the params
    and a scaled copy), apply(p, xc) -> its output, the split dim of each
    of its leaves, the config)``."""
    arch, spec, shared_ff = _BLOCKS[block]
    cfg = _cfg(f"{arch} smoke")
    if shared_ff:
        cfg = configs.replace(cfg, moe=configs.replace(
            cfg.moe, shared_expert_d_ff=shared_ff))
    plan = TPPlan(cfg, init_params(None, cfg, device="meta"), M)
    assert {"attn": plan.attn, "ffn": plan.ffn, "moe": plan.experts,
            "shared": plan.shared,
            "shared-whole": plan.experts and not plan.shared}[block]
    gen = torch.Generator().manual_seed(3)
    params = init_params(gen, cfg, device="cpu")
    # non-zero norm scales, so their gradients are not trivially shared
    params = tm.tmap(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen),
                     params)
    flat = fsdp.FlatShard(params).shard_tree(params)
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

    return plan, params, flat, x, w, layer_of, apply, dims, cfg


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
    ("ffn", 4, "full"), ("moe", 2, "full"), ("moe", 4, "none"),
    ("shared", 2, "full"), ("shared", 8, "none"),
    ("shared-whole", 2, "none")])
def test_block_split_over_simulated_ranks(block, M, remat, monkeypatch):
    """One block cut by the plan for each of M simulated model ranks,
    against the unsplit block: the output on every rank, and under
    ``vmap(grad)`` over two clients (with ``remat="full"``, through
    ``model.recompute``) the split leaves' gradients put together along
    their split dim, the replicated leaves' (the norm, ``q_scale`` /
    ``k_scale``, the router) and the input's on every rank, in fp32 to
    1e-6; the all-reduces per rank: 1 forward and 1 (FFN), 2 (MoE: the
    input, the gate values; 1 when only the shared expert splits, as
    llama4's 4 smoke experts over 8 ranks; the experts split with the
    shared expert whole, a d_ff of 255 over 2) or 3 (attention: the input,
    ``q_scale``, ``k_scale``) backward, the forward again in the
    recompute."""
    plan, params, flat, x, w, layer_of, apply, dims, cfg = _block(block, M)

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
        M, plan,
        lambda g: run(layer_of(_compute_tree(plan, flat, g, cfg)), x),
        monkeypatch)
    per = (2 if remat == "full" else 1) + _backward_reduces(block, plan)
    assert calls == [per] * M
    _check_ranks(got, want_y, want_gp, want_gx, dims)


@pytest.mark.parametrize("block", ["attn", "ffn", "moe"])
def test_recompute_replays_under_the_forwards_group(block, monkeypatch):
    """``remat="full"``'s backward run on a thread where no model group is
    active (as autograd runs a CUDA backward, on its device thread): the
    replay takes the forward's group, so each of 2 simulated ranks gets
    the unsplit block's gradients (``_check_ranks``, fp32 to 1e-6) and
    issues the same all-reduces as under ``vmap(grad)``."""
    plan, params, flat, x, w, layer_of, apply, dims, cfg = _block(block, 2)

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
        2, plan,
        lambda g: run(layer_of(_compute_tree(plan, flat, g, cfg)), x),
        monkeypatch)
    per = 2 * (2 + _backward_reduces(block, plan))
    assert calls == [per] * 2
    _check_ranks(got, want_y, want_gp, want_gx, dims)


def _moe(cfg, routing: str, capacity_factor: float):
    return configs.replace(cfg, moe=configs.replace(
        cfg.moe, routing=routing, capacity_factor=capacity_factor))


#: name -> (arch, changes to its smoke config, M). The smoke fedlm with
#: 500 of its 512 vocabulary rows in use, so the last rank's range holds
#: padded columns; qwen3-moe on both routes with capacity factor 0.5 (16
#: slots a chunk for 64 (token, expert) pairs: drops forced); llama4's
#: experts and shared expert; internvl2's frontend; untied embeddings.
WHOLE = {
    "fedlm-padded": ("fedlm-100m", dict(vocab_size=500), 2),
    "fedlm-m4": ("fedlm-100m", {}, 4),
    "qwen3-moe-onehot-drops": ("qwen3-moe-30b-a3b",
                               dict(routing="onehot", cf=0.5), 2),
    "qwen3-moe-sort-drops": ("qwen3-moe-30b-a3b",
                             dict(routing="sort", cf=0.5), 2),
    "llama4-shared": ("llama4-scout-17b-a16e", {}, 2),
    "internvl2-frontend": ("internvl2-26b", {}, 2),
    "fedlm-untied": ("fedlm-100m", dict(tie_embeddings=False), 2),
}


@pytest.mark.parametrize("name", list(WHOLE))
def test_lm_grad_fn_over_simulated_ranks(name, monkeypatch):
    """The whole ``lm_grad_fn`` (``remat="full"``) under ``vmap`` over two
    clients, each of M simulated model ranks on its compute tree, against
    the unsplit model: the losses, the split leaves' gradients put
    together along their split dim and the replicated leaves' on every
    rank, to 1e-6; the losses and every replicated leaf's gradient (the
    norms, ``q_scale`` / ``k_scale``, the router) bitwise equal on the
    ranks. The targets hit both sides of every rank's vocabulary range
    and its last valid id. The params and the compute are float64 (the
    layers' own fp32 steps, the norms, the router and the cross entropy,
    stay fp32): whole-model gradients in fp32 differ by their summation
    order alone up to 1.34e-6 of a leaf's largest entry (measured with
    AVX-512 and AVX2 kernels), in float64 up to 7.7e-7."""
    arch, change, M = WHOLE[name]
    cfg = _cfg(f"{arch} smoke")
    if "routing" in change:
        cfg = _moe(cfg, change["routing"], change["cf"])
        chunk = 2 * 16
        assert (moe_mod.capacity(cfg.moe, chunk) * cfg.moe.num_experts
                < chunk * cfg.moe.top_k)
    else:
        cfg = configs.replace(cfg, **change)
    template = init_params(None, cfg, device="meta")
    plan = TPPlan(cfg, template, M)
    assert plan.vocab and (plan.experts or not cfg.moe.enabled)
    f64 = torch.float64
    gen = torch.Generator().manual_seed(5)
    params = init_params(gen, cfg, f64, device="cpu")
    params = tm.tmap(lambda t: t + 0.1 * torch.randn(
        t.shape, generator=gen, dtype=f64), params)
    flat = fsdp.FlatShard(params).shard_tree(params, f64)
    r = np.random.default_rng(7)
    tokens = r.integers(0, cfg.vocab_size, (2, 2, 17))
    rows = cfg.padded_vocab // M
    edges = [0, cfg.vocab_size - 1] + [g * rows + e for g in range(1, M)
                                       for e in (-1, 0)]
    tokens[0, 0, 1:1 + len(edges)] = edges
    batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.frontend:
        batch["frontend"] = torch.randn(2, 2, cfg.frontend_tokens,
                                        cfg.d_model, generator=gen,
                                        dtype=f64)
    grad_fn = torch.func.vmap(lm_grad_fn(cfg, compute_dtype=f64, q_chunk=8,
                                         remat="full"))

    def stacked(tree):
        return tm.tmap(lambda t: torch.stack([t, 0.9 * t]), tree)

    want_loss, want = grad_fn(stacked(params), batch)
    got, calls = _on_ranks(
        M, plan,
        lambda g: grad_fn(stacked(_compute_tree(plan, flat, g, cfg)), batch),
        monkeypatch)
    assert len(set(calls)) == 1 and calls[0] > 0
    dims = {s.path: s.dim for s in plan.leaves}
    for loss, _ in got:
        _close(loss, want_loss)
        assert torch.equal(loss, got[0][0])
    for path, w in fsdp._paths(want):
        parts = [dict(fsdp._paths(gp))[path] for _, gp in got]
        if dims[path] is None:
            for part in parts:
                _close(part, w)
                assert torch.equal(part, parts[0]), path
        else:
            # the leaves carry the client axis in front of the split dim
            _close(torch.cat(parts, dim=dims[path]), w)
