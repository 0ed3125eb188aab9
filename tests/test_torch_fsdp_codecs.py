"""FedLoRA's payload codecs and the checkpoints of the FSDP flat layout
(``core/fsdp.py``, ``compression``, ``checkpoint/io.py``) over simulated
ranks, with no process group.

A simulated group is W threads, one ``FlatShard`` each on a mesh of W
ranks without a group; ``collective.all_reduce_codec`` is replaced by a
barrier that sums or maxes every thread's tensor, as the ranks of a real
group would. The tree's cuts fall mid-row of its matrix leaves at W = 3
and 4 (checked), and its leaves are in another order than JAX's sorted
one, so the sketch's leaf index is exercised too.

* Sharded ``int8`` and ``int16`` put back together equal the whole-tree
  codec bit for bit (the scale is a max, which is exact); with the
  ``lowrank`` sketch the factors, the decoded payload and the projected
  precision equal it within fp32 reassociation (the column sums of a cut
  row are split over the ranks), and ``lowrank+int8``'s codes equal the
  whole-tree quantizer's on the same factors bit for bit. Garbage in the
  padding past d changes nothing.
* Checkpoints: a state and the rows of a store written by simulated ranks
  restore into another W (bitwise equal to the layout's cut of the whole
  tree), into the other store placement, and an incomplete set or a
  layout of another d or template is refused.
"""
import threading

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.compression import build_codec
from repro_torch.compression.quant import is_qleaf
from repro_torch.configs.base import FedConfig
from repro_torch.core import collective, fsdp
from repro_torch.core import tree_math as tm
from repro_torch.core.client_state import make_client_store
from repro_torch.core.server import init_server_state
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.optim import get_optimizer

#: The codec specs: (payload_codec, quant_bits)
CODECS = {"lowrank": ("lowrank", 8), "int8": ("int8", 8),
          "int16": ("int8", 16), "lowrank+int8": ("lowrank+int8", 8)}
RANK, ROUND, C = 2, 3, 2


def _template():
    """Leaves of 120, 7, 54 and 6 elements (d = 187); every matrix's last
    dim is over the sketch's rank 2."""
    return {"w": torch.zeros(3, 4, 10, device="meta"),
            "b": torch.zeros(7, device="meta"),
            "m": {"k": torch.zeros(6, 9, device="meta"),
                  "s": torch.zeros(2, 3, device="meta")}}


def _draw(seed: int, lead=(), positive=False):
    g = torch.Generator().manual_seed(seed)
    return tm.tmap(lambda t: (torch.rand(*lead, *t.shape, generator=g) + 0.5
                              if positive else
                              torch.randn(*lead, *t.shape, generator=g)),
                   _template())


def _layouts(W: int):
    return [fsdp.FlatShard(_template(), ProcessMesh(("data",), (W,), r,
                                                    torch.device("cpu")))
            for r in range(W)]


def _on_ranks(layouts, fn, monkeypatch):
    """``fn(layout)`` on a thread per simulated rank, the codec's
    all-reduces summed or maxed over the threads; the results in rank
    order."""
    W = len(layouts)
    slots, out, errors = [None] * W, [None] * W, []
    barrier = threading.Barrier(W)

    def all_reduce(mesh, x, op):
        slots[mesh.rank] = x.clone()
        barrier.wait()
        xs = torch.stack(slots)
        total = xs.sum(0) if op == "sum" else xs.amax(0)
        barrier.wait()
        return total

    def run(k):
        try:
            out[k] = fn(layouts[k])
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            errors.append(e)
            barrier.abort()

    monkeypatch.setattr(collective, "all_reduce_codec", all_reduce)
    threads = [threading.Thread(target=run, args=(k,)) for k in range(W)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _fed(codec: str) -> FedConfig:
    spec, bits = CODECS[codec]
    return FedConfig(algorithm="fedlora", payload_codec=spec,
                     quant_bits=bits, lora_rank=RANK, clients_per_round=C)


def _whole(layouts, parts: list, lead: int):
    """Every rank's parts of one payload (``parts[r]``, in ``leaf_pieces``
    order, ``lead`` leading axes) -> the whole tree, shaped like the
    template: a piece's leaf concatenated over the ranks, a part held
    whole on every rank (a factor, or its codes) taken from rank 0; a
    quantized part ``{"q", "scale"}`` likewise, its scale rank 0's."""
    out = []
    for i, p in enumerate(layouts[0].leaf_pieces()):
        xs = [parts[r][i] for r in range(len(layouts))]
        q = [x["q"] if is_qleaf(x) else x for x in xs]
        if q[0].dim() == lead + 1:
            q = torch.cat(q, dim=-1).reshape(*q[0].shape[:-1], *p.shape)
        else:
            q = q[0]
        out.append({"q": q, "scale": xs[0]["scale"]} if is_qleaf(xs[0])
                   else q)
    return pytree.tree_unflatten(out, pytree.tree_structure(_template()))


def _assert_trees(got, want, exact: bool, what: str) -> None:
    for (path, g), w in zip(pytree.tree_flatten_with_path(got)[0],
                            pytree.tree_leaves(want)):
        msg = f"{what} {pytree.keystr(path)}"
        if exact:
            assert g.dtype == w.dtype and torch.equal(g, w), msg
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{msg}: {m}")


def _unstacked(tree):
    return tm.tmap(lambda x: x[0], tree)


@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_sharded_codec_equals_whole_tree(codec, W, monkeypatch):
    """Two clients' delta and precision through the codec on W simulated
    ranks, put back together, against the whole-tree codec. ``int8`` /
    ``int16``: the codes, the scales (the same on every rank), the
    decoded payload and the decoded accumulator bit for bit. With the
    sketch: the factors and the projected precision within fp32
    reassociation of the whole tree's; the decoded payload and
    accumulator within it of the whole-tree decode of the ranks' wire;
    and ``lowrank+int8``'s codes and scales bit for bit the whole-tree
    quantizer's on the ranks' factors."""
    fed = _fed(codec)
    spec, bits = CODECS[codec]
    whole = build_codec(fed)
    quant = build_codec(FedConfig(algorithm="fedlora", payload_codec="int8",
                                  quant_bits=bits)) if "int8" in spec \
        else None
    sketch = build_codec(FedConfig(algorithm="fedlora",
                                   payload_codec="lowrank",
                                   lora_rank=RANK)) if "lowrank" in spec \
        else None
    like = tm.tmap(lambda t: torch.zeros(t.shape), _template())
    delta, prec = _draw(1, (C,)), _draw(2, (C,), positive=True)
    layouts = _layouts(W)

    def rank(lay):
        chain = build_codec(fed)
        x, p = lay.shard_rows(delta), lay.shard_rows(prec)
        wire, pwire = chain.encode_payload(x, p, ROUND, None, lay)
        return dict(
            wire=wire, pwire=pwire,
            proj=chain.project_precision(p, ROUND, None, lay),
            factors=(sketch.encode(x, ROUND, None, lay) if sketch
                     else lay.split(x)),
            dec=chain.decode(wire, ROUND, None, lay),
            acc=chain.decode_accum(_unstacked(chain.to_accum(wire)), ROUND,
                                   None, lay))

    out = _on_ranks(layouts, rank, monkeypatch)
    got = {k: _whole(layouts, [o[k] for o in out], 1)
           for k in ("wire", "pwire", "proj", "factors")}
    exact = sketch is None
    if sketch is not None:
        _assert_trees(got["factors"], sketch.encode(delta, ROUND, like),
                      False, "factors")
        _assert_trees(got["proj"], whole.project_precision(prec, ROUND,
                                                           like),
                      False, "projected precision")
    if quant is not None:
        for k, pre in (("wire", got["factors"]), ("pwire", got["proj"])):
            want = quant.encode(pre, ROUND, _unstacked(pre))
            _assert_trees(got[k], want, True, k)
            for o in out:     # every rank holds the same scales
                assert all(torch.equal(a["scale"], b["scale"])
                           for a, b in zip(o[k], out[0][k]))
    if quant is None:
        _assert_trees(got["wire"], whole.encode(delta, ROUND, like), False,
                      "wire")
        _assert_trees(got["pwire"], got["proj"], True, "precision wire")
    if exact:
        _assert_trees(got["wire"], whole.encode(delta, ROUND, like), True,
                      "wire")
    one = fsdp.FlatShard(_template())
    for k, lead, want in (
            ("dec", 1, whole.decode(got["wire"], ROUND, like)),
            ("acc", 0, whole.decode_accum(_unstacked(whole.to_accum(
                got["wire"])), ROUND, like))):
        flat = torch.cat([o[k] for o in out], dim=-1)[..., :one.d]
        want = one._pack(want, 0, one.d, lead, flat.dtype)
        _assert_trees([flat], [want], exact, k)


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_sharded_codec_ignores_padding(codec, monkeypatch):
    """Garbage past d on the last of 3 ranks (187 = 3 x 63 - 2) changes
    no wire form and no decoded element."""
    fed = _fed(codec)
    delta, prec = _draw(3, (C,)), _draw(4, (C,), positive=True)
    layouts = _layouts(3)
    assert layouts[-1].real == layouts[-1].n - 2

    def rank(lay, garbage):
        x, p = lay.shard_rows(delta), lay.shard_rows(prec)
        if garbage and lay.real < lay.n:
            x[..., lay.real:] = 1e30
            p[..., lay.real:] = -7.0
        chain = build_codec(fed)
        wire, pwire = chain.encode_payload(x, p, ROUND, None, lay)
        dec = chain.decode(wire, ROUND, None, lay)
        return tm.tleaves((wire, pwire)), dec[..., :lay.real]

    clean = _on_ranks(layouts, lambda lay: rank(lay, False), monkeypatch)
    dirty = _on_ranks(layouts, lambda lay: rank(lay, True), monkeypatch)
    for (cw, cd), (dw, dd) in zip(clean, dirty):
        assert len(cw) == len(dw)
        for a, b in zip(cw, dw):
            assert torch.equal(a, b)
        assert torch.equal(cd, dd)


# -- checkpoints of the flat layout --------------------------------------------

N_CLIENTS = 3


def _server_state(offset: int = 0):
    """A whole server state of the template: params, SGD-momentum state
    and a params-shaped ``algo_state``, round 4."""
    state = init_server_state(_draw(5 + offset), get_optimizer("sgdm", 0.1))
    return state._replace(opt_state={"step": 4, "m": _draw(6)},
                          algo_state=_draw(7), round=4)


def _rows():
    """Whole FedEP-like rows of ``N_CLIENTS`` clients, and their stamps."""
    return ({"num": _draw(8, (N_CLIENTS,)),
             "den": _draw(9, (N_CLIENTS,), positive=True)},
            np.array([1, 2, 0], np.int64))


def _ckpt_tree(layout, placement: str, state=None, rows=None):
    """``{"server", "clients"}`` in ``layout``: ``state``'s shards (zeros
    when None) and a ``placement`` store made for the layout holding
    ``rows``' (zeros when None); returns the tree and the store."""
    state = layout.shard_state(state if state is not None else tm.tmap(
        lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0,
        _server_state()))
    store = make_client_store(placement, N_CLIENTS, device="cpu",
                              fsdp=layout)
    store.ensure({"num": state.params, "den": state.params})
    if rows is not None:
        buffers, stamps = rows
        store.load_state_dict({"buffers": layout.shard_rows(buffers),
                               "stamps": stamps})
    return {"server": state, "clients": store.state_dict()}, store


def _write(path: str, W: int, placement: str, step: int, ranks=None,
           state_of=None):
    for lay in _layouts(W):
        if ranks is None or lay.rank in ranks:
            state = (state_of or (lambda r: _server_state()))(lay.rank)
            tree, _ = _ckpt_tree(lay, placement, state, _rows())
            ckpt_io.save_checkpoint_fsdp(path, tree, step, lay)


@pytest.mark.parametrize("W_from,W_to,src,dst", [
    (3, 3, "host", "device"), (3, 2, "device", "host"),
    (2, 5, "host", "host"), (4, 1, "device", "device")])
def test_fsdp_checkpoint_reshards(tmp_path, W_from, W_to, src, dst):
    """A state and a store's rows written by ``W_from`` simulated ranks
    restore into each of ``W_to`` ranks bitwise equal to that layout's cut
    of the whole (the round and the step too), into either store; at W =
    1 the params gather into the whole tree."""
    _write(str(tmp_path), W_from, src, 7)
    assert ckpt_io.latest_fsdp_checkpoint(str(tmp_path)) == 7
    whole, (rows, stamps) = _server_state(), _rows()
    for lay in _layouts(W_to):
        like, store = _ckpt_tree(lay, dst)
        tree, step, _ = ckpt_io.restore_checkpoint_fsdp(str(tmp_path), like,
                                                        None, lay)
        want = lay.shard_state(whole)
        got = tree["server"]
        assert step == 7 and got.round == 4 and got.opt_state["step"] == 4
        for a, b in ((got.params, want.params), (got.algo_state,
                                                 want.algo_state),
                     (got.opt_state["m"], want.opt_state["m"])):
            assert torch.equal(a, b) and fsdp.in_flat_layout(a)
        store.load_state_dict(tree["clients"])
        back = store.state_dict()
        assert back["stamps"].tolist() == stamps.tolist()
        for key, x in lay.shard_rows(rows).items():
            np.testing.assert_array_equal(back["buffers"][key], x.numpy())
        if W_to == 1:
            for (path, a), (_, b) in zip(
                    fsdp._paths(lay.gather_state(got).params),
                    fsdp._paths(whole.params)):
                assert torch.equal(a, b), path


def test_fsdp_checkpoint_skips_an_incomplete_set(tmp_path):
    """Step 5 has the files of 2 of its 3 ranks: the latest complete step
    is 2, and step 5 is refused."""
    _write(str(tmp_path), 3, "device", 2)
    _write(str(tmp_path), 3, "device", 5, ranks=(0, 1))
    assert ckpt_io.latest_fsdp_checkpoint(str(tmp_path)) == 2
    lay = _layouts(2)[0]
    like, _ = _ckpt_tree(lay, "device")
    assert ckpt_io.restore_checkpoint_fsdp(str(tmp_path), like, None,
                                           lay)[1] == 2
    with pytest.raises(FileNotFoundError, match="ranks"):
        ckpt_io.restore_checkpoint_fsdp(str(tmp_path), like, 5, lay)


@pytest.mark.parametrize("change", ["d", "path"])
def test_fsdp_checkpoint_refuses_another_layout(tmp_path, change):
    """A layout whose d or leaf paths differ from the set's raises
    ``ValueError``."""
    _write(str(tmp_path), 2, "host", 1)
    template = _template()
    if change == "d":
        template["b"] = torch.zeros(8, device="meta")
    else:
        template["c"] = template.pop("b")
    lay = fsdp.FlatShard(template)
    with pytest.raises(ValueError, match="d =" if change == "d"
                       else "template"):
        ckpt_io.restore_checkpoint_fsdp(str(tmp_path), {}, 1, lay)


def test_fsdp_checkpoint_scalars_must_agree(tmp_path):
    """A leaf held whole (the round) that differs between the ranks'
    files is refused when the files are put together."""
    _write(str(tmp_path), 2, "host", 1,
           state_of=lambda r: _server_state()._replace(round=4 + r))
    lay = _layouts(3)[0]
    like, _ = _ckpt_tree(lay, "host")
    with pytest.raises(ValueError, match="differs"):
        ckpt_io.restore_checkpoint_fsdp(str(tmp_path), like, 1, lay)
