"""The port's payload codecs (``compression/``) on the CPU, each against
the JAX package on the same numpy inputs.

* Threefry (``compression/threefry.py``): keys, ``fold_in``, bits,
  uniforms, normals and ``erf_inv`` equal ``jax.random``'s and XLA's bit
  for bit; the low-rank basis within 1e-6 of ``LowRankCodec._basis`` (the
  two QRs round apart).
* Codecs, one client's tree and a stack of clients whose scales differ by
  10^3: encodes, decodes and projected precisions to 1e-5 relative;
  int8/int16 ``q`` equal except where ``x / scale`` lies within 1e-5 of a
  half quantum, every such flip counted (``record_property("flips")``) and
  at most one. Three places where a line-by-line port goes wrong each
  have a case: a 1-D leaf longer than the rank in a stack (eligibility
  from one client's shape), the per-client int8 scale, and leaves numbered
  in JAX's flatten order (dict keys sorted; the port keeps insertion
  order), down to the LM tree.
* ``parse_codec`` and ``register_codec``. FedLoRA through the engine is
  ``test_torch_fedlora.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import build_codec as jax_build_codec
from repro.compression import codec_names as jax_codec_names
from repro.configs.base import FedConfig as JaxFedConfig
from repro_torch import configs
from repro_torch.checkpoint import leaves_with_paths
from repro_torch.compression import (build_codec, codec_names, parse_codec,
                                     register_codec, threefry)
from repro_torch.compression.lowrank import host_basis
from repro_torch.compression.quant import QuantCodec
from repro_torch.configs.base import FedConfig
from repro_torch.convert import lm_params_from_jax, params_to_numpy
from repro_torch.core import tree_math as tm
from repro_torch.models.model import init_params


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _ulps(a, b) -> np.ndarray:
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


# ---------------------------------------------------------------------------
# Threefry and the basis
# ---------------------------------------------------------------------------

FOLDS = [(0, 0), (0, 5), (3, 12), (123456, 7)]


@pytest.mark.parametrize("shape", [(1,), (7, 3), (768, 4), (2048, 4)])
def test_threefry_bits_and_uniforms_equal_jax(shape):
    root = jax.random.PRNGKey(0x10A4)
    assert np.array_equal(np.asarray(root), threefry.prng_key(0x10A4))
    for r, leaf in FOLDS:
        jkey = jax.random.fold_in(jax.random.fold_in(root, r), leaf)
        key = threefry.fold_in(threefry.fold_in(threefry.prng_key(0x10A4),
                                                r), leaf)
        assert np.array_equal(np.asarray(jkey), key)
        assert np.array_equal(np.asarray(jax.random.bits(jkey, shape)),
                              threefry.random_bits(key, shape))
        assert np.array_equal(np.asarray(jax.random.uniform(jkey, shape)),
                              threefry.uniform(key, shape))


@pytest.mark.parametrize("shape", [(1,), (7, 3), (768, 4), (2048, 4),
                                   (2048, 256)])
def test_threefry_normals_equal_jax(shape):
    for r, leaf in FOLDS:
        key = threefry.fold_in(threefry.fold_in(threefry.prng_key(0x10A4),
                                                r), leaf)
        want = np.asarray(jax.random.normal(jnp.asarray(key), shape,
                                            jnp.float32))
        assert _ulps(threefry.normal(key, shape), want).max() == 0


def test_erfinv_and_log1p_equal_xla():
    """Both branches of ``log1p`` (``|x| < sqrt(2) - 1`` and beyond) and of
    ``erf_inv`` (``w < 5`` and beyond), edges included."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = threefry.uniform(threefry.prng_key(5), (400_000,), lo, 1.0)
    u = np.concatenate([u, np.float32([0.0, -0.0, 0.5, -0.999, 0.9999,
                                       lo, -lo])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    assert _ulps(threefry.erfinv(u), want).max() == 0
    x = -u * u
    assert _ulps(threefry._log1p(x),
                 np.asarray(jnp.log1p(jnp.asarray(x)))).max() == 0
    assert np.array_equal(threefry.erfinv(np.float32([-1.0, 1.0])),
                          [-np.inf, np.inf])


@pytest.mark.parametrize("last_dim,rank", [(6, 2), (64, 4), (256, 4),
                                           (768, 4), (2048, 4)])
def test_basis_within_1e6_of_jax(last_dim, rank):
    jcodec = jax_build_codec(JaxFedConfig(
        algorithm="fedlora", payload_codec="lowrank", lora_rank=rank))
    codec = build_codec(FedConfig(algorithm="fedlora",
                                  payload_codec="lowrank", lora_rank=rank))
    (stage,) = codec.stages
    for r, leaf in FOLDS:
        want = np.asarray(jcodec.stages[0]._basis(last_dim, r, leaf))
        got = host_basis(last_dim, rank, r, leaf)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert torch.equal(stage._basis(last_dim, r, leaf, "cpu"), got)
        np.testing.assert_allclose(got.T @ got, np.eye(rank), atol=1e-6)


# ---------------------------------------------------------------------------
# Codecs against the JAX codecs
# ---------------------------------------------------------------------------

#: fedlora knobs, as ``tests/test_compression.py``
LORA_KW = dict(local_steps=6, burn_in_steps=2, steps_per_sample=2,
               shrinkage_rho=0.5, server_opt="sgd", server_lr=0.1,
               client_opt="sgd", client_lr=0.01)


def _kw(codec, **over):
    base = dict(algorithm="fedlora", payload_codec=codec, lora_rank=2,
                clients_per_round=3, **LORA_KW)
    base.update(over)
    return base


def _stack(seed=0, C=3):
    """A stack of C clients' mixed trees, keys not in sorted order: a
    sketched matrix ``w`` (12, 6), a 1-D ``b`` (6,) longer than the rank, a
    matrix ``v`` whose last dim is the rank (passes), a 3-D ``k``
    (sketched on its last dim); client c scaled by 10^(3c / (C - 1))."""
    rng = np.random.RandomState(seed)
    scale = np.logspace(0, 3, C).astype(np.float32)
    shapes = {"w": (12, 6), "b": (6,), "v": (5, 2), "k": (2, 3, 8)}
    return {k: (rng.randn(C, *s) * scale.reshape(-1, *([1] * len(s))))
            .astype(np.float32) for k, s in shapes.items()}


def _client(tree, c):
    return {k: v[c] for k, v in tree.items()}


def _t(tree):
    return tm.tmap(torch.from_numpy, tree)


def _flat(tree):
    return {p: np.asarray(x) for p, x in leaves_with_paths(tree)}


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def count_flips(got_q, want_q, x, scale) -> int:
    """``q`` against the JAX package's: equal except where ``x / scale``
    (JAX's values) lies within 1e-5 of a half quantum, there off by at most
    one; returns how many flipped."""
    t = np.asarray(x, np.float32) / np.float32(scale)
    near = np.abs(np.abs(t - np.round(t)) - 0.5) <= 1e-5
    diff = np.asarray(got_q) != np.asarray(want_q)
    assert not (diff & ~near).any(), "q differs away from a half quantum"
    assert np.abs(np.asarray(got_q, np.int64) - want_q).max() <= 1
    return int(diff.sum())


SPECS = [("none", 8), ("int8", 8), ("int8", 16), ("lowrank", 8),
         ("lowrank+int8", 8)]


@pytest.mark.parametrize("stacked", [True, False], ids=["stack", "client"])
@pytest.mark.parametrize("spec,bits", SPECS)
def test_codec_matches_jax(spec, bits, stacked, record_property):
    """Encode, decode and the projected precision of each client against
    the JAX codec on that client's tree."""
    kw = _kw(spec, quant_bits=bits)
    codec, jcodec = build_codec(FedConfig(**kw)), jax_build_codec(
        JaxFedConfig(**kw))
    x = _stack()
    prec = tm.tmap(lambda a: np.abs(a) + 0.5, _stack(seed=1))
    like = _t(_client(x, 0))
    rnd = 3
    if stacked:
        wire = [codec.encode(_t(x), rnd, like)]
        pwire = [codec.encode_aux(codec.project_precision(_t(prec), rnd,
                                                          like), rnd, like)]
    else:
        wire = [codec.encode(_t(_client(x, c)), rnd) for c in range(3)]
        pwire = [codec.encode_aux(codec.project_precision(
            _t(_client(prec, c)), rnd), rnd) for c in range(3)]
    flips = 0
    for c in range(3):
        row = (lambda t, c=c: tm.tmap(lambda a: a[c], t)) if stacked \
            else (lambda t: t)
        i = 0 if stacked else c
        for got, src, enc in ((wire[i], x, jcodec.encode),
                              (pwire[i], prec, lambda t, r: jcodec.encode_aux(
                                  jcodec.project_precision(t, r), r))):
            g = _flat(row(got))
            jin = tm.tmap(jnp.asarray, _client(src, c))
            w = _jflat(enc(jin, rnd))
            assert set(g) == set(w)
            pre = _jflat(jcodec.stages[0].encode(jin, rnd)
                         if spec == "lowrank+int8" else jin)
            for path in w:
                if path.endswith("['q']"):
                    base = path[:-len("['q']")]
                    flips += count_flips(g[path], w[path], pre[base],
                                         w[base + "['scale']"])
                    assert g[path].dtype == w[path].dtype
                else:
                    np.testing.assert_allclose(
                        g[path], w[path], rtol=1e-5,
                        atol=1e-6 * np.abs(w[path]).max(), err_msg=path)
        # decode of the port's own wire against JAX's decode of it
        got_dec = codec.decode(wire[i], rnd, like)
        jwire = tm.tmap(lambda a: jnp.asarray(np.asarray(row(a))),
                        wire[i]) if stacked else tm.tmap(
                            lambda a: jnp.asarray(a.numpy()), wire[i])
        want_dec = _jflat(jcodec.decode(jwire, rnd, tm.tmap(
            jnp.asarray, _client(x, c))))
        for path, v in _flat(row(got_dec)).items():
            np.testing.assert_allclose(v, want_dec[path], rtol=1e-5,
                                       atol=1e-6 * np.abs(want_dec[path])
                                       .max(), err_msg=path)
    record_property("flips", flips)
    assert flips <= 1
    if stacked and "int8" in spec:
        scales = np.stack([np.asarray(wire[0][k]["scale"]) for k in x])
        assert scales.shape == (4, 3) and (scales[:, 2] > 100
                                           * scales[:, 0]).all()


def test_stacked_eligibility_comes_from_one_clients_shape():
    """A (C, 6) stack of 1-D leaves is not sketched at rank 2, and a
    (C, 5, 2) one neither; ``w`` and ``k`` are."""
    codec = build_codec(FedConfig(**_kw("lowrank")))
    x = _t(_stack())
    enc = codec.encode(x, 0, _t(_client(_stack(), 0)))
    assert torch.equal(enc["b"], x["b"]) and torch.equal(enc["v"], x["v"])
    assert enc["w"].shape == (3, 12, 2) and enc["k"].shape == (3, 2, 3, 2)
    zeros = codec.accum_zeros(_t(_client(_stack(), 0)))
    assert {k: tuple(v.shape) for k, v in zeros.items()} == {
        "w": (12, 2), "b": (6,), "v": (5, 2), "k": (2, 3, 2)}


def test_int8_scale_is_per_client():
    """Each client of a stack gets its own scale; a cohort-wide max would
    zero the small clients' q."""
    codec = build_codec(FedConfig(**_kw("int8")))
    x = _stack()
    enc = codec.encode(_t(x), 0, _t(_client(x, 0)))
    for k, v in x.items():
        want = np.abs(v.reshape(3, -1)).max(1) / np.float32(127)
        np.testing.assert_allclose(enc[k]["scale"].numpy(), want, rtol=1e-7)
        assert (enc[k]["q"].abs().reshape(3, -1).amax(1) == 127).all()
    dec = codec.decode(enc, 0, None)
    one = codec.decode(codec.encode(_t(_client(x, 0)), 0), 0, None)
    for k in x:
        assert torch.equal(dec[k][0], one[k])


def test_leaves_numbered_in_jax_flatten_order_on_the_lm_tree():
    """The smoke fedlm-100m tree as the port inits it (keys in insertion
    order) and as JAX hands it over (sorted): the same encoded factors per
    path, equal to the JAX encode."""
    cfg = configs.get_smoke("fedlm-100m")
    port = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    numpy_tree = params_to_numpy(port)
    jtree = jax.tree_util.tree_map(jnp.asarray, numpy_tree)
    from_jax = lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtree), "cpu")
    # the two trees really flatten in different orders (11 of 13 leaves
    # of a layer move); JAX's is the sorted one
    assert _insertion_paths(port) != _insertion_paths(from_jax)
    assert _insertion_paths(from_jax) == sorted(_insertion_paths(port))
    kw = _kw("lowrank", lora_rank=4)
    codec, jcodec = build_codec(FedConfig(**kw)), jax_build_codec(
        JaxFedConfig(**kw))
    want = _jflat(jcodec.encode(jtree, 5))
    a, b = _flat(codec.encode(port, 5)), _flat(codec.encode(from_jax, 5))
    assert set(a) == set(b) == set(want)
    for path in want:
        assert np.array_equal(a[path], b[path]), path
        np.testing.assert_allclose(a[path], want[path], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[path]).max(),
                                   err_msg=path)


def _insertion_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _insertion_paths(v, f"{prefix}[{k!r}]")]
    return [prefix]


def test_parse_and_register_codec():
    assert codec_names() == jax_codec_names()
    assert parse_codec("lowrank+int8") == ("lowrank", "int8")
    for bad, msg in (("gzip", "unknown payload codec"),
                     ("none+int8", "cannot be composed"),
                     ("int8+int8", "duplicate"),
                     ("int8+lowrank", "linear.*prefix")):
        with pytest.raises(ValueError, match=msg):
            parse_codec(bad)
    register_codec("int8")(QuantCodec)          # the same class: a no-op

    class Other(QuantCodec):
        pass

    with pytest.raises(ValueError, match="already registered"):
        register_codec("int8")(Other)
    try:
        register_codec("int8", override=True)(Other)
        assert type(build_codec(FedConfig(**_kw("int8"))).stages[0]) is Other
    finally:
        register_codec("int8", override=True)(QuantCodec)
    assert type(build_codec(FedConfig(**_kw("int8"))).stages[0]) is \
        QuantCodec
