"""How the CUDA DP kernels split their work, checked without a card.

``ref.dp_reduce_split_ref`` models the reduce kernel's sums (2048-element
fp32 tiles, per-tile partials in a fixed order, the tiles combined in
order) and ``ref.dp_coeffs`` holds the step's scalars that the reduce
kernel computes in its epilogue; both are held against the plain twins and
the JAX package's Pallas kernels (interpret mode) on the same numpy inputs,
with ``tests/test_kernels.py``'s tolerances (one reduce 1e-5 relative, one
step 1e-5 of the largest entry). ``fedpa_dp.vector_bytes`` picks the width
of the kernels' loads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fedpa_dp as jax_fedpa_dp
from repro.kernels import ops as jax_ops
from repro_torch.kernels import fedpa_dp, ref


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; the references here
    are fp32 like the port."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _split(u, delta, V, **kw):
    """``ref.dp_reduce_split_ref`` at the kernels' load width for d."""
    kw.setdefault("vec_bytes",
                  fedpa_dp.vector_bytes(u.shape[1], u.element_size()))
    return ref.dp_reduce_split_ref(u, delta, V, **kw)


def _reduce_inputs(C, d, lp=4, seed=0):
    r = np.random.default_rng([seed, C, d])
    return (r.normal(size=(C, d)).astype(np.float32),
            r.normal(size=(C, d)).astype(np.float32),
            r.normal(size=(C, lp, d)).astype(np.float32))


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("d", [64, 500, 1000, 1300, 4096, 1297, 1299])
def test_dp_reduce_split_vs_twin_and_jax(d, C):
    """The reference's sweep plus odd d (scalar loads, a ragged tile)."""
    u, delta, V = _reduce_inputs(C, d)
    got = _split(*map(torch.from_numpy, (u, delta, V)))
    twin = ref.dp_reduce_ref(*map(torch.from_numpy, (u, delta, V)))
    for g, w in zip(got, twin):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-4)
    for c in range(C):
        want = jax_fedpa_dp.dp_reduce(*(jnp.asarray(x[c])
                                        for x in (u, delta, V)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d,vec_bytes", [(4096, 16), (4096, 8), (4096, 4),
                                         (5002, 8), (1299, 4)])
def test_dp_reduce_split_at_every_vector_width(d, vec_bytes):
    """Every load width the kernel may take gives the twin's sums (the
    order of a thread's terms changes with the width, the tiles do not)."""
    u, delta, V = map(torch.from_numpy, _reduce_inputs(2, d, seed=1))
    got = _split(u, delta, V, vec_bytes=vec_bytes)
    for g, w in zip(got, ref.dp_reduce_ref(u, delta, V)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [4096, 5002, 1297])
def test_dp_reduce_split_client_alone_equals_its_row(d, dtype):
    """A client's sums are the same bits alone as inside a stack of 5: the
    tiles and their order do not depend on C."""
    tdt = getattr(torch, dtype)
    u, delta, V = (torch.from_numpy(x).to(tdt)
                   for x in _reduce_inputs(5, d, seed=2))
    stack = _split(u, delta, V)
    for c in range(5):
        alone = _split(u[c:c + 1], delta[c:c + 1], V[c:c + 1])
        for a, s in zip(alone, stack):
            assert torch.equal(a[0], s[c])


@pytest.mark.parametrize("t", [2, 3, 4, 5])
def test_dp_coeffs_vs_jax_step(t):
    """``dp_coeffs`` (the CUDA step's epilogue) against JAX ``ops.dp_step``
    at t = 2 .. lp + 1 with lp = 4: history rows k >= t-1 hold nonzero
    values and must weigh nothing."""
    lp, rho = 4, 0.3
    r = np.random.default_rng(t)
    u, delta = (r.normal(size=(2, 900)).astype(np.float32) for _ in range(2))
    V = r.normal(size=(2, lp, 900)).astype(np.float32)
    c_hist = np.abs(r.normal(size=(2, lp))).astype(np.float32)
    tu, td, tV, tc = map(torch.from_numpy, (u, delta, V, c_hist))
    w, scale, a, c_new = ref.dp_coeffs(*ref.dp_reduce_ref(tu, td, tV), tc,
                                       t, rho)
    assert torch.all(w[:, t - 1:] == 0) and torch.all(w[:, :t - 1] != 0)
    v, delta_new = ref.dp_map_ref(w, scale, tu, td, tV)
    for c in range(2):
        want = jax_ops.dp_step(*(jnp.asarray(x[c])
                                 for x in (u, delta, V, c_hist)), t, rho=rho)
        for g, wv in zip((v[c], delta_new[c], a[c], c_new[c]), want):
            wv = np.asarray(wv)
            np.testing.assert_allclose(
                g.numpy(), wv, rtol=1e-5,
                atol=1e-5 * max(1.0, float(np.abs(wv).max())))


@pytest.mark.parametrize("d,esize,want", [
    (4096, 4, 16), (4097, 4, 4), (4098, 4, 8), (4099, 4, 4),
    (4096, 2, 16), (4100, 2, 8), (4097, 2, 2), (4098, 2, 4), (4099, 2, 2),
    (428_350, 4, 8), (428_350, 2, 4)])
def test_vector_bytes_over_d_mod_4(d, esize, want):
    """The widest load every row start aligns to (fp32: esize 4, bf16: 2):
    16 bytes when a row is a multiple of 16 bytes, else 8 or 4 (bf16 also
    2), never below one element; a base address that is only 8-byte
    aligned caps it at 8, one only 4-byte aligned at 4."""
    assert fedpa_dp.vector_bytes(d, esize) == want
    assert fedpa_dp.vector_bytes(d, esize, 0, 256, 1 << 20) == want
    assert fedpa_dp.vector_bytes(d, esize, 256, 264) == min(want, 8)
    assert fedpa_dp.vector_bytes(d, esize, 260) == min(want, 4)
