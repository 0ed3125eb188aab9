"""The port's decode attention (the kernel's plain twin, on the CPU) against
the JAX package's Pallas kernel in interpret mode (``ops.swa_decode``) and
its oracle (``ref.swa_decode_ref``), on the same numpy inputs. The CUDA
kernel against the twin: ``test_torch_gpu.py``.

Tolerances are ``tests/test_kernels.py``'s: 2e-5 in fp32 (softmax sums in
another order), 2e-2 in bf16 (one bf16 rounding of the output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import build, ops, ref, swa_decode

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _x32():
    """Other test modules turn on jax x64 at import; compare in fp32."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _inputs(seed, B, H, KV, dh, L, dtype):
    """q (B, H, dh) and k, v (B, L, KV, dh) in numpy, rounded to ``dtype``
    so both packages see the same values."""
    r = np.random.default_rng(seed)
    rnd = lambda *s: np.asarray(jnp.asarray(r.normal(size=s), dtype),
                                np.float32)
    return rnd(B, H, dh), rnd(B, L, KV, dh), rnd(B, L, KV, dh)


def _port(q, k, v, slot_pos, pos, window, dtype):
    t = lambda x: torch.from_numpy(np.array(x)).to(_TDT[dtype])
    out = ops.swa_decode(t(q), t(k), t(v), torch.from_numpy(slot_pos), pos,
                         window=window)
    assert out.dtype == _TDT[dtype]
    return out.float().numpy()


def _jax_kernel(q, k, v, slot_pos, pos, window, dtype):
    j = lambda x: jnp.asarray(x, getattr(jnp, dtype))
    return np.asarray(jax_ops.swa_decode(j(q), j(k), j(v),
                                         jnp.asarray(slot_pos), pos,
                                         window=window), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,dh,L,window", [
    (1, 4, 1, 64, 512, 0),       # MQA, linear cache
    (2, 8, 2, 64, 1024, 300),    # GQA, window
    (2, 4, 4, 128, 512, 300),    # MHA, wide heads, window
])
def test_twin_vs_jax_kernel_sweep(B, H, KV, dh, L, window, dtype):
    q, k, v = _inputs(B * 7 + H + window, B, H, KV, dh, L, dtype)
    pos = L - 50
    slot = np.where(np.arange(L) <= pos, np.arange(L), -1).astype(np.int32)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(
        _port(q, k, v, slot, pos, window, dtype),
        _jax_kernel(q, k, v, slot, pos, window, dtype), rtol=tol, atol=tol)


def test_twin_vs_jax_kernel_wrapped_ring():
    """Ring cache: slots hold interleaved positions; masking follows
    slot_pos, not slot order."""
    B, H, KV, dh, L, W = 1, 2, 1, 64, 512, 256
    q, k, v = _inputs(3, B, H, KV, dh, L, "float32")
    pos = 700
    slots = np.arange(L)
    slot_pos = np.where(slots <= pos % L, (pos // L) * L + slots,
                        (pos // L - 1) * L + slots).astype(np.int32)
    np.testing.assert_allclose(
        _port(q, k, v, slot_pos, pos, W, "float32"),
        _jax_kernel(q, k, v, slot_pos, pos, W, "float32"),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("first_visible", [200, None])
def test_twin_vs_jax_kernel_masked_chunks(first_visible):
    """The first slots (whole kernel chunks) are empty; with no visible slot
    at all both give the mean of V over the L slots."""
    B, H, KV, dh, L = 2, 4, 2, 64, 512
    q, k, v = _inputs(11, B, H, KV, dh, L, "float32")
    pos = L - 1
    slot_pos = np.full(L, -1, np.int32)
    if first_visible is not None:
        slot_pos[first_visible:] = np.arange(first_visible, L)
    got = _port(q, k, v, slot_pos, pos, 0, "float32")
    np.testing.assert_allclose(
        got, _jax_kernel(q, k, v, slot_pos, pos, 0, "float32"),
        rtol=2e-5, atol=2e-5)
    if first_visible is None:
        mean_v = v.mean(axis=1)                           # (B, KV, dh)
        np.testing.assert_allclose(
            got.reshape(B, KV, H // KV, dh),
            np.broadcast_to(mean_v[:, :, None], (B, KV, H // KV, dh)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window", [0, 256])
def test_twin_vs_jax_oracle_ragged_length(window):
    """L = 1000 is no multiple of the Pallas tile (the JAX kernel asserts
    that), so the oracle is the reference here."""
    B, H, KV, dh, L = 2, 8, 2, 64, 1000
    q, k, v = _inputs(5, B, H, KV, dh, L, "float32")
    pos = 1100
    slot_pos = ((pos // L) * L + np.arange(L)).astype(np.int32)
    slot_pos[slot_pos > pos] -= L
    want = jax_ref.swa_decode_ref(
        jnp.asarray(q).reshape(B, KV, H // KV, dh), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(slot_pos), pos, window=window)
    np.testing.assert_allclose(
        _port(q, k, v, slot_pos, pos, window, "float32"),
        np.asarray(want).reshape(B, H, dh), rtol=2e-5, atol=2e-5)


def _cpu_args(dh=64, L=8, dtype=torch.float32):
    q = torch.zeros(1, 2, 2, dh, dtype=dtype)
    k = torch.zeros(1, L, 2, dh, dtype=dtype)
    return q, k, k.clone(), torch.arange(L, dtype=torch.int32)


@pytest.mark.parametrize("bad,err", [
    (dict(dh=48), ValueError),                 # not a multiple of 32
    (dict(dh=288), ValueError),                # above 256
    (dict(slot_dtype=torch.int64), TypeError),
    (dict(k_dtype=torch.bfloat16), TypeError),
    (dict(pos=3.0), TypeError),                # pos is a host int
    (dict(strided=True), ValueError),          # K read in place: contiguous
])
def test_kernel_checks_raise(bad, err):
    q, k, v, sp = _cpu_args(dh=bad.get("dh", 64))
    if "slot_dtype" in bad:
        sp = sp.to(bad["slot_dtype"])
    if "k_dtype" in bad:
        k = k.to(bad["k_dtype"])
    if bad.get("strided"):
        k = torch.zeros(*k.shape[:-1], 2 * k.shape[-1])[..., ::2]
    with pytest.raises(err):
        swa_decode._check(q, k, v, sp, bad.get("pos", 3), 0)


def test_wrapper_dispatch_by_device():
    """CPU tensors take the twin (no launch counted); a device mix raises."""
    q, k, v, sp = _cpu_args()
    before = swa_decode.launches["swa_decode"]
    torch.testing.assert_close(swa_decode.swa_decode_attention(q, k, v, sp, 5),
                               ref.swa_decode_ref(q, k, v, sp, 5))
    assert swa_decode.launches["swa_decode"] == before
    with pytest.raises(ValueError, match="one CUDA device"):
        build.on_cpu(q, k.to("meta"))
