"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Imports neither JAX nor the JAX package, so it runs where only the port's
dependencies are installed (``python -m pytest -q -m gpu
tests/test_torch_gpu.py``); skips without a CUDA device. Tolerances: the
reduce's fp32 sums over d run in another order (1e-4 relative, 1e-2 absolute
on sums of ~4e5 terms); the map is one fused pass, 1e-5 (fp32) or one bf16
rounding, 2e-2 (bf16 outputs); decode attention 2e-5 (fp32) and 2e-2
(bf16), as ``tests/test_kernels.py``.
"""
import pytest
import torch

from repro_torch.kernels import fedpa_dp, ref, swa_decode


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,lp,d", [(3, 1, 1300), (16, 4, 428_350)])
def test_cuda_kernels_vs_twins(C, lp, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(C * lp)
    tdt = getattr(torch, dtype)
    u, delta = (torch.randn(C, d, device="cuda", generator=g).to(tdt)
                for _ in range(2))
    V = torch.randn(C, lp, d, device="cuda", generator=g).to(tdt)
    w = torch.randn(C, lp, device="cuda", generator=g)
    s = torch.randn(C, device="cuda", generator=g)
    before = dict(fedpa_dp.launches)
    got = fedpa_dp.dp_reduce(u, delta, V)
    want = ref.dp_reduce_ref(u, delta, V)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-2)
    vout, dout = fedpa_dp.dp_map(w, s, u, delta, V)
    v_ref, d_ref = ref.dp_map_ref(w, s, u, delta, V)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(vout.float(), v_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dout.float(), d_ref.float(), rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert fedpa_dp.launches["dp_reduce"] == before["dp_reduce"] + 1
    assert fedpa_dp.launches["dp_map"] == before["dp_map"] + 1


def _slot_positions(L, pos, kind):
    """Token position per slot: a wrapped ring (p in slot p % L), a linear
    cache, one whose first 320 slots are empty, or an empty one."""
    i = torch.arange(L)
    if kind == "ring":
        p = (pos // L) * L + i
        p = torch.where(p > pos, p - L, p)
    else:
        p = torch.where(i <= pos, i, -1)
    if kind == "masked-head":
        p[:320] = -1
    if kind == "empty":
        p[:] = -1
    return p.clamp(min=-1).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,dh,L,window,pos,kind", [
    (4, 32, 16, 128, 1024, 1024, 1300, "ring"),       # gemma3 local layer
    (4, 32, 16, 128, 1344, 0, 1300, "linear"),        # gemma3 global layer
    (1, 4, 1, 64, 512, 300, 462, "linear"),           # MQA
    (2, 4, 4, 256, 512, 0, 462, "linear"),            # MHA, dh 256
    (2, 8, 2, 64, 1000, 256, 1100, "ring"),           # ragged L
    (2, 8, 2, 96, 1344, 0, 1343, "masked-head"),      # empty leading chunks
    (2, 8, 2, 64, 700, 0, 699, "empty"),              # mean of V
])
def test_swa_decode_kernel_vs_twin(B, H, KV, dh, L, window, pos, kind, dtype):
    """fp32 2e-5 (softmax sums in another order), bf16 2e-2 (one rounding
    of the output), as tests/test_kernels.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(L + H)
    tdt = getattr(torch, dtype)
    q = torch.randn(B, KV, H // KV, dh, device="cuda", generator=g).to(tdt)
    k, v = (torch.randn(B, L, KV, dh, device="cuda", generator=g).to(tdt)
            for _ in range(2))
    sp = _slot_positions(L, pos, kind).cuda()
    before = swa_decode.launches["swa_decode"]
    got = swa_decode.swa_decode_attention(q, k, v, sp, pos, window=window)
    want = ref.swa_decode_ref(q, k, v, sp, pos, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert got.dtype == tdt
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert swa_decode.launches["swa_decode"] == before + 1
