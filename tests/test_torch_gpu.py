"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Imports neither JAX nor the JAX package, so it runs where only the port's
dependencies are installed (``python -m pytest -q -m gpu
tests/test_torch_gpu.py``); skips without a CUDA device. Tolerances: the
reduce's fp32 sums over d run in another order (1e-4 relative, 1e-2 absolute
on sums of ~4e5 terms); the map is one fused pass, 1e-5 (fp32) or one bf16
rounding, 2e-2 (bf16 outputs).
"""
import pytest
import torch

from repro_torch.kernels import fedpa_dp, ref


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
