"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Imports neither JAX nor the JAX package, so it runs where only the port's
dependencies are installed (``python -m pytest -q -m gpu
tests/test_torch_gpu.py``); skips without a CUDA device. Tolerances: the
reduce's fp32 sums over d run in another order (1e-4 relative, 1e-2 absolute
on sums of ~4e5 terms); the map is one fused pass, 1e-5 (fp32) or one bf16
rounding, 2e-2 (bf16 outputs); decode attention 2e-5 (fp32) and 2e-2
(bf16), as ``tests/test_kernels.py``, and two calls of it agree bit for
bit. One DP step on the card against the twins' step: 1e-4 relative plus
1e-4 of the largest entry (the coefficients come from reduce sums in
another order; entries that cancel keep an absolute error of the largest
entry's size). A round on the card against the same round on the CPU:
1e-4 relative, 1e-5 absolute (fp32 least squares, 12 local steps); the
stateful CNN rounds and their client stores, 1e-3 relative, 1e-4
absolute (``chip_smoke.py`` phase 4's bound). The device store's CAS on
the card equals the host store's exactly. The codecs: the low-rank basis
on the card equals the CPU's bit for bit (it is built on the host), the
sketch's matmuls 1e-5 relative, int8 ``q`` equal but where ``x / scale``
lies within 1e-5 of a half quantum (at most one flip), the scales per
client; FedLoRA's ``lowrank`` rounds on the card as the stateful rounds
above.
"""
import numpy as np
import pytest
import torch

from repro_torch.compression import build_codec
from repro_torch.configs.base import FedConfig
from repro_torch.core import tree_math as tm
from repro_torch.core.round import FedSim
from repro_torch.data.synthetic_lsq import lsq_batches, make_federated_lsq
from repro_torch.kernels import fedpa_dp, ops, ref, swa_decode


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,lp,d", [
    (3, 1, 1300), (16, 4, 428_350),
    *[(C, 4, d) for C in (1, 6, 16) for d in (4096, 1297, 1299, 428_350)
      if (C, d) != (16, 428_350)]])
def test_cuda_kernels_vs_twins(C, lp, d, dtype):
    """The stacks of the three placements (1, 6, 16 clients) at every load
    width: d 4096 (16-byte rows), 428,350 (8-byte in fp32, 4 in bf16), odd
    d (one element)."""
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
    (2, 8, 2, 64, 1, 0, 0, "linear"),                 # L 1: 7 CTAs idle
    (2, 8, 2, 64, 5, 0, 4, "linear"),                 # L 5 < 8 CTAs
    (4, 64, 8, 128, 1344, 0, 1300, "linear"),         # qwen3-32b, G 8
])
def test_swa_decode_kernel_vs_twin(B, H, KV, dh, L, window, pos, kind, dtype):
    """fp32 2e-5 (softmax sums in another order), bf16 2e-2 (one rounding
    of the output), as tests/test_kernels.py; two calls agree bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _kernel_vs_twin(B, H, KV, dh, L, window, pos, kind, getattr(torch, dtype))


@pytest.mark.gpu
def test_swa_decode_kernel_vs_twin_widest():
    """G 16 at head_dim 256 in fp32: the most shared memory per CTA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _kernel_vs_twin(2, 32, 2, 256, 700, 300, 699, "linear", torch.float32)


def _kernel_vs_twin(B, H, KV, dh, L, window, pos, kind, tdt):
    g = torch.Generator(device="cuda").manual_seed(L + H)
    q = torch.randn(B, KV, H // KV, dh, device="cuda", generator=g).to(tdt)
    k, v = (torch.randn(B, L, KV, dh, device="cuda", generator=g).to(tdt)
            for _ in range(2))
    sp = _slot_positions(L, pos, kind).cuda()
    before = swa_decode.launches["swa_decode"]
    got = swa_decode.swa_decode_attention(q, k, v, sp, pos, window=window)
    again = swa_decode.swa_decode_attention(q, k, v, sp, pos, window=window)
    want = ref.swa_decode_ref(q, k, v, sp, pos, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if tdt == torch.bfloat16 else 2e-5
    assert got.dtype == tdt
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, again)
    assert swa_decode.launches["swa_decode"] == before + 2


@pytest.mark.gpu
def test_swa_decode_one_launch_and_checks_after_memo():
    """A call is one kernel on the card; the remembered checks of a good
    shape still let a bad one raise. The profiler may miss a kernel's record
    now and then, so over several calls it must see only swa_decode, and no
    more of it than calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    q = torch.randn(2, 2, 4, 128, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn(2, 300, 2, 128, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    sp = torch.arange(300, dtype=torch.int32, device="cuda")
    swa_decode.swa_decode_attention(q, k, v, sp, 299)
    torch.cuda.synchronize()
    calls = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            swa_decode.swa_decode_attention(q, k, v, sp, 299)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(kernels) <= calls, kernels
    assert all("swa_decode" in name for name in kernels), kernels
    with pytest.raises(ValueError, match="shape mismatch"):
        swa_decode.swa_decode_attention(q, k[:, :299].contiguous(), v, sp,
                                        299)
    with pytest.raises(TypeError, match="one dtype"):
        swa_decode.swa_decode_attention(q, k.float(), v, sp, 299)
    with pytest.raises(ValueError, match="16-byte"):
        kk = torch.empty(k.numel() + 1, device="cuda", dtype=k.dtype)
        swa_decode.swa_decode_attention(q, kk[1:].view(k.shape), v, sp, 299)


def _cohort_with_padding(C, lp, d, pad, seed):
    """A DP step's operands for C clients whose last ``pad`` clients
    duplicate client 0, as the chunked placement pads a chunk: u, delta
    (C, d), V (C, lp, d), the combine weights w and coefficients c_hist
    (C, lp), the scale s (C,)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u, delta = (torch.randn(C, d, device="cuda", generator=g)
                for _ in range(2))
    V = torch.randn(C, lp, d, device="cuda", generator=g)
    w = torch.randn(C, lp, device="cuda", generator=g)
    c_hist = torch.rand(C, lp, device="cuda", generator=g)
    s = torch.randn(C, device="cuda", generator=g)
    for x in (u, delta, V, w, c_hist, s):
        x[C - pad:] = x[:1]
    return u, delta, V, w, c_hist, s


@pytest.mark.gpu
@pytest.mark.parametrize("C,d,pad", [(1, 1300, 0), (1, 428_350, 0),
                                     (6, 1300, 2), (6, 428_350, 2)])
def test_dp_kernels_and_step_at_sequential_and_chunk_shapes(C, d, pad):
    """The stacks the new placements launch: one client (``sequential``)
    and a chunk of 6 whose last 2 clients are zero-weight copies of
    client 0 (``chunked``); a copy's results equal client 0's bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lp, t, rho = 4, 4, 0.1
    u, delta, V, w, c_hist, s = _cohort_with_padding(C, lp, d, pad,
                                                      C * 7 + pad)
    before = dict(fedpa_dp.launches)
    got = fedpa_dp.dp_reduce(u, delta, V)
    for a, b in zip(got, ref.dp_reduce_ref(u, delta, V)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-2)
    vout, dout = fedpa_dp.dp_map(w, s, u, delta, V)
    v_ref, d_ref = ref.dp_map_ref(w, s, u, delta, V)
    torch.testing.assert_close(vout, v_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dout, d_ref, rtol=1e-5, atol=1e-5)
    step = ops.dp_step(u, delta, V, c_hist, t, rho)
    for a, b in zip(step, ref.dp_step_ref(u, delta, V, c_hist, t, rho)):
        tol = 1e-4 * max(b.abs().max().item(), 1.0)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=tol)
    torch.cuda.synchronize()
    for out in (*got, vout, dout, *step):
        for row in range(C - pad, C):
            assert torch.equal(out[row], out[0])
    assert fedpa_dp.launches["dp_reduce"] == before["dp_reduce"] + 2
    assert fedpa_dp.launches["dp_map"] == before["dp_map"] + 2


def _lsq_sim(device, placement, chunk):
    """FedPA on a 4-client least-squares problem: 12 local steps, 4
    burn-in, windows of 2 (l = 4, so 3 DP steps per client)."""
    _, data = make_federated_lsq(4, 50, 3, heterogeneity=20.0, seed=0)

    def batch_fn(cid, r, steps):
        X, y = data[cid]
        return lsq_batches(X, y, 10, steps, seed=r * 131 + cid)

    grad_and_value = torch.func.grad_and_value(
        lambda p, b: 0.5 * ((b["x"] @ p - b["y"]) ** 2).mean() * 50)

    def grad_fn(p, b):
        g, value = grad_and_value(p, b)
        return value, g

    fed = FedConfig(algorithm="fedpa", clients_per_round=4, local_steps=12,
                    burn_in_steps=4, steps_per_sample=2, shrinkage_rho=0.5,
                    client_opt="sgd", client_lr=0.01, server_opt="sgd",
                    server_lr=0.1)
    return FedSim(fed, grad_fn, batch_fn, num_clients=4, device=device,
                  placement=placement, chunk_size=chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("placement,chunk,stacks", [
    ("sequential", None, 4), ("chunked", 3, 2), ("parallel", None, 1)])
def test_round_launches_each_dp_kernel_once_per_stack_and_step(
        placement, chunk, stacks):
    """A FedPA round makes (l - 1) DP steps per stack of clients: C stacks
    at ``sequential``, one per chunk (padding included) at ``chunked``;
    its params equal the same round on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = _lsq_sim("cuda", placement, chunk)
    state = sim.init(torch.zeros(3))
    fedpa_dp.reset_launches()
    state, record = sim.round(state, 0)
    torch.cuda.synchronize()
    assert fedpa_dp.launches == {"dp_reduce": stacks * 3,
                                 "dp_map": stacks * 3}
    cpu = _lsq_sim("cpu", placement, chunk)
    cpu_state, cpu_record = cpu.round(cpu.init(torch.zeros(3)), 0)
    np.testing.assert_allclose(state.params.cpu().numpy(),
                               cpu_state.params.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert record["loss_last"] == pytest.approx(cpu_record["loss_last"],
                                                rel=1e-4)


def _dp_operands(C, lp, d, tdt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u, delta = (torch.randn(C, d, device="cuda", generator=g).to(tdt)
                for _ in range(2))
    V = torch.randn(C, lp, d, device="cuda", generator=g).to(tdt)
    w = torch.randn(C, lp, device="cuda", generator=g)
    s = torch.randn(C, device="cuda", generator=g)
    return u, delta, V, w, s


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [428_350, 4096, 1299])
def test_dp_kernels_repeat_bitwise_and_client_alone_equals_its_row(d, dtype):
    """Two calls give the same bits (the reduce's partials are combined in
    a fixed order, no atomic on a value), and each client of a 16-stack
    called alone gives its row of the stack bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    u, delta, V, w, s = _dp_operands(16, 4, d, getattr(torch, dtype), 11)
    red = fedpa_dp.dp_reduce(u, delta, V)
    mapped = fedpa_dp.dp_map(w, s, u, delta, V)
    for a, b in zip(red, fedpa_dp.dp_reduce(u, delta, V)):
        assert torch.equal(a, b)
    for a, b in zip(mapped, fedpa_dp.dp_map(w, s, u, delta, V)):
        assert torch.equal(a, b)
    for c in range(16):
        one = [x[c:c + 1].clone() for x in (u, delta, V)]
        for a, b in zip(fedpa_dp.dp_reduce(*one), red):
            assert torch.equal(a[0], b[c]), c
        for a, b in zip(fedpa_dp.dp_map(w[c:c + 1].clone(),
                                        s[c:c + 1].clone(), *one), mapped):
            assert torch.equal(a[0], b[c]), c


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dp_reduce_tile_matches_the_cpu_model(dtype):
    """The reduce kernel's tile is the one ``ref.dp_reduce_split_ref``
    models, so the CPU tests of its sum order hold for the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    esize = torch.tensor([], dtype=dtype).element_size()
    assert fedpa_dp._lib().fedpa_dp_tile(int(dtype == torch.bfloat16)) \
        == ref.reduce_tile(esize)


@pytest.mark.gpu
@pytest.mark.parametrize("C,t", [(1, 2), (6, 4), (16, 5)])
def test_dp_step_is_two_kernels_and_captures_in_a_cuda_graph(C, t):
    """``ops.dp_step`` on the card: the reduce (with the coefficients) and
    the map, no other device operation, no host sync: it captures into a
    CUDA graph whose replay gives the eager step's bits, within 1e-4 of the
    twins' step (rows k >= t-1 hold values that must weigh nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    lp, rho, d = 4, 0.1, 428_350
    g = torch.Generator(device="cuda").manual_seed(C + t)
    u, delta = (torch.randn(C, d, device="cuda", generator=g)
                for _ in range(2))
    V = torch.randn(C, lp, d, device="cuda", generator=g)
    c_hist = torch.rand(C, lp, device="cuda", generator=g)
    eager = ops.dp_step(u, delta, V, c_hist, t, rho)
    for a, b in zip(eager, ref.dp_step_ref(u, delta, V, c_hist, t, rho)):
        tol = 1e-4 * max(b.abs().max().item(), 1.0)
        torch.testing.assert_close(a, b, rtol=1e-4, atol=tol)
    graph = torch.cuda.CUDAGraph()
    before = dict(fedpa_dp.launches)
    with torch.cuda.graph(graph):
        captured = ops.dp_step(u, delta, V, c_hist, t, rho)
    assert fedpa_dp.launches["dp_reduce"] == before["dp_reduce"] + 1
    assert fedpa_dp.launches["dp_map"] == before["dp_map"] + 1
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)
    calls = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.dp_step(u, delta, V, c_hist, t, rho)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    # the profiler may miss a record now and then, never add one
    assert 1 <= len(names) <= 2 * calls, names
    assert all("reduce_kernel" in n or "map_kernel" in n for n in names), \
        names


@pytest.mark.gpu
def test_dp_reduce_scratch_grows_and_counters_return_to_zero():
    """The reduce's scratch (per-tile partials, per-client ticket counters)
    grows for a larger call after a smaller one, the counters are 0 after
    every launch, and a graph captured at the small shape still replays
    right after the scratch grew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    small = _dp_operands(1, 2, 3000, torch.float32, 5)[:3]
    want_small = ref.dp_reduce_ref(*small)
    fedpa_dp._scratch.pop(small[0].device.index, None)   # start it small
    fedpa_dp.dp_reduce(*small)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_small = fedpa_dp.dp_reduce(*small)
    index = small[0].device.index
    partials, tickets = fedpa_dp._scratch[index]
    large = _dp_operands(16, 6, 200_000, torch.float32, 6)[:3]
    got = fedpa_dp.dp_reduce(*large)
    for a, b in zip(got, ref.dp_reduce_ref(*large)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-2)
    grown = fedpa_dp._scratch[index]
    assert grown[0].numel() > partials.numel()
    assert grown[1].numel() >= 16
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out_small, want_small):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    assert not tickets.any() and not grown[1].any()
    for a, b in zip(fedpa_dp.dp_reduce(*small), want_small):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
    torch.cuda.synchronize()
    assert not fedpa_dp._scratch[index][1].any()



@pytest.mark.gpu
def test_smoke_train_path_on_the_card_equals_the_cpu():
    """``launch.train.main`` on the smoke fedlm in fp32 compute (TF32 off):
    one burn-in and two FedPA rounds with l = 3, so (3 - 1) x 2 = 4 DP
    launches of each kernel and none of ``swa_decode``; the card's final
    params equal the CPU run's to 1e-3 relative, 1e-4 absolute (phase 4 of
    ``chip_smoke.py``: matmuls and sums in another order through 24 local
    steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import train

    argv = ["--smoke", "--rounds", "3", "--clients", "2", "--local-steps",
            "8", "--burn-in-steps", "2", "--steps-per-sample", "2",
            "--burn-in-rounds", "1", "--batch", "2", "--seq-len", "32",
            "--prefetch-rounds", "0"]
    fedpa_dp.reset_launches()
    swa_decode.reset_launches()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = train.main(argv + ["--device", "cuda"],
                          compute_dtype=torch.float32)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert fedpa_dp.launches == {"dp_reduce": 4, "dp_map": 4}
    assert swa_decode.launches["swa_decode"] == 0
    cpu = train.main(argv + ["--device", "cpu"], compute_dtype=torch.float32)
    for a, b in zip(card["records"], cpu["records"]):
        assert a["phase"] == b["phase"]
        assert a["eval_loss"] == pytest.approx(b["eval_loss"], rel=1e-4)
    for got, want in zip(tm.tleaves(card["state"].params),
                         tm.tleaves(cpu["state"].params)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_device_store_cas_on_cuda_equals_the_host_store():
    """The same gathers and CAS scatters (a stale stamp, a write mask) on
    the host store and on the device store's CUDA tensors: the same
    states, stamps and drop counts; ``device_gather`` / ``device_scatter``
    with the ids, stamps and mask already on the card never sync with the
    host (sync-debug mode ``"error"``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import client_state as cs

    template = {"a": np.zeros((3, 2), np.float32),
                "b": np.zeros(5, np.float32)}
    host = cs.ClientStateStore(8).ensure(template)
    dev = cs.DeviceClientStateStore(8, device="cuda").ensure(template)
    drops = {}
    for name, store in (("host", host), ("device", dev)):
        rng = np.random.default_rng(0)
        stale = store.gather([4])[1]
        drops[name] = []
        for ids, mask in ([1, 4, 6], None), ([4, 2, 7], [1, 0, 1]):
            _, stamps = store.gather(ids)
            upd = {k: rng.normal(size=(len(ids),) + v.shape).astype(
                np.float32) for k, v in template.items()}
            drops[name].append(store.scatter(ids, upd, stamps,
                                             write_mask=mask))
        ones = {k: np.ones((1,) + v.shape, np.float32)
                for k, v in template.items()}
        drops[name].append(store.scatter([4], ones, stale))
    assert drops["host"] == drops["device"] == [0, 0, 1]
    for a, b in zip(tm.tleaves(host.state_dict()),
                    tm.tleaves(dev.state_dict())):
        np.testing.assert_array_equal(a, b)

    ids = dev.prepare_ids([3, 4, 7])
    mask = torch.tensor([1.0, 0.0, 1.0], device="cuda")
    stale = dev.device_state()["stamps"].index_select(0, ids) - 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rows, stamps = cs.device_gather(dev.device_state(), ids)
        upd = tm.tmap(lambda x: x + 1.0, rows)
        _, drops = cs.device_scatter(dev.device_state(), ids, upd, stamps,
                                     write_mask=mask)
        _, stale_drops = cs.device_scatter(dev.device_state(), ids, upd,
                                           stale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(drops) == 0 and int(stale_drops) == 3
    host_rows, _ = host.gather([3, 4, 7])
    _, host_stamps = host.gather([3, 4, 7])
    assert host.scatter([3, 4, 7], tm.tmap(lambda x: x + 1.0, host_rows),
                        host_stamps, write_mask=[1, 0, 1]) == 0
    for a, b in zip(tm.tleaves(host.state_dict()),
                    tm.tleaves(dev.state_dict())):
        np.testing.assert_array_equal(a, b)


def _cnn_sim(device, algorithm, place):
    """A stateful round of the full-width EMNIST CNN: 4 of 6 clients, 6
    local steps (FedEP: 2 burn-in steps, windows of 2, l = 2, after one
    burn-in round)."""
    from repro_torch.configs.emnist_cnn import config
    from repro_torch.models.cnn import cnn_grad_fn

    cfg = config()
    s = cfg.image_size

    def batch_fn(cid, rnd, steps):
        r = np.random.default_rng([cid, rnd])
        return {"x": r.random((steps, 8, s, s, 1), np.float32),
                "y": r.integers(0, cfg.num_classes, (steps, 8),
                                dtype=np.int32)}

    kw = dict(algorithm=algorithm, clients_per_round=4, local_steps=6,
              client_opt="sgd", client_lr=0.01, server_opt="sgd",
              server_lr=0.3, client_state_placement=place)
    if algorithm == "fedep":
        kw.update(burn_in_steps=2, steps_per_sample=2, shrinkage_rho=0.01,
                  burn_in_rounds=1, fedep_damping=0.7)
    return FedSim(FedConfig(**kw), cnn_grad_fn(cfg), batch_fn,
                  num_clients=6, device=device), cfg


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm,place,dp_launches", [
    ("fedep", "device", 2), ("scaffold", "host", 0), ("scaffold", "device",
                                                       0)])
def test_stateful_cnn_rounds_on_the_card_equal_the_cpu(algorithm, place,
                                                       dp_launches):
    """Three rounds on the card and on the CPU (TF32 off): params and the
    client store within 1e-3 relative, 1e-4 absolute (``chip_smoke.py``
    phase 4's bound); FedEP makes (l - 1) = 1 DP step per FedEP round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.cnn import init_cnn_params

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            sim, cfg = _cnn_sim(device, algorithm, place)
            params = init_cnn_params(torch.Generator().manual_seed(0), cfg)
            fedpa_dp.reset_launches()
            state, _ = sim.run(params, 3)
            if device == "cuda":
                torch.cuda.synchronize()
                assert fedpa_dp.launches == {"dp_reduce": dp_launches,
                                             "dp_map": dp_launches}
            out[device] = (state, sim.client_store.state_dict())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    (card, card_store), (cpu, cpu_store) = out["cuda"], out["cpu"]
    for a, b in zip(tm.tleaves(card.params), tm.tleaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(card_store["stamps"], cpu_store["stamps"])
    for a, b in zip(tm.tleaves(card_store["buffers"]),
                    tm.tleaves(cpu_store["buffers"])):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def _codec_stack(device, C=4):
    """A stack of C clients' trees at fedlm-100m's sketched widths, client
    c scaled by 10^c, and its unstacked template."""
    g = torch.Generator().manual_seed(7)
    shapes = {"wq": (768, 768), "w_up": (768, 2048), "w_down": (2048, 768),
              "k_scale": (64,), "embed": (512, 768)}
    scale = 10.0 ** torch.arange(C, dtype=torch.float32)
    tree = {k: (torch.randn(C, *s, generator=g)
                * scale.reshape(-1, *([1] * len(s)))).to(device)
            for k, s in shapes.items()}
    return tree, {k: v[0] for k, v in tree.items()}


def _flips(q_card, x_card, q_cpu, scale_card) -> int:
    """int8 ``q`` from the card: the rounding of the card's own ``x /
    scale`` but within 1e-5 of a half quantum, and within one of the CPU's
    ``q`` (a flip, where the card's and the CPU's factors straddle a half
    quantum). Returns the flips."""
    q_card, x_card, s = q_card.cpu(), x_card.cpu(), scale_card.cpu()
    t = x_card / s.reshape(s.shape + (1,) * (x_card.dim() - s.dim()))
    near = ((t - torch.round(t)).abs() - 0.5).abs() <= 1e-5
    mine = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
    assert not ((mine != q_card) & ~near).any()
    diff = (q_card.long() - q_cpu.long()).abs()
    assert diff.max() <= 1
    return int(diff.sum())


@pytest.mark.gpu
def test_codec_on_the_card_equals_the_cpu_and_never_syncs(record_property):
    """lowrank+int8 at rank 4 on a stack of 4 clients: the card's bases
    equal the CPU's bit for bit; the factors, the decode and the projected
    precision 1e-5 relative; q the rounding of the card's own factors,
    within one of the CPU's (flips recorded); with the round's bases
    cached, encode, decode and dequantize raise nothing under
    ``set_sync_debug_mode("error")``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fed = FedConfig(algorithm="fedlora", payload_codec="lowrank+int8",
                    lora_rank=4)
    codec = {d: build_codec(fed) for d in ("cuda", "cpu")}
    (x, like), (xc, likec) = _codec_stack("cuda"), _codec_stack("cpu")
    prec = tm.tmap(lambda a: a.abs() + 0.5, x)
    wire = codec["cuda"].encode(x, 3, like)
    want = codec["cpu"].encode(xc, 3, likec)
    lr = codec["cuda"].stages[0].encode(x, 3, like)
    lr_cpu = codec["cpu"].stages[0].encode(xc, 3, likec)
    flips = 0
    for k in x:
        torch.testing.assert_close(lr[k].cpu(), lr_cpu[k], rtol=1e-5,
                                   atol=1e-5 * float(lr_cpu[k].abs().max()))
        torch.testing.assert_close(wire[k]["scale"].cpu(),
                                   want[k]["scale"], rtol=1e-5, atol=0)
        assert wire[k]["scale"].shape == (4,)
        flips += _flips(wire[k]["q"], lr[k], want[k]["q"], wire[k]["scale"])
    record_property("flips", flips)
    for key, (basis, _) in codec["cuda"].stages[0]._cache[3].items():
        leaf, last_dim, _ = key
        assert torch.equal(basis.cpu(), codec["cpu"].stages[0]._basis(
            last_dim, 3, leaf, "cpu"))
    want_cuda = tm.tmap(lambda a: a.cuda(), want)
    dec = codec["cuda"].decode(want_cuda, 3, like)
    dec_cpu = codec["cpu"].decode(want, 3, likec)
    for k in x:
        torch.testing.assert_close(dec[k].cpu(), dec_cpu[k], rtol=1e-5,
                                   atol=1e-5 * float(dec_cpu[k].abs().max()))
    p = codec["cuda"].project_precision(prec, 3, like)
    p_cpu = codec["cpu"].project_precision(tm.tmap(lambda a: a.abs() + 0.5,
                                                   xc), 3, likec)
    for k in x:
        torch.testing.assert_close(p[k].cpu(), p_cpu[k], rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wire = codec["cuda"].encode(x, 3, like)
        codec["cuda"].decode(wire, 3, like)
        codec["cuda"].to_accum(want_cuda)
        codec["cuda"].encode_aux(codec["cuda"].project_precision(
            prec, 3, like), 3, like)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_fedlora_rounds_on_the_card_equal_the_cpu():
    """FedLoRA (lowrank at rank 2, error feedback, one burn-in round) on
    federated least squares with a (6, 8) weight, 4 rounds on the card and
    on the CPU: params and residuals 1e-4 relative, 1e-5 absolute; 3
    FedLoRA rounds x (l - 1) = 3 DP launches of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, data = make_federated_lsq(4, 50, 6, heterogeneity=2.0, seed=0)

    def batch_fn(cid, r, steps):
        X, y = data[cid]
        b = lsq_batches(X, y, 10, steps, seed=r * 131 + cid)
        return {"x": b["x"], "y": np.repeat(b["y"][..., None], 8, -1)}

    def loss(p, batch):
        r = batch["x"] @ p["w"] - batch["y"]
        return 0.5 * (r * r).mean()

    gv = torch.func.grad_and_value(loss)
    fed = FedConfig(algorithm="fedlora", payload_codec="lowrank",
                    lora_rank=2, clients_per_round=4, local_steps=6,
                    burn_in_steps=2, steps_per_sample=2, shrinkage_rho=0.5,
                    burn_in_rounds=1, server_opt="sgd", server_lr=0.1,
                    client_opt="sgd", client_lr=0.01)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for device in ("cuda", "cpu"):
            sim = FedSim(fed, lambda p, b: tuple(reversed(gv(p, b))),
                         batch_fn, num_clients=4, device=device)
            fedpa_dp.reset_launches()
            state, _ = sim.run({"w": torch.zeros(6, 8)}, 4)
            if device == "cuda":
                torch.cuda.synchronize()
                assert fedpa_dp.launches == {"dp_reduce": 3, "dp_map": 3}
            out[device] = (state, sim.client_store.state_dict())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (card, card_store), (cpu, cpu_store) = out["cuda"], out["cpu"]
    torch.testing.assert_close(card.params["w"].cpu(), cpu.params["w"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(card_store["stamps"], cpu_store["stamps"])
    np.testing.assert_allclose(card_store["buffers"]["w"],
                               cpu_store["buffers"]["w"], rtol=1e-4,
                               atol=1e-5)
