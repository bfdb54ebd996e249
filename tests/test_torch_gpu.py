"""The CUDA kernels against their plain versions on the card. Marked ``gpu``:
without a card every test skips with the reason. This file imports neither
``jax`` nor ``repro``, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance 1e-5 absolute and relative for the serving kernels, with TF32 off
for the cuDNN conv of the plain version: float32 sums in another order. The
LM kernels: attention 2e-5 in float32, the JAX suite's (tests/test_kernels.py:19;
sums in another order); in bfloat16 atol 2e-3, rtol 1.6e-2, two bfloat16 ulps
(both sides compute in float32 and round the output to bfloat16, so they
differ where the float32 values straddle a rounding boundary); the scan atol
1e-5, rtol 1e-4 (tests/test_kernels.py:110; the sum over states in another
order, through the recurrence).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import COVID_CNN
from repro_torch.core.adapters import cnn_adapter
from repro_torch.data import make_covid_ct, split_clients
from repro_torch.kernels.dp_release import ops as dp_ops
from repro_torch.kernels.dp_release.ref import dp_release_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.privacy_conv import ops as pc_ops
from repro_torch.kernels.privacy_conv.ref import privacy_conv_ref
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.privacy import DPConfig, PrivacyGuard
from repro_torch.serving import SplitInferenceServer, poisson_trace

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=2e-3, rtol=1.6e-2)}
SCAN_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).cuda()


# every variant conv_plan chooses, (Cin variant, float4): (1, yes) COVID-CT,
# (generic, yes) TABLE1's Cin 3, Cin 16 and Cin 40 (three chunks of input
# channels, three channel blocks), (generic, no) Cin 3 with Cout 5, Cin 20
# and the smallest shape, (1, no) Cout 6; H and W off the 16-pixel tile
@pytest.mark.parametrize("B,H,W,cin,cout,scale,variant", [
    (64, 64, 64, 1, 16, 0.05, (1, True)), (64, 32, 32, 3, 16, 0.05, (0, True)),
    (8, 32, 32, 16, 32, 0.0, (0, True)), (2, 34, 16, 40, 36, 0.1, (0, True)),
    (3, 10, 14, 3, 5, 0.1, (0, False)), (2, 18, 22, 1, 6, 0.1, (1, False)),
    (2, 12, 20, 20, 7, 0.1, (0, False)), (1, 2, 2, 2, 1, 0.0, (0, False))])
def test_privacy_conv_kernel(cuda, B, H, W, cin, cout, scale, variant):
    g = torch.Generator().manual_seed(0)
    x, w = _randn(g, B, H, W, cin), _randn(g, 3, 3, cin, cout, scale=0.1)
    b, nz = _randn(g, cout, scale=0.1), _randn(g, B, H // 2, W // 2, cout)
    plan = pc_ops.plan_for(x, w, nz, scale)
    assert (plan["cin_variant"], plan["vec4"]) == variant
    before = pc_ops.launches
    got = pc_ops.privacy_conv_forward(x, w, b, nz, scale)
    torch.cuda.synchronize()
    assert pc_ops.launches == before + 1
    torch.testing.assert_close(got, privacy_conv_ref(x, w, b, nz, noise_scale=scale), **TOL)


def test_privacy_conv_other_plans_and_refusals(cuda):
    """The generic variant at Cin 1 (what chip_smoke.py times the Cin = 1
    variant against) and a misaligned noise view (scalar) agree with the
    plain version; a plan that does not fit the shape raises."""
    g = torch.Generator().manual_seed(5)
    x, w, b = _randn(g, 4, 24, 40, 1), _randn(g, 3, 3, 1, 16, scale=0.1), _randn(g, 16)
    nz = _randn(g, 4 * 12 * 20 * 16 + 1)[1:].view(4, 12, 20, 16)
    assert nz.data_ptr() % 16 == 4 and not pc_ops.plan_for(x, w, nz, 0.1)["vec4"]
    want = privacy_conv_ref(x, w, b, nz, noise_scale=0.1)
    torch.testing.assert_close(pc_ops.privacy_conv_forward(x, w, b, nz, 0.1), want, **TOL)
    generic = {**pc_ops.conv_plan(4, 24, 40, 1, 16), "cin_variant": 0}
    nz = nz.clone()
    torch.testing.assert_close(pc_ops._launch(x, w, b, nz, 0.1, generic), want, **TOL)
    for bad in ({"cin_variant": 3}, {"channels_per_block": 6}, {"channels_per_block": 32}):
        with pytest.raises(RuntimeError, match="launch failed"):
            pc_ops._launch(x, w, b, nz, 0.1, {**generic, **bad})
    with pytest.raises(RuntimeError, match="launch failed"):  # float4 with Cout 6
        w6, b6 = w[..., :6].contiguous(), b[:6].contiguous()
        pc_ops._launch(x, w6, b6, None, 0.0, {**generic, "vec4": True, "channels_per_block": 8})


# every plan release_plan chooses, (k > 1, float4), each with and without
# noise: the serving cut (k 1), the MURA cut (k 17), F % 4 != 0 split (k 3)
# and not, B = 1 split (k 49) and not
@pytest.mark.parametrize("shape,clip,sigma,split,vec4", [
    ((64, 32, 32, 16), 1.0, 0.0, False, True), ((64, 32, 32, 16), 1.0, 9.7, False, True),
    ((8, 112, 112, 64), 1.0, 9.7, True, True), ((8, 112, 112, 64), 1.0, 0.0, True, True),
    ((2, 50001), 1.0, 9.7, True, False), ((2, 50001), 1e4, 0.0, True, False),
    ((5, 7), 1e4, 0.5, False, False), ((5, 7, 5), 1.0, 0.0, False, False),
    ((1, 112, 112, 64), 1.0, 9.7, True, True), ((1, 100), 1.0, 9.7, False, True)])
def test_dp_release_kernel(cuda, shape, clip, sigma, split, vec4):
    g = torch.Generator().manual_seed(1)
    x, nz = _randn(g, *shape), _randn(g, *shape)
    plan = dp_ops.plan_for(x, nz, sigma)
    assert (plan["blocks_per_row"] > 1, plan["vec4"]) == (split, vec4)
    before = dp_ops.launches
    got = dp_ops.dp_release_forward(x, nz, clip, sigma)
    again = dp_ops.dp_release_forward(x, nz, clip, sigma)
    torch.cuda.synchronize()
    assert dp_ops.launches == before + 2 * plan["launches"]
    assert torch.equal(got, again)  # partials combined in a fixed order
    torch.testing.assert_close(got, dp_release_ref(x, nz, clip_norm=clip, sigma=sigma), **TOL)


def test_dp_release_other_plans_and_refusals(cuda):
    """One block a row at the MURA cut and a split at the serving cut (what
    chip_smoke.py times each plan against), and a misaligned view (scalar),
    agree with the plain version; a plan that does not fit raises."""
    g = torch.Generator().manual_seed(6)
    for shape, k in (((8, 112, 112, 64), 1), ((64, 32, 32, 16), 3)):
        x, nz = _randn(g, *shape), _randn(g, *shape)
        feats = x[0].numel()
        chunk = 4 * -(-feats // (4 * k))
        plan = {**dp_ops.plan_for(x, nz, 9.7), "blocks_per_row": k, "chunk": chunk}
        torch.testing.assert_close(dp_ops._launch(x, nz, 1.0, 9.7, plan),
                                   dp_release_ref(x, nz, clip_norm=1.0, sigma=9.7), **TOL)
    x = _randn(g, 3 * 40000 + 1)[1:].view(3, 40000)
    assert x.data_ptr() % 16 == 4 and not dp_ops.plan_for(x, None, 0.0)["vec4"]
    torch.testing.assert_close(dp_ops.dp_release_forward(x, None, 1.0),
                               dp_release_ref(x, None, clip_norm=1.0), **TOL)
    x = x.clone()
    good = dp_ops.plan_for(x, None, 0.0)
    for bad in ({"vec4": True, "chunk": 20001}, {"blocks_per_row": 1, "chunk": 100},
                {"blocks_per_row": 5, "chunk": 20000}):
        with pytest.raises(RuntimeError, match="launch failed"):
            dp_ops._launch(x, None, 1.0, 0.0, {**good, **bad})


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(2, 8, 8, 1, device=cuda)
    w, b = torch.randn(3, 3, 1, 4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        pc_ops.privacy_conv_forward(x.double(), w, b, None, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        dp_ops.dp_release_forward(x.transpose(1, 2), None, 1.0)


def test_serve_launches_each_kernel_once_per_release(cuda):
    cfg = dataclasses.replace(COVID_CNN, use_kernel=True)
    ad = cnn_adapter(cfg)
    g = torch.Generator().manual_seed(0)
    state = {"client_banks": [ad.init(g, cuda)["client"] for _ in range(3)],
             "server": ad.init(g, cuda)["server"], "step": 0}
    shards = split_clients(*make_covid_ct(48, hw=64, seed=0))
    before = (pc_ops.launches, dp_ops.launches)
    rep = SplitInferenceServer(ad, state, guard=PrivacyGuard(DPConfig(use_kernel=True)),
                               request_batch=4, device=cuda).serve(
        poisson_trace(3, rate=2.0, horizon=6, seed=0), shards)
    releases = sum(rep.releases_per_client)
    assert releases == rep.offered > 0
    assert (pc_ops.launches - before[0], dp_ops.launches - before[1]) == (releases, releases)
    assert all(np.isfinite(r).all() for r in rep.responses.values())


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,dtype", [
    (2, 64, 4, 4, 64, True, 0, torch.float32),
    (2, 100, 8, 2, 80, True, 0, torch.bfloat16),     # ragged tail, GQA, hd 80
    (1, 130, 4, 1, 128, False, 0, torch.float32),    # bidirectional, ragged
    (2, 200, 4, 2, 32, True, 24, torch.float32),     # window: fully masked first tiles
    (1, 150, 2, 2, 80, False, 40, torch.float32),    # bidirectional window, hd 80
    (1, 257, 8, 8, 32, True, 0, torch.bfloat16),     # ragged by one row
    (1, 300, 4, 2, 128, True, 64, torch.bfloat16)])  # window in bfloat16
def test_flash_attention_kernel(cuda, B, S, H, KV, hd, causal, window, dtype):
    g = torch.Generator().manual_seed(2)
    q = _randn(g, B, S, H, hd).to(dtype)
    k, v = (_randn(g, B, S, KV, hd).to(dtype) for _ in range(2))
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ops.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("Bsz,S,di,st,d_tile,t_chunk,init_a", [
    (2, 32, 64, 8, 32, 8, False),
    (1, 17, 64, 16, 64, 5, True),      # ragged time chunk, A and D as init_ssm
    (2, 100, 130, 16, 128, 64, True),  # di not a multiple of the block's channels
    (1, 40, 48, 40, 16, 7, False),     # st 40: two states a lane
    (3, 9, 5, 1, 128, 64, False)])     # st 1: one lane a channel
def test_selective_scan_kernel(cuda, Bsz, S, di, st, d_tile, t_chunk, init_a):
    g = torch.Generator().manual_seed(3)
    u = _randn(g, Bsz, S, di)
    dt = torch.nn.functional.softplus(_randn(g, Bsz, S, di) * 0.5 - 1)
    B, C = _randn(g, Bsz, S, st), _randn(g, Bsz, S, st)
    if init_a:
        A = -torch.arange(1, st + 1, dtype=torch.float32, device=cuda)[None].repeat(di, 1)
        D = torch.ones(di, device=cuda)
    else:
        A = -torch.exp(_randn(g, di, st, scale=0.3))
        D = _randn(g, di)
    before = ss_ops.launches
    got = ss_ops.selective_scan(u, dt, B, C, A, D, d_tile=d_tile, t_chunk=t_chunk)
    torch.cuda.synchronize()
    assert ss_ops.launches == before + 1
    torch.testing.assert_close(got, selective_scan_ref(u, dt, B, C, A, D), **SCAN_TOL)


def test_lm_kernels_are_forward_only_and_refuse_what_they_do_not_take(cuda):
    q = torch.randn(1, 8, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        fa_ops.flash_attention(q, k, k)
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, k).shape == q.shape
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(*(torch.randn(1, 8, 2, 72, device=cuda) for _ in range(3)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_ops.flash_attention(*(torch.randn(1, 8, 2, 64, device=cuda).half()
                                 for _ in range(3)))
    u = torch.randn(1, 4, 8, device=cuda, requires_grad=True)
    rest = (torch.rand(1, 4, 8, device=cuda), torch.randn(1, 4, 2, device=cuda),
            torch.randn(1, 4, 2, device=cuda), -torch.ones(8, 2, device=cuda),
            torch.ones(8, device=cuda))
    with pytest.raises(RuntimeError, match="forward only"):
        ss_ops.selective_scan(u, *rest)
    with pytest.raises(ValueError, match="float32"):
        ss_ops.selective_scan(u.detach().double(), *rest)


def _attention_case(g, B, S, H, KV, hd, dtype):
    q = _randn(g, B, S, H, hd).to(dtype)
    k, v = (_randn(g, B, S, KV, hd).to(dtype) for _ in range(2))
    return q, k, v


# (causal, window) of the three masks; S shorter than a 64-row tile, a tile
# exactly, one row past it, and several tiles with a ragged tail
_MASKS = {"causal": (True, 0), "window": (True, 24), "bidirectional": (False, 0),
          "bidirectional_window": (False, 40)}
_SEQS = (1, 17, 64, 65, 300)


@pytest.mark.parametrize("S", _SEQS)
@pytest.mark.parametrize("mask", ["causal", "window", "bidirectional"])
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_flash_attention_bf16_tensor_core_kernel(cuda, hd, mask, S):
    """The bfloat16 kernel (mma.sync) against the plain version at every
    head dim, mask and sequence length, with GQA ratios 1, 4 and 8."""
    causal, window = _MASKS[mask]
    G = (1, 4, 8)[(hd // 16 + len(mask) + S) % 3]
    g = torch.Generator().manual_seed(hd * 1000 + S)
    q, k, v = _attention_case(g, 2, S, 2 * G, 2, hd, torch.bfloat16)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ops.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_flash_attention_bf16_other_tile(cuda, hd, mask):
    """The tile the kernel does not pick for itself (128 query rows, 8 warps),
    which chip_smoke.py times against its choice, gives the same answers."""
    causal, window = _MASKS[mask]
    g = torch.Generator().manual_seed(hd)
    q, k, v = _attention_case(g, 2, 300, 8, 2, hd, torch.bfloat16)
    with torch.no_grad():
        got = fa_ops._launch(q, k, v, causal, window, q_rows=128)
    torch.cuda.synchronize()
    want = fa_ops.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("st,lanes", [(1, None), (5, None), (16, None), (16, 16), (40, None),
                                      (128, None)])
def test_selective_scan_lanes_and_states(cuda, st, lanes):
    """Every lane and state instantiation, with a ragged time chunk (S 37 in
    chunks of 8 steps, rounded up to whole groups of lanes) and di 200, not a
    multiple of the block's channels."""
    g = torch.Generator().manual_seed(st)
    Bsz, S, di = 2, 37, 200
    u = _randn(g, Bsz, S, di)
    dt = torch.nn.functional.softplus(_randn(g, Bsz, S, di) * 0.5 - 1)
    B, C = _randn(g, Bsz, S, st), _randn(g, Bsz, S, st)
    A = -torch.exp(_randn(g, di, st, scale=0.3))
    D = _randn(g, di)
    with torch.no_grad():
        got = ss_ops._launch(u, dt, B, C, A, D, 48, 8, lanes=lanes)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, selective_scan_ref(u, dt, B, C, A, D), **SCAN_TOL)


def test_redesigned_kernels_refuse_what_they_do_not_take(cuda):
    """The bfloat16 attention kernel copies 16 bytes at a time: a view that
    starts 8 bytes into its storage raises rather than reads astray; a tile
    or lane count the kernels were not built for raises too."""
    n = 1 * 8 * 2 * 64
    base = torch.randn(n + 4, device=cuda).bfloat16()
    q = base[4:].view(1, 8, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16 bytes"):
        fa_ops.flash_attention(q, q, q)
    ok = torch.randn(1, 8, 2, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="q_rows"):
        fa_ops._launch(ok, ok, ok, True, 0, q_rows=32)
    with pytest.raises(ValueError, match="q_rows"):
        fa_ops._launch(ok.float(), ok.float(), ok.float(), True, 0, q_rows=128)
    u = torch.randn(1, 4, 8, device=cuda)
    rest = (torch.rand(1, 4, 8, device=cuda), torch.randn(1, 4, 40, device=cuda),
            torch.randn(1, 4, 40, device=cuda), -torch.ones(8, 40, device=cuda),
            torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="lanes"):
        ss_ops._launch(u, *rest, 128, 64, lanes=4)  # 4 lanes hold at most 16 states
