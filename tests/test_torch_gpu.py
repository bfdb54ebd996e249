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

from repro_torch.common.tree import tree_leaves
from repro_torch.configs import COVID_CNN
from repro_torch.core import trainer
from repro_torch.core.adapters import cnn_adapter
from repro_torch.data import make_covid_ct, split_clients
from repro_torch.kernels.dp_release import ops as dp_ops
from repro_torch.kernels.dp_release.ref import dp_release_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.privacy_conv import ops as pc_ops
from repro_torch.kernels.privacy_conv.ref import privacy_conv_banked_ref, privacy_conv_ref
from repro_torch.kernels.selective_scan import ops as ss_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.optim import adamw
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
# and not, B = 1 split (k 49) and not; and the LM cut of llama3.2-1b at
# seq 512 (3 rows of 1 Mi features, k 44)
@pytest.mark.parametrize("shape,clip,sigma,split,vec4", [
    ((64, 32, 32, 16), 1.0, 0.0, False, True), ((64, 32, 32, 16), 1.0, 9.7, False, True),
    ((8, 112, 112, 64), 1.0, 9.7, True, True), ((8, 112, 112, 64), 1.0, 0.0, True, True),
    ((2, 50001), 1.0, 9.7, True, False), ((2, 50001), 1e4, 0.0, True, False),
    ((5, 7), 1e4, 0.5, False, False), ((5, 7, 5), 1.0, 0.0, False, False),
    ((1, 112, 112, 64), 1.0, 9.7, True, True), ((1, 100), 1.0, 9.7, False, True),
    ((3, 512, 2048), 1.0, 9.7, True, True), ((3, 512, 2048), 1.0, 0.0, True, True)])
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


@pytest.mark.parametrize("sigma", [0.0, None])
def test_e2e_covid_step_kernels_against_plain(cuda, sigma):
    """One e2e training step of the full-width COVID-CT CNN (3 clients, 21
    rows each) with the kernels on against the same step with them off, on
    the same state, batch and noise: three ``privacy_conv`` launches (one a
    client) and one ``dp_release`` call over the 63 rows. chip_smoke.py's
    training gate: the metrics within 1e-4 (float32 sums in another order
    through the trunk and its backward); the gradient (AdamW's first moment
    after one step is 0.1 x the clipped gradient) within 1e-3 in relative
    L2 norm (a ReLU or max-pool decision the rounding flips moves one
    position's contribution). ``sigma`` None is the calibrated σ (ε = 1),
    whose noise drowns the features; σ 0 lets the loss follow them."""
    noise = {} if sigma is None else {"noise_scale": sigma}
    runs = {}
    for on in (True, False):
        adapter = cnn_adapter(dataclasses.replace(COVID_CNN, use_kernel=on))
        tc = trainer.SplitTrainConfig(server_batch=64, mode="e2e",
                                      privacy=DPConfig(clip_norm=1.0, use_kernel=on, **noise))
        init, step = trainer.make_spatio_temporal_step(adapter, tc, adamw(1e-3), device=cuda)
        state = init(torch.Generator().manual_seed(0))
        shards = split_clients(*make_covid_ct(210, hw=64, seed=0), shares=(0.7, 0.2, 0.1))
        xs, ys = trainer.stack_batches([(x[:21], y[:21]) for x, y in shards])
        g = torch.Generator().manual_seed(1)
        model_noise = torch.randn((3, 21, 32, 32, 16), generator=g).to(cuda)
        guard_noise = torch.randn((3, 21, 32, 32, 16), generator=g).to(cuda)
        pc0, dp0 = pc_ops.launches, dp_ops.launches
        new, metrics = step(state, xs.to(cuda), ys.to(cuda), model_noise, guard_noise)
        torch.cuda.synchronize()
        runs[on] = (new, metrics, pc_ops.launches - pc0, dp_ops.launches - dp0)
    (k_state, k_m, pc, dp), (p_state, p_m, pc_plain, dp_plain) = runs[True], runs[False]
    assert (pc, dp, pc_plain, dp_plain) == (3, 1, 0, 0)
    for k in p_m:
        torch.testing.assert_close(k_m[k], p_m[k], atol=1e-4, rtol=1e-4)
    k_grad, p_grad = k_state["opt"]["mu"] / 0.1, p_state["opt"]["mu"] / 0.1
    assert float((k_grad - p_grad).norm() / p_grad.norm()) <= 1e-3


# the banked launch of fleet production: the COVID-CT cycle (7/2/1 items of
# 21 rows), a generic Cin with float4, and the scalar variant
@pytest.mark.parametrize("N,b,H,W,cin,cout,scale,cids,banks", [
    (10, 21, 64, 64, 1, 16, 0.05, (0,) * 7 + (1,) * 2 + (2,), 3),
    (4, 3, 32, 32, 16, 32, 0.1, (2, 0, 1, 2), 3), (3, 2, 10, 14, 3, 5, 0.1, (1, 0, 1), 2)])
def test_privacy_conv_banked_kernel(cuda, N, b, H, W, cin, cout, scale, cids, banks):
    """One launch for N items, each on its bank: within TOL of the plain
    banked version, and bit for bit N unbanked launches."""
    g = torch.Generator().manual_seed(1)
    x, w = _randn(g, N, b, H, W, cin), _randn(g, banks, 3, 3, cin, cout, scale=0.1)
    bb, nz = _randn(g, banks, cout, scale=0.1), _randn(g, N, b, H // 2, W // 2, cout)
    c = torch.tensor(cids, dtype=torch.int32, device="cuda")
    before = pc_ops.launches
    got = pc_ops.privacy_conv_banked_forward(x, w, bb, c, nz, scale)
    torch.cuda.synchronize()
    assert pc_ops.launches == before + 1
    torch.testing.assert_close(got, privacy_conv_banked_ref(x, w, bb, c, nz, noise_scale=scale),
                               **TOL)
    items = torch.stack([pc_ops.privacy_conv_forward(x[n], w[k], bb[k], nz[n], scale)
                         for n, k in enumerate(cids)])
    assert torch.equal(got, items)


def test_privacy_conv_banked_refusals(cuda):
    """A bank index out of range writes NaN over its item (the kernel
    reads no bank past the stack); cids of another type or shape raise."""
    g = torch.Generator().manual_seed(2)
    x, w = _randn(g, 2, 3, 8, 8, 1), _randn(g, 2, 3, 3, 1, 4)
    bb, nz = _randn(g, 2, 4), _randn(g, 2, 3, 4, 4, 4)
    out = pc_ops.privacy_conv_banked_forward(
        x, w, bb, torch.tensor([1, 5], dtype=torch.int32, device="cuda"), nz, 0.1)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()
    with pytest.raises(ValueError, match="int32"):
        pc_ops.privacy_conv_banked_forward(x, w, bb, torch.tensor([0, 1], device="cuda"), nz, 0.1)
    with pytest.raises(ValueError, match=r"cids must be \[N=2\]"):
        pc_ops.privacy_conv_banked_forward(
            x, w, bb, torch.tensor([0], dtype=torch.int32, device="cuda"), nz, 0.1)


@pytest.mark.parametrize("engine", ["protocol-async", "fused-queue"])
def test_queue_engine_fleet_launches_and_bits(cuda, engine):
    """A narrow CNN through a queue engine on the card: the fleet launches
    one banked privacy_conv and one dp_release a production cycle and is
    bit for bit the per-item run, which launches one of each a release."""
    from repro_torch.core import SplitSession, SplitTrainConfig

    cfg = dataclasses.replace(COVID_CNN, input_hw=(16, 16), stages=((8, 1), (16, 1)),
                              dense_units=(8,), use_kernel=True)
    shards = split_clients(*make_covid_ct(60, hw=16, seed=0), shares=(0.7, 0.2, 0.1))
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for production in ("fleet", "per-item"):
            s = SplitSession(cnn_adapter(cfg),
                             SplitTrainConfig(server_batch=12,
                                              privacy=DPConfig(clip_norm=1.0, use_kernel=True)),
                             adamw(1e-3), engine=engine, device="cuda", threaded=False,
                             production=production)
            pc0, dp0 = pc_ops.launches, dp_ops.launches
            s.fit(shards, epochs=2, steps_per_epoch=5)
            runs[production] = (s, pc_ops.launches - pc0, dp_ops.launches - dp0)
    finally:
        torch.backends.cudnn.deterministic = False
    (f, fpc, fdp), (p, ppc, pdp) = runs["fleet"], runs["per-item"]
    items = sum(f.fault_stats["releases_per_client"])
    assert fpc == fdp == f.engine.fleet.dispatches and ppc == pdp == items
    assert f.engine.losses == p.engine.losses
    for a, b in zip(tree_leaves(f.state), tree_leaves(p.state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sigma", [0.0, None])
def test_fedavg_local_step_kernels_against_plain(cuda, sigma):
    """One FedAvg local step of the full-width COVID-CT CNN (a hospital's
    batch of 32, the whole model, the guard at the cut) with the kernels on
    against the same step with them off, on the same weights, batch and
    noise: one ``privacy_conv`` launch and one ``dp_release`` call (k = 1),
    and none in the backward. As test_e2e_covid_step_kernels_against_plain:
    the loss within 1e-4, the gradient (AdamW's first moment after one step
    is 0.1 x the clipped gradient) within 1e-3 in relative L2 norm.
    ``sigma`` None is the calibrated σ (ε = 1)."""
    from repro_torch.core import fedavg

    noise = {} if sigma is None else {"noise_scale": sigma}
    x, y = make_covid_ct(32, hw=64, seed=0)
    guard_noise = torch.randn((32, 32, 32, 16), generator=torch.Generator().manual_seed(1))
    runs = {}
    for on in (True, False):
        adapter = cnn_adapter(dataclasses.replace(COVID_CNN, use_kernel=on))
        tc = trainer.SplitTrainConfig(privacy=DPConfig(clip_norm=1.0, use_kernel=on, **noise))
        opt = adamw(1e-3)
        params = adapter.init(torch.Generator().manual_seed(0), cuda)
        pc0, dp0 = pc_ops.launches, dp_ops.launches
        _, state, loss = fedavg.make_local_sgd(adapter, tc, opt)(
            params, opt.init(params), torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda),
            torch.zeros((), dtype=torch.int32, device=cuda), guard_noise.to(cuda))
        torch.cuda.synchronize()
        runs[on] = (state, loss, pc_ops.launches - pc0, dp_ops.launches - dp0)
    (k_state, k_loss, pc, dp), (p_state, p_loss, pc_plain, dp_plain) = runs[True], runs[False]
    assert (pc, dp, pc_plain, dp_plain) == (1, 1, 0, 0)
    torch.testing.assert_close(k_loss, p_loss, atol=1e-4, rtol=1e-4)
    k_grad, p_grad = (torch.cat([a.reshape(-1) for a in tree_leaves(s["mu"])]) / 0.1
                      for s in (k_state, p_state))
    assert float((k_grad - p_grad).norm() / p_grad.norm()) <= 1e-3


def test_attack_step_kernel_against_plain(cuda):
    """One inversion-attack step (``privacy.audit.invert_features``) on four
    full-width COVID-CT images through the client stage with
    ``privacy_conv`` against the plain stage, from the same x and target:
    one kernel launch (the backward recomputes through the plain version),
    the loss within 1e-5, and the next x within 1e-5 except where the two
    ``sign(g)`` differ, where an element parts by at most 2 x lr x 0.01
    (1e-3) plus 1e-5; at most 0.1% of the elements may do so (a flip needs
    a gradient within rounding of 0)."""
    from repro_torch.privacy.audit import invert_features

    x = torch.from_numpy(make_covid_ct(4, hw=64, seed=2)[0]).to(cuda)
    x0 = (0.5 + 0.01 * torch.randn(tuple(x.shape),
                                   generator=torch.Generator().manual_seed(0))).to(cuda)
    params = cnn_adapter(COVID_CNN).init(torch.Generator().manual_seed(0), cuda)["client"]
    fwds = {on: (lambda z, a=cnn_adapter(dataclasses.replace(COVID_CNN, use_kernel=on)):
                 a.client_forward(params, z, None)) for on in (True, False)}
    with torch.no_grad():
        target = fwds[False](x) + 0.1
    out = {}
    for on, fwd in fwds.items():
        pc0 = pc_ops.launches
        nxt = invert_features(fwd, target, x.shape, steps=1, x0=x0)
        with torch.no_grad():
            loss = torch.mean(torch.square(fwd(x0) - target))
        torch.cuda.synchronize()
        out[on] = (nxt, loss, pc_ops.launches - pc0)
    (k_x, k_loss, k_n), (p_x, p_loss, p_n) = out[True], out[False]
    assert (k_n, p_n) == (2, 0)  # the step's forward and the loss above
    torch.testing.assert_close(k_loss, p_loss, atol=1e-5, rtol=1e-5)
    err = (k_x - p_x).abs()
    parted = err > 1e-5 + 1e-5 * p_x.abs()
    assert int(parted.sum()) <= x.numel() // 1000
    assert float(err.max()) <= 2 * 0.05 * 0.01 + 1e-5
    assert not torch.equal(k_x, x0)


def test_llm_split_detached_step_kernel_against_plain(cuda):
    """One detached ``llm-split`` step at llama3.2-1b's width (d 2048,
    vocab 128,256; two layers, so the trunk is one block and the untied
    head), three clients of one 512-token window, the clipped guard at the
    calibrated σ through ``dp_release`` (one call over the ``[3, 512,
    2048]`` cut) against the plain guard, from one state and noise: the
    loss within 1e-4 and the gradient within 1e-3 in relative L2 norm, as
    chip_smoke.py's gate."""
    import dataclasses as dc

    from repro_torch.common.tree import ravel
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as td
    from repro_torch.models.transformer import ModelOptions

    cfg = dc.replace(get_config("llama3.2-1b"), n_layers=2)
    opts = ModelOptions(q_block=512, kv_block=512)
    banks, server = td.init_llm_params(torch.Generator(device=cuda).manual_seed(0), cfg, 3,
                                       torch.float32, device=cuda)
    flat, unravel = ravel(server)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (3, 1, 512), generator=g).to(cuda)
    guard_noise = torch.randn((3, 1, 512, 2048), generator=g).to(cuda)
    out = {}
    for on in (True, False):
        parts = td.llm_step_parts(cfg, opts, adamw(1e-3), 3,
                                  privacy=DPConfig(clip_norm=1.0, use_kernel=on))
        calls = sum(dp_ops.plans.values())
        grad, metrics = parts.grad(flat, unravel, banks, {"tokens": toks, "labels": toks},
                                   None, guard_noise)
        torch.cuda.synchronize()
        out[on] = (grad, metrics, sum(dp_ops.plans.values()) - calls)
    (k_grad, k_m, k_calls), (p_grad, p_m, p_calls) = out[True], out[False]
    assert (k_calls, p_calls) == (1, 0)
    for k in p_m:
        torch.testing.assert_close(k_m[k], p_m[k], atol=1e-4, rtol=1e-4)
    assert float((k_grad - p_grad).norm() / p_grad.norm()) <= 1e-3


def test_llm_split_session_weights_are_the_cpus(cuda):
    """One seed gives ``SplitSession(engine="llm-split")`` the same weights
    on the card as on the CPU (a reduced llama3.2-1b): the draws come from a
    CPU generator and move."""
    from repro_torch.configs import get_config
    from repro_torch.core import SplitSession, SplitTrainConfig
    from repro_torch.core import distributed as td
    from repro_torch.models.transformer import ModelOptions

    adapter = td.llm_adapter(get_config("llama3.2-1b").reduced(), ModelOptions(),
                             torch.float32)
    tc = SplitTrainConfig(n_clients=3, data_shares=(0.7, 0.2, 0.1), server_batch=3,
                          privacy=DPConfig(clip_norm=1.0, use_kernel=True))
    card, cpu = (SplitSession(adapter, tc, adamw(1e-3), engine="llm-split", seed=2, device=d)
                 for d in (cuda, "cpu"))
    assert all(torch.equal(a.cpu(), b)
               for a, b in zip(tree_leaves(card.state), tree_leaves(cpu.state)))


def _within_one_ulp(got, want, dtype):
    """|got - want| within one ulp of the half type (at the larger of the
    two values) beyond TOL: each side rounds a float32 value once, and the
    float32 values part by up to TOL (cuDNN's conv algorithm), more than an
    ulp of a value that the noise all but cancels."""
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    floor = 2.0 ** (-24 if dtype == torch.float16 else -133)
    g, w = got.float(), want.float()

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - mant
                          ).clamp(min=floor)

    one = torch.maximum(ulp(g), ulp(w))
    return bool(((g - w).abs() <= one + TOL["atol"] + TOL["rtol"] * w.abs()).all())


# the half types take the scalar path of each kernel: privacy_conv's Cin 1
# and generic variants, dp_release one block a row and a split row, each
# with and without noise
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["conv_cin1", "conv_generic", "release_rows",
                                  "release_split", "release_split_sigma0"])
def test_serving_kernels_take_the_half_types(cuda, dtype, case):
    """bfloat16 and float16 in and out, float32 sums: within one ulp of the
    type beyond TOL of the plain version (which computes in float32 and
    rounds once), and the same bits on a relaunch."""
    g = torch.Generator().manual_seed(7)
    if case.startswith("conv"):
        shape = (8, 64, 64, 1, 16) if case == "conv_cin1" else (2, 34, 16, 20, 12)
        B, H, W, cin, cout = shape
        x, w = _randn(g, B, H, W, cin).to(dtype), _randn(g, 3, 3, cin, cout, scale=0.3).to(dtype)
        b, nz = _randn(g, cout, scale=0.1).to(dtype), _randn(g, B, H // 2, W // 2, cout).to(dtype)
        plan = pc_ops.plan_for(x, w, nz, 0.05)
        assert plan["dtype"] == str(dtype).removeprefix("torch.") and not plan["vec4"]
        fn = lambda: pc_ops.privacy_conv_forward(x, w, b, nz, 0.05)  # noqa: E731
        want = privacy_conv_ref(x, w, b, nz, noise_scale=0.05)
    else:
        shape = (64, 32, 32, 16) if case == "release_rows" else (3, 512, 2048)
        sigma = 0.0 if case.endswith("sigma0") else 9.7
        x, nz = _randn(g, *shape).to(dtype), _randn(g, *shape).to(dtype)
        plan = dp_ops.plan_for(x, nz, sigma)
        assert (plan["blocks_per_row"] > 1) == (case != "release_rows") and not plan["vec4"]
        fn = lambda: dp_ops.dp_release_forward(x, nz, 1.0, sigma)  # noqa: E731
        want = dp_release_ref(x, nz, clip_norm=1.0, sigma=sigma)
    got, again = fn(), fn()
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, again)
    assert _within_one_ulp(got, want, dtype)


def test_half_kernels_refuse_mixed_types(cuda):
    x = torch.randn(2, 8, 8, 1, device=cuda).bfloat16()
    w, b = torch.randn(3, 3, 1, 4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="one type"):
        pc_ops.privacy_conv_forward(x, w, b, None, 0.0)
    with pytest.raises(ValueError, match="one type"):
        dp_ops.dp_release_forward(x, x.half(), 1.0, 1.0)
    with pytest.raises(ValueError, match="float32\\)"):  # the banked launch is float32 alone
        pc_ops.privacy_conv_banked_forward(x[None], w[None].bfloat16(), b[None].bfloat16(),
                                           torch.zeros(1, dtype=torch.int32, device=cuda),
                                           None, 0.0)


@pytest.mark.parametrize("arch,cf", [("granite-moe-1b-a400m", 1.25),
                                     ("granite-moe-1b-a400m", 1.0), ("mixtral-8x7b", 1.25)])
def test_moe_layer_on_the_card_against_the_cpu(cuda, arch, cf):
    """``moe_forward`` on the card against the CPU (reduced widths, 96
    tokens; at capacity factor 1 tokens are dropped): the same routing,
    the output, aux and gradients within 1e-5; the card bit-equal from call
    to call (the combine has no atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(arch).reduced(), capacity_factor=cf)
    params = moe.init_moe(torch.Generator().manual_seed(3), cfg, torch.float32)
    x = torch.randn((4, 24, cfg.d_model), generator=torch.Generator().manual_seed(4))
    out = {}
    for dev in ("cpu", cuda, cuda):
        leaves = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        xx = x.to(dev).requires_grad_()
        _, (dest, _, _, _), _ = moe._route_and_dispatch(leaves["router"], cfg,
                                                        xx.reshape(-1, cfg.d_model).float())
        y, aux = moe.moe_forward(leaves, cfg, xx)
        grads = torch.autograd.grad(y.square().mean() + aux, [xx] + list(leaves.values()))
        out.setdefault(str(dev), []).append([dest, y, aux, *grads])
    (cpu,), (card, again) = out["cpu"], out[str(cuda)]
    assert all(torch.equal(a, b) for a, b in zip(card, again))
    assert torch.equal(card[0].cpu(), cpu[0])
    for a, b in zip(card[1:], cpu[1:]):
        torch.testing.assert_close(a.cpu(), b, **TOL)


def test_ssm_layer_on_the_card_against_the_cpu(cuda):
    """``ssm_forward`` (both scans) and twelve decode steps on the card
    against the CPU, reduced falcon-mamba-7b: the output and gradients
    within 1e-5 (the associative scan at 1e-4 / 1e-3, the reference
    test's), the decode state too."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("falcon-mamba-7b").reduced()
    params = ssm.init_ssm(torch.Generator().manual_seed(5), cfg, torch.float32)
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(6))
    for assoc, tol in ((False, TOL), (True, dict(atol=1e-4, rtol=1e-3))):
        res = []
        for dev in ("cpu", cuda):
            leaves = {k: v.to(dev).requires_grad_() for k, v in params.items()}
            xx = x.to(dev).requires_grad_()
            y = ssm.ssm_forward(leaves, cfg, xx, associative=assoc)
            res.append([y, *torch.autograd.grad(y.square().mean(),
                                                [xx] + list(leaves.values()))])
        for a, b in zip(res[1], res[0]):
            torch.testing.assert_close(a.cpu(), b, **tol)
    states = []
    with torch.no_grad():
        for dev in ("cpu", cuda):
            p = {k: v.to(dev) for k, v in params.items()}
            st, ys = ssm.init_ssm_state(cfg, 2, device=dev), []
            for t in range(12):
                y, st = ssm.ssm_decode_step(p, cfg, x[:, t:t + 1].to(dev), st)
                ys.append(y)
            states.append([torch.cat(ys, 1), st["conv"], st["h"]])
    for a, b in zip(states[1], states[0]):
        torch.testing.assert_close(a.cpu(), b, **TOL)
