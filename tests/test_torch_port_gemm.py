"""The GEMM under K1/K2/K4/K5 (eventpretrain_tpu_torch/csrc/ln_gemm.cu) on
the CPU: its plain version in every layout and epilogue against the
sub-blocks' plain functions it composes, the CUDA paths' composition (the
LayerNorm rows first, the weight gradients' token split and its in-order
sum) with the launchers replaced by their plain versions, the split planner,
and the shape checks at every width the sub-blocks' gates admit.

Everything here is PyTorch on the CPU at small sizes; the kernel itself is
held against the same plain version on the card by chip_smoke.py.
"""

import itertools

import numpy as np
import pytest
import torch

from eventpretrain_tpu_torch.ops import common as cm
from eventpretrain_tpu_torch.ops import fused_attn_layer as ka
from eventpretrain_tpu_torch.ops import fused_mlp as km

from tests._port_threads import one_torch_thread  # noqa: F401

DTYPES = [torch.float32, torch.bfloat16]
# f32: the same products, sums in another order (the token split). bf16:
# the same rounding points, so a rounded intermediate may land one ulp
# apart: 2% of the output's scale, as the sub-block tests hold it.
REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _t(rng, *shape, dtype, std=1.0):
    return torch.from_numpy(rng.normal(size=shape) * std).to(dtype)


def _close(got, want, dtype, what=""):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.isfinite(got).all(), what
    err = (got - want).abs().max().item()
    assert err <= REL[dtype] * max(want.abs().max().item(), 1e-30), (what,
                                                                      err)


def _attn_inputs(rng, b, l, c, dtype):
    return dict(
        x=_t(rng, b, l, c, dtype=dtype),
        g=torch.from_numpy(1.0 + 0.1 * rng.normal(size=c)).float(),
        beta=torch.from_numpy(0.1 * rng.normal(size=c)).float(),
        wqkv=_t(rng, 3 * c, c, dtype=dtype, std=c ** -0.5),
        bqkv=_t(rng, 3 * c, dtype=dtype, std=0.1),
        wo=_t(rng, c, c, dtype=dtype, std=c ** -0.5),
        bo=_t(rng, c, dtype=dtype, std=0.1),
        dy=_t(rng, b, l, c, dtype=dtype),
    )


def _mlp_inputs(rng, b, l, c, dtype):
    a = _attn_inputs(rng, b, l, c, dtype)
    return dict(
        x=a["x"], g=a["g"], beta=a["beta"], dy=a["dy"],
        w1=_t(rng, 4 * c, c, dtype=dtype, std=c ** -0.5),
        b1=_t(rng, 4 * c, dtype=dtype, std=0.1),
        w2=_t(rng, c, 4 * c, dtype=dtype, std=(4 * c) ** -0.5),
        b2=_t(rng, c, dtype=dtype, std=0.1),
    )


# ----------------------------------------------------------- plain GEMM


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_gemm_composes_the_attention_layer(dtype):
    """qkv (forward, bias), the core, proj (forward, bias): the plain GEMM
    composes ``_layer_reference`` exactly, rounding where it rounds."""
    rng = np.random.default_rng(1)
    b, l, c, h = 2, 10, 128, 4
    a = _attn_inputs(rng, b, l, c, dtype)
    scale = (c // h) ** -0.5
    u2 = a["x"].view(b * l, c)
    qkv = cm.gemm_reference(u2, a["wqkv"], layout=cm.LAYOUT_FORWARD,
                            bias=a["bqkv"])
    o = ka.attention_core_reference(qkv, b, l, h, scale)
    y = cm.gemm_reference(o, a["wo"], layout=cm.LAYOUT_FORWARD,
                          epilogue=cm.EPI_BIAS, bias=a["bo"])
    want = ka._layer_reference(a["x"], a["wqkv"], a["bqkv"], a["wo"],
                               a["bo"], h, scale).to(dtype)
    assert torch.equal(y.view(b, l, c), want)
    # the residual epilogue is K1's ``x + y`` rounded once
    yr = cm.gemm_reference(o, a["wo"], layout=cm.LAYOUT_FORWARD,
                           epilogue=cm.EPI_BIAS_RESIDUAL, bias=a["bo"],
                           residual=u2)
    want_r = (a["x"].float() + ka._layer_reference(
        a["x"], a["wqkv"], a["bqkv"], a["wo"], a["bo"], h, scale)).to(dtype)
    assert torch.equal(yr.view(b, l, c), want_r)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("du_epilogue", [cm.EPI_F32, cm.EPI_BIAS],
                         ids=["du_f32", "du_rounded"])
def test_plain_gemm_composes_the_attention_layer_backward(dtype, du_epilogue):
    """dWo and dWqkv (wgrad), do (dgrad, rounded), du (dgrad: f32 for K1,
    rounded for K4) against ``_layer_bwd_reference``."""
    rng = np.random.default_rng(2)
    b, l, c, h = 2, 12, 128, 4
    a = _attn_inputs(rng, b, l, c, dtype)
    scale = (c // h) ** -0.5
    u2, dy2 = a["x"].view(b * l, c), a["dy"].view(b * l, c)
    qkv = cm.gemm_reference(u2, a["wqkv"], layout=cm.LAYOUT_FORWARD,
                            bias=a["bqkv"])
    o = ka.attention_core_reference(qkv, b, l, h, scale)
    dwo = cm.gemm_reference(dy2, o, layout=cm.LAYOUT_WGRAD)
    do = cm.gemm_reference(dy2, a["wo"], layout=cm.LAYOUT_DGRAD)
    dqkv = ka.attention_core_bwd_reference(qkv, do, b, l, h, scale)
    dwqkv = cm.gemm_reference(dqkv, u2, layout=cm.LAYOUT_WGRAD)
    du = cm.gemm_reference(dqkv, a["wqkv"], layout=cm.LAYOUT_DGRAD,
                           epilogue=du_epilogue)
    want = ka._layer_bwd_reference(a["x"], a["wqkv"], a["bqkv"], a["wo"],
                                   a["dy"], h, scale)
    want_du = want[0].view(b * l, c)
    if du_epilogue == cm.EPI_BIAS:
        want_du = want_du.to(dtype)
    assert du.dtype == want_du.dtype
    assert torch.equal(du, want_du)
    assert torch.equal(dwqkv, want[1])
    assert torch.equal(dwo, want[3])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_gemm_composes_the_mlp(dtype):
    """fc1 (bias+GELU) then fc2 (bias) against ``_mlp_reference``."""
    rng = np.random.default_rng(3)
    b, l, c = 2, 9, 128
    a = _mlp_inputs(rng, b, l, c, dtype)
    u2 = a["x"].view(b * l, c)
    hid = cm.gemm_reference(u2, a["w1"], layout=cm.LAYOUT_FORWARD,
                            epilogue=cm.EPI_BIAS_GELU, bias=a["b1"])
    y = cm.gemm_reference(hid, a["w2"], layout=cm.LAYOUT_FORWARD,
                          bias=a["b2"])
    want = km._mlp_reference(u2, a["w1"], a["b1"], a["w2"], a["b2"])
    assert torch.equal(y, want.to(dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_gemm_composes_the_mlp_backward(dtype):
    """h_pre with the GELU second output (forward, f32), dW2 and dW1
    (wgrad), dh_pre (dgrad, x gelu'(aux)), du (dgrad, f32) against
    ``_mlp_bwd_reference``."""
    rng = np.random.default_rng(4)
    b, l, c = 2, 11, 128
    a = _mlp_inputs(rng, b, l, c, dtype)
    u2, dy2 = a["x"].view(b * l, c), a["dy"].view(b * l, c)
    h_pre, hid = cm.gemm_reference(u2, a["w1"], layout=cm.LAYOUT_FORWARD,
                                   epilogue=cm.EPI_F32, bias=a["b1"],
                                   gelu_out=True)
    assert h_pre.dtype == torch.float32 and hid.dtype == dtype
    dw2 = cm.gemm_reference(dy2, hid, layout=cm.LAYOUT_WGRAD)
    dh_pre = cm.gemm_reference(dy2, a["w2"], layout=cm.LAYOUT_DGRAD,
                               epilogue=cm.EPI_DGELU, aux=h_pre)
    dw1 = cm.gemm_reference(dh_pre, u2, layout=cm.LAYOUT_WGRAD)
    du = cm.gemm_reference(dh_pre, a["w1"], layout=cm.LAYOUT_DGRAD,
                           epilogue=cm.EPI_F32)
    want = km._mlp_bwd_reference(u2, a["w1"], a["b1"], a["w2"], dy2)
    for name, got, w in zip(("du", "dw1", "dw2"), (du, dw1, dw2),
                            (want[0], want[1], want[3])):
        assert got.dtype == w.dtype, name
        assert torch.equal(got, w), name


@pytest.mark.parametrize("tokens", [64, 200, 1000])
def test_plain_gemm_split_sum_matches_one_sum(tokens):
    """The weight gradient summed range by range and the ranges added in
    order equals the one f32 sum up to f32 reordering."""
    rng = np.random.default_rng(tokens)
    dy = _t(rng, tokens, 128, dtype=torch.float32)
    x = _t(rng, tokens, 256, dtype=torch.float32)
    splits, chunk = cm.plan_wgrad_split(128, 256, tokens)
    got = cm.gemm_reference(dy, x, layout=cm.LAYOUT_WGRAD, chunk=chunk)
    want = cm.gemm_reference(dy, x, layout=cm.LAYOUT_WGRAD)
    _close(got, want, torch.float32, f"{splits} splits")


# ---------------------------------------- the CUDA paths' composition


def _colsum_plain(t):
    return t.float().sum(0).to(t.dtype)


@pytest.fixture
def plain_launchers(monkeypatch):
    """Every launcher of the K1/K2/K4/K5 CUDA paths replaced by its plain
    version, and the CUDA operand checks by nothing, so that the paths'
    Python (LayerNorm rows first, the split plan, the scratch, the in-order
    sum) runs on CPU tensors."""
    calls = {"gemm": [], "ln_rows": 0}

    def launch(a, w, bias, residual, aux, out, out2, part, m, n, k, layout,
               epilogue, chunk):
        calls["gemm"].append((layout, m, n, k, epilogue, chunk,
                              None if part is None else tuple(part.shape)))
        cm.gemm_launch_reference(a, w, bias, residual, aux, out, out2, part,
                                 m, n, k, layout, epilogue, chunk)

    def ln_rows(x, gamma, beta, eps):
        calls["ln_rows"] += 1
        return cm.ln_forward(x, gamma, beta, eps)

    def ln_backward(x, gamma, eps, dy, d_yln):
        return cm.ln_backward_reference(x, gamma, eps, dy, d_yln)

    def check(*args, **kwargs):
        return None

    monkeypatch.setattr(cm, "_launch_gemm", launch)
    monkeypatch.setattr(cm, "_sm_count", lambda index: cm.H100_SMS)
    for mod in (cm, ka, km):
        monkeypatch.setattr(mod, "check_cuda_operands", check)
        monkeypatch.setattr(mod, "ln_rows", ln_rows)
    for mod in (ka, km):
        monkeypatch.setattr(mod, "colsum", _colsum_plain)
        monkeypatch.setattr(mod, "ln_backward", ln_backward)
    monkeypatch.setattr(ka, "_attention", ka.attention_core_reference)
    monkeypatch.setattr(ka, "_attention_bwd", ka.attention_core_bwd_reference)
    return calls


# (B, L): B*L = 200 tokens, three full 64-token ranges and a ragged one
B, L = 2, 100


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("ln", [True, False], ids=["K1", "K4"])
def test_attention_cuda_path_composition_on_cpu(plain_launchers, dtype, ln):
    c, h = 128, 4
    scale = (c // h) ** -0.5
    a = _attn_inputs(np.random.default_rng(5), B, L, c, dtype)
    lnp = (a["g"], a["beta"], 1e-6) if ln else None
    y, qkv, o = ka._layer_cuda(a["x"], a["wqkv"], a["bqkv"], a["wo"],
                               a["bo"], h, scale, ln=lnp)
    kw = dict(num_heads=h, scale=scale)
    if ln:
        want = ka.fused_ln_attn_layer_reference(
            a["x"], a["g"], a["beta"], a["wqkv"], a["bqkv"], a["wo"],
            a["bo"], **kw)
        got = ka._ln_backward_cuda(a["x"], a["g"], a["beta"], a["wqkv"],
                                   a["wo"], qkv, o, a["dy"], h, scale, 1e-6)
        want_g = ka.fused_ln_attn_layer_bwd_reference(
            a["x"], a["g"], a["beta"], a["wqkv"], a["bqkv"], a["wo"],
            a["dy"], **kw)
    else:
        want = ka.fused_attn_layer_reference(a["x"], a["wqkv"], a["bqkv"],
                                             a["wo"], a["bo"], **kw)
        got = ka._backward_cuda(a["x"], a["wqkv"], a["wo"], qkv, o, a["dy"],
                                h, scale)
        want_g = ka.fused_attn_layer_bwd_reference(
            a["x"], a["wqkv"], a["bqkv"], a["wo"], a["dy"], **kw)
    assert y.dtype == dtype
    _close(y, want, dtype, "y")
    assert len(got) == len(want_g)
    for i, (g, w) in enumerate(zip(got, want_g)):
        assert g.dtype == w.dtype, i
        _close(g, w, dtype, f"grad {i}")
    # K1 normalises once forward and once backward, each before its GEMM
    assert plain_launchers["ln_rows"] == (2 if ln else 0)
    splits = {(m, n): shape for layout, m, n, _, _, _, shape
              in plain_launchers["gemm"] if layout == cm.LAYOUT_WGRAD}
    # dWo (C, C) and dWqkv (3C, C): 1 and 3 tiles, so each takes one
    # range per 64 of its 200 tokens
    assert splits == {(c, c): (4, c, c), (3 * c, c): (4, 3 * c, c)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("ln", [True, False], ids=["K2", "K5"])
def test_mlp_cuda_path_composition_on_cpu(plain_launchers, dtype, ln):
    c = 128
    a = _mlp_inputs(np.random.default_rng(6), B, L, c, dtype)
    args = (a["w1"], a["b1"], a["w2"], a["b2"])
    if ln:
        y = km._mlp_cuda(a["x"], *args, ln=(a["g"], a["beta"], 1e-6))
        want = km.fused_ln_mlp_reference(a["x"], a["g"], a["beta"], *args)
        got = km._ln_backward_cuda(a["x"], a["g"], a["beta"], *args[:3],
                                   a["dy"], 1e-6)
        want_g = km.fused_ln_mlp_bwd_reference(a["x"], a["g"], a["beta"],
                                               *args[:3], a["dy"])
    else:
        y = km._mlp_cuda(a["x"], *args)
        want = km.fused_mlp_reference(a["x"], *args)
        got = km._backward_cuda(a["x"], *args[:3], a["dy"])
        want_g = km.fused_mlp_bwd_reference(a["x"], *args[:3], a["dy"])
    assert y.dtype == dtype
    _close(y, want, dtype, "y")
    assert len(got) == len(want_g)
    for i, (g, w) in enumerate(zip(got, want_g)):
        assert g.dtype == w.dtype, i
        _close(g, w, dtype, f"grad {i}")
    # forward once, backward once (the h_pre recompute and dW1 read the
    # same rows)
    assert plain_launchers["ln_rows"] == (2 if ln else 0)
    layouts = [call[0] for call in plain_launchers["gemm"]]
    assert layouts == [cm.LAYOUT_FORWARD] * 3 + [
        cm.LAYOUT_WGRAD, cm.LAYOUT_DGRAD, cm.LAYOUT_WGRAD, cm.LAYOUT_DGRAD]


# ---------------------------------------------------------- the planner

SMS = 2 * cm.H100_SMS
# (M, N, tokens) of every weight gradient on the main paths: ViT-S C=384
# (dWo, dWqkv) at the cls batch, the decoder C=512 (dWo, dWqkv, dW1, dW2),
# the ViT-B encoder C=768 on 49 kept tokens (dWo, dWqkv, dW1, dW2), the
# dense ViT-S at B=16; then ragged token counts
MAIN_WGRAD = [(384, 384, 12544), (1152, 384, 12544), (384, 1536, 12544),
              (1536, 384, 12544), (512, 512, 12544), (1536, 512, 12544),
              (512, 2048, 12544), (2048, 512, 12544), (768, 768, 3136),
              (2304, 768, 3136), (768, 3072, 3136), (3072, 768, 3136),
              (384, 384, 3136), (1152, 384, 3136)]
RAGGED_WGRAD = [(384, 384, 12543), (128, 128, 1), (128, 128, 63),
                (128, 128, 65), (1152, 384, 777), (768, 3072, 3137),
                (512, 2048, 100)]


@pytest.mark.parametrize("m,n,tokens", MAIN_WGRAD + RAGGED_WGRAD)
def test_wgrad_split_plan(m, n, tokens):
    splits, chunk = cm.plan_wgrad_split(m, n, tokens)
    assert (splits, chunk) == cm.plan_wgrad_split(m, n, tokens)
    assert chunk > 0 and chunk % cm.GEMM_BK == 0
    # each token in exactly one range, in order; every range but the last
    # full, every range non-empty
    ranges = [(z * chunk, min(tokens, (z + 1) * chunk))
              for z in range(splits)]
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(tokens))
    assert all(hi > lo for lo, hi in ranges)
    assert all(hi - lo == chunk for lo, hi in ranges[:-1])
    # the grid reaches about two tiles an SM where the tokens allow
    tiles = (m // cm.GEMM_BM) * (n // cm.GEMM_BN)
    k_tiles = -(-tokens // cm.GEMM_BK)
    want = -(-SMS // tiles)
    if splits < k_tiles:
        assert splits >= want, (tiles, splits)
    assert splits < 2 * want, (tiles, splits)
    if tiles >= SMS:
        assert splits == 1


@pytest.mark.parametrize("m,n,tokens", MAIN_WGRAD[:4] + RAGGED_WGRAD[:3])
def test_wgrad_scratch_shape(plain_launchers, m, n, tokens):
    rng = np.random.default_rng(7)
    dy = _t(rng, tokens, m, dtype=torch.bfloat16)
    x = _t(rng, tokens, n, dtype=torch.bfloat16)
    out = cm.gemm_wgrad(dy, x)
    (call,) = plain_launchers["gemm"]
    splits, chunk = cm.plan_wgrad_split(m, n, tokens)
    assert call[5] == chunk
    assert call[6] == ((splits, m, n) if splits > 1 else None)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    want = cm.gemm_reference(dy, x, layout=cm.LAYOUT_WGRAD,
                             chunk=chunk if splits > 1 else None)
    assert torch.equal(out, want)


def test_wgrad_over_no_tokens_is_zero(plain_launchers):
    dy = torch.zeros((0, 128), dtype=torch.bfloat16)
    x = torch.zeros((0, 256), dtype=torch.bfloat16)
    out = cm.gemm_wgrad(dy, x)
    assert out.shape == (128, 256) and not out.any()
    assert plain_launchers["gemm"] == []


# ------------------------------------------------- the kernel's shapes


def _attn_gemms(m, c):
    """(layout, M, N, K) of every GEMM of K1/K4, forward and backward."""
    f, d, w = cm.LAYOUT_FORWARD, cm.LAYOUT_DGRAD, cm.LAYOUT_WGRAD
    return [(f, m, 3 * c, c), (f, m, c, c), (w, c, c, m), (d, m, c, c),
            (w, 3 * c, c, m), (d, m, c, 3 * c)]


def _mlp_gemms(m, c):
    f, d, w = cm.LAYOUT_FORWARD, cm.LAYOUT_DGRAD, cm.LAYOUT_WGRAD
    return [(f, m, 4 * c, c), (f, m, c, 4 * c), (w, c, 4 * c, m),
            (d, m, 4 * c, c), (w, 4 * c, c, m), (d, m, c, 4 * c)]


LENGTHS = sorted(set(range(1, 257, 15)) | {49, 196, 256})


@pytest.mark.parametrize("gate", ["attn", "mlp", "ln_mlp"])
def test_no_admitted_shape_is_refused(gate):
    """Every (L, C, H) the sub-blocks' gates admit, C <= 1024, passes the
    GEMM's checks in every layout its path uses, at batches 1 and 3."""
    checked = 0
    for c, l in itertools.product(range(128, 1025, 64), LENGTHS):
        if gate == "attn":
            heads = [h for h in range(1, c + 1) if c % h == 0]
            ok = [h for h in heads
                  if ka.supports_fused_attn_layer(l, c, h, backward=True)
                  or ka.supports_fused_attn_layer(l, c, h)]
            if not ok:
                continue
            gemms = _attn_gemms
        else:
            supports = (km.supports_fused_mlp if gate == "mlp"
                        else km.supports_fused_ln_mlp)
            if not supports(l, c, 4 * c):
                continue
            gemms = _mlp_gemms
        for b in (1, 3):
            for layout, m, n, k in gemms(b * l, c):
                cm.gemm_check(m, n, k, layout)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("layout,m,n,k,match", [
    (cm.LAYOUT_FORWARD, 64, 192, 128, "N % 128"),
    (cm.LAYOUT_FORWARD, 64, 128, 96, "K % 64"),
    (cm.LAYOUT_DGRAD, 64, 128, 32, "K % 64"),
    (cm.LAYOUT_WGRAD, 192, 128, 77, "M % 128"),
    (3, 128, 128, 128, "unknown layout"),
])
def test_gemm_check_refuses(layout, m, n, k, match):
    with pytest.raises(ValueError, match=match):
        cm.gemm_check(m, n, k, layout)


def test_gemm_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU must launch the kernel or raise; a
    'meta' tensor cannot launch, so each wrapper raises."""
    a = torch.zeros((8, 128), dtype=torch.bfloat16, device="meta")
    w = torch.zeros((128, 128), dtype=torch.bfloat16, device="meta")
    for call in (lambda: cm.ln_gemm(a, w, None, epilogue=cm.EPI_BIAS),
                 lambda: cm.gemm_dgrad(a, w),
                 lambda: cm.gemm_wgrad(a, a)):
        with pytest.raises(ValueError, match="expected cuda"):
            call()


def test_ln_gemm_reads_the_layernorm_rows(plain_launchers):
    """K1's and K2's first GEMM: ``ln_rows`` writes the normalised rows
    (as ``ln_forward`` rounds them), then the forward layout reads them."""
    rng = np.random.default_rng(8)
    a = _t(rng, 70, 128, dtype=torch.bfloat16)
    w = _t(rng, 256, 128, dtype=torch.bfloat16, std=0.1)
    g = torch.from_numpy(1.0 + 0.1 * rng.normal(size=128)).float()
    b = torch.from_numpy(0.1 * rng.normal(size=128)).float()
    got = cm.ln_gemm(a, w, None, epilogue=cm.EPI_F32, ln=(g, b, 1e-6))
    want = cm.gemm_reference(cm.ln_forward(a, g, b, 1e-6), w,
                             layout=cm.LAYOUT_FORWARD, epilogue=cm.EPI_F32)
    assert torch.equal(got, want)
    assert plain_launchers["ln_rows"] == 1
    assert [call[0] for call in plain_launchers["gemm"]] == [
        cm.LAYOUT_FORWARD]
