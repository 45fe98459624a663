"""Port ops (eventpretrain_tpu_torch/ops) against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its port. The
JAX Pallas kernels run in interpret mode (their default off a TPU); the
port's wrappers take their plain PyTorch versions because the tensors lie
on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.ops import view_augment as jva
from eventpretrain_tpu.ops.events import events_to_voxel_grid_batch as jvox
from eventpretrain_tpu.ops.fused_attn_layer import (
    fused_ln_attn_layer as j_attn,
    supports_fused_attn_layer as j_supports_attn,
)
from eventpretrain_tpu.ops.fused_mlp import (
    fused_ln_mlp as j_mlp,
    supports_fused_ln_mlp as j_supports_mlp,
)
from eventpretrain_tpu.ops.pallas_voxel import splat_mxu
from eventpretrain_tpu_torch.ops import view_augment as tva
from eventpretrain_tpu_torch.ops.events import (
    bilinear_bin_weights,
    events_to_voxel_grid_batch,
)
from eventpretrain_tpu_torch.ops.fused_attn_layer import (
    fused_ln_attn_layer,
    supports_fused_attn_layer,
)
from eventpretrain_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp,
    supports_fused_ln_mlp,
)
from eventpretrain_tpu_torch.ops.splat import (
    splat,
    splat_launch_reference,
    splat_plan,
    voxelize_batch,
)

from tests._port_threads import one_torch_thread  # noqa: F401


def _events(rng, b, e, h, w, *, margin=3.0):
    """xytp events with fractional and out-of-frame coordinates, sorted t,
    polarity in {0, 1}."""
    ev = np.stack([
        rng.uniform(-margin, w + margin, (b, e)),
        rng.uniform(-margin, h + margin, (b, e)),
        np.sort(rng.uniform(0, 1, (b, e)), axis=1),
        rng.integers(0, 2, (b, e)).astype(np.float64),
    ], axis=-1).astype(np.float32)
    return ev


# exact f32 scatter on both sides; only the order of the f32 additions
# differs (cells hold a few unit weights)
VOXEL_ATOL = 1e-5


@pytest.mark.parametrize("num_bins", [5, 6, 9])
def test_voxel_grid_matches_jax_scatter(num_bins):
    rng = np.random.default_rng(num_bins)
    b, e, h, w = 4, 700, 24, 32
    ev = _events(rng, b, e, h, w)
    ev[2, :, 2] = 0.25          # a window of 0 becomes 1
    counts = np.array([e, 431, 650, 0], np.int32)  # ragged, one empty
    want = jvox(jnp.asarray(ev), jnp.asarray(counts), num_bins=num_bins,
                height=h, width=w, use_mxu=False)
    got = events_to_voxel_grid_batch(
        torch.from_numpy(ev), torch.from_numpy(counts), num_bins=num_bins,
        height=h, width=w,
    )
    assert got.shape == (b, h, w, num_bins) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=VOXEL_ATOL)
    assert float(np.abs(np.asarray(want)[3]).max()) == 0.0
    # voxelize_batch is the entry point the dispatcher routes through
    again = voxelize_batch(torch.from_numpy(ev), torch.from_numpy(counts),
                           num_bins=num_bins, height=h, width=w)
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=VOXEL_ATOL)


def test_bin_weights_sum_to_polarity():
    """Each valid event in the window splits exactly +-1 over its bins."""
    rng = np.random.default_rng(3)
    ev = _events(rng, 2, 300, 10, 10)
    counts = torch.tensor([300, 120])
    wb = bilinear_bin_weights(torch.from_numpy(ev), counts, 5)
    total = wb.sum(-1).numpy()
    pol = np.where(ev[..., 3] == 0, -1.0, 1.0)
    np.testing.assert_allclose(total[0], pol[0], atol=1e-6)
    np.testing.assert_allclose(total[1, :120], pol[1, :120], atol=1e-6)
    assert np.all(total[1, 120:] == 0)


# splat_mxu carries the f32 weights as a bf16 hi+lo split (~1e-5 relative
# to the weights, pallas_voxel.py:206-221); the port's scatter is exact f32
SPLAT_ATOL = 1e-4


@pytest.mark.parametrize("b,c,e,h,w", [(2, 3, 300, 16, 24),
                                       (3, 5, 1100, 20, 20)])
def test_splat_matches_jax_splat_mxu(b, c, e, h, w):
    rng = np.random.default_rng(e)
    y = rng.integers(-2, h + 2, (b, e)).astype(np.int32)
    x = rng.integers(-2, w + 2, (b, e)).astype(np.int32)
    wts = rng.normal(size=(b, c, e)).astype(np.float32)
    want = splat_mxu(jnp.asarray(y), jnp.asarray(x), jnp.asarray(wts),
                     height=h, width=w, interpret=True)
    got = splat(torch.from_numpy(y), torch.from_numpy(x),
                torch.from_numpy(wts), height=h, width=w)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SPLAT_ATOL)
    # the cluster route's decomposition at its own plan and over 3 CTAs
    for plan in (splat_plan(h, w, c), splat_plan(h, w, c, cluster=3)):
        got = splat_launch_reference(
            torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(wts),
            height=h, width=w, plan=plan)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SPLAT_ATOL)


def _to_torch_params(p: jva.ViewParams) -> tva.ViewParams:
    return tva.ViewParams(*(torch.from_numpy(np.array(a)) for a in p))


# both sides are f32 resampling contractions; sums run in another order
VIEW_ATOL = 1e-5


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("negate", [True, False])
def test_view_augment_matches_jax(mode, negate):
    rng = np.random.default_rng(11)
    b, h, w, c = 6, 30, 40, 5
    views = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jp = jva.sample_view_params(rng, b, h, w, scale_min=0.3)
    out = (48, 56)
    want = jva.apply_view_augment(jnp.asarray(views), jp, out, mode,
                                  negate_on_tflip=negate)
    got = tva.apply_view_augment(torch.from_numpy(views),
                                 _to_torch_params(jp), out, mode,
                                 negate_on_tflip=negate)
    assert got.shape == (b, *out, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=VIEW_ATOL)


def test_view_augment_identity_per_sample_box():
    """The eval view: each sample's own sensor box on a shared canvas."""
    rng = np.random.default_rng(5)
    views = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jp = jva.identity_view_params(2, 32, 32)._replace(
        crop_h=jnp.asarray([20, 32], jnp.int32),
        crop_w=jnp.asarray([24, 30], jnp.int32),
    )
    want = jva.apply_view_augment(jnp.asarray(views), jp, (64, 64),
                                  "bilinear")
    tp = tva.identity_view_params(2, 32, 32)._replace(
        crop_h=torch.tensor([20, 32], dtype=torch.int32),
        crop_w=torch.tensor([24, 30], dtype=torch.int32),
    )
    got = tva.apply_view_augment(torch.from_numpy(views), tp, (64, 64),
                                 "bilinear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=VIEW_ATOL)


def _subblock(rng, b, l, c, hidden):
    """numpy inputs in the JAX layout: kernels (in, out)."""
    return dict(
        x=rng.normal(size=(b, l, c)),
        g=rng.normal(size=(c,)) * 0.1 + 1.0,
        beta=rng.normal(size=(c,)) * 0.1,
        w1=rng.normal(size=(c, hidden)) * c ** -0.5,
        b1=rng.normal(size=(hidden,)) * 0.1,
        w2=rng.normal(size=(hidden, c)) * hidden ** -0.5,
        b2=rng.normal(size=(c,)) * 0.1,
    )


def _as(a, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)
                                                 ).to(tdt)


# f32: same algorithm, sums in another order. bf16: both round at the same
# points, so an output may differ by a bf16 ulp where a rounded
# intermediate landed on the other side of a tie; bound the error at 2% of
# the output's scale (a few ulps of the largest values).
F32_ATOL = 1e-4
BF16_REL = 2e-2

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=F32_ATOL)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), err


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l,c,h", [(2, 20, 128, 4), (1, 49, 256, 8)])
def test_fused_ln_attn_layer_matches_jax_kernel(dtypes, b, l, c, h):
    jdt, tdt = dtypes
    rng = np.random.default_rng(l * c)
    a = _subblock(rng, b, l, c, 3 * c)
    wo = rng.normal(size=(c, c)) * c ** -0.5
    scale = (c // h) ** -0.5
    x_j, x_t = _as(a["x"], jdt, tdt)
    wqkv_j, wqkv_t = _as(a["w1"], jdt, tdt)
    bqkv_j, bqkv_t = _as(a["b1"], jdt, tdt)
    wo_j, wo_t = _as(wo, jdt, tdt)
    bo_j, bo_t = _as(a["b2"], jdt, tdt)
    g_j, g_t = _as(a["g"], jnp.float32, torch.float32)
    beta_j, beta_t = _as(a["beta"], jnp.float32, torch.float32)
    want = j_attn(x_j, g_j, beta_j, wqkv_j, bqkv_j, wo_j, bo_j,
                  num_heads=h, scale=scale)
    got = fused_ln_attn_layer(x_t, g_t, beta_t, wqkv_t.t().contiguous(),
                              bqkv_t, wo_t.t().contiguous(), bo_t,
                              num_heads=h, scale=scale)
    assert got.dtype == tdt and got.shape == (b, l, c)
    _check(got, want, tdt)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l,c", [(2, 20, 128), (1, 49, 256)])
def test_fused_ln_mlp_matches_jax_kernel(dtypes, b, l, c):
    jdt, tdt = dtypes
    rng = np.random.default_rng(l + c)
    a = _subblock(rng, b, l, c, 4 * c)
    x_j, x_t = _as(a["x"], jdt, tdt)
    w1_j, w1_t = _as(a["w1"], jdt, tdt)
    b1_j, b1_t = _as(a["b1"], jdt, tdt)
    w2_j, w2_t = _as(a["w2"], jdt, tdt)
    b2_j, b2_t = _as(a["b2"], jdt, tdt)
    g_j, g_t = _as(a["g"], jnp.float32, torch.float32)
    beta_j, beta_t = _as(a["beta"], jnp.float32, torch.float32)
    want = j_mlp(x_j, g_j, beta_j, w1_j, b1_j, w2_j, b2_j)
    got = fused_ln_mlp(x_t, g_t, beta_t, w1_t.t().contiguous(), b1_t,
                       w2_t.t().contiguous(), b2_t)
    assert got.dtype == tdt and got.shape == (b, l, c)
    _check(got, want, tdt)


# Backward parity. f32: the same algorithm with sums in another order, held
# at 1e-5 of each gradient's scale. bf16: both round at the same points
# (do, p, ds, dq/dk/dv, dh_pre, dx and the weight gradients once), so a
# rounded intermediate may land one ulp apart and move the sums over the
# tokens by a few ulps: 2e-2 of each gradient's scale.
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_NAMES = ("dx", "dgamma", "dbeta", "dw_in", "db_in", "dw_out", "db_out")


def _check_grads(got, want, tdt):
    """``want`` in the JAX layout (kernels (in, out)); ``got`` torch."""
    for name, g, w in zip(GRAD_NAMES, got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.float().detach().numpy()
        if name.startswith("dw"):
            g = g.T
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= BWD_REL[tdt] * np.abs(w).max(), (name, err,
                                                       np.abs(w).max())


def _torch_args(a, names, jdt, tdt):
    """(jax args, torch args) for the sub-block inputs; weights transposed
    into the torch layout, LayerNorm parameters f32."""
    js, ts = [], []
    for n in names:
        if n in ("g", "beta"):
            j, t = _as(a[n], jnp.float32, torch.float32)
        else:
            j, t = _as(a[n], jdt, tdt)
            if n.startswith("w"):
                t = t.t().contiguous()
        js.append(j)
        ts.append(t)
    return js, ts


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l,c,h", [(2, 16, 128, 4), (2, 24, 256, 8)])
def test_fused_ln_attn_layer_bwd_matches_jax_vjp(dtypes, b, l, c, h):
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_ln_attn_layer_bwd,
    )

    jdt, tdt = dtypes
    rng = np.random.default_rng(b * l + c)
    a = _subblock(rng, b, l, c, 3 * c)
    a["wo"] = rng.normal(size=(c, c)) * c ** -0.5
    dy = rng.normal(size=(b, l, c))
    scale = (c // h) ** -0.5
    names = ("x", "g", "beta", "w1", "b1", "wo", "b2")
    js, ts = _torch_args(a, names, jdt, tdt)
    _, vjp = jax.vjp(
        lambda *args: j_attn(*args, num_heads=h, scale=scale), *js)
    dy_j, dy_t = _as(dy, jdt, tdt)
    want = vjp(dy_j)
    got = fused_ln_attn_layer_bwd(*ts, dy_t, num_heads=h, scale=scale)
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    _check_grads(got, want, tdt)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l,c", [(2, 16, 128), (2, 12, 256), (1, 8, 768)],
                         ids=["pallas128", "pallas256", "xla768"])
def test_fused_ln_mlp_bwd_matches_jax_vjp(dtypes, b, l, c):
    """C <= 512 is the Pallas backward, C = 768 the XLA one; the port's one
    backward is held against both."""
    from eventpretrain_tpu_torch.ops.fused_mlp import fused_ln_mlp_bwd

    jdt, tdt = dtypes
    rng = np.random.default_rng(b + l + c)
    a = _subblock(rng, b, l, c, 4 * c)
    dy = rng.normal(size=(b, l, c))
    names = ("x", "g", "beta", "w1", "b1", "w2", "b2")
    js, ts = _torch_args(a, names, jdt, tdt)
    _, vjp = jax.vjp(lambda *args: j_mlp(*args), *js)
    dy_j, dy_t = _as(dy, jdt, tdt)
    want = vjp(dy_j)
    got = fused_ln_mlp_bwd(*ts, dy_t)
    assert got[0].dtype == tdt and got[3].dtype == tdt
    _check_grads(got, want, tdt)


@pytest.mark.parametrize("which", ["attn", "mlp"])
def test_autograd_function_takes_plain_backward_on_cpu(which):
    """torch.autograd.grad through the wrapper equals the plain backward,
    and no launch is counted on the CPU."""
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_ln_attn_layer_bwd_reference,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp_bwd_reference,
    )

    rng = np.random.default_rng(7)
    b, l, c, h = 2, 16, 128, 4
    hidden = 3 * c if which == "attn" else 4 * c
    a = _subblock(rng, b, l, c, hidden)
    if which == "attn":
        a["w2"] = rng.normal(size=(c, c)) * c ** -0.5
    names = ("x", "g", "beta", "w1", "b1", "w2", "b2")
    _, ts = _torch_args(a, names, jnp.bfloat16, torch.bfloat16)
    ts = [t.requires_grad_() for t in ts]
    dy = torch.from_numpy(rng.normal(size=(b, l, c)).astype(np.float32)).to(
        torch.bfloat16)
    kw = dict(num_heads=h, scale=(c // h) ** -0.5) if which == "attn" else {}
    fn = fused_ln_attn_layer if which == "attn" else fused_ln_mlp
    y = fn(*ts, **kw)
    got = torch.autograd.grad(y, ts, dy)
    if which == "attn":
        want = fused_ln_attn_layer_bwd_reference(*ts[:6], dy, **kw)
    else:
        want = fused_ln_mlp_bwd_reference(*ts[:6], dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fn.launches == 0 and fn.launches_bwd == 0


@pytest.mark.parametrize("l", [16, 49, 196, 256, 257])
@pytest.mark.parametrize("c,h", [(128, 4), (384, 12), (768, 12), (512, 16),
                                 (96, 3), (200, 8), (256, 8)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_gates_match_jax(l, c, h, dtypes):
    jdt, tdt = dtypes
    assert supports_fused_attn_layer(l, c, h, tdt) == j_supports_attn(
        l, c, h, jdt)
    assert supports_fused_ln_mlp(l, c, 4 * c, tdt) == j_supports_mlp(
        l, c, 4 * c, jdt)


@pytest.mark.parametrize("l,c,h", [(49, 384, 12), (49, 768, 12),
                                   (196, 256, 8), (196, 512, 16),
                                   (196, 384, 12), (196, 768, 12)])
def test_backward_gate_open_at_every_rec_hub_width(l, c, h):
    """Encoders (49 kept tokens) and decoders (196) of pretrain_hub_small
    and _base, and the dense ViT-S/B: the attention backward's shared
    memory fits, so training takes the kernels wherever serving does."""
    assert supports_fused_attn_layer(l, c, h, torch.bfloat16, backward=True)


def test_backward_gate_bound_closes_past_shared_memory():
    """The attention core's shared-memory bounds at L=256: head_dim 192
    fits the forward's block (226 KB) and not the backward's (253 KB);
    head_dim 160 fits both; past them each closes."""
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        MAX_BLOCK_SMEM,
        attention_bwd_smem_bytes,
        attention_smem_bytes,
    )

    assert supports_fused_attn_layer(256, 384, 2, torch.bfloat16)
    assert not supports_fused_attn_layer(256, 384, 2, torch.bfloat16,
                                         backward=True)
    assert supports_fused_attn_layer(256, 640, 4, torch.bfloat16,
                                     backward=True)
    assert not supports_fused_attn_layer(256, 256, 1, torch.bfloat16)
    assert attention_smem_bytes(256, 200) > MAX_BLOCK_SMEM
    assert attention_bwd_smem_bytes(256, 168) > MAX_BLOCK_SMEM
    assert attention_bwd_smem_bytes(196, 64) <= 80 * 1024


def _cuda_core_gate(l, d, backward):
    """The shared-memory bounds of the CUDA-core attention kernels that the
    tensor-core ones replaced: q, k, v of a head and 8 warps' f32 rows; and
    q, k, v, do with rows of D + 2 and the row statistics."""
    ok = 3 * l * d * 2 + 8 * l * 4 <= 232448
    if backward:
        ok = ok and 8 * l * (d + 2) + 4 * (3 * l + 8 * max(l, 64)) <= 232448
    return ok


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_attention_gate_open_wherever_the_cuda_core_gate_was(backward):
    """Every L <= 256 and head_dim (a multiple of 8, at the fewest heads
    that make C a multiple of 128): open wherever the CUDA-core kernels'
    gate was open, and never open where JAX's gate is closed."""
    import math

    for d in range(8, 264, 8):
        h = 128 // math.gcd(d, 128)
        for l in range(1, 258):
            ours = supports_fused_attn_layer(l, d * h, h, torch.bfloat16,
                                             backward)
            jax_ok = j_supports_attn(l, d * h, h, jnp.bfloat16)
            if jax_ok and _cuda_core_gate(l, d, backward):
                assert ours, (l, d)
            if not jax_ok:
                assert not ours, (l, d)


def test_attention_bwd_scratch_is_three_f32_rows_per_head():
    """The backward's statistics: (3, B, H, L) f32 on the operands' device,
    one max, sum and rowsum(dp * p) per query row of each head."""
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        attention_bwd_scratch,
    )

    st = attention_bwd_scratch(5, 196, 12, torch.device("cpu"))
    assert st.shape == (3, 5, 12, 196) and st.dtype == torch.float32
    assert st.device.type == "cpu" and st.is_contiguous()
    meta = attention_bwd_scratch(2, 17, 1, "meta")
    assert meta.shape == (3, 2, 1, 17) and meta.device.type == "meta"


def _packed_qkv(rng, b, l, c, jdt, tdt):
    a = rng.normal(size=(b, l, 3 * c))
    return _as(a, jdt, tdt)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("l,c,h", [(20, 128, 4), (17, 128, 1),
                                   (49, 256, 8)])
def test_attention_core_reference_matches_jax_heads(dtypes, l, c, h):
    """The plain attention core against JAX's ``_attention_heads`` on each
    sample's packed (L, 3C) rows, concatenated as ``_layer_fwd`` does."""
    from eventpretrain_tpu.ops.fused_attn_layer import _attention_heads
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        attention_core_reference,
    )

    jdt, tdt = dtypes
    rng = np.random.default_rng(l + c + h)
    b, scale = 2, (c // h) ** -0.5
    qj, qt = _packed_qkv(rng, b, l, c, jdt, tdt)
    want = jnp.stack([jnp.concatenate(_attention_heads(qj[i], c, h, scale,
                                                       jdt), axis=-1)
                      for i in range(b)])
    got = attention_core_reference(qt.reshape(b * l, 3 * c), b, l, h, scale)
    assert got.dtype == tdt and got.shape == (b * l, c)
    _rel_check(got.view(b, l, c), want, tdt)


@pytest.mark.parametrize("l,c,h", [(20, 128, 4), (17, 128, 1),
                                   (49, 256, 8)])
def test_attention_core_bwd_reference_matches_jax_vjp(l, c, h):
    """The plain attention core's backward, f32: dq, dk, dv in the packing
    of qkv against ``jax.vjp`` of JAX's ``_attention_heads`` (in f32 the
    kernels' rowsum(dp * p) form is the softmax's exact gradient)."""
    from eventpretrain_tpu.ops.fused_attn_layer import _attention_heads
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        attention_core_bwd_reference,
    )

    rng = np.random.default_rng(3 * l + c + h)
    b, scale = 2, (c // h) ** -0.5
    qj, qt = _packed_qkv(rng, b, l, c, jnp.float32, torch.float32)
    doj, dot = _as(rng.normal(size=(b, l, c)), jnp.float32, torch.float32)

    def heads(x):
        return jnp.stack([jnp.concatenate(
            _attention_heads(x[i], c, h, scale, jnp.float32), axis=-1)
            for i in range(b)])

    _, vjp = jax.vjp(heads, qj)
    (want,) = vjp(doj)
    got = attention_core_bwd_reference(qt.reshape(b * l, 3 * c),
                                       dot.reshape(b * l, c), b, l, h, scale)
    assert got.dtype == torch.float32 and got.shape == (b * l, 3 * c)
    got = got.view(b, l, 3 * c)
    for i, name in enumerate(("dq", "dk", "dv")):
        _rel_check(got[..., i * c:(i + 1) * c], want[..., i * c:(i + 1) * c],
                   torch.float32, name)


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU must launch the kernel or raise; a
    'meta' tensor cannot launch, so each wrapper raises."""
    c = 128
    x = torch.zeros((1, 16, c), dtype=torch.bfloat16, device="meta")
    w = torch.zeros((3 * c, c), dtype=torch.bfloat16, device="meta")
    v = torch.zeros((3 * c,), dtype=torch.bfloat16, device="meta")
    wo = torch.zeros((c, c), dtype=torch.bfloat16, device="meta")
    bo = torch.zeros((c,), dtype=torch.bfloat16, device="meta")
    g = torch.ones((c,), device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        fused_ln_attn_layer(x, g, g, w, v, wo, bo, num_heads=4, scale=0.1)
    w1 = torch.zeros((4 * c, c), dtype=torch.bfloat16, device="meta")
    b1 = torch.zeros((4 * c,), dtype=torch.bfloat16, device="meta")
    w2 = torch.zeros((c, 4 * c), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        fused_ln_mlp(x, g, g, w1, b1, w2, bo)
    y = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        splat(y, y, torch.zeros((1, 2, 8), device="meta"), height=4, width=4)
    assert splat.launches == fused_ln_attn_layer.launches == 0
    assert fused_ln_mlp.launches == 0
    assert fused_ln_attn_layer.launches_bwd == fused_ln_mlp.launches_bwd == 0


@pytest.mark.parametrize("num_bins", [2, 3, 5])
def test_normalize_representation_matches_jax(num_bins):
    from eventpretrain_tpu.data.representations import (
        normalize_representation as j_norm,
    )
    from eventpretrain_tpu_torch.data.representations import (
        normalize_representation,
    )

    rng = np.random.default_rng(num_bins)
    evg = np.abs(rng.normal(size=(3, 8, 9, num_bins))).astype(np.float32)
    evg[1] = 0.0  # an empty sample: the MEM factor falls back to 1
    want = j_norm(jnp.asarray(evg), num_bins)
    got = normalize_representation(torch.from_numpy(evg), num_bins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_unported_representations_raise():
    """EvRep waits for the EvRepSL network: it raises before any other
    option is read. The MEM image (``num_bins=3``) is held in
    tests/test_torch_port_datasets.py."""
    from eventpretrain_tpu_torch.data.representations import (
        build_representation,
    )

    ev = torch.zeros((1, 4, 4))
    with pytest.raises(NotImplementedError):
        build_representation(ev, torch.tensor([4]), height=8, width=8,
                             num_bins=5, use_evrep=True)


# ------------------------------------------------ K4 fused_attn_layer, K5


def _k4_inputs(rng, b, l, c):
    return dict(x=rng.normal(size=(b, l, c)),
                wqkv=rng.normal(size=(c, 3 * c)) * c ** -0.5,
                bqkv=rng.normal(size=(3 * c,)) * 0.1,
                wo=rng.normal(size=(c, c)) * c ** -0.5,
                bo=rng.normal(size=(c,)) * 0.1)


def _k5_inputs(rng, b, l, c):
    return dict(x=rng.normal(size=(b, l, c)),
                w1=rng.normal(size=(c, 4 * c)) * c ** -0.5,
                b1=rng.normal(size=(4 * c,)) * 0.1,
                w2=rng.normal(size=(4 * c, c)) * (4 * c) ** -0.5,
                b2=rng.normal(size=(c,)) * 0.1)


# f32: the same algorithm, sums in another order: 1e-5 of the output's and
# of each gradient's scale. bf16: both round at the same points, so a
# rounded intermediate may land one ulp apart: 2e-2 of the scale.
BARE_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
K4_GRADS = ("dx", "dwqkv", "dbqkv", "dwo", "dbo")
K5_GRADS = ("dx", "dw1", "db1", "dw2", "db2")


def _rel_check(got, want, tdt, name=""):
    got = got.float().detach().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= BARE_REL[tdt] * np.abs(want).max(), (name, err,
                                                       np.abs(want).max())


def _bare_args(a, jdt, tdt):
    """(jax args, torch args): every operand in the compute dtype, weights
    transposed into the torch layout."""
    js, ts = [], []
    for n, v in a.items():
        j, t = _as(v, jdt, tdt)
        if n.startswith("w"):
            t = t.t().contiguous()
        js.append(j)
        ts.append(t)
    return js, ts


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("l,c", [(20, 128), (64, 256)])
def test_fused_attn_layer_matches_jax_kernel(dtypes, l, c):
    """K4 forward against the Pallas kernel in interpret mode, 4 heads."""
    from eventpretrain_tpu.ops.fused_attn_layer import fused_attn_layer as j4
    from eventpretrain_tpu_torch.ops.fused_attn_layer import fused_attn_layer

    jdt, tdt = dtypes
    rng = np.random.default_rng(3 * l + c)
    js, ts = _bare_args(_k4_inputs(rng, 2, l, c), jdt, tdt)
    scale = (c // 4) ** -0.5
    want = j4(*js, num_heads=4, scale=scale, interpret=True)
    got = fused_attn_layer(*ts, num_heads=4, scale=scale)
    assert got.dtype == tdt and got.shape == (2, l, c)
    _rel_check(got, want, tdt)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("l,c", [(16, 128), (64, 256)])
def test_fused_attn_layer_bwd_matches_jax_vjp(dtypes, l, c):
    """K4 backward against ``jax.vjp`` of the Pallas kernel's custom VJP
    (``_bwd_kernel``, interpret mode): dx rounded once, every weight and
    bias gradient in the weights' dtype."""
    from eventpretrain_tpu.ops.fused_attn_layer import fused_attn_layer as j4
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_attn_layer_bwd,
    )

    jdt, tdt = dtypes
    rng = np.random.default_rng(5 * l + c)
    js, ts = _bare_args(_k4_inputs(rng, 2, l, c), jdt, tdt)
    dy_j, dy_t = _as(rng.normal(size=(2, l, c)), jdt, tdt)
    scale = (c // 4) ** -0.5
    _, vjp = jax.vjp(lambda *a: j4(*a, num_heads=4, scale=scale,
                                   interpret=True), *js)
    want = vjp(dy_j)
    got = fused_attn_layer_bwd(*ts, dy_t, num_heads=4, scale=scale)
    for name, g, w in zip(K4_GRADS, got, want):
        assert g.dtype == tdt, name
        _rel_check(g.t() if name.startswith("dw") else g, w, tdt, name)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("l,c", [(20, 128), (64, 256)])
def test_fused_mlp_matches_jax_kernel(dtypes, l, c):
    """K5 forward against the Pallas kernel in interpret mode."""
    from eventpretrain_tpu.ops.fused_mlp import fused_mlp as j5
    from eventpretrain_tpu_torch.ops.fused_mlp import fused_mlp

    jdt, tdt = dtypes
    rng = np.random.default_rng(7 * l + c)
    js, ts = _bare_args(_k5_inputs(rng, 2, l, c), jdt, tdt)
    want = j5(*js, interpret=True)
    got = fused_mlp(*ts)
    assert got.dtype == tdt and got.shape == (2, l, c)
    _rel_check(got, want, tdt)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("l,c", [(16, 128), (64, 256)])
def test_fused_mlp_bwd_matches_jax_vjp(dtypes, l, c):
    """K5 backward against ``jax.vjp`` of the Pallas kernel's custom VJP
    (``_bwd_kernel``, interpret mode)."""
    from eventpretrain_tpu.ops.fused_mlp import fused_mlp as j5
    from eventpretrain_tpu_torch.ops.fused_mlp import fused_mlp_bwd

    jdt, tdt = dtypes
    rng = np.random.default_rng(11 * l + c)
    js, ts = _bare_args(_k5_inputs(rng, 2, l, c), jdt, tdt)
    dy_j, dy_t = _as(rng.normal(size=(2, l, c)), jdt, tdt)
    _, vjp = jax.vjp(lambda *a: j5(*a, interpret=True), *js)
    want = vjp(dy_j)
    got = fused_mlp_bwd(*ts, dy_t)
    for name, g, w in zip(K5_GRADS, got, want):
        assert g.dtype == tdt, name
        _rel_check(g.t() if name.startswith("dw") else g, w, tdt, name)


@pytest.mark.parametrize("which", ["k4", "k5"])
def test_bare_autograd_function_takes_plain_backward_on_cpu(which):
    """torch.autograd.grad through the K4/K5 wrapper equals the plain
    backward bit for bit, and no launch is counted on the CPU."""
    from eventpretrain_tpu_torch.ops import fused_attn_layer as k4
    from eventpretrain_tpu_torch.ops import fused_mlp as k5

    rng = np.random.default_rng(13)
    make = _k4_inputs if which == "k4" else _k5_inputs
    _, ts = _bare_args(make(rng, 2, 16, 128), jnp.bfloat16, torch.bfloat16)
    ts = [t.requires_grad_() for t in ts]
    dy = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(
        np.float32)).to(torch.bfloat16)
    if which == "k4":
        kw = dict(num_heads=4, scale=32 ** -0.5)
        fn = k4.fused_attn_layer
        want = k4.fused_attn_layer_bwd_reference(*ts[:4], dy, **kw)
    else:
        kw = {}
        fn = k5.fused_mlp
        want = k5.fused_mlp_bwd_reference(*ts[:4], dy)
    got = torch.autograd.grad(fn(*ts, **kw), ts, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fn.launches == 0 and fn.launches_bwd == 0


# every ViT, hub and decoder width of the repo, and widths on each side of
# the gates' bounds
_WIDTHS = [(128, 4), (256, 8), (384, 12), (512, 16), (768, 12), (96, 3),
           (200, 8), (640, 10), (1024, 16)]


@pytest.mark.parametrize("l", [16, 49, 196, 256, 257])
@pytest.mark.parametrize("c,h", _WIDTHS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_k4_k5_gates_match_jax(l, c, h, dtypes):
    """K4 shares K1's gate function; K5 has its own (C <= 512)."""
    from eventpretrain_tpu.ops.fused_attn_layer import (
        supports_fused_attn_layer as j4_gate,
    )
    from eventpretrain_tpu.ops.fused_mlp import supports_fused_mlp as j5_gate
    from eventpretrain_tpu_torch.ops.fused_mlp import supports_fused_mlp

    jdt, tdt = dtypes
    for backward in (False, True):
        assert supports_fused_attn_layer(l, c, h, tdt, backward) == j4_gate(
            l, c, h, jdt)
    for hidden in (4 * c, 3 * c):
        assert supports_fused_mlp(l, c, hidden, tdt) == j5_gate(l, c, hidden,
                                                                jdt)


def test_bare_wrappers_never_fall_back_off_cpu():
    """K4 and K5 on a tensor that is not on the CPU launch or raise; a
    'meta' tensor cannot launch, so each raises; a shape outside the gate
    raises before anything else."""
    from eventpretrain_tpu_torch.ops.fused_attn_layer import fused_attn_layer
    from eventpretrain_tpu_torch.ops.fused_mlp import fused_mlp

    c = 128

    def z(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device="meta")

    with pytest.raises(ValueError, match="expected cuda"):
        fused_attn_layer(z(1, 16, c), z(3 * c, c), z(3 * c), z(c, c), z(c),
                         num_heads=4, scale=0.1)
    with pytest.raises(ValueError, match="expected cuda"):
        fused_mlp(z(1, 16, c), z(4 * c, c), z(4 * c), z(c, 4 * c), z(c))
    with pytest.raises(ValueError, match="gate"):
        fused_mlp(z(1, 16, 768), z(3072, 768), z(3072), z(768, 3072),
                  z(768))
    assert fused_attn_layer.launches == fused_mlp.launches == 0
    assert fused_attn_layer.launches_bwd == fused_mlp.launches_bwd == 0
