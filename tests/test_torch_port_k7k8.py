"""Port slice 3c against the JAX package on the CPU: K7 (``fused_mha`` and
the ``Attention(use_fused_kernel=True)`` route), K8
(``voxelize_batch_scatter``) and the training loops' prefetcher.

The same numpy-seeded inputs go through the JAX function and its port. JAX's
``fused_mha`` runs with ``interpret=True`` and ``voxelize_batch_pallas``
with ``pallas_call`` patched to interpret, as the JAX package's own tests
run them off a TPU; the port's wrappers take their plain PyTorch versions
because the tensors lie on the CPU.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eventpretrain_tpu.ops.pallas_voxel as jpv
from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.models.layers import Attention as JAttention
from eventpretrain_tpu.ops.pallas_attention import (
    fused_mha as j_fused_mha,
    supports_fused_mha as j_supports_fused_mha,
)
from eventpretrain_tpu_torch.ckpt.bridge import load_jax_state_dict
from eventpretrain_tpu_torch.data import cls_pipeline as tcp
from eventpretrain_tpu_torch.data.prefetch import Prefetcher
from eventpretrain_tpu_torch.models import layers as tlayers
from eventpretrain_tpu_torch.ops.fused_mha import (
    fused_mha,
    fused_mha_bwd,
    supports_fused_mha,
)
from eventpretrain_tpu_torch.ops.splat import (
    voxelize_batch,
    voxelize_batch_scatter,
)
from eventpretrain_tpu_torch.train import loop as tloop

# K7 (L, H, D) cases: a multiple of 8, a wider head, ragged L with D = 24
K7_SHAPES = [(16, 2, 8), (24, 4, 16), (33, 2, 24)]
K7_BATCH = 2
# f32 on both sides; the products and the row sums run in other orders
K7_ATOL = 1e-5


def _qkv(rng, l, h, d, n=3, dtype=np.float32):
    return tuple(rng.standard_normal((K7_BATCH, l, h, d)).astype(dtype)
                 for _ in range(n))


@functools.lru_cache(maxsize=None)
def _jax_k7(l, h, d, dtype="float32"):
    """JAX's interpret-mode ``fused_mha`` output and its ``jax.vjp`` for one
    numpy-seeded (q, k, v, do); cached so the forward and backward tests of
    a shape trace it once."""
    rng = np.random.default_rng(l * 100 + d)
    q, k, v, do = _qkv(rng, l, h, d, n=4)
    jdt = jnp.dtype(dtype)
    scale = d ** -0.5

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(functools.partial(
            j_fused_mha, scale=scale, interpret=True), q, k, v)
        return out, vjp(do)

    out, grads = run(*(jnp.asarray(a, jdt) for a in (q, k, v, do)))
    return (q, k, v, do), np.asarray(out.astype(jnp.float32)), tuple(
        np.asarray(g.astype(jnp.float32)) for g in grads)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("l,h,d", K7_SHAPES)
def test_fused_mha_forward_matches_jax_kernel(l, h, d):
    (q, k, v, _), want, _ = _jax_k7(l, h, d)
    got = fused_mha(_t(q), _t(k), _t(v), scale=d ** -0.5)
    assert got.shape == (K7_BATCH, l, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=K7_ATOL)


@pytest.mark.parametrize("l,h,d", K7_SHAPES)
def test_fused_mha_backward_matches_jax_vjp(l, h, d):
    """dq, dk, dv through autograd (the plain backward of the
    ``autograd.Function``) and through ``fused_mha_bwd``, against
    ``jax.vjp`` of the interpret kernel, within 1e-5 of each scale."""
    (q, k, v, do), _, want = _jax_k7(l, h, d)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    fused_mha(*leaves, scale=d ** -0.5).backward(_t(do))
    direct = fused_mha_bwd(_t(q), _t(k), _t(v), _t(do), scale=d ** -0.5)
    for leaf, g, w in zip(leaves, direct, want):
        scale = np.abs(w).max()
        assert np.abs(leaf.grad.numpy() - w).max() <= K7_ATOL * scale
        np.testing.assert_array_equal(g.numpy(), leaf.grad.numpy())


def test_fused_mha_bf16_within_two_ulps_of_jax_kernel():
    """bf16 inputs: both round p and o at the same points; the f32 sums
    before a rounding run in other orders, so an output may land a bf16 ulp
    or two apart (of the output's scale)."""
    l, h, d = 24, 4, 16
    (q, k, v, _), want, _ = _jax_k7(l, h, d, "bfloat16")
    bf = torch.bfloat16
    got = fused_mha(_t(q, bf), _t(k, bf), _t(v, bf), scale=d ** -0.5)
    assert got.dtype == bf
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= 2 * ulp


def test_supports_fused_mha_is_jax_gate():
    for l in (1, 49, 196, 1023, 1024, 1025, 4096):
        for d in (1, 8, 24, 64, 255, 256, 257):
            assert supports_fused_mha(l, d) == j_supports_fused_mha(l, d)


# The module: 2 x 20 tokens of width 64, 4 heads (head_dim 16)
ATTN_B, ATTN_L, ATTN_C, ATTN_H = 2, 20, 64, 4
# f32: the port takes the plain product (K7 is bf16 only), JAX its Pallas
# kernel in interpret mode; bf16: both take K7 (the port's plain version),
# with bf16 projections that round at the same points but sum in other
# orders, so an output or gradient may move a few bf16 ulps of its scale
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_module_matches_jax_fused_kernel_route(dtype):
    """``Attention(use_fused_kernel=True)`` with the JAX module's weights
    carried by the bridge (the same parameter names, loaded strictly),
    called with ``fused=False`` (JAX's ``use_fused_layer=False``): output,
    input gradient and every parameter gradient against JAX's
    ``Attention(use_fused_kernel=True)``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((ATTN_B, ATTN_L, ATTN_C)).astype(np.float32)
    dy = rng.standard_normal((ATTN_B, ATTN_L, ATTN_C)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jm = JAttention(num_heads=ATTN_H, use_fused_kernel=True,
                    use_fused_layer=False, dtype=jdt)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]

    @jax.jit
    def run(params, x, dy):
        def f(params, x):
            out, _ = jm.apply({"params": params}, x.astype(jdt))
            return jnp.sum(out.astype(jnp.float32) * dy), out

        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(params, x)
        return out, grads

    want, (gp, gx) = run(params, jnp.asarray(x), jnp.asarray(dy))
    tdt = getattr(torch, dtype)
    attn = tlayers.Attention(ATTN_C, ATTN_H, use_fused_kernel=True,
                             dtype=tdt, device="cpu")
    load_jax_state_dict(attn, export_torch_state_dict(params))
    xt = _t(x).requires_grad_()
    out, weights = attn(xt, fused=False)
    assert weights is None and out.dtype == tdt
    out.float().backward(_t(dy))
    tol = ATTN_TOL[dtype]

    def close(got, w):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert np.abs(got.detach().float().numpy() - w).max() <= tol * max(
            np.abs(w).max(), 1.0)

    close(out, want)
    close(xt.grad, gx)
    gsd = export_torch_state_dict(gp)
    assert set(gsd) == {n for n, _ in attn.named_parameters()}
    for n, p in attn.named_parameters():
        close(p.grad, gsd[n])


def _spies(monkeypatch):
    calls = {"fused_attn_layer": 0, "fused_mha": 0}
    for name in calls:
        real = getattr(tlayers, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tlayers, name, spy)
    return calls


# (case, Attention kwargs, forward kwargs, tokens, route): the K4 gate needs
# C % 128 == 0 and a 2-byte dtype
ROUTES = [
    ("k4_when_fused", dict(use_fused_kernel=True), dict(fused=True), 16,
     "fused_attn_layer"),
    ("explicit_for_weights", dict(use_fused_kernel=True),
     dict(fused=False, return_attn=True), 16, None),
    ("explicit_for_attn_dropout", dict(use_fused_kernel=True, attn_drop=0.1),
     dict(fused=True), 16, None),
    ("k7_under_the_flag", dict(use_fused_kernel=True), dict(fused=False), 16,
     "fused_mha"),
    ("k7_past_the_k4_gate", dict(use_fused_kernel=True), dict(fused=True),
     300, "fused_mha"),
    ("plain_without_the_flag", {}, dict(fused=False), 16, None),
    ("plain_past_the_k7_gate", dict(use_fused_kernel=True),
     dict(fused=False), 1025, None),
    ("plain_in_f32", dict(use_fused_kernel=True, dtype=torch.float32),
     dict(fused=False), 16, None),
]


@pytest.mark.parametrize("case,kw,call,tokens,route", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_attention_takes_the_route_jax_takes(monkeypatch, case, kw, call,
                                             tokens, route):
    """K4 when ``fused`` and its gate hold; the explicit softmax path when
    attention weights or attention dropout are asked for; K7 under
    ``use_fused_kernel`` inside its gate in bf16; the plain product
    otherwise (layers.py:249-304)."""
    calls = _spies(monkeypatch)
    c, h = 128, 4
    kw = {"dtype": torch.bfloat16, **kw}
    attn = tlayers.Attention(c, h, device="cpu", **kw).eval()
    x = torch.randn((1, tokens, c), generator=torch.Generator().manual_seed(
        0)).to(kw["dtype"])
    out, weights = attn(x, **call)
    assert out.shape == (1, tokens, c)
    assert (weights is not None) == call.get("return_attn", False)
    want = dict.fromkeys(calls, 0)
    if route:
        want[route] = 1
    assert calls == want


def _k8_events(rng, b, e, h, w):
    """Fractional xytp events from 2 before to 2 past the grid (strays,
    negative fractions that truncate to 0), sorted t, polarity {0, 1}."""
    return np.stack([
        rng.uniform(-2, w + 2, (b, e)),
        rng.uniform(-2, h + 2, (b, e)),
        np.sort(rng.uniform(0, 1, (b, e)), axis=1),
        rng.integers(0, 2, (b, e)).astype(np.float64),
    ], axis=-1).astype(np.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = jpv.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpv.pl, "pallas_call", patched)


# the sequential scatter on both sides, the same f32 weights; the adds run
# in another order
K8_ATOL = 1e-5


@pytest.mark.parametrize("h,w,bins", [(8, 16, 5), (16, 16, 4)])
def test_voxelize_batch_scatter_matches_jax_pallas(interpret_pallas, h, w,
                                                   bins):
    rng = np.random.default_rng(h * w + bins)
    e = 256
    ev = _k8_events(rng, 3, e, h, w)
    counts = np.array([e, 1, 0], np.int32)
    want = jpv.voxelize_batch_pallas.__wrapped__(
        jnp.asarray(ev), jnp.asarray(counts), num_bins=bins, height=h,
        width=w, chunk=128)
    got = voxelize_batch_scatter(torch.from_numpy(ev),
                                 torch.from_numpy(counts), num_bins=bins,
                                 height=h, width=w)
    assert got.shape == (3, h, w, bins) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K8_ATOL)
    assert float(got[2].abs().max()) == 0.0
    # K3's voxelize_batch computes the same function
    k3 = voxelize_batch(torch.from_numpy(ev), torch.from_numpy(counts),
                        num_bins=bins, height=h, width=w)
    np.testing.assert_allclose(got.numpy(), k3.numpy(), atol=K8_ATOL)


def test_voxelize_batch_scatter_keeps_jax_grid_contract():
    ev = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="multiple of 128"):
        voxelize_batch_scatter(ev, torch.tensor([4]), num_bins=5, height=10,
                               width=10)


def test_k7_k8_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU must launch the kernel or raise; a
    'meta' tensor cannot launch, so each wrapper raises, inside the gate and
    past it."""
    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device="meta")

    for l in (16, 1025):
        q = z(1, l, 2, 32)
        with pytest.raises(ValueError, match="expected cuda"):
            fused_mha(q, q, q, scale=0.1)
        with pytest.raises(ValueError, match="expected cuda"):
            fused_mha_bwd(q, q, q, q, scale=0.1)
    with pytest.raises(ValueError, match="expected cuda"):
        voxelize_batch_scatter(z(1, 8, 4, dtype=torch.float32),
                               z(1, dtype=torch.int32), num_bins=5,
                               height=16, width=16)
    assert fused_mha.launches == fused_mha.launches_bwd == 0
    assert voxelize_batch_scatter.launches == 0


# ------------------------------------------------------------ prefetcher

def _cls_pipe(seed):
    src = tcp.SyntheticClsSource(num_classes=2, samples_per_class=6,
                                 num_events=400, sensor_hw=(24, 32), seed=3)
    cfg = tcp.ClsDataConfig(num_classes=2, input_size=32, canvas_height=32,
                            canvas_width=32, fix_events_num=300,
                            transfer_codec="u32")
    return tcp.ClsPipeline(src, cfg, 4, train=True, seed=seed,
                           device="cpu")


def test_prefetcher_yields_the_pipelines_batches_in_order():
    """The cls pipeline (numpy draws for windows, augments and views) gives
    the same batches, in the same order, through the prefetcher."""
    want = list(_cls_pipe(11))
    got = list(Prefetcher(_cls_pipe(11)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], torch.Tensor):
                assert torch.equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def test_prefetcher_produces_off_the_main_thread():
    seen = []

    def gen():
        for i in range(3):
            seen.append(threading.current_thread())
            yield i

    assert list(Prefetcher(gen())) == [0, 1, 2]
    assert seen and all(t is not threading.main_thread() for t in seen)
    assert all(not t.is_alive() for t in seen)


def test_prefetcher_raises_the_producers_error_in_the_consumer():
    def gen():
        yield 1
        raise KeyError("bad sample")

    it = iter(Prefetcher(gen()))
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad sample"):
        next(it)


def _live_producers():
    return [t for t in threading.enumerate() if t.name == "Prefetcher"]


@pytest.mark.parametrize("stop", ["break", "step_raises"])
def test_an_early_stop_leaves_no_live_producer(stop):
    """A consumer that breaks, or a step that raises inside
    ``train_one_epoch``, stops and joins the producer, which was waiting on
    a full queue, and closes the pipeline's iterator."""
    closed = []

    def gen():
        try:
            for i in range(1000):
                yield {"i": i}
        finally:
            closed.append(True)

    if stop == "break":
        batches = iter(Prefetcher(gen()))
        for batch in batches:
            if batch["i"] == 1:
                break
        batches.close()
    else:
        def step(state, batch):
            raise RuntimeError("step failed")

        with pytest.raises(RuntimeError, match="step failed"):
            tloop.train_one_epoch(step, None, gen())
    assert closed == [True]
    assert _live_producers() == []


class _TinyState:
    """A linear model trained by SGD, so each step's metrics depend on the
    steps before it."""

    def __init__(self):
        gen = torch.Generator().manual_seed(0)
        self.w = torch.randn((3, 2), generator=gen)


def _tiny_step(state, batch):
    x, y = batch["x"], batch["y"]
    w = state.w.clone().requires_grad_()
    loss = ((x @ w - y) ** 2).mean()
    loss.backward()
    state.w = state.w - 0.1 * w.grad
    return {"loss": loss.detach(), "wsum": state.w.sum()}


def _tiny_batches(n, weigh=False):
    rng = np.random.default_rng(2)
    out = []
    for i in range(n):
        b = {"x": torch.from_numpy(rng.standard_normal((5, 3)).astype(
            np.float32)), "y": torch.from_numpy(rng.standard_normal(
                (5, 2)).astype(np.float32))}
        if weigh:
            b["n"] = i + 1
        out.append(b)
    return out


def test_loops_give_the_metrics_of_the_loop_without_prefetch():
    """``train_one_epoch`` and ``evaluate`` on a tiny f32 case give the
    metrics of the same loop run in the training thread (the loops before
    the prefetcher): a mean per step, and a mean weighted by ``_n``."""
    batches = _tiny_batches(7)
    ref_state = _TinyState()
    ref = [_tiny_step(ref_state, b) for b in batches]
    want = {k: sum(float(m[k]) for m in ref) / len(ref) for k in ref[0]}
    state, got = tloop.train_one_epoch(_tiny_step, _TinyState(), batches,
                                       print_freq=3)
    assert got == want
    assert torch.equal(state.w, ref_state.w)

    def eval_step(batch):
        return {"err": (batch["x"].sum() - batch["y"].sum()).abs(),
                "_n": batch["n"]}

    vb = _tiny_batches(5, weigh=True)
    total = sum(b["n"] for b in vb)
    want = {"err": sum(float(eval_step(b)["err"]) * b["n"] for b in vb)
            / total}
    assert tloop.evaluate(eval_step, vb, print_freq=2) == want
