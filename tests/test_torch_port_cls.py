"""The port's cls-serving slice against the JAX package on the CPU.

A tiny ViT-S-shaped hub (depth 2, C=128, 4 heads, 64x64 input, L=16, 5
bins, 3 classes) is initialised in JAX, carried across with
``export_torch_state_dict`` -> ``load_jax_state_dict`` (strict), and the
port's logits, preprocessing and served function are held against JAX.
JAX runs its XLA composition on the CPU (the fused kernels are TPU-only
there); the port runs f32, where its fused-kernel gates are closed too.
The port's factories build on the card unless asked for the CPU, so every
test passes ``device="cpu"``.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import (
    export_torch_state_dict,
    save_torch_checkpoint,
)
from eventpretrain_tpu.data.cls_pipeline import (
    _device_preprocess as j_preprocess,
)
from eventpretrain_tpu.models.cls_hub import cls_hub_vit_small as j_hub
from eventpretrain_tpu.ops.view_augment import ViewParams as JViewParams
from eventpretrain_tpu_torch.ckpt.bridge import load_jax_state_dict
from eventpretrain_tpu_torch.cli.serve import (
    build_hub,
    make_cls_infer,
    make_server,
)
from eventpretrain_tpu_torch.data.cls_pipeline import (
    _device_preprocess,
    eval_view_params,
)
from eventpretrain_tpu_torch.models.cls_hub import cls_hub_vit_small
from eventpretrain_tpu_torch.ops.fused_attn_layer import fused_ln_attn_layer
from eventpretrain_tpu_torch.ops.fused_mlp import fused_ln_mlp
from eventpretrain_tpu_torch.ops.splat import splat

from tests._port_threads import one_torch_thread  # noqa: F401

TINY = dict(embed_dim=128, depth=2, num_heads=4, input_size=64)
NUM_CLASSES = 3
CANVAS = (48, 48)
# f32 on both sides; the ViT's matmuls and LayerNorms sum in other orders
LOGIT_ATOL = 1e-4
EVG_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_tiny():
    hub = j_hub(NUM_CLASSES, **TINY)
    variables = hub.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 5), jnp.float32))
    return hub, variables


@pytest.fixture(scope="module")
def port_tiny(jax_tiny):
    hub = cls_hub_vit_small(NUM_CLASSES, device="cpu", **TINY)
    load_jax_state_dict(hub, export_torch_state_dict(jax_tiny[1]["params"]))
    return hub.eval()


def _raw_events(rng, b=3, e=600):
    ev = np.zeros((b, e, 4), np.float32)
    counts = np.array([e, 410, 0][:b], np.int32)
    sensor = np.array([[30, 40], [25, 35], [48, 48]][:b], np.int32)
    for i in range(b):
        h, w = sensor[i]
        n = counts[i]
        ev[i, :n, 0] = rng.integers(0, w, n)
        ev[i, :n, 1] = rng.integers(0, h, n)
        ev[i, :n, 2] = np.sort(rng.uniform(0, 0.05, n))
        ev[i, :n, 3] = rng.integers(0, 2, n)
    return ev, counts, sensor


def _jax_served(jax_tiny, ev, counts, sensor):
    hub, variables = jax_tiny
    b = ev.shape[0]
    params = JViewParams(
        crop_y=jnp.zeros((b,), jnp.int32), crop_x=jnp.zeros((b,), jnp.int32),
        crop_h=jnp.asarray(sensor[:, 0]), crop_w=jnp.asarray(sensor[:, 1]),
        hflip=jnp.zeros((b,), bool), tflip=jnp.zeros((b,), bool),
    )
    evg = j_preprocess(
        jnp.asarray(ev), jnp.asarray(counts), jnp.asarray(sensor), params,
        num_bins=5, height=CANVAS[0], width=CANVAS[1], out_size=64,
        mode="bilinear",
    )
    _, logits, _ = hub.apply(variables, evg, train=False)
    return np.asarray(evg), np.asarray(logits)


def test_weights_carry_across_strictly(jax_tiny, port_tiny):
    flat = export_torch_state_dict(jax_tiny[1]["params"])
    assert set(flat) == set(port_tiny.state_dict())
    np.testing.assert_array_equal(
        port_tiny.backbone.vit_block[1].attn.qkv.weight.detach().numpy(),
        flat["backbone.vit_block.1.attn.qkv.weight"],
    )
    missing = dict(flat)
    missing.pop("backbone.norm_layer.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_state_dict(
            cls_hub_vit_small(NUM_CLASSES, device="cpu", **TINY), missing)
    extra = dict(flat, **{"backbone.pos_embed": np.zeros((1, 16, 128))})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_state_dict(
            cls_hub_vit_small(NUM_CLASSES, device="cpu", **TINY), extra)


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_jax(jax_tiny, port_tiny, seed):
    hub, variables = jax_tiny
    x = np.random.default_rng(seed).normal(size=(2, 64, 64, 5)).astype(
        np.float32)
    emb_j, logits_j, _ = hub.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        emb_t, logits_t, _ = port_tiny(torch.from_numpy(x))
    assert logits_t.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_ATOL)


def test_attention_weights_and_pyramid_match_jax(jax_tiny, port_tiny):
    hub, variables = jax_tiny
    x = np.random.default_rng(7).normal(size=(1, 64, 64, 5)).astype(
        np.float32)
    _, _, attn_j = hub.apply(variables, jnp.asarray(x), return_attn=True)
    with torch.no_grad():
        _, _, attn_t = port_tiny(torch.from_numpy(x), return_attn=True)
        out = port_tiny.backbone.encode_dense(torch.from_numpy(x))
    assert attn_t.shape == (1, 4, 16, 16)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j),
                               atol=LOGIT_ATOL)
    assert out[3] == []  # out_indices (3, 5, 7, 11) lie past depth 2


def test_preprocess_matches_jax(jax_tiny):
    ev, counts, sensor = _raw_events(np.random.default_rng(2))
    evg_j, _ = _jax_served(jax_tiny, ev, counts, sensor)
    sensor_t = torch.from_numpy(sensor)
    evg_t = _device_preprocess(
        torch.from_numpy(ev), torch.from_numpy(counts), sensor_t,
        eval_view_params(sensor_t), num_bins=5, height=CANVAS[0],
        width=CANVAS[1], out_size=64, mode="bilinear",
    )
    assert evg_t.shape == (3, 64, 64, 5)
    np.testing.assert_allclose(evg_t.numpy(), evg_j, atol=EVG_ATOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_served_function_matches_jax(jax_tiny, port_tiny, seed):
    ev, counts, sensor = _raw_events(np.random.default_rng(seed))
    _, logits_j = _jax_served(jax_tiny, ev, counts, sensor)
    infer = make_cls_infer(port_tiny, num_bins=5, canvas=CANVAS,
                           input_size=64)
    got = infer(ev, counts, sensor)
    assert got.dtype == np.float32 and got.shape == (3, NUM_CLASSES)
    np.testing.assert_allclose(got, logits_j, atol=LOGIT_ATOL)


def test_bf16_hub_takes_fused_plain_versions(jax_tiny, port_tiny):
    """In bf16 the K1/K2 gates open; on the CPU the wrappers run their plain
    versions (no launch is counted) and stay near the f32 logits."""
    hub16 = cls_hub_vit_small(NUM_CLASSES, dtype=torch.bfloat16,
                              device="cpu", **TINY)
    hub16.load_state_dict(port_tiny.state_dict())
    # flax's split: f32 parameters, cast to the compute dtype at use
    assert {p.dtype for p in hub16.parameters()} == {torch.float32}
    ev, counts, sensor = _raw_events(np.random.default_rng(5))
    want = make_cls_infer(port_tiny, canvas=CANVAS, input_size=64)(
        ev, counts, sensor)
    got = make_cls_infer(hub16, canvas=CANVAS, input_size=64)(
        ev, counts, sensor)
    assert np.isfinite(got).all()
    # bf16 activations through two blocks: a few bf16 ulps of the logits
    assert np.abs(got - want).max() <= 5e-2 * max(1.0, np.abs(want).max())
    assert splat.launches == 0
    assert fused_ln_attn_layer.launches == 0 and fused_ln_mlp.launches == 0


def test_checkpoint_loads_through_serve_loader(tmp_path, jax_tiny,
                                               port_tiny):
    path = str(tmp_path / "tiny.pth")
    save_torch_checkpoint(path, jax_tiny[1]["params"])
    hub = build_hub(path, NUM_CLASSES, 5, "cpu", **TINY)
    assert hub.classify_head.weight.dtype == torch.float32
    for (k, a), (k2, b) in zip(hub.state_dict().items(),
                               port_tiny.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_full_width_checkpoint_loads(tmp_path):
    """ViT-S at full width: the exported key space loads strictly."""
    hub = j_hub(2)
    variables = jax.eval_shape(
        hub.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 5)))
    params = jax.tree.map(lambda s: np.full(s.shape, 0.5, np.float32),
                          variables["params"])
    path = str(tmp_path / "vits.pth")
    save_torch_checkpoint(path, params)
    port = build_hub(path, 2, 5, "cpu")
    assert len(port.backbone.vit_block) == 12
    assert port.backbone.vit_block[11].mlp.fc2.weight[0, 0].item() == 0.5
    assert port.backbone.pos_embed.shape == (1, 196, 384)


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, *arrays)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


def test_http_round_trip(jax_tiny, port_tiny):
    infer = make_cls_infer(port_tiny, num_bins=5, canvas=CANVAS,
                           input_size=64)
    srv = make_server(infer, "tiny", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "artifact": "tiny", "kind": "cls_hub"}
        ev, counts, sensor = _raw_events(np.random.default_rng(6))
        got = _post(url, (ev, counts, sensor))
        _, want = _jax_served(jax_tiny, ev, counts, sensor)
        assert got.dtype == np.float32 and got.shape == (3, NUM_CLASSES)
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
        np.testing.assert_array_equal(got, infer(ev, counts, sensor))
        req = urllib.request.Request(url + "/predict", data=b"junk",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
