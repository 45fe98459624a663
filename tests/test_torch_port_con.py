"""The port's contrastive stages (slice 4a: stage 2, backbone-fixed feature
transition, and stage 3, focus-aimed contrast, on precomputed CLIP token
embeddings) against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its port:
both InfoNCE losses with their gradients and the queue's enqueue, the
grouped BatchNorm at inputs with a large mean, the projector heads and
``forward_con`` of a tiny hub carried across with
``export_torch_state_dict(params, batch_stats)`` -> ``load_jax_state_dict``,
stage 2's trainable set, the CLIP embeddings' data path, the frozen
trunk's forward-only blocks and the stage CLI. The steps' trajectories
are in ``test_torch_port_con_steps.py``. Every JAX half runs under
``jax.jit``; f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.data import pretrain_pipeline as jpipe
from eventpretrain_tpu.models import layers as jlayers
from eventpretrain_tpu.objectives import contrastive as jcon
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_queue,
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.cli import pretrain as cli
from eventpretrain_tpu_torch.data import pretrain_pipeline as tpipe
from eventpretrain_tpu_torch.models.layers import (
    GroupedBatchNorm,
    ViTBlock,
)
from eventpretrain_tpu_torch.objectives import contrastive as tcon
from eventpretrain_tpu_torch.train import optim as toptim

from tests._con_port import (
    CLI_COMMON,
    CLIP_DIM,
    CLIP_TOKENS,
    EMBED,
    NUM_PATCHES,
    jax_hub,
    jax_variables,
    numpy_batch,
    port_hub,
    queue_buffer,
    tiny_cli_hub,
)
from tests._port_threads import one_torch_thread  # noqa: F401

# f32 on both sides; the InfoNCE losses sum over at most a few hundred
# terms in other orders
LOSS_ATOL = 1e-5
# LayerNorms, BatchNorms and matmuls of the tiny hub sum in other orders
FWD_ATOL = 1e-4


# -------------------------------------------------------- the objectives


def _qk(seed, b=4, l=NUM_PATCHES, c=EMBED):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, l, c)) * 3 + 0.5).astype(np.float32)
    k = rng.normal(size=(b, l, c)).astype(np.float32)
    return q, k


@pytest.mark.parametrize("ptr", [None, 0, 8, 10],
                         ids=["global", "queue_ptr0", "queue_wrap",
                              "queue_clamp"])
def test_infonce_losses_gradients_and_enqueue_match_jax(ptr):
    """Both losses and their gradients with respect to q and k within
    1e-5; the queue's new buffer (the keys enqueued as k^T at ptr, a start
    past K - B clamped as dynamic_update_slice does) and ptr + B mod K."""
    q, k = _qk(1)
    tq, tk = (torch.from_numpy(a).requires_grad_() for a in (q, k))
    if ptr is None:
        want, (wq, wk) = jax.jit(jax.value_and_grad(
            jcon.global_token_infonce, argnums=(0, 1)))(q, k)
        got = tcon.global_token_infonce(tq, tk)
    else:
        buf = queue_buffer(12, seed=2)
        jq = jcon.QueueState(buffer=jnp.asarray(buf),
                             ptr=jnp.asarray(ptr, jnp.int32))
        (want, new_j), (wq, wk) = jax.jit(jax.value_and_grad(
            jcon.token_infonce_queue, argnums=(0, 1), has_aux=True))(
                q, k, jq)
        queue = load_jax_queue(buf, ptr)
        got, new_t = tcon.token_infonce_queue(tq, tk, queue)
        assert new_t.buffer is queue.buffer  # enqueued in place
        assert new_t.ptr == int(new_j.ptr) == (ptr + 4) % 12
        # the enqueued keys are normalised on both sides: one ulp apart
        np.testing.assert_allclose(new_t.buffer.numpy(),
                                   np.asarray(new_j.buffer), rtol=0,
                                   atol=1e-7)
        assert not np.array_equal(new_t.buffer.numpy(), buf)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=LOSS_ATOL)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(wq),
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(wk),
                               atol=LOSS_ATOL)


def test_queue_loss_without_gradients_and_init():
    """Under no_grad the queue loss computes no gradient and still
    enqueues; ``init_queue`` draws from its generator alone, normalised
    over the channels."""
    q, k = _qk(3)
    buf = queue_buffer(12, seed=4)
    queue = load_jax_queue(buf, 0)
    with torch.no_grad():
        loss, new = tcon.token_infonce_queue(torch.from_numpy(q),
                                             torch.from_numpy(k), queue)
    want, _ = jax.jit(jcon.token_infonce_queue)(
        q, k, jcon.QueueState(jnp.asarray(buf), jnp.asarray(0, jnp.int32)))
    np.testing.assert_allclose(float(loss), float(want), atol=LOSS_ATOL)
    assert new.ptr == 4
    a = tcon.init_queue(torch.Generator().manual_seed(5), 8, 3, 6, "cpu")
    b = tcon.init_queue(torch.Generator().manual_seed(5), 8, 3, 6, "cpu")
    assert a.ptr == 0 and a.buffer.shape == (8, 3, 6)
    assert torch.equal(a.buffer, b.buffer)
    np.testing.assert_allclose(torch.linalg.vector_norm(a.buffer, dim=0),
                               1.0, rtol=1e-6)


# ------------------------------------------------------ BatchNorm, heads


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("train", [True, False])
def test_grouped_batchnorm_matches_flax_at_a_large_mean(groups, train):
    """Rows of mean ~500 and spread ~2: the mean of squared deviations
    keeps the variance (E[x^2] - mean^2 would lose it to f32); the running
    update is flax's momentum 0.99 on the biased variance, averaged over
    the groups."""
    rng = np.random.default_rng(6)
    x = (500.0 + rng.normal(size=(16, 24)) * 2
         + rng.normal(size=(1, 24)) * 50).astype(np.float32)
    mod = jlayers.GroupedBatchNorm(groups=groups)
    v = mod.init(jax.random.key(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(1 + 0.1 * rng.normal(size=24),
                                         jnp.float32),
                    "bias": jnp.asarray(rng.normal(size=24), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(x.mean(0) + 0.5, jnp.float32),
                         "var": jnp.asarray(4 + rng.uniform(size=24),
                                            jnp.float32)}}
    want, upd = jax.jit(lambda v, x: mod.apply(v, x, train,
                                               mutable=["batch_stats"]))(v, x)
    bn = GroupedBatchNorm(24, groups, device="cpu")
    load_jax_state_dict(bn, {
        "weight": np.asarray(v["params"]["scale"]),
        "bias": np.asarray(v["params"]["bias"]),
        "running_mean": np.asarray(v["batch_stats"]["mean"]),
        "running_var": np.asarray(v["batch_stats"]["var"])})
    bn.train(train)
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-4)


@pytest.mark.parametrize("bn_groups", [1, 2])
def test_forward_con_loads_the_export_strictly_and_matches_jax(bn_groups):
    """The whole hub (backbone, decoder, both projectors with their
    BatchNorm statistics, the CLIP norm and projection) loads
    ``export_torch_state_dict(params, batch_stats)`` strictly; the
    projectors' keys are the reference's nn.Sequential indices.
    ``forward_con`` in eval mode (running statistics, the last block's
    attention) and in training mode (batch statistics, the running
    update) agrees with JAX's."""
    params, stats = jax_variables(bn_groups=bn_groups)
    flat = export_torch_state_dict(params, stats)
    hub = load_jax_state_dict(port_hub(bn_groups=bn_groups), flat)
    assert set(flat) == set(hub.state_dict())
    for key in ("emb_h_proj.0.weight", "emb_h_proj.1.running_var",
                "emb_h_proj.6.weight", "emb_h_proj.7.running_mean",
                "emb_h_pred.4.running_var", "clip_emb_proj.weight",
                "norm_clip_emb.bias"):
        assert key in flat, key
    assert "emb_h_proj.7.weight" not in flat  # the last BN has no affine
    jhub = jax_hub(bn_groups=bn_groups)
    b = numpy_batch(7)
    evg, clip = b["evg"], b["clip_emb"]
    for train in (False, True):
        fn = jax.jit(lambda p, s, e, c: jhub.apply(
            {"params": p, "batch_stats": s}, e, c, train=train,
            return_attn=not train, method=jhub.forward_con,
            mutable=["batch_stats"]))
        want, upd = fn(params, stats, evg, clip)
        hub.train(train)
        with torch.no_grad():
            got = hub.forward_con(torch.from_numpy(evg),
                                  torch.from_numpy(clip),
                                  return_attn=not train)
        assert got[0].shape == (4, NUM_PATCHES, EMBED)
        assert (got[4] is None) == train
        for g, w in zip(got, want):
            if w is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=FWD_ATOL)
        want_stats = export_torch_state_dict({}, upd["batch_stats"])
        for k, w in want_stats.items():
            np.testing.assert_allclose(hub.state_dict()[k].numpy(), w,
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_trainable_set_matches_frozen_except_norm_mask():
    """Stage 2 trains the backbone's ``norm_layer`` and everything outside
    the backbone (optim.py:123-135); the optimizer holds exactly those."""
    params, _ = jax_variables()
    want = {k: bool(v) for k, v in export_torch_state_dict(
        joptim.frozen_except_norm_mask(params)).items()}
    hub = port_hub()
    names = [n for n, _ in hub.named_parameters()]
    assert toptim.frozen_except_norm_mask(names) == want
    mask = toptim.freeze_except_norm(hub)
    assert mask == want
    assert {n for n, p in hub.named_parameters() if p.requires_grad} == {
        n for n, t in want.items() if t}
    assert want["backbone.norm_layer.weight"]
    assert not want["backbone.vit_block.0.attn.qkv.weight"]
    assert want["emb_h_proj.0.weight"]
    opt = toptim.build_optimizer(hub, weight_decay=0.05)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    assert held == {id(p) for p in hub.parameters() if p.requires_grad}


def test_frozen_block_runs_forward_only_under_enabled_gradients():
    """A frozen ViTBlock under enabled gradients, on an input that needs
    none, is held to the forward gate only (C = 1024 is past the LayerNorm
    backward's width, so a trainable block would not fuse) and keeps no
    saved tensor; its output is the no_grad output bit for bit."""
    blk = ViTBlock(1024, 16, dtype=torch.bfloat16, device="cpu")
    blk.train()
    x = torch.randn((2, 16, 1024), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.no_grad():
        assert blk._fuse_block(x, False)
        want = blk(x)
    with torch.enable_grad():
        assert not blk._fuse_block(x, False)  # a trainable block
    for p in blk.parameters():
        p.requires_grad_(False)
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        assert blk._fuse_block(x, False)
        got = blk(x)
    assert not got.requires_grad and saved == []
    assert torch.equal(got, want)
    blk.norm1.weight.requires_grad_(True)
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        assert not blk._fuse_block(x, False)
        blk(x)
    assert saved  # a trainable part is recorded


# ------------------------------------------------------------ data path


def test_synthetic_source_draws_jax_clip_embeddings_and_batches():
    """The source's arrays byte for byte (the CLIP draw after the frame's),
    and the pipeline's contrastive batches: what each phase holds, the
    grid exactly, the CLIP embeddings exactly, the frame at 1e-5."""
    kw = dict(n=8, size=32, num_bins=5, clip_dim=CLIP_DIM,
              clip_tokens=CLIP_TOKENS, seed=3)
    js, ts = jpipe.SyntheticPretrainSource(**kw), \
        tpipe.SyntheticPretrainSource(**kw)
    for i in (0, 5):
        want, got = js.load(i), ts.load(i)
        assert set(got) == set(want) == {"evg", "frame", "clip_emb"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    d = tpipe.SyntheticPretrainSource(n=1).load(0)["clip_emb"]
    assert d.shape == (197, 512)
    for phase, keys in (("adj", {"evg", "clip_emb"}),
                        ("rec+con", {"evg", "frame", "clip_emb"})):
        jp = jpipe.PretrainPipeline(js, jpipe.PretrainDataConfig(
            pr_phase=phase, input_size=32), 4, seed=5, num_workers=0)
        tp = tpipe.PretrainPipeline(ts, tpipe.PretrainDataConfig(
            pr_phase=phase, input_size=32), 4, seed=5, num_workers=2,
            device="cpu")
        for want, got in zip(jp, tp):
            assert set(got) == set(want) == keys
            np.testing.assert_array_equal(got["evg"].numpy(),
                                          np.asarray(want["evg"]))
            np.testing.assert_array_equal(got["clip_emb"].numpy(),
                                          np.asarray(want["clip_emb"]))
            if "frame" in keys:
                np.testing.assert_allclose(got["frame"].numpy(),
                                           np.asarray(want["frame"]),
                                           atol=1e-5)


def _ef_tree(root, rng):
    """Two images of the reference EF-ImageNet layout, two frames each:
    CHW voxel grids and sub-frames, (1, 1 + L, 512)-style CLIP tensors."""
    for cls, name in (("n01", "img_a"), ("n02", "img_b")):
        base = root / cls / name
        (base / "events" / "noisy").mkdir(parents=True)
        (base / "sub_frames").mkdir()
        for f in range(2):
            torch.save(torch.from_numpy(rng.normal(size=(5, 16, 20)).astype(
                np.float32)), base / "events" / "noisy"
                / f"{name}_0{f}_noisy_events_voxel_grid.pt")
            torch.save(torch.from_numpy(rng.normal(size=(1, 16, 20)).astype(
                np.float32)),
                base / "sub_frames" / f"{name}_0{f}_sub_frame.pt")
        torch.save(torch.from_numpy(rng.normal(
            size=(1, CLIP_TOKENS, CLIP_DIM)).astype(np.float32)),
            base / f"{name}_clip_emb.pt")


@pytest.mark.parametrize("phase", ["rec", "adj", "con", "rec+con"])
def test_ef_imagenet_source_reads_clip_embeddings_like_jax(tmp_path, phase):
    _ef_tree(tmp_path, np.random.default_rng(8))
    kw = dict(pr_phase=phase, num_frames=2, seed=4)
    js = jpipe.EFImageNetSource(str(tmp_path), **kw)
    ts = tpipe.EFImageNetSource(str(tmp_path), **kw)
    assert len(ts) == len(js) == 2
    for visit in range(2):
        for i in range(2):
            want, got = js.load(i), ts.load(i)
            assert set(got) == set(want)
            assert ("clip_emb" in got) == (phase != "rec")
            assert ("frame" in got) == (phase in ("rec", "rec+con"))
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            if "clip_emb" in got:
                assert got["clip_emb"].shape == (CLIP_TOKENS, CLIP_DIM)


# ------------------------------------------------------------------ CLI


def test_cli_chains_the_stages_through_init_from(tmp_path, monkeypatch):
    """rec -> adj -> con (queue) -> con again, each from the last one's
    checkpoint: stage 2 leaves the frozen trunk as stage 1 wrote it bit
    for bit and moves its norm_layer; the checkpoints hold the projectors'
    BatchNorm buffers and the queue, and the next stage seeds its queue
    from them."""
    monkeypatch.setattr(cli, "pretrain_hub_small", tiny_cli_hub)
    runs = {}
    for name, phase, extra in (
            ("rec", "rec", []),
            ("adj", "_adj", ["--init_from", "rec"]),
            ("con", "con", ["--init_from", "adj", "--use_queue",
                            "--queue_length", "16"]),
            ("con2", "con", ["--init_from", "con", "--use_queue",
                             "--queue_length", "16"])):
        extra = [str(tmp_path / a / "checkpoint.pth")
                 if a in runs else a for a in extra]
        state = cli.main(["--pr_phase", phase, "--output_dir",
                          str(tmp_path / name)] + CLI_COMMON + extra)
        assert state.step == 4, name
        runs[name] = load_torch_checkpoint(
            str(tmp_path / name / "checkpoint.pth"))
    rec, adj, con = runs["rec"], runs["adj"], runs["con"]
    assert not any(k.startswith("emb_h_proj") for k in rec)
    assert not any(k.startswith("pretrain_rec_decoder") for k in adj)
    for k, v in adj.items():
        if k.startswith("backbone.") and "norm_layer" not in k:
            assert torch.equal(v, rec[k]), k
    assert not torch.equal(adj["backbone.norm_layer.weight"],
                           rec["backbone.norm_layer.weight"])
    assert "emb_h_proj.1.running_mean" in adj and "queue" not in adj
    assert con["queue"].shape == (64, 196, 16)
    assert int(con["queue_ptr"][0]) == 32 % 16
    # the second con run starts from the first one's queue
    assert not torch.equal(runs["con2"]["queue"], con["queue"])
    state = cli.main(["--pr_phase", "con", "--output_dir",
                      str(tmp_path / "c3"), "--init_from",
                      str(tmp_path / "con" / "checkpoint.pth"), "--use_queue",
                      "--queue_length", "16"] + CLI_COMMON + ["--epochs", "0"])
    assert torch.equal(state.queue.buffer, con["queue"])


@pytest.mark.parametrize("argv,error", [
    (["--pr_phase", "ecdp", "--data_parallel"], NotImplementedError),
    (["--pr_phase", "con", "--use_queue", "--queue_length", "24",
      "--accum_iter", "2"], ValueError),
    (["--pr_phase", "con", "--data_parallel"], NotImplementedError),
    (["--pr_phase", "rec", "--visualize"], NotImplementedError),
    (["--pr_phase", "adj", "--init_from", "some_orbax_dir"],
     NotImplementedError),
    (["--pr_phase", "con", "--input_size", "32"], ValueError),
    (["--pr_phase", "con", "--use_queue", "--queue_length", "20"],
     ValueError),
], ids=["ecdp", "accum_iter", "data_parallel", "visualize",
        "orbax", "patches", "queue_length"])
def test_cli_refuses_what_the_port_lacks(monkeypatch, tmp_path, argv, error):
    monkeypatch.setattr(cli, "pretrain_hub_small", tiny_cli_hub)
    with pytest.raises(error):
        cli.main(argv + CLI_COMMON + ["--output_dir", str(tmp_path)])
