"""The port's stage-1 rec training slice against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its port:
masking, reshapes, view parameters and augments, the pretrain pipeline, a
tiny pretrain hub (modelled on tests/test_train.py, widths 128 so that the
fused-kernel gates open in bf16) carried across with
``export_torch_state_dict`` -> ``load_jax_state_dict``, the loss, the
optimizer, short training trajectories and the CLI. ``jax.random`` cannot
be reproduced, so the trajectories replay explicit masks. The port's
factories build on the card unless asked for the CPU, so every test passes
``device="cpu"``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.data import pretrain_pipeline as jpipe
from eventpretrain_tpu.models.decoder import RecDecoder as JRecDecoder
from eventpretrain_tpu.models.pretrain_hub import PrHub as JPrHub
from eventpretrain_tpu.models.vit import ViT as JViT
from eventpretrain_tpu.objectives.rec import reconstruct_loss as j_loss
from eventpretrain_tpu.ops import masking as jmask
from eventpretrain_tpu.ops import reshape as jreshape
from eventpretrain_tpu.ops import view_augment as jva
from eventpretrain_tpu.ops.pallas_common import force_fused
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import make_rec_step as j_make_rec_step
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.data import pretrain_pipeline as tpipe
from eventpretrain_tpu_torch.models.decoder import RecDecoder
from eventpretrain_tpu_torch.models.pretrain_hub import PrHub
from eventpretrain_tpu_torch.models.vit import ViT
from eventpretrain_tpu_torch.objectives.rec import reconstruct_loss
from eventpretrain_tpu_torch.ops import masking as tmask
from eventpretrain_tpu_torch.ops import reshape as treshape
from eventpretrain_tpu_torch.ops import view_augment as tva
from eventpretrain_tpu_torch.ops.fused_attn_layer import fused_ln_attn_layer
from eventpretrain_tpu_torch.ops.fused_mlp import fused_ln_mlp
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import make_rec_step

from tests._port_threads import one_torch_thread  # noqa: F401

# the tiny hub: 32x32 input, patch 8 -> 16 patches, 4 kept
ENC = dict(input_size=32, patch_size=8, embed_dim=128, depth=4, num_heads=4,
           num_bins=5, out_indices=(1, 3))
DEC = dict(patch_size=8, num_patches=16, embed_dim=128, depth=2, num_heads=4,
           frame_chans=1)
NUM_PATCHES, LEN_KEEP, PATCH = 16, 4, 8


def _jax_hub(dtype=jnp.float32):
    return JPrHub(
        backbone=JViT(**ENC, dtype=dtype, name="backbone"),
        decoder=JRecDecoder(**DEC, dtype=dtype,
                            name="pretrain_rec_decoder"),
        embed_dim=128, num_patches=NUM_PATCHES,
    )


def _port_hub(dtype=torch.float32):
    backbone = ViT(**ENC, dtype=dtype, device="cpu")
    return PrHub(backbone, RecDecoder(128, **DEC, dtype=dtype, device="cpu"))


@pytest.fixture(scope="module")
def jax_params():
    hub = _jax_hub()
    v = jax.jit(lambda *a: hub.init(*a, method=hub.forward_rec))(
        jax.random.key(0), jnp.zeros((1, 32, 32, 5)),
        jnp.arange(LEN_KEEP)[None], jnp.arange(NUM_PATCHES)[None])
    # a nonzero mask token, so its gradient path is exercised too
    p = jax.tree.map(lambda a: a, v["params"])
    p["decoder"]["mask_token"] = jnp.asarray(
        np.random.default_rng(9).normal(size=(1, 1, 128)) * 0.02,
        jnp.float32)
    return p


def _carry(params, dtype=torch.float32):
    hub = _port_hub(dtype)
    return load_jax_state_dict(hub, export_torch_state_dict(params))


def _batch(seed, b=3):
    """numpy evg/frame with an all-zero patch at a kept index, and an
    explicit masking."""
    rng = np.random.default_rng(seed)
    evg = rng.normal(size=(b, 32, 32, 5)).astype(np.float32)
    frame = rng.normal(size=(b, 32, 32, 1)).astype(np.float32)
    noise = rng.uniform(size=(b, NUM_PATCHES)).astype(np.float32)
    noise[0, 5] = -1.0  # patch 5 of sample 0 is kept...
    evg[0, 8:16, 8:16] = 0.0  # ...and empty (row 1, column 1 of the grid)
    ids_keep, mask, ids_restore = jmask.make_mask_from_noise(
        jnp.asarray(noise), LEN_KEEP)
    return dict(evg=evg, frame=frame, ids_keep=np.asarray(ids_keep),
                mask=np.asarray(mask), ids_restore=np.asarray(ids_restore))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("ids_keep", "ids_restore"):
        out[k] = out[k].long()
    return out


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------- repairs


@pytest.mark.parametrize("factory", [
    "models.vit.ViT", "models.cls_hub.cls_hub_vit_small",
    "models.cls_hub.cls_hub_vit_base", "models.decoder.RecDecoder",
    "models.pretrain_hub.pretrain_hub_small",
    "models.pretrain_hub.pretrain_hub_base", "cli.serve.build_hub",
    "models.dense_hub.dense_hub_vit_small",
    "models.dense_hub.dense_hub_vit_base",
    "data.dense_pipeline.DensePipeline",
    "objectives.contrastive.init_queue",
])
def test_factories_default_to_the_card(factory):
    import importlib

    mod, name = factory.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"eventpretrain_tpu_torch.{mod}"),
                 name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_the_card():
    from eventpretrain_tpu_torch.cli.pretrain import build_parser

    assert build_parser().parse_args([]).device == "cuda"


def test_semseg_cli_defaults_to_the_card():
    from eventpretrain_tpu_torch.cli.finetune_semseg import build_parser

    assert build_parser().parse_args([]).device == "cuda"


def test_parameters_are_f32_and_compute_in_the_dtype(jax_params):
    hub = _carry(jax_params, torch.bfloat16)
    assert {p.dtype for p in hub.parameters()} == {torch.float32}
    b = _tb(_batch(0))
    with torch.no_grad():
        pred, *_ = hub.forward_rec(b["evg"], b["ids_keep"], b["ids_restore"])
    assert pred.dtype == torch.bfloat16


# ----------------------------------------------------- masking, reshapes


def test_make_mask_from_noise_is_exact_with_ties():
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 4, size=(5, 49)).astype(np.float32)  # ties
    for len_keep in (1, 12, 48):
        want = jmask.make_mask_from_noise(jnp.asarray(noise), len_keep)
        got = tmask.make_mask_from_noise(torch.from_numpy(noise), len_keep)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("strategy", ["density", "anti-density"])
def test_density_noise_and_masking_are_exact(strategy):
    """Integer event counts with empty patches: every patch sum is exact in
    f32, so both sides agree bit for bit, ties included."""
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, size=(3, 32, 48, 5)).astype(np.float32)
    x[:, :16, :16] = 0.0  # four empty patches per sample tie at 0
    x[1] = 0.0
    want = jmask.masking_noise(None, jnp.asarray(x), 8, strategy)
    got = tmask.masking_noise(None, torch.from_numpy(x), 8, strategy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tmask.density_noise(torch.from_numpy(x), 8).numpy(),
        np.asarray(jmask.density_noise(jnp.asarray(x), 8)))
    for g, w in zip(tmask.make_mask_from_noise(got, 6),
                    jmask.make_mask_from_noise(want, 6)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_random_masking_shapes_and_inverse():
    gen = torch.Generator().manual_seed(0)
    ids_keep, mask, ids_restore = tmask.random_masking(gen, 4, 196, 0.75)
    assert ids_keep.shape == (4, 49) and mask.shape == (4, 196)
    assert float(mask.sum()) == 4 * 147
    shuffle = torch.argsort(ids_restore, dim=1)
    assert torch.equal(shuffle[:, :49], ids_keep)
    assert torch.all(torch.gather(mask, 1, ids_keep) == 0)


def test_reshapes_match_jax_and_round_trip():
    rng = np.random.default_rng(3)
    frame = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    emb = treshape.frame2emb(8, torch.from_numpy(frame))
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(jreshape.frame2emb(8, jnp.asarray(frame))))
    back = treshape.emb2frame(8, emb, 3)
    np.testing.assert_array_equal(back.numpy(), frame)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jreshape.emb2frame(8, jnp.asarray(emb), 3)))
    tok = rng.normal(size=(2, 16, 7)).astype(np.float32)
    pf = treshape.emb2patch_frame(torch.from_numpy(tok))
    np.testing.assert_array_equal(
        pf.numpy(), np.asarray(jreshape.emb2patch_frame(jnp.asarray(tok))))
    np.testing.assert_array_equal(treshape.patch_frame2emb(pf).numpy(), tok)


# ------------------------------------------------------ views, pipeline


def test_sample_view_params_identical_for_a_seed():
    for seed in range(3):
        want = jva.sample_view_params(np.random.default_rng(seed), 16, 60,
                                      80, scale_min=0.3)
        got = tva.sample_view_params(np.random.default_rng(seed), 16, 60,
                                     80, scale_min=0.3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_frame_augment_matches_jax():
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(6, 30, 40, 1)).astype(np.float32)
    jp = jva.sample_view_params(rng, 6, 30, 40, scale_min=0.3)
    want = jva.apply_frame_augment(jnp.asarray(frames), jp, (48, 56))
    tp = tva.ViewParams(*(torch.from_numpy(np.array(a)) for a in jp))
    got = tva.apply_frame_augment(torch.from_numpy(frames), tp, (48, 56))
    assert bool(tp.tflip.any()) and bool(tp.hflip.any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pretrain_pipeline_batch_matches_jax():
    kw = dict(n=8, size=32, num_bins=5, seed=3)
    jcfg = jpipe.PretrainDataConfig(input_size=32)
    tcfg = tpipe.PretrainDataConfig(input_size=32)
    jp = jpipe.PretrainPipeline(jpipe.SyntheticPretrainSource(**kw), jcfg, 4,
                                seed=5, num_workers=0)
    tp = tpipe.PretrainPipeline(tpipe.SyntheticPretrainSource(**kw), tcfg, 4,
                                seed=5, num_workers=2, device="cpu")
    assert len(tp) == len(jp) == 2
    for want, got in zip(jp, tp):
        assert set(got) == {"evg", "frame"}
        # nearest: exact one-hot resampling; bicubic: f32 sums in another
        # order
        np.testing.assert_array_equal(got["evg"].numpy(),
                                      np.asarray(want["evg"]))
        np.testing.assert_allclose(got["frame"].numpy(),
                                   np.asarray(want["frame"]), atol=1e-5)


# ------------------------------------------------------ hub and loss


def test_hub_carries_across_strictly(jax_params):
    flat = export_torch_state_dict(jax_params)
    hub = _carry(jax_params)
    assert set(flat) == set(hub.state_dict())
    assert hub.pretrain_rec_decoder.mask_token.shape == (1, 1, 128)
    missing = dict(flat)
    missing.pop("pretrain_rec_decoder.mask_token")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_state_dict(_port_hub(), missing)


# f32 on both sides; LayerNorms and matmuls sum in other orders
FWD_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_forward_rec():
    """JAX's ``forward_rec`` of the tiny hub, compiled once for the
    module."""
    jhub = _jax_hub()
    return jax.jit(lambda p, *a: jhub.apply({"params": p}, *a,
                                            method=jhub.forward_rec))


@pytest.mark.parametrize("norm_pix,mask_ratio", [(True, 0.75), (False, 0.75),
                                                 (True, 0.0)])
def test_forward_rec_and_loss_match_jax(jax_params, jax_forward_rec,
                                        norm_pix, mask_ratio):
    b = _batch(1)
    outs_j = jax_forward_rec(jax_params, jnp.asarray(b["evg"]),
                             jnp.asarray(b["ids_keep"]),
                             jnp.asarray(b["ids_restore"]))
    hub = _carry(jax_params)
    tb = _tb(b)
    with torch.no_grad():
        outs_t = hub.forward_rec(tb["evg"], tb["ids_keep"], tb["ids_restore"])
    assert outs_t[0].shape == (3, NUM_PATCHES, PATCH * PATCH)
    for g, w in zip(outs_t, outs_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_ATOL)
    kw = dict(patch_size=PATCH, norm_pix_loss=norm_pix, mask_ratio=mask_ratio)
    want = j_loss(outs_j[0], jnp.asarray(b["frame"]), jnp.asarray(b["mask"]),
                  **kw)
    got = reconstruct_loss(outs_t[0], tb["frame"], tb["mask"], **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ------------------------------------------------------------ optimizer


def test_schedule_matches_jax_with_lr_zero_first():
    args = (1e-3, 1e-5, 2, 10, 7)
    js, ts = joptim.cosine_warmup_schedule(*args), \
        toptim.cosine_warmup_schedule(*args)
    assert ts(0) == 0.0 == float(js(0))
    for step in range(0, 80, 3):
        # JAX evaluates the schedule in f32
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5,
                                   atol=1e-12)


@pytest.mark.parametrize("grafted", [False, True])
def test_layer_scales_and_wd_mask_match_jax(jax_params, grafted):
    want = export_torch_state_dict(joptim.layer_scale_tree(
        jax_params, 4, 0.75, layer_grafted=grafted))
    hub = _carry(jax_params)
    names = [n for n, _ in hub.named_parameters()]
    got = toptim.layer_scales(names, 4, 0.75, layer_grafted=grafted)
    assert set(got) == set(want)
    for n in names:
        np.testing.assert_allclose(got[n], float(want[n]), rtol=1e-6)
    want_wd = export_torch_state_dict(joptim.weight_decay_mask(jax_params))
    got_wd = toptim.weight_decay_mask(dict(hub.named_parameters()))
    assert {n: bool(v) for n, v in want_wd.items()} == got_wd
    assert got_wd["pretrain_rec_decoder.mask_token"]


def test_adamw_update_matches_optax(jax_params):
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-2, jnp.float32),
        jax_params)
    tx = joptim.build_optimizer(jax_params, learning_rate=lambda s: 1e-3,
                                weight_decay=0.05, layer_decay=0.75,
                                num_layers=4)
    updates, _ = jax.jit(tx.update)(grads, tx.init(jax_params), jax_params)
    want = export_torch_state_dict(optax.apply_updates(jax_params, updates))
    hub = _carry(jax_params)
    flat_g = export_torch_state_dict(grads)
    for n, p in hub.named_parameters():
        p.grad = torch.from_numpy(np.ascontiguousarray(flat_g[n]))
    opt = toptim.build_optimizer(hub, weight_decay=0.05, layer_decay=0.75,
                                 num_layers=4)
    state = TrainState(hub, opt, lambda s: 1e-3)
    state.apply_gradients()
    assert state.step == 1
    for n, p in hub.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=1e-9, err_msg=n)


def test_global_grad_norm_survives_huge_gradients():
    g = [torch.full((3,), 3e19), torch.full((4,), 4e19)]
    want = float(joptim.global_grad_norm([jnp.full((3,), 3e19),
                                          jnp.full((4,), 4e19)]))
    got = float(toptim.global_grad_norm(g))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    clipped = [t.clone() for t in g]
    toptim.clip_by_safe_global_norm(clipped, 1.0)
    np.testing.assert_allclose(float(toptim.global_grad_norm(clipped)), 1.0,
                               rtol=1e-5)


# ---------------------------------------------------------- trajectories


def _schedule():
    return (1e-3, 1e-5, 1, 3, 2)  # update 0 at lr 0, then warm, then cosine


def test_f32_trajectory_matches_jax(jax_params):
    """3 updates from the same init and the same replayed masks: loss and
    grad norm at each step and the final params agree at 1e-4 of scale
    (f32 on both sides; sums in other orders)."""
    jhub = _jax_hub()
    tx = joptim.build_optimizer(
        jax_params, learning_rate=joptim.cosine_warmup_schedule(*_schedule()),
        weight_decay=0.05, layer_decay=0.75, num_layers=4)
    # the jitted step donates its state: hand it a copy of the fixture
    jstate = JTrainState.create(apply_fn=jhub.apply,
                                params=jax.tree.map(jnp.copy, jax_params),
                                tx=tx)
    jstep = j_make_rec_step(jhub, patch_size=PATCH, num_patches=NUM_PATCHES)
    hub = _carry(jax_params)
    opt = toptim.build_optimizer(hub, weight_decay=0.05, layer_decay=0.75,
                                 num_layers=4)
    state = TrainState(hub, opt,
                       toptim.cosine_warmup_schedule(*_schedule()))
    step = make_rec_step(hub, patch_size=PATCH, num_patches=NUM_PATCHES)
    for i in range(3):
        b = _batch(10 + i)
        jstate, jm = jstep(jstate, _jb(b), jax.random.key(i))
        tm = step(state, _tb(b))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    want = export_torch_state_dict(jstate.params)
    lr_sum = sum(toptim.cosine_warmup_schedule(*_schedule())(i)
                 for i in range(3))
    for n, p in hub.named_parameters():
        got, w = p.detach().numpy().copy(), want[n].copy()
        if n.endswith("attn.qkv.bias"):
            # softmax is invariant to the key bias, so its gradient is zero
            # up to rounding and Adam scales that noise to a whole step:
            # hold the key slice to the steps' size, the rest at 1e-4
            c = got.shape[0] // 3
            assert np.abs(got[c:2 * c] - w[c:2 * c]).max() <= 2 * lr_sum, n
            got[c:2 * c] = w[c:2 * c] = 0.0
        assert _rel_err(got, w) <= 1e-4, n


# bf16 through 6 fused blocks, forward and backward: both sides round at
# the same points but sum in other orders, so a rounded intermediate may
# land one bf16 ulp (2^-8 relative) apart and the differences add up over
# the blocks. The loss is a mean over 3 * 12 * 64 squared errors (2e-3 of
# it); each parameter's gradient is held at 5e-2 of its scale (the worst,
# the patch-embed bias, sums the gradient of every kept patch).
BF16_LOSS_REL = 2e-3
BF16_GRAD_REL = 5e-2


def test_bf16_fused_step_matches_jax_kernels(jax_params):
    """JAX under force_fused() runs the Pallas kernels in interpret mode;
    the port runs bf16 with the fused plain forward and backward."""
    jhub = _jax_hub(jnp.bfloat16)
    b = _batch(20)
    jb = _jb(b)

    def loss_fn(params):
        pred, *_ = jhub.apply({"params": params}, jb["evg"], jb["ids_keep"],
                              jb["ids_restore"], deterministic=False,
                              method=jhub.forward_rec,
                              rngs={"dropout": jax.random.key(0)})
        return j_loss(pred, jb["frame"], jb["mask"], patch_size=PATCH)

    with force_fused():
        want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(jax_params)
    want_g = export_torch_state_dict(want_g)
    hub = _carry(jax_params, torch.bfloat16)
    tb = _tb(b)
    fused_ln_attn_layer.launches_bwd = fused_ln_mlp.launches_bwd = 0
    hub.train()
    pred, *_ = hub.forward_rec(tb["evg"], tb["ids_keep"], tb["ids_restore"])
    loss = reconstruct_loss(pred, tb["frame"], tb["mask"], patch_size=PATCH)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= BF16_LOSS_REL * abs(
        float(want_loss))
    for n, p in hub.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        err = _rel_err(p.grad.numpy(), want_g[n])
        assert err <= BF16_GRAD_REL, (n, err)
    # the CPU wrappers ran their plain versions: nothing launched
    assert fused_ln_attn_layer.launches_bwd == fused_ln_mlp.launches_bwd == 0


# ------------------------------------------------------------------ CLI


def test_cli_runs_four_steps_and_writes_a_loadable_checkpoint(tmp_path):
    from eventpretrain_tpu_torch.cli.pretrain import main
    from eventpretrain_tpu_torch.models.pretrain_hub import pretrain_hub_small

    out = tmp_path / "run"
    state = main(["--pr_phase", "rec", "--dataset", "synthetic",
                  "--device", "cpu", "--model_size", "small",
                  "--input_size", "32", "--batch_size", "8", "--epochs", "1",
                  "--num_workers", "0", "--print_freq", "2",
                  "--output_dir", str(out)])
    assert state.step == 4
    sd = load_torch_checkpoint(str(out / "checkpoint.pth"))
    hub = pretrain_hub_small(device="cpu", input_size=32)
    load_jax_state_dict(hub, sd)
    for k, v in state.module.state_dict().items():
        torch.testing.assert_close(hub.state_dict()[k], v.cpu(), rtol=0,
                                   atol=0)
    with pytest.raises(NotImplementedError):
        main(["--pr_phase", "ecdp", "--device", "cpu"])
