"""The port's gradient accumulation (``--accum_iter``) against the JAX
package on the CPU.

JAX accumulates with ``optax.MultiSteps(tx, every_k_schedule=k)`` around
its whole optimizer chain (train/optim.py:199-200). The port's
``build_optimizer(..., accum_steps=k)`` and ``TrainState.apply_gradients``
are held against the chain that JAX's ``build_optimizer(accum_steps=k)``
builds, on a small tree with a leaf group of each kind the ConvViT
optimizer treats apart, fed the same numpy gradients microstep by
microstep: the clip on the
averaged gradient, Adam, weight decay, layer decay over 13 ids, and the
stage-2 frozen mask. Then the microsteps of a train step (BatchNorm
statistics move, parameters do not) and ``--accum_iter`` through the
pretrain and cls CLIs (the effective batch's lr, a schedule that counts
updates, the queue moving every microstep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu_torch.ckpt.bridge import load_jax_state_dict
from eventpretrain_tpu_torch.cli import finetune_cls as cls_cli
from eventpretrain_tpu_torch.cli import pretrain as pretrain_cli
from eventpretrain_tpu_torch.models import cls_hub as tcls_hub
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import make_semseg_train_step

from tests._convvit_port import (
    CFG,
    port_dense_hub,
    rel_err,
    tiny_cli_hub,
)
from tests._port_threads import one_torch_thread  # noqa: F401

SCHEDULE = (1e-3, 1e-5, 0, 4, 2)  # no warmup: update 0 and 1 differ
CLIP = 0.5  # binds: the mean gradient's norm is ~2


def _tree_pair(seed=3):
    """A flax-style parameter tree with one leaf group of each kind the
    ConvViT optimizer treats apart (a patch embed, the two conv stages,
    two ViT blocks, ``norm_layer``, a decoder outside the backbone) and a
    port module holding the same values under the exporter's names. A few
    leaves keep JAX's compile of the MultiSteps chain short."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": jnp.asarray(rng.normal(size=(i, o)), jnp.float32),
                "bias": jnp.asarray(rng.normal(size=(o,)), jnp.float32)}

    params = {
        "backbone": {
            "patch_embed1": dense(5, 8), "conv_block1_0": dense(8, 8),
            "conv_block2_0": dense(8, 8), "vit_block_0": dense(8, 8),
            "vit_block_1": dense(8, 8),
            "norm_layer": {"scale": jnp.ones((8,)),
                           "bias": jnp.zeros((8,))},
        },
        "pretrain_rec_decoder": dense(8, 4),
    }
    backbone = torch.nn.Module()
    backbone.patch_embed1 = torch.nn.Linear(5, 8)
    for name, n in (("conv_block1", 1), ("conv_block2", 1), ("vit_block", 2)):
        setattr(backbone, name, torch.nn.ModuleList(
            torch.nn.Linear(8, 8) for _ in range(n)))
    backbone.norm_layer = torch.nn.LayerNorm(8)
    hub = torch.nn.Module()
    hub.backbone = backbone
    hub.pretrain_rec_decoder = torch.nn.Linear(8, 4)
    return params, load_jax_state_dict(hub, export_torch_state_dict(params))


def _moments(opt_state, name):
    return export_torch_state_dict(optax.tree_utils.tree_get(opt_state,
                                                             name))


@pytest.mark.parametrize("frozen", [False, True], ids=["all", "adj_mask"])
@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_updates_match_optax_multisteps(k, frozen):
    """2k microsteps of the same numpy gradients through JAX's
    ``build_optimizer(accum_steps=k)`` (clip 0.5, weight decay 0.05, layer
    decay 0.75 over 13 ConvViT layer ids, with or without stage 2's frozen
    mask) and the port's: after every microstep but each k-th the
    parameters are unchanged, bit for bit, and the port's optimizer holds
    no moments yet; after each update the parameters agree within 1e-6
    and Adam's moments within 1e-6 of their scale; the step counts
    updates, and each call returns the norm of its own microstep's
    gradients."""
    params, hub = _tree_pair()
    sched = joptim.cosine_warmup_schedule(*SCHEDULE)
    mask = joptim.frozen_except_norm_mask(params) if frozen else None
    tx = joptim.build_optimizer(
        params, learning_rate=sched, weight_decay=0.05, betas=(0.9, 0.95),
        layer_decay=0.75, num_layers=13, backbone_type="convvit",
        clip_grad=CLIP, trainable_mask=mask, accum_steps=k)
    jstate = tx.init(params)
    update = jax.jit(tx.update)
    if frozen:
        toptim.freeze_except_norm(hub)
    state = TrainState(hub, toptim.build_optimizer(
        hub, weight_decay=0.05, betas=(0.9, 0.95), layer_decay=0.75,
        num_layers=13, backbone_type="convvit", accum_steps=k),
        toptim.cosine_warmup_schedule(*SCHEDULE), clip_grad=CLIP)
    assert state.accum_steps == k
    trainable = {n: p for n, p in hub.named_parameters() if p.requires_grad}
    assert len(trainable) == (4 if frozen else 14)
    rng = np.random.default_rng(k)
    for i in range(2 * k):
        # a frozen parameter has no gradient in the port and a zero one in
        # JAX's stage-2 step (its backward covers the trainable subtree)
        grads = jax.tree.map(
            lambda p, t: jnp.asarray(rng.normal(size=p.shape) * 0.5 * t,
                                     jnp.float32),
            params, mask if frozen else jax.tree.map(lambda _: 1.0, params))
        updates, jstate = update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        flat = export_torch_state_dict(grads)
        before = {n: p.detach().clone() for n, p in trainable.items()}
        for n, p in trainable.items():
            p.grad = torch.from_numpy(np.array(flat[n]))
        want_norm = toptim.global_grad_norm(
            [p.grad for p in trainable.values()])
        norm = state.apply_gradients()
        assert float(norm) == float(want_norm)
        assert all(p.grad is None for p in trainable.values())
        if (i + 1) % k:
            assert state.step == i // k and state.micro_step == (i + 1) % k
            for n, p in trainable.items():
                assert torch.equal(p, before[n]), n
            if i < k:
                assert not state.optimizer.state
            continue
        assert state.step == (i + 1) // k and state.micro_step == 0
        want = export_torch_state_dict(params)
        mu, nu = _moments(jstate, "mu"), _moments(jstate, "nu")
        for n, p in hub.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       rtol=1e-6, atol=1e-9, err_msg=n)
            if n not in trainable:
                continue
            # the clip's norm sums in another order: each moment within
            # 1e-6 of its tensor's scale
            st = state.optimizer.state[p]
            assert rel_err(st["exp_avg"].numpy(), mu[n]) <= 1e-6, n
            assert rel_err(st["exp_avg_sq"].numpy(), nu[n]) <= 1e-6, n


def test_microsteps_move_batchnorm_statistics_not_parameters():
    """A dense train step under ``accum_steps`` 2: the first microstep
    moves every BatchNorm's running statistics (the FPN's among them) and
    no parameter; the second updates the parameters."""
    hub = port_dense_hub(4)
    state = TrainState(hub, toptim.build_optimizer(hub, accum_steps=2),
                       lambda s: 1e-3)
    step = make_semseg_train_step(hub, num_classes=4,
                                  generator=torch.Generator())
    rng = np.random.default_rng(0)
    side = CFG["input_size"]

    def batch():
        return {"evg": torch.from_numpy(rng.normal(
                    size=(4, side, side, 5)).astype(np.float32)),
                "label": torch.from_numpy(rng.integers(0, 4, (4, 8, 8)))}

    params = {n: p.detach().clone() for n, p in hub.named_parameters()}
    stats = {n: b.clone() for n, b in hub.named_buffers() if "running_" in n}
    step(state, batch())
    assert state.step == 0
    for n, p in hub.named_parameters():
        assert torch.equal(p, params[n]), n
    for n, b in hub.named_buffers():
        if "running_" in n:
            assert not torch.equal(b, stats[n]), n
    assert "backbone.fpn.1.running_mean" in stats
    step(state, batch())
    assert state.step == 1
    assert not torch.equal(hub.backbone.patch_embed1.proj.weight,
                           params["backbone.patch_embed1.proj.weight"])


COMMON = ["--device", "cpu", "--no-bf16", "--backbone", "convvit",
          "--batch_size", "8", "--epochs", "1", "--num_workers", "0",
          "--print_freq", "2", "--accum_iter", "2"]


def test_pretrain_cli_accumulates(monkeypatch, tmp_path):
    """``--accum_iter 2``: 4 batches of 8 are 2 updates; the lr is the
    effective batch's (1e-3 * 16 / 256) on a schedule of 2 updates an
    epoch; the queue takes every microstep's keys, and its length must be
    a multiple of the effective batch."""
    monkeypatch.setattr(pretrain_cli, "pretrain_hub_convvit_small",
                        tiny_cli_hub)
    state = pretrain_cli.main(COMMON + ["--pr_phase", "rec", "--input_size",
                                        "64", "--warmup_epochs", "0",
                                        "--output_dir", str(tmp_path / "r")])
    assert state.step == 2 and state.micro_step == 0
    want = toptim.cosine_warmup_schedule(1e-3 * 16 / 256, 0.0, 0, 1, 2)
    assert [state.schedule(i) for i in range(2)] == [want(0), want(1)]
    state = pretrain_cli.main(COMMON + [
        "--pr_phase", "con", "--input_size", "224", "--use_queue",
        "--queue_length", "48", "--output_dir", str(tmp_path / "c")])
    assert state.step == 2
    assert state.queue.ptr == 32  # 4 microsteps of 8 keys
    with pytest.raises(ValueError, match="accum_iter"):
        pretrain_cli.main(COMMON + [
            "--pr_phase", "con", "--input_size", "224", "--use_queue",
            "--queue_length", "40", "--output_dir", str(tmp_path / "x")])


def test_cls_cli_accumulates(monkeypatch, tmp_path):
    """``--accum_iter 2`` on the ConvViT cls hub: 128 synthetic samples in
    batches of 32 are 4 microsteps and 2 updates."""
    def tiny(num_classes, num_bins=5, **kw):
        kw.update(CFG, input_size=kw["input_size"])
        return tcls_hub.cls_hub_convvit_small(num_classes, num_bins, **kw)

    monkeypatch.setattr(cls_cli, "cls_hub_convvit_small", tiny)
    res = cls_cli.main(["--device", "cpu", "--no-bf16", "--backbone",
                        "convvit", "--input_size", "64", "--batch_size", "32",
                        "--accum_iter", "2", "--epochs", "1",
                        "--num_workers", "0", "--fix_events_num", "1000",
                        "--val_fix_events_num", "1000",
                        "--output_dir", str(tmp_path)])
    state = res["state"]
    assert state.step == 2 and state.micro_step == 0
    assert state.optimizer.defaults["accum_steps"] == 2
