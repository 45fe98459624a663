"""The port's contrastive train step against the JAX package's on the CPU:
3-step f32 trajectories of ``make_con_step`` (stage 2 with its frozen
trunk, stage 3 against the batch, stage 3 against the queue) from the
same tiny hub carried across with ``export_torch_state_dict(params,
batch_stats)`` and the same numpy batches (``tests/_con_port.py``). The
JAX steps run jitted. The joint step is in
``test_torch_port_con_joint.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.objectives import contrastive as jcon
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import make_con_step as j_make_con_step
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_queue,
    load_jax_state_dict,
)
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import make_con_step

from tests._con_port import (
    hold_params,
    jax_hub,
    jax_variables,
    numpy_batch,
    STEP_REL,
    port_hub,
    queue_buffer,
    rel_err,
    torch_batch,
)
from tests._port_threads import one_torch_thread  # noqa: F401

QUEUE_LEN = 8  # two batches of 4: the pointer wraps within 3 steps


def _schedule():
    return toptim.cosine_warmup_schedule(1e-3, 1e-5, 1, 3, 2)


@pytest.mark.parametrize("phase", ["adj", "con", "con_queue"])
def test_con_step_trajectory_matches_jax(phase):
    """3 updates from the same init and batches: the loss and grad norm of
    each step at 1e-4, then every parameter at 1e-4 of its scale (the
    zero-gradient ones within two steps' size), the projectors' running
    statistics and the queue. Stage 2 leaves every frozen parameter as
    it was, bit for bit, and trains the rest."""
    use_queue = phase == "con_queue"
    params, stats = jax_variables(with_decoder=False)
    jhub = jax_hub(with_decoder=False)
    mask = joptim.frozen_except_norm_mask(params) if phase == "adj" else None
    tx = joptim.build_optimizer(
        params, learning_rate=joptim.cosine_warmup_schedule(1e-3, 1e-5, 1, 3,
                                                            2),
        weight_decay=0.05, trainable_mask=mask)
    buf = queue_buffer(QUEUE_LEN)
    # the jitted step donates its state: hand it copies
    jstate = JTrainState.create(
        apply_fn=jhub.apply, params=jax.tree.map(jnp.copy, params),
        batch_stats=jax.tree.map(jnp.copy, stats), tx=tx,
        queue=(jcon.QueueState(jnp.asarray(buf), jnp.asarray(0, jnp.int32))
               if use_queue else None))
    jstep = j_make_con_step(jhub, use_queue=use_queue, trainable_mask=mask)

    hub = load_jax_state_dict(port_hub(with_decoder=False),
                              export_torch_state_dict(params, stats))
    frozen_init = {}
    if phase == "adj":
        trainable = toptim.freeze_except_norm(hub)
        frozen_init = {n: p.detach().numpy().copy()
                       for n, p in hub.named_parameters()
                       if not trainable[n]}
        assert frozen_init and "backbone.norm_layer.weight" not in frozen_init
        norm_init = hub.backbone.norm_layer.weight.detach().clone()
    state = TrainState(hub, toptim.build_optimizer(hub, weight_decay=0.05),
                       _schedule(),
                       queue=load_jax_queue(buf, 0) if use_queue else None)
    step = make_con_step(hub, use_queue=use_queue)
    for i in range(3):
        b = numpy_batch(30 + i)
        jb = {k: jnp.asarray(b[k]) for k in ("evg", "clip_emb")}
        jstate, jm = jstep(jstate, jb, jax.random.key(i))
        tm = step(state, torch_batch(b, ("evg", "clip_emb")))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_REL, err_msg=f"{i} {k}")
    lr_sum = sum(_schedule()(i) for i in range(3))
    want = export_torch_state_dict(jstate.params, jstate.batch_stats)
    hold_params(hub, want, lr_sum, frozen_init)
    for k, v in hub.named_buffers():
        if k not in want:
            continue
        got, w = v.numpy(), want[k]
        if k == "emb_h_proj.1.running_mean":
            # the first BatchNorm's batch means move with the final
            # LayerNorm's zero-gradient bias (a shift of at most two steps'
            # size through fc0), a hundredth of them a step
            fc0 = np.abs(want["emb_h_proj.0.weight"]).sum(1).max()
            assert np.abs(got - w).max() <= 0.03 * fc0 * 2 * lr_sum, k
        else:
            assert rel_err(got, w) <= STEP_REL, k
    if use_queue:
        assert state.queue.ptr == int(jstate.queue.ptr) == 12 % QUEUE_LEN
        np.testing.assert_allclose(state.queue.buffer.numpy(),
                                   np.asarray(jstate.queue.buffer),
                                   atol=1e-6)
    if phase == "adj":
        assert not torch.equal(hub.backbone.norm_layer.weight, norm_init)
