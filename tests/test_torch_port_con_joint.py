"""The port's joint rec+con train step against the JAX package on the CPU:
one step at fixed masks of the tiny hub of ``tests/_con_port.py``, carried
across with ``export_torch_state_dict(params, batch_stats)``, against
JAX's pieces composed here under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.objectives import contrastive as jcon
from eventpretrain_tpu.objectives.rec import reconstruct_loss as j_rec_loss
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_queue,
    load_jax_state_dict,
)
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import make_rec_and_con_step

from tests._con_port import (
    NUM_PATCHES,
    PATCH,
    STEP_REL,
    jax_hub,
    jax_variables,
    numpy_batch,
    port_hub,
    queue_buffer,
    rel_err,
    torch_batch,
)
from tests._port_threads import one_torch_thread  # noqa: F401


class _CapturingState(TrainState):
    """A train state that keeps the gradients it applies."""

    def apply_gradients(self):
        self.grads = {n: p.grad.detach().clone()
                      for n, p in self.module.named_parameters()
                      if p.grad is not None}
        return super().apply_gradients()


@pytest.mark.parametrize("use_queue", [False, True],
                         ids=["global", "queue"])
def test_joint_step_loss_and_gradients_match_jax(use_queue):
    """The joint step at fixed masks against JAX's pieces composed here
    (``forward_rec`` and ``reconstruct_loss``, ``forward_con`` and the
    InfoNCE, summed, as steps.py:223-295): both losses and their sum at
    1e-5, every gradient at 1e-4 of its scale, the grad norm, the
    projectors' running statistics and the queue."""
    params, stats = jax_variables()
    jhub = jax_hub()
    b = numpy_batch(40)
    buf = queue_buffer(8)

    def loss_fn(p, s, jb, queue):
        pred, *_ = jhub.apply({"params": p}, jb["evg"], jb["ids_keep"],
                              jb["ids_restore"], deterministic=False,
                              mask=jb["mask"], method=jhub.forward_rec)
        rec = j_rec_loss(pred, jb["frame"], jb["mask"], patch_size=PATCH,
                         norm_pix_loss=True, mask_ratio=0.75)
        (q, k, *_), upd = jhub.apply(
            {"params": p, "batch_stats": s}, jb["evg"], jb["clip_emb"],
            train=True, method=jhub.forward_con, mutable=["batch_stats"])
        if queue is None:
            con, new_queue = jcon.global_token_infonce(q, k), None
        else:
            con, new_queue = jcon.token_infonce_queue(q, k, queue)
        return rec + con, (rec, con, upd["batch_stats"], new_queue)

    jq = (jcon.QueueState(jnp.asarray(buf), jnp.asarray(4, jnp.int32))
          if use_queue else None)
    (loss, (rec, con, new_stats, new_queue)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
            params, stats, {k: jnp.asarray(v) for k, v in b.items()}, jq)

    hub = load_jax_state_dict(port_hub(),
                              export_torch_state_dict(params, stats))
    state = _CapturingState(
        hub, toptim.build_optimizer(hub, weight_decay=0.05), lambda s: 0.0,
        queue=load_jax_queue(buf, 4) if use_queue else None)
    step = make_rec_and_con_step(hub, patch_size=PATCH,
                                 num_patches=NUM_PATCHES,
                                 use_queue=use_queue)
    m = step(state, torch_batch(b, b.keys()))
    for k, w in (("loss", loss), ("rec_loss", rec), ("con_loss", con)):
        np.testing.assert_allclose(float(m[k]), float(w), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(joptim.global_grad_norm(grads)),
                               rtol=1e-4)
    want_g = export_torch_state_dict(grads)
    assert set(state.grads) == set(want_g)
    for n, g in state.grads.items():
        if n.endswith("attn.qkv.bias"):
            continue  # the key slice is rounding noise on both sides
        assert rel_err(g.numpy(), want_g[n]) <= STEP_REL, n
    want_s = export_torch_state_dict({}, new_stats)
    for k, w in want_s.items():
        np.testing.assert_allclose(hub.state_dict()[k].numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if use_queue:
        assert state.queue.ptr == int(new_queue.ptr) == 0
        np.testing.assert_allclose(state.queue.buffer.numpy(),
                                   np.asarray(new_queue.buffer), atol=1e-6)
