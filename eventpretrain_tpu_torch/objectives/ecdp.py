"""The ECDP baseline's objectives: the EMA update and its cosine momentum,
the elementwise vector projection, the per-sample InfoNCE (against a
queue or the batch) and the sinkhorn-KL.

Counterpart of eventpretrain_tpu/objectives/ecdp.py. ``ema_update`` moves
the key encoder's parameters in place (JAX returns a new tree). The
queue is a (C, K) f32 buffer of keys with a host-int pointer; the enqueue
writes a new buffer, as ``dynamic_update_slice`` does, since the loss's
backward reads the old one: at C=256 and K=65536 that is a 64 MB copy a
step. ``sinkhorn`` detaches exactly what JAX's ``stop_gradient`` does
(the total and the row sums, not the column sums), so the KL's gradient
reaches ``clip_emb_proj`` through its target.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def ema_update(query: nn.Module, key: nn.Module, momentum: float) -> None:
    """``param_k = m * param_k + (1 - m) * param_q`` over ``key``'s
    parameters, each paired with ``query``'s of the same name
    (ecdp.py:27-31)."""
    q = dict(query.named_parameters())
    ks = [p for _, p in key.named_parameters()]
    qs = [q[n] for n, _ in key.named_parameters()]
    torch._foreach_mul_(ks, momentum)
    torch._foreach_add_(ks, torch._foreach_mul(qs, 1.0 - momentum))


def cosine_ema_momentum(base_m: float, epoch_frac: float,
                        total_epochs: float) -> float:
    """The cosine-increasing momentum (ecdp.py:34-42), on the host."""
    return 1.0 - (1.0 - base_m) * (
        math.cos(math.pi * epoch_frac / total_epochs) + 1.0) / 2.0


def vector_project(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """``(v1 * v2) * (v2 / sum(v2 ** 2))`` with the sum over the batch
    axis, elementwise: the reference's form (ecdp.py:45-51)."""
    denom = (v2 ** 2).sum(dim=0)
    return (v1 * v2) * (v2 / torch.clamp_min(denom, 1e-12))


class SampleQueueState(NamedTuple):
    buffer: torch.Tensor  # (C, K) keys
    ptr: int              # the next column to write


def init_sample_queue(generator: torch.Generator, proj_dim: int,
                      queue_length: int, device="cuda") -> SampleQueueState:
    """Normal draws from ``generator`` (on ``device``), each column
    normalised (ecdp.py:59-62)."""
    q = torch.randn((proj_dim, queue_length), generator=generator,
                    device=device)
    q /= torch.linalg.vector_norm(q, dim=0, keepdim=True)
    return SampleQueueState(buffer=q, ptr=0)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def sample_infonce_queue(q: torch.Tensor, k: torch.Tensor,
                         queue: SampleQueueState, temperature: float,
                         l2_norm: bool = True
                         ) -> tuple[torch.Tensor, SampleQueueState]:
    """Per-sample InfoNCE of q (B, C) against its key k and the queue's
    negatives (ecdp.py:69-89): ``(loss, new queue)``. The keys go in as
    ``k^T`` at ``ptr``, the start clamped to ``K - B`` as
    ``dynamic_update_slice`` clamps it, into a new buffer; ``ptr``
    advances by B mod K."""
    q, k = q.float(), k.float()
    if l2_norm:
        q, k = _l2(q), _l2(k)
    buf = queue.buffer
    l_pos = (q * k).sum(-1, keepdim=True)
    logits = torch.cat([l_pos, q @ buf.detach()], dim=-1) / temperature
    labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    loss = F.cross_entropy(logits, labels)
    batch, length = k.shape[0], buf.shape[-1]
    start = min(max(queue.ptr, 0), length - batch)
    new_buf = buf.detach().clone()
    new_buf[:, start:start + batch] = k.detach().t()
    return loss, SampleQueueState(buffer=new_buf,
                                  ptr=(queue.ptr + batch) % length)


def global_sample_infonce(q: torch.Tensor, k: torch.Tensor,
                          temperature: float,
                          l2_norm: bool = True) -> torch.Tensor:
    """InfoNCE of each sample against the batch's keys, times ``2T``
    (ecdp.py:92-104)."""
    q, k = q.float(), k.float()
    if l2_norm:
        q, k = _l2(q), _l2(k)
    logits = q @ k.t() / temperature
    labels = torch.arange(q.shape[0], device=q.device)
    return F.cross_entropy(logits, labels) * (2 * temperature)


def sinkhorn(out: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Sinkhorn normalisation of ``exp(out)`` (ecdp.py:107-119): the total
    and each pass's row sums detached, the column sums not."""
    q = torch.exp(out.float()).t()  # (K, B)
    k, b = q.shape
    q = q / q.sum().detach()
    for _ in range(iters):
        q = q / q.sum(dim=1, keepdim=True).detach()
        q = q / k
        q = q / q.sum(dim=0, keepdim=True)
        q = q / b
    return (q * b).t()


def ecdp_kl_loss(q: torch.Tensor, k: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    """``KL(log_softmax(q.q^T / T) || sinkhorn(k.k^T / T))``, batchmean
    (ecdp.py:122-135): ``sum(t * (log t - log p)) / B``, a zero target
    adding nothing."""
    q, k = _l2(q.float()), _l2(k.float())
    log_p = F.log_softmax(q @ q.t() / temperature, dim=-1)
    target = sinkhorn(k @ k.t() / temperature)
    safe_log_t = torch.where(target > 0,
                             torch.log(torch.clamp_min(target, 1e-30)), 0.0)
    return (target * (safe_log_t - log_p)).sum() / q.shape[0]
