"""Contrastive objectives of the feature-transition and focus-aimed stages
(2 and 3).

Counterpart of eventpretrain_tpu/objectives/contrastive.py:28-48, 144-185
(``QueueState``, ``init_queue``, ``_l2norm``, ``token_infonce_queue`` and
``global_token_infonce`` without an axis name). Both losses cast q and k to
f32 and normalise them; the queue and the enqueued keys carry no gradient.

The queue at ViT-B's default length is a (768, 196, 65536) f32 buffer,
39.5 GB, and its logits at B=64 are 3.3 GB, so nothing here copies the
buffer: the negatives' product reads it through a strided view (one
batched GEMM a token), the loss is taken as ``logsumexp`` over the
positive and the negatives without concatenating them, and the enqueue
writes the keys into the buffer in place. The in-place enqueue would
change the buffer under autograd's feet, so the queue loss computes its
gradient with respect to q and k in its forward, against the buffer as it
was, and the backward only scales it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class QueueState(NamedTuple):
    buffer: torch.Tensor  # (C, L, K) f32 normalised keys
    ptr: int              # the next column to write


def init_queue(generator: torch.Generator, embed_dim: int, num_patches: int,
               queue_length: int, device="cuda") -> QueueState:
    """Normal draws from ``generator`` (on ``device``) normalised over the
    channels (contrastive.py:33-39)."""
    q = torch.randn((embed_dim, num_patches, queue_length),
                    generator=generator, device=device)
    q /= torch.linalg.vector_norm(q, dim=0, keepdim=True)
    return QueueState(buffer=q, ptr=0)


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=dim, keepdim=True), 1e-12)


class _QueueInfoNCE(torch.autograd.Function):
    """Mean over (B, L) of ``logsumexp([l_pos | l_neg]) - l_pos`` with
    ``l_pos = <q, k> / T`` and ``l_neg = q . buffer[:, l] / T``, for
    normalised f32 q, k (B, L, C). The gradients with respect to q and k
    are computed here, while the buffer holds what the loss read."""

    @staticmethod
    def forward(ctx, q, k, buffer, temperature):
        b, l, _ = q.shape
        q_l = q.transpose(0, 1)                               # (L, B, C)
        l_pos = (q * k).sum(-1).t() / temperature             # (L, B)
        l_neg = torch.bmm(q_l, buffer.permute(1, 0, 2))       # (L, B, K)
        l_neg /= temperature
        lse = torch.logaddexp(l_pos, torch.logsumexp(l_neg, dim=-1))
        loss = (lse - l_pos).mean()
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # d loss / d l_pos = (p_pos - 1) / n, / d l_neg = p_neg / n
            scale = 1.0 / (temperature * b * l)
            p_neg = l_neg.sub_(lse[..., None]).exp_()
            w_pos = (torch.exp(l_pos - lse) - 1.0)[..., None]  # (L, B, 1)
            dq = torch.bmm(p_neg, buffer.permute(1, 2, 0))     # (L, B, C)
            dq += w_pos * k.transpose(0, 1)
            ctx.save_for_backward((dq * scale).transpose(0, 1),
                                  (w_pos * q_l * scale).transpose(0, 1))
        return loss

    @staticmethod
    def backward(ctx, grad):
        dq, dk = ctx.saved_tensors
        return grad * dq, grad * dk, None, None


def token_infonce_queue(emb_h: torch.Tensor, clip_emb: torch.Tensor,
                        queue: QueueState, temperature: float = 0.07
                        ) -> tuple[torch.Tensor, QueueState]:
    """Per-token InfoNCE of q (``emb_h``, (B, L, C)) against its key k
    (``clip_emb``) and the queue's negatives (contrastive.py:48-82):
    ``(loss, new queue)``. The keys are enqueued as ``k^T`` (C, L, B) at
    ``ptr`` into the same buffer, in place (a start past ``K - B`` is
    clamped, as ``dynamic_update_slice`` does), and ``ptr`` advances by B
    mod K."""
    q = _l2norm(emb_h.float())
    k = _l2norm(clip_emb.float())
    loss = _QueueInfoNCE.apply(q, k, queue.buffer, float(temperature))
    batch, length = k.shape[0], queue.buffer.shape[-1]
    start = min(max(queue.ptr, 0), length - batch)
    with torch.no_grad():
        queue.buffer[:, :, start:start + batch] = k.permute(2, 1, 0)
    return loss, QueueState(buffer=queue.buffer,
                            ptr=(queue.ptr + batch) % length)


def global_token_infonce(emb_h: torch.Tensor, clip_emb: torch.Tensor,
                         temperature: float = 0.07) -> torch.Tensor:
    """Global InfoNCE (contrastive.py:144-185, ``axis_name=None``): each
    token's positive is the same token of its own sample, every other
    sample of the batch a negative."""
    q = _l2norm(emb_h.float())
    k = _l2norm(clip_emb.float())
    n, l, _ = q.shape
    logits = torch.einsum("nlc,mlc->nlm", q, k) / temperature
    labels = torch.arange(n, device=q.device)[:, None].expand(n, l)
    return F.cross_entropy(logits.reshape(n * l, n), labels.reshape(-1))

