"""Sparse Swin backbone (GreenMIM-style) on the visible tokens only.

Counterpart of eventpretrain_tpu/models/swin.py. The integer planning
(window grouping, knapsack packing, merge gathers) runs on the host
(``models/swin_plan.py``, a copy of the JAX package's); the model gathers
by the plans, attends within each group of windows and scatters back. One
mask is shared by the batch (the reference's swin.py:158), so the plans
are one set a step:

- a training step's plans and its masking cross to the card as one int32
  buffer (:func:`pack_plans_np`, JAX's layout word for word), and
  :func:`unpack_plans` cuts them out of the uploaded tensor as views;
- :func:`expand_plan` derives each stage parity's additive attention mask
  and relative-position indices once a forward (``SparseSwin._run_stages``;
  under ``jit`` XLA shares it between the blocks of a parity, which eager
  PyTorch does not), not once a block;
- ``encode_dense`` takes the no-mask plans, built once for each (device,
  geometry) and cached (:func:`dense_plans`), where JAX rebuilds them as
  ``jit`` constants on every trace.

The windowed attention is plain PyTorch, as JAX's is plain ``jnp``
(swin.py:178-227): batched matmuls and a softmax in f32 cast back to the
compute dtype. The MLP is ``layers.Mlp``, which takes K5 in deterministic
calls inside its gate (stage 3 of Swin-T: C=384, 196 tokens at 224 px).
Activations stay ``(B, N, C)`` tokens; each conv (the patch embed, the
stage decoders, the FPN conv) sees a channels-last view.

Parameter names are the exporter's (ckpt/torch_import.py:120-129):
``patch_embed.proj``, ``patch_embed.norm``, ``swin_block.S.blocks.B.*``
(with ``attn.relative_position_bias_table``), ``swin_block.S.downsample.*``,
``norm_layer``, ``stage{1,2,3}_output_decode`` and ``fpn.{0,1}``. The
reference's ``relative_position_index`` and ``attn_mask`` buffers are not
kept: the plans recompute them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.models.convvit import conv_nhwc
from eventpretrain_tpu_torch.models.dense_heads import BatchNorm
from eventpretrain_tpu_torch.models.layers import (
    Conv2d,
    DropPath,
    Linear,
    Mlp,
    layer_norm,
)
from eventpretrain_tpu_torch.models.swin_plan import (
    StagePlan,
    build_swin_plans,
)


class DeviceGroupPlan(NamedTuple):
    idx_shuffle: torch.Tensor    # (nG*GS,) int64
    idx_unshuffle: torch.Tensor  # (N_vis,)
    gid: torch.Tensor            # (nG, GS), -1 = pad
    coords_g: torch.Tensor       # (nG, GS, 2)


class DeviceStagePlan(NamedTuple):
    plan_even: DeviceGroupPlan
    plan_odd: DeviceGroupPlan
    coords_flat: torch.Tensor                # (N_vis,)
    merge_child_idx: Optional[torch.Tensor]  # (N//4, 4) | None


def plans_to_device(plans: Sequence[StagePlan],
                    device) -> tuple[DeviceStagePlan, ...]:
    """Host plans as int64 tensors on ``device`` (swin.py:42-63); a stage
    whose shifted plan is its unshifted one keeps one set of tensors."""

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    def g(p):
        return DeviceGroupPlan(t(p.idx_shuffle), t(p.idx_unshuffle),
                               t(p.gid), t(p.coords_g))

    out = []
    for sp in plans:
        even = g(sp.plan_even)
        odd = even if sp.plan_odd is sp.plan_even else g(sp.plan_odd)
        out.append(DeviceStagePlan(
            even, odd, t(sp.coords_flat),
            None if sp.merge_child_idx is None else t(sp.merge_child_idx)))
    return tuple(out)


def pack_plans_np(plans, ids_keep, mask, ids_restore):
    """A host plan set and the step's masking as ONE int32 buffer and its
    layout (swin.py:66-99, word for word): per stage both parities'
    ``idx_shuffle``, ``idx_unshuffle``, ``gid``, ``coords_g``, then
    ``coords_flat`` and ``merge_child_idx`` (None in the layout for the
    last stage), then ``ids_keep``, ``mask`` and ``ids_restore``. The
    layout is hashable; only the group-count buckets vary it."""
    arrs: list[np.ndarray] = []
    shapes: list = []

    def push(a):
        a = np.asarray(a, np.int32)
        shapes.append(tuple(a.shape))
        arrs.append(a.ravel())

    for sp in plans:
        for p in (sp.plan_even, sp.plan_odd):
            push(p.idx_shuffle)
            push(p.idx_unshuffle)
            push(p.gid)
            push(p.coords_g)
        push(sp.coords_flat)
        if sp.merge_child_idx is not None:
            push(sp.merge_child_idx)
        else:
            shapes.append(None)
    push(ids_keep)
    push(mask.astype(np.int32))
    push(ids_restore)
    return np.concatenate(arrs), (len(plans), tuple(shapes))


def unpack_plans(flat: torch.Tensor, layout, batch_size: int):
    """The inverse of :func:`pack_plans_np` on the uploaded buffer (JAX's
    ``unpack_plans_traced``, swin.py:102-138): ``(plans, ids_keep (B, K),
    mask (B, L) f32, ids_restore (B, L))``. Every index tensor is a view
    of ``flat`` widened to int64 once (the gathers take int64 indices);
    the batch rows are views of one row."""
    num_stages, shapes = layout
    flat = flat.long()
    views, off = [], 0
    for shp in shapes:
        if shp is None:
            views.append(None)
            continue
        n = int(np.prod(shp)) if shp else 1
        views.append(flat[off:off + n].view(shp))
        off += n
    out, i = [], 0
    for _ in range(num_stages):
        groups = []
        for _ in range(2):
            groups.append(DeviceGroupPlan(*views[i:i + 4]))
            i += 4
        out.append(DeviceStagePlan(groups[0], groups[1], views[i],
                                   views[i + 1]))
        i += 2

    def rows(a):
        return a[None].expand(batch_size, -1)

    ids_keep, mask, ids_restore = views[i:i + 3]
    return (tuple(out), rows(ids_keep), rows(mask).float(),
            rows(ids_restore))


def expand_plan(plan: DeviceGroupPlan, window_size: int):
    """``(attn_mask (nG, GS, GS) f32, rel_pos_idx (nG, GS, GS) int64)`` of
    a compact plan (swin.py:157-175): -100 between slots of different
    windows and between two pads, the relative-position table index
    elsewhere (0 where masked)."""
    gid = plan.gid
    pad = gid == -1
    masked = (gid[:, :, None] != gid[:, None, :]) | (
        pad[:, :, None] & pad[:, None, :])
    attn_mask = torch.where(masked, -100.0, 0.0).float()
    rel = plan.coords_g[:, :, None, :] - plan.coords_g[:, None, :, :]
    rel = rel + (window_size - 1)
    idx = rel[..., 0] * (2 * window_size - 1) + rel[..., 1]
    return attn_mask, torch.where(masked, 0, idx)


class WindowAttention(nn.Module):
    """W-MSA over grouped tokens ``(B, nG, GS, C)`` with the masked
    relative-position bias (swin.py:178-227): the bias table gathered by
    ``rel_pos_idx``, zeroed where the mask forbids, then the additive
    mask; the softmax in f32, cast to the compute dtype."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            ((2 * window_size - 1) ** 2, num_heads), device=device))
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, **kw)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                rel_pos_idx: torch.Tensor) -> torch.Tensor:
        b, ng, gs, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, ng, gs, 3, h, c // h)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)  # (B, nG, h, GS, d) each
        attn = torch.matmul(q * self.scale, k.transpose(-1, -2))
        # index_select, whose backward adds each slot's gradient into its
        # table row: the backward of ``table[rel_pos_idx]`` sorts the
        # indices, 33 ms of a 54 ms rec step on an H100
        table = self.relative_position_bias_table
        bias = table.index_select(0, rel_pos_idx.reshape(-1)).view(
            *rel_pos_idx.shape, h)
        bias = bias * (attn_mask == 0).to(table.dtype)[..., None]
        attn = attn + bias.permute(0, 3, 1, 2)[None].to(attn.dtype)
        attn = attn + attn_mask[None, :, None].to(attn.dtype)
        attn = attn.float().softmax(-1).to(self.compute_dtype)
        out = torch.matmul(self.attn_drop(attn), v)
        out = out.transpose(2, 3).reshape(b, ng, gs, c)
        return self.proj_drop(self.proj(out))


class SparseSwinBlock(nn.Module):
    """One Swin block on the visible tokens (swin.py:230-270): LN, the
    gather into group slots, windowed attention, the gather back (padded
    slots dropped), residual with drop-path; LN, ``Mlp``, residual with
    drop-path. ``use_fused_layer=False`` keeps the MLP off K5, as
    ``ViTBlock``'s flag keeps its sub-blocks off K1/K2."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0, layer_norm_eps: float = 1e-6,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.window_size = window_size
        self.use_fused_layer: Optional[bool] = None
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias,
                                    attn_drop, drop, **kw)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=drop, **kw)

    def forward(self, x: torch.Tensor, plan: DeviceGroupPlan,
                expanded) -> torch.Tensor:
        """``x (B, N, C)``; ``expanded`` is :func:`expand_plan` of
        ``plan``."""
        b, _, c = x.shape
        gs = plan.gid.shape[-1]
        y = layer_norm(x, self.norm1).index_select(1, plan.idx_shuffle)
        y = self.attn(y.view(b, -1, gs, c), *expanded)
        y = y.reshape(b, -1, c).index_select(1, plan.idx_unshuffle)
        x = x + self.drop_path(y)
        y = self.mlp(layer_norm(x, self.norm2),
                     fused=self.use_fused_layer is not False)
        return x + self.drop_path(y)


class PatchMerging(nn.Module):
    """Merge 2x2 visible children (swin.py:273-287): the 4 children in
    [tl, bl, tr, br] order concatenated, LN, a bias-free reduction."""

    def __init__(self, dim: int, layer_norm_eps: float = 1e-6, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=layer_norm_eps, device=device)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype,
                                device=device)

    def forward(self, x: torch.Tensor,
                child_idx: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        y = x.index_select(1, child_idx.reshape(-1)).reshape(b, -1, 4 * c)
        return self.reduction(layer_norm(y, self.norm))


class SwinStage(nn.Module):
    """``blocks`` of one stage and, but on the last, its ``downsample``
    (the exporter's ``swin_block.S.{blocks.B,downsample}``)."""

    def __init__(self, blocks, downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class PatchEmbedNorm(nn.Module):
    """The strided patch conv and its LayerNorm (``layer_norm_eps``), no
    activation (swin.py:344-349): ``(B, H, W, C)`` -> ``(B, N, embed_dim)``
    tokens in row-major order."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 eps: float, *, dtype=torch.float32, device=None):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size,
                           dtype=dtype, device=device)
        self.norm = nn.LayerNorm(embed_dim, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_nhwc(self.proj, x)
        return layer_norm(x.reshape(x.shape[0], -1, x.shape[-1]), self.norm)


_DENSE_PLANS: dict = {}


def dense_plans(device, resolution: tuple[int, int], num_stages: int,
                window_size: int, cell_grid: int, clamp_shift: bool = True):
    """The no-mask plans on ``device``, built once for each (device,
    geometry, ``clamp_shift``) (swin.py:487-496). ``clamp_shift=False`` is
    the ECDDP Swin's: a stage whose window covers the map still shifts its
    odd blocks (swin_ecddp.py:86-96)."""
    key = (str(torch.device(device)), tuple(resolution), num_stages,
           window_size, cell_grid, clamp_shift)
    if key not in _DENSE_PLANS:
        _DENSE_PLANS[key] = plans_to_device(build_swin_plans(
            None, input_resolution=tuple(resolution), num_stages=num_stages,
            window_size=window_size, cell_grid=cell_grid,
            clamp_shift=clamp_shift), device)
    return _DENSE_PLANS[key]


def run_stages(stages, x: torch.Tensor, plans) -> list[torch.Tensor]:
    """``x`` through ``stages`` (``SwinStage``s) under ``plans``: each
    stage's tokens before its merge; each parity's plan is expanded once
    for the stage's blocks (swin.py:415-426)."""
    outs = []
    for sp, stage in zip(plans, stages):
        ws = stage.blocks[0].window_size
        even = expand_plan(sp.plan_even, ws)
        odd = (even if sp.plan_odd is sp.plan_even
               else expand_plan(sp.plan_odd, ws))
        for j, blk in enumerate(stage.blocks):
            x = (blk(x, sp.plan_even, even) if j % 2 == 0
                 else blk(x, sp.plan_odd, odd))
        outs.append(x)
        if stage.downsample is not None:
            x = stage.downsample(x, sp.merge_child_idx)
    return outs


def swin_stages(embed_dims: Sequence[int], depths: Sequence[int],
                num_heads: Sequence[int], window_size: int, resolution: int,
                mlp_ratio: float, drop_rate: float, attn_drop_rate: float,
                drop_path_rate: float, layer_norm_eps: float, **kw
                ) -> nn.ModuleList:
    """The stages of a Swin: ``depths[i]`` blocks at width
    ``embed_dims[i]``, window ``min(window_size, resolution >> i)``, the
    drop-path rates ``linspace(0, drop_path_rate, sum(depths))`` in block
    order, a ``PatchMerging`` after each stage but the last
    (swin.py:340-372)."""
    dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
    stages = []
    for i, depth in enumerate(depths):
        ws = min(window_size, resolution >> i)
        first = sum(depths[:i])
        blocks = [SparseSwinBlock(
            embed_dims[i], num_heads[i], ws, mlp_ratio, drop=drop_rate,
            attn_drop=attn_drop_rate, drop_path_rate=dpr[first + j],
            layer_norm_eps=layer_norm_eps, **kw) for j in range(depth)]
        merge = (PatchMerging(embed_dims[i], layer_norm_eps, **kw)
                 if i < len(depths) - 1 else None)
        stages.append(SwinStage(blocks, merge))
    return nn.ModuleList(stages)


class SparseSwin(nn.Module):
    """Swin-T over the visible tokens (swin.py:290-523)."""

    def __init__(self, input_size: int = 224, patch_size: int = 4,
                 embed_dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 num_bins: int = 5, decoder_num_patches: int = 49,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, use_feature_fusion: bool = True,
                 with_rec_decoders: bool = True, with_fpn: bool = False,
                 with_final_norm: bool = True, layer_norm_eps: float = 1e-6,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.patch_size = patch_size
        self.embed_dims = tuple(embed_dims)
        self.embed_dim = embed_dims[-1]
        self.window_size = window_size
        self.num_patches = decoder_num_patches
        self.cell_grid = int(decoder_num_patches ** 0.5)
        self.patches_resolution = (input_size // patch_size,) * 2
        self.use_feature_fusion = use_feature_fusion
        self.with_final_norm = with_final_norm
        self.patch_embed = PatchEmbedNorm(patch_size, num_bins, embed_dims[0],
                                          layer_norm_eps, **kw)
        self.pos_drop = nn.Dropout(drop_rate)
        res = min(self.patches_resolution)
        self.swin_block = swin_stages(
            embed_dims, depths, num_heads, window_size, res, mlp_ratio,
            drop_rate, attn_drop_rate, drop_path_rate, layer_norm_eps, **kw)
        if with_final_norm:
            self.norm_layer = nn.LayerNorm(embed_dims[-1], eps=layer_norm_eps,
                                           device=device)
        if with_rec_decoders:
            # each stage's map down to the mask-cell grid (swin.py:379-394)
            for i in range(3):
                k = max((res >> i) // self.cell_grid, 1)
                setattr(self, f"stage{i + 1}_output_decode",
                        Conv2d(embed_dims[i], embed_dims[-1], k, k, **kw))
        if with_fpn:
            self.fpn = nn.ModuleList([
                Conv2d(embed_dims[-1], embed_dims[-1], 3, 2, **kw),
                BatchNorm(embed_dims[-1], device=device)])

    def _embed_visible(self, x: torch.Tensor,
                       coords_flat: torch.Tensor) -> torch.Tensor:
        return self.pos_drop(self.patch_embed(x)).index_select(1,
                                                               coords_flat)

    def _run_stages(self, x: torch.Tensor, plans) -> list[torch.Tensor]:
        return run_stages(self.swin_block, x, plans)

    def encode_masked(self, x: torch.Tensor, ids_keep: torch.Tensor, plans):
        """Masked encoding of ``x (B, H, W, num_bins)`` (swin.py:435-476)
        under the step's device plans: ``(outs, emb_lh)``, each stage's
        visible tokens and the fused feature (B, K, d3) for the decoder.
        As in the reference, stages 1-3 reach the fused feature in
        ``ids_keep`` order, through their canvases and stage decoders,
        while stage 4's tokens stay in row-major visible-cell order."""
        outs = self._run_stages(
            self._embed_visible(x, plans[0].coords_flat), plans)
        idx = ids_keep[..., None].expand(-1, -1, self.embed_dim)
        stage_embs = []
        for i in range(3):
            decode = getattr(self, f"stage{i + 1}_output_decode")
            h = self.patches_resolution[0] >> i
            canvas = self._scatter_to_canvas(outs[i], plans[i].coords_flat,
                                             (h, h))
            dec = conv_nhwc(decode, canvas)
            stage_embs.append(torch.gather(
                dec.reshape(dec.shape[0], -1, dec.shape[-1]), 1, idx))
        stage_embs.append(outs[3])
        fused = (sum(stage_embs) if self.use_feature_fusion
                 else stage_embs[3])
        return outs, layer_norm(fused, self.norm_layer)

    @staticmethod
    def _scatter_to_canvas(x: torch.Tensor, coords_flat: torch.Tensor,
                           resolution) -> torch.Tensor:
        b, _, c = x.shape
        h, w = resolution
        canvas = x.new_zeros((b, h * w, c)).index_copy(1, coords_flat, x)
        return canvas.view(b, h, w, c)

    def encode_dense(self, x: torch.Tensor, plans=None,
                     return_attn: bool = False,
                     return_pyramid: bool = False):
        """Dense encoding under the no-mask plans (swin.py:478-520):
        ``(emb_l1, emb_l2, emb_h, out_embs, None)`` with ``emb_h`` stage
        4's tokens (B, 49, d3), normed where the model has ``norm_layer``,
        and with ``return_pyramid`` the channels-last 4-scale pyramid
        (with ``fpn``, a fifth level: GELU of its f32 BatchNorm). Swin
        returns no attention map."""
        if plans is None:
            plans = dense_plans(x.device, self.patches_resolution,
                                len(self.swin_block), self.window_size,
                                self.cell_grid)
        outs = self._run_stages(
            self._embed_visible(x, plans[0].coords_flat), plans)
        emb_h = (layer_norm(outs[-1], self.norm_layer)
                 if self.with_final_norm else outs[-1])
        out_embs = []
        if return_pyramid:
            for i, o in enumerate(outs):
                h = self.patches_resolution[0] >> i
                out_embs.append(o.reshape(o.shape[0], h, h, o.shape[-1]))
            if hasattr(self, "fpn"):
                conv, bn = self.fpn
                out_embs.append(F.gelu(bn(conv_nhwc(conv, out_embs[-1])),
                                       approximate="none"))
        return outs[0], outs[1], emb_h, out_embs, None

    def forward(self, x: torch.Tensor):
        return self.encode_dense(x)


def swin_tiny_window7(**kwargs) -> SparseSwin:
    """swin.py:526-534: Swin-T, window 7, 49 mask cells."""
    cfg = dict(input_size=224, patch_size=4, embed_dims=(96, 192, 384, 768),
               depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7,
               decoder_num_patches=49)
    cfg.update(kwargs)
    return SparseSwin(**cfg)
