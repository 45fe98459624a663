"""Pretrain entry point: the three stages of the paper on the ViT hubs.

Counterpart of eventpretrain_tpu/cli/pretrain.py for ``--pr_phase`` rec
(stage 1, difference-guided masked modeling), adj (stage 2,
backbone-fixed feature transition: the backbone frozen but its
``norm_layer``), con (stage 3, focus-aimed contrast, the whole model
trains) and rec+con (both objectives, summed), with the JAX CLI's flags
and defaults; ``--device`` picks the card (default) or the CPU. On
``cuda`` the hub computes in bf16 (``--bf16``, the default), which routes
every block of the encoder and decoder through the K1/K2 kernels; stage 2
runs them forward only. The contrastive phases read precomputed CLIP
token embeddings (EF-ImageNet's ``<image>_clip_emb.pt``, or the synthetic
source's) and pair the backbone's 196 tokens with CLIP ViT-B/16's 14x14
grid, so they need ``--input_size 224``. ``adj-n`` and ``con-n`` are
stages 2 and 3 with CLIP in the loop: raw N-ImageNet event streams
(``--n_imagenet_root``) and their ImageNet images (``--imagenet_root``),
or the synthetic raw source, through ``RawPretrainPipeline`` (K3 on the
input-size canvas), each batch's images encoded on the card by the frozen
CLIP ViT-B/16 (``ClipEncodingPipeline``; ``--clip_weights`` an OpenAI
checkpoint, else a random tower from seed 0, with a warning). CLIP's
parameters reach neither the optimizer nor a checkpoint.

    python -m eventpretrain_tpu_torch.cli.pretrain --pr_phase rec \\
        --dataset synthetic --model_size base --epochs 1
    python -m eventpretrain_tpu_torch.cli.pretrain --pr_phase adj \\
        --model_size base --init_from results/pretrain/checkpoint.pth
    python -m eventpretrain_tpu_torch.cli.pretrain --pr_phase adj-n \\
        --model_size base --dataset synthetic --epochs 1

``--init_from <file>.pth`` chains the stages: it fills every parameter
and buffer of the hub that the file holds under the reference key space
(the projectors' BatchNorm statistics among them) and leaves the rest at
their init, as ``init_variables_from(..., strict_backbone=False)`` does,
and seeds a ``--use_queue`` queue from the file's ``queue`` and
``queue_ptr``. At the end of each ``--save_model_freq`` epochs and of the
run it writes ``<output_dir>/checkpoint.pth`` as ``{"model": state_dict,
"epoch": ...}`` (with the queue's ``queue`` and ``queue_ptr``), which
the next stage's ``--init_from``, the serve loader and
``load_jax_state_dict`` read. The phases ``ecdp`` and ``ecdp-ef``,
``--accum_iter``, ``--data_parallel``, ``--visualize`` and an orbax
``--init_from`` raise ``NotImplementedError`` naming the slice that brings
them; JAX's other flags are not parsed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
from eventpretrain_tpu_torch.data.pretrain_pipeline import (
    ClipEncodingPipeline,
    EFImageNetSource,
    NImageNetPairedSource,
    PretrainDataConfig,
    PretrainPipeline,
    RawPretrainDataConfig,
    RawPretrainPipeline,
    SyntheticPretrainSource,
    SyntheticRawPretrainSource,
)
from eventpretrain_tpu_torch.models.clip import (
    clip_vit_b16,
    load_clip_visual_weights,
)
from eventpretrain_tpu_torch.models.pretrain_hub import (
    pretrain_hub_base,
    pretrain_hub_small,
)
from eventpretrain_tpu_torch.objectives.contrastive import (
    QueueState,
    init_queue,
)
from eventpretrain_tpu_torch.train.loop import train_one_epoch
from eventpretrain_tpu_torch.train.optim import (
    build_optimizer,
    cosine_warmup_schedule,
    freeze_except_norm,
)
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_con_step,
    make_rec_and_con_step,
    make_rec_step,
)

PHASES = ["rec", "rec-n", "adj", "_adj", "adj-n", "con", "con-n", "rec+con",
          "ecdp", "ecdp-ef"]
# cli/pretrain.py:198-207; the ECDP phases are refused
PHASE_ALIASES = {"rec-n": "rec", "_adj": "adj", "adj-n": "adj",
                 "con-n": "con"}
CLIP_IN_LOOP_PHASES = ("adj-n", "con-n")
CON_PHASES = ("adj", "con", "rec+con")
_REFUSED_PHASES = {
    "ecdp": "slice 5 (the ECDP baseline)",
    "ecdp-ef": "slice 5 (the ECDP baseline)",
}
# flags of the JAX CLI that the port does not have yet: (type, default,
# the slice that brings them); any other value is refused
_NOT_PORTED = {
    "accum_iter": (int, 1, "slice 4b (optax.MultiSteps accumulation)"),
    "data_parallel": (bool, False, "slice 6 (torch.distributed; with it "
                      "the local queue and BatchNorm scopes)"),
    "visualize": (bool, False, "slice 6 (viz/panels.py)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pretrain")
    p.add_argument("--pr_phase", default="rec", choices=PHASES)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "ef_imagenet", "n_imagenet"])
    p.add_argument("--data_root", default=None)
    p.add_argument("--n_imagenet_root", default=None,
                   help="raw N-ImageNet event .npz tree (adj-n/con-n)")
    p.add_argument("--imagenet_root", default=None,
                   help="paired ImageNet JPEG tree (adj-n/con-n)")
    p.add_argument("--clip_weights", default=None,
                   help="OpenAI CLIP ViT-B/16 checkpoint for in-loop "
                        "encoding; random init with a warning if omitted")
    p.add_argument("--fix_events_num", type=int, default=30000)
    p.add_argument("--pretrain_num_classes", type=int, default=None,
                   help="limit N-ImageNet classes (reference num_classes)")
    p.add_argument("--model_size", default="small", choices=["small", "base"])
    p.add_argument("--num_bins", type=int, default=5)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--frame_chans", type=int, default=1)
    p.add_argument("--mask_ratio", type=float, default=0.75)
    p.add_argument("--masking_strategy", default="random",
                   choices=["random", "density", "anti-density"])
    p.add_argument("--norm_pix_loss", action="store_true", default=True)
    p.add_argument("--no-norm_pix_loss", dest="norm_pix_loss",
                   action="store_false")
    p.add_argument("--use_queue", action="store_true")
    p.add_argument("--queue_length", type=int, default=65536)
    p.add_argument("--queue_scope", default="auto",
                   choices=["auto", "global", "local"],
                   help="without --data_parallel every scope is one queue "
                        "fed by the whole batch ('global')")
    p.add_argument("--bn_scope", default="auto",
                   choices=["auto", "global", "local"],
                   help="without --data_parallel every scope is the whole "
                        "batch's BatchNorm statistics ('global')")
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--warmup_epochs", type=float, default=40)
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=None,
                   help="absolute lr; overrides --blr * batch / 256")
    p.add_argument("--use_layer_decay", action="store_true")
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--use_layer_grafted", action="store_true")
    p.add_argument("--drop_path_rate", type=float, default=0.0)
    p.add_argument("--drop_rate", type=float, default=0.0)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    p.add_argument("--use_feature_fusion", action="store_true", default=True)
    p.add_argument("--no-use_feature_fusion", dest="use_feature_fusion",
                   action="store_false")
    p.add_argument("--crop_min", type=float, default=0.8)
    p.add_argument("--init_from", default=None,
                   help="stage chaining: a .pth checkpoint in the reference "
                        "key space (this CLI's own checkpoint.pth)")
    p.add_argument("--output_dir", default="./results/pretrain")
    p.add_argument("--save_model_freq", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="the port's device: cuda (the card) or cpu")
    for name, (typ, default, _) in _NOT_PORTED.items():
        if typ is bool:
            p.add_argument(f"--{name}", action="store_true")
        else:
            p.add_argument(f"--{name}", type=typ, default=default)
    return p


def _refuse_unported(args) -> None:
    if args.pr_phase in _REFUSED_PHASES:
        raise NotImplementedError(
            f"--pr_phase {args.pr_phase} is not ported yet; it comes with "
            f"{_REFUSED_PHASES[args.pr_phase]}")
    for name, (_, default, slice_) in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name} is not ported yet; it comes with {slice_}")
    if args.init_from and not args.init_from.endswith((".pth", ".pt",
                                                       ".bin")):
        raise NotImplementedError(
            f"--init_from {args.init_from}: only .pth files in the reference "
            "key space are read; the other dialects (orbax directories) "
            "come with slice 6")


def init_from_checkpoint(hub: torch.nn.Module, sd: dict) -> int:
    """Copy each tensor of ``sd`` whose key the hub's state dict has into
    it (parameters and buffers: the projectors' BatchNorm statistics);
    keys either side lacks are left alone, a shape that differs raises
    (torch_import.py:316-344 with ``strict_backbone=False``). Returns the
    count copied."""
    own = hub.state_dict()
    copied = 0
    with torch.no_grad():
        for key, value in sd.items():
            if key not in own:
                continue
            if tuple(value.shape) != tuple(own[key].shape):
                raise ValueError(f"--init_from: {key} is {tuple(value.shape)}"
                                 f", the hub's {tuple(own[key].shape)}")
            own[key].copy_(value)
            copied += 1
    return copied


def make_queue(args, hub, device, sd) -> QueueState:
    """The queue (cli/pretrain.py:465-503): ``queue_length`` a multiple of
    the batch, random normalised keys drawn from seed + 1 on ``device``,
    or the checkpoint's ``queue`` and ``queue_ptr`` where it has them."""
    if args.queue_length % args.batch_size:
        raise ValueError(f"--queue_length {args.queue_length} must be a "
                         f"multiple of --batch_size {args.batch_size}")
    if sd is not None and "queue" in sd:
        buf = sd["queue"].to(device=device, dtype=torch.float32)
        want = (hub.embed_dim, hub.num_patches, args.queue_length)
        if tuple(buf.shape) != want:
            raise ValueError(f"--init_from: queue is {tuple(buf.shape)}, "
                             f"expected {want}")
        ptr = int(sd["queue_ptr"].reshape(-1)[0]) if "queue_ptr" in sd else 0
        print(f"queue buffer seeded from {args.init_from}")
        return QueueState(buffer=buf.contiguous(), ptr=ptr)
    return init_queue(torch.Generator(device).manual_seed(args.seed + 1),
                      hub.embed_dim, hub.num_patches, args.queue_length,
                      device=device)


def raw_source(args):
    """The raw event source of ``adj-n``/``con-n`` (cli/pretrain.py:
    223-246): the synthetic one or raw N-ImageNet with its images."""
    if args.dataset == "synthetic":
        return SyntheticRawPretrainSource(n=max(args.batch_size * 4, 32),
                                          seed=args.seed)
    if not (args.n_imagenet_root and args.imagenet_root):
        raise SystemExit("adj-n/con-n need --n_imagenet_root and "
                         "--imagenet_root")
    return NImageNetPairedSource(args.n_imagenet_root, args.imagenet_root,
                                 num_classes=args.pretrain_num_classes)


def build_clip(dtype, device, weights: str | None = None) -> torch.nn.Module:
    """CLIP ViT-B/16 in the compute dtype from seed 0 (cli/pretrain.py:
    270-292), filled from the OpenAI checkpoint ``weights`` when given
    (``--clip_weights``); frozen."""
    clip = clip_vit_b16(dtype=dtype, device=device,
                        generator=torch.Generator().manual_seed(0))
    if weights:
        load_clip_visual_weights(weights, clip)
    else:
        print("[warn] --clip_weights not given: in-loop CLIP encoder is "
              "randomly initialized (smoke-run mode)")
    return clip.requires_grad_(False)


def main(argv=None):
    args = build_parser().parse_args(argv)
    clip_in_loop = args.pr_phase in CLIP_IN_LOOP_PHASES
    args.pr_phase = PHASE_ALIASES.get(args.pr_phase, args.pr_phase)
    _refuse_unported(args)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    need_decoder = args.pr_phase in ("rec", "rec+con")
    contrastive = args.pr_phase in CON_PHASES

    clip = None
    if clip_in_loop:
        source = raw_source(args)
        cfg = RawPretrainDataConfig(
            num_bins=args.num_bins, input_size=args.input_size,
            crop_min=args.crop_min, fix_events_num=args.fix_events_num)
        clip = build_clip(dtype, device, args.clip_weights)
    else:
        if args.dataset == "synthetic":
            source = SyntheticPretrainSource(
                n=max(args.batch_size * 4, 32), size=args.input_size,
                num_bins=args.num_bins, seed=args.seed,
            )
        else:
            if not args.data_root:
                raise SystemExit("--data_root required for ef_imagenet")
            source = EFImageNetSource(args.data_root,
                                      pr_phase=args.pr_phase)
        cfg = PretrainDataConfig(
            pr_phase=args.pr_phase, num_bins=args.num_bins,
            input_size=args.input_size, crop_min=args.crop_min,
            transfer_dtype="bfloat16" if args.bf16 else "float32",
        )

    factory = {"small": pretrain_hub_small, "base": pretrain_hub_base}
    hub = factory[args.model_size](
        num_bins=args.num_bins, frame_chans=args.frame_chans,
        with_decoder=need_decoder, with_heads=contrastive, dtype=dtype,
        device=device,
        generator=torch.Generator().manual_seed(args.seed),
        input_size=args.input_size, drop_path_rate=args.drop_path_rate,
        drop_rate=args.drop_rate, attn_drop_rate=args.attn_drop_rate,
        use_feature_fusion=args.use_feature_fusion,
    )
    if contrastive and hub.num_patches != 196:
        # token-level InfoNCE pairs the event tokens 1:1 with CLIP
        # ViT-B/16's 14x14 token grid (cli/pretrain.py:355-366)
        raise ValueError(
            f"--pr_phase {args.pr_phase} pairs event tokens with CLIP's "
            f"tokens; --input_size must be 224 (got {args.input_size} -> "
            f"{hub.num_patches} patches, need 196)")
    sd = None
    if args.init_from:
        sd = load_torch_checkpoint(args.init_from)
        n = init_from_checkpoint(hub, sd)
        print(f"init_from {args.init_from}: {n} of {len(hub.state_dict())} "
              "tensors")
    if args.pr_phase == "adj":
        freeze_except_norm(hub)
    n_params = sum(p.numel() for p in hub.parameters())
    n_train = sum(p.numel() for p in hub.parameters() if p.requires_grad)
    print(f"model params: {n_params / 1e6:.2f}M, {n_train / 1e6:.2f}M "
          f"trainable ({dtype} compute, f32 parameters, {device})")

    steps_per_epoch = max(len(source) // args.batch_size, 1)
    lr = args.lr if args.lr is not None else args.blr * args.batch_size / 256
    schedule = cosine_warmup_schedule(lr, args.min_lr, args.warmup_epochs,
                                      args.epochs, steps_per_epoch)
    optimizer = build_optimizer(
        hub, weight_decay=args.weight_decay, betas=(0.9, 0.95),
        layer_decay=args.layer_decay if args.use_layer_decay else 1.0,
        num_layers=12, layer_grafted=args.use_layer_grafted,
    )
    queue = (make_queue(args, hub, device, sd)
             if contrastive and args.use_queue else None)
    state = TrainState(hub, optimizer, schedule, queue=queue)
    generator = torch.Generator(device).manual_seed(args.seed)
    con = dict(use_queue=args.use_queue, temperature=args.temperature,
               queue_mode="global", generator=generator)
    rec = dict(patch_size=hub.patch_size, num_patches=hub.num_patches,
               mask_ratio=args.mask_ratio,
               masking_strategy=args.masking_strategy,
               norm_pix_loss=args.norm_pix_loss)
    if args.pr_phase == "rec":
        step = make_rec_step(hub, **rec, generator=generator)
    elif args.pr_phase in ("adj", "con"):
        step = make_con_step(hub, **con)
    else:
        step = make_rec_and_con_step(hub, **rec, **con)

    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "checkpoint.pth")
    for epoch in range(args.epochs):
        t0 = time.time()
        if clip_in_loop:
            pipe = ClipEncodingPipeline(
                RawPretrainPipeline(source, cfg, args.batch_size,
                                    train=True, seed=args.seed + epoch,
                                    num_workers=args.num_workers,
                                    device=device), clip)
        else:
            pipe = PretrainPipeline(source, cfg, args.batch_size, train=True,
                                    seed=args.seed + epoch,
                                    num_workers=args.num_workers,
                                    device=device)
        state, metrics = train_one_epoch(step, state, pipe, epoch=epoch,
                                         print_freq=args.print_freq)
        record = {"epoch": epoch,
                  **{f"train_{k}": v for k, v in metrics.items()},
                  "epoch_time_s": round(time.time() - t0, 2)}
        print(json.dumps(record), flush=True)
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(record) + "\n")
        if (epoch + 1) % args.save_model_freq == 0 or epoch + 1 == args.epochs:
            save_checkpoint(path, state, epoch)
    return state


def save_checkpoint(path: str, state: TrainState, epoch: int) -> None:
    """``{"model": state_dict, "epoch"}`` on the CPU; the queue, where the
    state has one, as the reference's ``queue`` (C, L, K) and
    ``queue_ptr`` (1,) buffers."""
    sd = {k: v.detach().cpu() for k, v in state.module.state_dict().items()}
    if state.queue is not None:
        sd["queue"] = state.queue.buffer.detach().cpu()
        sd["queue_ptr"] = torch.tensor([state.queue.ptr], dtype=torch.long)
    torch.save({"model": sd, "epoch": epoch}, path)


if __name__ == "__main__":
    main()
