"""Pretrain entry point: the three stages of the paper on the ViT, ConvViT
and sparse Swin hubs (``--backbone``).

Counterpart of eventpretrain_tpu/cli/pretrain.py for ``--pr_phase`` rec
(stage 1, difference-guided masked modeling), adj (stage 2, backbone-fixed
feature transition: the backbone frozen but its ``norm_layer``), con (stage
3, focus-aimed contrast, the whole model trains) and rec+con (both
objectives, summed), with the JAX CLI's flags and defaults; ``--device``
picks the card (default) or the CPU. On ``cuda`` the hub computes in bf16
(``--bf16``, the default), which routes every block of the encoder and
decoder through the K1/K2 kernels; stage 2 runs them forward only. The
contrastive phases read precomputed CLIP token embeddings (EF-ImageNet's
``<image>_clip_emb.pt``, or the synthetic source's) and pair the backbone's
196 tokens with CLIP ViT-B/16's 14x14 grid (Swin-T's 49 with the grid
through a 2x2 stride-2 conv), so they need ``--input_size 224``.
``--backbone swin`` is Swin-T whatever ``--model_size``, as in JAX: its rec
and rec+con steps mask 32-pixel cells (``--mask_ratio``, one mask a batch,
drawn from a schedule keyed by ``--seed`` and the step index,
``--masking_strategy`` unused) and plan their windows on the host
(``make_swin_rec_step``). ``adj-n`` and ``con-n`` are stages 2 and 3 with
CLIP in the loop: raw N-ImageNet event streams (``--n_imagenet_root``) and
their ImageNet images (``--imagenet_root``), or the synthetic raw source,
through ``RawPretrainPipeline`` (K3 on the input-size canvas), each batch's
images encoded on the card by the frozen CLIP ViT-B/16
(``ClipEncodingPipeline``; ``--clip_weights`` an OpenAI checkpoint, else a
random tower from seed 0, with a warning). CLIP's parameters reach neither
the optimizer nor a checkpoint.

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
``load_jax_state_dict`` read. ``--accum_iter k`` averages the gradients of
k batches of ``--batch_size`` into each update (``optax.MultiSteps``), as
JAX does: the base lr scales with the effective batch ``batch_size * k``,
the schedule counts updates (``steps // k`` an epoch), and the queue's
length must be a multiple of the effective batch.

``--pr_phase ecdp`` (``ecdp-ef`` is its alias) is the ECDP baseline
(cli/pretrain.py:747-940): two masked views of 2-channel count images, the
query encoder and its EMA key encoder (``--ema_m``, cosine to 1), the
image and event InfoNCE (``--use_queue``: per-sample queues of
``--queue_length`` keys, no multiple of the batch needed) and the
sinkhorn-KL, weighted by ``--lambda_image/event/kl``. Its sources: the
synthetic 2-channel grids, EF-ImageNet (``--data_root``) and raw
N-ImageNet (``--n_imagenet_root`` with ``--imagenet_root``, CLIP in the
loop, its class token, or ``--clip_emb_root``), whose count images K3
builds on the card. ``--backbone convvit`` is ConvViT-ECDP, every other
backbone ViT-ECDP, as in JAX. Its checkpoint holds the key encoder as
``"ema"`` beside ``"model"`` (and the queues); ``--init_from`` and
``--accum_iter``, which JAX's ECDP phase does not read, are refused.

    python -m eventpretrain_tpu_torch.cli.pretrain --pr_phase ecdp \\
        --dataset synthetic --epochs 1

``--data_parallel``, ``--visualize`` and an orbax ``--init_from`` raise
``NotImplementedError`` naming the slice that brings them; JAX's other
flags are not parsed.
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
    EcdpPretrainPipeline,
    EcdpRawPretrainPipeline,
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
from eventpretrain_tpu_torch.models.ecdp_hub import (
    ecdp_model_base,
    ecdp_model_convvit_base,
    ecdp_model_convvit_small,
    ecdp_model_small,
    make_key_encoder,
)
from eventpretrain_tpu_torch.models.pretrain_hub import (
    pretrain_hub_base,
    pretrain_hub_convvit_base,
    pretrain_hub_convvit_small,
    pretrain_hub_small,
    pretrain_hub_swin,
)
from eventpretrain_tpu_torch.objectives.contrastive import (
    QueueState,
    init_queue,
)
from eventpretrain_tpu_torch.objectives.ecdp import init_sample_queue
from eventpretrain_tpu_torch.train.loop import train_one_epoch
from eventpretrain_tpu_torch.train.optim import (
    build_optimizer,
    cosine_warmup_schedule,
    freeze_except_norm,
)
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_con_step,
    make_ecdp_step,
    make_rec_and_con_step,
    make_rec_step,
    make_swin_rec_and_con_step,
    make_swin_rec_step,
)

PHASES = ["rec", "rec-n", "adj", "_adj", "adj-n", "con", "con-n", "rec+con",
          "ecdp", "ecdp-ef"]
# cli/pretrain.py:198-207
PHASE_ALIASES = {"rec-n": "rec", "_adj": "adj", "adj-n": "adj",
                 "con-n": "con", "ecdp-ef": "ecdp"}
CLIP_IN_LOOP_PHASES = ("adj-n", "con-n")
CON_PHASES = ("adj", "con", "rec+con")
# flags of the JAX CLI that the port does not have yet: (type, default,
# the slice that brings them); any other value is refused
_NOT_PORTED = {
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
                   help="paired ImageNet JPEG tree (adj-n/con-n, ecdp)")
    p.add_argument("--clip_emb_root", default=None,
                   help="precomputed CLIP embeddings of the N-ImageNet "
                        "streams (ecdp, instead of --imagenet_root)")
    p.add_argument("--clip_weights", default=None,
                   help="OpenAI CLIP ViT-B/16 checkpoint for in-loop "
                        "encoding; random init with a warning if omitted")
    p.add_argument("--fix_events_num", type=int, default=30000)
    p.add_argument("--pretrain_num_classes", type=int, default=None,
                   help="limit N-ImageNet classes (reference num_classes)")
    p.add_argument("--backbone", default="vit",
                   choices=["vit", "convvit", "swin"])
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
    p.add_argument("--ema_m", type=float, default=0.99,
                   help="ecdp: the key encoder's base EMA momentum")
    p.add_argument("--lambda_image", type=float, default=1.0)
    p.add_argument("--lambda_event", type=float, default=1.0)
    p.add_argument("--lambda_kl", type=float, default=2.0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--accum_iter", type=int, default=1,
                   help="microsteps of --batch_size an update averages")
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
    if args.accum_iter < 1:
        raise ValueError(f"--accum_iter must be at least 1, got "
                         f"{args.accum_iter}")
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
    the effective batch ``batch_size * accum_iter``, random normalised keys
    drawn from seed + 1 on ``device``, or the checkpoint's ``queue`` and
    ``queue_ptr`` where it has them."""
    if args.queue_length % (args.batch_size * args.accum_iter):
        raise ValueError(f"--queue_length {args.queue_length} must be a "
                         f"multiple of --batch_size {args.batch_size} times "
                         f"--accum_iter {args.accum_iter}")
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
    if args.pr_phase == "ecdp":
        return main_ecdp(args)
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

    factory = {
        ("vit", "small"): pretrain_hub_small,
        ("vit", "base"): pretrain_hub_base,
        ("convvit", "small"): pretrain_hub_convvit_small,
        ("convvit", "base"): pretrain_hub_convvit_base,
        ("swin", "small"): pretrain_hub_swin,
        ("swin", "base"): pretrain_hub_swin,
    }[(args.backbone, args.model_size)]
    hub = factory(
        num_bins=args.num_bins, frame_chans=args.frame_chans,
        with_decoder=need_decoder, with_heads=contrastive, dtype=dtype,
        device=device,
        generator=torch.Generator().manual_seed(args.seed),
        input_size=args.input_size, drop_path_rate=args.drop_path_rate,
        drop_rate=args.drop_rate, attn_drop_rate=args.attn_drop_rate,
        use_feature_fusion=args.use_feature_fusion,
    )
    # token-level InfoNCE pairs the event tokens 1:1 with CLIP ViT-B/16's
    # 14x14 token grid, Swin's 7x7 through the conv (cli/pretrain.py:
    # 355-367)
    want = 49 if args.backbone == "swin" else 196
    if contrastive and hub.num_patches != want:
        raise ValueError(
            f"--pr_phase {args.pr_phase} pairs event tokens with CLIP's "
            f"tokens; --input_size must be 224 (got {args.input_size} -> "
            f"{hub.num_patches} patches, need {want})")
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
    eff_batch = args.batch_size * args.accum_iter
    lr = args.lr if args.lr is not None else args.blr * eff_batch / 256
    # the schedule counts updates (cli/pretrain.py:425-435)
    schedule = cosine_warmup_schedule(
        lr, args.min_lr, args.warmup_epochs, args.epochs,
        max(steps_per_epoch // args.accum_iter, 1))
    optimizer = build_optimizer(
        hub, weight_decay=args.weight_decay, betas=(0.9, 0.95),
        layer_decay=args.layer_decay if args.use_layer_decay else 1.0,
        # the ConvViT's stage-3 block ids reach 13 (cli/pretrain.py:443)
        num_layers=13 if args.backbone == "convvit" else 12,
        backbone_type=args.backbone, layer_grafted=args.use_layer_grafted,
        accum_steps=args.accum_iter,
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
    if args.pr_phase in ("adj", "con"):
        step = make_con_step(hub, **con)
    elif args.backbone == "swin":
        # the Swin schedule (cli/pretrain.py:525-553): 32-pixel cells, the
        # patch grid at input_size // 4
        swin = dict(cell_grid=int(hub.num_patches ** 0.5),
                    mask_ratio=args.mask_ratio,
                    decoder_patch_size=hub.patch_size,
                    norm_pix_loss=args.norm_pix_loss,
                    input_resolution=args.input_size // 4,
                    window_size=hub.backbone.window_size,
                    plan_seed=args.seed)
        step = (make_swin_rec_step(hub, **swin, generator=generator)
                if args.pr_phase == "rec"
                else make_swin_rec_and_con_step(hub, **swin, **con))
    elif args.pr_phase == "rec":
        step = make_rec_step(hub, **rec, generator=generator)
    else:
        step = make_rec_and_con_step(hub, **rec, **con)

    def make_pipe(epoch):
        if clip_in_loop:
            return ClipEncodingPipeline(
                RawPretrainPipeline(source, cfg, args.batch_size,
                                    train=True, seed=args.seed + epoch,
                                    num_workers=args.num_workers,
                                    device=device), clip)
        return PretrainPipeline(source, cfg, args.batch_size, train=True,
                                seed=args.seed + epoch,
                                num_workers=args.num_workers, device=device)

    return train_epochs(args, state, step, make_pipe)


def train_epochs(args, state: TrainState, step, make_pipe) -> TrainState:
    """``args.epochs`` epochs of ``step`` over ``make_pipe(epoch)``: each
    epoch's mean metrics printed and appended to ``<output_dir>/log.txt``
    as a JSON line, ``<output_dir>/checkpoint.pth`` written every
    ``save_model_freq`` epochs and at the end."""
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "checkpoint.pth")
    for epoch in range(args.epochs):
        t0 = time.time()
        state, metrics = train_one_epoch(step, state, make_pipe(epoch),
                                         epoch=epoch,
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


def ecdp_source(args):
    """``(source, raw)`` of the ECDP phase (cli/pretrain.py:763-808): raw
    N-ImageNet streams with their images or precomputed embeddings, the
    synthetic 2-channel grids with one CLIP token, or EF-ImageNet."""
    if args.dataset == "n_imagenet":
        if not (args.n_imagenet_root
                and (args.imagenet_root or args.clip_emb_root)):
            raise SystemExit("--dataset n_imagenet needs --n_imagenet_root "
                             "plus one of --imagenet_root (in-loop CLIP) / "
                             "--clip_emb_root")
        return NImageNetPairedSource(
            args.n_imagenet_root, imagenet_root=args.imagenet_root,
            clip_emb_root=args.clip_emb_root,
            num_classes=args.pretrain_num_classes), True
    if args.dataset == "synthetic":
        return SyntheticPretrainSource(
            n=max(args.batch_size * 4, 32), size=args.input_size,
            num_bins=2, clip_tokens=1, seed=args.seed), False
    if not args.data_root:
        raise SystemExit("--data_root required for ef_imagenet")
    return EFImageNetSource(args.data_root, pr_phase="con"), False


def main_ecdp(args) -> TrainState:
    """The ECDP baseline's pretraining (cli/pretrain.py:747-940)."""
    for flag, bad in (("--init_from", args.init_from),
                      ("--accum_iter", args.accum_iter != 1)):
        if bad:
            raise ValueError(f"--pr_phase ecdp does not read {flag}, as in "
                             "JAX")
    args.num_bins = 2
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    source, raw = ecdp_source(args)
    clip = (build_clip(dtype, device, args.clip_weights)
            if raw and args.imagenet_root else None)
    factory = {
        ("vit", "small"): ecdp_model_small,
        ("vit", "base"): ecdp_model_base,
        ("convvit", "small"): ecdp_model_convvit_small,
        ("convvit", "base"): ecdp_model_convvit_base,
    }["convvit" if args.backbone == "convvit" else "vit", args.model_size]
    model = factory(dtype=dtype, device=device,
                    generator=torch.Generator().manual_seed(args.seed),
                    input_size=args.input_size,
                    drop_path_rate=args.drop_path_rate,
                    drop_rate=args.drop_rate,
                    attn_drop_rate=args.attn_drop_rate)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M ({dtype} compute, f32 "
          f"parameters, {device})")
    steps_per_epoch = max(len(source) // args.batch_size, 1)
    lr = (args.lr if args.lr is not None
          else args.blr * args.batch_size / 256)
    schedule = cosine_warmup_schedule(lr, args.min_lr, args.warmup_epochs,
                                      args.epochs, steps_per_epoch)
    optimizer = build_optimizer(model, weight_decay=args.weight_decay,
                                betas=(0.9, 0.95), num_layers=12)
    queue = None
    if args.use_queue:
        queue = tuple(init_sample_queue(
            torch.Generator(device).manual_seed(args.seed + i),
            model.encoder.config["proj_dim"], args.queue_length,
            device=device) for i in (1, 2))
    state = TrainState(model, optimizer, schedule, queue=queue,
                       key_encoder=make_key_encoder(model))
    step = make_ecdp_step(
        model, num_patches=model.num_patches, mask_ratio=args.mask_ratio,
        use_queue=args.use_queue, lambda_image=args.lambda_image,
        lambda_event=args.lambda_event, lambda_kl=args.lambda_kl,
        base_ema_momentum=args.ema_m, total_epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        generator=torch.Generator(device).manual_seed(args.seed))
    cfg = PretrainDataConfig(pr_phase="ecdp", num_bins=2,
                             input_size=args.input_size,
                             crop_min=args.crop_min)
    raw_cfg = RawPretrainDataConfig(num_bins=2, input_size=args.input_size,
                                    crop_min=args.crop_min,
                                    fix_events_num=args.fix_events_num)
    def make_pipe(epoch):
        if not raw:
            return EcdpPretrainPipeline(source, cfg, args.batch_size,
                                        train=True, seed=args.seed + epoch,
                                        num_workers=args.num_workers,
                                        device=device)
        pipe = EcdpRawPretrainPipeline(
            source, raw_cfg, args.batch_size, train=True,
            seed=args.seed + epoch, num_workers=args.num_workers,
            device=device)
        return (pipe if clip is None
                else ClipEncodingPipeline(pipe, clip, cls_only=True))

    return train_epochs(args, state, step, make_pipe)


def save_checkpoint(path: str, state: TrainState, epoch: int) -> None:
    """``{"model": state_dict, "epoch"}`` on the CPU; the queue, where the
    state has one, as the reference's ``queue`` (C, L, K) and
    ``queue_ptr`` (1,) buffers. An ECDP state adds its key encoder's
    parameters as ``"ema"`` and its queues, where it has them, as
    ``queue_image``/``queue_event`` (C, K) with their ``*_ptr``."""
    def cpu(module):
        return {k: v.detach().cpu() for k, v in module.state_dict().items()}

    sd = cpu(state.module)
    out = {"model": sd, "epoch": epoch}
    if state.key_encoder is not None:
        out["ema"] = cpu(state.key_encoder)
        for name, q in zip(("queue_image", "queue_event"),
                           state.queue or ()):
            out[name] = q.buffer.detach().cpu()
            out[f"{name}_ptr"] = torch.tensor([q.ptr], dtype=torch.long)
    elif state.queue is not None:
        sd["queue"] = state.queue.buffer.detach().cpu()
        sd["queue_ptr"] = torch.tensor([state.queue.ptr], dtype=torch.long)
    torch.save(out, path)


if __name__ == "__main__":
    main()
