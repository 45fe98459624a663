"""Stage-1 pretrain entry point: difference-guided masked modeling.

Counterpart of eventpretrain_tpu/cli/pretrain.py for ``--pr_phase rec`` on
the ViT hubs, with the JAX CLI's flags and defaults for the epochs, the
lr, weight decay and warmup, and the masking; ``--device`` picks the card
(default) or the CPU. On ``cuda`` the hub computes in bf16 (``--bf16``,
the default), which routes every block of the encoder and decoder through
the K1/K2 kernels, forward and backward. The other phases raise
``NotImplementedError``; the other backbones and resuming wait for their
slices.

    python -m eventpretrain_tpu_torch.cli.pretrain --pr_phase rec \\
        --dataset synthetic --model_size base --epochs 1

At the end of each ``--save_model_freq`` epochs and of the run it writes
``<output_dir>/checkpoint.pth`` as ``{"model": state_dict, "epoch": ...}``,
the key space the serve loader and ``load_jax_state_dict`` read.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from eventpretrain_tpu_torch.data.pretrain_pipeline import (
    EFImageNetSource,
    PretrainDataConfig,
    PretrainPipeline,
    SyntheticPretrainSource,
)
from eventpretrain_tpu_torch.models.pretrain_hub import (
    pretrain_hub_base,
    pretrain_hub_small,
)
from eventpretrain_tpu_torch.train.loop import train_one_epoch
from eventpretrain_tpu_torch.train.optim import (
    build_optimizer,
    cosine_warmup_schedule,
)
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import make_rec_step

PHASES = ["rec", "rec-n", "adj", "_adj", "adj-n", "con", "con-n", "rec+con",
          "ecdp", "ecdp-ef"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("pretrain")
    p.add_argument("--pr_phase", default="rec", choices=PHASES)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "ef_imagenet"])
    p.add_argument("--data_root", default=None)
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
    p.add_argument("--output_dir", default="./results/pretrain")
    p.add_argument("--save_model_freq", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="the port's device: cuda (the card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.pr_phase not in ("rec", "rec-n"):
        raise NotImplementedError(
            f"--pr_phase {args.pr_phase}: the port has the rec phase only")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    if args.dataset == "synthetic":
        source = SyntheticPretrainSource(
            n=max(args.batch_size * 4, 32), size=args.input_size,
            num_bins=args.num_bins, seed=args.seed,
        )
    else:
        if not args.data_root:
            raise SystemExit("--data_root required for ef_imagenet")
        source = EFImageNetSource(args.data_root)
    cfg = PretrainDataConfig(
        num_bins=args.num_bins, input_size=args.input_size,
        crop_min=args.crop_min,
        transfer_dtype="bfloat16" if args.bf16 else "float32",
    )

    factory = {"small": pretrain_hub_small, "base": pretrain_hub_base}
    hub = factory[args.model_size](
        num_bins=args.num_bins, frame_chans=args.frame_chans, dtype=dtype,
        device=device,
        generator=torch.Generator().manual_seed(args.seed),
        input_size=args.input_size, drop_path_rate=args.drop_path_rate,
        drop_rate=args.drop_rate, attn_drop_rate=args.attn_drop_rate,
        use_feature_fusion=args.use_feature_fusion,
    )
    n_params = sum(p.numel() for p in hub.parameters())
    print(f"model params: {n_params / 1e6:.2f}M ({dtype} compute, "
          f"f32 parameters, {device})")

    steps_per_epoch = max(len(source) // args.batch_size, 1)
    lr = args.lr if args.lr is not None else args.blr * args.batch_size / 256
    schedule = cosine_warmup_schedule(lr, args.min_lr, args.warmup_epochs,
                                      args.epochs, steps_per_epoch)
    optimizer = build_optimizer(
        hub, weight_decay=args.weight_decay, betas=(0.9, 0.95),
        layer_decay=args.layer_decay if args.use_layer_decay else 1.0,
        num_layers=12, layer_grafted=args.use_layer_grafted,
    )
    state = TrainState(hub, optimizer, schedule)
    step = make_rec_step(
        hub, patch_size=hub.patch_size, num_patches=hub.num_patches,
        mask_ratio=args.mask_ratio, masking_strategy=args.masking_strategy,
        norm_pix_loss=args.norm_pix_loss,
        generator=torch.Generator(device).manual_seed(args.seed),
    )

    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "checkpoint.pth")
    for epoch in range(args.epochs):
        t0 = time.time()
        pipe = PretrainPipeline(source, cfg, args.batch_size, train=True,
                                seed=args.seed + epoch,
                                num_workers=args.num_workers, device=device)
        state, metrics = train_one_epoch(step, state, pipe, epoch=epoch,
                                         print_freq=args.print_freq)
        record = {"epoch": epoch,
                  **{f"train_{k}": v for k, v in metrics.items()},
                  "epoch_time_s": round(time.time() - t0, 2)}
        print(json.dumps(record), flush=True)
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(record) + "\n")
        if (epoch + 1) % args.save_model_freq == 0 or epoch + 1 == args.epochs:
            sd = {k: v.detach().cpu() for k, v in hub.state_dict().items()}
            torch.save({"model": sd, "epoch": epoch}, path)
    return state


if __name__ == "__main__":
    main()
