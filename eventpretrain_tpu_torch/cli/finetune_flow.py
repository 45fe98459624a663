"""Optical-flow finetune entry point: raw events to a trained flow hub.

Counterpart of eventpretrain_tpu/cli/finetune_flow.py for ``--backbone
convvit`` (the default, as in JAX), ``vit``, ``swin`` (Swin-T),
``vit_ecdp`` and ``convvit_ecdp`` (``--num_bins`` 2: the count image, 3:
the MEM image), with
the JAX CLI's flags and defaults for the data (30000 events a sample,
MVSEC's outdoor_day2 to train and the three indoor_flying splits to
validate), the optimizer (AdamW (0.9, 0.999), base lr 1e-3, layer decay,
gradient clip 3.0), the loss (decode 1.0 and auxiliary 0.4 times the L1 on
valid pixels, flows over ``--max_flow`` left out), ``--sample_mode`` and the
regularizers (drop-path 0.1, the heads' dropout 0.1). The hub is a dense
hub with two output channels, the flow's (u, v). ``--device`` picks the
card (default) or the CPU; on ``cuda`` the hub computes in bf16
(``--bf16``, the default).

    python -m eventpretrain_tpu_torch.cli.finetune_flow \\
        --dataset synthetic --epochs 2 --batch_size 4
    python -m eventpretrain_tpu_torch.cli.finetune_flow \\
        --dataset mvsec --data_root /path/to/mvsec

The synthetic source is JAX's smoke data (a 64x64 sensor, 4000 events a
sample, a unit flow in the quadrant the events fill). ``--dataset mvsec``
reads ``<data_root>/<split>_data.hdf5`` and ``<split>_gt.hdf5``
(``data/mvsec.py``; it needs ``h5py``); MVSEC's 260x346 grid is over the
untiled splat's 65536 cells, so its batches go through the host tile
bucketer and the tiled splat K6. Validation reports each split's AEE and
outlier share over the sparse mask (valid ground truth where events fell).
``--finetune`` loads a ``checkpoint.pth`` that a port CLI wrote, as the
semseg CLI does. Each epoch appends a JSON line to ``<output_dir>/log.txt``
and writes ``<output_dir>/checkpoint.pth`` as ``{"model": state_dict,
"epoch": ...}``, and ``best_<split>.pth`` where a split's AEE improved.
Flags of the JAX CLI that the port does not have yet raise an error naming
the slice that brings them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from eventpretrain_tpu_torch.cli.finetune_semseg import (
    BACKBONES,
    REFUSED_BACKBONES,
    load_finetune,
)
from eventpretrain_tpu_torch.data.dense_pipeline import (
    DenseDataConfig,
    DensePipeline,
    SyntheticDenseSource,
)
from eventpretrain_tpu_torch.models.dense_hub import (
    dense_hub_convvit_base,
    dense_hub_convvit_ecdp_base,
    dense_hub_convvit_ecdp_small,
    dense_hub_convvit_small,
    dense_hub_swin_tiny,
    dense_hub_vit_base,
    dense_hub_vit_ecdp_base,
    dense_hub_vit_ecdp_small,
    dense_hub_vit_small,
)
from eventpretrain_tpu_torch.train.loop import train_one_epoch
from eventpretrain_tpu_torch.train.optim import (
    build_optimizer,
    cosine_warmup_schedule,
)
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_flow_eval_step,
    make_flow_train_step,
)

MVSEC_HW = (260, 346)

# flags of the JAX CLI that the port does not have yet: (type, default,
# the slice that brings them); any other value is refused
_NOT_PORTED = {
    "use_checkpoint": (bool, False, "slice 6 (activation recompute)"),
    "feed_batches": (str, None, "slice 6 (batch replay)"),
    "lenient_import": (bool, False, "slice 6 (the torch import dialects)"),
    "export_torch": (str, None, "slice 6 (export artifacts)"),
    "export_serving": (str, None, "slice 6 (export artifacts)"),
    "serving_native": (bool, False, "slice 6 (export artifacts)"),
    "serving_batch_sizes": (str, "1,8", "slice 6 (export artifacts)"),
    "resume": (str, None, "slice 6 (checkpoint resume)"),
    "auto_resume": (bool, False, "slice 6 (checkpoint resume)"),
    "tensorboard": (bool, False, "slice 6 (utils/logging.py)"),
    "visualize": (bool, False, "slice 6 (viz/panels.py, needs matplotlib)"),
    "forward_only": (bool, False, "slice 6 (forward-only steps)"),
    "profile_dir": (str, None, "slice 6 (utils/profiling.py)"),
    "data_parallel": (bool, False, "slice 6 (torch.distributed)"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("finetune_flow")
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "mvsec"])
    p.add_argument("--data_root", default=None,
                   help="the MVSEC directory (--dataset mvsec)")
    p.add_argument("--val_splits", nargs="*",
                   default=["indoor_flying1", "indoor_flying2",
                            "indoor_flying3"])
    p.add_argument("--backbone", default="convvit", choices=BACKBONES)
    p.add_argument("--model_size", default="small", choices=["small", "base"])
    p.add_argument("--num_bins", type=int, default=5)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--fix_events_num", type=int, default=30_000)
    p.add_argument("--val_fix_events_num", type=int, default=30_000)
    p.add_argument("--max_flow", type=float, default=400.0)
    p.add_argument("--skip_num", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--warmup_epochs", type=float, default=2)
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--use_layer_decay", action="store_true")
    p.add_argument("--clip_grad", type=float, default=3.0)
    p.add_argument("--w_decode_loss", type=float, default=1.0)
    p.add_argument("--w_auxiliary_loss", type=float, default=0.4)
    p.add_argument("--drop_path_rate", type=float, default=0.1)
    p.add_argument("--decode_dropout", type=float, default=0.1)
    p.add_argument("--drop_rate", type=float, default=0.0)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    p.add_argument("--crop_min", type=float, default=0.8)
    p.add_argument("--sample_mode", default="bilinear",
                   choices=["nearest", "bilinear", "bicubic"],
                   help="the heads' and the predictions' resize")
    p.add_argument("--lr", type=float, default=None,
                   help="absolute lr; overrides --blr * batch / 256")
    p.add_argument("--finetune", default=None,
                   help="checkpoint.pth of a port CLI whose backbone (and "
                        "heads, when it has them) initialise the hub")
    p.add_argument("--output_dir", default="./results/finetune_flow")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="the port's device: cuda (the card) or cpu")
    for name, (typ, default, _) in _NOT_PORTED.items():
        if typ is bool:
            p.add_argument(f"--{name}", action="store_true")
        else:
            p.add_argument(f"--{name}", type=typ, default=default)
    return p


def _refuse_unported(args) -> None:
    for name, (_, default, slice_) in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise SystemExit(f"finetune_flow: --{name} is not ported yet; "
                             f"it comes with {slice_}")
    if args.backbone in REFUSED_BACKBONES:
        raise SystemExit(f"finetune_flow: --backbone {args.backbone} is not "
                         "ported yet; it comes with "
                         f"{REFUSED_BACKBONES[args.backbone]}")
    if args.dataset == "mvsec" and not args.data_root:
        raise SystemExit("finetune_flow: --dataset mvsec needs --data_root")


def make_sources(args):
    """(train, {split: val}, sensor (h, w)), as finetune_flow.py:150-170."""
    if args.dataset == "synthetic":
        train = SyntheticDenseSource("flow", n=32, seed=args.seed)
        vals = {"synthetic": SyntheticDenseSource("flow", n=8,
                                                  seed=args.seed + 100)}
        return train, vals, train.sensor_hw
    from eventpretrain_tpu_torch.data.mvsec import MvsecSource

    train = MvsecSource(args.data_root, "outdoor_day2", args.fix_events_num,
                        skip_num=args.skip_num)
    vals = {split: MvsecSource(args.data_root, split,
                               args.val_fix_events_num,
                               skip_num=args.skip_num)
            for split in args.val_splits}
    return train, vals, MVSEC_HW


def validate(eval_step, pipe) -> dict:
    """AEE and outlier share (percent) of one split over its sparse mask,
    and the mean inference time per batch (ft_flow_trainer.py:269)."""
    epe = out = count = 0.0
    n = 0
    t0 = time.time()
    for batch in pipe:
        m = eval_step(batch)
        epe += float(m["epe_sum"])
        out += float(m["outlier_sum"])
        count += float(m["count"])
        n += 1
    return {"aee": epe / max(count, 1.0),
            "outlier": 100.0 * out / max(count, 1.0),
            "count": count,
            "infer_ms": 1000 * (time.time() - t0) / max(n, 1)}


def main(argv=None) -> dict:
    """Run the finetune; returns ``{"state", "best_aee", "val"}`` (the train
    state, each split's best AEE, and the last epoch's ``validate``
    record of each split)."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    train_src, val_srcs, sensor_hw = make_sources(args)
    cfg = DenseDataConfig(
        task="flow", num_bins=args.num_bins, input_size=args.input_size,
        fix_events_num=args.fix_events_num,
        val_fix_events_num=args.val_fix_events_num,
        sensor_height=sensor_hw[0], sensor_width=sensor_hw[1],
        crop_min=args.crop_min, label_size=sensor_hw,
    )
    factory = {
        ("vit", "small"): dense_hub_vit_small,
        ("vit", "base"): dense_hub_vit_base,
        ("convvit", "small"): dense_hub_convvit_small,
        ("convvit", "base"): dense_hub_convvit_base,
        ("swin", "small"): dense_hub_swin_tiny,
        ("swin", "base"): dense_hub_swin_tiny,
        ("vit_ecdp", "small"): dense_hub_vit_ecdp_small,
        ("vit_ecdp", "base"): dense_hub_vit_ecdp_base,
        ("convvit_ecdp", "small"): dense_hub_convvit_ecdp_small,
        ("convvit_ecdp", "base"): dense_hub_convvit_ecdp_base,
    }[(args.backbone, args.model_size)]
    hub = factory(
        2, args.num_bins, dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(args.seed),
        sample_mode=args.sample_mode, decode_dropout=args.decode_dropout,
        input_size=args.input_size, drop_path_rate=args.drop_path_rate,
        drop_rate=args.drop_rate, attn_drop_rate=args.attn_drop_rate,
    )
    if args.finetune:
        load_finetune(hub, args.finetune)
        print(f"initialised from {args.finetune}")
    n_params = sum(p.numel() for p in hub.parameters())
    print(f"model params: {n_params / 1e6:.2f}M ({dtype} compute, "
          f"f32 parameters, {device})")

    steps_per_epoch = max(len(train_src) // args.batch_size, 1)
    lr = args.lr if args.lr is not None else args.blr * args.batch_size / 256
    schedule = cosine_warmup_schedule(lr, args.min_lr, args.warmup_epochs,
                                      args.epochs, steps_per_epoch)
    optimizer = build_optimizer(
        hub, weight_decay=args.weight_decay, betas=(0.9, 0.999),
        layer_decay=args.layer_decay if args.use_layer_decay else 1.0,
        num_layers=13 if args.backbone.startswith("convvit") else 12,
        backbone_type=args.backbone,
    )
    state = TrainState(hub, optimizer, schedule, clip_grad=args.clip_grad)
    train_step = make_flow_train_step(
        hub, max_flow=args.max_flow, w_decode=args.w_decode_loss,
        w_aux=args.w_auxiliary_loss, sample_mode=args.sample_mode,
        generator=torch.Generator(device).manual_seed(args.seed),
    )
    eval_step = make_flow_eval_step(hub, sample_mode=args.sample_mode)

    os.makedirs(args.output_dir, exist_ok=True)
    best_aee = {split: float("inf") for split in val_srcs}
    val = {}
    for epoch in range(args.epochs):
        t0 = time.time()
        pipe = DensePipeline(train_src, cfg, args.batch_size, train=True,
                             seed=args.seed + epoch, device=device)
        state, train_metrics = train_one_epoch(
            train_step, state, pipe, epoch=epoch, print_freq=args.print_freq)
        record = {"epoch": epoch,
                  **{f"train_{k}": v for k, v in train_metrics.items()}}
        sd = {k: v.detach().cpu() for k, v in hub.state_dict().items()}
        for split, src in val_srcs.items():
            val[split] = validate(eval_step, DensePipeline(
                src, cfg, args.batch_size, train=False, seed=args.seed,
                device=device))
            aee = val[split]["aee"]
            print(f"epoch {epoch} [{split}]: AEE {aee:.3f} outliers "
                  f"{val[split]['outlier']:.2f}% (inference "
                  f"{val[split]['infer_ms']:.1f} ms/batch)", flush=True)
            record.update({f"{split}_aee": aee,
                           f"{split}_outlier": val[split]["outlier"],
                           f"{split}_infer_ms": round(
                               val[split]["infer_ms"], 2)})
            if aee < best_aee[split]:
                best_aee[split] = aee
                torch.save({"model": sd, "epoch": epoch},
                           os.path.join(args.output_dir, f"best_{split}.pth"))
        record["epoch_time_s"] = round(time.time() - t0, 2)
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(record) + "\n")
        torch.save({"model": sd, "epoch": epoch},
                   os.path.join(args.output_dir, "checkpoint.pth"))
    print("best AEE per split:", best_aee)
    if args.dataset == "mvsec":
        for src in (train_src, *val_srcs.values()):
            src.close()
    return {"state": state, "best_aee": best_aee, "val": val}


if __name__ == "__main__":
    main()
