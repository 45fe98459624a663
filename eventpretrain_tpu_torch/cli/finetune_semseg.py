"""Semantic-segmentation finetune entry point: raw events to a trained
segmentation hub.

Counterpart of eventpretrain_tpu/cli/finetune_semseg.py for ``--backbone
convvit`` (the default, as in JAX), ``vit``, ``swin`` (Swin-T whatever
``--model_size``, as in JAX), ``vit_ecdp``, ``convvit_ecdp``, ``vit_mem``
and ``swin_ecddp`` (Swin-ECDDP-T whatever ``--model_size``) on the
synthetic source and on DSEC and DDD17 under ``--data_root``
(``--num_bins`` 2: the count image; 3: the MEM image), with the JAX
CLI's flags and defaults for the data, the optimizer (AdamW (0.9,
0.999), base lr 1e-3, layer decay, no gradient clip unless asked), the
loss weights (decode 1.0, auxiliary 0.4), ``--sample_mode`` and the
regularizers (drop-path 0.1, the heads' dropout 0.1). ``--device``
picks the card (default) or the CPU; on ``cuda`` the hub computes in bf16
(``--bf16``, the default).

    python -m eventpretrain_tpu_torch.cli.finetune_semseg \\
        --dataset synthetic --epochs 2 --batch_size 4

As in JAX, the synthetic source has 5 classes and no ignore label (64x64
sensor, 4000 events per sample). ``--dataset dsec`` reads DSEC's train
and val sequences under ``--data_root`` at 440x640 (``DsecSource``; it
needs ``h5py`` and ``PIL``); ``--dataset ddd17`` reads DDD17's ``dir0,
dir3, dir4, dir6, dir7`` for training and ``dir1`` for validation at
200x346 (``Ddd17Source``; it needs ``PIL``), the validation window taken
at the training fix + 10000 events, as the reference does: pass
``--fix_events_num 80000`` for DDD17's default.

``--finetune`` initialises the hub from a ``checkpoint.pth`` that a port
CLI wrote as JAX's ``init_variables_from(strict_backbone=True)`` does:
every backbone
parameter must be in the file (a ConvViT rec checkpoint lacks the FPN's
and raises, as in JAX), the tensors the hub lacks go unused, and the heads
take the file's tensors, BatchNorm running statistics included, where it
has them. Each epoch appends a JSON line to ``<output_dir>/log.txt`` and
writes ``<output_dir>/checkpoint.pth`` as ``{"model": state_dict,
"epoch": ...}``; an ECDP checkpoint's query encoder fills the backbone
(``ckpt.bridge.finetune_state_dict``). Flags of the JAX CLI that the port
does not have yet raise an error naming the slice that brings them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from eventpretrain_tpu_torch.ckpt.bridge import (
    finetune_state_dict,
    init_from_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.data.dense_pipeline import (
    Ddd17Source,
    DenseDataConfig,
    DensePipeline,
    DsecSource,
    SyntheticDenseSource,
)
from eventpretrain_tpu_torch.eval.metrics import (
    macc_from_confusion,
    miou_from_confusion,
)
from eventpretrain_tpu_torch.models.dense_hub import (
    dense_hub_convvit_base,
    dense_hub_convvit_ecdp_base,
    dense_hub_convvit_ecdp_small,
    dense_hub_convvit_small,
    dense_hub_swin_ecddp_tiny,
    dense_hub_swin_tiny,
    dense_hub_vit_base,
    dense_hub_vit_ecdp_base,
    dense_hub_vit_ecdp_small,
    dense_hub_vit_mem_base,
    dense_hub_vit_mem_small,
    dense_hub_vit_small,
)
from eventpretrain_tpu_torch.train.loop import train_one_epoch
from eventpretrain_tpu_torch.train.optim import (
    build_optimizer,
    cosine_warmup_schedule,
)
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_semseg_eval_step,
    make_semseg_train_step,
)

BACKBONES = ["vit", "convvit", "swin", "vit_ecdp", "convvit_ecdp",
             "vit_mem", "swin_ecddp"]

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
    p = argparse.ArgumentParser("finetune_semseg")
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "dsec", "ddd17"])
    p.add_argument("--data_root", default=None,
                   help="the DSEC or DDD17 tree (the reference's layout)")
    p.add_argument("--num_classes", type=int, default=11)
    p.add_argument("--ignore_label", type=int, default=255)
    p.add_argument("--backbone", default="convvit", choices=BACKBONES)
    p.add_argument("--model_size", default="small", choices=["small", "base"])
    p.add_argument("--num_bins", type=int, default=5)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--fix_events_num", type=int, default=200_000)
    p.add_argument("--val_fix_events_num", type=int, default=200_000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--warmup_epochs", type=float, default=2)
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--use_layer_decay", action="store_true")
    # the reference semseg trainer never clips (finetune_semseg.py:104-109)
    p.add_argument("--clip_grad", type=float, default=None)
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
    p.add_argument("--output_dir", default="./results/finetune_semseg")
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
            raise SystemExit(f"finetune_semseg: --{name} is not ported yet; "
                             f"it comes with {slice_}")
    if args.dataset != "synthetic" and not args.data_root:
        raise SystemExit(f"finetune_semseg: --dataset {args.dataset} needs "
                         "--data_root")


def make_sources(args):
    """(train, val, sensor (h, w)) as finetune_semseg.py:180-209; the
    synthetic sources are JAX's smoke data: 5 classes, no ignore label."""
    if args.dataset == "synthetic":
        args.num_classes = 5
        args.ignore_label = None
        train = SyntheticDenseSource("semseg", n=32, num_classes=5,
                                     seed=args.seed)
        val = SyntheticDenseSource("semseg", n=8, num_classes=5,
                                   seed=args.seed + 100)
        return train, val, train.sensor_hw
    if args.dataset == "dsec":
        train = DsecSource(args.data_root, DsecSource.TRAIN_SEQUENCES,
                           args.fix_events_num)
        val = DsecSource(args.data_root, DsecSource.VAL_SEQUENCES,
                         args.val_fix_events_num)
        return train, val, (440, 640)
    train = Ddd17Source(args.data_root, ["dir0", "dir3", "dir4", "dir6",
                                         "dir7"], args.fix_events_num)
    # the reference windows DDD17's validation at the training fix + 10000
    # too, then keeps the last val_fix_events_num
    val = Ddd17Source(args.data_root, ["dir1"], args.val_fix_events_num,
                      window_events_num=args.fix_events_num + 10_000)
    return train, val, (200, 346)


def load_finetune(hub, path: str) -> None:
    """Initialise ``hub`` from a ``{"model": state_dict}`` checkpoint as
    ``init_variables_from(strict_backbone=True)`` does
    (``ckpt.bridge.init_from_state_dict``): a backbone parameter the file
    lacks raises ``KeyError``, a shape that differs raises, the heads and
    the BatchNorm statistics take what the file holds, and the file's
    tensors the hub lacks go unused; an ECDP checkpoint's query encoder
    stands for the backbone."""
    unused = init_from_state_dict(
        hub, finetune_state_dict(load_torch_checkpoint(path)))
    if unused:
        print(f"{path}: {len(unused)} tensors unused (e.g. {unused[:4]})")


def main(argv=None) -> dict:
    """Run the finetune; returns ``{"state", "best_miou", "miou",
    "macc"}`` (the train state, the best and the last epoch's mIoU and
    mAcc in percent)."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    train_src, val_src, sensor_hw = make_sources(args)
    cfg = DenseDataConfig(
        task="semseg", num_bins=args.num_bins, input_size=args.input_size,
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
        ("vit_mem", "small"): dense_hub_vit_mem_small,
        ("vit_mem", "base"): dense_hub_vit_mem_base,
        ("swin_ecddp", "small"): dense_hub_swin_ecddp_tiny,
        ("swin_ecddp", "base"): dense_hub_swin_ecddp_tiny,
    }[(args.backbone, args.model_size)]
    hub = factory(
        args.num_classes, args.num_bins, dtype=dtype, device=device,
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
    train_step = make_semseg_train_step(
        hub, num_classes=args.num_classes, ignore_index=args.ignore_label,
        w_decode=args.w_decode_loss, w_aux=args.w_auxiliary_loss,
        sample_mode=args.sample_mode,
        generator=torch.Generator(device).manual_seed(args.seed),
    )
    eval_step = make_semseg_eval_step(
        hub, num_classes=args.num_classes, ignore_label=args.ignore_label,
        sample_mode=args.sample_mode,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "checkpoint.pth")
    best_miou = miou = macc = 0.0
    for epoch in range(args.epochs):
        t0 = time.time()
        pipe = DensePipeline(train_src, cfg, args.batch_size, train=True,
                             seed=args.seed + epoch, device=device)
        state, train_metrics = train_one_epoch(
            train_step, state, pipe, epoch=epoch, print_freq=args.print_freq)
        val_pipe = DensePipeline(val_src, cfg, args.batch_size, train=False,
                                 seed=args.seed, device=device)
        tv = time.time()
        conf = 0
        n_val = 0
        for batch in val_pipe:
            conf = conf + eval_step(batch)
            n_val += 1
        miou = float(miou_from_confusion(conf))
        macc = float(macc_from_confusion(conf))
        # mean inference time per batch (ft_semseg_trainer.py:269)
        infer_ms = 1000 * (time.time() - tv) / max(n_val, 1)
        print(f"epoch {epoch}: mIoU {miou:.2f} mAcc {macc:.2f} "
              f"(inference {infer_ms:.1f} ms/batch)", flush=True)
        record = {"epoch": epoch, "miou": miou, "macc": macc,
                  "val_infer_ms": round(infer_ms, 2),
                  **{f"train_{k}": v for k, v in train_metrics.items()},
                  "epoch_time_s": round(time.time() - t0, 2)}
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(record) + "\n")
        sd = {k: v.detach().cpu() for k, v in hub.state_dict().items()}
        torch.save({"model": sd, "epoch": epoch}, path)
        best_miou = max(best_miou, miou)
    print(f"best mIoU: {best_miou:.2f}")
    return {"state": state, "best_miou": best_miou, "miou": miou,
            "macc": macc}


if __name__ == "__main__":
    main()
