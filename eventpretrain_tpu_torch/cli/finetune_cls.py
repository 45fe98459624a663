"""Classification finetune entry point: raw events to a trained classifier.

Counterpart of eventpretrain_tpu/cli/finetune_cls.py for ``--backbone
vit``, ``convvit``, ``swin`` (Swin-T whatever ``--model_size``, as in
JAX), ``vit_ecdp`` and ``convvit_ecdp`` (the head over the two learned
tokens), ``vit_mem`` and ``swin_ecddp`` (Swin-ECDDP-T whatever
``--model_size``) on every source of the JAX CLI: synthetic, N-Cars, N-Caltech101,
CIFAR10-DVS, DVS128 Gesture, N-ImageNet (with ``--val_variant_roots``,
each root evaluated on its own every epoch), ES-ImageNet (with
``--es_train_label``/``--es_val_label``) and UCF101-DVS
(``data/cls_sources.py``). ``--num_bins`` 2 is the count image, 3 the
MEM image (3 channels), others the voxel grid, all through K3. The
fixed-sensor sources rasterise at their sensor, or at ``--input_size``
where the coordinates are rescaled (N-ImageNet always, CIFAR10-DVS,
DVS128 and UCF101-DVS at 2 bins); N-Cars and the synthetic source infer
the sensor on the ``--canvas``. The CLI has the JAX CLI's flags and
defaults for the data, the optimizer (AdamW (0.9, 0.999), the global-norm
clip, layer decay) and the regularizers (drop-path 0.1, label smoothing
0.1). ``--device`` picks the card (default) or the CPU; on ``cuda`` the
hub computes in bf16 (``--bf16``, the default), which routes the blocks
that fuse through K1/K2 and, in training, the drop-path blocks' attention
through K4. ``--use_evrepsl`` rasterises the EvRep image instead
(``ClsDataConfig.use_evrep``) and runs the frozen EvRepSL network
(``models/evrepsl.py``, from ``--evrepsl_checkpoint`` or a random init)
before the hub, which then takes its 5 channels.

    python -m eventpretrain_tpu_torch.cli.finetune_cls --dataset synthetic \\
        --model_size small --epochs 2
    python -m eventpretrain_tpu_torch.cli.finetune_cls --dataset n_cars \\
        --train_root N-Cars/train --val_root N-Cars/test \\
        --finetune results/pretrain/checkpoint.pth
    python -m eventpretrain_tpu_torch.cli.finetune_cls --dataset n_imagenet \\
        --num_classes 1000 --train_root N-ImageNet/train \\
        --val_root N-ImageNet/val --val_variant_roots N-ImageNet/val_mode_1

``--finetune`` initialises the hub from a ``checkpoint.pth`` that
``cli/pretrain.py`` (or this CLI) wrote, as JAX's ``init_backbone_from``
does: every backbone parameter must be in the file, the file's tensors the
hub lacks (a rec checkpoint's decoders) go unused, and the rest of the hub
takes the file's tensors where it has them; an ECDP checkpoint's query
encoder fills the backbone (``ckpt.bridge.finetune_state_dict``). ``--accum_iter k`` averages
the gradients of k batches into each update (the base lr scales with
``batch_size * k``, the schedule counts updates). Each epoch appends a
JSON line to ``<output_dir>/log.txt`` and writes
``<output_dir>/checkpoint.pth`` as ``{"model": state_dict, "epoch":
...}``. Flags of the JAX CLI that the port does not have yet raise an
error naming the slice that brings them.
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
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.data import cls_sources as cs
from eventpretrain_tpu_torch.data.cls_pipeline import (
    ClsDataConfig,
    ClsPipeline,
    NCarsSource,
    SyntheticClsSource,
)
from eventpretrain_tpu_torch.data.representations import num_channels
from eventpretrain_tpu_torch.models.cls_hub import (
    cls_hub_convvit_base,
    cls_hub_convvit_ecdp_base,
    cls_hub_convvit_ecdp_small,
    cls_hub_convvit_small,
    cls_hub_swin_ecddp_tiny,
    cls_hub_swin_tiny,
    cls_hub_vit_base,
    cls_hub_vit_ecdp_base,
    cls_hub_vit_ecdp_small,
    cls_hub_vit_mem_base,
    cls_hub_vit_mem_small,
    cls_hub_vit_small,
)
from eventpretrain_tpu_torch.models.evrepsl import evrepsl_net
from eventpretrain_tpu_torch.train.loop import evaluate, train_one_epoch
from eventpretrain_tpu_torch.train.optim import (
    build_optimizer,
    cosine_warmup_schedule,
)
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_cls_eval_step,
    make_cls_train_step,
)

DATASETS = ["synthetic", "n_cars", "n_caltech101", "cifar10_dvs",
            "dvs128_gesture", "n_imagenet", "es_imagenet", "ucf101_dvs"]
BACKBONES = ["vit", "convvit", "swin", "vit_ecdp", "convvit_ecdp", "vit_mem",
             "swin_ecddp"]

# flags of the JAX CLI that the port does not have yet: (type, default,
# the slice that brings them); any other value is refused
_NOT_PORTED = {
    "resume": (str, None, "slice 6 (checkpoint resume)"),
    "auto_resume": (bool, False, "slice 6 (checkpoint resume)"),
    "visualize": (bool, False, "slice 6 (viz/panels.py, needs matplotlib)"),
    "export_torch": (str, None, "slice 6 (export artifacts)"),
    "export_serving": (str, None, "slice 6 (export artifacts)"),
    "serving_native": (bool, False, "slice 6 (export artifacts)"),
    "serving_batch_sizes": (str, "1,8,64", "slice 6 (export artifacts)"),
    "data_parallel": (bool, False, "slice 6 (torch.distributed)"),
    "profile_dir": (str, None, "slice 6 (utils/profiling.py)"),
    "tensorboard": (bool, False, "slice 6 (utils/logging.py)"),
    "use_checkpoint": (bool, False, "slice 6 (activation recompute)"),
    "feed_batches": (str, None, "slice 6 (batch replay)"),
    "forward_only": (bool, False, "slice 6 (forward-only steps)"),
    "lenient_import": (bool, False, "slice 6 (the torch import dialects)"),
}

# where each dataset rescales its coordinates to the input after the
# stream augment (finetune_cls.py:184-189; ClsDataConfig.rescale_to_input)
_RESCALE_MODE = {
    "n_imagenet": "always",
    "cifar10_dvs": "ecdp",
    "dvs128_gesture": "ecdp",
    "ucf101_dvs": "ecdp",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("finetune_cls")
    p.add_argument("--dataset", default="synthetic", choices=DATASETS)
    p.add_argument("--es_train_label", default=None)
    p.add_argument("--es_val_label", default=None)
    p.add_argument("--val_variant_roots", nargs="*", default=[],
                   help="N-ImageNet robustness val roots, each evaluated "
                        "on its own every epoch")
    p.add_argument("--train_root", default=None)
    p.add_argument("--val_root", default=None)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--backbone", default="vit", choices=BACKBONES)
    p.add_argument("--model_size", default="small", choices=["small", "base"])
    p.add_argument("--num_bins", type=int, default=5)
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--fix_events_num", type=int, default=30000)
    p.add_argument("--val_fix_events_num", type=int, default=30000)
    p.add_argument("--canvas", type=int, nargs=2, default=(128, 128),
                   metavar=("H", "W"))
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--accum_iter", type=int, default=1,
                   help="microsteps of --batch_size an update averages")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--warmup_epochs", type=float, default=5)
    p.add_argument("--blr", type=float, default=2.5e-4)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--use_layer_decay", action="store_true")
    p.add_argument("--clip_grad", type=float, default=5.0)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--drop_path_rate", type=float, default=0.1)
    p.add_argument("--drop_rate", type=float, default=0.0)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    p.add_argument("--resize_mode", default="bilinear",
                   choices=["nearest", "bilinear", "bicubic"])
    p.add_argument("--lr", type=float, default=None,
                   help="absolute lr; overrides --blr * batch / 256")
    p.add_argument("--linprob", action="store_true",
                   help="freeze all but the classify head")
    p.add_argument("--finetune", default=None,
                   help="checkpoint.pth of cli.pretrain (or of this CLI) "
                        "whose backbone initialises the hub, strictly")
    p.add_argument("--output_dir", default="./results/finetune_cls")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--num_workers", type=int, default=8,
                   help="IO threads per pipeline (0 = load on the pipeline "
                        "thread)")
    p.add_argument("--val_event_noise", action="store_true")
    p.add_argument("--use_evrepsl", action="store_true",
                   help="EvRep input and the frozen EvRepSL network before "
                        "the backbone, which then takes 5 channels")
    p.add_argument("--evrepsl_checkpoint", default=None,
                   help="the EvRepSL network's weights (a .pth of its "
                        "state dict under 'model'); random if absent")
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
            raise SystemExit(f"finetune_cls: --{name} is not ported yet; it "
                             f"comes with {slice_}")
    if args.accum_iter < 1:
        raise SystemExit(f"finetune_cls: --accum_iter must be at least 1, "
                         f"got {args.accum_iter}")


def make_sources(args):
    """``(train, val, variants, sensor_hw, rescale)`` as
    finetune_cls.py:192-231: the sources, N-ImageNet's variant sources by
    their root's name, the fixed sensor (None: inferred from the events)
    and the dataset's rescale mode. The synthetic sources have the N-Cars
    shape: a 100x120 sensor and as many events per sample as the window
    takes."""
    rescale = _RESCALE_MODE.get(args.dataset, "never")
    if args.dataset == "synthetic":
        return (SyntheticClsSource(args.num_classes, 64,
                                   num_events=args.fix_events_num,
                                   sensor_hw=(100, 120), seed=args.seed),
                SyntheticClsSource(args.num_classes, 16,
                                   num_events=args.val_fix_events_num,
                                   sensor_hw=(100, 120),
                                   seed=args.seed + 1000),
                {}, None, rescale)
    if not (args.train_root and args.val_root):
        raise SystemExit(f"finetune_cls: --train_root/--val_root required "
                         f"for {args.dataset}")
    if args.dataset == "n_cars":
        return (NCarsSource(args.train_root), NCarsSource(args.val_root),
                {}, None, rescale)
    if args.dataset == "es_imagenet":
        if not (args.es_train_label and args.es_val_label):
            raise SystemExit("finetune_cls: --es_train_label/--es_val_label "
                             "required for es_imagenet")
        train = cs.EsImageNetSource(args.train_root, args.es_train_label,
                                    args.num_classes)
        val = cs.EsImageNetSource(args.val_root, args.es_val_label,
                                  args.num_classes)
        return train, val, {}, train.sensor_hw, rescale
    make = {
        "n_caltech101": cs.NCaltech101Source,
        "cifar10_dvs": cs.Cifar10DvsSource,
        "dvs128_gesture": cs.Dvs128GestureSource,
        "ucf101_dvs": cs.Ucf101DvsSource,
        "n_imagenet": lambda root: cs.NImageNetSource(root,
                                                      args.num_classes),
    }[args.dataset]
    train, val = make(args.train_root), make(args.val_root)
    variants = {}
    if args.dataset == "n_imagenet":
        for root in args.val_variant_roots:
            variants[os.path.basename(root.rstrip("/"))] = make(root)
    return train, val, variants, train.sensor_hw, rescale


def data_config(args, sensor_hw, rescale: str) -> ClsDataConfig:
    """The pipeline's config (finetune_cls.py:257-288): the canvas is
    ``input_size`` squared under an active rescale, else the source's
    fixed sensor, else ``--canvas`` with the sensor inferred."""
    rescale_active = rescale == "always" or (
        rescale == "ecdp" and args.num_bins == 2)
    if sensor_hw is not None:
        canvas = ((args.input_size, args.input_size) if rescale_active
                  else tuple(sensor_hw))
    else:
        canvas = tuple(args.canvas)
    return ClsDataConfig(
        num_classes=args.num_classes, num_bins=args.num_bins,
        input_size=args.input_size, fix_events_num=args.fix_events_num,
        val_fix_events_num=args.val_fix_events_num,
        canvas_height=canvas[0], canvas_width=canvas[1],
        infer_sensor_size=sensor_hw is None,
        event_noise=args.val_event_noise, resize_mode=args.resize_mode,
        sensor_height=None if sensor_hw is None else sensor_hw[0],
        sensor_width=None if sensor_hw is None else sensor_hw[1],
        rescale_to_input=rescale, use_evrep=args.use_evrepsl,
    )


def load_backbone(hub, path: str) -> None:
    """Initialise ``hub`` from a ``{"model": state_dict}`` checkpoint as
    ``init_backbone_from(strict_backbone=True)`` does
    (``ckpt.bridge.init_from_state_dict``): a backbone parameter the file
    lacks raises ``KeyError``, a shape that differs raises, the file's
    keys the hub lacks go unused; an ECDP checkpoint's query encoder
    stands for the backbone."""
    unused = init_from_state_dict(
        hub, finetune_state_dict(load_torch_checkpoint(path)))
    if unused:
        print(f"{path}: {len(unused)} tensors unused (e.g. {unused[:4]})")


def build_repgen(args, dtype, device):
    """The frozen EvRepSL network in the compute dtype
    (finetune_cls.py:306-325): ``--evrepsl_checkpoint``'s weights through a
    strict ``load_state_dict`` (the key space JAX's exporter writes), else
    a random init from seed 7 and JAX's warning. Its parameters require
    no gradient, and it is not part of the hub or its checkpoint."""
    rep = evrepsl_net(dtype=dtype, device=device,
                      generator=torch.Generator().manual_seed(7))
    if args.evrepsl_checkpoint:
        load_jax_state_dict(rep, load_torch_checkpoint(
            args.evrepsl_checkpoint))
    else:
        print("[warn] --use_evrepsl without --evrepsl_checkpoint: "
              "random RepGen weights")
    return rep.eval().requires_grad_(False)


def main(argv=None) -> dict:
    """Run the finetune; returns ``{"state", "best_acc1", "val",
    "variants"}`` (the train state, the best and the last epoch's
    validation metrics, and the last epoch's metrics of each variant)."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    train_src, val_src, variants, sensor_hw, rescale = make_sources(args)
    cfg = data_config(args, sensor_hw, rescale)
    factory = {
        ("vit", "small"): cls_hub_vit_small,
        ("vit", "base"): cls_hub_vit_base,
        ("convvit", "small"): cls_hub_convvit_small,
        ("convvit", "base"): cls_hub_convvit_base,
        ("swin", "small"): cls_hub_swin_tiny,
        ("swin", "base"): cls_hub_swin_tiny,
        ("vit_ecdp", "small"): cls_hub_vit_ecdp_small,
        ("vit_ecdp", "base"): cls_hub_vit_ecdp_base,
        ("convvit_ecdp", "small"): cls_hub_convvit_ecdp_small,
        ("convvit_ecdp", "base"): cls_hub_convvit_ecdp_base,
        ("vit_mem", "small"): cls_hub_vit_mem_small,
        ("vit_mem", "base"): cls_hub_vit_mem_base,
        ("swin_ecddp", "small"): cls_hub_swin_ecddp_tiny,
        ("swin_ecddp", "base"): cls_hub_swin_ecddp_tiny,
    }[(args.backbone, args.model_size)]
    in_chans = num_channels(args.num_bins)
    repgen = None
    if args.use_evrepsl:
        repgen = build_repgen(args, dtype, device)
        in_chans = 5  # concat(EvRep, clean_ie, C)
    hub = factory(
        args.num_classes, in_chans, dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(args.seed),
        input_size=args.input_size, drop_path_rate=args.drop_path_rate,
        drop_rate=args.drop_rate, attn_drop_rate=args.attn_drop_rate,
    )
    if args.finetune:
        load_backbone(hub, args.finetune)
        print(f"backbone loaded from {args.finetune}")
    if args.linprob:
        for name, p in hub.named_parameters():
            p.requires_grad_(name.startswith("classify_head."))
    n_params = sum(p.numel() for p in hub.parameters())
    print(f"model params: {n_params / 1e6:.2f}M ({dtype} compute, "
          f"f32 parameters, {device})")

    steps_per_epoch = max(len(train_src) // args.batch_size, 1)
    eff_batch = args.batch_size * args.accum_iter
    lr = args.lr if args.lr is not None else args.blr * eff_batch / 256
    # the schedule counts updates (finetune_cls.py:361-370)
    schedule = cosine_warmup_schedule(
        lr, args.min_lr, args.warmup_epochs, args.epochs,
        max(steps_per_epoch // args.accum_iter, 1))
    optimizer = build_optimizer(
        hub, weight_decay=args.weight_decay, betas=(0.9, 0.999),
        layer_decay=args.layer_decay if args.use_layer_decay else 1.0,
        num_layers=13 if args.backbone.startswith("convvit") else 12,
        backbone_type=args.backbone, accum_steps=args.accum_iter,
    )
    state = TrainState(hub, optimizer, schedule, clip_grad=args.clip_grad)
    train_step = make_cls_train_step(
        hub, smoothing=args.smoothing,
        generator=torch.Generator(device).manual_seed(args.seed),
        preprocess_fn=repgen,
    )
    eval_step = make_cls_eval_step(hub, preprocess_fn=repgen)

    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "checkpoint.pth")
    best_acc, val_metrics, variant_metrics = 0.0, {}, {}
    for epoch in range(args.epochs):
        t0 = time.time()
        pipe = ClsPipeline(train_src, cfg, args.batch_size, train=True,
                           seed=args.seed + epoch,
                           num_workers=args.num_workers, device=device)
        state, train_metrics = train_one_epoch(
            train_step, state, pipe, epoch=epoch, print_freq=args.print_freq)
        val_pipe = ClsPipeline(val_src, cfg, args.batch_size, train=False,
                               seed=args.seed, num_workers=args.num_workers,
                               device=device)
        tv = time.time()
        val_metrics = evaluate(eval_step, val_pipe)
        # mean inference time per batch (ft_cls_trainer.py:190)
        val_metrics["infer_ms"] = round(
            1000 * (time.time() - tv) / max(len(val_pipe), 1), 2)
        for name, src in variants.items():
            vm = evaluate(eval_step, ClsPipeline(
                src, cfg, args.batch_size, train=False, seed=args.seed,
                num_workers=args.num_workers, device=device),
                header=f"Val[{name}]:")
            print(f"  variant {name}: acc1 {vm.get('acc1', 0):.2f}",
                  flush=True)
            variant_metrics[name] = vm
        record = {"epoch": epoch,
                  **{f"train_{k}": v for k, v in train_metrics.items()},
                  **{f"val_{k}": v for k, v in val_metrics.items()},
                  "epoch_time_s": round(time.time() - t0, 2)}
        print(json.dumps(record), flush=True)
        with open(os.path.join(args.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(record) + "\n")
        sd = {k: v.detach().cpu() for k, v in hub.state_dict().items()}
        torch.save({"model": sd, "epoch": epoch}, path)
        best_acc = max(best_acc, val_metrics.get("acc1", 0.0))
    print(f"best val acc1: {best_acc:.2f}")
    return {"state": state, "best_acc1": best_acc, "val": val_metrics,
            "variants": variant_metrics}


if __name__ == "__main__":
    main()
