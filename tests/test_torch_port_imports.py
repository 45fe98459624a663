"""The port imports torch and never jax: the machine with the card has no
jax, and the port must not lean on the JAX package. It has no PIL and no
h5py either, so every port module imports without them too (the readers
that need them import them when they open a file)."""

import ast
import pathlib
import pkgutil
import subprocess
import sys

import pytest

from tests._port_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "eventpretrain_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "eventpretrain_tpu")


def _port_modules():
    names = ["eventpretrain_tpu_torch"]
    for info in pkgutil.walk_packages([str(PKG)], "eventpretrain_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert "eventpretrain_tpu_torch.cli.serve" in mods
    assert {"eventpretrain_tpu_torch.models.swin",
            "eventpretrain_tpu_torch.models.swin_plan",
            "eventpretrain_tpu_torch.models.vit_mem",
            "eventpretrain_tpu_torch.models.swin_ecddp",
            "eventpretrain_tpu_torch.models.evrepsl"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'eventpretrain_tpu', 'PIL',\n"
        "             'h5py'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                     'eventpretrain_tpu', 'PIL',\n"
        "                                     'h5py'))\n"
        "assert not bad, bad\n"
        "print('OK', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_names_jax(path):
    """No import statement of a port module (or of chip_smoke.py) names jax,
    its ecosystem or the JAX package."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_kernel_sources_ship_with_the_package():
    from eventpretrain_tpu_torch import _build

    for name in _build.SIGNATURES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert _build.BUILD_DIR == ROOT / "build" / "torch_kernels"


@pytest.mark.parametrize("module", [
    "data.codec", "data.event_transforms", "data.cls_pipeline",
    "objectives.cls", "eval.metrics", "cli.finetune_cls",
])
def test_finetune_slice_modules_are_covered(module):
    """The cls-finetune slice's modules are among those the import check
    above loads with jax blocked."""
    assert f"eventpretrain_tpu_torch.{module}" in _port_modules()


@pytest.mark.parametrize("module", [
    "native", "ops.splat_tiled", "data.dense_pipeline", "models.dense_heads",
    "models.dense_hub", "objectives.semseg", "cli.finetune_semseg",
])
def test_dense_slice_modules_are_covered(module):
    """The dense slice's modules are among those the import check above
    loads with jax blocked."""
    assert f"eventpretrain_tpu_torch.{module}" in _port_modules()


@pytest.mark.parametrize("module", [
    "data.prefetch", "ops.fused_mha", "ops.splat", "train.loop",
])
def test_k7_k8_slice_modules_are_covered(module):
    """Slice 3c's modules (the prefetcher, K7, K8 beside K3, the loops that
    prefetch) are among those the import check above loads with jax
    blocked."""
    assert f"eventpretrain_tpu_torch.{module}" in _port_modules()


@pytest.mark.parametrize("module", [
    "native", "data.io_pool", "data.mvsec", "objectives.flow",
    "cli.finetune_flow",
])
def test_host_half_and_flow_slice_modules_are_covered(module):
    """Slice 3b's modules (the C++ host code's bindings, the load pool, the
    MVSEC reader, the flow objective and CLI) are among those the import
    check above loads with jax blocked."""
    assert f"eventpretrain_tpu_torch.{module}" in _port_modules()


@pytest.mark.parametrize("module", [
    "objectives.contrastive", "models.layers", "models.pretrain_hub",
    "train.state", "train.steps", "data.pretrain_pipeline", "cli.pretrain",
    "ckpt.bridge",
])
def test_contrastive_slice_modules_are_covered(module):
    """Slice 4a's modules (the InfoNCE losses and the queue, the projector
    BatchNorm and heads, the contrastive steps, the CLIP embeddings' data
    path and the stage CLI) are among those the import check above loads
    with jax blocked."""
    assert f"eventpretrain_tpu_torch.{module}" in _port_modules()


@pytest.mark.parametrize("module", [
    "models.clip", "data.pretrain_pipeline", "cli.pretrain", "ckpt.bridge",
])
def test_clip_in_the_loop_modules_are_covered(module):
    """Slice 4b-ii's modules (the CLIP tower, the raw N-ImageNet pipeline
    and the in-loop encoding, the adj-n/con-n CLI, the CLIP weight bridge)
    are among those the import check above loads with jax, PIL and h5py
    blocked."""
    assert f"eventpretrain_tpu_torch.{module}" in _port_modules()


def test_host_code_source_ships_with_the_package():
    from eventpretrain_tpu_torch import native

    assert native.SOURCE == PKG / "native" / "event_pack.cpp"
    assert native.SOURCE.is_file()
    assert native.BUILD_DIR == ROOT / "build" / "host_native"


@pytest.mark.parametrize("module", [
    "models.convvit", "models.pretrain_hub", "models.cls_hub",
    "models.dense_hub", "train.optim", "train.state", "cli.finetune_flow",
])
def test_convvit_and_accumulation_modules_are_covered(module):
    """Slice 5a's modules (the ConvViT backbone and its hubs) and slice
    4b-i's (gradient accumulation in the optimizer and the train state)
    are among those the import check above loads with jax blocked."""
    assert f"eventpretrain_tpu_torch.{module}" in _port_modules()
