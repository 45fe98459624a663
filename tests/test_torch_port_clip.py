"""CLIP in the loop (stages 2 and 3 on raw N-ImageNet events, ``adj-n`` and
``con-n``) against the JAX package on the CPU.

The same inputs go through the JAX function and its port: the CLIP tower
(flax-initialised and carried across by ``clip_state_dict_from_flax``, and
loaded by both packages from one OpenAI-layout state dict),
``preprocess_images``, the raw pipeline (both on their C++ host code:
JAX's library built here from JAX's source, the port's from its copy),
``NImageNetPairedSource`` on a fixture tree, ``ClipEncodingPipeline``,
one stage-2 and one stage-3 step of the tiny hub of ``tests/_con_port.py``
each fed from its own package's in-loop pipeline, and the port's CLI
(``adj-n``, then ``con-n`` from its checkpoint; ``--clip_weights``) with
a tiny tower in place of ViT-B/16. f32 on both sides; every JAX half runs
under ``jax.jit``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu import native as jnative
from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.data import pretrain_pipeline as jpipe
from eventpretrain_tpu.models import clip as jclip
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import make_con_step as j_make_con_step
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.ckpt.bridge import (
    clip_state_dict_from_flax,
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.cli import pretrain as cli
from eventpretrain_tpu_torch.data import pretrain_pipeline as tpipe
from eventpretrain_tpu_torch.models import clip as tclip
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import make_con_step

from tests._con_port import (
    CLI_COMMON,
    CLIP_DIM,
    CLIP_TOKENS,
    STEP_REL,
    hold_params,
    jax_hub,
    jax_variables,
    port_hub,
    rel_err,
    tiny_cli_hub,
)
from tests._port_threads import one_torch_thread  # noqa: F401

# the tiny tower of tests/test_clip.py: width 32, 2 layers of 2 heads,
# patch 16, output 16
TINY = dict(patch_size=16, width=32, layers=2, heads=2, output_dim=16)
# f32 on both sides, products and LayerNorms summed in other orders (the
# JAX package's own CLIP test holds its torch twin at the same tolerance)
CLIP_RTOL, CLIP_ATOL = 2e-4, 2e-5
# the raw pipeline's grids and the in-loop embeddings
EVG_ATOL = 1e-5
EMB_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    """JAX's C++ library, built in this process's own directory when no
    other test of the process built it (JAX names its temporary file alike
    in every process, so parallel workers' builds may race)."""
    if jnative._LIB is None:
        old = os.environ.get("XDG_CACHE_HOME")
        os.environ["XDG_CACHE_HOME"] = str(tmp_path_factory.mktemp("jnat"))
        try:
            jnative._get_lib()
        finally:
            if old is None:
                del os.environ["XDG_CACHE_HOME"]
            else:
                os.environ["XDG_CACHE_HOME"] = old
    assert jnative.BACKEND == "native" and tnative.BACKEND == "native"


def _jax_tower(image_size, **kw):
    return jclip.CLIPVisionTransformer(image_size=image_size,
                                       **{**TINY, **kw})


def _port_tower(image_size, **kw):
    return tclip.CLIPVisionTransformer(image_size=image_size,
                                       **{**TINY, **kw}, device="cpu")


def _flax_params(model, image_size, seed):
    """The tower's flax init with every leaf redrawn from numpy (so the
    LayerNorms and biases are not at their trivial inits)."""
    params = jax.jit(model.init)(
        jax.random.key(0), jnp.zeros((1, image_size, image_size, 3))
    )["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        base = 1.0 if name == "scale" else 0.0
        return jnp.asarray(base + 0.05 * rng.normal(size=leaf.shape),
                           jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _openai_state_dict(image_size, seed, width=32, layers=2, patch=16,
                       out_dim=16):
    """An OpenAI-layout ``visual.*`` state dict (and one text key, which
    the loaders drop), as tests/test_clip.py writes it."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=0.05):
        return torch.randn(shape, generator=g) * s

    grid = image_size // patch
    sd = {"visual.conv1.weight": r(width, 3, patch, patch),
          "visual.class_embedding": r(width),
          "visual.positional_embedding": r(grid * grid + 1, width),
          "visual.proj": r(width, out_dim),
          "visual.ln_pre.weight": 1 + r(width),
          "visual.ln_pre.bias": r(width),
          "visual.ln_post.weight": 1 + r(width),
          "visual.ln_post.bias": r(width),
          "token_embedding.weight": r(8, width)}
    for i in range(layers):
        pre = f"visual.transformer.resblocks.{i}"
        sd.update({
            f"{pre}.ln_1.weight": 1 + r(width), f"{pre}.ln_1.bias": r(width),
            f"{pre}.ln_2.weight": 1 + r(width), f"{pre}.ln_2.bias": r(width),
            f"{pre}.attn.in_proj_weight": r(3 * width, width),
            f"{pre}.attn.in_proj_bias": r(3 * width, s=0.01),
            f"{pre}.attn.out_proj.weight": r(width, width),
            f"{pre}.attn.out_proj.bias": r(width, s=0.01),
            f"{pre}.mlp.c_fc.weight": r(4 * width, width),
            f"{pre}.mlp.c_fc.bias": r(4 * width, s=0.01),
            f"{pre}.mlp.c_proj.weight": r(width, 4 * width),
            f"{pre}.mlp.c_proj.bias": r(width, s=0.01)})
    return sd


# ------------------------------------------------------------------ CLIP


@pytest.mark.parametrize("weights", ["flax_init", "openai_file"])
def test_clip_tower_matches_jax(tmp_path, weights):
    """The tiny tower's (B, 1 + L, 16) tokens at rtol 2e-4, atol 2e-5: a
    flax-initialised tower carried across by the bridge, and one OpenAI
    file read by both loaders (JAX's ``load_clip_visual_weights`` and the
    port's prefix strip and strict load)."""
    img = 32
    jm = _jax_tower(img)
    tm = _port_tower(img)
    if weights == "flax_init":
        params = _flax_params(jm, img, 1)
        sd = clip_state_dict_from_flax(params)
        assert set(sd) == set(tm.state_dict())
        tm.load_state_dict(sd, strict=True)
    else:
        path = str(tmp_path / "clip.pt")
        torch.save(_openai_state_dict(img, 2), path)
        params = jclip.load_clip_visual_weights(
            path, jax.jit(jm.init)(jax.random.key(0),
                                   jnp.zeros((1, img, img, 3)))["params"])
        tclip.load_clip_visual_weights(path, tm)
    x = np.random.default_rng(3).normal(size=(2, img, img, 3)).astype(
        np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, (img // 16) ** 2 + 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=CLIP_RTOL, atol=CLIP_ATOL)


def test_clip_vit_b16_layout_and_loader_refusals(tmp_path):
    """``clip_vit_b16``'s key space is OpenAI's visual tower without its
    prefix (built on the meta device: no full-width tower on the CPU); a
    file missing a key fails the strict load."""
    tower = tclip.clip_vit_b16(device="meta")
    sd = tower.state_dict()
    assert sd["conv1.weight"].shape == (768, 3, 16, 16)
    assert sd["positional_embedding"].shape == (197, 768)
    assert sd["proj"].shape == (768, 512)
    assert sd["transformer.resblocks.11.attn.in_proj_weight"].shape == (
        2304, 768)
    assert "transformer.resblocks.12.ln_1.weight" not in sd
    assert all(p.dtype == torch.float32 for p in tower.parameters())
    assert tower.compute_dtype == torch.float32
    full = _openai_state_dict(32, 4)
    del full["visual.proj"]
    path = str(tmp_path / "clip.pt")
    torch.save(full, path)
    with pytest.raises(RuntimeError, match="proj"):
        tclip.load_clip_visual_weights(path, _port_tower(32))
    x = torch.tensor([-1.0, 0.0, 2.0])
    np.testing.assert_allclose(tclip.quick_gelu(x).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(
                                   x.numpy()))), rtol=1e-6)


@pytest.mark.parametrize("hw,dtype", [(64, "uint8"), (64, "float32"),
                                      (224, "uint8"), (224, "float32")])
def test_preprocess_images_matches_jax(hw, dtype):
    """The bicubic resize to 224 (none at 224) and the normalisation,
    within 1e-5 of the scale (uint8 images are not divided by 255 here,
    as in JAX: the in-loop encode divides them first)."""
    rng = np.random.default_rng(5)
    if dtype == "uint8":
        x = rng.integers(0, 256, (2, hw, hw, 3), dtype=np.uint8)
    else:
        x = rng.uniform(size=(2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jclip.preprocess_images)(jnp.asarray(x)))
    got = tclip.preprocess_images(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 224, 224, 3) and got.dtype == np.float32
    assert rel_err(got, want) <= 1e-5


# ---------------------------------------------------------- raw pipeline


def _raw_pipes(train, input_size=64, n=8, hw=(96, 96), seed=0):
    kw = dict(n=n, hw=hw, num_events=2048, seed=7)
    cfg = dict(num_bins=5, input_size=input_size, fix_events_num=1024)
    jp = jpipe.RawPretrainPipeline(
        jpipe.SyntheticRawPretrainSource(**kw),
        jpipe.RawPretrainDataConfig(**cfg, canvas_height=hw[0],
                                    canvas_width=hw[1]),
        4, train=train, seed=seed, num_workers=2)
    tp = tpipe.RawPretrainPipeline(
        tpipe.SyntheticRawPretrainSource(**kw),
        tpipe.RawPretrainDataConfig(**cfg), 4, train=train, seed=seed,
        num_workers=2, device="cpu")
    return jp, tp


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_raw_pipeline_matches_jax(train):
    """Two batches of the synthetic raw source (a 96x96 sensor, windows of
    1024 of 2048 events rescaled to 64, the C++ augment in training, the
    u32 codec, K3's plain version): ``evg`` within 1e-5 of JAX's, the
    images equal; the source's arrays byte for byte."""
    jp, tp = _raw_pipes(train)
    for i in (0, 7):
        want, got = jp.source.load(i), tp.source.load(i)
        assert got["hw"] == want["hw"]
        for k in ("events", "image"):
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    assert len(tp) == len(jp) == 2
    n = 0
    for want, got in zip(jp, tp):
        assert set(got) == set(want) == {"evg", "image"}
        assert got["evg"].shape == (4, 64, 64, 5)
        assert got["image"].dtype == torch.uint8
        np.testing.assert_array_equal(got["image"].numpy(),
                                      np.asarray(want["image"]))
        np.testing.assert_allclose(got["evg"].numpy(),
                                   np.asarray(want["evg"]), atol=EVG_ATOL)
        assert np.abs(got["evg"].numpy()).max() > 0
        n += 1
    assert n == 2 and tp.batches == 2 and tp.host_seconds > 0


def test_rescale_packed_coords_matches_jax():
    """The in-place f32 rescale from each sample's sensor to the input
    size, bit for bit."""
    rng = np.random.default_rng(9)
    packed = (rng.uniform(0, 640, (3, 50, 4))).astype(np.float32)
    hws = [(480, 640), (96, 96), (260, 346)]
    want = packed.copy()
    jpipe._rescale_packed_coords(want, hws, 224)
    tpipe._rescale_packed_coords(packed, hws, 224)
    assert packed.tobytes() == want.tobytes()


def _n_imagenet_tree(root, rng):
    """Two classes of two raw N-ImageNet streams (structured ``event_data``
    .npz) with their JPEGs of other sizes, and a precomputed CLIP tree."""
    nroot, iroot, croot = root / "n_imagenet", root / "imagenet", root / "emb"
    for cls in ("n01", "n02"):
        (nroot / cls).mkdir(parents=True)
        (iroot / cls).mkdir(parents=True)
        for i in range(2):
            name = f"{cls}_{i}"
            n = 40 + 7 * i
            ev = np.zeros(n, dtype=[("x", "<u2"), ("y", "<u2"),
                                    ("t", "<i8"), ("p", "i1")])
            ev["x"] = rng.integers(0, 640, n)
            ev["y"] = rng.integers(0, 480, n)
            ev["t"] = np.sort(rng.integers(0, 50000, n))
            ev["p"] = rng.choice([-1, 1], n)
            np.savez(nroot / cls / f"{name}.npz", event_data=ev)
            from PIL import Image

            Image.fromarray(rng.integers(
                0, 256, (260 + 40 * i, 300, 3), dtype=np.uint8)).save(
                    iroot / cls / f"{name}.JPEG")
            (croot / cls / name).mkdir(parents=True)
            torch.save(torch.from_numpy(rng.normal(
                size=(1, CLIP_TOKENS, CLIP_DIM)).astype(np.float32)),
                croot / cls / name / f"{name}_clip_emb.pt")
    return str(nroot), str(iroot), str(croot)


@pytest.mark.parametrize("paired", ["images", "clip_emb"])
def test_n_imagenet_paired_source_matches_jax(tmp_path, paired):
    """The raw streams (t in seconds) and either the centre-cropped 224
    JPEGs or the precomputed embeddings, equal to JAX's; the class limit;
    exactly one of the two roots."""
    nroot, iroot, croot = _n_imagenet_tree(tmp_path, np.random.default_rng(6))
    kw = (dict(imagenet_root=iroot) if paired == "images"
          else dict(clip_emb_root=croot))
    js = jpipe.NImageNetPairedSource(nroot, **kw)
    ts = tpipe.NImageNetPairedSource(nroot, **kw)
    assert ts.files == js.files and len(ts) == 4
    assert len(tpipe.NImageNetPairedSource(nroot, num_classes=1,
                                           **kw)) == 2
    for i in range(4):
        want, got = js.load(i), ts.load(i)
        assert set(got) == set(want)
        assert got["hw"] == want["hw"] == (480, 640)
        for k in want:
            if k != "hw":
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    key = "image" if paired == "images" else "clip_emb"
    assert got[key].shape == ((224, 224, 3) if paired == "images"
                              else (CLIP_TOKENS, CLIP_DIM))
    with pytest.raises(ValueError, match="exactly one"):
        tpipe.NImageNetPairedSource(nroot)


@pytest.mark.parametrize("cls_only", [False, True], ids=["tokens", "cls"])
def test_clip_encoding_pipeline_matches_jax(cls_only):
    """The tiny tower at 224 (197 tokens) in the loop of both packages'
    raw pipelines: ``clip_emb`` within 1e-4 of JAX's (the class token's
    alone with ``cls_only``), the image gone, the grid as the inner
    pipeline's."""
    jm, tm = _jax_tower(224), _port_tower(224)
    params = _flax_params(jm, 224, 8)
    tm.load_state_dict(clip_state_dict_from_flax(params), strict=True)
    jp, tp = _raw_pipes(True, n=4)
    jw = jpipe.ClipEncodingPipeline(jp, jm, params, cls_only=cls_only)
    tw = tpipe.ClipEncodingPipeline(tp, tm, cls_only=cls_only)
    assert len(tw) == len(jw) == 1
    for want, got in zip(jw, tw):
        assert set(got) == set(want) == {"evg", "clip_emb"}
        assert got["clip_emb"].shape == ((4, 16) if cls_only
                                         else (4, 197, 16))
        assert not got["clip_emb"].requires_grad
        np.testing.assert_allclose(got["clip_emb"].numpy(),
                                   np.asarray(want["clip_emb"]),
                                   atol=EMB_ATOL)
        np.testing.assert_allclose(got["evg"].numpy(),
                                   np.asarray(want["evg"]), atol=EVG_ATOL)


def test_clip_encoding_runs_without_gradients_in_a_producer_thread():
    """Grad mode is a thread's own: the encode runs under ``no_grad``
    inside the wrapper, in whichever thread iterates it (here the
    prefetcher's producer), leaves the consumer's grad mode alone, and a
    producer's error reaches the consumer."""
    from eventpretrain_tpu_torch.data.prefetch import Prefetcher

    tm = _port_tower(224)
    tm.requires_grad_(True)
    _, tp = _raw_pipes(True, n=8)
    seen = []
    for batch in Prefetcher(tpipe.ClipEncodingPipeline(tp, tm)):
        seen.append(torch.is_grad_enabled())
        assert not batch["clip_emb"].requires_grad
        assert batch["clip_emb"].grad_fn is None
    assert seen == [True, True]

    class Broken:
        def __len__(self):
            return 1

        def __iter__(self):
            yield {"evg": torch.zeros(1), "image": torch.zeros(
                (1, 7, 7, 2), dtype=torch.uint8)}

    with pytest.raises(RuntimeError):
        list(Prefetcher(tpipe.ClipEncodingPipeline(Broken(), tm)))


# ----------------------------------------------------- the slice as a whole


def _slice_tower(image_size=224):
    """A tower whose token count is the tiny hub's patches + 1: patch 56
    at 224 (4x4 + 1 tokens), CLIP_DIM wide output."""
    return dict(image_size=image_size, patch_size=56, width=32, layers=2,
                heads=2, output_dim=CLIP_DIM)


@pytest.mark.parametrize("phase", ["adj", "con"])
def test_in_loop_step_matches_jax(phase):
    """One stage-2 (trunk frozen but its norm_layer) or stage-3 step of the
    tiny hub, each fed from its own package's in-loop pipeline (the raw
    pipeline at the hub's 32x32 input, the tower's 17 tokens): the fed
    embeddings, the loss and grad norm at 1e-4, then every parameter at
    1e-4 of its scale; stage 2 leaves every frozen parameter and the tower
    as they were, bit for bit."""
    jm = jclip.CLIPVisionTransformer(**_slice_tower())
    tm = tclip.CLIPVisionTransformer(**_slice_tower(), device="cpu")
    cparams = _flax_params(jm, 224, 12)
    tm.load_state_dict(clip_state_dict_from_flax(cparams), strict=True)
    tower0 = {k: v.clone() for k, v in tm.state_dict().items()}
    jp, tp = _raw_pipes(True, input_size=32, n=4, seed=3)
    jbatch = next(iter(jpipe.ClipEncodingPipeline(jp, jm, cparams)))
    tbatch = next(iter(tpipe.ClipEncodingPipeline(tp, tm)))
    assert tbatch["clip_emb"].shape == (4, CLIP_TOKENS, CLIP_DIM)
    for k in ("evg", "clip_emb"):
        np.testing.assert_allclose(tbatch[k].numpy(), np.asarray(jbatch[k]),
                                   atol=EMB_ATOL, err_msg=k)

    params, stats = jax_variables(with_decoder=False)
    jhub = jax_hub(with_decoder=False)
    mask = joptim.frozen_except_norm_mask(params) if phase == "adj" else None
    # no warmup: the one update moves the weights
    tx = joptim.build_optimizer(
        params, learning_rate=joptim.cosine_warmup_schedule(1e-3, 1e-5, 0, 3,
                                                            2),
        weight_decay=0.05, trainable_mask=mask)
    jstate = JTrainState.create(
        apply_fn=jhub.apply, params=jax.tree.map(jnp.copy, params),
        batch_stats=jax.tree.map(jnp.copy, stats), tx=tx)
    jstate, jm_ = j_make_con_step(jhub, trainable_mask=mask)(
        jstate, jbatch, jax.random.key(0))

    hub = load_jax_state_dict(port_hub(with_decoder=False),
                              export_torch_state_dict(params, stats))
    frozen_init = {}
    if phase == "adj":
        trainable = toptim.freeze_except_norm(hub)
        frozen_init = {n: p.detach().numpy().copy()
                       for n, p in hub.named_parameters()
                       if not trainable[n]}
    schedule = toptim.cosine_warmup_schedule(1e-3, 1e-5, 0, 3, 2)
    state = TrainState(hub, toptim.build_optimizer(hub, weight_decay=0.05),
                       schedule)
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not held & {id(p) for p in tm.parameters()}
    m = make_con_step(hub)(state, tbatch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm_[k]),
                                   rtol=STEP_REL, err_msg=k)
    want = export_torch_state_dict(jstate.params, jstate.batch_stats)
    hold_params(hub, want, schedule(0), frozen_init)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, tower0[k]), k


# ------------------------------------------------------------------ CLI


_TOWERS = []


def _tiny_cli_tower(*, dtype, device, generator):
    """The CLI's CLIP factory at tiny widths: 197 tokens of CLIP's 512."""
    tower = tclip.CLIPVisionTransformer(
        image_size=224, patch_size=16, width=32, layers=2, heads=2,
        output_dim=512, dtype=dtype, device=device, generator=generator)
    _TOWERS.append(tower)
    return tower


@pytest.fixture
def tiny_cli(monkeypatch):
    monkeypatch.setattr(cli, "pretrain_hub_small", tiny_cli_hub)
    monkeypatch.setattr(cli, "clip_vit_b16", _tiny_cli_tower)
    _TOWERS.clear()
    return _TOWERS


def test_cli_chains_adj_n_and_con_n_through_init_from(tmp_path, tiny_cli,
                                                      capsys):
    """``adj-n`` on the synthetic raw source (32 samples, 4 steps of 8),
    then ``con-n`` from its checkpoint: each trains through the in-loop
    pipeline; stage 2 leaves the trunk at its seed-0 init bit for bit and
    moves its norm_layer; neither checkpoint holds a CLIP tensor, and the
    random tower (with its warning) is left as it was built."""
    runs = {}
    for name, phase, extra in (("adj", "adj-n", []),
                               ("con", "con-n", ["--init_from", "adj"])):
        extra = [str(tmp_path / a / "checkpoint.pth") if a in runs else a
                 for a in extra]
        state = cli.main(["--pr_phase", phase, "--output_dir",
                          str(tmp_path / name)] + CLI_COMMON + extra)
        assert state.step == 4, name
        tower = tiny_cli[-1]
        assert all(not p.requires_grad for p in tower.parameters())
        fresh = _tiny_cli_tower(dtype=torch.float32, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        for k, v in tower.state_dict().items():
            assert torch.equal(v, fresh.state_dict()[k]), k
        held = {id(p) for g in state.optimizer.param_groups
                for p in g["params"]}
        assert held == {id(p) for p in state.module.parameters()
                        if p.requires_grad}
        runs[name] = load_torch_checkpoint(
            str(tmp_path / name / "checkpoint.pth"))
    assert "--clip_weights not given" in capsys.readouterr().out
    adj, con = runs["adj"], runs["con"]
    init = tiny_cli_hub(with_decoder=False, with_heads=True,
                         dtype=torch.float32, device="cpu",
                         generator=torch.Generator().manual_seed(0),
                         input_size=224).state_dict()
    assert set(adj) == set(init) == set(con)
    for k, v in adj.items():
        if k.startswith("backbone.") and "norm_layer" not in k:
            assert torch.equal(v, init[k]), k
    assert not torch.equal(adj["backbone.norm_layer.weight"],
                           init["backbone.norm_layer.weight"])
    moved = [k for k in adj if k.startswith("backbone.vit_block")
             and not torch.equal(adj[k], con[k])]
    assert moved  # stage 3 trains the trunk


def test_cli_loads_clip_weights_from_an_openai_file(tmp_path, tiny_cli):
    """``--clip_weights``: the tower holds the file's visual tensors (its
    text keys dropped); the file's tower encodes the epoch's images."""
    sd = _openai_state_dict(224, 13, out_dim=512)
    path = str(tmp_path / "ViT-B-16.pt")
    torch.save(sd, path)
    state = cli.main(["--pr_phase", "adj-n", "--output_dir",
                      str(tmp_path / "a"), "--clip_weights", path]
                     + CLI_COMMON + ["--epochs", "0"])
    assert state.step == 0
    got = tiny_cli[-1].state_dict()
    assert set(got) == {k[len("visual."):] for k in sd
                        if k.startswith("visual.")}
    for k, v in got.items():
        assert torch.equal(v, sd["visual." + k]), k


@pytest.mark.parametrize("argv", [
    ["--pr_phase", "adj-n", "--dataset", "n_imagenet"],
    ["--pr_phase", "con-n", "--dataset", "n_imagenet", "--n_imagenet_root",
     "x"],
], ids=["no_roots", "no_imagenet_root"])
def test_cli_n_imagenet_needs_both_roots(tmp_path, tiny_cli, argv):
    with pytest.raises(SystemExit, match="n_imagenet_root"):
        cli.main(argv + CLI_COMMON + ["--output_dir", str(tmp_path)])
