"""The port's sparse Swin slice against the JAX package on the CPU.

The host planner's arrays (dense and three mask ratios, at Swin-T/224 and
at JAX's tiny geometry) and the step schedule's packed buffers are held
equal to JAX's integer for integer, and so are the handoff (pack, upload,
unpack) and ``expand_plan``. The same numpy-seeded inputs then go through
the JAX function and its port: ``WindowAttention``, ``SparseSwinBlock``,
``PatchMerging``, the backbone's dense encode (with its pyramid) and
masked encode, a bf16 eval forward whose stage-3 MLP takes the K5 branch,
the pretrain, cls and dense hubs carried across with
``export_torch_state_dict`` -> ``load_jax_state_dict`` (strictly), the
layer ids of every parameter of the full-size Swin-T hubs, rec steps 0,
1 and 5 (both states restored at update 5, as a resumed run), rec+con
steps 0 and 2, an adj step with the frozen trunk, and each CLI with
``--backbone swin`` at tiny widths (the pretrain CLI in all six phases).
The JAX halves run at f32, the steps under ``jax.jit``.
Every test passes ``device="cpu"``. The tiny hubs are
``tests/_swin_port.py``'s.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import (
    export_torch_state_dict,
    save_torch_checkpoint,
)
from eventpretrain_tpu.ckpt.torch_import import (
    _flax_path_to_torch_key,
    init_backbone_from,
)
from eventpretrain_tpu.models import cls_hub as jcls_hub
from eventpretrain_tpu.models import dense_hub as jdense_hub
from eventpretrain_tpu.models import layers as jlayers
from eventpretrain_tpu.models import pretrain_hub as jpretrain_hub
from eventpretrain_tpu.models import swin as jswin
from eventpretrain_tpu.models import swin_plan as jplan
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train import steps as jsteps
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu_torch import native
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.cli import finetune_cls as cls_cli
from eventpretrain_tpu_torch.cli import finetune_flow as flow_cli
from eventpretrain_tpu_torch.cli import finetune_semseg as semseg_cli
from eventpretrain_tpu_torch.cli import pretrain as pretrain_cli
from eventpretrain_tpu_torch.models import clip as tclip
from eventpretrain_tpu_torch.models import cls_hub as tcls_hub
from eventpretrain_tpu_torch.models import dense_hub as tdense_hub
from eventpretrain_tpu_torch.models import layers as tlayers
from eventpretrain_tpu_torch.models import pretrain_hub as tpretrain_hub
from eventpretrain_tpu_torch.models import swin as tswin
from eventpretrain_tpu_torch.models import swin_plan as tplan
from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train import steps as tsteps
from eventpretrain_tpu_torch.train.state import TrainState

from tests._con_port import zero_gradient_keys
from tests._swin_port import (
    CFG,
    EMBED,
    PLAN,
    SIDE,
    STEP,
    finetune_twin,
    mask_cells,
    plans_of,
    port_pretrain_hub,
    port_twin,
    rec_batch,
    rec_twin,
    rel_err,
)
from tests._port_threads import one_torch_thread  # noqa: F401

# f32 on both sides, sums in other orders: activations of scale ~1 within
# 1e-5 of their scale; losses, gradients and parameters after a few
# updates within 1e-4 of their scale
ENCODE_REL = 1e-5
STEP_REL = 1e-4
# Adam's first updates are lr * m / (sqrt(v) + eps): a component whose
# gradient is near eps moves by a part of a step set by the gradient's last
# digits, so parameters after the steps get 1e-3 of the steps' size beside
# the 1e-4 of their scale
ADAM_SLACK = 1e-3
# bf16 on both sides (the port's K5 plain version against JAX's plain
# Mlp), roundings in other places: within 2e-2 of the output's scale
BF16_REL = 2e-2
NUM_CLASSES = 4
T224 = dict(input_resolution=(56, 56), num_stages=4, window_size=7,
            cell_grid=7)


def _t(a, long=False):
    t = torch.from_numpy(np.array(a))
    return t.long() if long else t


def _mask(cells, ratio, seed):
    if ratio is None:
        return None
    keep = int(cells * (1 - ratio))
    mask = np.ones(cells, bool)
    mask[np.random.default_rng(seed).permutation(cells)[:keep]] = False
    return mask


# ------------------------------------------------------------- planner


def _plan_arrays(plans):
    out = []
    for sp in plans:
        for p in (sp.plan_even, sp.plan_odd):
            out += [p.idx_shuffle, p.idx_unshuffle, p.gid, p.coords_g,
                    p.grouped]
        out += [sp.coords_flat, sp.resolution, sp.merge_child_idx]
    return out


@pytest.mark.parametrize("ratio", [None, 0.25, 0.5, 0.75],
                         ids=["dense", "0.25", "0.5", "0.75"])
@pytest.mark.parametrize("geometry", ["swin_t_224", "tiny"])
def test_planner_matches_jax(geometry, ratio):
    """``build_swin_plans`` (the C++ knapsack on both sides): every array of
    every stage and parity equals JAX's, integer for integer."""
    kw = T224 if geometry == "swin_t_224" else PLAN
    mask = _mask(kw["cell_grid"] ** 2, ratio, seed=11)
    got = _plan_arrays(tplan.build_swin_plans(mask, **kw))
    want = _plan_arrays(jplan.build_swin_plans(mask, **kw))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, i
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        else:
            assert g == w, i


def test_group_windows_native_is_the_numpy_specification(monkeypatch):
    """The port's knapsack grouping through the C++ entry point equals its
    numpy specification ``_group_windows_numpy`` on the occupancies of a
    Swin-T/224 masked stage and of ragged windows."""
    coords = tplan.visible_coords(_mask(49, 0.5, 3), (56, 56), 7)
    gid = tplan._window_group_id(coords, 7, 3)
    occ = np.unique(gid, return_counts=True)[1].tolist()
    rng = np.random.default_rng(5)
    for weights in (occ, rng.integers(1, 50, 40).tolist()):
        native_res = tplan.group_windows(49, weights)
        monkeypatch.setattr(native, "BACKEND", "numpy-forced")
        assert tplan.group_windows(49, weights) == native_res
        assert tplan._group_windows_numpy(49, weights) == native_res
        monkeypatch.undo()


# ------------------------------------------------------------ schedule


@pytest.mark.parametrize("tag", ["rec", "rec_con"])
def test_schedule_matches_jax(tag):
    """The masker's packed buffer and layout for steps 0-3 at Swin-T/224
    (49 cells, 24 kept) equal JAX's ``_HostCellMasker._compute_np``."""
    t_tag, j_tag = ((tsteps._SWIN_REC_TAG, jsteps._SWIN_REC_TAG)
                    if tag == "rec" else
                    (tsteps._SWIN_REC_CON_TAG, jsteps._SWIN_REC_CON_TAG))
    assert t_tag == j_tag
    geo = dict(input_resolution=56, window_size=7, cell_grid=7)
    tm = tsteps._HostCellMasker(3, t_tag, 49, 24, device="cpu", **geo)
    jm = jsteps._HostCellMasker(3, j_tag, 49, 24, prefetch=0, **geo)
    for step in range(4):
        (gf, gl), (wf, wl) = tm._compute_np(step), jm._compute_np(step)
        assert gl == wl, step
        assert gf.dtype == wf.dtype == np.int32
        np.testing.assert_array_equal(gf, wf, err_msg=str(step))


# ------------------------------------------------------------- handoff


def test_pack_unpack_and_expand_match_jax():
    """The packed buffer through ``unpack_plans`` (views of one tensor)
    against JAX's ``unpack_plans_traced``, every leaf equal; the batch rows
    of ``ids_keep``/``mask``/``ids_restore``; and ``expand_plan``'s
    ``attn_mask`` and ``rel_pos_idx`` of every stage parity, exactly."""
    mask = _mask(49, 0.5, 7)
    keep = np.flatnonzero(~mask).astype(np.int32)
    restore = np.argsort(np.concatenate([keep, np.flatnonzero(mask)]))
    host = tplan.build_swin_plans(mask, **T224)
    flat, layout = tswin.pack_plans_np(host, keep, mask.astype(np.float32),
                                       restore)
    jflat, jlayout = jswin.pack_plans_np(host, keep, mask.astype(np.float32),
                                         restore)
    assert layout == jlayout
    np.testing.assert_array_equal(flat, jflat)
    plans, ik, mk, ir = tswin.unpack_plans(torch.from_numpy(flat), layout, 3)
    jplans, jik, jmk, jir = jax.jit(
        lambda f: jswin.unpack_plans_traced(f, layout, 3))(jnp.asarray(flat))
    got = [t for t in jax.tree.leaves(plans)]
    want = jax.tree.leaves(jplans)
    assert len(got) == len(want) == 4 * (2 * 4 + 2) - 1
    base = got[0].untyped_storage().data_ptr()
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert g.untyped_storage().data_ptr() == base
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in ((ik, jik), (mk, jmk), (ir, jir)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert mk.dtype == torch.float32
    expand = jax.jit(jswin.expand_plan, static_argnums=1)
    for sp, jsp, res in zip(plans, jplans, (56, 28, 14, 7)):
        for p, jp in ((sp.plan_even, jsp.plan_even),
                      (sp.plan_odd, jsp.plan_odd)):
            ws = min(7, res)
            ga, gr = tswin.expand_plan(p, ws)
            wa, wr = expand(jp, ws)
            np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
            np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
            assert ga.dtype == torch.float32


# ------------------------------------------------------------- modules


def _module_case(kind, seed=0):
    """(port module, JAX module, its variables, args of both) for a stage-1
    block of the tiny config under a masked plan."""
    mask, _, _ = mask_cells(seed)
    jplans, tplans = plans_of(mask)
    rng = np.random.default_rng(seed)
    n = int(tplans[0].coords_flat.shape[0])
    x = rng.normal(size=(2, n, 32)).astype(np.float32)
    if kind == "merge":
        tm = tswin.PatchMerging(32, device="cpu")
        jm = jswin.PatchMerging()
        targs = (_t(x), tplans[0].merge_child_idx)
        jargs = (jnp.asarray(x), jplans[0].merge_child_idx)
    elif kind == "block":
        tm = tswin.SparseSwinBlock(32, 2, 4, device="cpu")
        jm = jswin.SparseSwinBlock(num_heads=2, window_size=4)
        plan = tplans[0].plan_odd
        targs = (_t(x), plan, tswin.expand_plan(plan, 4))
        jargs = (jnp.asarray(x), jplans[0].plan_odd)
    else:
        plan, jplan = tplans[0].plan_odd, jplans[0].plan_odd
        gs = plan.gid.shape[-1]
        xg = x[:, np.asarray(plan.idx_shuffle)].reshape(2, -1, gs, 32)
        tm = tswin.WindowAttention(32, 2, 4, device="cpu")
        jm = jswin.WindowAttention(num_heads=2, window_size=4)
        targs = (_t(xg), *tswin.expand_plan(plan, 4))
        jargs = (jnp.asarray(xg), *jswin.expand_plan(jplan, 4))
    init_weights(tm, torch.Generator().manual_seed(seed))
    v = port_twin(tm, jm, *jargs)
    return tm, jm, v, targs, jargs


@pytest.mark.parametrize("kind", ["attention", "block", "merge"])
def test_modules_match_jax(kind):
    """``WindowAttention`` on grouped tokens (pads masked), a shifted
    ``SparseSwinBlock`` (the gather, attention, the gather back, the
    MLP) and ``PatchMerging`` on stage 1's visible tokens, within 1e-5 of
    their scale."""
    tm, jm, v, targs, jargs = _module_case(kind)
    want = np.asarray(jax.jit(lambda *a: jm.apply(v, *a))(*jargs))
    got = tm(*targs).detach().numpy()
    assert got.shape == want.shape
    assert rel_err(got, want) <= ENCODE_REL


@pytest.fixture(scope="module")
def backbone_vars():
    """The tiny Swin with its stage decoders and its JAX twin's variables
    for both encodes."""
    tm = tswin.SparseSwin(**CFG, device="cpu")
    init_weights(tm, torch.Generator().manual_seed(0))
    jm = jswin.SparseSwin(**CFG)
    mask, keep, _ = mask_cells(0)
    jplans, _ = plans_of(mask)
    x = jnp.zeros((1, SIDE, SIDE, 5))
    vm = port_twin(tm, jm, x, jnp.asarray(keep)[None], jplans,
                   method=jm.encode_masked)
    return jm, vm, tm.eval()


def test_encode_dense_matches_jax(backbone_vars):
    """The dense encode under the cached no-mask plans: the first two
    stages' tokens, the normed stage-4 tokens and the 4-level pyramid,
    within 1e-5 of their scale; a second call reuses the plans."""
    jm, v, tm = backbone_vars
    x = rec_batch(2)["evg"]
    want = jax.jit(lambda x: jm.apply(v, x, method=jm.encode_dense,
                                      return_pyramid=True))(jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode_dense(_t(x), return_pyramid=True)
    pairs = list(zip(got[:3], want[:3])) + list(zip(got[3], want[3]))
    assert len(pairs) == 7 and got[4] is None
    for i, (g, w) in enumerate(pairs):
        assert tuple(g.shape) == w.shape, i
        assert rel_err(g.numpy(), np.asarray(w)) <= ENCODE_REL, i
    key = [k for k in tswin._DENSE_PLANS if k[1] == (16, 16)]
    assert len(key) == 1
    plans = tswin._DENSE_PLANS[key[0]]
    tm.encode_dense(_t(x))
    assert tswin._DENSE_PLANS[key[0]] is plans


def test_fpn_level_matches_jax():
    """``with_fpn``: the pyramid's fifth level, GELU of the f32 BatchNorm
    (on running statistics away from their init) of the 3x3 stride-2 conv
    of stage 4's map, on a 96x96 input (stage 4 at 3x3), within 1e-5 of
    its scale."""
    cfg = {**CFG, "input_size": 96, "depths": (1, 1, 1, 1)}
    tm = tswin.SparseSwin(**cfg, with_rec_decoders=False, with_fpn=True,
                          device="cpu")
    init_weights(tm, torch.Generator().manual_seed(1))
    jm = jswin.SparseSwin(**cfg, with_rec_decoders=False, with_fpn=True)
    x = np.random.default_rng(8).normal(size=(2, 96, 96, 5)).astype(
        np.float32)
    v = port_twin(tm, jm, jnp.zeros((1, 96, 96, 5)), method=jm.encode_dense,
                  return_pyramid=True)
    want = jax.jit(lambda x: jm.apply(v, x, method=jm.encode_dense,
                                      return_pyramid=True))(jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval().encode_dense(_t(x), return_pyramid=True)
    assert len(got[3]) == len(want[3]) == 5
    assert tuple(got[3][4].shape) == want[3][4].shape == (2, 1, 1, 256)
    for g, w in zip(got[3], want[3]):
        assert rel_err(g.numpy(), np.asarray(w)) <= ENCODE_REL


def test_encode_masked_matches_jax(backbone_vars):
    """The masked encode under a step's plans: each stage's visible tokens
    and the fused feature (stages 1-3 in ``ids_keep`` order, stage 4 in
    row-major cell order), within 1e-5 of their scale."""
    jm, v, tm = backbone_vars
    mask, keep, _ = mask_cells(4)
    keep = keep[::-1].copy()  # an ids_keep order that is not row-major
    jplans, tplans = plans_of(mask)
    x = rec_batch(3)["evg"]
    ids = np.tile(keep, (2, 1))
    wouts, wemb = jax.jit(lambda x, i: jm.apply(
        v, x, i, jplans, method=jm.encode_masked))(jnp.asarray(x),
                                                   jnp.asarray(ids))
    with torch.no_grad():
        gouts, gemb = tm.encode_masked(_t(x), _t(ids, long=True), tplans)
    for g, w in zip([*gouts, gemb], [*wouts, wemb]):
        assert tuple(g.shape) == w.shape
        assert rel_err(g.numpy(), np.asarray(w)) <= ENCODE_REL


def test_bf16_eval_takes_k5_and_matches_jax(monkeypatch):
    """A bf16 eval forward of the tiny cls hub: the MLPs of stages 3 and 4
    (C=128 and 256, hidden 4C, 16 and 4 tokens) take the K5 branch of
    ``Mlp`` (on the CPU its plain version), those of stages 1 and 2 (C=32,
    64) do not; those MLPs' outputs and the logits within 2e-2 of their
    scale of JAX's bf16 hub (its plain ``Mlp``). A training forward stays
    off K5."""
    calls = []
    orig = tlayers.fused_mlp

    def spy(x, *a, **kw):
        out = orig(x, *a, **kw)
        calls.append(out.detach().float().numpy())
        return out

    monkeypatch.setattr(tlayers, "fused_mlp", spy)
    hub, _, v = finetune_twin("cls", NUM_CLASSES)
    hub16 = tcls_hub.cls_hub_swin_tiny(NUM_CLASSES, device="cpu",
                                       dtype=torch.bfloat16, **CFG)
    hub16.load_state_dict(hub.state_dict())
    jhub16 = jcls_hub.FtClsHub(
        backbone=jswin.SparseSwin(**CFG, with_rec_decoders=False,
                                  dtype=jnp.bfloat16, name="backbone"),
        num_classes=NUM_CLASSES, dtype=jnp.bfloat16)
    x = rec_batch(6)["evg"]

    def is_mlp(mdl, method):
        return isinstance(mdl, jlayers.Mlp) and method == "__call__"

    (_, want, _), inter = jax.jit(lambda x: jhub16.apply(
        v, x, capture_intermediates=is_mlp, mutable=["intermediates"]))(
            jnp.asarray(x))
    mlps = [np.asarray(a, np.float32) for a in jax.tree.leaves(inter)
            if a.shape[-1] >= 128]
    with torch.no_grad():
        _, got, _ = hub16.eval()(_t(x))
    assert len(calls) == len(mlps) == 2
    for g, w in zip(calls, mlps):
        assert g.shape == w.shape
        assert rel_err(g, w) <= BF16_REL
    assert rel_err(got.float().numpy(), np.asarray(want, np.float32)) \
        <= BF16_REL
    hub16.train()
    hub16(_t(x))
    assert len(calls) == 2


# ---------------------------------------------------------------- hubs


def _twin_outputs(kind):
    if kind == "pretrain":
        hub, jhub, v = rec_twin()
        mask, keep, restore = mask_cells(5)
        jplans, tplans = plans_of(mask)
        b = rec_batch(4)
        ik, ir = np.tile(keep, (2, 1)), np.tile(restore, (2, 1))
        want = jax.jit(lambda e, i, r: jhub.apply(
            v, e, i, r, plans=jplans, method=jhub.forward_rec))(
                jnp.asarray(b["evg"]), jnp.asarray(ik), jnp.asarray(ir))
        got = hub.forward_rec(_t(b["evg"]), _t(ik, True), _t(ir, True),
                              plans=tplans)
        wcon = jax.jit(lambda e, c: jhub.apply(
            v, e, c, method=jhub.forward_con))(jnp.asarray(b["evg"]),
                                               jnp.asarray(b["clip_emb"]))
        gcon = hub.eval().forward_con(_t(b["evg"]), _t(b["clip_emb"]))
        return [*got, *gcon[:4]], [*want, *wcon[:4]]
    hub, jhub, v = finetune_twin(kind, NUM_CLASSES)
    x = rec_batch(5)["evg"]
    want = jax.jit(lambda x: jhub.apply(v, x))(jnp.asarray(x))
    got = hub.eval()(_t(x))
    if kind == "cls":
        return got[:2], want[:2]
    return ((got[0], *got[1], got[2], got[3]),
            (want[0], *want[1], want[2], want[3]))


@pytest.mark.parametrize("kind", ["pretrain", "cls", "dense"])
def test_hub_outputs_match_jax(kind):
    """Each Swin hub against its JAX twin (the same weights): the rec
    prediction and features, and ``forward_con``'s q and k (the conv CLIP
    projection) with the detached tokens; the cls features and logits;
    the dense hub's pyramid, decode and auxiliary outputs; each within
    1e-5 of its scale."""
    got, want = _twin_outputs(kind)
    assert len(got) == len(want) == {"pretrain": 8, "cls": 2,
                                     "dense": 7}[kind]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        assert rel_err(g, w) <= ENCODE_REL, (i, rel_err(g, w))


@pytest.mark.parametrize("kind", ["pretrain", "cls", "dense"])
def test_weight_bridge_is_strict(kind):
    """The exporter's state dict of each JAX Swin hub loads strictly into a
    fresh port hub and gives back the weights it came from (the bias
    tables, the bias-free reductions, the conv CLIP projection); a
    reference file's ``relative_position_index`` and ``attn_mask``
    buffers are skipped; a key left out raises."""
    if kind == "pretrain":
        hub, _, v = rec_twin()
        fresh = port_pretrain_hub()
    else:
        hub, _, v = finetune_twin(kind, NUM_CLASSES)
        fresh = (tcls_hub.cls_hub_swin_tiny if kind == "cls"
                 else tdense_hub.dense_hub_swin_tiny)(
            NUM_CLASSES, device="cpu", **CFG,
            generator=torch.Generator().manual_seed(9))
    sd = export_torch_state_dict(v["params"], v.get("batch_stats"))
    table = "backbone.swin_block.0.blocks.1.attn.relative_position_bias_table"
    assert sd[table].shape == (49, 2)
    assert "backbone.swin_block.2.downsample.reduction.weight" in sd
    assert "backbone.swin_block.3.downsample.norm.weight" not in sd
    assert ("clip_emb_proj.weight" in sd) == (kind == "pretrain")
    if kind == "pretrain":
        assert sd["clip_emb_proj.weight"].shape == (256, 16, 2, 2)
    ref = {**sd,
           "backbone.swin_block.0.blocks.1.attn_mask": np.zeros((4, 16, 16)),
           "backbone.swin_block.0.blocks.0.attn.relative_position_index":
               np.zeros((16, 16), np.int64)}
    load_jax_state_dict(fresh, ref)
    for k, t in hub.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(),
                                      t.numpy(), err_msg=k)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_state_dict(fresh, {k: a for k, a in sd.items()
                                    if k != table})


# ----------------------------------------------------------- layer ids


def _jax_full_tree(kind):
    x = jnp.zeros((1, 224, 224, 5))
    if kind == "pretrain":
        hub = jpretrain_hub.pretrain_hub_swin()
        mask = np.zeros(49, bool)
        mask[24:] = True
        plans = jswin.plans_to_device(jplan.build_swin_plans(mask))
        fn = lambda k: hub.init(k, x, jnp.arange(24)[None],  # noqa: E731
                                jnp.arange(49)[None], plans=plans,
                                method=hub.forward_rec)
    elif kind == "cls":
        hub = jcls_hub.cls_hub_swin_tiny(NUM_CLASSES)
        fn = lambda k: hub.init(k, x)  # noqa: E731
    else:
        hub = jdense_hub.dense_hub_swin_tiny(NUM_CLASSES)
        fn = lambda k: hub.init(k, x)  # noqa: E731
    return jax.eval_shape(fn, jax.random.key(0))["params"]


@pytest.mark.parametrize("kind", ["pretrain", "cls", "dense"])
def test_layer_ids_match_jax(kind):
    """Every parameter of the full-size Swin-T hubs (12 layer ids, as the
    CLIs set them): the port's id and lr scale of its torch name equal
    JAX's ``vit_layer_id(..., "swin")`` and ``layer_scale_tree`` of the
    flax path the exporter maps to that name (the patch embed 0, the rest
    of the backbone and the heads 12); both hubs hold the same names."""
    tree = _jax_full_tree(kind)
    port = {"pretrain": lambda: tpretrain_hub.pretrain_hub_swin(
                device="meta"),
            "cls": lambda: tcls_hub.cls_hub_swin_tiny(NUM_CLASSES,
                                                      device="meta"),
            "dense": lambda: tdense_hub.dense_hub_swin_tiny(
                NUM_CLASSES, device="meta")}[kind]()
    names = [n for n, _ in port.named_parameters()]
    scales = joptim.layer_scale_tree(tree, 12, 0.75, "swin")
    want_id, want_scale = {}, {}

    def visit(path, leaf):
        flax_names = [getattr(p, "key", str(p)) for p in path]
        key = _flax_path_to_torch_key(flax_names)[0]
        want_id[key] = joptim.vit_layer_id(flax_names, 12, "swin")
        return leaf

    jax.tree_util.tree_map_with_path(visit, tree)
    jax.tree_util.tree_map_with_path(
        lambda path, s: want_scale.__setitem__(_flax_path_to_torch_key(
            [getattr(p, "key", str(p)) for p in path])[0], s), scales)
    assert set(names) == set(want_id)
    got_scale = toptim.layer_scales(names, 12, 0.75, "swin")
    for n in names:
        assert toptim.vit_layer_id(n, 12, "swin") == want_id[n], n
        assert got_scale[n] == pytest.approx(want_scale[n], rel=1e-12), n
    assert {toptim.vit_layer_id(n, 12, "swin") for n in names} == {0, 12}


# --------------------------------------------------------------- steps


def _schedule():
    return (1e-3, 1e-5, 1, 3, 2)  # update 0 at lr 0, then warm, then cosine


def _jax_state(jhub, v, trainable_mask=None):
    tx = joptim.build_optimizer(
        v["params"], learning_rate=joptim.cosine_warmup_schedule(
            *_schedule()),
        weight_decay=0.05, layer_decay=0.75, num_layers=12,
        backbone_type="swin", trainable_mask=trainable_mask)
    params = jax.tree.map(jnp.copy, v["params"])
    # TrainState.create's eager tx.init, jitted (the layer-decay chain
    # has an op a leaf)
    return JTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.copy, v["batch_stats"]),
        opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=jhub.apply)


def _port_state(hub):
    return TrainState(hub, toptim.build_optimizer(
        hub, weight_decay=0.05, layer_decay=0.75, num_layers=12,
        backbone_type="swin"), toptim.cosine_warmup_schedule(*_schedule()))


def _resumed(jstate, state, count):
    """Both states as a run restored at update ``count`` holds them: the
    step counter and the lr schedule's count there (each side's Adam
    moments and count stay as they are)."""
    def visit(s):
        if isinstance(s, optax.ScaleByScheduleState):
            return s._replace(count=jnp.full_like(s.count, count))
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            return tuple(visit(x) for x in s)
        return s

    state.step = count
    return jstate.replace(step=jnp.full_like(jstate.step, count),
                          opt_state=visit(jstate.opt_state))


def _run(kind, counts, jstep, step, v, hub, jhub, mask=None):
    """Steps at the update counts ``counts`` on both sides from the same
    init (a count that does not follow the last resumes both states
    there, so the Swin schedules plan that step's mask); the loss (and
    rec/con losses) and grad norm of each within 1e-4, then every
    parameter (1e-4 of its scale; the zero-gradient ones within two
    steps' size) and the projectors' statistics."""
    frozen = {}
    if kind == "adj":
        trainable = toptim.freeze_except_norm(hub)
        frozen = {n: p.detach().numpy().copy()
                  for n, p in hub.named_parameters() if not trainable[n]}
        assert "backbone.swin_block.0.blocks.0.attn.qkv.weight" in frozen
    jstate, state = _jax_state(jhub, v, mask), _port_state(hub)
    keys = ("loss", "grad_norm") + (("rec_loss", "con_loss")
                                    if kind == "rec_con" else ())
    names = ("evg", "clip_emb") if kind == "adj" else ("evg", "frame",
                                                        "clip_emb")
    for i, count in enumerate(counts):
        if count != state.microsteps:
            jstate = _resumed(jstate, state, count)
        b = rec_batch(20 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(b[k]) for k in names},
                           jax.random.key(i))
        tm = step(state, {k: _t(b[k]) for k in names})
        for k in keys:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_REL, err_msg=f"{i} {k}")
    assert state.step == counts[-1] + 1
    lr_sum = sum(toptim.cosine_warmup_schedule(*_schedule())(c)
                 for c in counts)
    want = export_torch_state_dict(jstate.params, jstate.batch_stats)
    for n, p in hub.named_parameters():
        got, w = p.detach().numpy().copy(), want[n].copy()
        if n in frozen:
            assert np.array_equal(got, frozen[n]), n
        if zero_gradient_keys(n):
            # softmax ignores the key bias and the projector's BatchNorm
            # the final LayerNorm's bias: their gradients are rounding,
            # which Adam scales to a step of either sign
            sl = (slice(got.shape[0] // 3, 2 * got.shape[0] // 3)
                  if n.endswith("qkv.bias") else slice(None))
            assert np.abs(got[sl] - w[sl]).max() <= 2 * lr_sum, n
            got[sl] = w[sl] = 0.0
        tol = STEP_REL * np.abs(w).max() + ADAM_SLACK * lr_sum
        assert np.abs(got - w).max() <= tol, (n, rel_err(got, w))
    for k, buf in hub.named_buffers():
        if "running_" in k:
            assert rel_err(buf.numpy(), want[k]) <= STEP_REL, k
    return state


def test_swin_rec_steps_match_jax():
    """make_swin_rec_step: steps 0 and 1, then step 5 of both states
    restored at update 5 (a resumed run plans step 5's mask), against
    JAX's make_swin_rec_step with the same schedule seed; the port's masker
    uploads one buffer a planned step, prefetching two ahead (steps 0-3,
    then 5-7; the jump to 5 cancels step 3's planning if it has not
    started)."""
    hub, jhub, v = rec_twin()
    jstep = jsteps.make_swin_rec_step(jhub, plan_seed=4, **STEP)
    step = tsteps.make_swin_rec_step(hub, plan_seed=4, **STEP)
    _run("rec", [0, 1, 5], jstep, step, v, hub, jhub)
    concurrent.futures.wait(step.masker._pending.values())
    assert step.masker.uploads in (6, 7)


def test_swin_rec_and_con_step_matches_jax():
    """make_swin_rec_and_con_step (global InfoNCE through the conv CLIP
    projection) against JAX's: step 0, then step 2 of both states
    restored at update 2 (its schedule's mask at index 2)."""
    hub, jhub, v = rec_twin()
    jstep = jsteps.make_swin_rec_and_con_step(jhub, plan_seed=1, **STEP)
    step = tsteps.make_swin_rec_and_con_step(hub, plan_seed=1, **STEP)
    _run("rec_con", [0, 2], jstep, step, v, hub, jhub)


def test_swin_adj_step_matches_jax():
    """Stage 2 on the Swin hub: make_con_step with the trunk frozen but
    its norm_layer, against JAX's with ``frozen_except_norm_mask``; every
    frozen parameter unchanged, bit for bit."""
    hub, jhub, v = rec_twin()
    mask = joptim.frozen_except_norm_mask(v["params"])
    jstep = jsteps.make_con_step(jhub, trainable_mask=mask)
    step = tsteps.make_con_step(hub)
    _run("adj", [0], jstep, step, v, hub, jhub, mask)


def test_step_index_reaches_the_schedule():
    """The masker keys each step's mask by ``state.microsteps`` (JAX's
    ``state.step``): through ``train_one_epoch`` a second epoch goes on
    from where the first stopped, and a state restored at update 7 plans
    step 7's mask; each step's buffer is the schedule's at its index."""
    from eventpretrain_tpu_torch.train.loop import train_one_epoch

    hub = port_pretrain_hub(with_heads=False)
    init_weights(hub, torch.Generator().manual_seed(0))
    step = tsteps.make_swin_rec_step(hub, **STEP)
    masker = step.masker
    seen = []
    orig = masker.flat_layout

    def record(state):
        flat, layout = orig(state)
        seen.append((state.microsteps, flat.numpy().copy()))
        return flat, layout

    masker.flat_layout = record
    state = _port_state(hub)
    batches = [{k: _t(a) for k, a in rec_batch(i).items()} for i in range(2)]
    step(state, batches[0])
    for _ in range(2):
        train_one_epoch(step, state, batches, print_freq=5)
    state.step = 7
    step(state, batches[1])
    assert [s for s, _ in seen] == [0, 1, 2, 3, 4, 7] and state.step == 8
    for s, flat in seen:
        np.testing.assert_array_equal(flat, masker._compute_np(s)[0])


# ---------------------------------------------------------------- CLIs


def _tiny_pretrain(num_bins=5, frame_chans=1, with_decoder=True,
                   with_heads=False, bn_groups=1, *, dtype, device,
                   generator, input_size, **bk):
    """``cli.pretrain``'s Swin factory at the tiny widths, window 7 as
    Swin-T's (so the CLI's schedule plans it), cells of 32 pixels (4 at
    64; 49 at 224, paired with CLIP's 512-wide 14x14 token grid)."""
    hub = port_pretrain_hub(with_decoder, with_heads, dtype, device,
                            clip_dim=512, input_size=input_size,
                            window_size=7,
                            decoder_num_patches=(input_size // 32) ** 2, **bk)
    init_weights(hub, generator)
    return hub


def _cls_tiny(num_classes, num_bins=5, **kw):
    # window 7 as the rec checkpoint's: its bias tables' shapes
    kw.update(CFG, input_size=kw["input_size"], window_size=7)
    return tcls_hub.cls_hub_swin_tiny(num_classes, num_bins, **kw)


def _dense_tiny(num_classes, num_bins=5, **kw):
    kw.update(CFG, input_size=kw["input_size"])
    return tdense_hub.dense_hub_swin_tiny(num_classes, num_bins, **kw)


@pytest.fixture(scope="module")
def swin_rec_checkpoint(tmp_path_factory):
    """A rec checkpoint of ``cli.pretrain --backbone swin`` (4 steps)."""
    out = tmp_path_factory.mktemp("swin_rec")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pretrain_cli, "pretrain_hub_swin", _tiny_pretrain)
        state = pretrain_cli.main([
            "--device", "cpu", "--no-bf16", "--backbone", "swin",
            "--pr_phase", "rec", "--input_size", str(SIDE),
            "--mask_ratio", "0.5", "--batch_size", "8", "--epochs", "1",
            "--num_workers", "0", "--output_dir", str(out)])
    return state, str(out / "checkpoint.pth")


def test_pretrain_cli_rec_with_swin(swin_rec_checkpoint):
    """``--backbone swin --pr_phase rec``: the Swin schedule's steps (32
    synthetic samples at batch 8), a checkpoint with the stage decoders
    and the Swin decoder; a contrastive phase at a grid other than 7x7 is
    refused."""
    state, path = swin_rec_checkpoint
    assert state.step == 4 and state.module.patch_size == 32
    sd = load_torch_checkpoint(path)
    assert "backbone.stage3_output_decode.weight" in sd
    assert "backbone.swin_block.0.blocks.1.attn.relative_position_bias_table" \
        in sd
    with pytest.raises(ValueError, match="need 49"):
        pretrain_cli.main(["--device", "cpu", "--backbone", "swin",
                           "--pr_phase", "con", "--input_size", "64",
                           "--epochs", "0"])


SWIN_CLI = ["--device", "cpu", "--no-bf16", "--backbone", "swin",
            "--batch_size", "8", "--epochs", "1", "--num_workers", "0",
            "--input_size", "224"]


def _tiny_tower(*, dtype, device, generator):
    """The CLI's CLIP factory at tiny widths: 197 tokens of CLIP's 512."""
    return tclip.CLIPVisionTransformer(
        image_size=224, patch_size=16, width=32, layers=2, heads=2,
        output_dim=512, dtype=dtype, device=device, generator=generator)


@pytest.fixture(scope="module")
def swin_rec_224(tmp_path_factory):
    """A rec checkpoint of ``cli.pretrain --backbone swin`` at 224 (49
    cells; 4 steps of 8)."""
    out = tmp_path_factory.mktemp("swin_rec_224")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pretrain_cli, "pretrain_hub_swin", _tiny_pretrain)
        state = pretrain_cli.main(SWIN_CLI + [
            "--pr_phase", "rec", "--mask_ratio", "0.5", "--output_dir",
            str(out)])
    assert state.step == 4 and state.module.num_patches == 49
    return load_torch_checkpoint(str(out / "checkpoint.pth")), \
        str(out / "checkpoint.pth")


@pytest.mark.parametrize("phase", ["adj", "con", "rec+con", "adj-n",
                                   "con-n"])
def test_pretrain_cli_contrastive_phases_with_swin(
        monkeypatch, tmp_path, swin_rec_224, phase):
    """``--backbone swin`` in each contrastive phase at 224, from the rec
    checkpoint through ``--init_from``, 4 steps of 8: adj and con (con
    with the queue, its (C, 49, K) buffer in the checkpoint) and rec+con
    on the synthetic source's precomputed 197x512 CLIP tokens, adj-n and
    con-n on the synthetic raw source with a tiny CLIP tower in the loop.
    The 49 tokens meet CLIP's 14x14 grid through the conv projection; adj
    leaves every trunk tensor the rec checkpoint holds as it was but the
    norm_layer's, the other phases move the trunk; the checkpoint holds
    the hub's keys and no CLIP tensor."""
    rec, path = swin_rec_224
    monkeypatch.setattr(pretrain_cli, "pretrain_hub_swin", _tiny_pretrain)
    monkeypatch.setattr(pretrain_cli, "clip_vit_b16", _tiny_tower)
    extra = ["--use_queue", "--queue_length", "16"] if phase == "con" else []
    state = pretrain_cli.main(SWIN_CLI + [
        "--pr_phase", phase, "--init_from", path, "--output_dir",
        str(tmp_path)] + extra)
    assert state.step == 4
    hub = state.module
    assert hub.num_patches == 49 and hub.clip_emb_proj.weight.shape == (
        EMBED, 512, 2, 2)
    sd = load_torch_checkpoint(str(tmp_path / "checkpoint.pth"))
    assert set(sd) == set(hub.state_dict()) | (
        {"queue", "queue_ptr"} if phase == "con" else set())
    if phase == "con":
        assert tuple(sd["queue"].shape) == (hub.embed_dim, 49, 16)
    trunk = [k for k in sd if k.startswith("backbone.swin_block")]
    assert trunk and all(k in rec for k in trunk)
    moved = [k for k in trunk if not torch.equal(sd[k], rec[k])]
    if phase in ("adj", "adj-n"):
        assert not moved
        assert not torch.equal(sd["backbone.norm_layer.weight"],
                               rec["backbone.norm_layer.weight"])
    else:
        assert moved


def test_cls_cli_with_swin_finetunes_from_a_rec_checkpoint(
        monkeypatch, tmp_path, swin_rec_checkpoint):
    """``finetune_cls --backbone swin --finetune``: the backbone from the
    rec checkpoint as JAX's ``init_backbone_from(strict_backbone=True)``
    fills it (the stage decoders and the decoder unused), then one
    step."""
    _, path = swin_rec_checkpoint
    hub, _, v = finetune_twin("cls", NUM_CLASSES, seed=1)
    jpath = str(tmp_path / "jax_rec.pth")
    save_torch_checkpoint(jpath, rec_twin(seed=7)[2]["params"])
    want = export_torch_state_dict(init_backbone_from(
        jpath, v["params"], strict_backbone=True))
    cls_cli.load_backbone(hub, jpath)
    for k, t in hub.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    monkeypatch.setattr(cls_cli, "cls_hub_swin_tiny", _cls_tiny)
    res = cls_cli.main([
        "--device", "cpu", "--no-bf16", "--backbone", "swin",
        "--input_size", str(SIDE), "--batch_size", "64", "--epochs", "1",
        "--num_workers", "0", "--fix_events_num", "1000",
        "--val_fix_events_num", "1000", "--num_classes", "2",
        "--finetune", path, "--output_dir", str(tmp_path / "cls")])
    assert res["state"].step == 2  # 128 synthetic samples / 64
    assert np.isfinite(res["val"]["loss"])


@pytest.mark.parametrize("task", ["semseg", "flow"])
def test_dense_clis_with_swin(monkeypatch, tmp_path, task):
    """``--backbone swin`` in the semseg and flow CLIs: one step, the
    eval, a checkpoint of the Swin pyramid's hub."""
    cli = semseg_cli if task == "semseg" else flow_cli
    monkeypatch.setattr(cli, "dense_hub_swin_tiny", _dense_tiny)
    res = cli.main(["--device", "cpu", "--no-bf16", "--backbone", "swin",
                    "--input_size", str(SIDE), "--batch_size", "32",
                    "--epochs", "1", "--fix_events_num", "1000",
                    "--val_fix_events_num", "1000", "--output_dir",
                    str(tmp_path)])
    assert res["state"].step == 1  # 32 synthetic samples / 32
    sd = load_torch_checkpoint(str(tmp_path / "checkpoint.pth"))
    assert "backbone.swin_block.3.blocks.0.mlp.fc2.weight" in sd
    assert "decode_head.lateral_convs.0.conv_layer.weight" in sd
