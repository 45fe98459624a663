"""JAX twins at random weights, and the finetune trajectories that the
ViT-MEM, Swin-ECDDP and EvRepSL port tests share.

flax initialises ViT-MEM's bias tables, ``q_bias`` and ``v_bias`` to zero
and its layer scales to 0.1, and every bias and BatchNorm statistic to
its identity; a comparison at init would not see a wrong index or a
missed term. So every leaf of the JAX tree is drawn from a numpy seed at
a scale of its kind (``random_variables``), the tree goes through JAX's
exporter (``export_torch_state_dict``) and the port's module loads it
strictly (``ckpt.bridge.load_jax_state_dict``). The tree's shapes come
from ``jax.eval_shape`` of the module's init, so no init is compiled, and
are traced once for each module and input shape.

``cls_trajectory`` and ``semseg_trajectory`` run 3 f32 updates of a hub
and of its JAX twin from those weights, the drop-path keep masks replayed
on both sides, and hold the metrics of each step and the parameters
after them against JAX's. JAX's step is compiled at LLVM's -O0
(``JAX_STEP_COMPILE``), which takes a quarter less time on the CPU than
the default; its roundings move in the last bits, well inside the
tolerances. The dense tests give both hubs heads of ``HEAD_WIDTH``
channels (``narrow_heads``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.ckpt.torch_import import _flax_path_to_torch_key
from eventpretrain_tpu.models import layers as jlayers
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import (
    make_cls_train_step as j_make_cls,
    make_semseg_train_step as j_make_semseg,
)
from eventpretrain_tpu_torch.ckpt.bridge import load_jax_state_dict
from eventpretrain_tpu_torch.models import dense_hub as tdense_hub
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_cls_train_step,
    make_semseg_train_step,
)

# f32 on both sides, sums in other orders: activations of scale ~1 within
# 1e-5 of their scale; losses, gradients and parameters after a few
# updates within 1e-4 of their scale
ENCODE_REL = 1e-5
STEP_REL = 1e-4
# bf16 on both sides, roundings in other places: within 2e-2 of the
# output's scale (the earlier slices' bf16 encode cases)
BF16_REL = 2e-2
# the dense heads' width in the tests (the hubs' UPerHead 384, FCN 256):
# the same modules at a tenth of the work a step
HEAD_WIDTH = 32
JAX_STEP_COMPILE = {"xla_backend_optimization_level": 0}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _draw(rng, name: str, shape) -> np.ndarray:
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1])) or 1
        return rng.normal(size=shape) * fan_in ** -0.5
    if name == "scale":
        return 1.0 + 0.2 * rng.normal(size=shape)
    if name.startswith("gamma"):
        return rng.uniform(0.2, 1.0, size=shape)
    if name == "var":
        return rng.uniform(0.5, 1.5, size=shape)
    if name in ("relative_position_bias_table", "cls_token"):
        return 0.5 * rng.normal(size=shape)
    # biases (q_bias and v_bias among them) and BatchNorm means
    return 0.2 * rng.normal(size=shape)


def random_variables(shapes, seed: int) -> dict:
    """A tree of the ``shapes`` tree's structure (``jax.eval_shape`` of an
    init) with every leaf drawn by its name from ``seed``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        return jnp.asarray(_draw(rng, name, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


_SHAPES = {}


def random_twin(module, jmodule, *args, seed: int = 0, **kw) -> dict:
    """JAX variables of ``jmodule`` at ``jmodule.init(key, *args, **kw)``'s
    shapes, drawn from ``seed``; ``module`` (the port's) loads them
    through the exporter, strictly. Returns the variables."""
    key = repr((jmodule, [(a.shape, a.dtype) for a in args], kw))
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(
            lambda k: jmodule.init(k, *args, **kw), jax.random.key(0))
    v = random_variables(_SHAPES[key], seed)
    sd = export_torch_state_dict(v["params"], v.get("batch_stats"))
    load_jax_state_dict(module, sd)
    return v


def narrow_heads(monkeypatch) -> dict:
    """The port's dense hubs built from here on get heads of
    ``HEAD_WIDTH`` channels; returns the JAX ``FtDenseHub``'s fields for
    the same."""
    monkeypatch.setattr(tdense_hub, "DECODE_CHANNELS", HEAD_WIDTH)
    monkeypatch.setattr(tdense_hub, "AUX_CHANNELS", HEAD_WIDTH)
    return {"decode_channels": HEAD_WIDTH, "aux_channels": HEAD_WIDTH}


def t(a, long=False) -> torch.Tensor:
    out = torch.from_numpy(np.array(a))
    return out.long() if long else out


def check_layer_decay(tree, hub, num_layers: int, backbone_type: str):
    """The port's lr scale (layer decay 0.75) and weight-decay flag of
    each parameter name of ``hub`` equal JAX's ``layer_scale_tree`` and
    ``weight_decay_mask`` of the flax path the exporter maps to that
    name, and both hubs hold the same names. Returns the set of layer
    ids the port gives."""
    scales = joptim.layer_scale_tree(tree, num_layers, 0.75, backbone_type)
    masks = joptim.weight_decay_mask(tree)
    want_scale, want_mask = {}, {}

    def key(path):
        return _flax_path_to_torch_key(
            [getattr(p, "key", str(p)) for p in path])[0]

    jax.tree_util.tree_map_with_path(
        lambda p, s: want_scale.__setitem__(key(p), s), scales)
    jax.tree_util.tree_map_with_path(
        lambda p, m: want_mask.__setitem__(key(p), bool(m)), masks)
    params = dict(hub.named_parameters())
    assert set(params) == set(want_scale)
    got_scale = toptim.layer_scales(params, num_layers, 0.75, backbone_type)
    got_mask = toptim.weight_decay_mask(params)
    for n in params:
        assert got_scale[n] == pytest.approx(want_scale[n], rel=1e-12), n
        assert got_mask[n] == want_mask[n], n
    return {toptim.vit_layer_id(n, num_layers, backbone_type)
            for n in params}


class BatchReplayDropPath:
    """Stands in for ``eventpretrain_tpu.models.layers.drop_path`` in a
    compiled cls step that serves every batch: each batch's keep masks
    (S, B) ride on an extra channel of ``evg`` and ``preprocess`` takes
    them off (traced values, not constants of one trace)."""

    def __init__(self, sites: int):
        self.sites = sites
        self.masks = None
        self.calls = 0

    @staticmethod
    def pack(evg, keep):
        extra = np.zeros(evg.shape[:-1] + (1,), np.float32)
        extra[:, :keep.shape[0], 0, 0] = keep.T
        return np.concatenate([evg, extra], axis=-1)

    def preprocess(self, evg):
        self.masks = evg[:, :self.sites, 0, -1].T > 0.5  # (S, B)
        self.calls = 0
        return evg[..., :-1]

    def __call__(self, key, x, rate):
        keep = self.masks[self.calls].reshape(
            (x.shape[0],) + (1,) * (x.ndim - 1))
        self.calls += 1
        return jnp.where(keep, x / (1.0 - rate), 0.0)


class ConstReplayDropPath:
    """``drop_path`` with the same keep masks (S, B) at every call of a
    step: the masks of the step's one trace."""

    def __init__(self, masks):
        self.masks = masks
        self.calls = 0

    def __call__(self, key, x, rate):
        keep = jnp.asarray(self.masks[self.calls]).reshape(
            (x.shape[0],) + (1,) * (x.ndim - 1))
        self.calls += 1
        return jnp.where(keep, x / (1.0 - rate), 0.0)


SCHEDULE = (1e-3, 1e-5, 1, 3, 2)  # update 0 at lr 0, then warm, then cosine


def _jax_tx(v, num_layers, backbone_type, clip, layer_decay=0.75):
    return joptim.build_optimizer(
        v["params"], learning_rate=joptim.cosine_warmup_schedule(*SCHEDULE),
        weight_decay=0.05, betas=(0.9, 0.999), layer_decay=layer_decay,
        num_layers=num_layers, backbone_type=backbone_type, clip_grad=clip)


def _jax_state(jhub, v, tx):
    params = jax.tree.map(jnp.copy, v["params"])
    # TrainState.create's eager tx.init, jitted (the layer-decay chain has
    # an op a leaf), and committed to the device as the step's outputs
    # are: one ``tx`` and committed inputs make one compile for all calls
    return jax.device_put(JTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.copy, v.get("batch_stats", {})),
        opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=jhub.apply),
        jax.devices()[0])


def compiled(jitted, *args):
    """JAX's ``jitted`` function compiled for ``args`` under
    ``JAX_STEP_COMPILE``."""
    return jitted.lower(*args).compile(compiler_options=JAX_STEP_COMPILE)


def _port_state(hub, num_layers, backbone_type, clip, layer_decay=0.75):
    return TrainState(hub, toptim.build_optimizer(
        hub, weight_decay=0.05, betas=(0.9, 0.999), layer_decay=layer_decay,
        num_layers=num_layers, backbone_type=backbone_type),
        toptim.cosine_warmup_schedule(*SCHEDULE), clip_grad=clip)


# A dense trajectory holds each parameter tensor by the root mean square
# of its deviation from JAX's, within DENSE_UPDATE_REL of the root mean
# square of JAX's own update of it: a tensor left unchanged, or moved
# the other way, is off by all of it, whatever its scale; and each
# component within Adam's bound of two steps' size. The steps are
# ill-conditioned at these sizes (the heads' BatchNorms normalise a
# pooled map of a few values a channel, and Adam makes a component whose
# gradient is set by the last digits of its sums a step of either sign):
# measured, the deviation is at most 8e-4 of the update with
# ``HEAD_WIDTH`` heads, but 2e-2 after a change of rounding in one
# LayerNorm's forward and 3e-2 with the full heads
DENSE_UPDATE_REL = 0.1

# Adam's first updates are lr * m / (sqrt(v) + eps): a component whose
# gradient is near eps moves by a part of a step set by the gradient's last
# digits, so parameters after the steps get 1e-3 of the steps' size beside
# their share of their scale (the Swin port tests' rule)
ADAM_SLACK = 1e-3


def _zero_gradient(name: str, shape) -> slice | None:
    """The part of a parameter whose gradient is zero up to rounding,
    which Adam scales to a step of either sign: the key third of a qkv
    bias (softmax ignores it); a dense head's conv bias, which the
    BatchNorm after it removes in training; and Swin-ECDDP's ``norm0`` and
    ``norm1`` biases, whose stages feed only the UPerHead's lateral 1x1
    convs and BatchNorms, which remove a shift of a channel as well."""
    if name.endswith("attn.qkv.bias"):
        return slice(shape[0] // 3, 2 * shape[0] // 3)
    if name.endswith("conv_layer.bias") or name in (
            "backbone.norm0.bias", "backbone.norm1.bias"):
        return slice(None)
    return None


def _rms(a) -> float:
    return float(np.sqrt((np.asarray(a, np.float64) ** 2).mean()))


def _check_params(hub, jstate, rel, before=None):
    """Every parameter within ``rel`` of its scale (and 1e-3 of the steps'
    size) of JAX's after the steps, the zero-gradient parts within two
    steps' size; with ``before`` (the exported parameters before the
    steps: a dense trajectory) each tensor's RMS deviation within
    ``DENSE_UPDATE_REL`` of the RMS of JAX's update of it and each
    component within two steps' size instead. Every BatchNorm statistic
    within ``rel`` of its scale."""
    want = export_torch_state_dict(jstate.params, jstate.batch_stats)
    lr_sum = sum(toptim.cosine_warmup_schedule(*SCHEDULE)(i)
                 for i in range(3))
    for n, p in hub.named_parameters():
        got, w = p.detach().numpy().astype(np.float64), want[n].copy()
        sl = _zero_gradient(n, got.shape)
        if before is not None:
            d, u = got - w, w - before[n]
            assert np.abs(d).max() <= 2 * lr_sum, n
            if sl is not None:
                d[sl] = u[sl] = 0.0
            assert _rms(d) <= DENSE_UPDATE_REL * _rms(u), (
                n, _rms(d) / max(_rms(u), 1e-30))
            continue
        if sl is not None:
            assert np.abs(got[sl] - w[sl]).max() <= 2 * lr_sum, n
            got[sl] = w[sl] = 0.0
        tol = rel * np.abs(w).max() + ADAM_SLACK * lr_sum
        assert np.abs(got - w).max() <= tol, (n, rel_err(got, w))
    for k, buf in hub.named_buffers():
        if "running_" in k:
            assert rel_err(buf.numpy(), want[k]) <= rel, k
    return want


def cls_trajectory(monkeypatch, hub, jhub, v, batches, *, sites: int,
                   num_layers: int = 12, backbone_type: str = "vit",
                   preprocess=None, jpreprocess=None):
    """3 ``make_cls_train_step`` updates of ``hub`` and of JAX's twin
    ``jhub`` (variables ``v``) on ``batches`` (``evg``, ``label``,
    ``keep``), drop-path masks replayed, label smoothing 0.1, the clip at
    5 and layer decay 0.75; ``preprocess``/``jpreprocess`` map ``evg``
    first on each side. Loss, grad norm and accuracy at each step within
    1e-4, then every parameter within 1e-4 of its scale."""
    replay = BatchReplayDropPath(sites)
    monkeypatch.setattr(jlayers, "drop_path", replay)
    jstate = _jax_state(jhub, v, _jax_tx(v, num_layers, backbone_type, 5.0))
    state = _port_state(hub, num_layers, backbone_type, 5.0)

    def jpre(evg):
        evg = replay.preprocess(evg)
        return evg if jpreprocess is None else jpreprocess(evg)

    jstep = j_make_cls(jhub, smoothing=0.1, preprocess_fn=jpre)
    step = make_cls_train_step(hub, smoothing=0.1, preprocess_fn=preprocess)
    for i, b in enumerate(batches):
        args = (jstate, {"evg": jnp.asarray(replay.pack(b["evg"], b["keep"])),
                         "label": jnp.asarray(b["label"])},
                jax.random.key(i))
        if i == 0:
            jstep = compiled(jstep, *args)
        jstate, jm = jstep(*args)
        assert replay.calls == sites
        tm = step(state, {"evg": t(b["evg"]), "label": t(b["label"], True),
                          "drop_path_keep": t(b["keep"])})
        for k in ("loss", "grad_norm", "acc1"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_REL, err_msg=f"{i} {k}")
    assert state.step == len(batches)
    _check_params(hub, jstate, STEP_REL)
    return state


def semseg_trajectory(monkeypatch, hub, jhub, v, batches, keep, *,
                      num_classes: int, backbone_type: str = "vit"):
    """3 ``make_semseg_train_step`` updates of the dense hub and of its
    JAX twin on ``batches`` (``evg``, ``label``), the same drop-path keep
    masks ``keep`` (S, B) at every step (JAX's compiled step holds the
    masks of its one trace), no clip and no layer decay (the CLIs'
    defaults; the cls trajectories and ``check_layer_decay`` hold the
    scales): the losses at
    each step within 1e-4, then the parameters as ``DENSE_UPDATE_REL``'s
    note says and every BatchNorm statistic within 1e-4 of its scale."""
    monkeypatch.setattr(jlayers, "drop_path", ConstReplayDropPath(keep))
    jstate = _jax_state(jhub, v, _jax_tx(v, 12, backbone_type, None,
                                         layer_decay=1.0))
    state = _port_state(hub, 12, backbone_type, None, layer_decay=1.0)
    jstep = j_make_semseg(jhub, num_classes=num_classes)
    step = make_semseg_train_step(hub, num_classes=num_classes)
    for i, b in enumerate(batches):
        args = (jstate, {"evg": jnp.asarray(b["evg"]),
                         "label": jnp.asarray(b["label"])},
                jax.random.key(i))
        if i == 0:
            jstep = compiled(jstep, *args)
        jstate, jm = jstep(*args)
        tm = step(state, {"evg": t(b["evg"]), "label": t(b["label"]),
                          "drop_path_keep": t(keep)})
        for k in ("loss", "decode_ce", "decode_dice"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_REL, err_msg=f"{i} {k}")
    assert state.step == len(batches)
    _check_params(hub, jstate, STEP_REL,
                  before=export_torch_state_dict(v["params"],
                                                 v.get("batch_stats")))
    return state
