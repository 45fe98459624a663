"""The two splats' launch plans and decompositions, and K1's backward gate,
on the CPU.

K3 (``ops/splat.py``) and K6 (``ops/splat_tiled.py``) run one device body
(``csrc/splat_core.cuh``): a plane of the grid in shared memory, its
channels cut over a thread-block cluster. The planner (``splat_plan``) and K3's route
(``splat_route``) are plain Python; the plain twins of the launches
(``splat_launch_reference``, ``splat_tiled_launch_reference``) replay the
kernel's channels per CTA, bin-range skips, rows per CTA and crop in PyTorch
and are held against the JAX package's ``splat_mxu`` and
``splat_mxu_tiled`` in interpret mode. K1's backward gate is walked against
the LayerNorm backward's own width check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.ops.pallas_voxel import splat_mxu, splat_mxu_tiled
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.models import layers
from eventpretrain_tpu_torch.ops import common as cm
from eventpretrain_tpu_torch.ops import fused_attn_layer as ka
from eventpretrain_tpu_torch.ops.splat import (
    CLUSTER_ROUTE_MIN_CTAS,
    MAX_CLUSTER,
    SMEM_LIMIT,
    SplatPlan,
    splat_launch_reference,
    splat_plan,
    splat_route,
    splat_smem_bytes,
)
from eventpretrain_tpu_torch.ops.splat_tiled import (
    splat_tiled_launch_reference,
    splat_tiled_plan,
)

# splat_mxu carries the f32 weights as a bf16 hi+lo pair (~1e-5 relative
# to the weights, a few weights per cell); the replays sum in exact f32
SPLAT_ATOL = 1e-4

# ------------------------------------------------------------ the planner


def _check_plan(plan, rows, cols, channels):
    n, cp, groups = plan.cluster, plan.cp, plan.groups
    assert 1 <= n <= MAX_CLUSTER
    # the groups cover every channel once, the CTAs every channel of a
    # group once, and every CTA holds one at least
    width = -(-channels // groups)
    assert (groups - 1) * width < channels <= groups * width
    assert (n - 1) * cp < width <= n * cp and cp <= 4
    mapped = splat_smem_bytes(rows, cols, cp, cols * channels)
    assert plan.smem_bytes == (
        mapped if groups == 1 and mapped <= SMEM_LIMIT
        else splat_smem_bytes(rows, cols, cp))
    assert plan.smem_bytes <= SMEM_LIMIT


SWEEP_HW = [(h, w) for h in (1, 16, 56, 100, 128, 260, 440)
            for w in (1, 24, 128, 346, 640)]


@pytest.mark.parametrize("channels", [1, 2, 3, 5, 10])
def test_splat_plan_fits_the_cluster_and_covers_every_channel(channels):
    for h, w in SWEEP_HW:
        plan = splat_plan(h, w, channels)
        if plan is not None:
            _check_plan(plan, h, w, channels)
            assert plan.groups == 1
            # the smallest cluster that fits
            if plan.cluster > 1:
                assert splat_plan(h, w, channels,
                                  cluster=plan.cluster - 1) is None
        grouped = splat_tiled_plan(h, w, channels)
        if grouped is not None:
            _check_plan(grouped, h, w, channels)
        assert (grouped is None) == (h * w * 4 > SMEM_LIMIT)


@pytest.mark.parametrize("h,w,c,route,cluster", [
    (128, 128, 5, "cluster", 2),   # N-Cars canvas: the served and cls batch
    (128, 128, 10, "cluster", 4),
    (128, 128, 2, "cluster", 1),
    (64, 64, 5, "cluster", 2),     # the semseg CLI's synthetic sensor:
    (64, 64, 4, "cluster", 1),     # a CTA holds at most 4 channels
    (260, 346, 5, "global", 0),    # MVSEC, untiled
    (440, 640, 5, "global", 0),    # DSEC, tiled_raster="off"
    (128, 128, 25, "global", 0),   # more channels than 8 CTAs hold
    (16, 16, 33, "global", 0),
])
def test_splat_route_takes_the_cluster_body_wherever_it_fits(h, w, c, route,
                                                             cluster):
    assert splat_route(128, h, w, c) == route
    plan = splat_plan(h, w, c)
    assert (plan is not None) == (route == "cluster")
    if plan is not None:
        assert plan.cluster == cluster
        # a batch whose clusters fill fewer than half the SMs goes global
        small = -(-CLUSTER_ROUTE_MIN_CTAS // plan.cluster) - 1
        assert splat_route(small, h, w, c) == "global"
        assert splat_route(small + 1, h, w, c) == "cluster"


def test_splat_route_sweep():
    for channels in (1, 2, 3, 5, 10, 25, 33):
        for h, w in SWEEP_HW:
            fits = any(splat_smem_bytes(h, w, -(-channels // n))
                       <= SMEM_LIMIT and -(-channels // n) <= 4
                       for n in range(1, MAX_CLUSTER + 1))
            assert splat_route(128, h, w, channels) == (
                "cluster" if fits else "global"), (h, w, channels)


def test_k6_plans_at_the_main_paths():
    five = splat_tiled_plan(128, 128, 5)  # DSEC's 5-bin voxel grid
    assert (five.cluster, five.cp, five.groups) == (2, 3, 1)
    two = splat_tiled_plan(128, 128, 2)  # the 2-bin count image
    assert (two.cluster, two.cp, two.groups) == (1, 2, 1)
    assert splat_plan(128, 128, 5) == five  # K3 at the N-Cars canvas


@pytest.mark.parametrize("tile", [(128, 128), (64, 256), (240, 240),
                                  (32, 32), (1, 58112), (58112, 1)])
def test_k6_plans_every_tile_the_first_port_took(tile):
    """The first port took any tile whose one-channel f32 plane fitted a
    block; the cluster body takes each at every channel count."""
    th, tw = tile
    assert th * tw * 4 <= SMEM_LIMIT
    for channels in (1, 2, 5, 10, 33, 64):
        plan = splat_tiled_plan(th, tw, channels)
        assert plan is not None, (tile, channels)
        _check_plan(plan, th, tw, channels)


# ------------------------------------------- K3's decomposition against JAX


def _k3_inputs(rng, b, c, e, h, w):
    """Strays up to 3 past every edge; sample 1 has every event out of
    frame, sample 2 all-zero weights (two kinds of empty sample)."""
    y = rng.integers(-3, h + 3, (b, e)).astype(np.int32)
    x = rng.integers(-3, w + 3, (b, e)).astype(np.int32)
    wts = rng.normal(size=(b, c, e)).astype(np.float32)
    y[1] = h + 1
    wts[2] = 0.0
    return y, x, wts


@pytest.mark.parametrize("cluster", [None, 2, 3, 5])
def test_splat_launch_reference_matches_jax_splat_mxu(cluster):
    b, c, e, h, w = 4, 5, 1301, 40, 36
    rng = np.random.default_rng(7)
    y, x, wts = _k3_inputs(rng, b, c, e, h, w)
    want = np.asarray(splat_mxu(jnp.asarray(y), jnp.asarray(x),
                                jnp.asarray(wts), height=h, width=w,
                                interpret=True))
    plan = splat_plan(h, w, c, cluster=cluster)
    got = splat_launch_reference(torch.from_numpy(y), torch.from_numpy(x),
                                 torch.from_numpy(wts), height=h, width=w,
                                 plan=plan)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SPLAT_ATOL)
    assert np.abs(got[1:3].numpy()).max() == 0.0


# ------------------------------------------- K6's decomposition against JAX

H, W, NB, CHUNK = 200, 300, 5, 256  # 2x3 tiles of 128x128, the last row
# of tiles holding 72 of its 128 rows


@pytest.fixture(scope="module")
def tiled_case():
    """Bucketed events: sample 0 with strays (past H inside the last tile
    row, past W, negative, and coordinates of another tile in the first
    chunk), sample 1 empty, sample 2 in the left half only (its right
    tiles hold pads alone); random weights on every slot, pads included,
    and random bin ranges; JAX's kernel with and without them."""
    rng = np.random.default_rng(5)
    cap = 3000
    ev = np.zeros((3, cap, 4), np.float32)
    counts = np.array([cap, 0, 1400], np.int32)
    for i, n in enumerate(counts):
        wmax = W if i != 2 else 128
        ev[i, :n, 0] = rng.integers(0, wmax, n)
        ev[i, :n, 1] = rng.integers(0, H, n)
        ev[i, :n, 2] = np.sort(rng.random(n)).astype(np.float32)
        ev[i, :n, 3] = rng.integers(0, 2, n)
    ev[0, :60, 0] = rng.integers(-5, W + 40, 60)
    ev[0, :60, 1] = rng.integers(-5, 256 + 10, 60)
    out, table, _, _ = tnative.bucket_pack_event_batch(
        ev, counts, height=H, width=W, chunk=CHUNK)
    y = out[..., 1].astype(np.int32)
    x = out[..., 0].astype(np.int32)
    x[0, :CHUNK] = 290  # sample 0's first chunk is tile 0: strays
    y[0, :CHUNK] = 150
    e = y.shape[1]
    wts = rng.normal(size=(3, NB, e)).astype(np.float32)
    lo = rng.integers(0, NB, (3, e // CHUNK))
    br = np.stack([lo, np.minimum(lo + rng.integers(0, 3, lo.shape),
                                  NB - 1)], -1).astype(np.int32)
    want = {}
    for key, bins in (("full", None), ("bin_range", br)):
        want[key] = np.asarray(splat_mxu_tiled(
            jnp.asarray(y), jnp.asarray(x), jnp.asarray(wts),
            jnp.asarray(table), None if bins is None else jnp.asarray(bins),
            height=H, width=W, chunk=CHUNK, interpret=True))
    return y, x, wts, table, br, want


@pytest.mark.parametrize("bins", ["full", "bin_range"])
@pytest.mark.parametrize("pins", [
    {},                # K6's own plan: 2 CTAs of 3 and 2 channels
    {"cluster": 3},    # 2, 2 and 1
    {"cluster": 5},    # one channel a CTA
], ids=["own", "c3", "c5"])
def test_splat_tiled_launch_reference_matches_jax_kernel(tiled_case, bins,
                                                         pins):
    y, x, wts, table, br, want = tiled_case
    plan = splat_tiled_plan(128, 128, NB, **pins)
    got = splat_tiled_launch_reference(
        torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(wts),
        torch.from_numpy(table),
        torch.from_numpy(br) if bins == "bin_range" else None, height=H,
        width=W, chunk=CHUNK, plan=plan)
    np.testing.assert_allclose(got.numpy(), want[bins], rtol=0,
                               atol=SPLAT_ATOL)
    assert np.abs(got[1].numpy()).max() == 0.0
    assert np.abs(got[2, :, 128:].numpy()).max() == 0.0


def test_splat_tiled_launch_reference_in_channel_groups(tiled_case):
    """Plans of several channel groups (the planner's answer where a
    tile's channels do not fit a cluster of 8) write each group's channels
    and no other."""
    y, x, wts, table, br, want = tiled_case
    for groups, cluster in ((2, 1), (2, 2), (3, 1), (5, 1)):
        width = -(-NB // groups)
        plan = SplatPlan(cluster, -(-width // cluster), groups,
                         splat_smem_bytes(128, 128, -(-width // cluster)))
        got = splat_tiled_launch_reference(
            torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(wts),
            torch.from_numpy(table), torch.from_numpy(br), height=H,
            width=W, chunk=CHUNK, plan=plan)
        np.testing.assert_allclose(got.numpy(), want["bin_range"], rtol=0,
                                   atol=SPLAT_ATOL)


# ----------------------------------------------- F2: K1's backward gate


def test_k1_backward_gate_admits_only_widths_ln_backward_takes():
    """Every (L <= 256, C <= 2048, heads) that K1's backward gate admits
    passes ``ln_backward``'s own width check (CPU tensors are refused
    after it, for their device)."""
    widths = set()
    for c in range(8, 2049, 8):
        for h in range(1, c // 8 + 1):
            if c % h:
                continue
            for seq in range(1, 257):
                if ka.supports_fused_ln_attn_layer(seq, c, h, backward=True):
                    widths.add(c)
                    break
    assert widths and max(widths) == cm.LN_BWD_MAX_WIDTH
    for c in sorted(widths):
        x = torch.zeros((1, c), dtype=torch.bfloat16)
        g = torch.ones(c)
        with pytest.raises(ValueError, match="cuda"):
            cm.ln_backward(x, g, 1e-6, x, g[None])


@pytest.mark.parametrize("c,h", [(896, 14), (1024, 16), (1280, 16)])
def test_k1_gate_keeps_wide_forwards_and_closes_their_backward(c, h):
    assert ka.supports_fused_attn_layer(196, c, h, torch.bfloat16,
                                        backward=True)
    assert ka.supports_fused_ln_attn_layer(196, c, h, torch.bfloat16)
    assert not ka.supports_fused_ln_attn_layer(196, c, h, torch.bfloat16,
                                               backward=True)


def test_wide_vit_block_with_gradients_takes_the_plain_path(monkeypatch):
    """A bf16 ViTBlock(1024, 16) takes K1 for a forward without gradients
    and the plain composition when gradients are on (K1's backward would
    need the LayerNorm backward at C=1024)."""
    calls = []

    def k1(*args, **kwargs):
        calls.append(args[0].shape)
        return args[0]

    monkeypatch.setattr(layers, "fused_ln_attn_layer", k1)
    monkeypatch.setattr(layers, "fused_ln_mlp", lambda x, *a, **k: x)
    block = layers.ViTBlock(1024, 16, dtype=torch.bfloat16, device="cpu")
    block.eval()
    x = torch.randn((1, 4, 1024), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        block(x)
    assert calls == [(1, 4, 1024)]
    xg = x.clone().requires_grad_()
    y = block(xg)
    y.float().sum().backward()
    assert calls == [(1, 4, 1024)]  # no K1 call with gradients on
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
