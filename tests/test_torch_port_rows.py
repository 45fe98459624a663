"""The row and column reductions of the K1/K2/K4/K5 backward
(eventpretrain_tpu_torch/csrc/ln_bwd.cu) on the CPU: the planner that cuts
a kernel's rows into ranges for the card, the plain twins of the kernels'
launch contract (each range's partial sums, then the ordered sum) against
the plain LayerNorm backward, JAX's LayerNorm VJP and the plain column sum,
and the wrappers' refusals.

Everything here is PyTorch (and JAX) on the CPU at small sizes; the
kernels themselves are held against the same plain versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.ops.pallas_common import ln_forward as jax_ln_forward
from eventpretrain_tpu_torch.ops import common as cm

from tests._port_threads import one_torch_thread  # noqa: F401

EPS = 1e-6
# the card's block slots at each kernel: 132 SMs x 2 (LayerNorm backward)
# or x 8 (column sum), and smaller and odd cards
SLOTS = (1, 2, 7, 66, 132, 264, 1056)
MS = (1, 5, 8, 31, 64, 100, 257, 3001, 3136, 12544)


def _t(rng, *shape, dtype=torch.float32, std=1.0):
    return torch.from_numpy(rng.normal(size=shape) * std).to(dtype)


def _ln_case(rng, m, c, dtype):
    return dict(
        x=_t(rng, m, c, dtype=dtype),
        g=torch.from_numpy(1.0 + 0.1 * rng.normal(size=c)).float(),
        dy=_t(rng, m, c, dtype=dtype),
        d_yln=_t(rng, m, c),
    )


# ------------------------------------------------------------ the planner


@pytest.mark.parametrize("tiles,min_rows", [(1, cm.ROW_WARPS),
                                            (3, cm.COLSUM_MIN_ROWS),
                                            (8, cm.COLSUM_MIN_ROWS)])
def test_plan_covers_every_row_once_in_order(tiles, min_rows):
    for m in MS:
        for slots in SLOTS:
            plan = cm.plan_row_ranges(m, slots, tiles, min_rows)
            bounds = plan.bounds(m)
            assert len(bounds) == plan.ranges
            assert bounds[0][0] == 0 and bounds[-1][1] == m
            for (a, b), (c, _) in zip(bounds, bounds[1:]):
                assert b == c  # contiguous, in order
            assert all(b > a for a, b in bounds)  # none empty
            assert all(b - a == plan.rows for a, b in bounds[:-1])
            # one wave (no more blocks than the card holds at once), and
            # no range shorter than min_rows where M allows
            assert plan.ranges <= max(1, slots // tiles)
            assert plan.ranges <= cm.ROW_MAX_RANGES
            assert plan.rows >= min(min_rows, m)
            # the groups cover the ranges, each step about sqrt(ranges)
            assert plan.group * plan.groups >= plan.ranges
            assert (plan.groups - 1) * plan.group < plan.ranges
            assert plan.group * plan.group >= plan.ranges
            # each step adds at most 16 rows: one batch of loads
            assert plan.group <= 16 and plan.groups <= 16


def test_plan_fills_the_card_at_the_main_path_shapes():
    """At the encoder's M = 3136 every SM of an H100 gets a block, at
    every main-path shape of the LayerNorm backward (two block slots an
    SM) and of the column sums (eight)."""
    for m, c in ((3136, 768), (12544, 512), (12544, 384)):
        plan = cm.plan_row_ranges(m, 2 * cm.H100_SMS)
        assert plan.ranges >= cm.H100_SMS
        for n in (c, 3 * c, 4 * c):
            tiles = -(-n // cm.COLSUM_TILE)
            plan = cm.plan_row_ranges(m, 8 * cm.H100_SMS, tiles,
                                      cm.COLSUM_MIN_ROWS)
            assert plan.ranges * tiles >= cm.H100_SMS, (m, n)


def test_plan_rejects_empty_inputs():
    for args in ((0, 132), (5, 0), (5, 132, 0), (5, 132, 1, 0)):
        with pytest.raises(ValueError):
            cm.plan_row_ranges(*args)


def test_scratch_and_counters_follow_the_plan():
    plan = cm.plan_row_ranges(12544, 264)
    assert plan == cm.RowPlan(256, 49, 16) and plan.groups == 16
    assert cm.row_scratch_shape(plan, 2, 512) == (2, 256 + 16, 512)
    assert cm.row_counter_count(plan) == 17
    plan = cm.plan_row_ranges(3136, 1056, 9, cm.COLSUM_MIN_ROWS)
    assert cm.row_scratch_shape(plan, 1, 2304) == (
        1, plan.ranges + plan.groups, 2304)
    assert cm.row_counter_count(plan, 9) == 9 * (plan.groups + 1)


# ------------------------------------------------ the ordered sum's order


@pytest.mark.parametrize("m,slots", [(1, 132), (37, 5), (100, 9),
                                     (3001, 264)])
def test_ordered_row_sum_adds_in_the_planned_order(m, slots):
    """The plain twin adds the ranges' f32 partial sums in the kernels'
    order, bit for bit: the ranges of a group in order, then the groups in
    order (numpy f32, one addition at a time)."""
    rng = np.random.default_rng(m)
    t = rng.normal(size=(m, 24)).astype(np.float32) * 10 ** rng.integers(
        -3, 4, size=(m, 1)).astype(np.float32)
    plan = cm.plan_row_ranges(m, slots)
    got = cm.ordered_row_sum(torch.from_numpy(t), plan).numpy()
    parts = [torch.from_numpy(t[a:b]).sum(0).numpy()
             for a, b in plan.bounds(m)]
    groups = []
    for first in range(0, plan.ranges, plan.group):
        acc = np.zeros(24, np.float32)
        for p in parts[first:first + plan.group]:
            acc = (acc + p).astype(np.float32)
        groups.append(acc)
    want = np.zeros(24, np.float32)
    for g in groups:
        want = (want + g).astype(np.float32)
    np.testing.assert_array_equal(got, want)


# ----------------------------------- the launch contract's plain twins


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,c,slots", [
    (3001, 64, 264),   # ragged M, the narrowest width the gate admits
    (200, 384, 264),   # ViT-S's width, ranges of one warp's 8 rows
    (100, 768, 7),     # the widest width, a few long ranges
    (5, 512, 264),     # M smaller than one range
])
def test_ln_backward_contract_matches_the_plain_backward(dtype, m, c,
                                                         slots):
    a = _ln_case(np.random.default_rng(c + m), m, c, dtype)
    plan = cm.plan_row_ranges(m, slots)
    dx, dg, db = cm.ln_backward_launch_reference(a["x"], a["g"], EPS,
                                                 a["dy"], a["d_yln"], plan)
    wdx, wdg, wdb = cm.ln_backward_reference(a["x"], a["g"], EPS, a["dy"],
                                             a["d_yln"])
    assert dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    # dx is computed row by row in both: equal; the column sums are the
    # same f32 values added in another order
    assert torch.equal(dx, wdx)
    for got, want in ((dg, wdg), (db, wdb)):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("m,c", [(64, 128), (300, 768)])
def test_ln_backward_contract_matches_jax_layernorm_vjp(m, c):
    """The same f32 inputs through JAX's LayerNorm (pallas_common.ln_forward,
    the TPU kernels' statistics) and its VJP: dx = dy + the VJP through x,
    dgamma and dbeta the VJP through the parameters."""
    rng = np.random.default_rng(7)
    x, dy, d_yln = (rng.normal(size=(m, c)).astype(np.float32)
                    for _ in range(3))
    g = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)

    def ln(x_, g_, b_):
        return jax_ln_forward(x_, g_, b_, EPS)[0]

    _, vjp = jax.vjp(ln, jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    jdx, jdg, jdb = (np.asarray(v) for v in vjp(jnp.asarray(d_yln)))
    plan = cm.plan_row_ranges(m, 264)
    dx, dg, db = cm.ln_backward_launch_reference(
        torch.from_numpy(x), torch.from_numpy(g), EPS, torch.from_numpy(dy),
        torch.from_numpy(d_yln), plan)
    np.testing.assert_allclose(dx.numpy(), dy + jdx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dg.numpy(), jdg, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(db.numpy(), jdb, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,n,slots", [
    (3001, 384, 1056),   # ragged M, a half tile
    (100, 2048, 1056),   # M smaller than one range of every tile
    (12544, 512, 1056),  # the decoder's dbo / db2
    (77, 8, 3),          # the narrowest N, a few ranges
])
def test_colsum_contract_matches_the_plain_column_sum(m, n, slots):
    x = _t(np.random.default_rng(n), m, n, dtype=torch.bfloat16)
    tiles = -(-n // cm.COLSUM_TILE)
    plan = cm.plan_row_ranges(m, slots, tiles, cm.COLSUM_MIN_ROWS)
    got = cm.colsum_launch_reference(x, plan)
    want = x.float().sum(0).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (n,)
    # the same f32 values added in another order, rounded once: at most one
    # bf16 step apart (2^-8 of the value's binade), plus f32 order noise
    # near zero
    step = torch.ldexp(torch.ones(n), torch.frexp(want.float()).exponent - 8)
    assert bool(((got.float() - want.float()).abs() <= step + 1e-3).all())


# ------------------------------------------------- the wrappers refuse


def test_wrappers_refuse_cpu_tensors():
    a = _ln_case(np.random.default_rng(0), 8, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="cuda"):
        cm.ln_backward(a["x"], a["g"], EPS, a["dy"], a["d_yln"])
    with pytest.raises(ValueError, match="cuda"):
        cm.colsum(a["x"])
    with pytest.raises(ValueError, match="cuda"):
        cm.ln_rows(a["x"], a["g"], a["g"], EPS)


@pytest.mark.parametrize("c", [96, 100, 832, 1024])
def test_ln_backward_refuses_widths_outside_the_gate(c):
    a = _ln_case(np.random.default_rng(1), 8, c, torch.bfloat16)
    with pytest.raises(ValueError, match="C % 64 == 0"):
        cm.ln_backward(a["x"], a["g"], EPS, a["dy"], a["d_yln"])


def test_colsum_refuses_rows_it_cannot_read_16_bytes_at_a_time():
    x = torch.zeros((4, 12), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cm.colsum(x)
