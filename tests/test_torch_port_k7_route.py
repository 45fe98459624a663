"""K7's two CUDA routes, decided on the CPU: which kernels ``fused_mha``
launches for a shape and its operands (``mha_route``), and that the plain
versions of K7 and of the K1/K4 attention core compute one function, which
is what lets one one-pass kernel body serve both.

Nothing here launches a kernel: ``mha_route`` and the operand descriptors
read shapes, strides and pointers, and the plain versions run on CPU
tensors.
"""

import numpy as np
import pytest
import torch

from eventpretrain_tpu_torch.ops.fused_attn_layer import (
    MAX_BLOCK_SMEM,
    attention_bwd_smem_bytes,
    attention_core_bwd_reference,
    attention_core_reference,
    attention_smem_bytes,
)
from eventpretrain_tpu_torch.ops.fused_mha import (
    _descriptor,
    fused_mha_bwd_reference,
    fused_mha_reference,
    mha_route,
    supports_fused_mha,
)

from tests._port_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
GRID_L = (1, 16, 49, 196, 255, 256, 257, 1024)
GRID_D = (8, 20, 24, 32, 64, 160, 168, 192, 256)


def _fits(l, d, backward):
    return (attention_smem_bytes(l, d) <= MAX_BLOCK_SMEM
            and (not backward
                 or attention_bwd_smem_bytes(l, d) <= MAX_BLOCK_SMEM))


def _routes(l, d, operands):
    """(forward route, backward route) of q, k, v and a contiguous do."""
    do = torch.zeros(operands[0].shape, dtype=BF16)
    return (mha_route(l, d, operands, backward=False),
            mha_route(l, d, (*operands, do), backward=True))


def _grid(backward):
    """Every (L, D) of the grid lies inside the gate and takes one route:
    "onepass" exactly where L <= 256, D % 8 == 0 and the core's shared
    memory fits in this direction."""
    for l in GRID_L:
        for d in GRID_D:
            assert supports_fused_mha(l, d)
            t = torch.zeros((1, l, 1, d), dtype=BF16)
            route = mha_route(l, d, (t,) * (4 if backward else 3), backward)
            assert route in ("onepass", "tiled")
            onepass = l <= 256 and d % 8 == 0 and _fits(l, d, backward)
            assert (route == "onepass") == onepass, (l, d, route)


def case_grid_forward():
    _grid(False)


def case_grid_backward():
    _grid(True)


def case_smem_corners():
    """At L=256 the forward's shared memory fits up to D=192 and the
    backward's up to D=160, so at D=192 the two directions part; at L=196,
    D=256 neither fits."""
    for l, d, want in ((256, 160, ("onepass", "onepass")),
                       (256, 192, ("onepass", "tiled")),
                       (256, 256, ("tiled", "tiled")),
                       (196, 256, ("tiled", "tiled"))):
        t = torch.zeros((2, l, 4, d), dtype=BF16)
        assert _routes(l, d, (t, t, t)) == want, (l, d)


def case_packed_slices():
    """The slices of a packed (B, L, 3, H, D) projection, as ``Attention``
    hands them over, at ViT-S's and the ViT-B encoder's head shapes."""
    for l, h, d in ((196, 12, 32), (196, 16, 32), (49, 12, 64)):
        qkv = torch.zeros((2, l, 3, h, d), dtype=BF16)
        assert _routes(l, d, qkv.unbind(2)) == ("onepass", "onepass")


def case_contiguous_operands():
    q, k, v = (torch.zeros((2, 196, 16, 32), dtype=BF16) for _ in range(3))
    assert _routes(196, 32, (q, k, v)) == ("onepass", "onepass")


def case_unreadable_rows():
    """A view offset by one element, a row stride that is not a multiple of
    8, and a column stride other than 1 take the tiled kernels."""
    b, l, h, d = 2, 49, 4, 32
    n = b * l * 3 * h * d
    flat = torch.zeros(n + 8, dtype=BF16)
    aligned = flat[8:].view(b, l, 3, h, d).unbind(2)
    assert _routes(l, d, aligned) == ("onepass", "onepass")
    shifted = flat[1:n + 1].view(b, l, 3, h, d).unbind(2)
    assert shifted[0].data_ptr() % 16 != 0
    assert _routes(l, d, shifted) == ("tiled", "tiled")
    odd_rows = torch.zeros((b, l, h * d + 4), dtype=BF16)[..., :h * d]
    q = odd_rows.unflatten(-1, (h, d))  # row stride h * d + 4
    assert _routes(l, d, (q, q, q)) == ("tiled", "tiled")
    cols = torch.zeros((b, l, d, h), dtype=BF16).transpose(-1, -2)
    assert _routes(l, d, (cols, cols, cols)) == ("tiled", "tiled")
    # a contiguous q beside an unreadable do: the backward alone is tiled
    q = torch.zeros((b, l, h, d), dtype=BF16)
    assert mha_route(l, d, (q, q, q, cols), backward=True) == "tiled"


ROUTE_CASES = [case_grid_forward, case_grid_backward, case_smem_corners,
               case_packed_slices, case_contiguous_operands,
               case_unreadable_rows]


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=[f.__name__[len("case_"):] for f in ROUTE_CASES])
def test_mha_route(case):
    case()


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16],
                         ids=["float32", "bfloat16"])
def test_core_and_k7_plain_versions_agree_bit_for_bit(dtype, direction):
    """``attention_core_reference`` (and its backward) on packed (B*L, 3C)
    qkv rows, and ``fused_mha_reference`` (and its backward) on the
    (B, L, H, D) slices of the same rows: the same products, softmax and
    rounding points in the same order, so the results are equal to the
    bit, in f32 and in bf16."""
    b, l, h, d = 2, 13, 3, 8
    c, scale = h * d, d ** -0.5
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.standard_normal((b * l, 3 * c)).astype(
        np.float32)).to(dtype)
    do = torch.from_numpy(rng.standard_normal((b * l, c)).astype(
        np.float32)).to(dtype)
    q, k, v = qkv.view(b, l, 3, h, d).unbind(2)
    if direction == "forward":
        core = attention_core_reference(qkv, b, l, h, scale)
        k7 = fused_mha_reference(q, k, v, scale=scale)
        assert k7.dtype == core.dtype == dtype
        assert torch.equal(k7.reshape(b * l, c), core)
    else:
        core = attention_core_bwd_reference(qkv, do, b, l, h, scale)
        k7 = fused_mha_bwd_reference(q, k, v, do.view(b, l, h, d),
                                     scale=scale)
        packed = torch.stack(k7, dim=2).reshape(b * l, 3 * c)
        assert packed.dtype == core.dtype == dtype
        assert torch.equal(packed, core)


@pytest.mark.parametrize("n", [1, 3])
def test_descriptors_of_packed_slices_are_the_cores_rows(n):
    """K7's one-pass route reads each (B, L, H, D) slice of packed (B*L,
    n*C) rows through its descriptor (pointer; batch, row and head
    strides); the attention core's kernels compute the same pointers and
    strides from qkv alone (slice i at C*i elements, row stride n*C, batch
    stride L*n*C, head stride D), so one body sees the same rows."""
    b, l, h, d = 2, 5, 3, 8
    c = h * d
    x = torch.zeros((b * l, n * c), dtype=BF16)
    views = x.view(b, l, n, h, d).unbind(2)
    ptr = x.data_ptr()
    for i, view in enumerate(views):
        assert _descriptor(view) == [ptr + 2 * c * i, l * n * c, n * c, d]
