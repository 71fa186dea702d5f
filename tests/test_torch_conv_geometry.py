"""The host-side geometry of the bf16 conv-layer GEMM (K1 and K6's up pass,
fithubert_tpu_torch/ops/kernels/conv_frontend.py): the two strided views of
a layer's input that the kernel hands TMA as its A operand
(``a_operand_view``), and the width rule it raises on (``check_widths``).
On the CPU the views are taken with ``torch.as_strided`` on the input's own
storage, which refuses a view that reaches past it, and the GEMM on them is
held against ``conv_stack_plain``."""

import numpy as np
import pytest
import torch

from fithubert_tpu_torch.ops.kernels import conv_frontend as cf

# the tap rule k <= 2s with k in {1, 2, 3} and s in {1, 2}
LAYERS = [(1, 1), (2, 1), (1, 2), (2, 2), (3, 2)]


def _a_operand(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """(B, T_out, k * C_in): the kernel's A operand, read through its views."""
    b, t_in, c_in = x.shape
    t_out = (t_in - k) // s + 1
    view = cf.a_operand_view(t_in, c_in, k, s)
    flat = x.reshape(-1)
    groups = [(0, view.cols0), (view.off1, view.cols1)]
    return torch.cat([flat.as_strided((b, t_out, cols), (view.batch_stride, view.row_stride, 1),
                                      off) for off, cols in groups if cols > 0], dim=-1)


@pytest.mark.parametrize("t_in", [37, 38], ids=["odd_T", "even_T"])
@pytest.mark.parametrize("k, s", LAYERS, ids=[f"k{k}s{s}" for k, s in LAYERS])
def test_a_operand_view_matches_conv_stack_plain(k, s, t_in):
    """gelu(A Wt^T) over the two views equals the strided conv + GELU, fp32:
    the same products summed in another order (5e-6 + 1e-5)."""
    rng = np.random.default_rng(10 * k + s + t_in)
    b, c_in, d = 3, 8, 5
    x = torch.from_numpy(rng.standard_normal((b, t_in, c_in)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c_in, d)) / np.sqrt(k * c_in))
                         .astype(np.float32))
    a = _a_operand(x, k, s)
    wt = w.permute(2, 0, 1).reshape(d, k * c_in)  # (C_out, k, C_in), as the kernel takes it
    got = cf.gelu_exact(a @ wt.t())
    want = cf.conv_stack_plain(x, [w], ((d, k, s),))
    assert got.shape == want.shape == (b, cf.out_len(t_in, ((d, k, s),)), d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-6, rtol=1e-5)


@pytest.mark.parametrize("t_in", [37, 38], ids=["odd_T", "even_T"])
@pytest.mark.parametrize("k, s", LAYERS, ids=[f"k{k}s{s}" for k, s in LAYERS])
def test_a_operand_views_stay_in_their_batch_row(k, s, t_in):
    """No view overlaps itself (its columns fit in a row stride), the two
    groups make up K = k * C_in, and the last element either reads for a
    valid frame lies inside X[b]: a frame tile never reads the next batch
    row, nor past the buffer for the last one, even at odd T_in where the
    last pair row is partial."""
    c_in = 64
    t_out = (t_in - k) // s + 1
    v = cf.a_operand_view(t_in, c_in, k, s)
    assert v.cols0 + v.cols1 == k * c_in
    assert v.cols0 <= v.row_stride and v.cols1 <= v.row_stride
    assert v.batch_stride == t_in * c_in
    for off, cols in ((0, v.cols0), (v.off1, v.cols1)):
        if cols:
            last = off + (t_out - 1) * v.row_stride + cols - 1
            assert last < v.batch_stride
    # the kernel's K chunks are 64 wide and must not straddle the groups
    assert v.cols0 % 64 == 0 and v.cols1 % 64 == 0 and v.off1 % 8 == 0


def test_check_widths_rule():
    """bf16 takes widths that are multiples of 64 (one 128-byte TMA row per
    K chunk, inside one tap group); fp32 multiples of 4. The rule raises
    before any launch."""
    cf.check_widths(128, ((256, 1, 1), (512, 2, 2)), torch.bfloat16, "K1")
    cf.check_widths(12, ((40, 3, 2),), torch.float32, "K1")
    for c0, spec, dtype in ((96, ((256, 1, 1),), torch.bfloat16),
                            (128, ((256, 1, 1), (48, 2, 2)), torch.bfloat16),
                            (6, ((8, 1, 1),), torch.float32)):
        with pytest.raises(ValueError, match="multiple of"):
            cf.check_widths(c0, spec, dtype, "K1")
