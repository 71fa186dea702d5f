"""The port's CUDA kernels against their plain versions on the card, at
shapes the serving path does not reach: tails in every tiled dimension of
the conv GEMM, the teacher's widths, short and odd T, strided q/k/v views,
and fully padded rows. Skipped where there is no CUDA card. On a machine
with one (and without JAX, which the suite's conftest imports):

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch

from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
from fithubert_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.gpu

# |kernel - plain| <= atol + rtol * |plain|. fp32: summation order only.
# bf16: both sides compute in fp32 from the same bf16 operands and round
# once, so they differ by at most one bf16 step (2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    assert bool((err <= atol + rtol * want.float().abs()).all()), err.max().item()


CONV_CASES = [
    # K = 72 and 80 (not multiples of the 32-deep tile), N = 40 / 48 / 16,
    # M = B * T_out not a multiple of the 128-row tile
    (2, 301, 24, ((40, 3, 2), (48, 2, 2), (16, 1, 1))),
    # the student's first layers, one output frame short of a tile
    (3, 97, 128, ((256, 1, 1), (256, 3, 2))),
    # the teacher's widths (C0 = 512)
    (1, 1000, 512, ((512, 3, 2), (512, 2, 2))),
]


@pytest.mark.parametrize("prefix", [True, False], ids=["gn_prefix", "no_prefix"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=["tails", "student", "teacher"])
def test_conv_stack_layers_match_plain(dev, case, dtype, prefix):
    b, t, c0, spec = case
    g = torch.Generator().manual_seed(t)
    x = (torch.randn(b, t, c0, generator=g) * 0.5).to(dev, dtype)
    ws, c = [], c0
    for (d, k, _s) in spec:
        ws.append((torch.randn(k, c, d, generator=g) * (2.0 / (k * c)) ** 0.5).to(dev, dtype))
        c = d
    ss = (None, None)
    if prefix:
        gamma = 1 + 0.1 * torch.randn(c0, generator=g)
        ss = cf.gn_scale_shift(x, gamma.to(dev), (0.1 * torch.randn(c0, generator=g)).to(dev))
    _build.reset_launches()
    out = cf.conv_stack(x, ws, spec, *ss)
    assert _build.LAUNCHES[cf.KERNEL] == len(spec)
    assert tuple(out.shape) == (b, cf.out_len(t, spec), spec[-1][0])
    h = x  # layer by layer, each from the plain version's input
    for i, (w, layer) in enumerate(zip(ws, spec)):
        lss = ss if i == 0 else (None, None)
        got = cf.conv_stack(h, [w], (layer,), *lss)
        h = cf.conv_stack_plain(h, [w], (layer,), *lss)
        _close(got, h, dtype)


def test_conv_stack_rejects_widths_the_kernel_does_not_take(dev):
    x = torch.randn(1, 50, 12, device=dev, dtype=torch.bfloat16)
    w = torch.randn(1, 12, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        cf.conv_stack(x, [w], ((16, 1, 1),))


ATTN_CASES = [(2, 1, 1, 40), (3, 65, 2, 40), (2, 200, 3, 64), (1, 130, 12, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_matches_plain_on_strided_views(dev, case, dtype):
    b, t, h, d = case
    g = torch.Generator().manual_seed(t + d)
    # q, k, v as views into one fused (B, T, 3, H, D) projection: non-unit
    # strides along T, read in place by the kernel
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
    q, k, v = qkv[:, :, 0] * d ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
    assert not k.is_contiguous()
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    mask = (torch.arange(t)[None, :] >= lengths[:, None]).to(dev)
    if b > 1:
        mask[-1] = True  # a fully padded row
    _build.reset_launches()
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True)
    assert _build.LAUNCHES[fa.KERNEL] == 1
    want, want_lse = fa.attention_plain(q, k, v, mask)
    rows = ~mask.all(-1)
    _close(out[rows], want[rows], dtype)
    _close(lse[rows], want_lse[rows], torch.float32)
    assert (out[~rows] == 0).all() and (lse[~rows] == fa.NEG_INF).all()


def test_flash_attention_rejects_head_sizes_it_is_not_built_for(dev):
    q = torch.randn(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head sizes"):
        fa.flash_attention(q, q, q)
