"""The port's CUDA kernels against their plain versions on the card, at
shapes the main paths do not reach: tails in every tiled dimension of the
conv GEMM, the teacher's widths, short and odd T, strided q/k/v views, fully
padded rows, the attention backward (K3, K4) with and without dropout, and
its determinism. Skipped where there is no CUDA card. On a machine
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


BWD_CASES = [(2, 1, 2, 40), (2, 63, 3, 40), (3, 65, 2, 64), (2, 130, 12, 40)]


def _attention_inputs(case, dtype, dev, seed):
    """q, k, v as strided views into one (B, T, 3, H, D) tensor, a ragged
    mask with one fully padded row, and an output gradient."""
    b, t, h, d = case
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
    q, k, v = qkv[:, :, 0] * d ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    mask = (torch.arange(t)[None, :] >= lengths[:, None]).to(dev)
    mask[-1] = True
    dout = torch.randn(b, t, h, d, generator=g).to(dev, dtype)
    return q, k, v, mask, dout


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_backward_matches_plain(dev, case, dtype, dropout_p):
    """K2 (with and without dropout), K3 and K4 against the plain versions on
    the same keep mask: ragged tails (T = 1, 63, 65), D = 64, strided views.
    The fully padded row has exactly zero gradients."""
    q, k, v, mask, dout = _attention_inputs(case, dtype, dev, seed=sum(case))
    seed = (0xDEADBEEF, 12345) if dropout_p else None
    _build.reset_launches()
    out, lse = fa.flash_attention(q, k, v, mask, dropout_p=dropout_p, seed=seed,
                                  return_lse=True)
    want, want_lse = fa.attention_plain(q, k, v, mask, dropout_p, seed)
    rows = ~mask.all(-1)
    _close(out[rows], want[rows], dtype)
    _close(lse[rows], want_lse[rows], torch.float32)
    grads = fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, dropout_p, seed)
    wants = fa.attention_bwd_plain(q, k, v, mask, out, lse, dout, dropout_p, seed)
    for got, ref in zip(grads, wants):
        _close(got[rows], ref[rows], dtype)
        assert (got[~rows] == 0).all()
    fwd = fa.KERNEL_DROPOUT if dropout_p else fa.KERNEL
    assert _build.LAUNCHES == {fwd: 1, fa.KERNEL_DQ: 1, fa.KERNEL_DKV: 1}


def test_attention_backward_is_deterministic(dev):
    """Each gradient element is summed by one thread in a fixed order: two
    backward runs are bit-identical."""
    q, k, v, mask, dout = _attention_inputs((3, 299, 12, 40), torch.bfloat16, dev, seed=0)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    runs = []
    for _ in range(2):
        out = fa.flash_attention(qs, ks, vs, mask, dropout_p=0.1, seed=(1, 2))
        runs.append(torch.autograd.grad(out, (qs, ks, vs), dout))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_positional_conv_bf16_at_the_teachers_width(dev):
    """cuDNN's bf16 grouped conv at C = 768, groups 16, k = 128 against the
    same conv in fp32 on the card: within bf16 rounding."""
    from fithubert_tpu_torch.ops.conv import PositionalConv

    g = torch.Generator().manual_seed(0)
    pc = PositionalConv(768, 128, 16, device=dev)
    with torch.no_grad():
        pc._modules["0"].weight_v.copy_(torch.randn(768, 48, 128, generator=g) * 0.01)
        x = torch.randn(2, 300, 768, generator=g).to(dev)
        want = pc(x)
        got = pc(x.bfloat16()).float()
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    assert rel < 2e-2, rel
