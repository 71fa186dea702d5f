"""The positional conv's wrapper (``ops/kernels/pos_conv.py``) on the CPU:
its plain version against the positional conv as ``F.conv1d`` computed it
before the kernel (a grouped conv of ``padding=k // 2``, SamePad's drop,
the input gradient as a forward conv of flipped kernels), forward and
gradients; the bf16 kernel's packed weights against the conv they encode;
and which path ``PositionalConv`` and ``SameConv1d`` take on the CPU. The
kernel itself runs in ``test_torch_kernels_gpu.py``."""

import pytest
import torch
import torch.nn.functional as F

from fithubert_tpu_torch.ops import conv as conv_mod
from fithubert_tpu_torch.ops.activations import gelu_exact
from fithubert_tpu_torch.ops.conv import PositionalConv, SameConv1d, _GroupedConv1d
from fithubert_tpu_torch.ops.kernels import pos_conv as pc

# (C, groups, k, T): the smoke width at odd and even T, FitHuBERT's student
# (30 channels a group) and the 768-wide teachers at short T
CASES = [(48, 4, 16, 37), (48, 4, 16, 40), (480, 16, 128, 21), (768, 16, 128, 19)]
IDS = ["smoke-odd", "smoke-even", "fithubert", "hubert"]


def _weights(c, groups, k, seed):
    g = torch.Generator().manual_seed(seed)
    mod = PositionalConv(c, k, groups)
    with torch.no_grad():
        conv = mod._modules["0"]
        conv.weight_v.copy_(torch.randn(conv.weight_v.shape, generator=g) * 0.05)
        conv.weight_g.copy_(torch.rand(conv.weight_g.shape, generator=g) + 0.5)
        conv.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return mod, g


def _before(mod, x):
    """PositionalConv's forward as it ran before the kernel: ``F.conv1d``
    through ``_GroupedConv1d`` in the (B, C, T) layout, summed in fp32 on
    the CPU, SamePad's trailing frame dropped."""
    conv = mod._modules["0"]
    v = conv.weight_v
    norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
    w = (v * (conv.weight_g / norm)).to(x.dtype)
    b = conv.bias.to(x.dtype)
    xt = x.transpose(1, 2)
    if x.dtype != torch.float32:
        xt, w, b = xt.float(), w.float(), b.float()
    y = _GroupedConv1d.apply(xt, w, b, mod.kernel_size // 2, mod.groups).to(x.dtype)
    if mod.kernel_size % 2 == 0:
        y = y[:, :, :-1]
    return gelu_exact(y.transpose(1, 2))


def _run(fn, mod, x, cot):
    x = x.detach().requires_grad_()
    y = fn(mod, x) if fn is _before else mod(x)
    params = [p for _n, p in sorted(mod.named_parameters())]
    grads = torch.autograd.grad(y, [x] + params, cot)
    return y.detach(), grads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_equals_the_conv_before_the_kernel(case, dtype):
    """Output, input gradient and the parameters' gradients equal the
    F.conv1d path's bit for bit: the same convs in the same precision."""
    c, groups, k, t = case
    mod, g = _weights(c, groups, k, seed=c + k + t)
    x = torch.randn(2, t, c, generator=g).to(dtype)
    cot = torch.randn(2, t, c, generator=g).to(dtype)
    y_new, g_new = _run(None, mod, x, cot)
    y_old, g_old = _run(_before, mod, x, cot)
    assert y_new.shape == (2, t, c) and y_new.dtype == dtype
    assert torch.equal(y_new, y_old)
    for a, b in zip(g_new, g_old):
        assert torch.equal(a, b)


def _packed_conv(x, wpk, bias, pad, cg):
    """The bf16 kernel's sum over the packed weights, in fp32: for each
    group and tap j, the window shifted by j rows (zeros outside [0, T))
    times the tap's unpacked (cgp, cgp) slab, its padded outputs cut."""
    b, t, c = x.shape
    groups, k, cgp = wpk.shape[0], wpk.shape[1], wpk.shape[2] * 8
    slabs = wpk.permute(0, 1, 2, 4, 3, 5).reshape(groups, k, cgp, cgp).float()  # (g, k, o, i)
    # the window of each group as the kernel reads it: cgp channels from g * cg on,
    # the next group's channels (or zeros past C) beyond cg
    xp = F.pad(x.float(), (0, cgp, pad, k))
    y = torch.zeros(b, t, groups, cgp)
    for gi in range(groups):
        win = xp[:, :, gi * cg: gi * cg + cgp]
        for j in range(k):
            y[:, :, gi] += win[:, j: j + t] @ slabs[gi, j].t()
    y = y[..., :cg].reshape(b, t, c)
    return y if bias is None else y + bias.float()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_packed_weights_encode_the_conv(case):
    """pack_weights' (groups, k, cgp / 8, cgp / 8, 8, 8) layout, read back
    as the kernel's per-tap GEMM over the shifted window, gives the plain
    conv, forward (pad k // 2) and input gradient (flipped weights, pad
    k - 1 - k // 2); the stray channels of the next group meet zero weights."""
    c, groups, k, t = case
    g = torch.Generator().manual_seed(7 * c + t)
    x = torch.randn(2, t, c, generator=g)
    w = torch.randn(c, c // groups, k, generator=g) * 0.05
    bias = torch.randn(c, generator=g)
    cgp = pc.padded_group_width(c // groups)
    for wt, bt, pad in ((w, bias, k // 2), (pc.flipped(w, groups), None, k - 1 - k // 2)):
        wpk = pc.pack_weights(wt, groups)
        assert wpk.shape == (groups, k, cgp // 8, cgp // 8, 8, 8) and wpk.is_contiguous()
        got = _packed_conv(x, wpk, bt, pad, c // groups)
        want = pc.pos_conv_plain(x, wt, bt, pad)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_input_gradient_is_the_flipped_conv():
    """The input gradient (pos_conv of the cotangent over flipped weights)
    equals autograd through F.conv1d of padding k // 2 and SamePad's drop."""
    g = torch.Generator().manual_seed(3)
    c, groups, k, t = 48, 4, 16, 29
    x = torch.randn(2, t, c, generator=g).requires_grad_()
    w = torch.randn(c, c // groups, k, generator=g) * 0.1
    cot = torch.randn(2, t, c, generator=g)
    y = F.conv1d(x.transpose(1, 2), w, padding=k // 2, groups=groups)[:, :, :t].transpose(1, 2)
    (want,) = torch.autograd.grad(y, x, cot)
    got = pc.pos_conv_plain(cot, pc.flipped(w, groups), None, k - 1 - k // 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_group_widths_pad_to_the_kernels():
    assert [pc.padded_group_width(n) for n in (12, 16, 30, 48, 64)] == [16, 16, 32, 48, 64]
    with pytest.raises(ValueError):
        pc.padded_group_width(80)


def test_positional_conv_routes_through_the_plain_version(monkeypatch):
    """On the CPU PositionalConv runs pos_conv_plain, forward and input
    gradient, and never _GroupedConv1d; SameConv1d's grouped conv still runs
    _GroupedConv1d."""
    calls = {"plain": 0, "grouped": 0}
    plain, grouped = pc.pos_conv_plain, _GroupedConv1d.apply

    def counted_plain(*args):
        calls["plain"] += 1
        return plain(*args)

    def counted_grouped(*args):
        calls["grouped"] += 1
        return grouped(*args)

    monkeypatch.setattr(pc, "pos_conv_plain", counted_plain)
    monkeypatch.setattr(conv_mod._GroupedConv1d, "apply", counted_grouped)
    mod, g = _weights(48, 4, 16, seed=1)
    x = torch.randn(2, 20, 48, generator=g).requires_grad_()
    mod(x).sum().backward()
    assert calls == {"plain": 2, "grouped": 0}
    same = SameConv1d(48, 48, 7, padding=3, groups=4)
    same(x).sum().backward()
    assert calls == {"plain": 2, "grouped": 1}


def test_wrapper_refuses_a_weight_that_does_not_group_x():
    x = torch.randn(1, 5, 48)
    with pytest.raises(ValueError):
        pc.positional_conv(x, torch.randn(48, 10, 16), None, 4)
