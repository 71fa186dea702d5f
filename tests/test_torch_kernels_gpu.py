"""The port's CUDA kernels against their plain versions on the card, at
shapes the main paths do not reach: tails in every tiled dimension of the
conv GEMM (odd T_in, B > 1, so the last batch row's tail is read; fp32 at
narrow widths), the teacher's widths, the bf16 GroupNorm prefix kernel,
widths the bf16 conv GEMM does not take (rejected), K6's
up pass against K1's output bit for bit, short and odd T at the attention tiles'
edges, strided q/k/v views, misaligned views (rejected), fully padded
rows, the bf16 forward against its plain emulation (attention_fwd_tiles_plain),
its register count, its determinism and its replay in a CUDA graph with new
seed words, the attention backward (the delta pre-pass, the fused wgmma pass at
D = 16-128 against its plain version, its register count, the dQ sum bit for bit,
the whole backward against the plain formulas) with and without dropout,
its determinism and its replay in a CUDA graph; the seeded dropout (K5) bit for bit, forward and backward;
the conv-stack backward (K6) on ragged T with k < s, k = s and k > s layers
and on the whole student stack at odd T_in with B > 1, its determinism, and
its selection as the card's default backward, down to a train step; the
positional conv at every config's group width, forward and input gradient,
its determinism, its launch count and its replay in a CUDA graph.
Skipped where there is no CUDA card. On a machine
with one (and without JAX, which the suite's conftest imports):

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import pytest
import torch

from fithubert_tpu_torch.ops.kernels import _build
from fithubert_tpu_torch.ops.kernels import conv_frontend as cf
from fithubert_tpu_torch.ops.kernels import dropout as kd
from fithubert_tpu_torch.ops.kernels import flash_attention as fa
from fithubert_tpu_torch.ops.kernels import pos_conv as kp
from fithubert_tpu_torch.ops.kernels.philox import seed_tensor

pytestmark = pytest.mark.gpu

# |kernel - plain| <= atol + rtol * |plain|. fp32: summation order only.
# bf16: both sides sum in fp32 from the same bf16 operands; the attention
# kernels also round P (and K4 dS) to bf16 before the second product, as the
# TPU kernels do, which averages out to about one bf16 step (2^-8 relative).
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


def _by_dtype(cases, narrow):
    """(case, dtype) params: every case in fp32 and bf16, and the ``narrow``
    cases in fp32 alone, whose FMA bodies take widths that are multiples of
    4 where the bf16 GEMM takes multiples of 64."""
    params = [pytest.param(case, torch.float32, id=f"{name}-fp32") for name, case in narrow]
    for name, case in cases:
        params += [pytest.param(case, dt, id=f"{name}-{dn}")
                   for dn, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16))]
    return params


CONV_CASES = [
    # odd T_in with B > 1 (the partial last pair row of every batch row), N =
    # 64 (half a 128-channel tile), T_out not a multiple of the 128-frame tile
    ("tails", (2, 301, 64, ((64, 3, 2), (128, 2, 2), (64, 1, 1)))),
    # the student's first layers, one output frame short of a tile
    ("student", (3, 97, 128, ((256, 1, 1), (256, 3, 2)))),
    # the teacher's widths (C0 = 512)
    ("teacher", (2, 1001, 512, ((512, 3, 2), (512, 2, 2)))),
]
# fp32 only: K = 72 and 80 (not multiples of the FMA GEMM's 16-deep tile),
# N = 40 / 48 / 16, M = B * T_out not a multiple of its 64-row tile
CONV_NARROW = [("narrow", (2, 301, 24, ((40, 3, 2), (48, 2, 2), (16, 1, 1))))]


@pytest.mark.parametrize("prefix", [True, False], ids=["gn_prefix", "no_prefix"])
@pytest.mark.parametrize("case, dtype", _by_dtype(CONV_CASES, CONV_NARROW))
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
    # bf16 runs the prefix as a kernel of its own; fp32 applies it to each A tile
    want = {cf.KERNEL: len(spec)}
    if prefix and dtype == torch.bfloat16:
        want[cf.KERNEL_PREFIX] = 1
    assert _build.LAUNCHES == want
    assert tuple(out.shape) == (b, cf.out_len(t, spec), spec[-1][0])
    h = x  # layer by layer, each from the plain version's input
    for i, (w, layer) in enumerate(zip(ws, spec)):
        lss = ss if i == 0 else (None, None)
        got = cf.conv_stack(h, [w], (layer,), *lss)
        h = cf.conv_stack_plain(h, [w], (layer,), *lss)
        _close(got, h, dtype)


@pytest.mark.parametrize("shape", [(2, 301, 64), (3, 97, 128), (2, 1001, 512)],
                         ids=["tails", "student", "teacher"])
def test_gn_prefix_matches_plain(dev, shape):
    """The bf16 prefix kernel against ``_prefix``, one launch; both take the
    affine map in fp32 and round the GELU once, so they differ at most where
    the two GELUs straddle a bf16 rounding boundary."""
    g = torch.Generator().manual_seed(shape[1])
    x = (torch.randn(*shape, generator=g) * 2.0).to(dev, torch.bfloat16)
    scale, shift = ((1 + 0.3 * torch.randn(shape[0], shape[2], generator=g)).to(dev, x.dtype),
                    (0.3 * torch.randn(shape[0], shape[2], generator=g)).to(dev, x.dtype))
    _build.reset_launches()
    got = cf.gn_prefix_cuda(x, scale, shift)
    assert _build.LAUNCHES == {cf.KERNEL_PREFIX: 1}
    _close(got, cf._prefix(x, scale, shift), torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        cf.gn_prefix_cuda(x.float(), scale.float(), shift.float())


@pytest.mark.parametrize("c0, d", [(12, 64), (96, 64), (64, 96)], ids=["c0_12", "c0_96", "d_96"])
def test_conv_stack_rejects_widths_the_kernel_does_not_take(dev, c0, d):
    """The bf16 GEMM reads 64-element K chunks (128-byte swizzled TMA rows)
    that must lie in one tap group: every width a multiple of 64. The
    kernels' launchers refuse other widths (``conv_stack`` and
    ``conv_stack_bwd_cuda`` pad them first)."""
    x = torch.randn(2, 50, c0, device=dev, dtype=torch.bfloat16)
    w = torch.randn(1, c0, d, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        cf._conv_stack_kernels(x, [w], ((d, 1, 1),), None, None)
    with pytest.raises(ValueError, match="multiple of 64"):
        cf._conv_stack_bwd_kernels(x, [w], torch.randn(2, 50, d, device=dev), ((d, 1, 1),))


@pytest.mark.parametrize("case", [c for _n, c in CONV_CASES[1:]], ids=["student", "teacher"])
def test_k6_up_pass_equals_k1_output(dev, case):
    """K6's up pass launches K1's GEMM on the same tile geometry: its a_next
    is K1's y bit for bit."""
    b, t, c0, spec = case
    g = torch.Generator().manual_seed(7)
    h = (torch.randn(b, t, c0, generator=g) * 0.5).to(dev, torch.bfloat16)
    for (d, k, s) in spec:
        w = (torch.randn(k, h.shape[-1], d, generator=g) * (2.0 / (k * h.shape[-1])) ** 0.5
             ).to(dev, torch.bfloat16)
        y = cf.conv_stack(h, [w], ((d, k, s),))
        _z, a_next = cf.up_pass_cuda(h, w, (d, k, s))
        assert torch.equal(a_next, y)
        h = y


ATTN_CASES = [(2, 1, 1, 40), (3, 65, 2, 40), (2, 200, 3, 64), (1, 130, 12, 40),
              # the tensor-core tiles' edges at the teacher's D = 64: one k16
              # row block, one past it, one whole 64-row tile, the teacher's T
              (2, 16, 3, 64), (2, 17, 3, 64), (2, 64, 3, 64), (2, 599, 12, 64)]


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


def _head_size_36(dev):
    q = torch.randn(1, 8, 2, 36, device=dev)
    return q, q, q


def _misaligned_rows(dev):
    # rows 41 elements apart, starting one element in: no row on 16 bytes
    q = torch.randn(1, 8, 2, 41, device=dev, dtype=torch.bfloat16)[..., 1:]
    return q, q, q


@pytest.mark.parametrize("inputs, match", [(_head_size_36, "head sizes"),
                                           (_misaligned_rows, "16-byte")],
                         ids=["head_size_36", "misaligned_bf16_rows"])
def test_flash_attention_rejects_what_the_kernels_do_not_take(dev, inputs, match):
    """The launchers refuse what the kernels do not read (flash_attention
    pads the head size and copies misaligned rows first)."""
    q, k, v = inputs(dev)
    with pytest.raises(ValueError, match=match):
        fa._fwd_kernel(q, k, v, None, 0.0, None)
    if q.dtype == torch.bfloat16:
        lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=dev)
        dout = torch.zeros(q.shape, dtype=q.dtype, device=dev)
        with pytest.raises(ValueError, match=match):
            fa.bwd_fused_cuda(q, k, v, None, lse, dout, lse)


# the forward against attention_fwd_tiles_plain: the same arithmetic in
# another fp32 summation order, which can flip P's bf16 rounding near a
# boundary (well under 1e-3 of the output) and the output's own rounding by
# one step (2^-8 relative); chip_smoke.FWD_TILES_TOL
FWD_TILES_TOL = (1e-3, 2 ** -8)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("case", [(2, 1, 2, 40), (3, 65, 2, 64), (2, 130, 3, 16),
                                  (2, 299, 4, 40), (2, 599, 3, 64), (2, 200, 2, 80),
                                  (1, 129, 2, 128)], ids=lambda c: "x".join(map(str, c)))
def test_forward_matches_its_tiles_plain_version(dev, case, dropout_p):
    """The bf16 kernel against the plain emulation of its arithmetic, on the
    same keep mask: strided views, ragged masks, a fully padded row."""
    q, k, v, mask, _dout = _attention_inputs(case, torch.bfloat16, dev, seed=5 * sum(case))
    seed = seed_tensor(77, 78, dev) if dropout_p else None
    out, lse = fa.flash_attention(q, k, v, mask, dropout_p=dropout_p, seed=seed,
                                  return_lse=True)
    want, want_lse = fa.attention_fwd_tiles_plain(q, k, v, mask, dropout_p, seed)
    rows = ~mask.all(-1)
    err = (out[rows].float() - want[rows].float()).abs()
    assert bool((err <= FWD_TILES_TOL[0] + FWD_TILES_TOL[1] * want[rows].float().abs()).all()), \
        err.max().item()
    _close(lse[rows], want_lse[rows], torch.float32)
    assert (out[~rows] == 0).all() and (lse[~rows] == fa.NEG_INF).all()


def test_forward_is_built_at_the_register_count_of_its_plan(dev):
    """Every instantiation of the bf16 forward, at every compiled head size,
    with the registers its setmaxnreg plan moves between the warpgroups
    (ptxas's report of this build), and none spills."""
    _build.load("flash_attention")
    fwd = [r for r in _build.ptxas_usage("flash_attention") if r[0].startswith("flash_fwd_wgmma")]
    assert len(fwd) == 2 * len(fa.HEAD_DIMS)
    for name, regs, stores, loads in fwd:
        assert regs == fa.FWD_REGS[int(name.split("<")[1].split(",")[0])], (name, regs)
        assert stores == loads == 0, (name, stores, loads)


@pytest.mark.parametrize("case, p", [((12, 299, 12, 40), 0.1), ((2, 599, 4, 64), 0.0)],
                         ids=["d40_p0.1", "d64_p0"])
def test_forward_is_deterministic(dev, case, p):
    """Every sum of the forward has a fixed order: two runs are bit-identical."""
    q, k, v, mask, _dout = _attention_inputs(case, torch.bfloat16, dev, seed=6)
    seed = seed_tensor(13, 14, dev) if p else None
    runs = [fa.flash_attention(q, k, v, mask, dropout_p=p, seed=seed, return_lse=True)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [(3, 299, 12, 40), (2, 130, 4, 64)], ids=["d40", "d64"])
def test_forward_replays_in_a_cuda_graph_with_new_seed_words(dev, case):
    """K2 captured in a CUDA graph reads its seed from device memory when it
    runs: a replay after new words are written equals an eager call with
    those words, bit for bit, and differs from the old words' output."""
    q, k, v, mask, _dout = _attention_inputs(case, torch.bfloat16, dev, seed=8)
    seed = seed_tensor(31, 32, dev)

    def fwd():
        return fa.flash_attention(q, k, v, mask, dropout_p=0.1, seed=seed, return_lse=True)

    old = fwd()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fwd()
    seed.copy_(seed_tensor(33, 34, dev))
    graph.replay()
    torch.cuda.synchronize()
    eager = fwd()
    for a, b in zip(static, eager):
        assert torch.equal(a, b)
    assert not torch.equal(static[0], old[0])


BWD_CASES = [(2, 1, 2, 40), (2, 63, 3, 40), (3, 65, 2, 64), (2, 130, 12, 40),
             # the tensor-core tiles' edges at D = 64, and the student's T
             (2, 17, 3, 64), (2, 64, 3, 64), (2, 299, 4, 40)]


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
    seed = seed_tensor(0xDEADBEEF, 12345, dev) if dropout_p else None
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
    bwd = fa.BWD_KERNELS if dtype == torch.bfloat16 else (
        fa.KERNEL_BWD_PREP, fa.KERNEL_DQ_F32, fa.KERNEL_DKV_F32)
    assert _build.LAUNCHES == {fwd: 1, **{name: 1 for name in bwd}}


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_past_65535_batch_heads(dev, dtype, dropout_p):
    """B x H = 65536 at T = 1: every kernel takes its (tile, b * H + h)
    blocks on grid x, whose y would stop at 65535. The forward and the
    backward against the plain versions, and rows b < 16 bit for bit
    against a call on those rows alone (their Philox words do not move)."""
    q, k, v, mask, dout = _attention_inputs((4096, 1, 16, 40), dtype, dev, seed=65536)
    seed = seed_tensor(0xDEADBEEF, 12345, dev) if dropout_p else None

    def both(q, k, v, mask, dout):
        out, lse = fa.flash_attention(q, k, v, mask, dropout_p=dropout_p, seed=seed,
                                      return_lse=True)
        return (out, lse) + tuple(fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout,
                                                     dropout_p, seed))

    got = both(q, k, v, mask, dout)
    out, lse, *grads = got
    want, want_lse = fa.attention_plain(q, k, v, mask, dropout_p, seed)
    rows = ~mask.all(-1)
    _close(out[rows], want[rows], dtype)
    _close(lse[rows], want_lse[rows], torch.float32)
    for g, ref in zip(grads, fa.attention_bwd_plain(q, k, v, mask, out, lse, dout, dropout_p,
                                                    seed)):
        _close(g[rows], ref[rows], dtype)
        assert (g[~rows] == 0).all()
    head = both(q[:16], k[:16], v[:16], mask[:16], dout[:16])
    for a, b in zip(got, head):
        assert torch.equal(a[:16], b)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("case", [(2, 63, 3, 40), (3, 130, 2, 64), (2, 65, 2, 16),
                                  (2, 200, 2, 80), (1, 129, 2, 128)],
                         ids=lambda c: "x".join(map(str, c)))
def test_fused_backward_matches_its_plain_version(dev, case, dropout_p):
    """Each bf16 launch against its plain version on the same inputs: the
    pre-pass (fp32 sums in another order), the fused pass's dQ partials, dK
    and dV (attention_bwd_tiles_plain, the kernel's roundings), and the dQ
    sum bit for bit."""
    q, k, v, mask, dout = _attention_inputs(case, torch.bfloat16, dev, seed=7 * sum(case))
    seed = seed_tensor(5, 6, dev) if dropout_p else None
    out, lse = fa.flash_attention(q, k, v, mask, dropout_p=dropout_p, seed=seed,
                                  return_lse=True)
    delta = fa.bwd_prep_cuda(out, dout)
    _close(delta, fa.bwd_prep_plain(out, dout), torch.float32)
    got = fa.bwd_fused_cuda(q, k, v, mask, lse, dout, delta, dropout_p, seed)
    want = fa.attention_bwd_tiles_plain(q, k, v, mask, lse, dout, delta, dropout_p, seed)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, torch.bfloat16)
    assert torch.equal(fa.dq_sum_cuda(got[0]), fa.dq_sum_plain(got[0], torch.bfloat16))


def test_fused_backward_is_built_at_the_register_count_of_its_plan(dev):
    """Every instantiation of the fused pass, at every compiled head size,
    with the registers its setmaxnreg plan moves between the warpgroups
    (ptxas's report of this build), and none spills at D <= 64."""
    _build.load("flash_attention_bwd")
    fused = [r for r in _build.ptxas_usage("flash_attention_bwd")
             if r[0].startswith("flash_bwd_fused")]
    assert len(fused) == 2 * len(fa.HEAD_DIMS)
    for name, regs, stores, loads in fused:
        assert regs == fa.BWD_FUSED_REGS, (name, regs)
        if int(name.split("<")[1].split(",")[0]) <= 64:
            assert stores == loads == 0, (name, stores, loads)


@pytest.mark.parametrize("case", [(12, 299, 12, 40), (2, 599, 4, 64)], ids=["d40", "d64"])
def test_dq_kernel_is_deterministic(dev, case):
    """The fused backward in bf16: each dQ partial is summed by one
    warpgroup in a fixed key order and the partials in key-tile order, no
    atomics; two backwards are bit-identical."""
    q, k, v, mask, dout = _attention_inputs(case, torch.bfloat16, dev, seed=3)
    seed = seed_tensor(11, 12, dev)
    out, lse = fa.flash_attention(q, k, v, mask, dropout_p=0.1, seed=seed, return_lse=True)
    runs = [fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, 0.1, seed) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [(3, 299, 12, 40), (2, 130, 4, 64)], ids=["d40", "d64"])
def test_attention_backward_replays_in_a_cuda_graph(dev, case):
    """The bf16 backward (pre-pass, fused pass, dQ sum) captured in a CUDA
    graph and replayed twice equals the eager backward bit for bit; a new
    seed written into the captured seed tensor changes the replay's mask."""
    q, k, v, mask, dout = _attention_inputs(case, torch.bfloat16, dev, seed=4)
    seed = seed_tensor(21, 22, dev)
    out, lse = fa.flash_attention(q, k, v, mask, dropout_p=0.1, seed=seed, return_lse=True)
    eager = fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, 0.1, seed)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, 0.1, seed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fa._flash_bwd_cuda(q, k, v, mask, out, lse, dout, 0.1, seed)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(static, eager):
            assert torch.equal(a, b)
    seed.copy_(seed_tensor(23, 24, dev))
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(static[2], eager[2])


@pytest.mark.parametrize("case", [(3, 299, 12, 40), (2, 599, 4, 64)], ids=["d40", "d64"])
def test_attention_backward_is_deterministic(dev, case):
    """Each gradient element is summed by one thread (dQ) or one warp (dK,
    dV) in a fixed order: two backward runs are bit-identical."""
    q, k, v, mask, dout = _attention_inputs(case, torch.bfloat16, dev, seed=0)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    runs = []
    for _ in range(2):
        out = fa.flash_attention(qs, ks, vs, mask, dropout_p=0.1, seed=seed_tensor(1, 2, dev))
        runs.append(torch.autograd.grad(out, (qs, ks, vs), dout))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_positional_conv_bf16_at_the_teachers_width(dev):
    """The positional conv kernel in bf16 at C = 768, groups 16, k = 128
    (through PositionalConv) against the kernel's fp32 body on the card:
    within bf16 rounding."""
    from fithubert_tpu_torch.ops.conv import PositionalConv

    g = torch.Generator().manual_seed(0)
    pc = PositionalConv(768, 128, 16, device=dev)
    with torch.no_grad():
        pc._modules["0"].weight_v.copy_(torch.randn(768, 48, 128, generator=g) * 0.01)
        x = torch.randn(2, 300, 768, generator=g).to(dev)
        _build.reset_launches()
        want = pc(x)
        got = pc(x.bfloat16()).float()
    assert _build.LAUNCHES == {kp.KERNEL: 2}
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    assert rel < 2e-2, rel


# (B, T, C, groups, k): every config's positional conv (serving's and the
# train cells' shapes; FitHuBERT's 30-wide groups; the large teacher's 64;
# the smoke student's 12 and teacher's 16 at k = 16), and T from 1 frame to
# past a block's 256, odd and even
POS_CONV_CASES = [
    (32, 849, 768, 16, 128), (12, 599, 768, 16, 128), (12, 599, 480, 16, 128),
    (8, 599, 768, 16, 128), (3, 301, 1024, 16, 128), (4, 49, 48, 4, 16), (4, 24, 64, 4, 16),
    (2, 1, 768, 16, 128), (3, 64, 480, 16, 128), (2, 129, 768, 16, 128), (2, 257, 48, 4, 16),
]


def _pos_conv_inputs(case, dtype, dev, seed):
    b, t, c, groups, k = case
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=g).to(dev, dtype)
    w = (torch.randn(c, c // groups, k, generator=g) * (c // groups * k) ** -0.5).to(dev, dtype)
    bias = torch.randn(c, generator=g).to(dev, dtype)
    return x, w, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", POS_CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_pos_conv_matches_plain(dev, case, dtype):
    """The kernel against its plain version, forward (pad k // 2, with the
    bias) and input gradient (flipped weights, pad k - 1 - k // 2)."""
    x, w, bias = _pos_conv_inputs(case, dtype, dev, seed=sum(case))
    groups, k = case[3], case[4]
    for wt, bt, pad in ((w, bias, k // 2), (kp.flipped(w, groups), None, k - 1 - k // 2)):
        _close(kp.pos_conv_cuda(x, wt, bt, pad), kp.pos_conv_plain(x, wt, bt, pad), dtype)


def test_pos_conv_is_deterministic_and_counted(dev):
    """Forward and input gradient through positional_conv: bit for bit the
    same over two runs, one launch each; the weight and bias gradients
    (cuDNN) within bf16 rounding of the fp32 body's."""
    x, w, bias = _pos_conv_inputs((8, 599, 768, 16, 128), torch.bfloat16, dev, seed=2)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(dev, x.dtype)
    runs = []
    for _ in range(2):
        leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
        _build.reset_launches()
        y = kp.positional_conv(*leaves, 16)
        assert _build.LAUNCHES == {kp.KERNEL: 1}
        grads = torch.autograd.grad(y, leaves, cot)
        assert _build.LAUNCHES == {kp.KERNEL: 2}
        runs.append((y, *grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    leaves = [t.detach().float().requires_grad_() for t in (x, w, bias)]
    want = torch.autograd.grad(kp.positional_conv(*leaves, 16), leaves, cot.float())
    for got, ref in zip(runs[0][2:], want[1:]):
        rel = (torch.linalg.vector_norm(got.float() - ref) / torch.linalg.vector_norm(ref)).item()
        assert rel < 2e-2, rel


def test_pos_conv_replays_in_a_cuda_graph(dev):
    """Forward and input gradient captured in a CUDA graph and replayed
    equal the eager launches bit for bit, also after new inputs are copied
    into the captured ones."""
    case = (3, 599, 480, 16, 128)
    x, w, bias = _pos_conv_inputs(case, torch.bfloat16, dev, seed=8)
    wt = kp.flipped(w, 16)

    def both():
        return kp.pos_conv_cuda(x, w, bias, 64), kp.pos_conv_cuda(x, wt, None, 63)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = both()
    for seed in (8, 9):
        x2, w2, b2 = _pos_conv_inputs(case, torch.bfloat16, dev, seed=seed)
        for dst, src in ((x, x2), (w, w2), (bias, b2), (wt, kp.flipped(w2, 16))):
            dst.copy_(src)
        eager = both()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(static, eager):
            assert torch.equal(a, b)


DROPOUT_CASES = [(4, 12, 299, 299), (3, 5, 77), (1, 1, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", DROPOUT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_seeded_dropout_is_bit_identical_to_plain(dev, shape, dtype):
    """K5 and seeded_dropout_plain draw the same Philox words and compute
    x * fp32(1/(1-p)) rounded once: exact equality, forward and backward."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).to(dev, dtype).requires_grad_()
    cot = torch.randn(shape, generator=g).to(dev, dtype)
    seed, p = seed_tensor(0xDEADBEEF, 0x12345678, dev), 0.1
    _build.reset_launches()
    y = kd.seeded_dropout(x, seed, p)
    (dx,) = torch.autograd.grad(y, x, cot)
    assert _build.LAUNCHES == {kd.KERNEL: 2}
    assert torch.equal(y, kd.seeded_dropout_plain(x.detach(), seed, p))
    assert torch.equal(dx, kd.seeded_dropout_plain(cot, seed, p))


def test_seeded_dropout_of_an_unaligned_view(dev):
    """A view whose start is not 16-byte aligned takes the element-wise
    path and draws the same mask."""
    big = torch.randn(4 * 1000 + 3, device=dev)
    x = big[3:]
    assert x.data_ptr() % 16 != 0
    seed = seed_tensor(5, 6, dev)
    assert torch.equal(kd.seeded_dropout(x, seed, 0.3), kd.seeded_dropout_plain(x, seed, 0.3))


# K6 against its plain version, norm-wise: fp32 sums the same products in
# another order (dW over up to ~10^5 frames); in bf16 that order can flip
# the rounding of z or dz by one step, which moves the gradient well below
# 1e-2 of its norm.
K6_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
STUDENT_STACK = ((256, 1, 1),) + ((256, 3, 2),) * 4 + ((512, 1, 1),) + ((512, 2, 2),) * 2
K6_CASES = [
    # ragged T, T_out and widths not multiples of the tiles, k > s, k = s,
    # k = s = 1 (bf16 widths are multiples of 64: K1's up pass takes no other)
    ("tails", (2, 301, 64, ((64, 3, 2), (128, 2, 2), (64, 1, 1)))),
    # k < s: the odd input rows get no gradient
    ("k_lt_s", (2, 257, 64, ((64, 1, 2), (128, 3, 2)))),
    # the student's widths
    ("student", (3, 397, 128, ((256, 1, 1), (256, 3, 2), (512, 1, 1), (512, 2, 2)))),
    # every layer shape of the student's stack, odd T_in with B > 1
    ("student_stack", (2, 1001, 128, STUDENT_STACK)),
]
# fp32 only: K and widths not multiples of the fp32 tiles (K = 72, 80; N =
# 40, 48, 16, 24), with k > s, k = s, k = s = 1 and k < s
K6_NARROW = [("narrow", (2, 301, 24, ((40, 3, 2), (48, 2, 2), (16, 1, 1)))),
             ("narrow_k_lt_s", (2, 257, 16, ((16, 1, 2), (24, 3, 2))))]


def _k6_inputs(case, dtype, dev, seed):
    b, t, c0, spec = case
    g = torch.Generator().manual_seed(seed)
    a0 = (torch.randn(b, t, c0, generator=g) * 0.5).to(dev, dtype)
    ws, c = [], c0
    for (d, k, _s) in spec:
        ws.append((torch.randn(k, c, d, generator=g) / (k * c) ** 0.5).to(dev, dtype))
        c = d
    cot = torch.randn(b, cf.out_len(t, spec), spec[-1][0], generator=g).to(dev, dtype)
    return a0, ws, cot, spec


@pytest.mark.parametrize("case, dtype", _by_dtype(K6_CASES, K6_NARROW))
def test_conv_stack_backward_matches_plain(dev, case, dtype):
    a0, ws, cot, spec = _k6_inputs(case, dtype, dev, seed=case[1])
    _build.reset_launches()
    da0, dws = cf.conv_stack_bwd_cuda(a0, ws, cot, spec)
    assert _build.LAUNCHES == {cf.KERNEL_BWD: 4 * len(spec)}
    want_da0, want_dws = cf.conv_stack_bwd_plain(a0, ws, cot, spec)
    for got, want in [(da0, want_da0)] + list(zip(dws, want_dws)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.isfinite(got).all()
        rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
        assert rel < K6_LIMIT[dtype], rel
    if spec[0][1] < spec[0][2]:  # k < s: rows 1, 3, 5, ... of a0 feed no output
        assert (da0[:, 1::2] == 0).all()


def test_conv_stack_backward_is_deterministic(dev):
    """No atomics: the dW chunks are summed in a fixed order, and every
    element of da is written by one thread. Two runs are bit-identical."""
    a0, ws, cot, spec = _k6_inputs(K6_CASES[3][1], torch.bfloat16, dev, seed=0)
    runs = [cf.conv_stack_bwd_cuda(a0, ws, cot, spec) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_conv_stack_switch_launches_k6_on_the_card(dev, monkeypatch):
    """Under FITHUBERT_CONV_BWD=pallas the autograd backward of conv_stack
    goes through K6 (and K1 for its up pass's forward is not relaunched)."""
    a0, ws, cot, spec = _k6_inputs(K6_CASES[0][1], torch.bfloat16, dev, seed=1)
    x = a0.clone().requires_grad_()
    monkeypatch.setenv("FITHUBERT_CONV_BWD", "pallas")
    out = cf.conv_stack(x, ws, spec)
    _build.reset_launches()
    out.backward(cot)
    assert _build.LAUNCHES == {cf.KERNEL_BWD: 4 * len(spec)}
    torch.testing.assert_close(x.grad.float(), cf.conv_stack_bwd_plain(a0, ws, cot, spec)[0],
                               rtol=0.0, atol=1e-2 * x.grad.float().abs().max().item())


@pytest.mark.parametrize("env, k6", [(None, True), ("pallas", True), ("xla", False)],
                         ids=["unset", "pallas", "xla"])
def test_conv_stack_backward_default_on_the_card(dev, monkeypatch, env, k6):
    """On CUDA tensors K6 is the default backward; FITHUBERT_CONV_BWD=xla
    selects the library recompute, which launches no K6 kernel."""
    a0, ws, cot, spec = _k6_inputs(K6_CASES[2][1], torch.bfloat16, dev, seed=2)
    if env is None:
        monkeypatch.delenv("FITHUBERT_CONV_BWD", raising=False)
    else:
        monkeypatch.setenv("FITHUBERT_CONV_BWD", env)
    x = a0.clone().requires_grad_()
    out = cf.conv_stack(x, ws, spec)
    _build.reset_launches()
    out.backward(cot)
    assert _build.LAUNCHES.get(cf.KERNEL_BWD, 0) == (4 * len(spec) if k6 else 0)
    assert torch.isfinite(x.grad.float()).all()


def test_train_step_runs_k6_with_the_variable_unset(dev, monkeypatch):
    """A bf16 Distiller step on the card (a narrow teacher and student whose
    conv widths suit the card's GEMMs) runs the student's conv-stack
    backward through K6 with FITHUBERT_CONV_BWD unset: 4 launches per layer
    after block 0, one fused backward per step."""
    from fithubert_tpu_torch import config as tc
    from fithubert_tpu_torch.models.student import StudentModel
    from fithubert_tpu_torch.models.teacher import TeacherGeometry, TeacherModel
    from fithubert_tpu_torch.train.step import Distiller

    monkeypatch.delenv("FITHUBERT_CONV_BWD", raising=False)
    s_spec, t_spec = ((64, 10, 5), (64, 3, 2), (128, 2, 2)), ((64, 10, 5), (128, 3, 2), (128, 2, 2))
    student = tc.StudentConfig(
        conv_feature_layers=s_spec, encoder_layers=2, encoder_embed_dim=80,
        encoder_ffn_embed_dim=128, encoder_attention_heads=2, conv_pos=16, conv_pos_groups=4,
        layerwise_proj=True, enable_tr_layer=True, tr_layer_type="conv1d", tr_layer_index=0,
        pred_head_final_dim=128, pred_layer_id=(1,), required_seq_len_multiple=1,
        compute_dtype="bfloat16")
    teacher = dict(encoder_layers=2, encoder_embed_dim=128, encoder_ffn_embed_dim=128,
                   encoder_attention_heads=2)
    cfg = tc.ExperimentConfig(
        teacher=tc.TeacherConfig(**teacher),
        train=tc.TrainConfig(batch_size=2, accumulate_grad_batches=2, use_fp16=True),
        loss=tc.LossConfig(rec_loss_type="mse", sim_loss_weight=0.0, distil_random_layer=1,
                           random_layer_weight=0.1),
        distiller=student)
    gen = torch.Generator().manual_seed(0)
    geom = TeacherGeometry(conv_feature_layers=t_spec, conv_pos=16, conv_pos_groups=4, **teacher)
    t_state = TeacherModel(geom, device="cpu").init_weights(gen).state_dict()
    s_state = StudentModel(student, device="cpu").init_weights(gen).state_dict()
    d = Distiller(cfg, t_state, s_state, device="cuda", num_training_steps=10,
                  teacher_geometry=geom)
    batch = {"x": torch.randn(2, 2, 4000, generator=gen) * 0.1,
             "padding_mask": torch.zeros(2, 2, 4000, dtype=torch.bool)}
    for _ in range(2):
        _build.reset_launches()
        logs = d.train_step(batch, torch.tensor([0]))
        torch.cuda.synchronize()
        assert _build.LAUNCHES[cf.KERNEL_BWD] == 4 * (len(s_spec) - 1)
        assert all(torch.isfinite(torch.tensor(v)) for v in logs.values())
