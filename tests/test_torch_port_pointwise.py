"""Kernel K8 (tpuflow_torch/kernels/pointwise.py): one 1x1 convolution of
PCBlock4 as a GEMM on NHWC rows, act(residual + (bias + x W^T)).

On the CPU the wrapper runs its plain twin, which is held here to the
module's former composition, F.conv2d on an NCHW view, then the add and
the GELU, in f32; `pointwise_stage`'s backward, to the twin's own.  The
CUDA kernel is held to the twin on the card by chip_smoke.py's K8 row.
"""

import pytest
import torch
import torch.nn.functional as F

import tpuflow_torch.core.sk as sk
import tpuflow_torch.kernels.pointwise as pw
from tpuflow_torch.core.encoders import gelu
from tpuflow_torch.core.sk import (PCBlock4, SKMotionEncoderMem, SKMotionEncoderMOF, SKUpdateBlockMem,
                                   SKUpdateBlockMOF, nchw_to_nhwc, nhwc_to_nchw)
from tpuflow_torch.kernels.pointwise import (TILE_WIDTHS, pointwise_gemm, pointwise_gemm_plain,
                                             pointwise_stage, tile_width)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other port test modules run (several
    test workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw(b, h, w, k, n, seed=0, dtype=torch.float32):
    """NHWC x [b, h, w, k], a 1x1 conv's weight [n, k, 1, 1] at its init
    scale, a bias and a residual [b, h, w, n]."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, k, generator=g)
    wt = torch.randn(n, k, 1, 1, generator=g) / k ** 0.5
    bias = torch.randn(n, generator=g) * 0.1
    res = torch.randn(b, h, w, n, generator=g)
    return tuple(t.to(dtype) for t in (x, wt, bias, res))


def module_conv(x, wt, bias, res=None, act=False):
    """The module's former composition of a 1x1 conv, its residual add and
    GELU, on NCHW views; NHWC in and out."""
    y = F.conv2d(nhwc_to_nchw(x), wt, bias)
    if res is not None:
        y = nhwc_to_nchw(res) + y
    return nchw_to_nhwc(gelu(y) if act else y)


# ---------------------------------------------------------------------------
# the plain twin on the CPU, against the module's former composition (f32)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,n", [(12, 18), (18, 12), (324, 486), (486, 256), (972, 648), (64, 4), (24, 2),
                                 (6, 126), (400, 172)])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("act", [False, True], ids=["linear", "gelu"])
def test_plain_matches_module_composition(k, n, residual, act):
    x, wt, bias, res = draw(2, 3, 5, k, n, seed=k + n)
    res = res if residual else None
    got = pointwise_gemm(x, wt, bias, res, act=act)
    assert got.shape == (2, 3, 5, n) and got.is_contiguous()
    # Both f32: the conv's own sum against F.linear's, then the same add and erf GELU.
    torch.testing.assert_close(got, module_conv(x, wt, bias, res, act), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_plain_rounds_once(dtype, residual):
    """The twin sums in f32 (the module's former conv on an NCHW view), adds
    the bias and the residual in f32, applies the dtype's GELU (tanh form in
    bf16) in f32 and rounds once."""
    x, wt, bias, res = draw(1, 4, 6, 36, 20, seed=5, dtype=dtype)
    res = res if residual else None
    got = pointwise_gemm(x, wt, bias, res, act=True)
    assert got.dtype == dtype
    f32 = F.conv2d(nhwc_to_nchw(x).float(), wt.float(), bias.float())
    if res is not None:
        f32 = nhwc_to_nchw(res).float() + f32
    want = F.gelu(f32, approximate="tanh" if dtype == torch.bfloat16 else "none").to(dtype)
    assert torch.equal(got, nchw_to_nhwc(want))


def test_plain_rows_without_an_image_shape():
    """x of other ranks ([M, K]) takes F.linear in f32 with one rounding."""
    x, wt, bias, res = draw(1, 1, 30, 36, 20, seed=6, dtype=torch.bfloat16)
    x2, res2 = x.reshape(30, 36), res.reshape(30, 20)
    got = pointwise_gemm(x2, wt, bias, res2, act=True)
    want = F.gelu(res2.float() + F.linear(x2.float(), wt.float().reshape(20, 36), bias.float()),
                  approximate="tanh").bfloat16()
    assert got.shape == (30, 20) and torch.equal(got, want)


def test_plain_takes_a_2d_weight_and_strided_rows():
    """A weight [N, K] is the conv's [N, K, 1, 1]; x and the residual may be
    slices of wider rows (the motion encoder's split)."""
    x, wt, bias, res = draw(2, 3, 4, 16, 8, seed=9)
    wide = torch.cat([x, torch.randn(2, 3, 4, 5)], dim=-1)[..., :16]
    wide_res = torch.cat([torch.randn(2, 3, 4, 3), res], dim=-1)[..., 3:]
    got = pointwise_gemm(wide, wt.reshape(8, 16), bias, wide_res, act=True)
    torch.testing.assert_close(got, module_conv(x, wt, bias, res, True), rtol=1e-5, atol=1e-5)


_X, _W, _B, _R = draw(1, 4, 5, 8, 6)


@pytest.mark.parametrize("call", [
    lambda: pointwise_gemm(_X[0, 0, 0], _W, _B),                                  # no token axis
    lambda: pointwise_gemm(_X, _W[:, :4], _B),                                    # K differs
    lambda: pointwise_gemm(_X, torch.zeros(6, 8, 3, 3), _B),                      # not 1x1
    lambda: pointwise_gemm(_X, _W[..., 0], _B),                                   # 3-d weight
    lambda: pointwise_gemm(_X, _W, None),                                         # no bias
    lambda: pointwise_gemm(_X, _W, _B[:4]),                                       # bias width
    lambda: pointwise_gemm(_X, _W, _B, _R[..., :4]),                              # residual width
    lambda: pointwise_gemm(_X, _W, _B, _R[:, :2]),                                # residual tokens
    lambda: pointwise_gemm(_X.half(), _W.half(), _B.half()),                      # fp16
    lambda: pointwise_gemm(_X, _W.bfloat16(), _B),                                # dtypes differ
    lambda: pointwise_gemm(_X, _W, _B, _R.bfloat16()),                            # residual dtype
    lambda: pointwise_gemm(nchw_to_nhwc(nhwc_to_nchw(_X).contiguous()), _W, _B),  # NHWC view of NCHW
    lambda: pointwise_gemm(_X.transpose(1, 2), _W, _B),                           # rows not even
    lambda: pointwise_gemm(_X, _W, _B, nchw_to_nhwc(nhwc_to_nchw(_R).contiguous())),  # residual strided
    lambda: pointwise_gemm(_X[:, :1].expand(1, 4, 5, 8), _W, _B),                 # overlapping rows
    lambda: pointwise_gemm(_X, _W.to("meta"), _B),                                # devices differ
    lambda: pointwise_gemm(_X.to("meta"), _W.to("meta"), _B.to("meta")),          # neither cpu nor cuda
], ids=["no_token_axis", "k_differs", "not_1x1", "weight_3d", "no_bias", "bias_width", "residual_width",
        "residual_tokens", "fp16", "mixed_dtypes", "residual_dtype", "nchw_memory", "rows_uneven",
        "residual_strided", "overlapping_rows", "devices_differ", "meta_device"])
def test_wrapper_rejects_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# the wrapper's rules, which the kernel relies on
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,width", [(2, 8), (4, 8), (64, 64), (126, 128), (128, 128), (172, 96), (192, 96),
                                     (256, 128), (324, 112), (384, 128), (400, 112), (486, 128), (576, 128),
                                     (600, 128), (648, 112), (768, 128), (972, 128)])
def test_tile_width_rule(n, width):
    """The fewest tiles of at most 128 columns, each rounded up to a width
    the kernel has: the widths of both cells' convolutions."""
    assert tile_width(n) == width


def test_tile_width_covers_every_n():
    for n in range(1, 2100):
        w = tile_width(n)
        assert w in TILE_WIDTHS
        tiles = -(-n // w)
        assert tiles == -(-n // 128) and (tiles - 1) * w < n <= tiles * w


@pytest.mark.parametrize("k,offset,vec", [(648, 0, 8), (256, 0, 8), (324, 0, 4), (972, 0, 4), (486, 0, 2),
                                          (9, 0, 1), (648, 4, 4), (648, 2, 2), (648, 1, 1)])
def test_copy_vector_rule(k, offset, vec):
    """16-byte copies where the row stride and the address allow, else 8, 4
    or 2 bytes (bf16)."""
    buf = torch.zeros(3 * k + offset, dtype=torch.bfloat16)
    assert pw._copy_vector(k, buf[offset:].view(3, k)) == vec


@pytest.mark.parametrize("k,vec", [(972, 4), (486, 2), (648, 8), (9, 1)])
def test_copy_vector_of_padded_rows(k, vec):
    """Rows padded to 16 bytes take 16-byte copies whatever K; copies that
    must not straddle a row's end (the residual's) follow K too."""
    x = torch.zeros(3, pw._padded(k), dtype=torch.bfloat16)[:, :k]
    assert pw._copy_vector(pw._row_stride(x), x) == 8
    assert pw._copy_vector(pw._row_stride(x), x, k) == vec


@pytest.mark.parametrize("n,ld", [(972, 976), (648, 648), (486, 488), (4, 8), (2, 8), (125, 128)])
def test_padded_rows(n, ld):
    assert pw._padded(n) == ld


def test_weight_rows_padded_once_per_version():
    """A bf16 weight whose K is not a multiple of 8 is given rows padded to
    16 bytes, made again only after the weight changes; others pass as they
    are."""
    w = torch.randn(6, 972, 1, 1).bfloat16()
    rows = pw._weight_rows(w, 6, 972)
    assert rows.shape == (6, 972) and rows.stride(0) == 976 and torch.equal(rows, w.reshape(6, 972))
    assert pw._weight_rows(w, 6, 972).data_ptr() == rows.data_ptr()
    w.mul_(2)
    again = pw._weight_rows(w, 6, 972)
    assert torch.equal(again, w.reshape(6, 972))
    for plain in (torch.randn(6, 648, 1, 1).bfloat16(), torch.randn(6, 972, 1, 1)):
        assert pw._weight_rows(plain, 6, plain.shape[1]).data_ptr() == plain.data_ptr()


def test_weight_rows_of_an_inference_tensor():
    """A weight made under inference mode (spatial strips' functional calls)
    has no version counter: its padded rows are made for each launch, so a
    change in place shows."""
    with torch.inference_mode():
        w = torch.randn(6, 324, 1, 1).bfloat16()
        rows = pw._weight_rows(w, 6, 324)
        assert rows.stride(0) == 328 and torch.equal(rows, w.reshape(6, 324))
        w.mul_(2)
        assert torch.equal(pw._weight_rows(w, 6, 324), w.reshape(6, 324))


def test_pad_changes_no_value_on_the_cpu():
    """pad only lays out the kernel's output; the twin returns the same values."""
    x, wt, bias, res = draw(1, 3, 4, 20, 18, seed=4)
    torch.testing.assert_close(pointwise_gemm(x, wt, bias, res, act=True, pad=True),
                               pointwise_gemm(x, wt, bias, res, act=True), rtol=0, atol=0)


def test_row_stride_rule():
    x = torch.zeros(2, 3, 4, 10)
    assert pw._row_stride(x) == 10
    assert pw._row_stride(x[..., 2:7]) == 10
    assert pw._row_stride(x[:1, 1:3]) == 10
    assert pw._row_stride(x[:, 1:3]) is None              # a gap between the batch rows
    assert pw._row_stride(x.transpose(1, 2)) is None
    assert pw._row_stride(nchw_to_nhwc(torch.zeros(2, 10, 3, 4))) is None
    assert pw._row_stride(torch.zeros(1, 1, 1, 7)) == 7
    assert pw._row_stride(x[:, :, :1].expand(2, 3, 4, 10)) is None


# ---------------------------------------------------------------------------
# the gradient: pointwise_stage's backward is the twin's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", ["none", "other", "x"])
@pytest.mark.parametrize("act", [False, True], ids=["linear", "gelu"])
def test_stage_backward_is_the_plain_twins(dtype, residual, act):
    """On the CPU pointwise_stage's forward is the twin's, and its gradients,
    for x, the weight, the bias and the residual (another tensor, or x
    itself as PCBlock4's pw), are the twin's own."""
    k = n = 12
    x, wt, bias, res = draw(2, 3, 4, k, n, seed=11, dtype=dtype)
    probe = torch.randn(2, 3, 4, n, generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (pointwise_stage, pointwise_gemm_plain):
        inputs = [t.clone().requires_grad_() for t in (x, wt, bias, res)]
        r = {"none": None, "other": inputs[3], "x": inputs[0]}[residual]
        y = fn(*inputs[:3], r, act=act) if fn is pointwise_stage else fn(*inputs[:3], r, act)
        if fn is pointwise_stage:
            with torch.no_grad():
                assert torch.equal(y, pointwise_gemm_plain(x, wt, bias, {"none": None, "other": res, "x": x}[residual],
                                                           act))
        (y.float() * probe).sum().backward()
        grads.append([t.grad for t in inputs])
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


def test_stage_backward_without_parameter_gradients():
    """Only x requires a gradient: the weight and the bias get none, x the
    twin's."""
    x, wt, bias, res = draw(1, 3, 4, 10, 10, seed=2)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    pointwise_stage(xs[0], wt, bias, res, act=True).sum().backward()
    pointwise_gemm_plain(xs[1], wt, bias, res, True).sum().backward()
    assert wt.grad is None and bias.grad is None and torch.equal(xs[0].grad, xs[1].grad)


@pytest.mark.parametrize("call", [
    lambda: pointwise_stage(_X, torch.zeros(6, 8, 3, 3), _B),                     # not 1x1
    lambda: pointwise_stage(_X, _W, None),                                        # no bias
    lambda: pointwise_stage(_X.half(), _W.half(), _B.half()),
    lambda: pointwise_stage(_X.requires_grad_(False), _W, _B, _R[..., :4]),       # residual width
], ids=["not_1x1", "no_bias", "fp16", "residual_width"])
def test_stage_rejects_what_the_kernel_refuses(call):
    """On the CPU too, whatever x's layout: a model the card cannot run
    fails where it is tested."""
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# which path runs: the entry or the twin, by device and grad mode
# ---------------------------------------------------------------------------
def _record(monkeypatch):
    """Records the outermost calls of the entry and the twin (the entry runs
    the twin on the CPU) with the grad mode they ran in."""
    calls, depth = [], [0]

    def outermost(name, fn):
        def call(*a, **kw):
            if not depth[0]:
                calls.append((name, torch.is_grad_enabled()))
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return call

    for name in ("pointwise_gemm", "pointwise_gemm_plain"):
        monkeypatch.setattr(pw, name, outermost(name, getattr(pw, name)))
    return calls


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "gradient"])
def test_pcblock4_picks_the_entry_or_the_twin(monkeypatch, grad):
    """Five convolutions a block in every grad mode: each forward runs once
    (on the CPU the twin, on x as it lies; on the card the kernel entry),
    and only a backward runs the twin again, once per convolution."""
    calls = _record(monkeypatch)
    torch.manual_seed(3)
    block = PCBlock4(12, 8, (1, 15))
    with torch.set_grad_enabled(grad):
        out = block(torch.randn(1, 6, 7, 12))
    forward = [("pointwise_gemm_plain", False)] * 5     # inside the Function: no graph
    assert calls == forward
    if grad:
        out.sum().backward()
        assert calls == forward + [("pointwise_gemm_plain", True)] * 5
        assert all(p.grad is not None for p in (*block.ffn1.parameters(), *block.pw.parameters(),
                                                *block.ffn2.parameters()))


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "gradient"])
def test_stage_off_the_cpu_takes_the_entry(monkeypatch, grad):
    """A tensor that is not on the CPU goes to the kernel entry (which
    refuses a meta tensor), never to the twin."""
    calls = _record(monkeypatch)
    x, wt, bias = (t.to("meta").requires_grad_(grad) for t in (_X, _W, _B))
    with torch.set_grad_enabled(grad), pytest.raises(ValueError, match="cpu or cuda"):
        pointwise_stage(x, wt, bias, act=True)
    assert calls == [("pointwise_gemm", False)]


# ---------------------------------------------------------------------------
# PCBlock4 and the SK blocks in NHWC
# ---------------------------------------------------------------------------
def old_pcblock4(block, x, act=False):
    """PCBlock4.forward as it was composed before K7 and K8, on NCHW x, with
    the motion encoders' gelu after it where act."""
    x = gelu(x + block.ffn1[2](gelu(block.ffn1[0](x))))
    for conv in block.conv_list:
        x = gelu(x + conv(x))
    x = gelu(x + block.pw(x))
    x = block.ffn2[2](gelu(block.ffn2[0](x)))
    return gelu(x) if act else x


@pytest.mark.parametrize("c_in,c_out,k_conv", [(18, 4, (1, 15)), (24, 2, (1, 7)), (16, 10, (15,))])
@pytest.mark.parametrize("act", [False, True], ids=["linear", "gelu"])
def test_pcblock4_matches_the_nchw_composition(c_in, c_out, k_conv, act):
    """The NHWC block (five twins, the depthwise stages) against the former
    NCHW composition, with the output GELU folded into the last launch."""
    torch.manual_seed(c_in)
    block = PCBlock4(c_in, c_out, k_conv).eval()
    x = torch.randn(2, 9, 10, c_in)
    with torch.no_grad():
        got = block(x, act=act)
        want = nchw_to_nhwc(old_pcblock4(block, nhwc_to_nchw(x), act))
    assert got.shape == (2, 9, 10, c_out) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _count_stages(monkeypatch):
    seen = []
    stage = sk.pointwise_stage
    monkeypatch.setattr(sk, "pointwise_stage", lambda *a, **kw: seen.append(1) or stage(*a, **kw))
    return seen


def test_mof_step_runs_thirty_pointwise_launches(monkeypatch):
    """One MOF refinement step: six PCBlocks of five convolutions (12 steps a
    window: 360 launches), NHWC in and out, the motion state [B, N, h, w, 48]."""
    seen = _count_stages(monkeypatch)
    torch.manual_seed(0)
    block = SKUpdateBlockMOF(corr_levels=1, corr_radius=1).eval()
    bs, n, h, w = 1, 3, 4, 5
    bn = bs * n
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    with torch.no_grad():
        net, mhs, delta = block.step(r(bn, h, w, 128), None, r(bn, h, w, 128), r(bn, h, w, 18), r(bn, h, w, 4),
                                     r(bn, h, w, 128), r(bn, h, w, 128), bs)
        assert net.shape == (bn, h, w, 128) and delta.shape == (bn, h, w, 4)
        assert mhs.shape == (bs, n, h, w, 48)
        block.step(net, mhs, r(bn, h, w, 128), r(bn, h, w, 18), r(bn, h, w, 4), r(bn, h, w, 128),
                   r(bn, h, w, 128), bs)
    assert len(seen) == 2 * 30


def test_mem_step_runs_thirty_pointwise_launches(monkeypatch):
    seen = _count_stages(monkeypatch)
    torch.manual_seed(0)
    block = SKUpdateBlockMem(corr_levels=1, corr_radius=1).eval()
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    with torch.no_grad():
        net, motion, delta = block.step(r(1, 4, 5, 128), r(1, 4, 5, 128), r(1, 4, 5, 9), r(1, 4, 5, 2),
                                        r(1, 4, 5, 128), r(1, 4, 5, 128), r(1, 4, 5, 128))
    assert (net.shape, motion.shape, delta.shape) == ((1, 4, 5, 128), (1, 4, 5, 128), (1, 4, 5, 2))
    assert len(seen) == 30


def test_mof_motion_encoder_matches_the_nchw_composition():
    """The NHWC motion encoder against its former NCHW composition (the
    learned start expanded, the states shifted across interior frames)."""
    torch.manual_seed(4)
    enc = SKMotionEncoderMOF(1, 1, (1, 15)).eval()
    bs, n, h, w = 2, 3, 4, 5
    g = torch.Generator().manual_seed(2)
    flow, corr = torch.randn(bs * n, h, w, 4, generator=g), torch.randn(bs * n, h, w, 18, generator=g)
    mhs = torch.randn(bs, n, h, w, 48, generator=g)

    def old(flow, mhs, corr):
        flow, corr, mhs = nhwc_to_nchw(flow), nhwc_to_nchw(corr), mhs.permute(0, 1, 4, 2, 3)
        zeros = torch.zeros((bs, 1, 48, h, w))
        fwd = torch.cat([mhs[:, 1:], zeros], dim=1).reshape(bs * n, 48, h, w)
        bwd = torch.cat([zeros, mhs[:, :-1]], dim=1).reshape(bs * n, 48, h, w)
        cor = old_pcblock4(enc.convc2, old_pcblock4(enc.convc1, corr, act=True))
        flo = old_pcblock4(enc.convf2, enc.convf1_(flow))
        out = old_pcblock4(enc.conv, torch.cat([cor, flo, fwd, bwd, mhs.reshape(bs * n, 48, h, w)], dim=1))
        motion, new = torch.split(out, [124, 48], dim=1)
        return nchw_to_nhwc(torch.cat([motion, flow], dim=1)), new.reshape(bs, n, 48, h, w).permute(0, 1, 3, 4, 2)

    with torch.no_grad():
        for state in (mhs, None):
            got = enc(flow, state, corr, bs)
            want = old(flow, enc.init_hidden_state.expand(bs, n, 48, h, w).permute(0, 1, 3, 4, 2)
                       if state is None else state, corr)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_mem_motion_encoder_matches_the_nchw_composition():
    torch.manual_seed(5)
    enc = SKMotionEncoderMem(1, 1, (1, 15)).eval()
    g = torch.Generator().manual_seed(3)
    flow, corr, mem = (torch.randn(2, 4, 5, c, generator=g) for c in (2, 9, 128))
    with torch.no_grad():
        got = enc(flow, corr, mem)
        f, c, m = nhwc_to_nchw(flow), nhwc_to_nchw(corr), nhwc_to_nchw(mem)
        cor = old_pcblock4(enc.convc2, old_pcblock4(enc.convc1, c, act=True))
        flo = old_pcblock4(enc.convf2, enc.convf1_(f))
        want = torch.cat([old_pcblock4(enc.conv, torch.cat([cor, flo, m], dim=1)), f], dim=1)
    torch.testing.assert_close(got, nchw_to_nhwc(want), rtol=1e-5, atol=1e-5)
