"""Kernel K7 (tpuflow_torch/kernels/depthwise.py): one stage of PCBlock4's
conv_list, act(x + b + dwconv_k(x)), in NHWC.

On the CPU the wrapper runs its plain twin, which is held here to the
module's previous composition, gelu(x + F.conv2d(x, w, b, padding=k // 2,
groups=C)), in f32; `depthwise_stage`'s backward, to the twin's own.  The
CUDA kernel is held to the twin on the card by chip_smoke.py's K7 row.
"""

import pytest
import torch
import torch.nn.functional as F

from tpuflow_torch.core.encoders import gelu
from tpuflow_torch.core.sk import PCBlock4, nchw_to_nhwc, nhwc_to_nchw
from tpuflow_torch.kernels.depthwise import (depthwise_residual_gelu, depthwise_residual_gelu_plain,
                                             depthwise_stage)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other port test modules run (several
    test workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw(b, h, w, c, k, seed=0, dtype=torch.float32, device="cpu"):
    """NHWC x, depthwise weight [C, 1, k, k] at a conv's init scale
    (1 / k) and bias, and a pointwise entry's weight and bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g)
    wt = torch.randn(c, 1, k, k, generator=g) / k
    bias = torch.randn(c, generator=g) * 0.1
    pw = torch.randn(c, 1, 1, 1, generator=g) * 0.5
    pb = torch.randn(c, generator=g) * 0.1
    return tuple(t.to(device=device, dtype=dtype) for t in (x, wt, bias, pw, pb))


def module_stage(x, wt, bias):
    """The module's previous composition of one conv_list entry, NHWC in
    and out."""
    k, c = wt.shape[-1], x.shape[-1]
    xc = nhwc_to_nchw(x)
    return nchw_to_nhwc(gelu(xc + F.conv2d(xc, wt, bias, padding=k // 2, groups=c)))


# ---------------------------------------------------------------------------
# the plain twin on the CPU, against the module's previous composition (f32)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("c", [4, 12, 324])
@pytest.mark.parametrize("k", [1, 7, 15])
def test_plain_matches_module_composition(k, c, b):
    x, wt, bias, _, _ = draw(b, 9, 11, c, k, seed=k + c + b)
    got = depthwise_residual_gelu(x, wt, bias)
    assert got.shape == x.shape and got.is_contiguous()
    # Both f32: the conv's own sum, then the same add and erf GELU.
    torch.testing.assert_close(got, module_stage(x, wt, bias), rtol=1e-5, atol=1e-5)


def test_plain_frame_smaller_than_the_kernel():
    """A 5 x 9 frame under a 15 x 15 kernel: every output reads padding."""
    x, wt, bias, _, _ = draw(2, 5, 9, 12, 15, seed=3)
    torch.testing.assert_close(depthwise_residual_gelu(x, wt, bias), module_stage(x, wt, bias),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pads", [(0, 0), (7, 0), (0, 7), (3, 5), (7, 7)])
def test_plain_explicit_row_pads(pads):
    """Rows padded by (top, bottom), the width 'SAME': F.pad, then the conv
    without padding, the residual at each output's center row."""
    k, (top, bottom) = 15, pads
    x, wt, bias, _, _ = draw(2, 20, 9, 12, k, seed=sum(pads))
    got = depthwise_residual_gelu(x, wt, bias, pads=pads)
    xc = nhwc_to_nchw(x)
    conv = F.conv2d(F.pad(xc, (k // 2, k // 2, top, bottom)), wt, bias, groups=12)
    res = xc[:, :, k // 2 - top : k // 2 - top + conv.shape[2]]
    assert got.shape == (2, 20 + top + bottom - (k - 1), 9, 12)
    torch.testing.assert_close(got, nchw_to_nhwc(gelu(res + conv)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [7, 15])
def test_plain_folds_the_pointwise_entry(k):
    """A k = 1 entry folded in as the prologue is the two stages in turn,
    the second padding the first's output with zeros."""
    x, wt, bias, pw, pb = draw(2, 9, 11, 12, k, seed=k)
    got = depthwise_residual_gelu(x, wt, bias, pw, pb)
    torch.testing.assert_close(got, module_stage(module_stage(x, pw, pb), wt, bias), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_rounds_once(dtype):
    """The twin sums in f32 and rounds once to x's dtype, with the dtype's
    GELU (tanh form in bf16)."""
    x, wt, bias, _, _ = draw(1, 9, 11, 12, 7, seed=5, dtype=dtype)
    got = depthwise_residual_gelu(x, wt, bias)
    assert got.dtype == dtype
    xc = nhwc_to_nchw(x).float()
    f32 = xc + F.conv2d(F.pad(xc, (3, 3, 3, 3)), wt.float(), bias.float(), groups=12)
    want = F.gelu(f32, approximate="tanh" if dtype == torch.bfloat16 else "none").to(dtype)
    assert torch.equal(got, nchw_to_nhwc(want).contiguous())


_X, _W, _B, _PW, _PB = draw(1, 6, 7, 8, 7)


@pytest.mark.parametrize("call", [
    lambda: depthwise_residual_gelu(nhwc_to_nchw(_X), _W, _B),                    # NCHW view
    lambda: depthwise_residual_gelu(_X.transpose(1, 2), _W, _B),                  # not contiguous
    lambda: depthwise_residual_gelu(_X.half(), _W.half(), _B.half()),
    lambda: depthwise_residual_gelu(_X, _W.bfloat16(), _B),                       # dtypes differ
    lambda: depthwise_residual_gelu(_X, torch.zeros(8, 1, 4, 4), _B),             # even k
    lambda: depthwise_residual_gelu(_X, torch.zeros(8, 1, 17, 17), _B),           # above the cap
    lambda: depthwise_residual_gelu(_X, torch.zeros(8, 1, 5, 5), _B),             # no template
    lambda: depthwise_residual_gelu(_X, _W, None),                                # no bias
    lambda: depthwise_residual_gelu(_X, torch.zeros(8, 1, 7, 5), _B),             # not square
    lambda: depthwise_residual_gelu(_X, _W[:4], _B),                              # channels
    lambda: depthwise_residual_gelu(_X, _W, _B, pads=(4, 3)),                     # pad above k // 2
    lambda: depthwise_residual_gelu(_X[:, :1], _W, _B, pads=(0, 0)),              # no output row
    lambda: depthwise_residual_gelu(_X, _W, _B, torch.zeros(8, 1, 3, 3), _PB),    # prologue not 1x1
    lambda: depthwise_residual_gelu(_X, _W, _B, None, _PB),                       # bias without weight
    lambda: depthwise_residual_gelu(_X, _W, _B, _PW, None),                       # weight without bias
], ids=["nchw_view", "strided", "fp16", "mixed_dtypes", "even_k", "k_above_cap", "k_not_built", "no_bias",
        "not_square", "channels", "pad_above_half", "no_output_row", "prologue_not_pointwise",
        "prologue_bias_alone", "prologue_weight_alone"])
def test_wrapper_rejects_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# PCBlock4's paths
# ---------------------------------------------------------------------------
def old_pcblock4(block, x):
    """PCBlock4.forward as it was composed before K7 and K8, on NCHW x."""
    x = gelu(x + block.ffn1[2](gelu(block.ffn1[0](x))))
    for conv in block.conv_list:
        x = gelu(x + conv(x))
    x = gelu(x + block.pw(x))
    return block.ffn2[2](gelu(block.ffn2[0](x)))


def pcblock4(k_conv, seed=0):
    torch.manual_seed(seed)
    return PCBlock4(12, 8, k_conv)


@pytest.mark.parametrize("k_conv", [(1, 15), (1, 7), (15,), (1,), (7, 1, 15)])
def test_pcblock4_matches_the_old_composition(k_conv):
    """Inference (no grad): the entries' plain twins on the CPU, on NHWC x,
    with each k = 1 entry before a k > 1 one folded in."""
    block = pcblock4(k_conv)
    x = torch.randn(2, 10, 9, 12)
    with torch.no_grad():
        torch.testing.assert_close(block(x), nchw_to_nhwc(old_pcblock4(block, nhwc_to_nchw(x))),
                                   rtol=1e-5, atol=1e-5)


def test_pcblock4_gradient_path_takes_the_plain_twin():
    """With grad enabled and parameters that require it, PCBlock4 runs the
    kernel entry forward and the plain twin backward (depthwise_stage) and
    gives the old module's gradients, for the parameters and the input."""
    block = pcblock4((1, 15), seed=1)
    g = torch.Generator().manual_seed(2)
    x0 = torch.randn(2, 10, 9, 12, generator=g)
    probe = torch.randn(2, 10, 9, 8, generator=g)
    grads = []
    for forward in (block, lambda x: nchw_to_nhwc(old_pcblock4(block, nhwc_to_nchw(x)))):
        block.zero_grad()
        x = x0.clone().requires_grad_()
        (forward(x) * probe).sum().backward()
        grads.append([x.grad] + [p.grad.clone() for p in block.parameters()])
    for new, old in zip(*grads):
        torch.testing.assert_close(new, old, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "gradient"])
def test_pcblock4_picks_the_entry_or_the_twin(monkeypatch, grad):
    """One path in every grad mode: each stage's forward runs once (on the
    CPU the twin, on x as it lies; on the card the kernel entry, which
    chip_smoke.py's train phase counts), and only a backward runs the
    plain twin again, once per stage."""
    import tpuflow_torch.kernels.depthwise as dw

    calls, depth = [], [0]

    def outermost(name, fn):
        """Records the calls that no other call of the two makes (the entry
        runs the twin on the CPU, and the twin runs itself for a prologue)."""
        def call(*a, **kw):
            if not depth[0]:
                calls.append((name, torch.is_grad_enabled()))
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return call

    for name in ("depthwise_residual_gelu", "depthwise_residual_gelu_plain"):
        monkeypatch.setattr(dw, name, outermost(name, getattr(dw, name)))
    block = pcblock4((1, 15, 1, 7), seed=3)
    with torch.set_grad_enabled(grad):
        out = block(torch.randn(1, 6, 7, 12))
    forward = [("depthwise_residual_gelu_plain", False)] * 2     # inside the Function: no graph
    assert calls == forward
    if grad:
        out.sum().backward()
        assert calls == forward + [("depthwise_residual_gelu_plain", True)] * 2
        assert all(p.grad is not None for p in block.conv_list.parameters())


@pytest.mark.parametrize("fold", [False, True], ids=["alone", "folded"])
@pytest.mark.parametrize("pads", [None, (7, 0), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_stage_backward_is_the_plain_twins(fold, pads, dtype, layout):
    """On the CPU depthwise_stage's forward is the plain twin's on x as it
    lies, and its gradients, for x, the weights and the biases, are the
    twin's own; x contiguous, or an NHWC view of NCHW memory."""
    x, wt, bias, pw, pb = draw(2, 20, 9, 12, 15, seed=11, dtype=dtype)
    if layout == "nchw":
        x = nchw_to_nhwc(nhwc_to_nchw(x).contiguous())
    pre = (pw, pb) if fold else (None, None)
    probe = torch.randn(2, 20 + sum(pads or (14,)) - 14, 9, 12, generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (depthwise_stage, depthwise_residual_gelu_plain):
        inputs = [t if t is None else t.clone().requires_grad_() for t in (x, wt, bias) + pre]
        y = fn(*inputs, pads=pads)
        if fn is depthwise_stage:
            with torch.no_grad():
                assert torch.equal(y, depthwise_residual_gelu_plain(x, wt, bias, *pre, pads))
        (y.float() * probe).sum().backward()
        grads.append([t.grad for t in inputs if t is not None])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_stage_backward_without_parameter_gradients():
    """Only x requires a gradient: the weights get none, x the twin's."""
    x, wt, bias, _, _ = draw(1, 9, 11, 12, 7, seed=2)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    depthwise_stage(xs[0], wt, bias).sum().backward()
    depthwise_residual_gelu_plain(xs[1], wt, bias).sum().backward()
    assert wt.grad is None and torch.equal(xs[0].grad, xs[1].grad)


@pytest.mark.parametrize("call", [
    lambda: depthwise_stage(_X, torch.zeros(8, 1, 5, 5), _B),                     # no template
    lambda: depthwise_stage(_X, _W, None),                                        # no bias
    lambda: depthwise_stage(_X.half(), _W.half(), _B.half()),
    lambda: depthwise_stage(_X, _W, _B, pads=(4, 3)),                             # pad above k // 2
], ids=["k_not_built", "no_bias", "fp16", "pad_above_half"])
def test_stage_rejects_what_the_kernel_refuses(call):
    """On the CPU too, whatever x's layout: a model the card cannot run
    fails where it is tested."""
    with pytest.raises(ValueError):
        call()
