"""Kernel K9 (tpuflow_torch/kernels/memread.py): MemFlow's memory reader,
an exact f32 softmax readout over the memory's valid slots.

On the CPU the wrapper runs its plain twin (the reader's chunked, masked
softmax), held here to a softmax computed over the valid slots alone, the
premise of the kernel's skip of invalid slots; its rotary table, to
rope_2d's rotation; its checks, to what the kernel refuses (on meta
tensors, which take the kernel's path).  The CUDA kernel is held to the
twin on the card by chip_smoke.py's K9 row; the reader against the JAX
package's by tests/test_torch_port_memflow.py.
"""

import math

import pytest
import torch

from tests.mirrors.memflow_torch import rope_2d as mirror_rope_2d
from tpuflow_torch.core.memflownet import MemoryReader, MemoryState, rope_2d
from tpuflow_torch.kernels.memread import (memory_read, memory_read_plain, memory_read_stage, rope_rotate,
                                           rope_table)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as the other port test modules run (several
    test workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 5, 7
HW = H * W


def draw(validity, dk=64, dv=128, seed=0, qdtype=torch.float32):
    """q [B, hw, dk] (std 2), keys and values of every slot at random
    (invalid slots large, so that a slot the mask let through would show),
    valid [B, cap] from `validity`."""
    g = torch.Generator().manual_seed(seed)
    b, cap = len(validity), len(validity[0])
    valid = torch.tensor(validity, dtype=torch.float32)
    q = (2 * torch.randn(b, HW, dk, generator=g)).to(qdtype)
    keys = torch.randn(b, cap, HW, dk, generator=g)
    values = torch.randn(b, cap, HW, dv, generator=g)
    dead = (valid <= 0)[:, :, None, None]
    keys = torch.where(dead, 50 * keys, keys)
    values = torch.where(dead, 1e3 * values, values)
    return q, keys, values, valid


def softmax_over_valid(q, keys, values, valid, table):
    """The readout computed over each batch row's valid slots alone (a host
    index of valid, no mask), in f32 as the twin: zeros for a row with
    none."""
    b, hw, dk = q.shape
    qf = q.float() / math.sqrt(dk)
    kf = keys.float()
    if table is not None:
        qf, kf = rope_rotate(qf, table), rope_rotate(kf, table)
    out = torch.zeros(b, hw, values.shape[-1])
    for i in range(b):
        keep = valid[i] > 0
        if keep.any():
            k = kf[i, keep].reshape(-1, dk)
            v = values[i, keep].reshape(-1, values.shape[-1])
            out[i] = torch.softmax(qf[i] @ k.t(), dim=-1) @ v
    return out


PATTERNS = {
    "noncontiguous": [[1, 0, 1, 1, 0, 0, 1, 0]],
    "rows_differ": [[1, 0, 1, 1, 0, 0, 1, 0], [0, 1, 0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1]],
    "single": [[0, 0, 0, 0, 0, 1, 0, 0]],
    "all": [[1, 1, 1, 1, 1, 1, 1, 1]],
    "none": [[0, 0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0]],
}


# ---------------------------------------------------------------------------
# the premise of the skip: the masked twin is the softmax over valid slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_masked_twin_equals_softmax_over_valid_slots(pattern, rope):
    validity = PATTERNS[pattern]
    q, keys, values, valid = draw(validity, seed=len(pattern))
    table = rope_table(H, W, 64) if rope else None
    got = memory_read_plain(q, keys, values, valid, table)
    assert got.shape == (len(validity), HW, 128) and got.dtype == torch.float32
    if pattern == "none":
        # Before out_proj a memory with no valid slot reads exact zeros.
        assert torch.equal(got, torch.zeros_like(got))
        return
    ref = softmax_over_valid(q, keys, values, valid, table)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the wrapper on CPU tensors is the twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_wrapper_on_cpu_is_the_twin(rope, qdtype):
    q, keys, values, valid = draw(PATTERNS["rows_differ"], seed=7, qdtype=qdtype)
    table = rope_table(H, W, 64) if rope else None
    got = memory_read(q, keys, values, valid, table)
    assert torch.equal(got, memory_read_plain(q, keys, values, valid, table))
    assert torch.equal(memory_read_stage(q, keys, values, valid, table), got)


def test_reader_takes_the_wrapper_and_caches_its_table(monkeypatch):
    """MemoryReader reads through memory_read_stage with the table of its
    grid, built once per grid and device, and applies out_proj to the
    readout cast to the query's dtype."""
    import tpuflow_torch.core.memflownet as memflownet

    calls = []
    real_stage, real_table = memflownet.memory_read_stage, memflownet.rope_table
    monkeypatch.setattr(memflownet, "memory_read_stage", lambda *a: calls.append(a) or real_stage(*a))
    built = []
    monkeypatch.setattr(memflownet, "rope_table", lambda *a: built.append(a) or real_table(*a))
    reader = MemoryReader(128, use_rope=True).eval()
    q, keys, values, valid = draw(PATTERNS["rows_differ"], seed=3)
    mem = MemoryState(keys, values, valid, torch.zeros(3, dtype=torch.int64))
    with torch.no_grad():
        first = reader(q.reshape(3, H, W, 64), mem)
        second = reader(q.reshape(3, H, W, 64), mem)
    assert torch.equal(first, second) and len(calls) == 2 and built == [(H, W, 64, torch.device("cpu"))]
    assert torch.equal(calls[0][4], rope_table(H, W, 64))
    read = memory_read_plain(q, keys, values, valid, rope_table(H, W, 64)).reshape(3, H, W, 128)
    want = torch.nn.functional.conv2d(read.permute(0, 3, 1, 2), reader.out_proj.weight, reader.out_proj.bias)
    torch.testing.assert_close(first, want.permute(0, 2, 3, 1), rtol=1e-6, atol=1e-6)


def test_reader_gradient_is_the_twins():
    """A backward through the reader differentiates the plain twin."""
    q, keys, values, valid = draw(PATTERNS["noncontiguous"], seed=11)
    table = rope_table(H, W, 64)
    grads = []
    for stage in (memory_read_stage, memory_read_plain):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, keys, values))
        stage(qq, kk, vv, valid, table).square().sum().backward()
        grads.append([t.grad for t in (qq, kk, vv)])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the rotary table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,w,d", [(5, 7, 64), (1, 1, 4), (3, 8, 8), (135, 240, 64)])
def test_rope_table_rotates_as_rope_2d(h, w, d):
    """Rotating by the table gives rope_2d's rotation, and an independent
    copy of it (the test mirror), bit for bit."""
    g = torch.Generator().manual_seed(h * w + d)
    t = 10 * torch.randn(2, 3, h * w, d, generator=g)
    table = rope_table(h, w, d)
    assert table.shape == (h * w, 2, d // 2) and table.dtype == torch.float32
    got = rope_rotate(t, table)
    assert torch.equal(got, rope_2d(t, h, w))
    assert torch.equal(got, mirror_rope_2d(t, h, w))


def test_rope_table_angles():
    """cos and sin of pos * 10000^(-i / (d/4)): pair i < d/4 with x, pair
    d/4 + i with y."""
    h, w, d = 3, 4, 8
    table = rope_table(h, w, d).double()
    for j in range(h * w):
        y, x = divmod(j, w)
        for p in range(d // 2):
            pos, i = (x, p) if p < d // 4 else (y, p - d // 4)
            ang = pos * 10000.0 ** (-i / (d // 4))
            assert abs(table[j, 0, p].item() - math.cos(ang)) < 1e-6
            assert abs(table[j, 1, p].item() - math.sin(ang)) < 1e-6


def test_rope_table_rejects_channels_not_divisible_by_4():
    with pytest.raises(ValueError, match="divisible by 4"):
        rope_table(2, 3, 6)


# ---------------------------------------------------------------------------
# the wrapper's checks: what K9 does not take raises
# ---------------------------------------------------------------------------
_Q, _K, _V, _VALID = draw([[1, 0, 1]], seed=1)
_T = rope_table(H, W, 64)


def _meta(*tensors):
    return [t.to("meta") for t in tensors]


@pytest.mark.parametrize("call,match", [
    (lambda: memory_read(_Q[0], _K, _V, _VALID), "q \\[B, hw, dk\\]"),                        # rank of q
    (lambda: memory_read(_Q, _K[0], _V, _VALID), "q \\[B, hw, dk\\]"),                        # rank of keys
    (lambda: memory_read(_Q, _K[..., :32], _V, _VALID), "keys must be"),                      # dk differs
    (lambda: memory_read(_Q, _K, _V[:, :2], _VALID), "keys must be"),                         # cap differs
    (lambda: memory_read(_Q[..., :6], _K[..., :6], _V, _VALID, rope_table(H, W, 4)[:, :, :3]),
     "divisible by 4"),                                                                        # dk 6 with rope
    (lambda: memory_read(_Q, _K, _V, _VALID, _T[:, :, :16]), "table"),                        # table shape
    (lambda: memory_read(*_meta(_Q[..., :32], _K[..., :32], _V, _VALID)), "built for dk 64"),  # dk on the card
    (lambda: memory_read(*_meta(_Q, _K, _V[..., :64], _VALID)), "built for dk 64"),           # dv on the card
    (lambda: memory_read(*_meta(_Q.half(), _K, _V, _VALID)), "bfloat16 or float32"),          # fp16 query
    (lambda: memory_read(*_meta(_Q, _K.bfloat16(), _V, _VALID)), "bfloat16 or float32"),      # bf16 keys
    (lambda: memory_read(*_meta(_Q, _K, _V, _VALID, _T.double())), "bfloat16 or float32"),    # f64 table
    (lambda: memory_read(*_meta(_Q, _K.transpose(1, 2).contiguous().transpose(1, 2), _V, _VALID)),
     "contiguous"),                                                                            # strided keys
    (lambda: memory_read(*_meta(_Q, _K, _V), _VALID), "different devices"),                   # valid on cpu
    (lambda: memory_read(*_meta(_Q, _K, _V, _VALID, _T)), "cpu or cuda"),                     # a meta device
], ids=["q_rank", "keys_rank", "dk_differs", "cap_differs", "dk_not_multiple_of_4", "table_shape",
        "kernel_dk", "kernel_dv", "fp16_query", "bf16_keys", "f64_table", "noncontiguous_keys",
        "devices_differ", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "gradient"])
def test_stage_off_the_cpu_takes_the_entry(grad):
    """A tensor that is not on the CPU goes to the kernel entry (which
    refuses a meta tensor), never to the twin."""
    q, keys, values, valid = (t.to("meta") for t in (_Q, _K, _V, _VALID))
    q.requires_grad_(grad)
    with torch.set_grad_enabled(grad), pytest.raises(ValueError, match="cpu or cuda"):
        memory_read_stage(q, keys, values, valid, _T.to("meta"))
