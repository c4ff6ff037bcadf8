"""Each Hopper kernel of the port against its plain version, on the card.

Marked `cuda`; every test skips where torch sees no CUDA card (the check is
made inside the tests, never at import). Imports nothing of JAX, so it runs
on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.quantizer import pack_codes
from repro_torch.kernels import comq_panel, flash_attention, quant_matmul

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,n", [(256, 512), (56, 100), (37, 33)])
def test_panel_matches_plain(cuda, B, n):
    g = torch.Generator(device=cuda).manual_seed(B + n)
    x = torch.randn(4 * B, B, generator=g, device=cuda)
    h_bb = x.T @ x / (4 * B) + 0.1 * torch.eye(B, device=cuda)
    h_bb[-3:, :] = 0
    h_bb[:, -3:] = 0                      # padded rows keep their code
    args = (h_bb, torch.randn(B, n, generator=g, device=cuda),
            torch.randn(B, n, generator=g, device=cuda) * 3,
            torch.rand(n, generator=g, device=cuda) * 0.15 + 0.05,
            torch.full((n,), -8.0, device=cuda),
            torch.full((n,), 7.0, device=cuda),
            torch.diagonal(h_bb).contiguous())
    qk, dk = comq_panel.comq_panel_dq_cuda(*args)
    qp, dp = comq_panel.comq_panel_dq_plain(*args)
    assert float((qk == qp).float().mean()) >= 0.999
    assert torch.equal(qk[-3:], torch.clamp(torch.round(args[2][-3:]), -8, 7))
    assert torch.equal(dk[-3:], (qk[-3:] - args[2][-3:]) * args[3])


@pytest.mark.parametrize("case", [
    dict(B=2, T=64, H=14, KV=2, hd=16, window=0),    # group 7
    dict(B=1, T=96, H=14, KV=2, hd=32, window=40),
    dict(B=2, T=48, H=4, KV=4, hd=8, window=0),
    dict(B=2, T=130, H=28, KV=4, hd=128, window=0)],
    ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_matches_plain(cuda, case, dtype):
    B, T, H, KV, hd, w = (case[k] for k in ("B", "T", "H", "KV", "hd",
                                             "window"))
    g = torch.Generator(device=cuda).manual_seed(T)
    q = torch.randn(B, T, H, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, T, KV, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, T, KV, hd, generator=g, device=cuda).to(dtype)
    got = flash_attention.flash_attention_cuda(q, k, v, window=w).float()
    want = flash_attention.flash_attention_plain(q, k, v, window=w).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert bool(((got - want).abs() <= 8e-3 * want.abs() + 1e-3).all())


def test_flash_reads_strided_views(cuda):
    """q/k/v as views into a fused (B, T, H+2KV, hd) buffer."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 40, 14 + 4, 32, generator=g, device=cuda)
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    got = flash_attention.flash_attention_cuda(q, k, v)
    want = flash_attention.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,K,N", [(8, 3584, 512), (5, 300, 44),
                                   (70, 1000, 24)])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quant_matmul_matches_plain(cuda, M, K, N, bits):
    g = torch.Generator(device=cuda).manual_seed(M + K + N + bits)
    x = torch.randn(M, K, generator=g, device=cuda)
    u = torch.randint(0, 2 ** bits, (K, N), generator=g, device=cuda,
                      dtype=torch.uint8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.04 + 0.01
    z = torch.randint(-(2 ** (bits - 1)), 0, (N,), generator=g,
                      device=cuda).float()
    codes, cpb = pack_codes(u, bits)
    got = quant_matmul.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
    want = quant_matmul.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 64, device=cuda)
    codes = torch.zeros(64, 16, dtype=torch.uint8, device=cuda)
    s = torch.ones(32, device=cuda)
    with pytest.raises(TypeError):
        quant_matmul.quant_matmul_cuda(x.half(), codes, s, s, cpb=2)
    strided = torch.randn(8, 128, device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        quant_matmul.quant_matmul_cuda(strided, codes, s, s, cpb=2)
    q = torch.randn(1, 8, 3, 16, device=cuda)
    kv = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_cuda(q, kv, kv)   # 3 % 2 != 0
