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


def _code_range(bits: int):
    """(z_lo, z_hi, spread): the code range of a b-bit grid centred on 0,
    and how much wider its codes are than 4-bit ones (so a step δ is that
    much finer): the ranges a policy solves at."""
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1, (2 ** bits - 1) / 15


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("B,n", [(256, 512), (56, 100), (37, 33)])
def test_panel_matches_plain(cuda, B, n, bits):
    lo, hi, spread = _code_range(bits)
    g = torch.Generator(device=cuda).manual_seed(B + n)
    x = torch.randn(4 * B, B, generator=g, device=cuda)
    h_bb = x.T @ x / (4 * B) + 0.1 * torch.eye(B, device=cuda)
    h_bb[-3:, :] = 0
    h_bb[:, -3:] = 0                      # padded rows keep their code
    args = (h_bb, torch.randn(B, n, generator=g, device=cuda),
            torch.randn(B, n, generator=g, device=cuda) * 3 * spread,
            (torch.rand(n, generator=g, device=cuda) * 0.15 + 0.05) / spread,
            torch.full((n,), float(lo), device=cuda),
            torch.full((n,), float(hi), device=cuda),
            torch.diagonal(h_bb).contiguous())
    qk, dk = comq_panel.comq_panel_dq_cuda(*args)
    qp, dp = comq_panel.comq_panel_dq_plain(*args)
    assert float((qk == qp).float().mean()) >= 0.999
    assert torch.equal(qk[-3:], torch.clamp(torch.round(args[2][-3:]), lo,
                                            hi))
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


def _bf16_close(got, want):
    """The bf16 tolerance of both attention kernels: two bf16 ulps."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((d <= 8e-3 * want.abs() + 1e-3).all()), float(d.max())


@pytest.mark.parametrize("case", [
    dict(B=1, T=512, H=28, KV=4, hd=128, window=0),   # serve prefill
    dict(B=2, T=300, H=14, KV=2, hd=64, window=100),  # window edge
    dict(B=3, T=77, H=8, KV=8, hd=32, window=0),      # Tq % 64 != 0
    dict(B=1, T=200, H=16, KV=1, hd=256, window=0),   # group 16, hd 256
    dict(B=2, T=70, H=4, KV=2, hd=14, window=0)],     # 28-byte rows
    ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_flash_bf16_tensor_core_shapes(cuda, case):
    B, T, H, KV, hd, w = (case[k] for k in ("B", "T", "H", "KV", "hd",
                                             "window"))
    g = torch.Generator(device=cuda).manual_seed(T + hd)
    q, k, v = (torch.randn(B, T, n, hd, generator=g, device=cuda).bfloat16()
               for n in (H, KV, KV))
    got = flash_attention.flash_attention_cuda(q, k, v, window=w)
    want = flash_attention.flash_attention_plain(q, k, v, window=w)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, want)


def test_flash_bf16_reads_strided_views(cuda):
    """bf16 q/k/v as views into a fused (B, T, H+2KV, hd) buffer."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 40, 14 + 4, 32, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    _bf16_close(flash_attention.flash_attention_cuda(q, k, v),
                flash_attention.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("M,K,N", [(8, 3584, 512), (5, 300, 44),
                                   (70, 1000, 24), (8, 18944, 3584)])
@pytest.mark.parametrize("bits", [8, 4, 3, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_matches_plain(cuda, M, K, N, bits, dtype):
    """Every code width a policy stores (3-bit codes at cpb 2, values
    0..7), including the model's 8-bit w_down (K=18944, N=3584, cpb 1)
    and 2-bit wk (K=3584, N=512, cpb 4), with f32 and bf16 X."""
    g = torch.Generator(device=cuda).manual_seed(M + K + N + bits)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
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
    odd = torch.randn(1, 8, 2, 15, device=cuda).bfloat16()
    with pytest.raises(ValueError):    # bf16 rows copy in 4-byte units
        flash_attention.flash_attention_cuda(odd, odd, odd)


# ---------------------------------------------------------------------------
# the tiling edges of the redesigned comq_panel and quant_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 64, 1024])
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_tiling_edges(cuda, M, bits, dtype):
    """Both tile configurations (8 rows a block below M = 64, in one or
    more row tiles; then 128 / 64 rows), K off the 16-deep steps, N off a block's 128 code bytes, code rows
    whose width only allows 8-, 4- or 2-byte (plain) copies, and X rows
    of odd length (4-byte f32 / 2-byte bf16 copies) at K = 37."""
    K = (37, 300, 1000)[M % 3]
    N = 1000                       # code rows of 1000 / 500 / 250 bytes
    g = torch.Generator(device=cuda).manual_seed(M * 10 + bits)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    u = torch.randint(0, 2 ** bits, (K, N), generator=g, device=cuda,
                      dtype=torch.uint8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.04 + 0.01
    z = torch.randint(-(2 ** (bits - 1)), 0, (N,), generator=g,
                      device=cuda).float()
    codes, cpb = pack_codes(u, bits)
    got = quant_matmul.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
    want = quant_matmul.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("B,n", [(16, 1), (40, 5), (100, 130), (255, 4097),
                                 (256, 20000)])
def test_panel_tiling_edges(cuda, B, n, bits):
    """B below 256 and off the 16-row sub-panels, n off every column
    tile (4-32 a block), rows with h_tt <= 1e-12 inside the panel, at the
    code ranges of 2-, 3-, 4- and 8-bit leaves."""
    lo, hi, spread = _code_range(bits)
    g = torch.Generator(device=cuda).manual_seed(B * 7 + n)
    x = torch.randn(4 * B, B, generator=g, device=cuda)
    h_bb = x.T @ x / (4 * B) + 0.1 * torch.eye(B, device=cuda)
    dead = torch.arange(B, device=cuda) % 13 == 5     # h_tt = 0 rows
    h_bb[dead, :] = 0
    h_bb[:, dead] = 0
    qf = torch.randn(B, n, generator=g, device=cuda) * 3 * spread
    delta = (torch.rand(n, generator=g, device=cuda) * 0.15 + 0.05) / spread
    args = (h_bb, torch.randn(B, n, generator=g, device=cuda), qf, delta,
            torch.full((n,), float(lo), device=cuda),
            torch.full((n,), float(hi), device=cuda),
            torch.diagonal(h_bb).contiguous())
    qk, dk = comq_panel.comq_panel_dq_cuda(*args)
    qp, _ = comq_panel.comq_panel_dq_plain(*args)
    assert float((qk == qp).float().mean()) >= 0.999
    assert torch.equal(qk[dead], torch.clamp(torch.round(qf[dead]), lo, hi))
    assert torch.equal(dk, (qk - qf) * delta)


@pytest.mark.parametrize("M,K,NB,cpb,split,kc", [
    (8, 3584, 9472, 2, 8, 448), (8, 18944, 1792, 2, 37, 512),
    (1024, 3584, 9472, 2, 1, 3584), (3, 300, 500, 2, 3, 128),
    (8, 3584, 128, 4, 28, 128), (8, 3584, 256, 2, 28, 128),
    (8, 3584, 512, 1, 28, 128)])
def test_quant_matmul_plan(cuda, M, K, NB, cpb, split, kc):
    """The kernel's split-K plan on 132 SMs (an H100): about four blocks
    an SM where the tiles do not fill the card, runs of whole stages that
    cover K. The last three are the shapes whose order
    test_torch_kernel_numerics emulates at its KC."""
    for x_bf16 in (False, True):
        big, ksplit, kc_, ws = quant_matmul.plan(M, K, NB, cpb, x_bf16, 132)
        assert (big, ksplit, kc_) == (int(M >= 64), split, kc)
        assert (ksplit - 1) * kc_ < K <= ksplit * kc_
        planes = 0 if x_bf16 else -(-3 * M * K // 2)
        assert ws >= planes + (ksplit * M * NB * cpb if ksplit > 1 else 0)


def test_quant_matmul_captured_in_a_graph_keeps_its_workspace(cuda):
    """A call captured into a CUDA graph replays correctly, and writes
    nothing outside its own memory, after a larger eager call on the same
    stream has grown (and let go of) that stream's shared workspace."""
    g = torch.Generator(device=cuda).manual_seed(5)

    def inputs(M, K, N):
        u = torch.randint(0, 16, (K, N), generator=g, device=cuda,
                          dtype=torch.uint8)
        codes, cpb = pack_codes(u, 4)
        return (torch.randn(M, K, generator=g, device=cuda), codes,
                torch.rand(N, generator=g, device=cuda) * 0.04 + 0.01,
                torch.randint(-8, 0, (N,), generator=g, device=cuda).float(),
                cpb)

    x, codes, scale, z, cpb = inputs(8, 1024, 512)
    want = quant_matmul.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
    ws = quant_matmul.plan(8, 1024, codes.shape[1], cpb, False,
                           torch.cuda.get_device_properties(cuda)
                           .multi_processor_count)[3]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant_matmul.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = quant_matmul.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
        big = inputs(64, 8192, 4096)
        quant_matmul.quant_matmul_cuda(*big[:4], cpb=cpb)
        # the size the small call's buffer had: the allocator hands its
        # block on to this tensor
        junk = torch.full((ws,), float("nan"), device=cuda)
        y.zero_()
        graph.replay()
    torch.cuda.synchronize()
    assert bool(torch.isnan(junk).all())
    assert float((y - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_panel_and_qmm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    B, n = 32, 64
    h = torch.eye(B, device=cuda)
    m = torch.zeros(B, n, device=cuda)
    v = torch.ones(n, device=cuda)
    d = torch.ones(B, device=cuda)
    with pytest.raises(TypeError):      # f64 panel
        comq_panel.comq_panel_dq_cuda(h.double(), m, m, v, v, v, d)
    with pytest.raises(ValueError):     # strided s0
        comq_panel.comq_panel_dq_cuda(
            h, torch.zeros(B, 2 * n, device=cuda)[:, ::2], m, v, v, v, d)
    with pytest.raises(ValueError):     # hdiag of the wrong length
        comq_panel.comq_panel_dq_cuda(h, m, m, v, v, v, d[:-1])
    with pytest.raises(RuntimeError):   # CPU tensors never reach the kernel
        comq_panel.comq_panel_dq_cuda(h.cpu(), m.cpu(), m.cpu(), v.cpu(),
                                      v.cpu(), v.cpu(), d.cpu())
    big = comq_panel.max_b() + 1        # a panel past shared memory
    hb, mb = torch.eye(big, device=cuda), torch.zeros(big, 8, device=cuda)
    vb, db = torch.ones(8, device=cuda), torch.ones(big, device=cuda)
    with pytest.raises(ValueError, match=f"up to {big - 1}"):
        comq_panel.comq_panel_dq_cuda(hb, mb, mb, vb, vb, vb, db)
    comq_panel.comq_panel_dq_cuda(hb[:-1, :-1].contiguous(), mb[:-1],
                                  mb[:-1], vb, vb, vb, db[:-1])
    x = torch.randn(8, 64, device=cuda)
    codes = torch.zeros(64, 16, dtype=torch.uint8, device=cuda)
    s = torch.ones(32, device=cuda)
    for bad in (x.to(torch.int32), x.double()):
        with pytest.raises(TypeError):
            quant_matmul.quant_matmul_cuda(bad, codes, s, s, cpb=2)
    with pytest.raises(ValueError):     # cpb 3
        quant_matmul.quant_matmul_cuda(x, codes, s, s, cpb=3)
    with pytest.raises(ValueError):     # codes of the wrong K
        quant_matmul.quant_matmul_cuda(x, codes[:-1], s, s, cpb=2)
    with pytest.raises(TypeError):      # bf16 scale
        quant_matmul.quant_matmul_cuda(x, codes, s.bfloat16(), s, cpb=2)


# ---------------------------------------------------------------------------
# paged_attention / paged_attention_quant
# ---------------------------------------------------------------------------

def _paged_inputs(dev, B, H, KV, hd, NB, BS, MAXB, lengths, dtype, seed):
    """q (B, H, hd), f32 pages (NB, BS, KV, hd), a table of distinct random
    pages per slot, int32 lengths."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(NB, BS, KV, hd, generator=g, device=dev)
    v = torch.randn(NB, BS, KV, hd, generator=g, device=dev)
    bt = torch.stack([torch.randperm(NB, generator=g, device=dev)[:MAXB]
                      for _ in range(B)]).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, bt, lens


def _quantize_pool(pool, kv_bits):
    from repro_torch.serve.kv_cache import kv_encode, kv_scale_of
    scale = kv_scale_of(pool.abs().amax(dim=(1, 3)), kv_bits)   # (NB, KV)
    codes = kv_encode(pool, scale[:, None], kv_bits)
    return codes.contiguous(), scale.contiguous()


def _paged_diff(got, want, lens):
    """|got - want| and |want| in f32, after checking that zero-length
    slots are exactly 0."""
    assert bool((got[lens == 0] == 0).all()), "zero-length slots must be 0"
    got, want = got.float(), want.float()
    return (got - want).abs(), want.abs()


PAGED_CASES = [
    dict(H=28, KV=4, hd=128, lengths=[1, 4096, 0, 1000, 17, 2500]),  # G 7
    dict(H=4, KV=4, hd=64, lengths=[33, 0, 700]),                     # G 1
    dict(H=14, KV=2, hd=16, lengths=[5, 300, 0]),                     # G 7
]


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c['H']}-KV{c['KV']}-hd{c['hd']}")
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_matches_plain(cuda, case, window, dtype):
    from repro_torch.kernels import paged_attention as pa
    BS, MAXB = 16, 256
    NB = MAXB * len(case["lengths"])
    q, k, v, bt, lens = _paged_inputs(cuda, len(case["lengths"]), case["H"],
                                      case["KV"], case["hd"], NB, BS, MAXB,
                                      case["lengths"], dtype, seed=case["H"])
    k, v = k.to(dtype), v.to(dtype)
    got = pa.paged_attention_cuda(q, k, v, bt, lens, window=window)
    want = pa.paged_attention_plain(q, k, v, bt, lens, window=window)
    assert got.dtype == dtype
    d, w = _paged_diff(got, want, lens)
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-4
    else:
        assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=lambda c: f"H{c['H']}-KV{c['KV']}-hd{c['hd']}")
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_matches_plain(cuda, case, kv_bits, window,
                                             dtype):
    from repro_torch.kernels import paged_attention as pa
    BS, MAXB = 16, 256
    NB = MAXB * len(case["lengths"])
    q, k, v, bt, lens = _paged_inputs(cuda, len(case["lengths"]), case["H"],
                                      case["KV"], case["hd"], NB, BS, MAXB,
                                      case["lengths"], dtype, seed=case["hd"])
    kq, ks = _quantize_pool(k, kv_bits)
    vq, vs = _quantize_pool(v, kv_bits)
    got = pa.paged_attention_quant_cuda(q, kq, vq, ks, vs, bt, lens,
                                        window=window, kv_bits=kv_bits)
    want = pa.paged_attention_quant_plain(q, kq, vq, ks, vs, bt, lens,
                                          window=window, kv_bits=kv_bits)
    d, w = _paged_diff(got, want, lens)
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-4
    else:
        assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


def test_paged_attention_odd_rows_and_small_pages(cuda):
    """Rows whose bytes allow only narrow loads (hd 14: 28-byte bf16 rows,
    7-byte 4-bit rows) and BS 4 pages over many splits."""
    from repro_torch.kernels import paged_attention as pa
    q, k, v, bt, lens = _paged_inputs(cuda, 3, 4, 2, 14, 90, 4, 30,
                                      [117, 4, 0], torch.bfloat16, seed=3)
    got = pa.paged_attention_cuda(q, k.bfloat16(), v.bfloat16(), bt, lens)
    want = pa.paged_attention_plain(q, k.bfloat16(), v.bfloat16(), bt, lens)
    assert bool(((got.float() - want.float()).abs()
                 <= 8e-3 * want.float().abs() + 1e-3).all())
    kq, ks = _quantize_pool(k, 4)
    vq, vs = _quantize_pool(v, 4)
    got = pa.paged_attention_quant_cuda(q.float(), kq, vq, ks, vs, bt, lens,
                                        window=6, kv_bits=4)
    want = pa.paged_attention_quant_plain(q.float(), kq, vq, ks, vs, bt, lens,
                                          window=6, kv_bits=4)
    assert float((got - want).abs().max()) <= 1e-4
    assert bool((got[2] == 0).all())


@pytest.mark.parametrize("case", [
    # ends mid-page and mid-tile, and at the 256-token split boundary +-1
    dict(H=28, KV=4, hd=128, window=0,
         lengths=[255, 256, 257, 511, 513, 37, 70, 1]),
    dict(H=28, KV=4, hd=128, window=1024,       # qwen2's group of 7
         lengths=[4096, 1023, 1025, 2000, 0, 3333]),
    dict(H=16, KV=1, hd=32, window=0, lengths=[100, 300]),     # group 16
    dict(H=8, KV=4, hd=256, window=50, lengths=[700, 64, 5])],  # hd 256
    ids=lambda c: f"H{c['H']}-KV{c['KV']}-hd{c['hd']}-w{c['window']}")
def test_paged_attention_bf16_tensor_core_shapes(cuda, case):
    from repro_torch.kernels import paged_attention as pa
    BS, MAXB = 16, 256
    lens_l = case["lengths"]
    NB = MAXB * len(lens_l)
    q, k, v, bt, lens = _paged_inputs(cuda, len(lens_l), case["H"],
                                      case["KV"], case["hd"], NB, BS, MAXB,
                                      lens_l, torch.bfloat16, seed=len(lens_l))
    k, v = k.bfloat16(), v.bfloat16()
    got = pa.paged_attention_cuda(q, k, v, bt, lens, window=case["window"])
    want = pa.paged_attention_plain(q, k, v, bt, lens, window=case["window"])
    d, w = _paged_diff(got, want, lens)
    assert got.dtype == torch.bfloat16
    assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


def test_paged_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels import paged_attention as pa
    q, k, v, bt, lens = _paged_inputs(cuda, 2, 4, 2, 16, 8, 4, 4, [3, 5],
                                      torch.float32, seed=0)
    with pytest.raises(TypeError):
        pa.paged_attention_cuda(q.half(), k, v, bt, lens)
    with pytest.raises(TypeError):
        pa.paged_attention_cuda(q, k, v, bt.long(), lens)
    with pytest.raises(ValueError):
        pa.paged_attention_cuda(q[:, :3], k, v, bt, lens)     # 3 % 2 != 0
    odd = _paged_inputs(cuda, 2, 4, 2, 15, 8, 4, 4, [3, 5], torch.bfloat16,
                        seed=0)
    with pytest.raises(ValueError):    # bf16 rows copy in 4-byte units
        pa.paged_attention_cuda(odd[0], odd[1].bfloat16(), odd[2].bfloat16(),
                                *odd[3:])
    kq, ks = _quantize_pool(k, 8)
    with pytest.raises(TypeError):     # uint8 codes at kv_bits 8
        pa.paged_attention_quant_cuda(q, kq.view(torch.uint8),
                                      kq.view(torch.uint8), ks, ks, bt, lens,
                                      kv_bits=8)


# bf16 q over int8 / 4-bit pools: the tensor-core kernel for codes
QUANT_TC_CASES = [
    # qwen2's group of 7 at hd 128, 16-token pages: split and tile edges
    dict(H=28, KV=4, hd=128, BS=16, window=0,
         lengths=[255, 256, 257, 1, 0, 2048]),
    # group 1, hd 64, 4-token pages, a window that starts mid-page
    dict(H=4, KV=4, hd=64, BS=4, window=37, lengths=[700, 0, 33, 3]),
    # group 16, hd 256, 32-token pages, a window that starts mid-page
    dict(H=16, KV=1, hd=256, BS=32, window=100, lengths=[1000, 5, 0]),
    # group 7, 32-token pages, window 1024 starting mid-page
    dict(H=14, KV=2, hd=128, BS=32, window=1024, lengths=[1500, 64, 0]),
]


@pytest.mark.parametrize("case", QUANT_TC_CASES, ids=lambda c: (
    f"H{c['H']}-KV{c['KV']}-hd{c['hd']}-BS{c['BS']}-w{c['window']}"))
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_quant_tensor_cores_match_plain(cuda, case, kv_bits):
    from repro_torch.kernels import paged_attention as pa
    lens_l, BS = case["lengths"], case["BS"]
    MAXB = -(-max(lens_l) // BS) + 1
    q, k, v, bt, lens = _paged_inputs(cuda, len(lens_l), case["H"],
                                      case["KV"], case["hd"],
                                      MAXB * len(lens_l), BS, MAXB, lens_l,
                                      torch.bfloat16, seed=case["hd"] + BS)
    kq, ks = _quantize_pool(k, kv_bits)
    vq, vs = _quantize_pool(v, kv_bits)
    assert pa.quant_kernel(q.dtype, kv_bits, case["hd"], BS) == pa.TENSOR_CORE
    before = pa.launches_quant_tc
    got = pa.paged_attention_quant_cuda(q, kq, vq, ks, vs, bt, lens,
                                        window=case["window"],
                                        kv_bits=kv_bits)
    want = pa.paged_attention_quant_plain(q, kq, vq, ks, vs, bt, lens,
                                          window=case["window"],
                                          kv_bits=kv_bits)
    assert pa.launches_quant_tc == before + 1
    assert got.dtype == torch.bfloat16
    d, w = _paged_diff(got, want, lens)
    assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_quant_tensor_cores_read_a_page_out_of_range_as_zero(
        cuda, kv_bits):
    """A page id past the pool reads as a zero row with scale 0: the result
    of a real all-zero page with scale 0 in its place."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve.kv_cache import kv_encode
    H, KV, hd, BS, MAXB, NB = 28, 4, 128, 16, 40, 80
    q, k, v, bt, lens = _paged_inputs(cuda, 2, H, KV, hd, NB, BS, MAXB,
                                      [600, 300], torch.bfloat16, seed=9)
    kq, ks = _quantize_pool(k, kv_bits)
    vq, vs = _quantize_pool(v, kv_bits)
    bt[0, 5] = NB
    bt[1, 3] = 1000
    zero_scale = torch.zeros(1, KV, device=cuda)
    zero_page = kv_encode(torch.zeros(1, BS, KV, hd, device=cuda),
                          zero_scale[:, None], kv_bits)
    bt_ref = torch.where(bt >= NB, torch.full_like(bt, NB), bt)
    want = pa.paged_attention_quant_plain(
        q, torch.cat([kq, zero_page]), torch.cat([vq, zero_page]),
        torch.cat([ks, zero_scale]), torch.cat([vs, zero_scale]), bt_ref,
        lens, kv_bits=kv_bits)
    got = pa.paged_attention_quant_cuda(q, kq, vq, ks, vs, bt, lens,
                                        kv_bits=kv_bits)
    d, w = _paged_diff(got, want, lens)
    assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


# ---------------------------------------------------------------------------
# the MoE family (granite-moe-3b-a800m's shapes): the expert-batched
# comq_panel launch, and the other kernels at 24 query / 8 KV heads, hd 64
# ---------------------------------------------------------------------------

def _panel_stack(dev, E, B, n, seed):
    """E random panels: h_bb (E, B, B), s0 / qf (E, B, n), delta / z_lo /
    z_hi (E, n), hdiag (E, B); the last 3 rows of expert 0 are padding."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(E, 4 * B, B, generator=g, device=dev)
    h = (torch.bmm(x.transpose(1, 2), x) / (4 * B)
         + 0.1 * torch.eye(B, device=dev))
    h[0, -3:, :] = 0
    h[0, :, -3:] = 0
    return (h, torch.randn(E, B, n, generator=g, device=dev),
            torch.randn(E, B, n, generator=g, device=dev) * 3,
            torch.rand(E, n, generator=g, device=dev) * 0.15 + 0.05,
            torch.full((E, n), -8.0, device=dev),
            torch.full((E, n), 7.0, device=dev),
            torch.diagonal(h, dim1=1, dim2=2).contiguous())


@pytest.mark.parametrize("E,B,n", [(1, 256, 1024), (4, 256, 512),
                                   (40, 256, 1024), (4, 37, 33),
                                   (40, 64, 6)])
def test_panel_batched_matches_plain_and_single_launches(cuda, E, B, n):
    """One launch for E experts: >= 99.9% of codes equal to the plain
    version, and each expert's result equal, bit for bit, to a launch on
    its own slices (the per-column code is the single-panel kernel's)."""
    args = _panel_stack(cuda, E, B, n, seed=E * B + n)
    before = (comq_panel.launches, comq_panel.launches_batched)
    qk, dk = comq_panel.comq_panel_dq_cuda(*args)
    assert (comq_panel.launches, comq_panel.launches_batched) == (
        before[0] + 1, before[1] + (E > 1))
    qp, _ = comq_panel.comq_panel_dq_plain(*args)
    assert qk.shape == (E, B, n)
    assert float((qk == qp).float().mean()) >= 0.999
    for e in range(E):
        q1, d1 = comq_panel.comq_panel_dq_cuda(*(a[e].contiguous()
                                                 for a in args))
        assert torch.equal(qk[e], q1) and torch.equal(dk[e], d1)


def test_panel_batched_wrapper_refuses_bad_stacks(cuda):
    h, s0, qf, d, lo, hi, hd = _panel_stack(cuda, 3, 16, 8, seed=0)
    with pytest.raises(ValueError):     # hdiag of another expert count
        comq_panel.comq_panel_dq_cuda(h, s0, qf, d, lo, hi, hd[:2])
    with pytest.raises(ValueError):     # a second leading axis
        comq_panel.comq_panel_dq_cuda(h[None], s0[None], qf[None], d[None],
                                      lo[None], hi[None], hd[None])
    with pytest.raises(ValueError):     # one panel's delta for a stack
        comq_panel.comq_panel_dq_cuda(h, s0, qf, d[0], lo, hi, hd)


def test_batched_blocked_solve_on_the_card(cuda):
    """comq_quantize_blocked_experts with the batched kernel against the
    same solve with the plain panel version."""
    from repro_torch.core.comq_hessian import comq_quantize_blocked_experts
    from repro_torch.core.quantizer import QuantSpec
    g = torch.Generator(device=cuda).manual_seed(3)
    E, N, m, n = 6, 300, 200, 96
    xs = torch.randn(E, N, m, generator=g, device=cuda)
    hs = torch.bmm(xs.transpose(1, 2), xs)
    ws = torch.randn(E, m, n, generator=g, device=cuda)
    spec = QuantSpec(bits=4, lam=0.9)
    before = comq_panel.launches_batched
    rk = comq_quantize_blocked_experts(hs, ws, spec, block=64)
    assert comq_panel.launches_batched - before == 4 * spec.sweeps
    rp = comq_quantize_blocked_experts(
        hs, ws, spec, block=64, panel_fn=comq_panel.comq_panel_dq_plain)
    assert float((rk.q == rp.q).float().mean()) >= 0.999
    torch.testing.assert_close(rk.errors, rp.errors, rtol=1e-3, atol=0)


@pytest.mark.parametrize("B,T", [(8, 128), (1, 512), (2, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_granite_heads(cuda, B, T, dtype):
    g = torch.Generator(device=cuda).manual_seed(B * T)
    q, k, v = (torch.randn(B, T, n, 64, generator=g, device=cuda).to(dtype)
               for n in (24, 8, 8))
    got = flash_attention.flash_attention_cuda(q, k, v)
    want = flash_attention.flash_attention_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_attention_granite_heads(cuda, dtype, window):
    from repro_torch.kernels import paged_attention as pa
    lens_l, BS, MAXB = [1, 544, 0, 255, 257, 100, 17, 33], 16, 40
    q, k, v, bt, lens = _paged_inputs(cuda, 8, 24, 8, 64, 8 * MAXB, BS,
                                      MAXB, lens_l, dtype, seed=window + 1)
    if dtype == torch.bfloat16:
        k, v = k.bfloat16(), v.bfloat16()
    got = pa.paged_attention_cuda(q, k, v, bt, lens, window=window)
    want = pa.paged_attention_plain(q, k, v, bt, lens, window=window)
    d, w = _paged_diff(got, want, lens)
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-4
    else:
        assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_granite_heads(cuda, kv_bits, dtype):
    """bf16 q takes the tensor-core kernel at hd 64 (group 3), f32 q the
    CUDA-core one."""
    from repro_torch.kernels import paged_attention as pa
    lens_l, BS, MAXB = [1, 544, 0, 255, 257, 100, 17, 33], 16, 40
    q, k, v, bt, lens = _paged_inputs(cuda, 8, 24, 8, 64, 8 * MAXB, BS,
                                      MAXB, lens_l, dtype, seed=kv_bits)
    kq, ks = _quantize_pool(k, kv_bits)
    vq, vs = _quantize_pool(v, kv_bits)
    tc = dtype == torch.bfloat16
    assert (pa.quant_kernel(dtype, kv_bits, 64, BS) == pa.TENSOR_CORE) == tc
    before = pa.launches_quant_tc
    got = pa.paged_attention_quant_cuda(q, kq, vq, ks, vs, bt, lens,
                                        kv_bits=kv_bits)
    want = pa.paged_attention_quant_plain(q, kq, vq, ks, vs, bt, lens,
                                          kv_bits=kv_bits)
    assert pa.launches_quant_tc == before + tc
    d, w = _paged_diff(got, want, lens)
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-4
    else:
        assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


@pytest.mark.parametrize("N", [1536, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_granite_shapes(cuda, N, dtype):
    """granite's attention projections at decode: M=8, K=1536, 4-bit."""
    M, K = 8, 1536
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    u = torch.randint(0, 16, (K, N), generator=g, device=cuda,
                      dtype=torch.uint8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.04 + 0.01
    z = torch.randint(-8, 0, (N,), generator=g, device=cuda).float()
    codes, cpb = pack_codes(u, 4)
    got = quant_matmul.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
    want = quant_matmul.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


# hymba-1.5b: 25/5 heads (group 5), hd 64, a 1024-token window at every
# layer; its projections at decode (M=8): K=1600 (= 25 x 64) into wq/wo
# (N=1600), wk/wv (N=320) and w_gate/w_up (N=5504), w_down K=5504; w_in's
# 6400-column panels
@pytest.mark.parametrize("B,T", [(2, 128), (1, 1016), (1, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_hymba_heads_and_window(cuda, B, T, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + 5)
    q, k, v = (torch.randn(B, T, n, 64, generator=g, device=cuda).to(dtype)
               for n in (25, 5, 5))
    got = flash_attention.flash_attention_cuda(q, k, v, window=1024)
    want = flash_attention.flash_attention_plain(q, k, v, window=1024)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("K,N", [(1600, 320), (1600, 1600), (1600, 5504),
                                 (5504, 1600)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_hymba_shapes(cuda, K, N, dtype):
    M = 8
    g = torch.Generator(device=cuda).manual_seed(K + N)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    u = torch.randint(0, 16, (K, N), generator=g, device=cuda,
                      dtype=torch.uint8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.04 + 0.01
    z = torch.randint(-8, 0, (N,), generator=g, device=cuda).float()
    codes, cpb = pack_codes(u, 4)
    got = quant_matmul.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
    want = quant_matmul.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_panel_hymba_w_in_width(cuda):
    """B=256 against w_in's 6400 columns (d_model 1600 -> 2 x 3200)."""
    B, n = 256, 6400
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(4 * B, B, generator=g, device=cuda)
    h_bb = x.T @ x / (4 * B) + 0.1 * torch.eye(B, device=cuda)
    args = (h_bb, torch.randn(B, n, generator=g, device=cuda),
            torch.randn(B, n, generator=g, device=cuda) * 3,
            torch.rand(n, generator=g, device=cuda) * 0.15 + 0.05,
            torch.full((n,), -8.0, device=cuda),
            torch.full((n,), 7.0, device=cuda),
            torch.diagonal(h_bb).contiguous())
    qk, dk = comq_panel.comq_panel_dq_cuda(*args)
    qp, dp = comq_panel.comq_panel_dq_plain(*args)
    assert float((qk == qp).float().mean()) >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_h2o_danube_heads_and_window(cuda, dtype):
    """h2o-danube-1.8b: 32/8 heads at hd 80 (a head width no other config
    runs: five 16-wide k steps) and a 4096-token window that binds at
    T=4608."""
    g = torch.Generator(device=cuda).manual_seed(80)
    q, k, v = (torch.randn(1, 4608, n, 80, generator=g, device=cuda).to(dtype)
               for n in (32, 8, 8))
    got = flash_attention.flash_attention_cuda(q, k, v, window=4096)
    want = flash_attention.flash_attention_plain(q, k, v, window=4096)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(got, want)


# musicgen-large: 32/32 heads (group 1: MHA), hd 64; its decode projections
# (M=8): K=2048 into wq/wk/wv/wo (N=2048) and w_up (N=8192), w_down K=8192.
# rwkv6-7b: the panel against channel-mix w_k's 14336 columns
@pytest.mark.parametrize("B,T", [(8, 128), (1, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_musicgen_heads(cuda, B, T, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + 32)
    q, k, v = (torch.randn(B, T, 32, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    got = flash_attention.flash_attention_cuda(q, k, v)
    want = flash_attention.flash_attention_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_pair_musicgen_heads(cuda, kv_bits, dtype):
    """Group 1: the tensor-core kernels pad one query row a KV head to a
    16-row fragment; bf16 pages, int8 and 4-bit codes."""
    from repro_torch.kernels import paged_attention as pa
    lens_l, BS, MAXB = [1, 544, 0, 255, 257, 100, 17, 33], 16, 40
    q, k, v, bt, lens = _paged_inputs(cuda, 8, 32, 32, 64, 8 * MAXB, BS,
                                      MAXB, lens_l, dtype, seed=kv_bits + 7)
    if kv_bits:
        kq, ks = _quantize_pool(k, kv_bits)
        vq, vs = _quantize_pool(v, kv_bits)
        tc = dtype == torch.bfloat16
        assert (pa.quant_kernel(dtype, kv_bits, 64, BS)
                == pa.TENSOR_CORE) == tc
        before = pa.launches_quant_tc
        got = pa.paged_attention_quant_cuda(q, kq, vq, ks, vs, bt, lens,
                                            kv_bits=kv_bits)
        want = pa.paged_attention_quant_plain(q, kq, vq, ks, vs, bt, lens,
                                              kv_bits=kv_bits)
        assert pa.launches_quant_tc == before + tc
    else:
        if dtype == torch.bfloat16:
            k, v = k.bfloat16(), v.bfloat16()
        got = pa.paged_attention_cuda(q, k, v, bt, lens)
        want = pa.paged_attention_plain(q, k, v, bt, lens)
    d, w = _paged_diff(got, want, lens)
    if dtype == torch.float32:
        assert float(d.max()) <= 1e-4
    else:
        assert bool((d <= 8e-3 * w + 1e-3).all()), float(d.max())


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 8192), (8192, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_musicgen_shapes(cuda, K, N, dtype):
    M = 8
    g = torch.Generator(device=cuda).manual_seed(K + 2 * N)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    u = torch.randint(0, 16, (K, N), generator=g, device=cuda,
                      dtype=torch.uint8)
    scale = torch.rand(N, generator=g, device=cuda) * 0.04 + 0.01
    z = torch.randint(-8, 0, (N,), generator=g, device=cuda).float()
    codes, cpb = pack_codes(u, 4)
    got = quant_matmul.quant_matmul_cuda(x, codes, scale, z, cpb=cpb)
    want = quant_matmul.quant_matmul_plain(x, codes, scale, z, cpb=cpb)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.parametrize("n", [4096, 14336])
def test_panel_rwkv_widths(cuda, n):
    """B=256 against rwkv's 4096-column time-mix leaves and channel-mix
    w_k's 14336 columns."""
    B = 256
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(4 * B, B, generator=g, device=cuda)
    h_bb = x.T @ x / (4 * B) + 0.1 * torch.eye(B, device=cuda)
    args = (h_bb, torch.randn(B, n, generator=g, device=cuda),
            torch.randn(B, n, generator=g, device=cuda) * 3,
            torch.rand(n, generator=g, device=cuda) * 0.15 + 0.05,
            torch.full((n,), -8.0, device=cuda),
            torch.full((n,), 7.0, device=cuda),
            torch.diagonal(h_bb).contiguous())
    qk, dk = comq_panel.comq_panel_dq_cuda(*args)
    qp, dp = comq_panel.comq_panel_dq_plain(*args)
    assert float((qk == qp).float().mean()) >= 0.999


NONCAUSAL_CASES = [
    dict(B=8, Tq=128, Tk=1601, H=64, KV=8, hd=128),   # VLM cross prefill
    dict(B=8, Tq=1, Tk=1601, H=64, KV=8, hd=128),     # VLM cross decode
    dict(B=8, Tq=197, Tk=197, H=12, KV=12, hd=64),    # vit-base-16
    dict(B=2, Tq=12, Tk=17, H=4, KV=2, hd=16),        # VLM smoke cross
    dict(B=3, Tq=65, Tk=64, H=8, KV=1, hd=32)]        # Tq one past a tile


@pytest.mark.parametrize("case", NONCAUSAL_CASES,
                         ids=lambda c: "-".join(f"{k}{v}"
                                                for k, v in c.items()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_noncausal_matches_plain(cuda, case, dtype):
    """causal=0 with Tq != Tk: ragged Tk (1601 = 25 tiles of 64 + 1 key:
    the last tile scores its 63 absent keys -inf), one query row in a
    block, Tq ending mid-warp, group 8 at hd 128."""
    B, Tq, Tk, H, KV, hd = (case[k] for k in ("B", "Tq", "Tk", "H", "KV",
                                               "hd"))
    g = torch.Generator(device=cuda).manual_seed(Tq + Tk)
    q = torch.randn(B, Tq, H, hd, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(B, Tk, KV, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    got = flash_attention.flash_attention_cuda(q, k, v, causal=False)
    want = flash_attention.flash_attention_plain(q, k, v, causal=False)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_noncausal_reads_a_strided_image_cache(cuda, dtype):
    """The cross layer's K/V as non-contiguous views: group 1 of an image
    cache that holds K and V side by side, (G, B, N, 2, KV, hd)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    xkv = torch.randn(2, 3, 1601, 2, 8, 128, generator=g,
                      device=cuda).to(dtype)
    k, v = xkv[1, :, :, 0], xkv[1, :, :, 1]
    assert not k.is_contiguous()
    q = torch.randn(3, 5, 64, 128, generator=g, device=cuda).to(dtype)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=False)
    want = flash_attention.flash_attention_plain(q, k, v, causal=False)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _bf16_close(got, want)


def test_model_noncausal_attention_launches_the_kernel(cuda):
    """models.attention.flash_attention(causal=False) on CUDA tensors runs
    csrc/flash_attention.cu (the launch counter moves), as the encoder's
    layers and the VLM's cross layers call it."""
    from repro_torch.models import attention
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 7, 8, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, 33, 2, 64, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    n0 = flash_attention.launches
    s0 = flash_attention.launches_single_query
    got = attention.flash_attention(q, k, v, None, causal=False)
    assert flash_attention.launches == n0 + 1
    _bf16_close(got, flash_attention.flash_attention_plain(q, k, v,
                                                           causal=False))
    attention.flash_attention(q[:, :1], k, v, None, causal=False)
    assert flash_attention.launches == n0 + 2
    assert flash_attention.launches_single_query == s0 + 1   # Tq = 1


@pytest.mark.parametrize("n", [1024, 8192, 28672])
def test_panel_vlm_widths(cuda, n):
    """B=256 against llama-3.2-vision's leaves: wk / wv (1024 columns), wq
    / wo / w_down (8192), w_gate / w_up (28672)."""
    B = 256
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    x = torch.randn(4 * B, B, generator=g, device=cuda)
    h_bb = x.T @ x / (4 * B) + 0.1 * torch.eye(B, device=cuda)
    args = (h_bb, torch.randn(B, n, generator=g, device=cuda),
            torch.randn(B, n, generator=g, device=cuda) * 3,
            torch.rand(n, generator=g, device=cuda) * 0.15 + 0.05,
            torch.full((n,), -8.0, device=cuda),
            torch.full((n,), 7.0, device=cuda),
            torch.diagonal(h_bb).contiguous())
    qk, dk = comq_panel.comq_panel_dq_cuda(*args)
    qp, dp = comq_panel.comq_panel_dq_plain(*args)
    assert float((qk == qp).float().mean()) >= 0.999


def test_decode_step_annotation_holds_the_paged_kernel(cuda, tmp_path):
    """The device bridge: a traced decode step's `decode_step` span is a
    torch.profiler user annotation, and the paged-attention kernel it
    launched falls inside it (by the launch call's correlation id, or by
    the kernel's interval where the launch call was not recorded)."""
    import json

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.obs import Tracer
    from repro_torch.serve import Runtime, ServeConfig
    cfg = get_smoke_config("qwen2-7b")
    rt = Runtime(init_params(cfg, seed=0, device=cuda), cfg, BuildPlan(),
                 ServeConfig(max_slots=2, block_size=16, num_blocks=8,
                             buckets=(16,), max_blocks_per_slot=4),
                 device=cuda, tracer=Tracer())
    rs = np.random.RandomState(0)
    for n in (9, 12):
        rt.submit(rs.randint(0, cfg.vocab_size, (n,)), max_new_tokens=4)
    rt.step()                            # the prefills and a first step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.step()
        torch.cuda.synchronize()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in evs
             if e.get("cat") == "user_annotation"
             and e["name"] == "decode_step"]
    launches = {e["args"]["correlation"]: e["ts"] for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and "paged_" in e["name"]]
    assert len(spans) == 1 and kernels
    a, b = spans[0]
    for k in kernels:
        t = launches.get(k["args"].get("correlation"))
        t0, t1 = (t, t) if t is not None else (k["ts"], k["ts"] + k["dur"])
        assert a <= t0 and t1 <= b, (k["name"], t0, t1, a, b)
    assert [e["name"] for e in rt.tracer.events].count("decode_step") == 2


# ---------------------------------------------------------------------------
# distribution on the card: 2 gloo ranks sharing the card, smoke size
# ---------------------------------------------------------------------------

def test_column_sharded_walk_on_the_card_is_the_meshless_walk(cuda,
                                                              tmp_path):
    """model 2 (data 1): every leaf's codes, zero-points and scales of the
    column-sharded walk equal the meshless walk's bit for bit, on both
    ranks (the panel kernel solves each rank's column slice)."""
    import numpy as np

    from torch_dist_worker import spawn
    tok = np.random.RandomState(3).randint(0, 256, (4, 48)).astype(np.int32)
    out = spawn("walk", {"archs": {"qwen2-7b": {"params": None,
                                                "tokens": tok}},
                         "spec": dict(bits=4, granularity="per_channel",
                                      lam=0.9, sweeps=2, order="greedy"),
                         "method": "comq_blocked", "mesh": (1, 2)}, 2,
                tmp_path, device="cuda", backend="gloo")
    single = out[0][("qwen2-7b", "single")]["codes"]
    for r in out:
        sh = r[("qwen2-7b", "mesh")]["codes"]
        assert sorted(sh) == sorted(single)
        for k in single:
            for f in ("codes", "z_lo", "scale"):
                assert np.array_equal(sh[k][f], single[k][f]), (k, f)


def test_sharded_runtime_on_the_card_is_the_meshless_runtime(cuda,
                                                             tmp_path):
    """Runtime(mesh=) over 2 gloo ranks sharing the card (model 2): greedy
    tokens equal the meshless runtime's at int8 and f32 pages; each rank
    launches the paged kernels and no collective inside the step."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import BuildPlan, init_params
    from repro_torch.serve import Runtime, ServeConfig
    from torch_dist_worker import spawn
    sc = dict(max_slots=4, block_size=8, num_blocks=16, buckets=(8, 16),
              max_blocks_per_slot=4)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32)
               for n in (9, 14, 7, 12)]
    out = spawn("serve", {"arch": "qwen2-7b",
                          "cfg": {"compute_dtype": "float32"},
                          "params": None, "prompts": prompts, "sc": sc,
                          "kv_bits": (8, 0), "max_new": 8,
                          "cache_dtype": "float32"}, 2, tmp_path,
                device="cuda", backend="gloo")
    cfg = get_smoke_config("qwen2-7b").replace(compute_dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    for kv in (8, 0):
        want = [t.tolist() for t in Runtime(
            params, cfg, BuildPlan(cache_dtype=torch.float32, kv_bits=kv),
            ServeConfig(**sc), device=cuda).generate(prompts,
                                                     max_new_tokens=8)]
        for r in out:
            assert r[kv]["tokens"] == want
            assert r[kv]["counts"]["inside"] == 0
            assert r[kv]["paged_launches"] > 0


# ---------------------------------------------------------------------------
# the flash-attention backward kernel (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------

BWD_CASES = [
    dict(B=2, Tq=64, Tk=64, H=14, KV=2, hd=16, causal=True, window=0),
    dict(B=1, Tq=96, Tk=96, H=14, KV=2, hd=32, causal=True, window=40),
    dict(B=2, Tq=33, Tk=77, H=8, KV=2, hd=64, causal=False, window=0),
    dict(B=2, Tq=197, Tk=197, H=12, KV=12, hd=64, causal=False, window=0),
    dict(B=2, Tq=130, Tk=130, H=28, KV=4, hd=128, causal=True, window=0),
    dict(B=1, Tq=40, Tk=40, H=4, KV=1, hd=256, causal=True, window=0),
    dict(B=1, Tq=5, Tk=19, H=6, KV=3, hd=20, causal=False, window=0),
    # near-hard softmax rows (score std ~130, as the random init's)
    dict(B=2, Tq=64, Tk=64, H=28, KV=4, hd=128, causal=True, window=0,
         qscale=12)]


def _bwd_inputs(dev, c, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(c["B"], c["Tq"], c["H"], c["hd"], generator=g,
                     device=dev) * c.get("qscale", 1)).to(dtype)
    k, v = (torch.randn(c["B"], c["Tk"], c["KV"], c["hd"], generator=g,
                        device=dev).to(dtype) for _ in range(2))
    do = torch.randn(c["B"], c["Tq"], c["H"], c["hd"], generator=g,
                     device=dev).to(dtype)
    return q, k, v, do


def _plain_grads(q, k, v, do, causal, window):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention.flash_attention_plain(*leaves, causal=causal,
                                                window=window)
    out.backward(do)
    return [t.grad for t in leaves]


def _grad_close(got, want, dtype, what):
    """The backward's tolerance (kernels/flash_attention.py docstring)."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    rel_max, rel = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 8e-3)
    bad = (got - want).abs() > rel_max * top + rel * want.abs()
    assert not bool(bad.any()), (what, float((got - want).abs().max()), top)


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(
    f"{k}{int(v)}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain_autograd(cuda, case, dtype):
    """dQ, dK, dV of the backward kernel against the plain version's
    autograd graph, and the forward's LSE against logsumexp: causal,
    window, non-causal with Tq != Tk, T off the tiles (197), group 1 to 7,
    hd 16 to 256 (20: not a multiple of 4)."""
    c = case
    q, k, v, do = _bwd_inputs(cuda, c, dtype, c["Tq"] + c["hd"])
    _, lse = flash_attention._forward(q, k, v, c["causal"], c["window"],
                                      with_lse=True)
    want_lse = flash_attention.attention_lse_plain(
        q, k, causal=c["causal"], window=c["window"])
    assert bool(((lse - want_lse).abs()
                 <= 1e-4 + 1e-5 * want_lse.abs()).all())
    n0 = flash_attention.launches_bwd
    got = flash_attention.flash_attention_bwd_cuda(
        q, k, v, do, lse, causal=c["causal"], window=c["window"])
    assert flash_attention.launches_bwd == n0 + 1
    want = _plain_grads(q, k, v, do, c["causal"], c["window"])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _grad_close(a, b, dtype, name)


def _bwd_plan(c):
    from repro_torch.kernels import build
    return flash_attention.plan_bwd(
        c["B"], c["Tq"], c["Tk"], c["H"], c["KV"], c["hd"],
        build.sm_count(torch.cuda.current_device()))


@pytest.mark.parametrize("T", [50, 520])
def test_flash_backward_is_deterministic_and_reads_strided_views(cuda, T):
    """Two backward launches give the same bits (no atomics), also with
    q/k/v as views into a fused buffer and a non-contiguous dO, where the
    bf16 dK/dV kernel runs in query splits summed by a third kernel (4 at
    T=50, 15 at T=520 on 132 SMs)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    fused = torch.randn(1 if T > 64 else 2, T, 8 + 2 * 2, 64, generator=g,
                        device=cuda).bfloat16()
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    do = torch.randn(fused.shape[0], 8, T, 64, generator=g,
                     device=cuda).bfloat16().transpose(1, 2)
    plan = _bwd_plan(dict(B=q.shape[0], Tq=T, Tk=T, H=8, KV=2, hd=64,
                          causal=True, window=0))
    assert plan.nsplit > 1, plan
    _, lse = flash_attention._forward(q, k, v, True, 0, with_lse=True)
    a = flash_attention.flash_attention_bwd_cuda(q, k, v, do, lse)
    b = flash_attention.flash_attention_bwd_cuda(q, k, v, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for name, x, y in zip(("dq", "dk", "dv"), a,
                          _plain_grads(q, k, v, do, True, 0)):
        _grad_close(x, y, torch.bfloat16, name)


@pytest.mark.parametrize("layout", ["odd-stride-of-a-dim-of-one",
                                    "one-element-offset"])
def test_flash_backward_takes_any_do_layout(cuda, layout):
    """dO as autograd may hand it over at B=1 (hymba's 1 x 2048 step: an
    odd stride on the batch dim of one), or as a view one bf16 element
    off a 4-byte boundary: the bf16 kernels copy rows in 4-byte units,
    and the wrapper lays such a dO out anew; the gradients match the
    plain version's autograd."""
    c = dict(B=1, Tq=130, Tk=130, H=25, KV=5, hd=64, causal=True, window=64)
    q, k, v, do = _bwd_inputs(cuda, c, torch.bfloat16, 7)
    if layout == "one-element-offset":
        buf = torch.empty(do.numel() + 1, dtype=do.dtype, device=cuda)
        view = buf[1:].view(do.shape)
    else:
        view = torch.empty_like(do).as_strided(do.shape,
                                               (1,) + do.stride()[1:])
    view.copy_(do)
    assert view.data_ptr() % 4 or view.stride(0) % 2
    _, lse = flash_attention._forward(q, k, v, True, 64, with_lse=True)
    got = flash_attention.flash_attention_bwd_cuda(q, k, v, view, lse,
                                                   window=64)
    for name, a, b in zip(("dq", "dk", "dv"), got,
                          _plain_grads(q, k, v, do, True, 64)):
        _grad_close(a, b, torch.bfloat16, name)


# bf16 shapes whose dK/dV kernel runs in query splits on 132 SMs (split
# 1: B=1, T >= 512, hd 20 to 256, hd 256 in two halves of the dims) or
# in one, writing bf16 directly (split 0: the planner's blocks suffice)
SPLIT_CASES = [
    dict(B=1, Tq=512, Tk=512, H=28, KV=4, hd=128, causal=True, window=0,
         split=1),
    dict(B=1, Tq=600, Tk=600, H=25, KV=5, hd=64, causal=True, window=200,
         split=1),
    dict(B=1, Tq=520, Tk=520, H=4, KV=1, hd=256, causal=True, window=0,
         split=1),
    dict(B=1, Tq=530, Tk=530, H=6, KV=3, hd=20, causal=True, window=0,
         split=1),
    dict(B=1, Tq=70, Tk=600, H=8, KV=2, hd=20, causal=False, window=0,
         split=1),
    dict(B=1, Tq=512, Tk=512, H=28, KV=4, hd=128, causal=True, window=0,
         qscale=12, split=1),
    dict(B=4, Tq=250, Tk=250, H=32, KV=32, hd=64, causal=True, window=0,
         split=0),
    dict(B=8, Tq=100, Tk=700, H=16, KV=4, hd=128, causal=False, window=0,
         split=0)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "-".join(
    f"{k}{int(v)}" for k, v in c.items()))
def test_flash_backward_split_matches_plain_autograd(cuda, case):
    """bf16 with and without the planner's query split: dQ, dK, dV
    against the plain version's autograd, one counted launch."""
    c = case
    plan = _bwd_plan(c)
    assert (plan.nsplit > 1) == bool(c["split"]), plan
    q, k, v, do = _bwd_inputs(cuda, c, torch.bfloat16, c["Tq"] + c["hd"])
    _, lse = flash_attention._forward(q, k, v, c["causal"], c["window"],
                                      with_lse=True)
    n0 = flash_attention.launches_bwd
    got = flash_attention.flash_attention_bwd_cuda(
        q, k, v, do, lse, causal=c["causal"], window=c["window"])
    assert flash_attention.launches_bwd == n0 + 1
    want = _plain_grads(q, k, v, do, c["causal"], c["window"])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _grad_close(a, b, torch.bfloat16, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_attention_parameter_gets_a_gradient(cuda, dtype):
    """lm_loss on the card: every parameter leaf (wq/wk/wv and the QKV
    biases included) gets a finite gradient through the forward kernel
    with LSE and the backward kernel, close to the same model's gradient
    on the CPU (the plain version's autograd)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import BuildPlan, init_params, lm_loss
    from torch.utils import _pytree as pytree
    cfg = get_smoke_config("qwen2-7b").replace(
        compute_dtype="float32" if dtype == torch.float32 else "bfloat16")
    params = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        p = pytree.tree_map(
            lambda t: t.detach().to(dev).requires_grad_(True), params)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        n0, b0 = flash_attention.launches, flash_attention.launches_bwd
        loss, _ = lm_loss(p, cfg, BuildPlan(), batch)
        loss.backward()
        if dev != "cpu":
            assert flash_attention.launches > n0
            assert flash_attention.launches_bwd - b0 == cfg.n_layers
        grads[str(dev)] = pytree.tree_map(lambda t: t.grad, p)
    flat_cpu, _ = pytree.tree_flatten(grads["cpu"])
    flat_gpu, _ = pytree.tree_flatten(grads[str(cuda)])
    attn = [lp["attn"] for lp in grads[str(cuda)]["layers"]]
    for a in attn:
        for name in ("wq", "wk", "wv", "bq", "bk", "bv"):
            assert a[name] is not None and float(a[name].abs().max()) > 0
    tol = 1e-3 if dtype == torch.float32 else 1e-1
    for gc, gg in zip(flat_cpu, flat_gpu):
        assert gg is not None and bool(torch.isfinite(gg).all())
        rel = float((gg.cpu() - gc).norm()) / max(float(gc.norm()), 1e-30)
        assert rel <= tol, rel


def test_failed_backward_launch_raises(cuda, monkeypatch):
    """A backward kernel that returns a CUDA error raises out of
    loss.backward(); nothing falls back to the plain version."""
    from repro_torch.kernels import build
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(1, 16, 2, 32, generator=g, device=cuda)
               .requires_grad_(True) for _ in range(3))
    flash_attention.flash_attention_cuda(q, k, v).sum().backward()  # loads
    real = build.load

    def failing(name, fn, argtypes):
        if name == flash_attention.NAME_BWD:
            return lambda *a: 1                  # cudaErrorInvalidValue
        return real(name, fn, argtypes)

    monkeypatch.setattr(build, "load", failing)
    monkeypatch.setattr(flash_attention, "flash_attention_plain",
                        lambda *a, **k: pytest.fail("plain version reached"))
    out = flash_attention.flash_attention_cuda(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention_bwd kernel "
                       "launch failed"):
        out.sum().backward()


# the training families' attention shapes (chip_smoke phase 19's steps):
# granite's group 3, hymba's 25/5 heads with its 1024 window binding,
# musicgen's group 1, vit's non-causal 197 tokens; hd 64 throughout
FAMILY_ATTN_CASES = [
    dict(B=2, T=128, H=24, KV=8, causal=True, window=0),
    dict(B=1, T=1100, H=25, KV=5, causal=True, window=1024),
    dict(B=2, T=128, H=32, KV=32, causal=True, window=0),
    dict(B=2, T=197, H=12, KV=12, causal=False, window=0)]


@pytest.mark.parametrize("case", FAMILY_ATTN_CASES,
                         ids=["granite", "hymba", "musicgen", "vit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_at_the_family_shapes(cuda, case, dtype):
    """ops.flash_attention under autograd on the card (FlashAttention: the
    forward kernel with LSE, then the backward kernel, one launch each)
    against the plain version's forward and autograd: the output under
    test_flash_matches_plain's tolerance, dQ / dK / dV under the
    backward's."""
    from repro_torch.kernels import ops
    c = dict(case, Tq=case["T"], Tk=case["T"], hd=64)
    q, k, v, do = _bwd_inputs(cuda, c, dtype, c["T"] + c["H"])
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    n0, b0 = flash_attention.launches, flash_attention.launches_bwd
    out = ops.flash_attention(*leaves, causal=c["causal"],
                              window=c["window"])
    got = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == n0 + 1
    assert flash_attention.launches_bwd == b0 + 1
    want_out = flash_attention.flash_attention_plain(
        q, k, v, causal=c["causal"], window=c["window"])
    got_out, want_out = out.detach().float(), want_out.float()
    if dtype == torch.float32:        # test_flash_matches_plain's bounds
        torch.testing.assert_close(got_out, want_out, rtol=1e-4, atol=1e-4)
    else:
        assert bool(((got_out - want_out).abs()
                     <= 8e-3 * want_out.abs() + 1e-3).all())
    want = _plain_grads(q, k, v, do, c["causal"], c["window"])
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _grad_close(a, b, dtype, name)


@pytest.mark.parametrize("T,chunk", [(64, 1024), (96, 32)])
def test_ssm_autograd_on_the_card_matches_the_cpu(cuda, T, chunk):
    """hymba's selective SSM under autograd (models/ssm.ChunkScan) on the
    card against the same computation on the CPU at f32: the outputs, the
    final state and the gradient of every SSM leaf, the input and the
    initial state, each to 1e-4 of its max; one chunk and three."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm
    cfg = get_smoke_config("hymba-1.5b").replace(compute_dtype="float32")
    g = torch.Generator().manual_seed(T)
    p = ssm.init_ssm(g, cfg, "cpu")
    st = ssm.init_ssm_state(2, cfg)
    x = torch.randn(2, T, cfg.d_model, generator=g)
    h0 = torch.randn(st.h.shape, generator=g)
    conv0 = torch.randn(st.conv.shape, generator=g)
    w = [torch.randn(s, generator=g) for s in
         (x.shape, st.h.shape, st.conv.shape)]
    runs = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True)
                  for t in list(p.values()) + [x, h0, conv0]]
        tp = dict(zip(p, leaves))
        y, s = ssm.apply_ssm(tp, leaves[-3], cfg,
                             ssm.SSMState(leaves[-2], leaves[-1]),
                             chunk=chunk)
        outs = (y, s.h, s.conv)
        loss = sum((o * wi.to(dev)).sum() for o, wi in zip(outs, w))
        grads = torch.autograd.grad(loss, leaves)
        runs[str(dev)] = [t.detach().cpu() for t in outs + grads]
    names = ["y", "h", "conv"] + list(p) + ["x", "h0", "conv0"]
    for name, a, b in zip(names, runs[str(cuda)], runs["cpu"]):
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * top, (
            name, float((a - b).abs().max()), top)


@pytest.mark.parametrize("m,n,tp", [(2048, 4608, 2), (3584, 3584, 4),
                                     (512, 1024, 4)])
def test_column_sharded_solve_is_bit_identical_to_one_rank(cuda, m, n, tp):
    """The column-sharded solve's property on the card (JAX's
    tests/test_dist.py:416): each rank's share, solved alone as
    `dist.sharded_solve` solves it (`_local_solve`: the visit order of the
    whole W, only its own columns), gives the codes, zero-points and
    scales of those columns of the one-rank solve bit for bit."""
    from repro_torch.core.comq_hessian import shared_order
    from repro_torch.core.quantizer import QuantSpec
    from repro_torch.dist.calibrate import _local_solve
    from repro_torch.dist.sharding import column_slice
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn(1024, m, generator=g, device=cuda)
    h = x.T @ x
    w = torch.randn(m, n, generator=g, device=cuda) * 0.05
    spec = QuantSpec(bits=4, granularity="per_channel", lam=0.9, sweeps=3,
                     order="greedy")
    perm = shared_order(h, w, spec)
    whole = _local_solve(h, w, perm, spec, "comq_blocked", 256)
    for r in range(tp):
        lo, hi, _ = column_slice(n, r, tp)
        part = _local_solve(h, w[:, lo:hi].contiguous(), perm, spec,
                            "comq_blocked", 256)
        for i, name in enumerate(("q", "delta", "z_lo")):
            assert torch.equal(whole[i][..., lo:hi], part[i]), (r, name)
