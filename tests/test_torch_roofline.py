"""The port's roofline (repro_torch.roofline) against the JAX package's
(repro.roofline): shapes and model flops for every arch, the three-term
roofline at JAX's constants, the bytes-per-decode-step model in both
modes, the op-level count against JAX's HLO count, the kernels' cost
charge (the same work on the CPU's plain versions as the card's kernels
would be charged), and the bound column of PERF.md §6 reproduced from
the cost functions."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs import list_archs as jax_archs
from repro.configs import shapes_for as jax_shapes_for
from repro.models import BuildPlan as JPlan
from repro.models import init_params as jax_init
from repro.models.model import forward as jax_forward
from repro.roofline import kv_bytes as jkv
from repro.roofline import report as jreport
from repro.roofline.analysis import CostTotals as JCost
from repro.roofline.analysis import hlo_cost
from repro.roofline.analysis import roofline_terms as jax_terms
from repro_torch.configs import get_config, get_smoke_config, shapes_for
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops
from repro_torch.models import BuildPlan
from repro_torch.models.model import forward
from repro_torch.roofline import kernels as kc
from repro_torch.roofline import kv_bytes as tkv
from repro_torch.roofline import report as treport
from repro_torch.roofline.analysis import (CostTotals, Hardware, count_cost,
                                           roofline_terms)
from repro_torch.roofline.kernels import bound_ms

torch.set_num_threads(2)

# JAX's TPU constants (src/repro/roofline/analysis.py) as a Hardware record
TPU = Hardware("tpu-v5e", hbm_bytes_per_s=819e9,
               peak_flops={"bf16": 197e12}, link_bytes_per_s=50e9, links=4)


@pytest.mark.parametrize("arch", jax_archs())
def test_shapes_and_model_flops_match_jax(arch):
    from repro.configs import get_config as jax_config
    names = [s.name for s in shapes_for(get_config(arch))]
    assert names == [s.name for s in jax_shapes_for(jax_config(arch))]
    for name in names:
        assert treport.model_flops(arch, name) == \
            jreport.model_flops(arch, name)


def test_roofline_terms_equal_jax_at_its_constants():
    rng = np.random.default_rng(0)
    for _ in range(5):
        f, b, ar, ag = (float(v) for v in rng.uniform(1e9, 1e14, 4))
        coll = {"all-reduce": ar, "all-gather": ag}
        want = jax_terms(JCost(f, b, dict(coll)), n_chips=4)
        got = roofline_terms(CostTotals(f, b, dict(coll)), TPU, kind="bf16")
        assert got == want
    # the H100 record: the data sheet's dense peaks and rates
    t = roofline_terms(CostTotals(989e12, 3.35e12, {"all_reduce": 450e9}))
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0


@pytest.fixture(scope="module")
def smoke():
    """The smoke qwen in both packages from JAX's init, f32 compute."""
    jcfg = jax_smoke("qwen2-7b").replace(compute_dtype="float32")
    jp = jax_init(jax.random.PRNGKey(0), jcfg, JPlan(remat=False))
    cfg = get_smoke_config("qwen2-7b").replace(compute_dtype="float32")
    return jcfg, jp, cfg, params_from_numpy(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_decode_bytes_match_jax(smoke, kv_bits, cache):
    """decode_kv_bytes / decode_step_bytes equal JAX's, exactly, in both
    modes, full tables and a live length; the weights term (every leaf of
    the converted params) equals JAX's."""
    jcfg, jp, cfg, tp = smoke
    jplan = JPlan(remat=False, cache_dtype=getattr(jnp, cache),
                  kv_bits=kv_bits)
    tplan = BuildPlan(remat=False, cache_dtype=getattr(torch, cache),
                      kv_bits=kv_bits)
    assert tkv.pool_elem_bytes(tplan) == jkv.pool_elem_bytes(jplan)
    assert tkv.weight_stream_bytes(tp) == jkv.weight_stream_bytes(jp)
    for mode in ("xla", "pallas"):
        for live in (None, 37):
            kw = dict(max_slots=3, block_size=8, max_blocks_per_slot=6,
                      num_blocks=24, mode=mode, live_tokens=live)
            assert tkv.decode_kv_bytes(cfg, tplan, **kw) == \
                jkv.decode_kv_bytes(jcfg, jplan, **kw)
            assert tkv.decode_step_bytes(tp, cfg, tplan, **kw) == \
                jkv.decode_step_bytes(jp, jcfg, jplan, **kw)


def test_weight_stream_bytes_of_packed_leaves_equal_jax():
    """A packed QT leaf streams its codes, scales and zero-points, as
    JAX's QT pytree children do: the same arrays in both packages' QT."""
    from repro.core.apply import QT as JQT
    from repro_torch.core.apply import QT
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, (64, 24)).astype(np.uint8)
    scale = rng.random(48).astype(np.float32)
    z_lo = rng.integers(-8, 0, 48).astype(np.int32)
    emb = rng.normal(size=(32, 64)).astype(np.float32)
    jtree = {"embed": jnp.asarray(emb), "layers": [{"w": JQT(
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(z_lo),
        (64, 48), 4)}]}
    ttree = {"embed": torch.from_numpy(emb), "layers": [{"w": QT(
        torch.from_numpy(codes), torch.from_numpy(scale),
        torch.from_numpy(z_lo), (64, 48), 4)}]}
    assert tkv.weight_stream_bytes(ttree) == \
        jkv.weight_stream_bytes(jtree) == emb.nbytes + codes.nbytes \
        + scale.nbytes + z_lo.nbytes


def test_count_cost_matmul_flops_exact_over_a_chain():
    """2·M·K·N for mm, bmm, addmm, baddbmm and what matmul / einsum lower
    to; the operands' reads and the outputs' writes counted once."""
    g = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(*s, generator=g) for s in
                 ((8, 16), (16, 32), (32, 12)))
    b3, c3 = torch.randn(4, 8, 16, generator=g), torch.randn(4, 16, 5,
                                                             generator=g)
    bias = torch.randn(12, generator=g)

    def chain():
        y = torch.addmm(bias, x @ w1, w2)                # mm, addmm
        z = torch.bmm(b3, c3)                            # bmm
        z = torch.baddbmm(z, b3, c3)                     # baddbmm
        return y, torch.einsum("bij,bjk->bik", b3, c3)   # bmm again

    c = count_cost(chain)
    want = 2 * 8 * 16 * 32 + 2 * 8 * 32 * 12 + 3 * 2 * 4 * 8 * 16 * 5
    assert c.flops == want
    f4 = 4
    mm_bytes = f4 * (8 * 32 + 8 * 16 + 16 * 32)
    addmm_bytes = f4 * (8 * 12 + 12 + 8 * 32 + 32 * 12)
    bmm_bytes = f4 * (4 * 8 * 5 + 4 * 8 * 16 + 4 * 16 * 5)
    baddbmm_bytes = bmm_bytes + f4 * 4 * 8 * 5
    assert c.bytes_accessed == mm_bytes + addmm_bytes + 2 * bmm_bytes \
        + baddbmm_bytes
    assert c.collective_bytes == {}


def test_count_cost_forward_flops_near_jax_hlo(smoke):
    """One smoke-qwen f32 forward: the count's flops against JAX's
    trip-count-aware HLO count of the same forward. The matmul flops are
    the same 2·M·K·N in both; the elementwise count differs by fusion:
    XLA breaks softmax, the norms and RoPE into its own elementwise ops
    (exp, subtract, divide, rsqrt, each a flop an element), while aten
    runs them as whole ops (`_softmax`, reductions) that the count charges
    no flops. Measured 0.946 of JAX's; the bound is [0.90, 1.0]."""
    jcfg, jp, cfg, tp = smoke
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 32)).astype(np.int32)
    fn = jax.jit(lambda p, t: jax_forward(p, jcfg, JPlan(remat=False), t)[0])
    want = hlo_cost(fn.lower(jp, jnp.asarray(toks)).compile().as_text())
    with torch.no_grad():
        got = count_cost(forward, tp, cfg, BuildPlan(remat=False),
                         torch.from_numpy(toks).long())
    assert 0.90 <= got.flops / want.flops <= 1.0, got.flops / want.flops


def _paged_inputs(kv_bits):
    from repro_torch.serve.kv_cache import kv_encode, kv_scale_of
    g = torch.Generator().manual_seed(4)
    B, H, KV, hd, BS, MAXB = 3, 4, 2, 16, 4, 5
    q = torch.randn(B, H, hd, generator=g)
    kp, vp = (torch.randn(B * MAXB, BS, KV, hd, generator=g)
              for _ in range(2))
    bt = torch.randperm(B * MAXB, generator=g).reshape(B, MAXB).int()
    lens = torch.tensor([7, 0, 19], dtype=torch.int32)
    if not kv_bits:
        return (q, kp, vp, bt, lens), {}
    ks, vs = (kv_scale_of(p.abs().amax(dim=(1, 3)), kv_bits) for p in
              (kp, vp))
    kq, vq = (kv_encode(p, s[:, None], kv_bits) for p, s in
              ((kp, ks), (vp, vs)))
    return (q, kq, vq, ks, vs, bt, lens), {"kv_bits": kv_bits}


def _kernel_calls():
    """(name, call, plain call, cost) for each forward kernel, CPU tensors."""
    from repro_torch.core.quantizer import pack_codes
    from repro_torch.kernels import comq_panel, paged_attention, quant_matmul
    g = torch.Generator().manual_seed(1)
    B, n = 16, 24
    x = torch.randn(4 * B, B, generator=g)
    h = x.T @ x / (4 * B) + 0.1 * torch.eye(B)
    panel = (h, torch.randn(B, n, generator=g),
             torch.randn(B, n, generator=g) * 3,
             torch.full((n,), 0.1), torch.full((n,), -8.0),
             torch.full((n,), 7.0), torch.diagonal(h).contiguous())
    u = torch.randint(0, 16, (32, 24), generator=g, dtype=torch.uint8)
    codes, cpb = pack_codes(u, 4)
    qmm = (torch.randn(5, 32, generator=g), codes,
           torch.rand(24, generator=g), torch.full((24,), -8.0))
    q, k, v = (torch.randn(2, 9, h_, 16, generator=g) for h_ in (6, 2, 2))
    p0, kw0 = _paged_inputs(0)
    p8, kw8 = _paged_inputs(8)
    p4, kw4 = _paged_inputs(4)
    return [
        ("comq_panel", lambda: ops.comq_panel_dq(*panel),
         lambda: comq_panel.comq_panel_dq_plain(*panel),
         kc.comq_panel(B, n)),
        ("quant_matmul", lambda: ops.quant_matmul(*qmm, cpb=cpb),
         lambda: quant_matmul.quant_matmul_plain(*qmm, cpb=cpb),
         kc.quant_matmul(5, 32, 24, codes.numel(), 4)),
        ("flash_attention", lambda: ops.flash_attention(q, k, v, window=4),
         lambda: flash_mod.flash_attention_plain(q, k, v, window=4),
         kc.flash_attention(2, 9, 9, 6, 2, 16, window=4, elem_bytes=4,
                            kind="f32")),
        ("paged_attention", lambda: ops.paged_attention(*p0, **kw0),
         lambda: paged_attention.paged_attention_plain(*p0, **kw0),
         kc.paged_attention(3, 4, 2, 16, 4, 16 * 4, 5, 7, 26, q_bytes=4)),
        ("paged_attention_quant int8",
         lambda: ops.paged_attention_quant(*p8, **kw8),
         lambda: paged_attention.paged_attention_quant_plain(*p8, **kw8),
         kc.paged_attention(3, 4, 2, 16, 4, 16, 5, 7, 26, q_bytes=4,
                            kv_bits=8)),
        ("paged_attention_quant 4-bit",
         lambda: ops.paged_attention_quant(*p4, **kw4),
         lambda: paged_attention.paged_attention_quant_plain(*p4, **kw4),
         kc.paged_attention(3, 4, 2, 16, 4, 8, 5, 7, 26, q_bytes=4,
                            kv_bits=4)),
    ]


@pytest.mark.parametrize("i", range(6), ids=["comq_panel", "quant_matmul",
                                              "flash_attention", "paged",
                                              "paged_q8", "paged_q4"])
def test_ops_charge_the_kernel_cost_not_the_plain_version(i):
    """count_cost over an ops.* call on CPU tensors is that kernel's cost
    function exactly; the plain version's own ops count otherwise (so
    they were kept out)."""
    name, call, plain, cost = _kernel_calls()[i]
    got = count_cost(call)
    assert (got.flops, got.bytes_accessed) == (cost.flops, cost.bytes), name
    inner = count_cost(plain)
    assert (inner.flops, inner.bytes_accessed) != (cost.flops, cost.bytes)
    assert inner.bytes_accessed > 0


def test_flash_backward_charged_as_the_kernel_on_the_cpu():
    """Under a count, the CPU's plain attention's gradient is charged as
    the backward kernel (and its graph's ops kept out), and it is the
    plain autograd's gradient bit for bit; with no count nothing
    changes."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 12, 6, 16, generator=g, requires_grad=True)
    k, v = (torch.randn(2, 12, 2, 16, generator=g, requires_grad=True)
            for _ in range(2))
    do = torch.randn(2, 12, 6, 16, generator=g)
    grads = {}

    def step():
        out = ops.flash_attention(q, k, v, causal=True, window=5)
        grads["g"] = torch.autograd.grad(out, (q, k, v), do)

    got = count_cost(step)
    fwd = kc.flash_attention_of(q, k, causal=True, window=5)
    bwd = kc.flash_attention_bwd_of(q, k, causal=True, window=5)
    assert got.flops == fwd.flops + bwd.flops
    assert got.bytes_accessed == fwd.bytes + bwd.bytes
    want = torch.autograd.grad(
        flash_mod.flash_attention_plain(q, k, v, causal=True, window=5),
        (q, k, v), do)
    for a, b in zip(grads["g"], want):
        assert torch.equal(a, b)


def test_meta_tensors_count_as_the_cpu_does():
    """The same ops.* calls on meta tensors cost what they cost on the
    CPU (paged attention aside: meta lengths hold no values, so every
    table entry counts as live)."""
    for name, call, _, cost in _kernel_calls()[:3]:
        cpu = count_cost(call)
        assert (cpu.flops, cpu.bytes_accessed) == (cost.flops, cost.bytes)
    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt,
                                                 device="meta")
    got = count_cost(ops.flash_attention, m(2, 9, 6, 16), m(2, 9, 2, 16),
                     m(2, 9, 2, 16), window=4)
    want = kc.flash_attention(2, 9, 9, 6, 2, 16, window=4, elem_bytes=4,
                              kind="f32")
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes)
    got = count_cost(ops.paged_attention, m(3, 4, 16), m(15, 4, 2, 16),
                     m(15, 4, 2, 16), m(3, 5, dt=torch.int32),
                     m(3, dt=torch.int32))
    want = kc.paged_attention(3, 4, 2, 16, 4, 64, 5, 15, 60, q_bytes=4)
    assert (got.flops, got.bytes_accessed) == (want.flops, want.bytes)


def _qmm(M, K, N, cpb, x_bytes=2):
    return kc.quant_matmul(M, K, N, K * N // cpb, x_bytes)


# PERF.md §6's bound column (ms, to 4 decimals) at each row's timed shape
BOUND_ROWS = [
    ("panel n=18944", kc.comq_panel(256, 18944), "0.0233"),
    ("panel n=512", kc.comq_panel(256, 512), "0.0007"),
    ("panel n=3584", kc.comq_panel(256, 3584), "0.0045"),
    ("panel granite E=40", kc.comq_panel(256, 512, 40), "0.0283"),
    ("panel granite E=40 n=1024", kc.comq_panel(256, 1024, 40), "0.0534"),
    ("panel granite E=40 n=1536", kc.comq_panel(256, 1536, 40), "0.0785"),
    ("panel hymba", kc.comq_panel(256, 6400), "0.0079"),
    ("panel hymba n=5504", kc.comq_panel(256, 5504), "0.0068"),
    ("panel musicgen", kc.comq_panel(256, 2048), "0.0026"),
    ("panel musicgen n=6144", kc.comq_panel(256, 6144), "0.0076"),
    ("panel musicgen n=8192", kc.comq_panel(256, 8192), "0.0101"),
    ("panel rwkv", kc.comq_panel(256, 4096), "0.0051"),
    ("panel rwkv n=14336", kc.comq_panel(256, 14336), "0.0177"),
    ("panel vlm", kc.comq_panel(256, 1024), "0.0013"),
    ("panel vlm n=28672", kc.comq_panel(256, 28672), "0.0352"),
    ("qmm bf16 X", _qmm(8, 3584, 18944, 2), "0.0104"),
    ("qmm f32 X", _qmm(8, 3584, 18944, 2, 4), "0.0104"),
    ("qmm 8-bit", _qmm(8, 18944, 3584, 1), "0.0204"),
    ("qmm 2-bit", _qmm(8, 3584, 512, 4), "0.0002"),
    ("qmm granite", _qmm(8, 1536, 1536, 2), "0.0004"),
    ("qmm granite kv", _qmm(8, 1536, 512, 2), "0.0001"),
    ("qmm hymba", _qmm(8, 1600, 1600, 2), "0.0004"),
    ("qmm hymba kv", _qmm(8, 1600, 320, 2), "0.0001"),
    ("qmm hymba up", _qmm(8, 1600, 5504, 2), "0.0014"),
    ("qmm hymba down", _qmm(8, 5504, 1600, 2), "0.0014"),
    ("qmm musicgen", _qmm(8, 2048, 2048, 2), "0.0007"),
    ("qmm musicgen up", _qmm(8, 2048, 8192, 2), "0.0026"),
    ("qmm musicgen down", _qmm(8, 8192, 2048, 2), "0.0026"),
    ("flash qwen", kc.flash_attention(8, 128, 128, 28, 4, 128), "0.0050"),
    ("flash qwen prefill", kc.flash_attention(1, 512, 512, 28, 4, 128),
     "0.0025"),
    ("flash granite", kc.flash_attention(8, 128, 128, 24, 8, 64), "0.0025"),
    ("flash granite prefill", kc.flash_attention(1, 512, 512, 24, 8, 64),
     "0.0013"),
    ("flash hymba", kc.flash_attention(8, 128, 128, 25, 5, 64, window=1024),
     "0.0023"),
    ("flash hymba window binds",
     kc.flash_attention(1, 2048, 2048, 25, 5, 64, window=1024), "0.0102"),
    ("flash musicgen", kc.flash_attention(8, 128, 128, 32, 32, 64),
     "0.0050"),
    ("flash musicgen prefill", kc.flash_attention(1, 512, 512, 32, 32, 64),
     "0.0025"),
    ("flash vlm", kc.flash_attention(8, 128, 128, 64, 8, 128), "0.0113"),
    ("flash vlm cross", kc.flash_attention(8, 128, 1601, 64, 8, 128,
                                           causal=False), "0.0543"),
    ("flash vlm cross decode", kc.flash_attention(8, 1, 1601, 64, 8, 128,
                                                  causal=False), "0.0157"),
    ("flash vit", kc.flash_attention(8, 197, 197, 12, 12, 64, causal=False),
     "0.0029"),
    ("bwd qwen", kc.flash_attention_bwd(8, 128, 128, 28, 4, 128), "0.0079"),
    ("bwd qwen prefill", kc.flash_attention_bwd(1, 512, 512, 28, 4, 128),
     "0.0048"),
    ("bwd granite", kc.flash_attention_bwd(8, 128, 128, 24, 8, 64),
     "0.0041"),
    ("bwd hymba", kc.flash_attention_bwd(1, 2048, 2048, 25, 5, 64,
                                         window=1024), "0.0255"),
    ("bwd musicgen", kc.flash_attention_bwd(8, 128, 128, 32, 32, 64),
     "0.0088"),
    ("bwd vlm cross", kc.flash_attention_bwd(8, 128, 1601, 64, 8, 128,
                                             causal=False), "0.1358"),
    ("bwd vit", kc.flash_attention_bwd(8, 197, 197, 12, 12, 64,
                                       causal=False), "0.0051"),
    # 1090 live pages of the phase's seeded lengths: bytes-bound, so the
    # live keys (at most 16 a page) do not move the bound
    ("paged qwen", kc.paged_attention(8, 28, 4, 128, 16, 256, 256, 1090,
                                      1090 * 16), "0.0107"),
    ("paged granite", kc.paged_attention(8, 24, 8, 64, 16, 128, 256, 1090,
                                         1090 * 16), "0.0107"),
    ("paged musicgen", kc.paged_attention(8, 32, 32, 64, 16, 128, 256, 1090,
                                          1090 * 16), "0.0427"),
    ("paged int8 qwen", kc.paged_attention(8, 28, 4, 128, 16, 128, 256, 1090,
                                           1090 * 16, kv_bits=8), "0.0054"),
    ("paged 4-bit qwen", kc.paged_attention(8, 28, 4, 128, 16, 64, 256,
                                            1090, 1090 * 16, kv_bits=4),
     "0.0027"),
    ("paged int8 granite", kc.paged_attention(8, 24, 8, 64, 16, 64, 256,
                                              1090, 1090 * 16, kv_bits=8),
     "0.0054"),
    ("paged 4-bit granite", kc.paged_attention(8, 24, 8, 64, 16, 32, 256,
                                               1090, 1090 * 16, kv_bits=4),
     "0.0027"),
    ("paged int8 musicgen", kc.paged_attention(8, 32, 32, 64, 16, 64, 256,
                                               1090, 1090 * 16, kv_bits=8),
     "0.0214"),
    ("paged 4-bit musicgen", kc.paged_attention(8, 32, 32, 64, 16, 32, 256,
                                                1090, 1090 * 16, kv_bits=4),
     "0.0108"),
    # the AdamW update at qwen's w_down, granite's expert stack and
    # hymba's w_down (rows of 1600 coded as 1792: 7 blocks of 256)
    ("adamw qwen", kc.adamw_update(18944 * 3584, "float32"), "0.5675"),
    ("adamw qwen int8", kc.adamw_update(18944 * 3584, "int8"), "0.3357"),
    ("adamw granite", kc.adamw_update(40 * 1536 * 512, "float32"),
     "0.2629"),
    ("adamw granite int8", kc.adamw_update(40 * 1536 * 512, "int8"),
     "0.1555"),
    ("adamw hymba", kc.adamw_update(5504 * 1600, "float32"), "0.0736"),
    ("adamw hymba int8", kc.adamw_update(5504 * 1600, "int8", 5504 * 1792),
     "0.0450"),
    ("wkv 8x128", kc.wkv(8, 128, 64, 64, 4096), "0.0301"),
    ("wkv 8x1", kc.wkv(8, 1, 64, 64, 4096), "0.0052"),
    ("wkv 1x1000", kc.wkv(1, 1000, 64, 64, 4096), "0.0251"),
]


@pytest.mark.parametrize("name,cost,want", BOUND_ROWS,
                         ids=[r[0] for r in BOUND_ROWS])
def test_bound_ms_reproduces_the_perf_md_column(name, cost, want):
    assert f"{bound_ms(cost)[0]:.4f}" == want


def test_bound_ms_of_the_plain_scan_and_the_paged_megabytes():
    """The selective scan's bounds from hymba's config, and the paged
    rows' megabytes as PERF.md prints them."""
    from repro_torch.models import ssm
    cfg = get_config("hymba-1.5b")
    _, di, n, dt_rank, _ = ssm._dims(cfg)
    shapes = ssm.ssm_param_shapes(cfg)
    numel = sum(math.prod(shapes[k]) for k in ("w_xproj", "w_dt", "b_dt",
                                                "a_log"))
    got = [f"{bound_ms(kc.ssm_scan(8, T, di, n, dt_rank, numel))[0]:.4f}"
           for T in (128, 512)]
    assert got == ["0.0282", "0.1127"]
    mb = [kc.paged_attention(8, H, KV, hd, 16, row, 256, 1090, 0).bytes / 1e6
          for H, KV, hd, row in ((28, 4, 128, 256), (24, 8, 64, 128),
                                 (32, 32, 64, 128))]
    assert [f"{x:.2f}" for x in mb] == ["35.84", "35.77", "142.94"]
    assert bound_ms(kc.flash_attention(1, 2048, 2048, 25, 5, 64,
                                       window=1024))[1] == "operations"


def test_measured_decode_bytes_tracks_the_pallas_prediction(smoke):
    """count_cost over one decode step (the paged kernels charged their
    live pages) against decode_step_bytes(mode="pallas"), bf16 over int8
    pages, every slot at 500 of its 512 table tokens: ratio_of_ratios
    within [0.8, 1.25] (JAX's bench gate is [0.75, 1.25]). The misses:
    the prediction streams every leaf (the embedding table too, where the
    step gathers B rows) and the eager int8 append materializes its page
    in f32 about ten times where the model rescales it in registers (at
    48 live tokens of 8-token pages that append outweighs the int8 pages'
    saving, and the counted int8 step is the larger); both are the same in
    the two plans or small beside 63 live pages a slot."""
    _, _, cfg, tp = smoke
    from repro_torch.serve import Runtime, ServeConfig
    sc = ServeConfig(max_slots=4, block_size=8, num_blocks=256,
                     buckets=(8, 16), max_blocks_per_slot=64)
    plan = BuildPlan(remat=False, cache_dtype=torch.bfloat16)
    r = tkv.predicted_vs_measured_ratio(
        tp, cfg, plan, plan.replace(kv_bits=8), max_slots=4, block_size=8,
        max_blocks_per_slot=64, num_blocks=256, live_tokens=500,
        make_runtime=lambda p: Runtime(tp, cfg, p, sc, device="cpu"))
    assert r["predicted"] > 1.0 and r["measured"] > 1.0
    assert 0.8 <= r["ratio_of_ratios"] <= 1.25, r
