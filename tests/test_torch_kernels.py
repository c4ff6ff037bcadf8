"""The plain versions of the port's three kernels against the JAX oracles
(kernels/ref.py) and the JAX model's attention. Each Hopper kernel is held
against its plain version on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.core.quantizer import pack_codes as jpack
from repro.models.attention import flash_attention as jflash
from repro.models.attention import head_to_kv_map as jhmap
from repro_torch.kernels import flash_attention, quant_matmul

torch.set_num_threads(2)


def _qmm_inputs(M, K, N, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    u = rng.integers(0, 2 ** bits, (K, N)).astype(np.uint8)
    scale = rng.uniform(0.01, 0.05, N).astype(np.float32)
    z = rng.integers(-(2 ** (bits - 1)), 0, N).astype(np.float32)
    return x, u, scale, z


@pytest.mark.parametrize("M,K,N", [(8, 64, 48), (5, 37, 12), (33, 70, 20)])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_plain_quant_matmul_matches_jax_oracles(M, K, N, bits):
    x, u, scale, z = _qmm_inputs(M, K, N, bits, seed=M + K + N + bits)
    packed, cpb = jpack(jnp.asarray(u), bits)
    assert cpb == {8: 1, 4: 2, 2: 4}[bits]
    want = np.asarray(jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(u),
                                            jnp.asarray(scale),
                                            jnp.asarray(z)))
    want_p = np.asarray(jref.quant_matmul_packed_ref(
        jnp.asarray(x), packed, jnp.asarray(scale), jnp.asarray(z), cpb=cpb))
    got = quant_matmul.quant_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(np.array(packed)),
        torch.from_numpy(scale), torch.from_numpy(z), cpb=cpb).numpy()
    np.testing.assert_allclose(want_p, want, rtol=0, atol=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _attn_inputs(B, T, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, T, H, hd), mk(B, T, KV, hd), mk(B, T, KV, hd)
    if dtype == "bf16":   # round through bf16 once, so both packages agree
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("case", [
    dict(B=2, T=64, H=14, KV=2, hd=16, window=0),    # group 7
    dict(B=1, T=96, H=14, KV=2, hd=32, window=40),
    dict(B=2, T=48, H=4, KV=4, hd=8, window=0)], ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_flash_matches_jax_ref_and_pair_scan(case, dtype):
    B, T, H, KV, hd, w = (case[k] for k in ("B", "T", "H", "KV", "hd",
                                             "window"))
    q, k, v = _attn_inputs(B, T, H, KV, hd, dtype, seed=T + H + w)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    got = flash_attention.flash_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=True,
        window=w).float().numpy()
    # oracle in its (BH, T, hd) layout, f32
    bh = lambda a: a.transpose(0, 2, 1, 3).reshape(-1, T, hd)  # noqa: E731
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(bh(q)), jnp.asarray(bh(k)), jnp.asarray(bh(v)),
        causal=True, window=w)).reshape(B, H, T, hd).transpose(0, 2, 1, 3)
    scan = np.asarray(jflash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             jhmap(H, H, KV), causal=True, window=w,
                             block_size=16), np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, scan, rtol=2e-5, atol=2e-5)
    else:   # one bf16 rounding of the output; the scan also rounds p to bf16
        np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-3)
        np.testing.assert_allclose(got, scan, rtol=3e-2, atol=3e-2)
