"""repro_torch.core.quantizer against repro.core.quantizer: grid init, RTN
codes (exact .5 ties included) and packed bytes are identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizer as jq
from repro_torch.core import quantizer as tq

torch.set_num_threads(2)


def _w(seed=0, m=64, n=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n)) * 0.05).astype(np.float32)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("lam", [1.0, 0.9])
def test_per_channel_grid_identical(bits, lam):
    w = _w(bits)
    jd, jlo, jhi = jq.init_per_channel(jnp.asarray(w), bits, lam)
    td, tlo, thi = tq.init_per_channel(torch.from_numpy(w), bits, lam)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_np(thi), np.asarray(jhi))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_per_layer_grid(bits):
    w = _w(10 + bits)
    jd, jlo, jhi = jq.init_per_layer(jnp.asarray(w), bits)
    td, tlo, thi = tq.init_per_layer(torch.from_numpy(w), bits)
    # the mean over columns may be summed in another order: one f32 ulp
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=2.4e-7)
    assert int(tlo) == int(jlo) and int(thi) == int(jhi)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_rtn_codes_identical(bits):
    w = _w(20 + bits)
    jd, jlo, jhi = jq.init_per_channel(jnp.asarray(w), bits, 0.9)
    td, tlo, thi = tq.init_per_channel(torch.from_numpy(w), bits, 0.9)
    jcode = jq.quantize_rtn(jnp.asarray(w), jd, jlo, jhi)
    tcode = tq.quantize_rtn(torch.from_numpy(w), td, tlo, thi)
    np.testing.assert_array_equal(_np(tcode), np.asarray(jcode))


def test_rtn_round_half_to_even_ties():
    delta = 0.25                          # exact in binary: w/δ hits .5
    halves = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 6.5]],
                      np.float32) * delta
    z_lo, z_hi = np.int32(-8), np.int32(7)
    want = np.asarray(jq.quantize_rtn(jnp.asarray(halves),
                                      jnp.float32(delta), z_lo, z_hi))
    got = tq.quantize_rtn(torch.from_numpy(halves), torch.tensor(delta),
                          torch.tensor(z_lo), torch.tensor(z_hi))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(want, [[0, 2, 2, 0, -2, -2, 4, 6]])


@pytest.mark.parametrize("bits,n", [(2, 48), (3, 48), (4, 48), (8, 48),
                                    (4, 45), (2, 46)])
def test_packed_bytes_identical(bits, n):
    rng = np.random.default_rng(bits * 100 + n)
    u = rng.integers(0, 2 ** bits, size=(16, n)).astype(np.uint8)
    jp, jcpb = jq.pack_codes(jnp.asarray(u), bits)
    tp, tcpb = tq.pack_codes(torch.from_numpy(u), bits)
    assert tcpb == jcpb
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(_np(tq.unpack_codes(tp, tcpb)), u)
    assert tq.codes_per_byte(bits) == jq.codes_per_byte(bits)
