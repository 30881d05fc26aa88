"""Device-resident transform chain (GROK_TPU_DEVICE=jax): the jitted
DC/MCT/DWT/(de)quant XLA program must match the host pipeline — bit-exact
for the reversible path everywhere; the irreversible float chain is
bit-exact where the device rounds like the host
(jax_pipeline.float_chain_exact) and within ±1 LSB on the CPU backend
(XLA:CPU's LLVM codegen contracts mul+add into FMAs)."""

import os

import numpy as np
import pytest

import grok_tpu as gk
from tests.conftest import natural_image


@pytest.fixture
def device_env():
    os.environ["GROK_TPU_DEVICE"] = "jax"
    yield
    os.environ.pop("GROK_TPU_DEVICE", None)


def _host_then_device(im, params, stream):
    os.environ.pop("GROK_TPU_DEVICE", None)
    host_enc = gk.compress(im, params)
    host_dec = gk.decompress(stream).to_array()
    os.environ["GROK_TPU_DEVICE"] = "jax"
    dev_enc = gk.compress(im, params)
    dev_dec = gk.decompress(stream).to_array()
    os.environ.pop("GROK_TPU_DEVICE", None)
    return host_enc, dev_enc, host_dec, dev_dec


def test_device_lossless_bit_exact():
    arr = natural_image(96, 128)
    im = gk.Image.from_array(arr)
    p = gk.CompressParams(num_resolutions=3)
    stream = gk.compress(im, p)
    host_enc, dev_enc, host_dec, dev_dec = _host_then_device(im, p, stream)
    assert host_enc == dev_enc
    assert np.array_equal(host_dec, dev_dec)
    assert np.array_equal(dev_dec.squeeze(), arr)


def test_device_rgb_mct_roundtrip():
    arr = natural_image(80, 96, 3)
    im = gk.Image.from_array(arr)
    p = gk.CompressParams(num_resolutions=3)
    stream = gk.compress(im, p)
    host_enc, dev_enc, host_dec, dev_dec = _host_then_device(im, p, stream)
    assert host_enc == dev_enc
    assert np.array_equal(host_dec, dev_dec)


def test_device_custom_mct():
    """Part-2 custom-MCT must ride the device transform chain too:
    device encode/decode of an mct=2 stream matches the host path within
    the CPU backend's ±1 LSB float class."""
    arr = natural_image(80, 96, 3)
    M = [[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]]
    im = gk.Image.from_array(arr)
    p = gk.CompressParams(num_resolutions=3, mct_matrix=M, irreversible=True)
    stream = gk.compress(im, p)
    host_enc, dev_enc, host_dec, dev_dec = _host_then_device(im, p, stream)
    assert np.abs(host_dec.astype(int) - dev_dec.astype(int)).max() <= 1
    # device-encoded stream must decode (on host) as faithfully as the
    # host-encoded one — guards against the matrix silently not being
    # applied on the device (signalled mct=2 would then garble decode)
    host_err = np.abs(gk.decompress(host_enc).to_array().astype(int)
                      - arr.astype(int)).max()
    dev_err = np.abs(gk.decompress(dev_enc).to_array().astype(int)
                     - arr.astype(int)).max()
    assert dev_err <= host_err + 1


def test_device_irreversible_host_equiv():
    """±1 LSB on the CPU backend; see test_float_chain_on_gpu."""
    arr = natural_image(80, 96, 3)
    im = gk.Image.from_array(arr)
    p = gk.CompressParams(num_resolutions=3, irreversible=True)
    stream = gk.compress(im, p)
    host_enc, dev_enc, host_dec, dev_dec = _host_then_device(im, p, stream)
    assert np.abs(host_dec.astype(int) - dev_dec.astype(int)).max() <= 1
    # device stream must decode as faithfully as the host stream
    host_err = np.abs(gk.decompress(host_enc).to_array().astype(int)
                      - arr.astype(int)).max()
    dev_err = np.abs(gk.decompress(dev_enc).to_array().astype(int)
                     - arr.astype(int)).max()
    assert dev_err <= host_err + 1


def test_float_chain_exact_is_false_on_cpu():
    """XLA:CPU contracts mul+add into FMAs, and the probe must see it (it
    keeps lossy tiles off the mesh by default there)."""
    import jax

    from grok_tpu.ops import jax_pipeline

    if jax.devices()[0].platform != "cpu":
        pytest.skip("CPU backend property")
    assert jax_pipeline.float_chain_exact() is False


@pytest.mark.gpu
@pytest.mark.parametrize("custom_mct", [False, True])
def test_float_chain_on_gpu(gpu_device, custom_mct):
    """On the card the 9/7 chain is held to its measured property: byte-
    identical streams when it rounds like the host, else within 1 LSB."""
    from grok_tpu.ops import jax_pipeline

    arr = natural_image(160, 224, 3)
    M = [[0.6, 0.3, 0.1], [-0.3, 0.5, -0.2], [0.1, -0.4, 0.5]]
    p = gk.CompressParams(num_resolutions=5, irreversible=True,
                          mct_matrix=M if custom_mct else None)
    im = gk.Image.from_array(arr)
    stream = gk.compress(im, p)
    host_enc, dev_enc, host_dec, dev_dec = _host_then_device(im, p, stream)
    diff = np.abs(host_dec.astype(int) - dev_dec.astype(int)).max()
    if jax_pipeline.float_chain_exact():
        assert dev_enc == host_enc
        assert diff == 0
    assert diff <= 1


def test_device_id_pins_ht_coders(monkeypatch):
    """GROK_TPU_DEVICE_ID (CLI -G) moves the HT coders to that device,
    as it does the transform chain, with unchanged output."""
    import jax

    from grok_tpu.ops.jax_pipeline import pin_device
    from grok_tpu.t1 import ht_jax
    from tests.test_ht_device import (_blocks, _check_decode_identical,
                                      _check_identical)

    if len(jax.devices()) < 2:
        pytest.skip("needs two devices")
    rng = np.random.default_rng(31)
    coeffs = _blocks(rng, 6, 16, 16, mag=300)
    hw = np.full(6, 16, dtype=np.int64)
    monkeypatch.setenv("GROK_TPU_DEVICE_ID", "1")
    out = pin_device(ht_jax._build(6, 16, 16, 10))(
        coeffs.astype(np.int32), hw.astype(np.int32), hw.astype(np.int32))
    assert out["max"].devices() == {jax.devices()[1]}
    _check_identical(coeffs, hw, hw)
    _check_decode_identical(coeffs, hw, hw, 16, 16)
