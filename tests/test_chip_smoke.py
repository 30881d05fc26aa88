"""chip_smoke.py on the CPU: its phase functions at 256x256 (the GPU run
uses 3840x2160), and its refusal to run without a GPU."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402

N = 256


@pytest.fixture(scope="module")
def frame():
    return bench.natural_image(N, N, 3)


def test_main_exits_nonzero_without_gpu(capsys):
    import jax

    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_four_cards_needs_gpus(monkeypatch):
    """Without GPUs the four-card path fails before printing a result."""
    import jax

    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")

    def child(kind, workdir):
        return {"platform": "cpu", "kind": "cpu", "count": 4}

    monkeypatch.setattr(cs, "nvidia_smi", lambda: ["(no card)"])
    monkeypatch.setattr(cs, "_four_child", child)
    monkeypatch.setattr(cs, "FOUR_CFGS", ())
    with pytest.raises(cs.PhaseError, match="cpu"):
        cs.main(["--four-cards"])


@pytest.mark.parametrize("cfg", ["lossless53", "lossy97_1bpp"])
def test_phase_codec(frame, cfg):
    res = cs.phase_codec(cfg, frame)
    assert res["spans_s"]["enc.device_fwd"] > 0
    assert res["spans_s"]["dec.device_inv"] > 0
    if cfg == "lossless53":
        assert res["stream_identical"]
    else:
        assert res["max_d"] <= 1


def test_phase_ht_coverage(frame):
    res = cs.phase_ht_coverage(frame)
    assert res["enc_device_blocks"] == res["dec_device_blocks"] > 0
    assert res["enc_host_blocks"] == res["dec_host_blocks"] == 0


def test_phase_ht_coverage_flags_host_route(frame, monkeypatch):
    """A block batch sent to the host coder fails the coverage phase."""
    from grok_tpu.t1 import ht_jax

    monkeypatch.setattr(ht_jax, "DEVICE_MAG_LIMIT", 1)
    with pytest.raises(cs.PhaseError, match="host route"):
        cs.phase_ht_coverage(frame[:64, :64])


def test_phase_cli(frame, tmp_path):
    res = cs.phase_cli(frame[:128, :128], str(tmp_path))
    assert res["lossless53"]["stream_identical"]
    assert res["ht_lossless"]["stream_identical"]


def test_phase_fma():
    res = cs.phase_fma(N, N)
    for name, *_ in cs.fma_cases(8, 8):
        assert res[name]["max_d"] <= 1


def test_phase_ebcot():
    res = cs.phase_ebcot(bench.photo_image(N, N, 3), n=8)
    assert res["blocks"] == 8 and res["bit_exact"]


def test_codec_env_restores_switches(monkeypatch):
    monkeypatch.setenv("GROK_TPU_T1", "native")
    monkeypatch.delenv("GROK_TPU_DEVICE", raising=False)
    with cs.codec_env(True, "ht_lossless"):
        assert os.environ["GROK_TPU_DEVICE"] == "jax"
        assert os.environ["GROK_TPU_T1"] == "ht-device"
    assert os.environ["GROK_TPU_T1"] == "native"
    assert "GROK_TPU_DEVICE" not in os.environ


def test_diff_stats():
    ref = np.zeros((4, 4, 3), np.int64)
    a = ref.copy()
    b = ref.copy()
    b[0, 0, 0] = 1
    st = cs._diff_stats(a, b, ref)
    assert st["samples_differ"] == 1 and st["max_d"] == 1
    assert st["dpsnr_db"] < 0
