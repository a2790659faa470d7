"""The work counts of each kind of unit against hand counts at one small
shape each, and at the cells' own shapes against the figures they were
planned with."""

from types import SimpleNamespace

import pytest

from nddwt_bench import counts, harness


def _ctx(shape, wavelet, level, coils=1, **traffic):
    cfg = {"shape": shape, "wavelet": wavelet, "level": level, "dtype": "float32",
           "coils": coils, "preserve_l2": True}
    return SimpleNamespace(cfg=cfg, traffic=traffic)


def _kind(name):
    return harness.load_module(harness.BENCH_DIR / "kinds" / f"{name}.py",
                               f"nddwt_bench.kinds.{name}")


def test_denoise_hand_count():
    # (8, 8, 8) db2 L2, real: 512 voxels, 15 bands; bytes 4*512*(1+15) each
    # way; a level 2*4*(2+4+8)*512 operations each way.
    w = _kind("dec_rec").work(_ctx([8, 8, 8], "db2", 2))
    assert (w.bytes, w.flops) == (2 * 32768, 2 * 2 * 57344)


def test_coil_hand_count():
    # 3 coils of (16, 12) db4 L3: 6 real components of 192 elements, 10
    # bands; bytes 6*4*192*11 each way; a level 2*8*(2+4)*192 per component.
    w = _kind("coil_prox").work(_ctx([16, 12], "db4", 3, coils=3))
    assert (w.bytes, w.flops) == (2 * 50688, 2 * 6 * 3 * 18432)


def test_cs_hand_count():
    # (8, 8, 4) db2 L2, 3 iterations; 256 voxels, complex64 (8 bytes).
    # An iteration: two FFTs (2*2*256*8 bytes, 2*5*256*8 operations), the
    # residual (256*(8+8+4+8)), the gradient step and the momentum (256*24
    # each), analysis and synthesis of two components (2*2*4*256*16 bytes,
    # 2*2*2*8*(2+4+8)*256 operations). First: the masked b and one FFT.
    w = _kind("fista_cs").work(_ctx([8, 8, 4], "db2", 2, iters=3))
    per_iter_bytes = 8192 + 7168 + 6144 + 65536 + 6144
    per_iter_flops = 20480 + 229376
    assert w.bytes == 5120 + 4096 + 3 * per_iter_bytes
    assert w.flops == 10240 + 3 * per_iter_flops


def test_cell_shapes():
    # The coil step moves 622 MB, the denoising call 184 bytes a voxel, the
    # CS iteration 476 bytes a voxel, the figures the cells were planned with.
    coil = _kind("coil_prox").work(_ctx([640, 368], "db4", 3, coils=15))
    assert coil.bytes == 30 * 640 * 368 * 4 * 22
    n = 320 * 320 * 256
    den = _kind("dec_rec").work(_ctx([320, 320, 256], "db4", 3))
    assert den.bytes == 184 * n
    cs = _kind("fista_cs").work(_ctx([320, 320, 256], "db4", 3, iters=1))
    assert cs.bytes == 476 * n + 36 * n


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3"])
def test_least_time_bound(name):
    peaks = counts.PEAKS[name]
    t, bound = counts.Work(3.35e12, 1.0).least_s(peaks)
    assert (t, bound) == (1.0, "bytes")
    t, bound = counts.Work(1.0, 67e12).least_s(peaks)
    assert (t, bound) == (1.0, "operations")
