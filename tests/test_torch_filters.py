"""The torch port's NumPy filter bank and band helpers are the JAX
package's, bit for bit: same taps for every wavelet family and order, same
band counts, same errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import non_decimated_wavelets_tpu as nw
from non_decimated_wavelets_tpu import filters as jf
from non_decimated_wavelets_tpu import oracle as jo

import non_decimated_wavelets_tpu_torch as tw
from non_decimated_wavelets_tpu_torch import filters as tf
from non_decimated_wavelets_tpu_torch import oracle as to

# The suite runs in several worker processes that share the machine's
# cores; one intra-op thread keeps torch from oversubscribing them.
torch.set_num_threads(1)

NAMES = [f"db{p}" for p in range(1, 11)] + ["db38"] + [
    f"sym{p}" for p in range(2, 9)
] + ["haar"]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_taps_bit_identical(name):
    for fn in ("correlation_taps", "decomposition_filters"):
        for a, b in zip(getattr(tf, fn)(name), getattr(jf, fn)(name)):
            _same(a, b)
    lo = tf.correlation_taps(name)[0]
    _same(tf.qmf_highpass(lo), jf.qmf_highpass(lo))
    n = max(len(lo), 16)
    _same(tf.frequency_response(name, n), jf.frequency_response(name, n))
    family, p = tf._parse_family(name)
    taps = tf.daubechies_taps if family == "db" else tf.symlet_taps
    ref = jf.daubechies_taps if family == "db" else jf.symlet_taps
    _same(taps(p), ref(p))
    assert tf.parse_wavelet_name(name) == jf.parse_wavelet_name(name)


@pytest.mark.parametrize(
    "wv,shape,pl2",
    [
        (("db2", "db3", "db4"), (16, 16, 16), False),
        (("haar", "sym4"), (12, 20), True),
        ("db4", (64, 64, 64), True),
        (("db1", "db6", "sym3", "db2"), (8, 12, 9, 10), False),
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_taps_bit_identical(wv, shape, pl2, dtype):
    """Per-axis tuples: the plans' full-precision and storage-dtype taps."""
    jp = nw.NDDWT(wavelet=wv, shape=shape, preserve_l2=pl2, dtype=dtype)
    tp = tw.NDDWT(wv, shape, preserve_l2=pl2, dtype=dtype, device="cpu")
    assert tp.wavelets == jp.wavelets
    assert tp.filter_lengths == jp.filter_lengths
    for a, b in zip(tp.taps_hp, jp.taps_hp):
        _same(a, b)
    for a, b in zip(tp.taps, jp.taps):  # bf16 compared exactly via float32
        _same(a.float().numpy(), np.asarray(b).astype(np.float32))


@pytest.mark.parametrize("ndim", [1, 2, 3, 4])
def test_band_helpers(ndim):
    for level in range(1, 6):
        B = tw.num_bands(ndim, level)
        assert B == jo.num_bands(ndim, level)
        assert tw.level_from_bands(ndim, B) == jo.level_from_bands(ndim, B)
    bad = 2**ndim - 1  # fewer than one level's bands
    for mod in (to, jo):
        with pytest.raises(ValueError, match="not a valid"):
            mod.level_from_bands(ndim, bad)


@pytest.mark.parametrize(
    "call",
    [
        lambda m: m.parse_wavelet_name("coif2"),
        lambda m: m.parse_wavelet_name("db0"),
        lambda m: m.parse_wavelet_name("db39"),
        lambda m: m.parse_wavelet_name("sym21"),
        lambda m: m.qmf_highpass(np.ones(3)),
        lambda m: m.frequency_response("db4", 7),
    ],
)
def test_filter_errors_match(call):
    msgs = []
    for mod in (tf, jf):
        with pytest.raises(ValueError) as e:
            call(mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize(
    "wavelets,ndim", [(("db1", "db2"), 3), (("db1", "bogus"), 2), ([], 1)]
)
def test_normalize_wavelets_errors_match(wavelets, ndim):
    msgs = []
    for mod in (to, jo):
        with pytest.raises(ValueError) as e:
            mod._normalize_wavelets(wavelets, ndim)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
