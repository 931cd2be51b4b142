"""K8, the tuner's combine (``fgumi_tpu_torch/ops/tune_combine.py``), against
the JAX package's ``dev_combine`` (``fgumi_tpu/tune/autotune.py``,
``_bench_choosers``).

``dev_combine`` is defined inside ``_bench_choosers`` and cannot be
imported, so the reference is built as the JAX package builds it: the
``jnp.where`` expression under ``jax.jit``. The plain version equals it bit
for bit at the sweep's two shapes ((512, 100) under ``--quick``, (4096,
150) otherwise), on all 256 x 256 byte pairs (``min + 3`` wraps past 255 in
uint8 on both) and on the inputs ``chip_smoke.py`` holds the kernel to on
the card (``chip_smoke.tune_combine_inputs``: the sweep's, random bytes,
the wrap, an unaligned view). The wrapper takes the plain version for CPU
tensors and counts no launch; other devices, mixed devices, other dtypes,
unequal shapes and non-contiguous inputs raise. The ``gpu`` case holds the
kernel to its plain version on the card (it skips here; the card's run of
the same check is ``tests/test_torch_cuda.py``'s, which needs no JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fgumi_tpu_torch.ops import tune_combine as TC


@jax.jit
def dev_combine(x, y):
    return jnp.where(x == y, jnp.minimum(x, y) + 3,
                     jnp.maximum(x, y) - jnp.minimum(x, y))


def _jax(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.asarray(dev_combine(jnp.asarray(x), jnp.asarray(y)))


def _plain(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return TC.tune_combine_plain(torch.from_numpy(x),
                                 torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("shape", [(512, 100), (4096, 150)])
def test_plain_equals_jax_on_the_sweep_arrays(shape):
    n, L = shape
    a = np.random.default_rng(5).integers(0, 41, size=(n, L), dtype=np.uint8)
    b = np.random.default_rng(6).integers(0, 41, size=(n, L), dtype=np.uint8)
    got, want = _plain(a, b), _jax(a, b)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (n, L)
    assert np.array_equal(got, want)
    # and the host side of the bench: the same numpy expression
    assert np.array_equal(got, np.where(a == b, np.minimum(a, b) + 3,
                                        np.maximum(a, b) - np.minimum(a, b)))


def test_plain_equals_jax_on_every_byte_pair():
    x, y = np.meshgrid(np.arange(256, dtype=np.uint8),
                       np.arange(256, dtype=np.uint8), indexing="ij")
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    got = _plain(x, y)
    assert np.array_equal(got, _jax(x, y))
    # the wrap: min + 3 of an equal pair at 253-255 is 0-2
    assert [int(got[v, v]) for v in (252, 253, 254, 255)] == [255, 0, 1, 2]
    assert int(got[0, 255]) == 255 and int(got[40, 3]) == 37


@pytest.mark.parametrize("shape", [(512, 100), (4096, 150), (37, 99)])
def test_plain_equals_jax_on_the_chip_inputs(shape):
    inputs = chip_smoke.tune_combine_inputs(*shape, torch.device("cpu"))
    assert set(inputs) == {"sweep", "bytes", "wrap", "unaligned"}
    for name, (x, y) in inputs.items():
        a, b = x.numpy(), y.numpy()
        launches = TC.TUNE_COMBINE_LAUNCHES
        got = TC.tune_combine(x, y).numpy()
        assert TC.TUNE_COMBINE_LAUNCHES == launches  # the plain version
        assert np.array_equal(got, _jax(np.ascontiguousarray(a),
                                        np.ascontiguousarray(b))), name
    x, y = inputs["unaligned"]
    assert x.data_ptr() % 16 == 1 and x.is_contiguous()
    wx, wy = inputs["wrap"]
    assert bool(((wx == wy) & (wx >= 253)).any())


def test_wrapper_cpu_route_and_refusals():
    x = torch.arange(24, dtype=torch.uint8).reshape(4, 6)
    y = torch.flip(x, dims=(1,)).contiguous()
    launches = TC.TUNE_COMBINE_LAUNCHES
    assert torch.equal(TC.tune_combine(x, y), TC.tune_combine_plain(x, y))
    assert TC.tune_combine(x[:0], y[:0]).shape == (0, 6)
    assert TC.TUNE_COMBINE_LAUNCHES == launches
    meta = torch.empty((4, 6), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TC.tune_combine(meta, meta)
    with pytest.raises(ValueError, match="different devices"):
        TC.tune_combine(x, meta)
    with pytest.raises(TypeError, match="torch.uint8"):
        TC.tune_combine(x.to(torch.int16), y.to(torch.int16))
    with pytest.raises(ValueError, match="shapes differ"):
        TC.tune_combine(x, y[:3])
    with pytest.raises(ValueError, match="contiguous"):
        TC.tune_combine(x.t(), y.t())
    assert TC.TUNE_COMBINE_LAUNCHES == launches


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 100), (4096, 150), (37, 99)])
def test_kernel_matches_plain_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda", 0)
    for name, (x, y) in chip_smoke.tune_combine_inputs(*shape, dev).items():
        launches = TC.TUNE_COMBINE_LAUNCHES
        got = TC.tune_combine(x, y)
        torch.cuda.synchronize()
        assert TC.TUNE_COMBINE_LAUNCHES == launches + 1
        assert torch.equal(got, TC.tune_combine_plain(x, y)), name
        assert np.array_equal(got.cpu().numpy(),
                              _jax(x.cpu().numpy(), y.cpu().numpy())), name
