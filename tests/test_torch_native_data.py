"""Port parity: the native batch generator, the prefetching loader and the
synthetic pipelines give the JAX package's bytes for the same seeds.

The port keeps its own copy of ``tf_operator_tpu/native`` (built with g++
into ``build/torch_native/``); its ``fill_uniform``, ``fill_randint``,
``normalize_images``, ``SyntheticImages``, ``SyntheticLM``,
``images_pipeline`` and ``lm_pipeline`` are byte-equal to the JAX
package's, with the loader at 1 and 2 threads on either side. A source
that does not build raises instead of falling back to numpy.
"""

import time

import numpy as np
import pytest
import torch

from tf_operator_tpu import native as jnative
from tf_operator_tpu.native import prefetch as jprefetch
from tf_operator_tpu.train import data as jdata
from tf_operator_tpu_torch import native as tnative
from tf_operator_tpu_torch.native import prefetch as tprefetch
from tf_operator_tpu_torch.train import data as tdata

pytestmark = pytest.mark.compute


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_the_jax_package_uses_its_native_build():
    """Byte equality below would be vacuous against numpy fallbacks."""
    assert jnative.available() and jprefetch.available()


# Sizes on both sides of the generator's threading threshold (1 << 16).
@pytest.mark.parametrize("shape", [(7,), (4, 32, 32, 3), (3, 1 << 16)],
                         ids=str)
@pytest.mark.parametrize("seed", [0, 12345, (7 << 20) + 3])
def test_fill_uniform_is_byte_equal(shape, seed):
    got, want = tnative.fill_uniform(shape, seed), jnative.fill_uniform(
        shape, seed)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert 0.0 <= got.min() and got.max() < 1.0


@pytest.mark.parametrize("low, high", [(0, 1000), (3, 11), (5, 5)])
@pytest.mark.parametrize("shape", [(16,), (2, 1 << 16)], ids=str)
def test_fill_randint_is_byte_equal(shape, low, high):
    got = tnative.fill_randint(shape, low, high, 42)
    want = jnative.fill_randint(shape, low, high, 42)
    assert got.dtype == np.int32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", [(4, 8, 8, 3), (2, 300, 300, 3)], ids=str)
def test_normalize_images_is_byte_equal(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    got = tnative.normalize_images(img, mean, std)
    assert got.tobytes() == jnative.normalize_images(img, mean,
                                                     std).tobytes()
    expected = (img.astype(np.float32) / 255.0
                - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_generators_are_byte_equal(seed):
    pairs = [
        (tdata.SyntheticImages(3, 16, num_classes=7, seed=seed),
         jdata.SyntheticImages(3, 16, num_classes=7, seed=seed)),
        (tdata.SyntheticLM(4, 16, vocab_size=100, seed=seed),
         jdata.SyntheticLM(4, 16, vocab_size=100, seed=seed)),
    ]
    for port, ref in pairs:
        got, want = iter(port), iter(ref)
        for _ in range(3):
            assert_batches_equal(next(got), next(want))
    first = next(iter(tdata.SyntheticLM(4, 16, 100, seed=seed)))
    assert first["inputs"].shape == (4, 17)


@pytest.mark.parametrize("threads", [(1, 2), (2, 1), (2, 2)])
def test_images_pipeline_is_byte_equal(threads):
    ours, theirs = threads
    with tdata.images_pipeline(4, 16, num_classes=9, seed=3,
                               threads=ours) as got:
        want = jdata.images_pipeline(4, 16, num_classes=9, seed=3,
                                     threads=theirs)
        try:
            for _ in range(6):
                batch = next(got)
                assert_batches_equal(batch, next(want))
        finally:
            want.close()
    assert batch["inputs"].shape == (4, 16, 16, 3)
    assert batch["labels"].dtype == np.int32 and batch["labels"].max() < 9


@pytest.mark.parametrize("threads", [(1, 2), (2, 1)])
def test_lm_pipeline_is_byte_equal(threads):
    ours, theirs = threads
    with tdata.lm_pipeline(2, 32, vocab_size=500, seed=1,
                           prefetch_depth=2, threads=ours) as got:
        want = jdata.lm_pipeline(2, 32, vocab_size=500, seed=1,
                                 prefetch_depth=8, threads=theirs)
        try:
            for _ in range(6):
                batch = next(got)
                assert_batches_equal(batch, next(want))
        finally:
            want.close()
    assert batch["inputs"].shape == (2, 33)


def test_loader_runs_ahead_and_closes():
    with tprefetch.create_tokens(8, 64, 100, depth=4, threads=2) as ld:
        next(ld)
        deadline = time.monotonic() + 2.0
        while ld.produced() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ld.produced() >= 3
    ld.close()      # idempotent
    with pytest.raises(StopIteration):
        next(ld)


def test_pipeline_through_prefetch_to_device():
    """The batches reach the device (here the CPU) as tensors equal to the
    numpy batches."""
    with tdata.images_pipeline(2, 8, seed=4) as src, \
            tdata.images_pipeline(2, 8, seed=4) as ref:
        fed = tdata.prefetch_to_device(src, "cpu", depth=2)
        for _ in range(3):
            got, want = next(fed), next(ref)
            assert isinstance(got["inputs"], torch.Tensor)
            assert torch.equal(got["inputs"], torch.from_numpy(
                want["inputs"]))
            assert torch.equal(got["labels"], torch.from_numpy(
                want["labels"]))


def test_build_is_keyed_by_the_source(monkeypatch, tmp_path):
    """The library is named by a hash of its source: another source gets
    another file, the same source the same one."""
    path = tnative.library_path("batchgen")
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert tnative.library_path("batchgen") == path
    src = tmp_path / "batchgen.cc"
    src.write_text((tnative.SRC / "batchgen.cc").read_text() + "\n// x\n")
    monkeypatch.setattr(tnative, "SRC", tmp_path)
    assert tnative.library_path("batchgen") != path


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No numpy fallback: a compiler that fails is an error."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_loaded", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building batchgen.cc failed"):
        tnative.fill_uniform((4,), 0)
    assert not list(tmp_path.glob("*.so"))
