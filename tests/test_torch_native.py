"""The port's native host normalizer (`echoflow_torch/csrc/preprocess.cc`,
`ops/native.py`) against echoflow's (`echoflow.native`) and the numpy path.

echoflow's library is built here by its own Makefile into a directory of
the test's, so this file never rebuilds `echoflow/native/` under a test
that is loading it; the port's builds into `echoflow_torch/_build/` as it
does at first use.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import echoflow.native as jax_native

from echoflow_torch.ops import _build, native
from echoflow_torch.ops.normalize import zeroone_normalizer, zeroone_normalizer_numpy


@pytest.fixture(scope="module")
def echoflow_native(tmp_path_factory):
    """`echoflow.native.zeroone_normalize_native` on echoflow's library,
    built by its Makefile from a copy of its sources."""
    src = Path(jax_native.__file__).parent
    build = tmp_path_factory.mktemp("echoflow_native")
    for name in ("Makefile", "preprocess.cc"):
        shutil.copy(src / name, build / name)
    subprocess.run(["make", "-C", str(build)], check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_LIB_PATH", str(build / "libechoflow_native.so"))
    mp.setattr(jax_native, "_lib", None)
    assert jax_native.available()
    yield jax_native.zeroone_normalize_native
    mp.undo()


def _video(dtype, seed=0, shape=(3, 12, 20, 24)):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(7, 241, size=shape).astype(np.uint8)
    return (rng.rand(*shape) * 200.0 - 30.0).astype(np.float32)


@pytest.mark.parametrize("threads", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
def test_native_normalizer_is_bitwise_echoflows_and_numpys(echoflow_native, dtype, threads):
    """uint8 and float32 videos on 1-4 threads (more threads than the 3
    channels included): bitwise echoflow's native loop and the numpy
    path, a new float32 array, the input untouched."""
    video = _video(dtype, seed=threads)
    before = video.copy()
    got = native.zeroone_normalize_native(video, threads=threads)
    assert got.dtype == np.float32 and got.shape == video.shape
    np.testing.assert_array_equal(got, echoflow_native(video, threads=threads))
    np.testing.assert_array_equal(got, zeroone_normalizer_numpy(video))
    np.testing.assert_array_equal(video, before)
    assert got.min() == 0.0 and got.max() == 1.0


def test_normalizer_routes_uint8_to_the_native_loop(monkeypatch):
    """`zeroone_normalizer` sends uint8 input to the native loop (the CLI's
    decoded video) and keeps float input on the in-place numpy path, as
    echoflow routes them."""
    calls = []
    real = native.zeroone_normalize_native
    monkeypatch.setattr(native, "zeroone_normalize_native",
                        lambda video, threads=None: calls.append(1) or real(video, threads))
    video = _video(np.uint8, seed=5)
    np.testing.assert_array_equal(zeroone_normalizer(video), zeroone_normalizer_numpy(video))
    assert len(calls) == 1
    floats = video.astype(np.float32)
    assert np.shares_memory(zeroone_normalizer(floats), floats) and len(calls) == 1


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that is not there, or one that fails, raises: nothing
    falls back to numpy. The library name carries the compiler, so a new
    compiler builds anew."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+"):
        _build.build_host("preprocess")
    failing = tmp_path / "failing-c++"
    failing.write_text("#!/bin/sh\necho 'broken compiler' >&2\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setenv("CXX", str(failing))
    with pytest.raises(RuntimeError, match="broken compiler"):
        _build.build_host("preprocess")
    assert not list(tmp_path.glob("*.so"))   # no partial library left behind


def test_host_library_is_named_by_source_compiler_and_flags(monkeypatch, tmp_path):
    """The host library lands in the build directory under the hash of its
    source, compiler and flags, is reused while they stay, and the CUDA
    build's `*.cu` list does not take the `.cc` source."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    path = _build.build_host("preprocess")
    assert path.parent == tmp_path and path.exists()
    assert path == _build.host_library_path("preprocess", "g++")
    mtime = path.stat().st_mtime_ns
    assert _build.build_host("preprocess") == path and path.stat().st_mtime_ns == mtime
    assert _build.host_library_path("preprocess", "clang++") != path
    cuda_sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert "preprocess" not in cuda_sources and cuda_sources
    assert (_build.CSRC / "preprocess.cc").exists()


def test_threads_below_one_are_refused():
    with pytest.raises(ValueError, match="threads"):
        native.zeroone_normalize_native(_video(np.uint8), threads=0)
