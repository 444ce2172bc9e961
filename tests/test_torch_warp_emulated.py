"""The CUDA source of the warp kernels (echoflow_torch/csrc/warp.cu) on the
CPU: compiled with g++ against a host emulation of the CUDA subset it uses
(tests/cuda_host_emu/cuda_runtime.h: each warp runs as 32 threads, and a
shuffle or ballot that not every lane reaches from the same line is an
error), then run on CPU tensors against the plain PyTorch versions. K2
(single and pair) and K4 are held bitwise, K3 within its per-element bound.

This holds the kernels' indexing, chunking, lane sharing and refusals in the
CPU tests; what only the card shows (nvcc, timing, the memory model) is
held by tests/test_torch_cuda.py. Skips where there is no g++."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from echoflow_torch.ops import warp_kernel as wk

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "echoflow_torch" / "csrc" / "warp.cu"
SHIM = Path(__file__).resolve().parent / "cuda_host_emu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for host emulation")
    # kernel<<<grid, block, smem, stream>>>(args) -> emu_launch([&] { kernel(args); }, grid, ...)
    src = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\)(\s*;|\s*\\?\n)",
                 lambda m: f"emu_launch([&] {{ {m.group(1)}({m.group(3)}); }}, "
                           f"{m.group(2)}){m.group(4)}",
                 SOURCE.read_text(), flags=re.S)
    assert "<<<" not in src
    out = tmp_path_factory.mktemp("warp_emu")
    (out / "warp_emu.cpp").write_text(src)
    so = out / "libwarp_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-ffp-contract=off", "-Wno-unknown-pragmas", f"-I{SHIM}", "-o", str(so),
                    str(out / "warp_emu.cpp")], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.echoflow_warp_forward.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.echoflow_warp_forward2.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.echoflow_warp_image_grad.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.echoflow_warp_image_grad_scratch.argtypes = [i32] * 4
    lib.echoflow_warp_image_grad_scratch.restype = ctypes.c_longlong
    lib.echoflow_warp_coord_grad.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    return lib


def _coords(n, h, w, motion, seed=0):
    """tests/test_torch_cuda.py's motions on the CPU: "far" past the
    border, "near" 0.3 px of noise, "shift" a uniform 0.3 px shift (nearly
    every lane takes its x0 + 1 corners from the next lane); some
    coordinates exactly on the last row and column."""
    g = torch.Generator().manual_seed(seed)
    if motion == "far":
        px = (torch.rand((n, h, w), generator=g) * 1.4 - 0.2) * w - 0.5
        py = (torch.rand((n, h, w), generator=g) * 1.4 - 0.2) * h - 0.5
    else:
        noise = 0.3 * torch.randn((2, n, h, w), generator=g) if motion == "near" \
            else torch.full((2, n, h, w), 0.3)
        px = torch.arange(w, dtype=torch.float32) + noise[0]
        py = torch.arange(h, dtype=torch.float32)[:, None] + noise[1]
    px[:, ::3, ::4] = w - 1.0
    py[:, ::4, ::3] = h - 1.0
    return px.contiguous(), py.contiguous()


def _images(n, channels, h, w, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((n, c, h, w), generator=g) for c in channels]


# W = 17, 9, 1, 30 are not multiples of 4; 15 x 17, 1 x 9, 31 x 1 pixels not
# a multiple of a warp.
SHAPES = [(3, 15, 17), (2, 1, 9), (1, 31, 1), (2, 12, 30)]
MOTIONS = ["far", "near", "shift"]


@pytest.mark.parametrize("motion", MOTIONS)
@pytest.mark.parametrize("channels", [(4, 3), (1, 1), (3, 6), (7, 2)])
@pytest.mark.parametrize("nhw", SHAPES)
def test_emulated_pair_forward_is_bitwise_plain(lib, nhw, channels, motion):
    n, h, w = nhw
    px, py = _coords(n, h, w, motion)
    a, b = _images(n, channels, h, w)
    out_a, out_b = torch.full_like(a, float("nan")), torch.full_like(b, float("nan"))
    err = lib.echoflow_warp_forward2(a.data_ptr(), b.data_ptr(), px.data_ptr(), py.data_ptr(),
                                     out_a.data_ptr(), out_b.data_ptr(), n, *channels, h, w, None)
    assert err == 0 and lib.emu_errors() == 0
    assert torch.equal(out_a, wk.reference_warp_forward(a, px, py))
    assert torch.equal(out_b, wk.reference_warp_forward(b, px, py))


@pytest.mark.parametrize("motion", MOTIONS)
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("nhw", SHAPES)
def test_emulated_forward_and_coord_grad_are_bitwise_plain(lib, nhw, c, motion):
    n, h, w = nhw
    px, py = _coords(n, h, w, motion)
    image, = _images(n, (c,), h, w)
    g = torch.randn(image.shape, generator=torch.Generator().manual_seed(2))
    out = torch.full_like(image, float("nan"))
    d_px, d_py = torch.full_like(px, float("nan")), torch.full_like(py, float("nan"))
    assert lib.echoflow_warp_forward(image.data_ptr(), px.data_ptr(), py.data_ptr(),
                                     out.data_ptr(), n, c, h, w, None) == 0
    assert lib.echoflow_warp_coord_grad(image.data_ptr(), g.data_ptr(), px.data_ptr(),
                                        py.data_ptr(), d_px.data_ptr(), d_py.data_ptr(),
                                        n, c, h, w, None) == 0
    assert lib.emu_errors() == 0
    assert torch.equal(out, wk.reference_warp_forward(image, px, py))
    r_px, r_py = wk.reference_warp_coord_grad(image, g, px, py)
    assert torch.equal(d_px, r_px) and torch.equal(d_py, r_py)


@pytest.mark.parametrize("motion", MOTIONS)
@pytest.mark.parametrize("c", [3, 4, 5])
def test_emulated_image_grad_within_its_bound(lib, c, motion):
    n, h, w = 2, 15, 17
    px, py = _coords(n, h, w, motion)
    g = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(3))
    d_img = torch.full_like(g, float("nan"))
    scratch = torch.zeros(lib.echoflow_warp_image_grad_scratch(n, c, h, w))
    assert lib.echoflow_warp_image_grad(g.data_ptr(), px.data_ptr(), py.data_ptr(),
                                        d_img.data_ptr(), scratch.data_ptr(), n, c, h, w,
                                        None) == 0
    assert lib.emu_errors() == 0
    tol = wk.image_grad_tolerance(g, px, py)
    assert bool(((d_img - wk.reference_warp_image_grad(g, px, py)).abs() <= tol).all())


def test_emulated_kernels_refuse_what_they_cannot_index(lib):
    z = torch.zeros(4)
    p = z.data_ptr()
    assert lib.echoflow_warp_forward2(p, p, p, p, p, p, 1, 1, 0, 2, 2, None) != 0   # cb = 0
    assert lib.echoflow_warp_forward2(p, p, p, p, p, p, 1, 0, 1, 2, 2, None) != 0   # ca = 0
    # 2^31 elements of one image: int offsets would overflow.
    assert lib.echoflow_warp_forward(p, p, p, p, 1 << 10, 1 << 11, 1 << 10, 1, None) != 0
    assert lib.echoflow_warp_forward2(p, p, p, p, p, p, 1 << 10, 1, 1 << 11, 1 << 10, 1,
                                      None) != 0
