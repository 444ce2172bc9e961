"""The decoder-tail kernel's module (echoflow_torch/ops/decoder_heads.py)
and the folded forward against echoflow's decoder oracles.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py);
here the plain version, the kernel's host-side tables and the
arithmetic the kernel performs with them are held against echoflow."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import echoflow.ops.pallas.decoder_kernel as DK
from echoflow.models.fast_forward import folded_forward as jax_folded_forward
from echoflow.models.fold_bn import fold_variables
from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet, init_variables

from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.models.fast_forward import (
    decoder_weights,
    folded_forward,
    merged_projections,
    plain_decoder,
)
from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet
from echoflow_torch.ops import _build
from echoflow_torch.ops.decoder_heads import (
    _axis_table,
    decoder_heads,
    reference_decoder_heads,
)
from echoflow_torch.ops.resize import _linear_resize_matrix_np

torch.set_num_threads(2)

SPECS = [((16, 16), (8, 8), (4, 4)), ((32, 32), (16, 16), (8, 8), (4, 4))]
NAMES = ("b1", "w2", "b2", "ws", "bs", "wm", "bm")


def _inputs(seed, specs, c=16, c2=16, b=2, t=4):
    """The random projections and weights of tests/test_fast_forward.py."""
    rng = np.random.RandomState(seed)
    projs = [(rng.randn(b, t, h, w, c) * 0.2).astype(np.float32) for h, w in specs]
    shapes = dict(b1=(c,), w2=(c, c2), b2=(c2,), ws=(c2, 2), bs=(2,), wm=(c2, 4), bm=(4,))
    scale = dict(b1=0.1, w2=0.3, b2=0.1, ws=0.3, bs=0.1, wm=0.3, bm=0.1)
    weights = {k: (rng.randn(*shapes[k]) * scale[k]).astype(np.float32) for k in NAMES}
    return projs, weights


def _torch(projs, weights):
    return [torch.from_numpy(p) for p in projs], {k: torch.from_numpy(v) for k, v in weights.items()}


@pytest.mark.parametrize("specs", SPECS)
def test_plain_matches_xla_reference(specs):
    projs, w = _inputs(0, specs)
    rseg, rmot = DK.xla_reference_decoder_heads(
        [jnp.asarray(p) for p in projs], *[jnp.asarray(w[k]) for k in NAMES], out_hw=(32, 32))
    tp, tw = _torch(projs, w)
    seg, mot = reference_decoder_heads(tp, **tw, out_hw=(32, 32))
    # Both are fp32 statements of one formula; only summation order differs.
    np.testing.assert_allclose(seg.numpy(), np.asarray(rseg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mot.numpy(), np.asarray(rmot), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_motion", [True, False])
@pytest.mark.parametrize("specs", SPECS)
def test_plain_matches_pallas_interpret(specs, with_motion):
    projs, w = _inputs(1, specs)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    if not with_motion:
        jw.pop("wm"), jw.pop("bm")
    DK.set_interpret_mode(True)
    try:
        kseg, kmot = DK.fused_decoder_heads([jnp.asarray(p) for p in projs], **jw,
                                            out_hw=(32, 32), with_motion=with_motion)
    finally:
        DK.set_interpret_mode(False)
    tp, tw = _torch(projs, w)
    seg, mot = reference_decoder_heads(tp, **tw, out_hw=(32, 32), with_motion=with_motion)
    # The Pallas kernel rounds its operands to bf16 (a TPU MXU choice):
    # the tolerance of tests/test_fast_forward.py:53-58.
    np.testing.assert_allclose(seg.numpy(), np.asarray(kseg), rtol=0.05, atol=0.05)
    if with_motion:
        np.testing.assert_allclose(mot.numpy(), np.asarray(kmot), rtol=0.05, atol=0.05)
    else:
        assert mot is None and kmot is None


def test_wrapper_on_cpu_is_the_plain_version():
    projs, w = _inputs(2, SPECS[0])
    tp, tw = _torch(projs, w)
    before = decoder_heads.launches
    got = decoder_heads(tp, **tw, out_hw=(32, 32))
    want = reference_decoder_heads(tp, **tw, out_hw=(32, 32))
    assert decoder_heads.launches == before   # nothing launched on the CPU
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("align_corners", [True, False])
def test_kernel_tables_rebuild_the_resize_matrix(align_corners):
    """The kernel's per-axis (lo, hi, w_lo, w_hi) tables carry exactly the
    plain version's float32 weights."""
    for src in (1, 4, 7, 14, 28, 56, 112):
        for dst in (1, 5, 32, 112, 128):
            idx, wts = _axis_table(src, dst, align_corners)
            mat = np.zeros((dst, src), np.float32)
            rows = np.arange(dst)
            mat[rows, idx[:, 0]] += wts[:, 0]
            mat[rows, idx[:, 1]] += wts[:, 1]
            np.testing.assert_array_equal(mat, _linear_resize_matrix_np(src, dst, align_corners))
            assert idx.dtype == np.int32 and wts.dtype == np.float32


@pytest.mark.parametrize("specs", SPECS)
def test_kernel_arithmetic_matches_plain(specs):
    """The kernel's per-pixel recipe, written out in torch: four corner
    reads per source from the tables (rows first, then columns), bias and
    ReLU, comb2 one output channel at a time folded into the heads."""
    projs, w = _inputs(3, specs)
    tp, tw = _torch(projs, w)
    h_out = w_out = 32
    acc = 0.0
    for p in tp:
        yi, yw = (torch.from_numpy(a) for a in _axis_table(p.shape[2], h_out, True))
        xi, xw = (torch.from_numpy(a) for a in _axis_table(p.shape[3], w_out, True))
        rows = lambda k: p[:, :, yi[:, k].long()]                     # (B,T,H,wr,C)
        corner = lambda r, k: r[:, :, :, xi[:, k].long()]             # (B,T,H,W,C)
        wy = lambda k: yw[:, k][:, None, None]
        wx = lambda k: xw[:, k][:, None]
        lo_col = wy(0) * corner(rows(0), 0) + wy(1) * corner(rows(1), 0)
        hi_col = wy(0) * corner(rows(0), 1) + wy(1) * corner(rows(1), 1)
        acc = acc + wx(0) * lo_col + wx(1) * hi_col
    y = torch.relu(acc + tw["b1"])
    seg = torch.zeros(*y.shape[:-1], 2)
    mot = torch.zeros(*y.shape[:-1], 4)
    for d in range(tw["w2"].shape[1]):
        z = torch.relu((y * tw["w2"][:, d]).sum(-1) + tw["b2"][d])[..., None]
        seg = seg + z * tw["ws"][d]
        mot = mot + z * tw["wm"][d]
    seg, mot = seg + tw["bs"], torch.tanh(mot + tw["bm"])
    rseg, rmot = reference_decoder_heads(tp, **tw, out_hw=(h_out, w_out))
    np.testing.assert_allclose(seg.numpy(), rseg.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mot.numpy(), rmot.numpy(), rtol=1e-5, atol=1e-5)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: a clear error, never a silent fall back to the plain path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["decoder_heads"])


def test_module_imports_without_triton_or_nvcc(tmp_path):
    """Importing and running the CPU path needs neither triton nor nvcc,
    and builds nothing."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'triton' or name.startswith('triton.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from echoflow_torch.ops import _build\n"
        "from echoflow_torch.ops.decoder_heads import decoder_heads\n"
        "import echoflow_torch.infer.pipeline\n"
        "p = [torch.zeros(1, 2, 4, 4, 8)]\n"
        "w = [torch.zeros(8), torch.zeros(8, 8), torch.zeros(8), torch.zeros(8, 2), torch.zeros(2)]\n"
        "seg, mot = decoder_heads(p, *w, out_hw=(8, 8))\n"
        "assert seg.shape == (1, 2, 8, 8, 2) and mot is None\n"
        "assert not _build._libs and decoder_heads.launches == 0\n"
    )
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path / "none"),
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent.parent)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def folded_pair():
    v = init_variables(jax.random.PRNGKey(1), FlaxNet(), (1, 3, 8, 16, 16))
    folded = fold_variables(v)
    model = R2Plus1DMotionSegNet(folded=True)
    model.load_state_dict(state_dict_from_variables(folded), strict=True)
    return folded, model.eval()


def test_folded_forward_matches_echoflow(folded_pair):
    folded, model = folded_pair
    x = np.random.RandomState(0).rand(1, 3, 8, 32, 32).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        seg_j, mot_j = jax.jit(lambda v, x: jax_folded_forward(v, x, pallas=False))(
            folded, jnp.asarray(x))
    with torch.no_grad():
        seg_k, mot_k = folded_forward(model, torch.from_numpy(x))             # K1 path
        projs = merged_projections(model.r2plus1d_model(torch.from_numpy(x)),
                                   model.comb_1_layer.weight)
        seg_p, mot_p = (a.permute(0, 4, 1, 2, 3) for a in plain_decoder(
            projs, *decoder_weights(model), out_hw=x.shape[3:]))
        seg_m, _ = model(torch.from_numpy(x))
    # fp32 reassociation across two frameworks (tests/test_convert.py:146).
    for seg, mot in ((seg_k, mot_k), (seg_p, mot_p)):
        np.testing.assert_allclose(seg.numpy(), np.asarray(seg_j), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(mot.numpy(), np.asarray(mot_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(seg_k.numpy(), seg_m.numpy(), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        seg_n, mot_n = folded_forward(model, torch.from_numpy(x), with_motion=False)
    assert mot_n is None and torch.equal(seg_n, seg_k)


def test_plain_decoder_matches_reference_decoder():
    projs, w = _inputs(4, SPECS[1])
    tp, tw = _torch(projs, w)
    a = plain_decoder(tp, *[tw[k] for k in NAMES], out_hw=(32, 32))
    b = reference_decoder_heads(tp, **tw, out_hw=(32, 32))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)


def test_decoder_weights_layout(folded_pair):
    _, model = folded_pair
    b1, w2, b2, ws, bs, wm, bm = decoder_weights(model)
    assert w2.shape == (64, 64) and ws.shape == (64, 2) and wm.shape == (64, 4)
    assert torch.equal(w2, model.comb_2_layer.weight[:, :, 0, 0, 0].t())
    assert torch.equal(b1, model.comb_1_layer.bias)
