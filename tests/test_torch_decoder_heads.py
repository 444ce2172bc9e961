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
    tile_plan,
    x_plan,
)
from echoflow_torch.ops.resize import _linear_resize_matrix_np
from echoflow_torch.utils.profiling import counters

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
    before = counters().get("decoder_heads.launches", 0)
    got = decoder_heads(tp, **tw, out_hw=(32, 32))
    want = reference_decoder_heads(tp, **tw, out_hw=(32, 32))
    # nothing launched on the CPU
    assert counters().get("decoder_heads.launches", 0) == before
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
    """The corner tables' per-pixel recipe, written out in torch: four
    corner reads per source (rows first, then columns), bias and ReLU,
    comb2 one output channel at a time folded into the heads."""
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
        "from echoflow_torch.utils.profiling import counters\n"
        "assert not _build._libs and 'decoder_heads.launches' not in counters()\n"
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


def _tf32(x):
    """cvt.rna.tf32.f32 on the int32 bits: round the low 13 mantissa bits
    to nearest, ties away from zero (bit patterns are sign and magnitude)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _three_pass(y, w2):
    """comb2 as the kernel computes it: lo*W2hi + hi*W2lo + hi*W2hi, each
    product of TF32 values exact in fp32, accumulated in fp32."""
    y_hi, w_hi = _tf32(y), _tf32(w2)
    y_lo, w_lo = _tf32(y - y_hi), _tf32(w2 - w_hi)
    return y_lo @ w_hi + y_hi @ w_lo + y_hi @ w_hi


# A column budget for `tile_plan` (the kernel's comes from its library,
# `echoflow_decoder_heads_column_budget`); the main path's tiles need 56.
COLUMN_BUDGET = 100


def _kernel_recipe(projs, w, out_hw, align_corners=True):
    """The CUDA kernel's arithmetic in torch: each output row cut into
    `tile_plan`'s tiles; per tile, stage 1 blends every source column the
    tile touches over the row's two source rows into a column buffer laid
    out by `x_plan`; stage 2 blends each pixel's two columns per source
    (rows first, then columns, the tables' float32 weights); +b1, ReLU;
    comb2 as three TF32 passes; +b2, ReLU; the heads."""
    h_out, w_out = out_hw
    bsz, t, c = projs[0].shape[0], projs[0].shape[1], projs[0].shape[-1]
    ys = [_axis_table(p.shape[2], h_out, align_corners) for p in projs]
    xs = [_axis_table(p.shape[3], w_out, align_corners) for p in projs]
    tile_w, cols = tile_plan([idx for idx, _ in xs], w_out, COLUMN_BUDGET)
    plan = torch.from_numpy(x_plan(xs, w_out, tile_w, cols))
    seg = torch.zeros(bsz, t, h_out, w_out, 2)
    mot = torch.zeros(bsz, t, h_out, w_out, 4)
    for y in range(h_out):
        for tc, x0 in enumerate(range(0, w_out, tile_w)):
            n_x = min(tile_w, w_out - x0)
            buf = torch.zeros(bsz, t, sum(cols), c)
            acc = torch.zeros(bsz, t, n_x, c)
            for r, p in enumerate(projs):
                (ylo, yhi), (wy_lo, wy_hi) = ys[r][0][y], ys[r][1][y]
                first, n, at = (int(v) for v in plan[tc, r, 0, :3])
                buf[:, :, at:at + n] = (float(wy_lo) * p[:, :, ylo, first:first + n]
                                        + float(wy_hi) * p[:, :, yhi, first:first + n])
                e = plan[tc, r, 1:1 + n_x]
                wts = e[:, 2:].contiguous().view(torch.float32)
                acc = (acc + wts[:, 0, None] * buf[:, :, e[:, 0]]
                       + wts[:, 1, None] * buf[:, :, e[:, 1]])
            z = torch.relu(_three_pass(torch.relu(acc + w["b1"]), w["w2"]) + w["b2"])
            seg[:, :, y, x0:x0 + n_x] = z @ w["ws"] + w["bs"]
            mot[:, :, y, x0:x0 + n_x] = torch.tanh(z @ w["wm"] + w["bm"])
    return seg, mot


@pytest.mark.parametrize("specs,out_hw,align_corners", [
    (SPECS[0], (32, 32), True), (SPECS[1], (32, 32), True),
    (SPECS[1], (20, 30), False),   # 600 pixels: not a multiple of 64
])
def test_kernel_tiled_recipe_matches_plain(specs, out_hw, align_corners):
    projs, w = _inputs(5, specs)
    tp, tw = _torch(projs, w)
    seg, mot = _kernel_recipe(tp, tw, out_hw, align_corners)
    rseg, rmot = reference_decoder_heads(tp, **tw, out_hw=out_hw, align_corners=align_corners)
    np.testing.assert_allclose(seg.numpy(), rseg.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mot.numpy(), rmot.numpy(), rtol=1e-5, atol=1e-5)


def test_x_plan_points_at_the_tables_columns():
    """Each pixel's two places in the column buffer are its table columns,
    counted from the tile's first column, after the earlier sources'; a
    tile's columns fit the budget (500 source columns onto 7 pixels halve
    the tile to 2 pixels); entries past a tile's pixels are 0."""
    for w_out, sizes in ((112, (56, 28, 14, 7)), (36, (20, 10, 5, 3)), (7, (500,))):
        xs = [_axis_table(s, w_out, True) for s in sizes]
        tile_w, cols = tile_plan([idx for idx, _ in xs], w_out, COLUMN_BUDGET)
        plan = x_plan(xs, w_out, tile_w, cols)
        assert 1 <= tile_w <= 64 and plan.shape == (-(-w_out // tile_w), len(sizes), 65, 4)
        assert sum(cols) <= COLUMN_BUDGET and tile_w == {112: 56, 36: 36, 7: 2}[w_out]
        for tc, x0 in enumerate(range(0, w_out, tile_w)):
            n_x = min(tile_w, w_out - x0)
            for r, (idx, wts) in enumerate(xs):
                first, n, at = plan[tc, r, 0, :3]
                assert at == sum(cols[:r]) and n <= cols[r]
                np.testing.assert_array_equal(plan[tc, r, 1:1 + n_x, :2] - at + first,
                                              idx[x0:x0 + n_x])
                assert not plan[tc, r, 1 + n_x:].any()
                np.testing.assert_array_equal(plan[tc, r, 1:1 + n_x, 2:].view(np.float32),
                                              wts[x0:x0 + n_x])


def test_three_tf32_passes_keep_fp32_accuracy():
    """Why comb2 takes three TF32 passes: at the main path's magnitudes
    (y = ReLU of upsampled 0.2-scale projections, W2 at 0.3 scale) the
    three-pass product is within 2e-6 (relative to the largest entry) of
    the float64 product, measured 3.1e-7; one TF32 pass, what the tensor
    cores give for raw fp32 operands, is off by 5.2e-4, some 1,700 times
    more."""
    rng = np.random.RandomState(0)
    y = torch.relu(torch.from_numpy((rng.randn(4096, 64) * 0.4).astype(np.float32)))
    w2 = torch.from_numpy((rng.randn(64, 64) * 0.3).astype(np.float32))
    exact = y.double() @ w2.double()
    scale = float(exact.abs().max())
    three = float((_three_pass(y, w2).double() - exact).abs().max()) / scale
    one = float(((_tf32(y) @ _tf32(w2)).double() - exact).abs().max()) / scale
    assert three <= 2e-6
    assert one >= 10 * three
