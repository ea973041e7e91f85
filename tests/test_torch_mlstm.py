"""Port parity of the masked pixel-LSTM (``sketchyscenecolorization_torch/
ops/mlstm.py``): the plain PyTorch recurrence and its BPTT against the JAX
``mlstm_scan`` (and ``jax.vjp`` of it) and against the Pallas kernels in
interpret mode, for end-padded and front-padded masks, pixel counts that
are not a multiple of the tile and an all-masked row.  Tolerance 1e-5
absolute on h and on the three gradients (f32, T <= 6 steps; measured
max-abs difference 1.2e-7 on h, 4.8e-7 on the gradients).
``MaskedPixelLSTM`` on the CPU is held against autograd through
``mlstm_plain``.  The CUDA kernels themselves run only on the card
(``cuda`` marker): B1 is held against ``mlstm_plain`` to 1e-4, B2 against
``mlstm_bwd_plain`` to 1e-4 of each gradient's largest magnitude, and two
B2 launches must agree bit for bit.  B2 runs its products in 3xTF32 on
the tensor cores; ``tf32_round`` and ``matmul_3xtf32_plain`` repeat that
arithmetic here: TF32 rounding on chosen bit patterns, and the 3xTF32
product at the RMI step shape cut to 256 pixels within 1e-6 of float64
(measured 4.8e-7, as plain f32's 5.5e-7) where one TF32 pass is off by
2.9e-4 of the result's magnitude; the same at the products of B5/B6.  The
kernels take any H by zero padding (to Hp, a multiple of 128, inside):
through the plain versions, the padded problem at H = 250 gives h and acc
exactly with each gate block padded to a multiple of 4 (252) and within
2e-7 at Hp = 256 (the sums run over K = 256 in another order), and every
gradient within 1e-6 of its largest magnitude.

jax is imported inside the parity test only, so that the card's test run
(which has no jax, see README) can import this file."""
import numpy as np
import pytest
import torch

from sketchyscenecolorization_torch.ops import mlstm

ATOL = 1e-5


def _inputs(n, p, hidden, t, seed=0):
    rng = np.random.RandomState(seed)
    pixel = (rng.randn(n, p, 4 * hidden) * 0.3).astype(np.float32)
    step = (rng.randn(n, t, 4 * hidden) * 0.3).astype(np.float32)
    w_h = (rng.randn(hidden, 4 * hidden) * 0.2).astype(np.float32)
    return pixel, step, w_h


def _end_pad(lens, t):
    return np.arange(t)[None, :] < np.asarray(lens)[:, None]


def _front_pad(tokens):
    return np.asarray(tokens) != 0


CASES = {
    # name: (n, p, hidden, t, valid)
    "end_pad": (2, 40, 12, 5, _end_pad([3, 5], 5)),
    "front_pad": (1, 36, 8, 4, _front_pad([[0, 0, 4, 9]])),
    "ragged_p": (2, 23, 10, 6, _end_pad([6, 1], 6)),
    "all_masked_row": (2, 17, 8, 3, _end_pad([0, 3], 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_scan_and_interpret_pallas(case):
    import jax.numpy as jnp
    from sketchyscenecolorization_tpu.ops.pallas_mlstm import (mlstm_pallas,
                                                               mlstm_scan)
    n, p, hidden, t, valid = CASES[case]
    pixel, step, w_h = _inputs(n, p, hidden, t)
    got = mlstm.mlstm_plain(torch.from_numpy(pixel), torch.from_numpy(step),
                            torch.from_numpy(w_h),
                            torch.from_numpy(valid)).numpy()
    args = (jnp.asarray(pixel), jnp.asarray(step), jnp.asarray(w_h),
            jnp.asarray(valid))
    np.testing.assert_allclose(got, np.asarray(mlstm_scan(*args)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(mlstm_pallas(*args, tile_p=16, interpret=True)),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_scan_vjp_and_interpret_pallas(case):
    import jax
    import jax.numpy as jnp
    from sketchyscenecolorization_tpu.ops.pallas_mlstm import (
        mlstm_pallas_bwd, mlstm_scan)
    n, p, hidden, t, valid = CASES[case]
    pixel, step, w_h = _inputs(n, p, hidden, t)
    g = np.random.RandomState(1).randn(n, p, hidden).astype(np.float32)
    got = mlstm.mlstm_bwd_plain(*(torch.from_numpy(a) for a in
                                  (pixel, step, w_h, valid, g)))
    jv = jnp.asarray(valid)
    _, vjp = jax.vjp(lambda a, b, c: mlstm_scan(a, b, c, jv),
                     jnp.asarray(pixel), jnp.asarray(step), jnp.asarray(w_h))
    want_scan = vjp(jnp.asarray(g))
    want_pallas = mlstm_pallas_bwd(jnp.asarray(pixel), jnp.asarray(step),
                                   jnp.asarray(w_h), jv, jnp.asarray(g),
                                   tile_p=16, interpret=True)
    for name, a, b, c in zip(("d_pixel", "d_step", "d_w_h"), got, want_scan,
                             want_pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_function_matches_autograd_through_plain(case):
    n, p, hidden, t, valid = CASES[case]
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in _inputs(n, p, hidden, t)]
    valid = torch.from_numpy(valid)
    g = torch.from_numpy(
        np.random.RandomState(2).randn(n, p, hidden).astype(np.float32))
    want = torch.autograd.grad(mlstm.mlstm_plain(*leaves, valid), leaves, g)
    before = mlstm.mlstm_bwd_cuda.launches
    out = mlstm.masked_pixel_lstm(*leaves, valid)
    got = torch.autograd.grad(out, leaves, g)
    assert mlstm.mlstm_bwd_cuda.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    with torch.no_grad():                # serving: nothing kept for backward
        assert not mlstm.masked_pixel_lstm(*leaves, valid).requires_grad


def test_cpu_tensors_take_the_plain_path_and_cuda_entry_refuses_them():
    pixel, step, w_h = _inputs(1, 9, 4, 3)
    args = (torch.from_numpy(pixel), torch.from_numpy(step),
            torch.from_numpy(w_h), torch.ones(1, 3, dtype=torch.int32))
    before = mlstm.mlstm_cuda.launches
    torch.testing.assert_close(mlstm.masked_pixel_lstm(*args),
                               mlstm.mlstm_plain(*args), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm.mlstm_cuda(*args)
    g = torch.zeros(1, 9, 4)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm.mlstm_bwd_cuda(*args, g)
    assert mlstm.mlstm_cuda.launches == before


@pytest.mark.parametrize("hidden", [8, 100, 500, 512, 1024])
def test_launch_geometry_fits_the_card(hidden):
    """B1's and B3's launch sequence (``fwd_geometry``): H padded to Hp, the
    128x128 stage tile's shared memory, two blocks of it on an SM (plus 1 KB
    each that the card reserves)."""
    hp, smem = mlstm.fwd_geometry(9216, hidden)
    assert hp == mlstm.padded_hidden(hidden)
    assert hp % mlstm.BWD_PAD == 0 and hidden <= hp < hidden + mlstm.BWD_PAD
    assert smem == mlstm.product_smem(*mlstm.BWD_TILES[0]) <= mlstm.SMEM_BYTES
    assert 2 * (smem + 1024) <= 233472


@pytest.mark.parametrize("rows,hidden", [(9216, 500), (144, 512),
                                         (576, 1024), (111, 100), (15, 8),
                                         (2002, 500)])
def test_bwd_geometry_fits_the_card(rows, hidden):
    hp, splits, smem = mlstm.bwd_geometry(rows, hidden)
    assert hp % mlstm.BWD_PAD == 0 and hidden <= hp < hidden + mlstm.BWD_PAD
    # BWD_BLOCKS_PER_SM blocks of each product on an SM (plus 1 KB each that
    # the card reserves)
    assert smem == max(mlstm.product_smem(*t) for t in mlstm.BWD_TILES)
    for tile, blocks in zip(mlstm.BWD_TILES, mlstm.BWD_BLOCKS_PER_SM):
        assert blocks * (mlstm.product_smem(*tile) + 1024) <= 233472
    assert smem <= mlstm.SMEM_BYTES
    assert 1 <= splits <= max(1, min(16, rows // 64))
    tiles = (hp // 128) * (4 * hp // 128)
    assert splits == 1 or splits * tiles <= 2 * mlstm.SMS   # one wave


@pytest.mark.parametrize("rows", [0, 65535 * 64 + 1])
def test_bwd_geometry_refuses_unsupported_rows(rows):
    with pytest.raises(ValueError, match="pixel rows"):
        mlstm.bwd_geometry(rows, 500)


@pytest.mark.parametrize("hidden", [6, 1028])
def test_launch_geometry_refuses_unsupported_hidden(hidden):
    """B1-B4 take any positive H (padded to Hp inside; B3 past 1024 too, since
    it runs on B1's launch sequence) and refuse the negative one."""
    hp = mlstm.padded_hidden(hidden)
    assert hp % mlstm.BWD_PAD == 0 and hidden <= hp < hidden + mlstm.BWD_PAD
    assert mlstm.fwd_geometry(64, hidden)[0] == hp
    assert mlstm.bwd_geometry(64, hidden)[0] == hp
    for geometry in (mlstm.fwd_geometry, mlstm.bwd_geometry):
        with pytest.raises(ValueError, match="must be positive"):
            geometry(64, -hidden)


def pad_gates(x: torch.Tensor, hidden: int, width: int) -> torch.Tensor:
    """[..., 4*hidden] -> [..., 4*width]: each of the four gate blocks
    zero-padded from ``hidden`` to ``width`` columns, as the kernels pad the
    gate columns of their weights."""
    blocks = x.reshape(*x.shape[:-1], 4, hidden)
    return torch.nn.functional.pad(blocks, (0, width - hidden)).reshape(
        *x.shape[:-1], 4 * width)


def pad_w_h(w_h: torch.Tensor, width: int) -> torch.Tensor:
    """W_h [H, 4H] -> [width, 4*width]: zero rows and zero gate columns for
    the padded units."""
    hidden = w_h.shape[0]
    return pad_gates(torch.nn.functional.pad(w_h, (0, 0, 0, width - hidden)),
                     hidden, width)


def _unpad_gates(x, hidden):
    """[..., 4*width] -> [..., 4*hidden]: the first ``hidden`` columns of
    each gate block (the inverse of ``pad_gates``)."""
    width = x.shape[-1] // 4
    return x.reshape(*x.shape[:-1], 4, width)[..., :hidden].reshape(
        *x.shape[:-1], 4 * hidden)


def _padded(pixel, step, w_h, width):
    return (pad_gates(pixel, pixel.shape[-1] // 4, width),
            pad_gates(step, step.shape[-1] // 4, width), pad_w_h(w_h, width))


@pytest.mark.parametrize("width", [252, 256])
@pytest.mark.parametrize("variant", ["plain", "attn"])
def test_zero_padding_to_any_width_is_exact(variant, width):
    """The padding of C1 through the plain versions at H = 250: each gate
    block to a multiple of 4 (252) and to the kernels' Hp (256)."""
    hidden, t = 250, 5
    pixel, step, w_h = (torch.from_numpy(a)
                        for a in _inputs(2, 12, hidden, t, seed=3))
    w_h = w_h / 4                           # glorot-like scale at H = 250
    valid = torch.from_numpy(_front_pad([[0, 0, 3, 4, 5], [1, 2, 0, 0, 0]]))
    g = torch.from_numpy(np.random.RandomState(4).randn(2, 12, hidden)
                         .astype(np.float32))
    attn = torch.softmax(torch.from_numpy(
        np.random.RandomState(5).randn(2, t).astype(np.float32)), -1)
    extra = () if variant == "plain" else (attn,)
    fwd, bwd = ((mlstm.mlstm_plain, mlstm.mlstm_bwd_plain)
                if variant == "plain" else
                (mlstm.mlstm_attn_plain, mlstm.mlstm_attn_bwd_plain))
    padded = _padded(pixel, step, w_h, width)
    got = fwd(*padded, valid, *extra)
    assert not got[..., hidden:].any()      # padded units stay 0
    want = fwd(pixel, step, w_h, valid, *extra)
    torch.testing.assert_close(got[..., :hidden], want, rtol=0,
                               atol=0 if width == 252 else 2e-7)
    grads = bwd(*padded, valid, *extra,
                torch.nn.functional.pad(g, (0, width - hidden)))
    grads = (_unpad_gates(grads[0], hidden), _unpad_gates(grads[1], hidden),
             _unpad_gates(grads[2][:hidden], hidden)) + grads[3:]
    for name, a, b in zip(("d_pixel", "d_step", "d_w_h", "d_attn"), grads,
                          bwd(pixel, step, w_h, valid, *extra, g)):
        assert a.shape == b.shape, name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * scale, name


TF32_CASES = [
    # f32 bits in, TF32 bits out (round to nearest, ties away from zero)
    (0x3F800000, 0x3F800000),    # 1.0 is exact
    (0x3F800FFF, 0x3F800000),    # just under half an ulp: down
    (0x3F801000, 0x3F802000),    # 1 + 2^-11, a tie: away (even would stay)
    (0xBF801000, 0xBF802000),    # its negative: away from zero
    (0x3F805000, 0x3F806000),    # a tie whose even neighbour is below
    (0x3F801001, 0x3F802000),    # just over half an ulp: up
    (0x3FFFF000, 0x40000000),    # the carry reaches the exponent
    (0x7F7FF000, 0x7F800000),    # past the largest TF32: inf
    (0x00001000, 0x00002000),    # a subnormal tie
    (0x80000000, 0x80000000),    # -0
    (0xFF800000, 0xFF800000),    # -inf passes through
]


@pytest.mark.parametrize("bits,want", TF32_CASES,
                         ids=[f"{b:08x}" for b, _ in TF32_CASES])
def test_tf32_round_is_nearest_ties_away_to_10_bits(bits, want):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32)
    got = mlstm.tf32_round(x.view(torch.float32)).view(torch.int32)
    assert int(got) & 0xFFFFFFFF == want
    assert int(got) & 0x1FFF == 0


def test_tf32_round_keeps_nan():
    assert torch.isnan(mlstm.tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("product", ["forward", "sweep", "recur_sweep",
                                     "recur_proj", "recur_gates"])
def test_3xtf32_product_keeps_f32_accuracy(product):
    """The kernels' products in 3xTF32 with P cut to 256: B1-B4's at the RMI
    step shape (h [256, 500] @ W_h [500, 2000]; dgates [256, 2000] @
    W_h^T) and B5/B6's at the RecurAttn shape padded to Hp = 256 (dgates
    [256, 1024] @ Wm^T [1024, 512]; h [256, 256] @ Wp, K = 256; F3's [x, h]
    [256, 512] @ Wm [512, 1024], K = 2Hp, their largest): within 1e-6 of
    the float64 product's largest magnitude, where a single TF32 pass is off
    by more than 1e-4 of it.  This is why the kernels hold BWD_TOL = 1e-4
    against the f32 plain versions."""
    rng = np.random.RandomState(5)
    w_h = rng.randn(500, 2000) * 0.05
    if product == "forward":
        a, b = rng.uniform(-1, 1, (256, 500)), w_h
    elif product == "sweep":
        a, b = rng.randn(256, 2000) * 0.1, w_h.T
    elif product == "recur_sweep":
        a, b = rng.randn(256, 1024) * 0.1, rng.randn(1024, 512) * 0.25 / 16
    elif product == "recur_proj":
        a, b = rng.uniform(-1, 1, (256, 256)), rng.randn(256, 256) / 16
    else:
        a, b = rng.uniform(-1, 1, (256, 512)), rng.randn(512, 1024) / 16
    a32, b32 = (torch.from_numpy(x.astype(np.float32)) for x in (a, b))
    want = a32.double() @ b32.double()
    scale = float(want.abs().max())
    err3 = float((mlstm.matmul_3xtf32_plain(a32, b32).double()
                  - want).abs().max()) / scale
    err1 = float(((mlstm.tf32_round(a32) @ mlstm.tf32_round(b32)).double()
                  - want).abs().max()) / scale
    assert err3 <= 1e-6, err3
    assert err1 > 1e-4, err1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,hidden,t,front", [
    (1, 9216, 500, 15, False),     # RMI fusion
    (3, 36, 512, 15, True),        # FG text fusion
    (1, 576, 1024, 8, True),       # BG text fusion
    (2, 37, 100, 7, False),        # ragged tile, H not a multiple of 32
    (3, 5, 8, 6, True),            # smaller than one tile
    (2, 37, 250, 7, False),        # H not a multiple of 4 (model_scale 0.5)
])
def test_kernel_matches_plain_on_cuda(cuda_device, n, p, hidden, t, front):
    pixel, step, w_h = _inputs(n, p, hidden, t, seed=p)
    lens = np.random.RandomState(t).randint(0, t + 1, size=n)
    valid = _end_pad(lens, t)
    if front:
        valid = valid[:, ::-1].copy()
    args = [torch.from_numpy(a).to(cuda_device) for a in (pixel, step, w_h)]
    valid_t = torch.from_numpy(valid).to(cuda_device)
    before = mlstm.mlstm_cuda.launches
    got = mlstm.masked_pixel_lstm(*args, valid_t)
    torch.cuda.synchronize()
    assert mlstm.mlstm_cuda.launches == before + 1
    want = mlstm.mlstm_plain(*args, valid_t)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


BWD_SHAPES = [
    # n, p, hidden, t, valid steps per row, front-padded
    (1, 9216, 500, 15, [7], False),         # RMI fusion
    (4, 36, 512, 15, [4, 4, 4, 4], True),   # FG text fusion
    (1, 576, 1024, 8, [5], True),           # BG text fusion
    (3, 37, 100, 7, [7, 0, 3], False),      # ragged tile, an all-masked row
    (3, 5, 8, 6, [3, 6, 0], True),          # smaller than one tile
    (2, 37, 250, 7, [7, 3], False),         # H not a multiple of 4
]


def _bwd_inputs(device, n, p, hidden, t, lens, front):
    pixel, step, w_h = _inputs(n, p, hidden, t, seed=p)
    g = np.random.RandomState(hidden).randn(n, p, hidden).astype(np.float32)
    valid = _end_pad(lens, t)
    if front:
        valid = valid[:, ::-1]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (pixel, step, w_h)]
    valid_t = torch.from_numpy(np.ascontiguousarray(valid)).to(device)
    return args, valid_t.to(torch.int32), torch.from_numpy(g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_bwd_kernel_matches_plain_on_cuda(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    args, valid, g = _bwd_inputs(cuda_device, *shape)
    before = mlstm.mlstm_bwd_cuda.launches
    got = mlstm.mlstm_bwd_cuda(*args, valid, g)
    again = mlstm.mlstm_bwd_cuda(*args, valid, g)
    torch.cuda.synchronize()
    assert mlstm.mlstm_bwd_cuda.launches == before + 2
    want = mlstm.mlstm_bwd_plain(*args, valid, g)
    for name, a, b, c in zip(("d_pixel", "d_step", "d_w_h"), got, again,
                             want):
        assert torch.equal(a, b), name              # bitwise repeatable
        scale = max(float(c.abs().max()), 1e-30)
        assert float((a - c).abs().max()) / scale <= 1e-4, name


@pytest.mark.cuda
def test_autograd_function_launches_both_kernels_on_cuda(cuda_device):
    args, valid, g = _bwd_inputs(cuda_device, *BWD_SHAPES[3])
    leaves = [a.clone().requires_grad_() for a in args]
    fwd, bwd = mlstm.mlstm_cuda.launches, mlstm.mlstm_bwd_cuda.launches
    got = torch.autograd.grad(mlstm.masked_pixel_lstm(*leaves, valid),
                              leaves, g)
    assert mlstm.mlstm_cuda.launches == fwd + 1
    assert mlstm.mlstm_bwd_cuda.launches == bwd + 1
    for a, b in zip(got, mlstm.mlstm_bwd_plain(*args, valid, g)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
