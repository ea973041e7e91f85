"""Port parity of the word-attention pixel-LSTM (``ops/mlstm.py``:
``mlstm_attn_plain``, ``mlstm_attn_bwd_plain``, ``AttnWeightedPixelLSTM``)
against the JAX ``mlstm_attn_scan`` (and ``jax.vjp`` of it) and against the
Pallas kernels B3/B4 in interpret mode, for end-padded and front-padded
masks, pixel counts that are not a multiple of the tile and a row with no
valid step.  Tolerance 1e-5 absolute on acc and on the four gradients,
d_attn included (f32, T <= 6 steps; measured max-abs 6.0e-8 on acc,
1.8e-6 on the gradients).  The CUDA kernels B3 and B4 run only
on the card (``cuda`` marker): B3 is held against ``mlstm_attn_plain`` to
1e-4 max-abs (and a row without a kept step must give exact zeros), B4
against ``mlstm_attn_bwd_plain`` to 1e-4 of each gradient's largest
magnitude, and two B4 launches must agree bit for bit; both take any H,
1028 (past the 1024 that B3 took before it ran on B1's launch sequence)
included.

jax is imported inside the parity tests only, so that the card's test run
(which has no jax, see README) can import this file."""
import numpy as np
import pytest
import torch

from sketchyscenecolorization_torch.ops import mlstm

ATOL = 1e-5
NAMES = ("d_pixel", "d_step", "d_w_h", "d_attn")


def _inputs(n, p, hidden, t, seed=0):
    rng = np.random.RandomState(seed)
    pixel = (rng.randn(n, p, 4 * hidden) * 0.3).astype(np.float32)
    step = (rng.randn(n, t, 4 * hidden) * 0.3).astype(np.float32)
    w_h = (rng.randn(hidden, 4 * hidden) * 0.2).astype(np.float32)
    logits = rng.randn(n, t)
    attn = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return pixel, step, w_h, attn.astype(np.float32)


def _end_pad(lens, t):
    return np.arange(t)[None, :] < np.asarray(lens)[:, None]


CASES = {
    # name: (n, p, hidden, t, valid)
    "end_pad": (2, 40, 12, 5, _end_pad([3, 5], 5)),
    "front_pad": (1, 36, 8, 4, np.array([[0, 0, 4, 9]]) != 0),
    "ragged_p": (2, 23, 10, 6, _end_pad([6, 1], 6)),
    "all_masked_row": (2, 17, 8, 3, _end_pad([0, 3], 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_scan_and_interpret_pallas(case):
    import jax.numpy as jnp
    from sketchyscenecolorization_tpu.ops.pallas_mlstm import (
        mlstm_attn_pallas, mlstm_attn_scan)
    n, p, hidden, t, valid = CASES[case]
    pixel, step, w_h, attn = _inputs(n, p, hidden, t)
    got = mlstm.mlstm_attn_plain(
        *(torch.from_numpy(a) for a in (pixel, step, w_h, valid, attn)))
    assert got.shape == (n, p, hidden)
    args = (jnp.asarray(pixel), jnp.asarray(step), jnp.asarray(w_h),
            jnp.asarray(valid), jnp.asarray(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(mlstm_attn_scan(*args)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(mlstm_attn_pallas(*args, tile_p=16, interpret=True)),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_scan_vjp_and_interpret_pallas(case):
    import jax
    import jax.numpy as jnp
    from sketchyscenecolorization_tpu.ops.pallas_mlstm import (
        mlstm_attn_pallas_bwd, mlstm_attn_scan)
    n, p, hidden, t, valid = CASES[case]
    pixel, step, w_h, attn = _inputs(n, p, hidden, t)
    g = np.random.RandomState(1).randn(n, p, hidden).astype(np.float32)
    got = mlstm.mlstm_attn_bwd_plain(*(torch.from_numpy(a) for a in
                                       (pixel, step, w_h, valid, attn, g)))
    jv = jnp.asarray(valid)
    _, vjp = jax.vjp(lambda a, b, c, d: mlstm_attn_scan(a, b, c, jv, d),
                     jnp.asarray(pixel), jnp.asarray(step), jnp.asarray(w_h),
                     jnp.asarray(attn))
    want_scan = vjp(jnp.asarray(g))
    want_pallas = mlstm_attn_pallas_bwd(
        jnp.asarray(pixel), jnp.asarray(step), jnp.asarray(w_h), jv,
        jnp.asarray(attn), jnp.asarray(g), tile_p=16, interpret=True)
    for name, a, b, c in zip(NAMES, got, want_scan, want_pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=ATOL, err_msg=name)
    if not valid.all():                  # masked steps get no attention grad
        assert (got[3].numpy()[~valid] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_function_matches_autograd_through_plain(case):
    n, p, hidden, t, valid = CASES[case]
    pixel, step, w_h, attn = (torch.from_numpy(a).requires_grad_()
                              for a in _inputs(n, p, hidden, t))
    leaves = [pixel, step, w_h, attn]
    valid = torch.from_numpy(valid)
    g = torch.from_numpy(
        np.random.RandomState(2).randn(n, p, hidden).astype(np.float32))
    want = torch.autograd.grad(
        mlstm.mlstm_attn_plain(pixel, step, w_h, valid, attn), leaves, g)
    before = (mlstm.mlstm_attn_cuda.launches,
              mlstm.mlstm_attn_bwd_cuda.launches)
    out = mlstm.attn_weighted_pixel_lstm(pixel, step, w_h, valid, attn)
    got = torch.autograd.grad(out, leaves, g)
    assert (mlstm.mlstm_attn_cuda.launches,
            mlstm.mlstm_attn_bwd_cuda.launches) == before
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL, msg=name)
    with torch.no_grad():                # serving: nothing kept for backward
        assert not mlstm.attn_weighted_pixel_lstm(
            pixel, step, w_h, valid, attn).requires_grad


def test_attention_gradient_reaches_the_logits():
    """d_attn flows back through the softmax to whatever made the
    attention weights (``attn_fc`` in the model), on the CPU path."""
    pixel, step, w_h, _ = (torch.from_numpy(a) for a in _inputs(1, 9, 4, 3))
    logits = torch.zeros(1, 3, requires_grad=True)
    acc = mlstm.attn_weighted_pixel_lstm(pixel, step, w_h,
                                         torch.ones(1, 3, dtype=torch.int32),
                                         torch.softmax(logits, -1))
    (acc ** 2).sum().backward()
    assert logits.grad is not None and logits.grad.abs().sum() > 0


def test_cpu_tensors_take_the_plain_path_and_cuda_entries_refuse_them():
    args = tuple(torch.from_numpy(a) for a in _inputs(1, 9, 4, 3))
    valid = torch.ones(1, 3, dtype=torch.int32)
    before = mlstm.mlstm_attn_cuda.launches
    torch.testing.assert_close(
        mlstm.attn_weighted_pixel_lstm(*args[:3], valid, args[3]),
        mlstm.mlstm_attn_plain(*args[:3], valid, args[3]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm.mlstm_attn_cuda(*args[:3], valid, args[3])
    with pytest.raises(ValueError, match="CUDA"):
        mlstm.mlstm_attn_bwd_cuda(*args[:3], valid, args[3],
                                  torch.zeros(1, 9, 4))
    assert mlstm.mlstm_attn_cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


SHAPES = [
    # n, p, hidden, t, valid steps per row
    (1, 9216, 500, 15, [7]),          # RMI fusion with word attention
    (2, 37, 100, 7, [7, 0]),          # ragged tile, a row with no valid step
    (3, 5, 8, 6, [2, 6, 1]),          # smaller than one tile
    (2, 37, 250, 7, [7, 3]),          # H not a multiple of 4
    (2, 37, 1028, 5, [5, 2]),         # H past 1024
]


def _cuda_inputs(device, n, p, hidden, t, lens):
    pixel, step, w_h, attn = _inputs(n, p, hidden, t, seed=p)
    g = np.random.RandomState(hidden).randn(n, p, hidden).astype(np.float32)
    args = [torch.from_numpy(a).to(device) for a in (pixel, step, w_h)]
    valid = torch.from_numpy(_end_pad(lens, t)).to(device, torch.int32)
    return args, valid, torch.from_numpy(attn).to(device), \
        torch.from_numpy(g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernels_match_plain_on_cuda(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    args, valid, attn, g = _cuda_inputs(cuda_device, *shape)
    before = mlstm.mlstm_attn_cuda.launches
    got = mlstm.attn_weighted_pixel_lstm(*args, valid, attn)
    torch.cuda.synchronize()
    assert mlstm.mlstm_attn_cuda.launches == before + 1
    torch.testing.assert_close(got, mlstm.mlstm_attn_plain(*args, valid, attn),
                               rtol=0, atol=1e-4)
    empty = (valid == 0).all(1)
    assert not got[empty].any()               # no kept step: exact zeros
    grads = mlstm.mlstm_attn_bwd_cuda(*args, valid, attn, g)
    again = mlstm.mlstm_attn_bwd_cuda(*args, valid, attn, g)
    want = mlstm.mlstm_attn_bwd_plain(*args, valid, attn, g)
    for name, a, b, c in zip(NAMES, grads, again, want):
        assert torch.equal(a, b), name              # bitwise repeatable
        scale = max(float(c.abs().max()), 1e-30)
        assert float((a - c).abs().max()) / scale <= 1e-4, name


@pytest.mark.cuda
def test_autograd_launches_both_kernels_and_feeds_the_logits_on_cuda(
        cuda_device):
    args, valid, attn, g = _cuda_inputs(cuda_device, *SHAPES[1])
    leaves = [a.clone().requires_grad_() for a in args]
    logits = torch.log(attn).clone().requires_grad_()
    fwd, bwd = mlstm.mlstm_attn_cuda.launches, mlstm.mlstm_attn_bwd_cuda.launches
    out = mlstm.attn_weighted_pixel_lstm(*leaves, valid,
                                         torch.softmax(logits, -1))
    got = torch.autograd.grad(out, leaves + [logits], g)
    assert mlstm.mlstm_attn_cuda.launches == fwd + 1
    assert mlstm.mlstm_attn_bwd_cuda.launches == bwd + 1
    assert float(got[3].abs().sum()) > 0
    want = mlstm.mlstm_attn_bwd_plain(*args, valid, attn, g)
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
