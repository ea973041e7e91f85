"""Port parity of the RecurAttn pixel-LSTM (``ops/recur_attn.py``:
``recur_attn_plain``, ``recur_attn_bwd_plain``, ``RecurAttnPixelLSTM``)
against the JAX ``recur_attn_scan`` (and ``jax.vjp`` of it) and against the
Pallas kernels B5/B6 in interpret mode, for end-padded, front-padded and
mid-sequence-padded masks (RecurAttn masks by ``words != 0`` and skips a pad
wherever it falls), pixel counts that are not a multiple of the tile and a
row with no valid step, and T = 20 (past the 16 steps the kernels took
before).  Tolerance 1e-5 absolute on h and on the six gradients (f32;
measured max-abs 8.9e-8 on h, 1.9e-6 on the gradients at T <= 6).  B5 and
B6 pad H to Hp inside (zero rows and columns, Wm's gate blocks padded one
by one): through the plain versions the padded problem at H = 250 gives h
within 2e-7 and every gradient within 1e-6 of its largest magnitude.  The
CUDA kernels B5 and B6 run only on the card (``cuda`` marker): B5 is held
against ``recur_attn_plain`` to 1e-4 max-abs (also at H = 250, at its T
limit and with a row without a kept step, whose output must be h0 bit for
bit), B6 against ``recur_attn_bwd_plain`` to 1e-4 of each gradient's
largest magnitude, and two B6 launches must agree bit for bit.

jax is imported inside the parity tests only, so that the card's test run
(which has no jax, see README) can import this file."""
import numpy as np
import pytest
import torch

from sketchyscenecolorization_torch.ops import recur_attn
from sketchyscenecolorization_torch.ops.mlstm import SMEM_BYTES
from test_torch_mlstm import pad_gates

ATOL = 1e-5
NAMES = ("d_h0", "d_lang", "d_wp", "d_bp", "d_wm", "d_bm")


def _inputs(n, p, hidden, w, t, seed=0):
    """``tests/test_pallas_mlstm.py:_recur_attn_inputs`` as NumPy."""
    rng = np.random.RandomState(seed)
    return tuple(a.astype(np.float32) for a in (
        rng.randn(n, p, hidden) * 0.3, rng.randn(n, t, w) * 0.3,
        rng.randn(hidden, w) * 0.2, rng.randn(w) * 0.1,
        rng.randn(w + hidden, 4 * hidden) * 0.2, rng.randn(4 * hidden) * 0.1))


CASES = {
    # name: (n, p, hidden, w, t, valid)
    "end_pad": (2, 40, 12, 10, 5, np.array([[1] * 5, [1, 1, 1, 0, 0]]) != 0),
    "front_pad": (2, 40, 12, 10, 5, np.array([[0, 0, 1, 1, 1]] * 2) != 0),
    "mid_pad": (1, 24, 8, 6, 6, np.array([[3, 0, 5, 2, 0, 0]]) != 0),
    "ragged_p": (2, 23, 8, 8, 4, np.array([[1, 1, 1, 1], [1, 0, 0, 0]]) != 0),
    "all_masked_row": (2, 17, 8, 6, 3, np.array([[0, 0, 0], [1, 1, 1]]) != 0),
    "t20": (2, 9, 8, 8, 20, np.array([[1] * 12 + [0] * 8,
                                      [0, 1, 1, 0, 1] + [0] * 15]) != 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_scan_and_interpret_pallas(case):
    import jax.numpy as jnp
    from sketchyscenecolorization_tpu.ops.pallas_mlstm import (
        recur_attn_pallas, recur_attn_scan)
    n, p, hidden, w, t, valid = CASES[case]
    args = _inputs(n, p, hidden, w, t)
    got = recur_attn.recur_attn_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(valid))
    assert got.shape == (n, p, hidden)
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(valid)]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(recur_attn_scan(*jargs)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(recur_attn_pallas(*jargs, tile_p=16, interpret=True)),
        rtol=0, atol=ATOL)
    if not valid[0].any():               # no valid step: h stays at h0
        np.testing.assert_array_equal(got.numpy()[0], args[0][0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_scan_vjp_and_interpret_pallas(case):
    import jax
    import jax.numpy as jnp
    from sketchyscenecolorization_tpu.ops.pallas_mlstm import (
        recur_attn_pallas_bwd, recur_attn_scan)
    n, p, hidden, w, t, valid = CASES[case]
    args = _inputs(n, p, hidden, w, t)
    g = np.random.RandomState(1).randn(n, p, hidden).astype(np.float32)
    got = recur_attn.recur_attn_bwd_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(valid),
        torch.from_numpy(g))
    jv = jnp.asarray(valid)
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda *a: recur_attn_scan(*a, jv), *jargs)
    want_scan = vjp(jnp.asarray(g))
    want_pallas = recur_attn_pallas_bwd(*jargs, jv, jnp.asarray(g),
                                        tile_p=16, interpret=True)
    for name, a, b, c in zip(NAMES, got, want_scan, want_pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_function_matches_autograd_through_plain(case):
    n, p, hidden, w, t, valid = CASES[case]
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in _inputs(n, p, hidden, w, t)]
    valid = torch.from_numpy(valid)
    g = torch.from_numpy(
        np.random.RandomState(2).randn(n, p, hidden).astype(np.float32))
    want = torch.autograd.grad(recur_attn.recur_attn_plain(*leaves, valid),
                               leaves, g)
    before = (recur_attn.recur_attn_cuda.launches,
              recur_attn.recur_attn_bwd_cuda.launches)
    got = torch.autograd.grad(
        recur_attn.recur_attn_pixel_lstm(*leaves, valid), leaves, g)
    assert (recur_attn.recur_attn_cuda.launches,
            recur_attn.recur_attn_bwd_cuda.launches) == before
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL, msg=name)
    with torch.no_grad():                # serving: nothing kept for backward
        assert not recur_attn.recur_attn_pixel_lstm(*leaves,
                                                    valid).requires_grad


def test_cpu_tensors_take_the_plain_path_and_cuda_entries_refuse_them():
    args = tuple(torch.from_numpy(a) for a in _inputs(1, 9, 64, 64, 3))
    valid = torch.ones(1, 3, dtype=torch.int32)
    before = recur_attn.recur_attn_cuda.launches
    torch.testing.assert_close(recur_attn.recur_attn_pixel_lstm(*args, valid),
                               recur_attn.recur_attn_plain(*args, valid),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        recur_attn.recur_attn_cuda(*args, valid)
    with pytest.raises(ValueError, match="CUDA"):
        recur_attn.recur_attn_bwd_cuda(*args, valid, torch.zeros(1, 9, 64))
    assert recur_attn.recur_attn_cuda.launches == before


@pytest.mark.parametrize("hidden,t", [(64, 5), (256, 15), (256, 16),
                                      (512, 15)])
def test_geometry_fits_the_card(hidden, t):
    hp, smem = recur_attn.recur_geometry(9216, hidden, t)
    assert hp % 128 == 0 and hidden <= hp < hidden + 128
    assert smem == 4 * (t * hp + recur_attn.SOFTMAX_WARPS * (hp + t))
    assert smem <= SMEM_BYTES
    hp, split_wm, split_wp, rows, chunks, bwd = recur_attn.recur_bwd_geometry(
        9216, hidden, t)
    assert hp % 128 == 0 and hidden <= hp < hidden + 128
    assert rows == 32 and bwd <= SMEM_BYTES
    assert 1 <= split_wm <= 16 and 1 <= split_wp <= 32
    assert 1 <= chunks <= recur_attn.COL_CHUNKS


@pytest.mark.parametrize("hidden,t", [(96, 5), (1024, 5), (256, 17)])
def test_geometry_refuses_what_the_kernels_do_not_take(hidden, t):
    """B5 and B6 take any H (padded to Hp inside; B5 took only multiples of
    64 up to 512 before it ran on B6's kernels) and any T whose shared
    memory fits, and refuse a non-positive H or T and more pixel rows than
    their grids hold."""
    hp = -(-hidden // 128) * 128
    assert recur_attn.recur_geometry(74, hidden, t)[0] == hp
    assert recur_attn.recur_bwd_geometry(74, hidden, t)[0] == hp
    for geometry in (recur_attn.recur_geometry,
                     recur_attn.recur_bwd_geometry):
        for bad in ((74, -hidden, t), (74, hidden, 0)):
            with pytest.raises(ValueError, match="must be positive"):
                geometry(*bad)
        with pytest.raises(ValueError, match="pixel rows"):
            geometry(65535 * 64 + 1, hidden, t)


@pytest.mark.parametrize("kernel,hidden,t_max", [("fwd", 256, 212),
                                                 ("fwd", 512, 103),
                                                 ("bwd", 256, 198)])
def test_geometry_states_the_t_limit(kernel, hidden, t_max):
    """The longest sequence each kernel takes, set by lang[n] in shared
    memory (B5 beside F2's 8 warps' rows, B6 at its fewest, 8, attention
    rows a block)."""
    if kernel == "fwd":
        recur_attn.recur_geometry(9216, hidden, t_max)
        with pytest.raises(ValueError, match=f"1..{t_max} "):
            recur_attn.recur_geometry(9216, hidden, t_max + 1)
    else:
        assert recur_attn.recur_bwd_geometry(9216, hidden, t_max)[3] == 8
        with pytest.raises(ValueError, match=f"1..{t_max} "):
            recur_attn.recur_bwd_geometry(9216, hidden, t_max + 1)


def test_zero_padding_to_hp_is_exact():
    """B5's and B6's padding through the plain versions at H = w = 250: h0,
    lang, Wp and bp zero-padded to Hp = 256, Wm's x rows and h rows each
    padded to Hp and its gate blocks one by one (``pad_gates``), bm
    likewise."""
    hidden, hp, t = 250, 256, 5
    h0, lang, wp, bp, wm, bm = (torch.from_numpy(a) for a in _inputs(
        2, 9, hidden, hidden, t, seed=7))
    wp, wm = wp / 4, wm / 4                 # glorot-like scale at H = 250
    valid = torch.from_numpy(np.array([[1, 1, 0, 1, 0], [0, 0, 1, 1, 1]]))
    g = torch.from_numpy(np.random.RandomState(8).randn(2, 9, hidden)
                         .astype(np.float32))
    pad = hp - hidden

    def cols(x):
        return torch.nn.functional.pad(x, (0, pad))
    wm_p = torch.cat([torch.nn.functional.pad(pad_gates(part, hidden, hp),
                                              (0, 0, 0, pad))
                      for part in (wm[:hidden], wm[hidden:])])
    padded = (cols(h0), cols(lang),
              torch.nn.functional.pad(wp, (0, pad, 0, pad)), cols(bp), wm_p,
              pad_gates(bm, hidden, hp))
    got = recur_attn.recur_attn_plain(*padded, valid)
    assert not got[..., hidden:].any()      # padded units stay 0
    torch.testing.assert_close(
        got[..., :hidden],
        recur_attn.recur_attn_plain(h0, lang, wp, bp, wm, bm, valid),
        rtol=0, atol=2e-7)
    grads = recur_attn.recur_attn_bwd_plain(*padded, valid, cols(g))
    keep = torch.cat([torch.arange(hidden), hp + torch.arange(hidden)])
    grads = (grads[0][..., :hidden], grads[1][..., :hidden],
             grads[2][:hidden, :hidden], grads[3][:hidden],
             grads[4][keep].reshape(2 * hidden, 4, hp)[..., :hidden]
             .reshape(2 * hidden, 4 * hidden),
             grads[5].reshape(4, hp)[:, :hidden].reshape(-1))
    want = recur_attn.recur_attn_bwd_plain(h0, lang, wp, bp, wm, bm, valid, g)
    for name, a, b in zip(NAMES, grads, want):
        assert a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


SHAPES = [
    # n, p, hidden, t, valid rows
    (1, 9216, 256, 15, [[1] * 7 + [0] * 8]),            # RecurAttn fusion
    (2, 37, 256, 6, [[2, 0, 4, 1, 0, 0], [0] * 6]),      # ragged, mid pad
    (2, 40, 64, 5, [[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]]),  # H=64, front pad
    (2, 37, 256, 20, [[1] * 12 + [0] * 8, [0, 1, 1, 0, 1] + [0] * 15]),  # T=20
]


def _cuda_inputs(device, n, p, hidden, t, rows):
    """Weights scaled to the model's glorot range at width H (the scales of
    ``_inputs`` suit H ~ 10: at H = 256 they make the gradients grow 10x per
    step, and float32 rounding with them)."""
    h0, lang, wp, bp, wm, bm = _inputs(n, p, hidden, hidden, t, seed=p)
    scale = np.float32(4.0 / np.sqrt(hidden))
    args = (h0, lang, wp * scale, bp, wm * scale, bm)
    g = np.random.RandomState(hidden).randn(n, p, hidden).astype(np.float32)
    valid = torch.tensor(rows, dtype=torch.int32, device=device) != 0
    return [torch.from_numpy(a).to(device) for a in args], \
        valid.to(torch.int32), torch.from_numpy(g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernels_match_plain_on_cuda(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    args, valid, g = _cuda_inputs(cuda_device, *shape)
    before = recur_attn.recur_attn_cuda.launches
    got = recur_attn.recur_attn_pixel_lstm(*args, valid)
    torch.cuda.synchronize()
    assert recur_attn.recur_attn_cuda.launches == before + 1
    torch.testing.assert_close(got, recur_attn.recur_attn_plain(*args, valid),
                               rtol=0, atol=1e-4)
    grads = recur_attn.recur_attn_bwd_cuda(*args, valid, g)
    again = recur_attn.recur_attn_bwd_cuda(*args, valid, g)
    want = recur_attn.recur_attn_bwd_plain(*args, valid, g)
    for name, a, b, c in zip(NAMES, grads, again, want):
        assert torch.equal(a, b), name              # bitwise repeatable
        scale = max(float(c.abs().max()), 1e-30)
        assert float((a - c).abs().max()) / scale <= 1e-4, name


@pytest.mark.cuda
def test_autograd_launches_both_kernels_on_cuda(cuda_device):
    args, valid, g = _cuda_inputs(cuda_device, *SHAPES[1])
    leaves = [a.clone().requires_grad_() for a in args]
    fwd = recur_attn.recur_attn_cuda.launches
    bwd = recur_attn.recur_attn_bwd_cuda.launches
    got = torch.autograd.grad(recur_attn.recur_attn_pixel_lstm(*leaves, valid),
                              leaves, g)
    assert recur_attn.recur_attn_cuda.launches == fwd + 1
    assert recur_attn.recur_attn_bwd_cuda.launches == bwd + 1
    for a, b in zip(got, recur_attn.recur_attn_bwd_plain(*args, valid, g)):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


FWD_SHAPES = [
    # n, p, hidden, t, valid rows
    (2, 37, 250, 6, [[1, 1, 0, 1, 1, 1], [1, 1, 1, 0, 0, 0]]),   # H = 250
    (1, 40, 256, 212, [[1] * 9 + [0] * 203]),                    # T limit
    (3, 37, 256, 5, [[1, 1, 1, 0, 0], [0] * 5, [0, 1, 0, 1, 0]]),  # no step
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
def test_forward_kernel_takes_any_h_its_t_limit_and_empty_rows_on_cuda(
        cuda_device, shape):
    """B5 alone (B6's T limit is lower): within 1e-4 max-abs of
    ``recur_attn_plain``, and h0 bit for bit where a row has no kept step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, valid, _ = _cuda_inputs(cuda_device, *shape)
    got = recur_attn.recur_attn_cuda(*args, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, recur_attn.recur_attn_plain(*args, valid),
                               rtol=0, atol=1e-4)
    empty = (valid == 0).all(1)
    assert torch.equal(got[empty], args[0][empty])
