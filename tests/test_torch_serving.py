"""The port's serving layer (``sketchyscenecolorization_torch/pipeline/``:
``device_compositing.py``, the serving paths of ``session.py`` and
``engines.py``) on the synthetic fixtures of ``tests/test_pipeline.py``.

One module-scoped pair of sessions at ``small_config`` (the default
``PipelineConfig``: device compositing, compact fetch, device gradient):
the JAX session and the port's session on the CPU, with the JAX weights
bridged into the port and the JAX engine's noise stream fed to its FG
engine.  The tests run on ``clone``s of them.

- The port's ``DeviceCompositor`` against JAX's and the host chain on the
  same canvas and generator bytes, and ``sky_detect_trace`` against the
  host ``detect_sky`` and JAX's: exact (tolerance 0, measured 0).
- A mirror of each equivalence test of ``tests/test_pipeline_serving.py``
  but the three serving-data-parallel ones, port against
  port: byte-equal (tolerance 0, measured 0), but for stream against
  sequential commands, which differ by the generator's bucket-size
  reduction order (the JAX session's caveat): within 1 uint8 LSB on under
  1% of values, records byte-equal (measured 0 here).  The
  random-weight matcher matches nothing on this fixture, so the mirrors
  that need the generator to run route the instructions to fixed instances
  (``routed``), as JAX's serving-DP session test does.
- The JAX default-config session against the port's on a mixed
  ``colorize_stream`` queue, gradient off: records byte-equal, matched
  sets equal, canvases within 1 LSB (measured 1), FG results byte-equal
  outside the matched instances' inner masks where their bases agree, BG
  results byte-equal inside the inner masks and on the drawings.
- The PNG encoder (``pipeline/io.py``) at 1 to 8 row bands, levels 0
  and 1: PIL decodes the pixels, the joined IDAT inflates to the filtered
  rows (so the combined Adler-32 holds), every chunk's CRC holds, and one
  band is the plain ``zlib.compressobj`` stream byte for byte; more
  callers than CPUs share the pool, and a forked child encodes in bands
  on a pool of its own.
- ``match_instances_host`` against ``match_instances``, and the stage
  trace's labels.
- Serving data parallelism (``tests/test_pipeline_serving.py:646-770``):
  ``serve_devices_for``'s wiring and fallback; the FG engine with
  ``serve_devices=[cpu] * 4`` against the single-device engine (the noise
  stream bit-equal, small buckets byte-equal) and against JAX's engine on
  its 4-device mesh on JAX's noise (within 1 LSB on under 1% of values;
  measured, printed); a session whose engine splits over four devices
  against JAX's DP session and the port's default one, gradient off
  (records byte-equal, canvases within 1 LSB; measured, printed).
"""
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
from PIL import Image

from sketchyscenecolorization_torch.config import FGGanConfig, FrameworkConfig
from sketchyscenecolorization_torch.models import fg_gan
from sketchyscenecolorization_torch.pipeline import compositing as comp
from sketchyscenecolorization_torch.pipeline.engines import (
    FGColorizeEngine, sky_detect_trace)
from sketchyscenecolorization_torch.pipeline.factory import (
    build_session, serve_devices_for)
from sketchyscenecolorization_torch.pipeline.session import \
    ColorizationSession as TColorizationSession
from sketchyscenecolorization_torch.pipeline import io as png_io
from sketchyscenecolorization_torch.pipeline.io import (AsyncPngWriter,
                                                        write_png)
from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
from sketchyscenecolorization_tpu.pipeline.compositing import \
    detect_sky as jax_detect_sky
from sketchyscenecolorization_tpu.pipeline.engines import \
    sky_detect_trace as jax_sky_detect_trace
from sketchyscenecolorization_tpu.pipeline.factory import \
    build_session as jax_build_session
from test_pipeline import INST, SIZE, small_config, write_fixtures
from test_torch_session import JaxNoise, port_config

IMAGE_ID = 7
TEXTS = ["the bus is yellow", "the grass is green",
         "the sky is blue and the ground is green", "the bus is red"]
# fixed matches of the FG instructions: 0 is the bus, 1 the grass
ROUTES = {"the bus is yellow": [0], "the grass is green": [1],
          "the bus is red": [0, 1], "the bus is blue": [0, 1],
          "the grass is blue": [1], "the road is gray": [1]}


def routed(session, routes=ROUTES):
    def _match_many(self, state, input_texts):
        return [list(routes[t]) for t in input_texts]
    session._match_many = types.MethodType(_match_many, session)
    return session


def _img(path):
    return np.array(Image.open(path).convert("RGB"))


def _records(tmp, outputs, image_id=IMAGE_ID):
    return (tmp / outputs / "update_records" /
            f"{image_id}_records.json").read_bytes()


def _assert_same(paths_a, paths_b):
    assert [os.path.basename(p) for p in paths_a] == \
        [os.path.basename(p) for p in paths_b]
    for a, b in zip(paths_a, paths_b):
        np.testing.assert_array_equal(_img(a), _img(b), err_msg=a)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serving")
    write_fixtures(str(tmp / "examples"), image_id=IMAGE_ID)
    jcfg = small_config(tmp)
    js = jax_build_session(jcfg, seed=0)
    ts = build_session(port_config(jcfg), seed=0, device="cpu")
    load_jax_tree(ts.matching.model, jax.tree.map(np.asarray,
                                                   js.matching.params))
    load_jax_tree(ts.fg.model, jax.tree.map(np.asarray, js.fg.g_params))
    load_jax_tree(ts.bg.model, jax.tree.map(np.asarray, js.bg.g_params))
    ts.fg.noise_source = JaxNoise(0, ts.fg.cfg.noise_dim)
    return tmp, js, ts


# ------------------------------------------------------------------ PNG IO

def _chunks(data):
    """(tag, payload) of every chunk of PNG bytes, each CRC checked."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    out, p = [], 8
    while p < len(data):
        n = int.from_bytes(data[p:p + 4], "big")
        tag, payload = data[p + 4:p + 8], data[p + 8:p + 8 + n]
        assert int.from_bytes(data[p + 8 + n:p + 12 + n], "big") == \
            zlib.crc32(tag + payload), tag
        out.append((tag, payload))
        p += 12 + n
    assert out[-1] == (b"IEND", b"")
    return out


@pytest.mark.parametrize("bands", [1, 2, 3, 8])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (5, 767), (767, 768),
                                   (768, 768)])
def test_write_png_roundtrip(tmp_path, monkeypatch, shape, level, bands):
    """Any band count decodes to the same pixels and filtered rows (the
    joined IDAT inflates with its combined Adler-32); one band is the
    plain ``compressobj`` stream byte for byte."""
    monkeypatch.setattr(png_io, "_pool_size", lambda: bands)
    h, w = shape
    rng = np.random.RandomState(h * w + level)
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    img[: h // 3] = img[0, 0]                    # a flat run, as a sky
    p = str(tmp_path / "x.png")
    used = write_png(p, img, level)
    assert used == max(1, min(bands, h // 64))
    np.testing.assert_array_equal(_img(p), img)
    with open(p, "rb") as f:
        chunks = _chunks(f.read())
    idat = b"".join(d for tag, d in chunks if tag == b"IDAT")
    rows = img.reshape(h, w * 3)
    if level:
        rows = rows.copy()
        rows[:, 3:] = rows[:, 3:] - img.reshape(h, w * 3)[:, :-3]
    raw = np.concatenate([np.full((h, 1), level, np.uint8), rows], 1)
    assert zlib.decompress(idat) == raw.tobytes()
    if used == 1:
        c = zlib.compressobj(level, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
        assert idat == c.compress(raw.tobytes()) + c.flush()


def test_a_fork_child_encodes_in_bands(monkeypatch):
    """The pool's threads stay in the parent; a forked child makes its own."""
    monkeypatch.setattr(png_io, "_pool_size", lambda: 4)
    img = np.random.RandomState(1).randint(0, 256, (256, 96, 3), np.uint8)
    want, used = png_io.png_bytes(img)          # makes the parent's pool
    assert used == 4
    pid = os.fork()
    if pid == 0:                                # the child: report, exit
        code = 1
        try:
            code = 0 if png_io.png_bytes(img) == (want, 4) else 2
        finally:
            os._exit(code)
    deadline = time.monotonic() + 60
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if not done:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
    assert done and os.waitstatus_to_exitcode(status) == 0


def test_concurrent_callers_share_the_pool(monkeypatch):
    """More callers than CPUs encode at once on the one pool, with the
    interpreter switching threads as often as it can: each gets its own
    image back."""
    monkeypatch.setattr(png_io, "_pool_size", lambda: 8)
    imgs = [np.random.RandomState(i).randint(0, 256, (512, 40, 3), np.uint8)
            for i in range(2 * (os.cpu_count() or 1))]
    got = [None] * len(imgs)

    def encode(i):
        for _ in range(3):
            data, used = png_io.png_bytes(imgs[i])
            got[i] = (used, np.array(Image.open(io.BytesIO(data))))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=encode, args=(i,))
                   for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    for img, (used, back) in zip(imgs, got):
        assert used == 8
        np.testing.assert_array_equal(back, img)


def test_async_writer_flush_and_error_surface(tmp_path):
    w = AsyncPngWriter()
    img = np.zeros((8, 8, 3), np.uint8)
    p = str(tmp_path / "a.png")
    w.save(p, img)
    w.flush()
    assert os.path.isfile(p)
    w.save(str(tmp_path / "no_dir" / "b.png"), img)   # surfaces on flush
    with pytest.raises(OSError):
        w.flush()
    w.close()


_EXIT_WITHOUT_FLUSH = """
import dataclasses, sys, time, types
import numpy as np
from sketchyscenecolorization_torch.config import FrameworkConfig
from sketchyscenecolorization_torch.pipeline import io as png_io
from sketchyscenecolorization_torch.pipeline.session import \\
    ColorizationSession

png_io._pool_size = lambda: 4
cfg = FrameworkConfig()
cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
    cfg.pipeline, async_png_writes=True, color_gradient=False))
s = ColorizationSession(cfg, types.SimpleNamespace(device="cpu"), None, None)
png_io.png_bytes(np.zeros((768, 768, 3), np.uint8))    # the band pool runs


def later(i):
    # each job starts after the interpreter has begun to exit
    def image():
        time.sleep(0.3)
        return np.random.RandomState(i).randint(0, 256, (768, 768, 3),
                                                np.uint8)
    return image


for i in range(6):
    s._save_result(f"{sys.argv[1]}/{i}.png", later(i))
"""


def test_queued_writes_survive_exit_without_flush(tmp_path):
    """A process that exits with write-behind PNGs still queued writes
    them all, banded, from the session's finalizer -- which runs after the
    interpreter has closed its thread pools to new work."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", _EXIT_WITHOUT_FLUSH, str(tmp_path)],
        env={**os.environ, "PYTHONPATH": root}, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "Traceback" not in r.stderr, r.stderr
    for i in range(6):
        want = np.random.RandomState(i).randint(0, 256, (768, 768, 3),
                                                np.uint8)
        np.testing.assert_array_equal(_img(str(tmp_path / f"{i}.png")), want)


# -------------------------------------------------------------- FG engine

def _small_engine(seed=7, noise_dim=8):
    cfg = FGGanConfig(image_size=32, vocab_size=12, max_len=6,
                      base_channels=8, num_classes=5, noise_dim=noise_dim)
    model = fg_gan.build_generator(cfg, torch.Generator().manual_seed(0))
    vocab = {"<pad>": 0, "<unk>": 1, "red": 2, "blue": 3}
    return FGColorizeEngine(cfg, model, vocab, seed=seed, device="cpu")


def test_fg_colorize_batch_matches_sequential_loop():
    """A K-row batch (bucket 4 for K = 3) against K one-row calls on the
    same noise stream: per-sample BN keeps rows independent, so only the
    reduction order differs (<= 1 LSB on < 1% of values; measured 0)."""
    seq_engine = _small_engine()
    batch_engine = seq_engine.fork(7)
    rng = np.random.RandomState(0)
    sketches = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    class_ids = [1, 4, 2]
    seq = [seq_engine.colorize_batch(sketches[k:k + 1], class_ids[k:k + 1],
                                     "red blue")[0] for k in range(3)]
    batched = batch_engine.colorize_batch(sketches, class_ids, "red blue")
    assert batched.dtype == np.uint8 and batched.shape == (3, 32, 32, 3)
    for k in range(3):
        diff = np.abs(batched[k].astype(int) - seq[k].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, k


def test_colorize_rows_dev_chunking_matches_single_call():
    """Above MAX_GAN_ROWS the rows run in row-order chunks: outputs within
    the bucket caveat (<= 1 LSB on < 0.1%; measured 0) and the noise
    stream advanced exactly as one call."""
    one = _small_engine()
    chunked = one.fork(7)
    chunked.MAX_GAN_ROWS = 2              # instance attr shadows the class's
    rng = np.random.RandomState(0)
    sketches = rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    ids = [1, 4, 2, 0, 3]
    toks = rng.randint(0, 12, (5, 6)).astype(np.int32)
    a, ka = one.colorize_rows_dev(sketches, ids, toks)
    b, kb = chunked.colorize_rows_dev(sketches, ids, toks)
    assert ka == kb == 5 and a.shape[0] == 8 and b.shape[0] == 5
    diff = np.abs(a[:5].numpy().astype(int) - b.numpy().astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    assert torch.equal(one._rng.get_state(), chunked._rng.get_state())


@pytest.mark.parametrize("noise_dim", [8, 256])
def test_noise_stream_is_invariant_to_segmentation_and_fork(noise_dim):
    """The engine's own noise source: k rows drawn at once equal the same
    rows drawn in any split (both of torch's CPU normal paths: fewer and
    more than 16 values a draw), and a fork draws from its own stream
    without advancing the original's."""
    eng = _small_engine(seed=11, noise_dim=noise_dim)
    whole = eng.fork(11).noise_source(5)
    parts_eng = eng.fork(11)
    parts = np.concatenate([parts_eng.noise_source(n) for n in (2, 0, 3)])
    assert whole.shape == (5, noise_dim)
    np.testing.assert_array_equal(parts, whole)
    np.testing.assert_array_equal(eng.noise_source(5), whole)
    # the JAX key chain fed in is per row too
    jn_whole, jn_parts = JaxNoise(3, noise_dim), JaxNoise(3, noise_dim)
    np.testing.assert_array_equal(
        np.concatenate([jn_parts(2), jn_parts(3)]), jn_whole(5))


# ------------------------------------- device compositor and sky detection

@pytest.mark.parametrize("method", ["composite", "composite_run",
                                    "composite_run_compact"])
def test_device_compositor_matches_jax_and_host_chain(env, method):
    """On the same canvas and generator bytes the port's compositor gives
    the JAX compositor's canvases and patches, and ``composite`` the host
    chain's canvas, byte for byte; the input canvas is never written."""
    _, js, ts = env
    jc = js._state(IMAGE_ID).get_compositor()
    state = ts._state(IMAGE_ID)
    tc = state.get_compositor()
    rng = np.random.RandomState(1)
    base = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
    gen = rng.randint(0, 256, (5, INST, INST, 3)).astype(np.uint8)
    base_t, gen_t = torch.from_numpy(base.copy()), torch.from_numpy(gen)
    passes = [((0,), 0), ((1,), 1), ((0, 1), 2), ((), 4), ((1,), 4)]
    if method == "composite":
        for inst, off in passes:
            got = tc.composite(base_t, gen_t, list(inst), off).numpy()
            want = np.asarray(jc.composite(jnp.asarray(base),
                                           jnp.asarray(gen), list(inst), off))
            np.testing.assert_array_equal(got, want)
            host = base.copy()
            for k, i in enumerate(inst):
                bbox = state.pred_boxes[i]
                color = comp.instance_result_postprocessing_u8(
                    gen[off + k], bbox, int(state.pred_class_ids[i]))
                comp.paste_instance(host, color, state.inner_mask, i, bbox)
            host[state.drawings_region] = state.moved[state.drawings_region]
            np.testing.assert_array_equal(got, host)
    elif method == "composite_run":
        got = tc.composite_run(base_t, gen_t, passes)
        want = jc.composite_run(jnp.asarray(base), jnp.asarray(gen), passes)
        assert len(got) == len(want) == len(passes)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        canvas, patches = tc.composite_run_compact(base_t, gen_t, passes)
        j_canvas, j_patches = jc.composite_run_compact(
            jnp.asarray(base), jnp.asarray(gen), passes)
        np.testing.assert_array_equal(canvas.numpy(), np.asarray(j_canvas))
        assert len(patches) == len(j_patches) == len(passes)
        for p, jp in zip(patches, j_patches):
            assert p.dtype == torch.uint8
            np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(base_t.numpy(), base)


def test_device_canvases_keep_the_host_layout(env):
    """The compositor's constants and canvases and the BG generator's
    input are row-major like the host's, though the .mat inner mask loads
    Fortran-ordered: ``torch.where`` gives its output its inputs' layout,
    and the convolutions choose algorithms, and so summation orders, by
    the layout of their input (a transposed input moved a BG pixel by 1
    LSB against the host chain on the card, and by 2 on the CPU)."""
    _, _, ts = env
    state = ts._state(IMAGE_ID)
    assert not state.inner_mask.flags["C_CONTIGUOUS"]   # as the loader gives
    c = state.get_compositor()
    assert c._inner.is_contiguous()
    canvas = c.composite(torch.from_numpy(state.sketch.copy()),
                         torch.zeros((2, INST, INST, 3), dtype=torch.uint8),
                         [0, 1])
    assert canvas.is_contiguous()
    seen = []
    hook = ts.bg.model.register_forward_pre_hook(
        lambda _m, inputs: seen.append(inputs[0].is_contiguous()))
    try:
        ts.bg.colorize_composited(canvas, c._inner, c._moved, c._drawings,
                                  "the sky is blue")
    finally:
        hook.remove()
    assert seen == [True]


def test_sky_detect_trace_matches_host_and_jax():
    """``sky_detect_trace`` == host ``detect_sky`` == JAX's, exactly: the
    dominant band colour by count with the first-occurrence tie-break and
    the lowest sky row, over random images with few colours (real ties),
    sky only in row 0, and a one-colour band."""
    fn = jax.jit(jax_sky_detect_trace)
    rng = np.random.RandomState(0)
    checked = 0
    for trial in range(12):
        h, w = 32, 24
        img = rng.randint(0, 4, (h, w, 3)).astype(np.uint8) * 63
        inner = (rng.rand(h, w) < 0.3).astype(np.int32)
        img_bg = np.where((inner != 0)[..., None], np.uint8(255), img)
        if trial == 5:        # sky colour present only in row 0
            img_bg[1: h // 2 + 1] = 7
            img_bg[0, :] = img_bg[5, 0]
        if trial == 7:        # whole band one colour
            img_bg[5:7] = 42
        if not (inner[5:7] == 0).any():
            continue
        want_color, want_bottom = comp.detect_sky(img_bg, inner)
        assert jax_detect_sky(img_bg, inner) == (want_color, want_bottom)
        j_color, j_bottom = fn(jnp.asarray(img_bg), jnp.asarray(inner))
        color, bottom = sky_detect_trace(torch.from_numpy(img_bg),
                                         torch.from_numpy(inner))
        assert [int(v) for v in color] == want_color == \
            [int(v) for v in np.asarray(j_color)], trial
        assert int(bottom) == want_bottom == int(j_bottom), trial
        checked += 1
    assert checked >= 10


# ------------------------------------------ mirrors of the JAX equivalences

def test_stream_matches_sequential(env):
    """``colorize_stream`` against sequential ``colorize`` on a mixed queue:
    the same result names and records byte for byte; images within the
    bucket caveat (the stream's FG run is one generator bucket)."""
    tmp, _, ts = env
    seq = routed(ts.clone(seed=0, results_base_dir=str(tmp / "seq")))
    stream = routed(ts.clone(seed=0, results_base_dir=str(tmp / "stream")))
    seq_paths = [seq.colorize(IMAGE_ID, t) for t in TEXTS]
    stream_paths = stream.colorize_stream(IMAGE_ID, TEXTS)
    assert [os.path.basename(p) for p in seq_paths] == \
        [os.path.basename(p) for p in stream_paths]
    for a, b in zip(seq_paths, stream_paths):
        diff = np.abs(_img(a).astype(int) - _img(b).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, a
    assert _records(tmp, "seq") == _records(tmp, "stream")


def test_device_compositing_matches_host_chain(env):
    """Device compositing against the NumPy/PIL chain, byte for byte:
    sequential passes, a BG pass, a withdraw, write-behind PNGs read off
    the device canvases, and a stream (row offsets > 0)."""
    tmp, _, ts = env
    dev = routed(ts.clone(seed=3, results_base_dir=str(tmp / "comp_dev"),
                          device_compositing=True))
    host = routed(ts.clone(seed=3, results_base_dir=str(tmp / "comp_host"),
                           device_compositing=False))
    host_imgs = []
    for t in TEXTS:
        a, b = _img(dev.colorize(IMAGE_ID, t)), _img(host.colorize(IMAGE_ID, t))
        host_imgs.append(b)
        np.testing.assert_array_equal(a, b, err_msg=t)
    dev.withdraw(IMAGE_ID)
    host.withdraw(IMAGE_ID)
    np.testing.assert_array_equal(_img(dev.colorize(IMAGE_ID, "the bus is blue")),
                                  _img(host.colorize(IMAGE_ID, "the bus is blue")))

    for compact in (True, False):     # the writer reads patches or canvases
        out = f"comp_dev_async_{compact}"
        dev_a = routed(ts.clone(seed=3, results_base_dir=str(tmp / out),
                                device_compositing=True, compact_fetch=compact,
                                async_png_writes=True))
        paths = [dev_a.colorize(IMAGE_ID, t) for t in TEXTS]
        dev_a.flush()
        for p, want in zip(paths, host_imgs):
            np.testing.assert_array_equal(_img(p), want, err_msg=p)

    dev_s = routed(ts.clone(seed=5, results_base_dir=str(tmp / "comp_dev_s"),
                            device_compositing=True, async_png_writes=True))
    host_s = routed(ts.clone(seed=5, results_base_dir=str(tmp / "comp_host_s"),
                             device_compositing=False))
    dev_paths = dev_s.colorize_stream(IMAGE_ID, TEXTS)
    dev_s.flush()
    _assert_same(dev_paths, host_s.colorize_stream(IMAGE_ID, TEXTS))
    assert _records(tmp, "comp_dev_s") == _records(tmp, "comp_host_s")


@pytest.mark.parametrize("case", ["sequential", "stream", "segmented",
                                  "small_override"])
def test_compact_fetch_matches_full_canvas(env, case):
    """Compact changed-pixel fetches with host reconstruction against the
    full-canvas device path, byte for byte (``sequential``, ``stream``); a
    run segmented one row a segment, and through the small-run override
    at two rows, against one segment (the noise stream and every canvas
    the same however the run is split)."""
    tmp, _, ts = env
    opts = {"sequential": ({"compact_fetch": True}, {"compact_fetch": False}),
            "stream": ({"compact_fetch": True}, {"compact_fetch": False}),
            "segmented": ({"stream_segment_rows": 1,
                           "stream_small_segment_rows": 0},
                          {"stream_segment_rows": 0,
                           "stream_small_segment_rows": 0}),
            "small_override": ({"stream_segment_rows": 0,
                                "stream_small_segment_rows": 2},
                               {"stream_segment_rows": 0,
                                "stream_small_segment_rows": 0})}[case]
    a, b = (routed(ts.clone(seed=9, results_base_dir=str(tmp / f"cf_{case}_{k}"),
                            device_compositing=True, **o))
            for k, o in zip("ab", opts))
    if case == "sequential":
        _assert_same([a.colorize(IMAGE_ID, t) for t in TEXTS],
                     [b.colorize(IMAGE_ID, t) for t in TEXTS])
    else:
        texts = TEXTS[:2] + ["the bus is red", "the bus is blue"] + TEXTS[2:]
        _assert_same(a.colorize_stream(IMAGE_ID, texts),
                     b.colorize_stream(IMAGE_ID, texts))
        assert torch.equal(a.fg._rng.get_state(), b.fg._rng.get_state())
    assert _records(tmp, f"cf_{case}_a") == _records(tmp, f"cf_{case}_b")


def test_device_gradient_matches_host_gradient(env, monkeypatch):
    """The device sky gradient (sky detection and the LUT round-trip on the
    device, the float64 ramp rows on the host, the canvas kept on the
    device, the PNG fetch write-behind) against the host
    ``add_color_gradient`` chain, byte for byte, over consecutive BG passes
    and a mixed stream.  The 64^2 scene is below LUT scale, so the gate is
    forced; the LUT equals the direct float64 math exactly."""
    tmp, _, ts = env
    monkeypatch.setattr(comp, "_LUT_MIN_PIXELS", 1)
    texts = ["the sky is blue and the ground is green", "the bus is yellow",
             "the sky is red and the ground is gray", "the sky is purple"]
    dev = routed(ts.clone(seed=31, results_base_dir=str(tmp / "dg_on"),
                          device_color_gradient=True))
    host = routed(ts.clone(seed=31, results_base_dir=str(tmp / "dg_off"),
                           device_color_gradient=False))
    calls = []
    grad = ts.bg.colorize_composited_gradient
    monkeypatch.setattr(ts.bg, "colorize_composited_gradient",
                        lambda *a: calls.append(1) or grad(*a))
    for t in texts:
        a_p, b_p = dev.colorize(IMAGE_ID, t), host.colorize(IMAGE_ID, t)
        np.testing.assert_array_equal(_img(a_p), _img(b_p), err_msg=t)
    assert len(calls) == 3                 # the device path really ran

    d_s = routed(ts.clone(seed=33, results_base_dir=str(tmp / "dg_on_s"),
                          device_color_gradient=True, async_png_writes=True))
    h_s = routed(ts.clone(seed=33, results_base_dir=str(tmp / "dg_off_s"),
                          device_color_gradient=False))
    a_paths = d_s.colorize_stream(IMAGE_ID, texts)
    d_s.flush()
    _assert_same(a_paths, h_s.colorize_stream(IMAGE_ID, texts))
    assert _records(tmp, "dg_on_s") == _records(tmp, "dg_off_s")


@pytest.mark.parametrize("mode", ["sequential", "stream"])
def test_fused_matches_split(env, mode):
    """``fused_gan_compositing`` has no effect in eager PyTorch: on and off
    give the same bytes, records and noise-stream advance (exact)."""
    tmp, _, ts = env
    fused = routed(ts.clone(seed=21, results_base_dir=str(tmp / f"fu_on_{mode}"),
                            fused_gan_compositing=True))
    split = routed(ts.clone(seed=21, results_base_dir=str(tmp / f"fu_off_{mode}"),
                            fused_gan_compositing=False))
    if mode == "sequential":
        _assert_same([fused.colorize(IMAGE_ID, t) for t in TEXTS],
                     [split.colorize(IMAGE_ID, t) for t in TEXTS])
    else:
        _assert_same(fused.colorize_stream(IMAGE_ID, TEXTS),
                     split.colorize_stream(IMAGE_ID, TEXTS))
    assert torch.equal(fused.fg._rng.get_state(), split.fg._rng.get_state())
    assert _records(tmp, f"fu_on_{mode}") == _records(tmp, f"fu_off_{mode}")


def test_stream_failure_matches_sequential(env):
    """A pass failing mid-run (a single-line road, ``fg_color_utils.py:
    306-308``) leaves the stream session in the sequential failure state:
    the passes before it committed (records and images), the same error
    raised, nothing written for the failing or later passes."""
    tmp, _, ts = env
    base_dir = str(tmp / "examples")
    sketch = np.full((SIZE, SIZE, 3), 255, np.uint8)
    sketch[10:30, 10:40][[0, -1], :] = 0
    sketch[10:30, 10:40][:, [0, -1]] = 0
    sketch[50, 2:62] = 0
    Image.fromarray(sketch).save(os.path.join(base_dir, "sketches", "19.png"))
    masks = np.empty(2, dtype=object)
    masks[0] = np.ones((21, 31), np.uint8)
    single = np.zeros((21, 61), np.uint8)
    single[10, :] = 1                      # one stroke -> odd crossings
    masks[1] = single
    np.savez(os.path.join(base_dir, "seg_data", "19_datas.npz"),
             pred_masks=masks, pred_class_ids=np.array([7, 36]),
             pred_boxes=np.array([[10, 10, 30, 40], [40, 2, 60, 62]],
                                 np.int32))
    inner = np.zeros((SIZE, SIZE), np.uint8)
    inner[11:29, 11:39] = 1
    scipy.io.savemat(os.path.join(base_dir, "inner_masks", "19.mat"),
                     {"inner_masks": inner})
    routes = {"the bus is yellow": [0], "the road is gray": [1],
              "the bus is red": [0]}
    texts = ["the bus is yellow", "the road is gray", "the bus is red"]

    seq = routed(ts.clone(seed=0, results_base_dir=str(tmp / "fail_seq")),
                 routes)
    seq_err = None
    for t in texts:
        try:
            seq.colorize(19, t)
        except ValueError as e:
            seq_err = str(e)
            break
    stream = routed(ts.clone(seed=0,
                             results_base_dir=str(tmp / "fail_stream")), routes)
    with pytest.raises(ValueError) as excinfo:
        stream.colorize_stream(19, texts)
    assert seq_err == "Road is single line" == str(excinfo.value)
    rec_a = json.loads(_records(tmp, "fail_seq", 19))
    assert rec_a == json.loads(_records(tmp, "fail_stream", 19)) \
        and len(rec_a) == 1
    a = sorted(os.listdir(tmp / "fail_seq" / "results" / "19"))
    b = sorted(os.listdir(tmp / "fail_stream" / "results" / "19"))
    assert a == b == ["19_1.png"]
    np.testing.assert_array_equal(
        _img(tmp / "fail_seq" / "results" / "19" / a[0]),
        _img(tmp / "fail_stream" / "results" / "19" / b[0]))


def test_async_matches_sync_and_withdraw_flushes(env):
    """Write-behind PNGs give the synchronous bytes, and withdraw sees a
    consistent disk (it flushes before deleting)."""
    tmp, _, ts = env

    def run(out, async_writes):
        session = routed(ts.clone(seed=0, results_base_dir=str(tmp / out),
                                  async_png_writes=async_writes))
        p1 = session.colorize(IMAGE_ID, "the bus is yellow")
        p2 = session.colorize(IMAGE_ID, "the sky is blue and the ground is green")
        session.flush()
        return session, p1, p2

    _, a1, a2 = run("sync_out", False)
    s_async, b1, b2 = run("async_out", True)
    _assert_same([a1, a2], [b1, b2])
    p3 = s_async.colorize(IMAGE_ID, "the bus is red")
    s_async.withdraw(IMAGE_ID)
    assert os.path.isfile(b1) and os.path.isfile(b2)
    assert not os.path.isfile(p3)


def test_match_score_cache_matches_uncached_and_skips_dispatch(env):
    """``cache_match_scores`` selects what the uncached path selects (with
    the power-of-two pad batch), a repeated instruction runs no forward,
    and a tight LRU still answers identically."""
    tmp, _, ts = env
    cached = ts.clone(seed=0, results_base_dir=str(tmp / "mc_on"))
    uncached = ts.clone(seed=0, results_base_dir=str(tmp / "mc_off"),
                        cache_match_scores=False)
    state_c, state_u = cached._state(IMAGE_ID), uncached._state(IMAGE_ID)
    texts = ["the bus is yellow", "the grass", "the bus"]
    assert cached._match_many(state_c, texts) == \
        uncached._match_many(state_u, texts)
    assert list(state_c.match_scores) == texts and not state_u.match_scores

    calls = []
    orig = cached.matching.score_instances
    cached.matching.score_instances = \
        lambda *a, **kw: calls.append(1) or orig(*a, **kw)
    try:
        again = cached._match_many(state_c, ["the bus", "the bus is yellow"])
        assert calls == []
        assert again == [cached._match_many(state_c, ["the bus"])[0],
                         cached._match_many(state_c, ["the bus is yellow"])[0]]
        tight = ts.clone(seed=0, results_base_dir=str(tmp / "mc_tight"),
                         max_cached_match_texts=2)
        state_t = tight._state(IMAGE_ID)
        assert tight._match_many(state_t, texts) == \
            uncached._match_many(state_u, texts)
        assert len(state_t.match_scores) <= 2
    finally:
        del cached.matching.score_instances       # back to the method


def test_cold_backbone_matches_warm_cache(env):
    tmp, _, ts = env
    warm = ts.clone(seed=0, results_base_dir=str(tmp / "warm_out"))
    cold = ts.clone(seed=0, results_base_dir=str(tmp / "cold_out"),
                    cache_visual_features=False)
    for text in ("the bus", "the grass is green"):
        assert warm.match_instances(IMAGE_ID, text) == \
            cold.match_instances(IMAGE_ID, text)
    assert warm._state(IMAGE_ID).visual_dev is not None
    assert cold._state(IMAGE_ID).visual_dev is None


def test_cache_bounds_soak_matches_unbounded(env):
    """Many images through tight LRU bounds (max_cached_images=2,
    max_cached_instance_inputs=1) give the unbounded session's outputs,
    with every cache (the device rows included) within its cap."""
    tmp, _, ts = env
    image_ids = [31, 32, 33, 34, 35]
    for i in image_ids:
        write_fixtures(str(tmp / "examples"), image_id=i)
    commands = [(i, "the bus is yellow") for i in image_ids] \
        + [(i, "the bus is red") for i in image_ids]
    bounded = routed(ts.clone(seed=0, results_base_dir=str(tmp / "soak_b"),
                              max_cached_images=2,
                              max_cached_instance_inputs=1))
    unbounded = routed(ts.clone(seed=0, results_base_dir=str(tmp / "soak_u"),
                                max_cached_images=0,
                                max_cached_instance_inputs=0))
    for image_id, text in commands:
        pb = bounded.colorize(image_id, text)
        pu = unbounded.colorize(image_id, text)
        assert len(bounded._images) <= 2
        assert all(len(s.instance_inputs) <= 1 and
                   len(s.instance_rows_dev) <= 1
                   for s in bounded._images.values())
        np.testing.assert_array_equal(_img(pb), _img(pu),
                                      err_msg=f"{image_id}: {text}")
    assert len(unbounded._images) == len(image_ids)
    for i in image_ids:
        rec_b = json.loads(_records(tmp, "soak_b", i))
        assert rec_b == json.loads(_records(tmp, "soak_u", i)) \
            and len(rec_b) == 2


def test_clone_matches_fresh_build(env):
    """``clone(seed)`` serves exactly as ``build_session`` with that seed,
    also after the session it was cloned from has drawn noise."""
    tmp, js, _ = env
    cfg = port_config(small_config(tmp))
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, results_base_dir=str(tmp / "fresh")))
    fresh = routed(build_session(cfg, seed=4, device="cpu"))
    fresh_paths = [fresh.colorize(IMAGE_ID, t) for t in TEXTS]
    clone = routed(fresh.clone(seed=4, results_base_dir=str(tmp / "cloned")))
    _assert_same(fresh_paths, [clone.colorize(IMAGE_ID, t) for t in TEXTS])
    assert _records(tmp, "fresh") == _records(tmp, "cloned")


def test_unknown_clone_override_raises(env):
    _, _, ts = env
    for fixed in ("score_thresh", "serve_gan_data_parallel"):
        with pytest.raises(ValueError, match=fixed):
            ts.clone(seed=0, **{fixed: 1})


# ----------------------------------------------- against the JAX session

def test_default_config_stream_matches_jax(env):
    """JAX's default-config session and the port's on a mixed
    ``colorize_stream`` queue (a FG run, BG, a FG run), gradient off, the
    JAX noise fed to both: the real matchers select the same instances;
    routed so that the generator runs, the records are byte-equal and the
    canvases within 1 LSB, FG results byte-equal outside the matched
    instances' inner masks wherever the base they were painted on agrees,
    BG results byte-equal inside the inner masks and on the drawings."""
    tmp, js, ts = env
    jsess = js.clone(seed=0, results_base_dir=str(tmp / "x_jax"),
                     color_gradient=False)
    tsess = ts.clone(seed=0, results_base_dir=str(tmp / "x_torch"),
                     color_gradient=False)
    tsess.fg.noise_source = JaxNoise(0, tsess.fg.cfg.noise_dim)
    texts = ["the bus is yellow", "the grass is green",
             "the sky is blue and the ground is green", "the bus is red",
             "the grass is blue"]
    fg_texts = [t for t in texts if "sky" not in t]
    for text in fg_texts:
        assert tsess.match_instances(IMAGE_ID, text) == \
            jsess.match_instances(IMAGE_ID, text)
    j_paths = routed(jsess).colorize_stream(IMAGE_ID, texts)
    t_paths = routed(tsess).colorize_stream(IMAGE_ID, texts)
    assert _records(tmp, "x_torch") == _records(tmp, "x_jax")
    assert [os.path.basename(p) for p in t_paths] == \
        [os.path.basename(p) for p in j_paths]

    state = tsess._state(IMAGE_ID)
    inside = state.inner_mask != 0
    prev_t = prev_j = state.sketch
    worst = 0
    for text, tp, jp in zip(texts, t_paths, j_paths):
        t_img, j_img = _img(tp), _img(jp)
        diff = np.abs(t_img.astype(int) - j_img.astype(int))
        worst = max(worst, int(diff.max()))
        assert diff.max() <= 1, tp
        if text in fg_texts:
            painted = np.isin(state.inner_mask,
                              [i + 1 for i in ROUTES[text]])
            same_base = (prev_t == prev_j).all(axis=-1)
            assert not diff[~painted & same_base].any(), tp
        else:
            assert not diff[inside].any(), tp
            assert not diff[state.drawings_region].any(), tp
        prev_t, prev_j = t_img, j_img
    fg_debug = f"{IMAGE_ID}_fg.png"
    diff = np.abs(_img(tmp / "x_torch" / "results" / str(IMAGE_ID) / fg_debug)
                  .astype(int) -
                  _img(tmp / "x_jax" / "results" / str(IMAGE_ID) / fg_debug))
    assert diff.max() <= 1


def test_match_instances_host_matches_device(env):
    tmp, _, ts = env
    session = ts.clone(seed=0, results_base_dir=str(tmp / "host_match"))
    for text in ("the bus is yellow", "the grass", "the bus"):
        assert session.match_instances(IMAGE_ID, text) == \
            session.match_instances_host(IMAGE_ID, text), text


FG_LABELS = {"match", "prep_rows", "gan_dispatch[2]", "comp_dispatch",
             "patch_wait", "reconstruct", "save+records", "canvas_upload"}
BG_LABELS = {"bg_dispatch", "bg_band_fetch", "bg_ramp_host",
             "bg_finish_dispatch", "bg_save", "png_fetch", "png_encode"}


@pytest.mark.parametrize("stage_trace", [True, False])
def test_stage_trace_records_the_serving_stages(env, monkeypatch,
                                                stage_trace):
    """With ``stage_trace`` the session records (label, t0, t1) events with
    the JAX package's labels, PNG workers' included; off, none."""
    tmp, _, ts = env
    monkeypatch.setattr(comp, "_LUT_MIN_PIXELS", 1)  # the device gradient
    session = routed(ts.clone(seed=0, results_base_dir=str(
        tmp / f"trace_{stage_trace}"), stage_trace=stage_trace,
        async_png_writes=True))
    session.colorize_stream(IMAGE_ID, TEXTS)
    session.flush()
    events = session.trace_events
    if not stage_trace:
        assert events == []
        return
    labels = {label for label, _, _ in events}
    assert FG_LABELS | BG_LABELS <= labels, (FG_LABELS | BG_LABELS) - labels
    assert all(t1 >= t0 for _, t0, t1 in events)
    session.clear_trace()
    assert session.trace_events == []


# ------------------------------------------------- serving data parallelism

def test_serve_devices_for_wiring(monkeypatch):
    """``factory.serve_devices_for`` (JAX ``serve_mesh_for``): the first N
    CUDA devices when the host has them; None (one device, JAX's
    fallback) otherwise, and on the CPU."""
    def cfg(n):
        base = FrameworkConfig()
        return dataclasses.replace(base, pipeline=dataclasses.replace(
            base.pipeline, serve_gan_data_parallel=n))

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert serve_devices_for(cfg(4)) is None          # no card here
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert serve_devices_for(cfg(0)) is None
    assert serve_devices_for(cfg(1)) is None
    assert serve_devices_for(cfg(4)) == [torch.device("cuda", i)
                                         for i in range(4)]
    assert serve_devices_for(cfg(9)) is None          # more than the host
    assert serve_devices_for(cfg(4), device="cpu") is None


def _dp_engines():
    """JAX's FG engine on a 4-device 'data' mesh and the port's with
    ``serve_devices=[cpu] * 4``, from the same weights (the fixture of
    ``tests/test_pipeline_serving.py:666-716``)."""
    from sketchyscenecolorization_tpu.config import FGGanConfig as JFGGan
    from sketchyscenecolorization_tpu.parallel import create_mesh
    from sketchyscenecolorization_tpu.pipeline.engines import \
        FGColorizeEngine as JFGEngine
    from sketchyscenecolorization_tpu.train.fg_gan import build_models
    kw = dict(image_size=32, vocab_size=12, max_len=6, base_channels=8,
              num_classes=5, noise_dim=8)
    jcfg, cfg = JFGGan(**kw), FGGanConfig(**kw)
    gen, _ = build_models(jcfg)
    s = cfg.image_size
    params = gen.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, s, s, 3), jnp.float32),
                      jnp.zeros((1, cfg.max_len), jnp.int32),
                      jnp.zeros((1,), jnp.int32),
                      jnp.zeros((1, cfg.noise_dim), jnp.float32))["params"]
    vocab = {"<pad>": 0, "<unk>": 1, "red": 2}
    mesh = create_mesh(data=4, model=1, devices=jax.devices()[:4])
    jax_dp = JFGEngine(jcfg, params, vocab, seed=7, serve_mesh=mesh)
    model = load_jax_tree(fg_gan.build_generator(cfg),
                          jax.tree.map(np.asarray, params))
    single = FGColorizeEngine(cfg, model, vocab, seed=7, device="cpu")
    dp = FGColorizeEngine(cfg, model, vocab, seed=7, device="cpu",
                          serve_devices=["cpu"] * 4)
    return jax_dp, single, dp


def _lsb(a, b):
    diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(diff.max()), float((diff > 0).mean())


def test_serve_dp_engine_matches_single_device_and_jax():
    jax_dp, single, dp = _dp_engines()
    assert len(dp._replicas) == 1           # one replica per device
    rng = np.random.RandomState(0)
    k, s = 6, single.cfg.image_size         # bucket 8: 2 rows a device
    sketches = rng.uniform(-1, 1, (k, s, s, 3)).astype(np.float32)
    ids = [1, 4, 2, 0, 3, 1]
    toks = rng.randint(0, 12, (k, 6)).astype(np.int32)

    out_1, k1 = single.colorize_rows_dev(sketches, ids, toks)
    out_n, kn = dp.colorize_rows_dev(sketches, ids, toks)
    assert k1 == kn == k and out_n.shape[0] == 8
    assert torch.equal(single._rng.get_state(), dp._rng.get_state())
    worst, share = _lsb(out_1[:k], out_n[:k])
    assert worst <= 1 and share < 0.01
    # buckets that do not divide over the devices run on the first one
    small_1, _ = single.colorize_rows_dev(sketches[:2], ids[:2], toks[:2])
    small_n, _ = dp.colorize_rows_dev(sketches[:2], ids[:2], toks[:2])
    assert torch.equal(small_1, small_n)

    # against JAX's engine on its mesh, on JAX's noise stream
    dp_jax_noise = dp.fork(7)
    dp_jax_noise.noise_source = JaxNoise(7, dp.cfg.noise_dim)
    want, _ = jax_dp.colorize_rows_dev(sketches, ids, toks)
    got, _ = dp_jax_noise.colorize_rows_dev(sketches, ids, toks)
    j_worst, j_share = _lsb(got[:k], np.asarray(want)[:k])
    assert j_worst <= 1 and j_share < 0.01
    print(f"serving DP engine: vs single {worst} LSB on {share:.2%}, "
          f"vs JAX {j_worst} LSB on {j_share:.2%}")


def test_serve_dp_session_matches_jax_and_default(env):
    """A session whose FG engine splits each bucket over four devices
    serves the stream of JAX's DP session (JAX ``test_pipeline_serving.py:
    719-770``) and of the port's default session, routed, gradient off,
    on JAX's noise: records byte-equal, canvases within 1 LSB."""
    from sketchyscenecolorization_tpu.parallel import create_mesh
    from sketchyscenecolorization_tpu.pipeline.engines import \
        FGColorizeEngine as JFGEngine
    from sketchyscenecolorization_tpu.pipeline.session import \
        ColorizationSession as JColorizationSession
    tmp, js, ts = env
    texts = ["the bus is yellow", "the grass is green",
             "the sky is blue and the ground is green", "the bus is red"]
    routes = {t: [0, 1] for t in texts if "sky" not in t}   # bucket 4 first

    def dp_cfg(cfg, outputs):
        return dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, results_base_dir=str(tmp / outputs),
            serve_gan_data_parallel=4, color_gradient=False))

    mesh = create_mesh(data=4, model=1, devices=jax.devices()[:4])
    jsess = routed(JColorizationSession(
        dp_cfg(js.cfg, "dp_jax"), js.matching,
        JFGEngine(js.fg.cfg, js.fg.g_params, js.fg.vocab, seed=9,
                  serve_mesh=mesh), js.bg), routes)
    engine = FGColorizeEngine(ts.fg.cfg, ts.fg.model, ts.fg.vocab, seed=9,
                              device="cpu", serve_devices=["cpu"] * 4)
    engine.noise_source = JaxNoise(9, engine.cfg.noise_dim)
    tsess = routed(TColorizationSession(dp_cfg(ts.cfg, "dp_torch"),
                                        ts.matching, engine, ts.bg), routes)
    default = ts.clone(seed=9, results_base_dir=str(tmp / "dp_default"),
                       color_gradient=False)
    default.fg.noise_source = JaxNoise(9, engine.cfg.noise_dim)
    routed(default, routes)
    paths = {name: sess.colorize_stream(IMAGE_ID, texts) for name, sess in
             (("dp_jax", jsess), ("dp_torch", tsess),
              ("dp_default", default))}
    worst = {}
    for other in ("dp_jax", "dp_default"):
        assert _records(tmp, "dp_torch") == _records(tmp, other)
        assert [os.path.basename(p) for p in paths["dp_torch"]] == \
            [os.path.basename(p) for p in paths[other]]
        worst[other] = max(_lsb(_img(a), _img(b))[0] for a, b in
                           zip(paths["dp_torch"], paths[other]))
        assert worst[other] <= 1, other
    print(f"serving DP session: {worst}")
