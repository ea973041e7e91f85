"""Port parity of the interactive session on the synthetic fixtures of
``tests/test_pipeline.py`` (``write_fixtures`` + ``small_config``): the JAX
session (host compositing, ``device_compositing=False``) and the torch
session get the same weights through the bridge and the same noise stream
(the JAX engine's key chain fed through ``FGColorizeEngine.noise_source``),
then run the same instruction sequence.

FG sequence: byte-identical records JSON, equal matched-instance sets
(scores within 1e-9), result canvases within 1 uint8 LSB (generator outputs
are f32 in another summation order before the u8 truncation; measured max
0 LSB) and byte-equal outside the instances' inner masks; withdraw agrees,
through the session and through the CLI.

Mixed FG/BG sequence, sky gradient off: byte-identical records JSON (the
merged ``proc_bg_text`` included), canvases within 1 LSB (the BG generator
writes every pixel outside the inner masks; measured max 1 LSB) and
byte-equal inside the inner masks and on the drawings.  With the gradient
on, the port's host chain fed the JAX engine's background bytes gives
byte-identical canvases: the gradient's sky-colour vote could move on a
1-LSB difference of the generator, so it is held apart from it."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from sketchyscenecolorization_tpu.pipeline.factory import \
    build_session as jax_build_session
from sketchyscenecolorization_torch import cli
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch.pipeline.factory import build_session
from sketchyscenecolorization_torch.pipeline.session import \
    ColorizationSession as TColorizationSession
from sketchyscenecolorization_tpu.pipeline.session import \
    ColorizationSession as JColorizationSession
from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
from test_pipeline import small_config, write_fixtures

IMAGE_ID = 7


class JaxNoise:
    """The FG engine's noise chain (JAX ``engines.py:256-264``): per row,
    ``key, nk = split(key)`` and ``normal(nk, (noise_dim,))``."""

    def __init__(self, seed: int, noise_dim: int):
        self.key = jax.random.PRNGKey(seed)
        self.noise_dim = noise_dim

    def __call__(self, k: int) -> np.ndarray:
        rows = []
        for _ in range(k):
            self.key, nk = jax.random.split(self.key)
            rows.append(np.asarray(
                jax.random.normal(nk, (self.noise_dim,), jnp.float32)))
        return np.stack(rows)


def port_config(jcfg):
    """The port's config built from the same keyword arguments as the JAX
    config ``jcfg`` (nested dataclasses included)."""
    kwargs = {}
    for f in dataclasses.fields(jcfg):
        value = getattr(jcfg, f.name)
        kwargs[f.name] = (port_config(value) if dataclasses.is_dataclass(value)
                          else value)
    return getattr(tconfig, type(jcfg).__name__)(**kwargs)


def _host_config(tmp_path):
    cfg = small_config(tmp_path)
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, device_compositing=False))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_session")
    tdir = tmp_path_factory.mktemp("torch_session")
    for d in (jdir, tdir):
        write_fixtures(str(d / "examples"), image_id=IMAGE_ID)
    jcfg, tcfg = _host_config(jdir), port_config(_host_config(tdir))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(_host_config(tdir))
    js = jax_build_session(jcfg, seed=0)
    ts = build_session(tcfg, seed=0, device="cpu")
    load_jax_tree(ts.matching.model, jax.tree.map(np.asarray,
                                                   js.matching.params))
    load_jax_tree(ts.fg.model, jax.tree.map(np.asarray, js.fg.g_params))
    load_jax_tree(ts.bg.model, jax.tree.map(np.asarray, js.bg.g_params))
    ts.fg.noise_source = JaxNoise(0, tcfg.fg_gan.noise_dim)
    return (js, jdir), (ts, tdir)


def _records(base, outputs="outputs"):
    path = base / outputs / "update_records" / f"{IMAGE_ID}_records.json"
    return path.read_bytes() if path.exists() else None


def _results(base, outputs="outputs"):
    d = base / outputs / "results" / str(IMAGE_ID)
    return {n: np.array(Image.open(d / n).convert("RGB"))
            for n in sorted(os.listdir(d))}


def _assert_same_state(js_dir, ts_dir, inner_mask):
    assert _records(ts_dir) == _records(js_dir)
    want, got = _results(js_dir), _results(ts_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        diff = np.abs(got[name].astype(int) - want[name].astype(int))
        assert diff.max() <= 1, name
        assert not diff[inner_mask == 0].any(), name


def test_fg_sequence_matches_jax(sessions):
    (js, jdir), (ts, tdir) = sessions
    texts = ["the bus is yellow", "the grass is green",
             "the yellow bus and the green grass"]
    for text in texts:
        assert ts.match_instances(IMAGE_ID, text) == \
            js.match_instances(IMAGE_ID, text)
        want = js._state(IMAGE_ID).match_scores[text]
        np.testing.assert_allclose(ts._state(IMAGE_ID).match_scores[text],
                                   want, rtol=0, atol=1e-9)
    inner = ts._state(IMAGE_ID).inner_mask

    for s in (js, ts):
        s.colorize(IMAGE_ID, texts[0])
        # force the generator onto both instances (the bus and the
        # grass, which is thickened): random weights may match neither
        s.colorize_foreground(IMAGE_ID, texts[2], [0, 1], "7_forced.png",
                              "7_1.png")
        s.colorize(IMAGE_ID, texts[1])
    _assert_same_state(jdir, tdir, inner)

    js.withdraw(IMAGE_ID)
    ts.withdraw(IMAGE_ID)
    _assert_same_state(jdir, tdir, inner)

    for s in (js, ts):
        s.colorize(IMAGE_ID, texts[2])
    _assert_same_state(jdir, tdir, inner)

    js.withdraw(IMAGE_ID)
    assert cli.main(["--command", "withdraw", "--image_id", str(IMAGE_ID),
                     "--results_base_dir", str(tdir / "outputs")]) == 0
    _assert_same_state(jdir, tdir, inner)


def test_unported_pipeline_options_raise(sessions):
    """Every pipeline option of the JAX package builds: the default
    ``PipelineConfig`` (device compositing, compact fetch, the device
    gradient), and ``serve_gan_data_parallel=2``, which on a host with
    fewer than two cards (here the CPU) falls back to one device, as JAX's
    ``serve_mesh_for`` does, and serves the same records and canvases as
    the default session (byte-equal)."""
    _, (ts, tdir) = sessions
    cfg = port_config(small_config(tdir))      # the default PipelineConfig
    pl = cfg.pipeline
    assert pl.device_compositing and pl.compact_fetch \
        and pl.device_color_gradient
    outputs = {}
    for n in (0, 2):
        out = f"dp_{n}"
        session = build_session(dataclasses.replace(
            cfg, pipeline=dataclasses.replace(
                pl, serve_gan_data_parallel=n,
                results_base_dir=str(tdir / out))), seed=0, device="cpu")
        assert session.fg.serve_devices is None
        session.colorize(IMAGE_ID, "the bus is yellow")
        # the generator on both instances (random weights may match none)
        session.colorize_foreground(IMAGE_ID, "the yellow bus", [0, 1],
                                    "7_forced.png", "7_1.png")
        session.colorize(IMAGE_ID, "the sky is blue and the ground is green")
        session.flush()
        outputs[n] = (_records(tdir, out), _results(tdir, out))
    assert outputs[2][0] == outputs[0][0]
    assert sorted(outputs[2][1]) == sorted(outputs[0][1])
    for name, img in outputs[0][1].items():
        np.testing.assert_array_equal(outputs[2][1][name], img, err_msg=name)


def _outputs_config(cfg, outputs, color_gradient):
    """``cfg`` writing to ``<tmp>/<outputs>`` with the gradient on or off."""
    base = os.path.dirname(cfg.pipeline.results_base_dir)
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, results_base_dir=os.path.join(base, outputs),
        color_gradient=color_gradient))


def _rebind(sessions, outputs, color_gradient, bg=None):
    """Both sessions' engines under a new results dir and gradient setting;
    ``bg`` replaces the port's BG engine."""
    (js, jdir), (ts, tdir) = sessions
    return (JColorizationSession(
                _outputs_config(js.cfg, outputs, color_gradient),
                js.matching, js.fg, js.bg),
            TColorizationSession(
                _outputs_config(ts.cfg, outputs, color_gradient),
                ts.matching, ts.fg, bg or ts.bg))


def test_mixed_fg_bg_sequence_matches_jax(sessions):
    (_, jdir), (_, tdir) = sessions
    js, ts = _rebind(sessions, "mixed", color_gradient=False)
    state = ts._state(IMAGE_ID)
    inside = state.inner_mask != 0

    def check():
        assert _records(tdir, "mixed") == _records(jdir, "mixed")
        want, got = _results(jdir, "mixed"), _results(tdir, "mixed")
        assert sorted(got) == sorted(want)
        for name in want:
            diff = np.abs(got[name].astype(int) - want[name].astype(int))
            assert diff.max() <= 1, name
            assert not diff[inside].any(), name
            assert not diff[state.drawings_region].any(), name

    sequence = ["the sky is blue", "the bus is yellow", "the ground is green",
                None, "the sky is red and the ground is brown"]
    for text in sequence:
        for s in (js, ts):
            if text is None:
                s.withdraw(IMAGE_ID)
            else:
                s.colorize(IMAGE_ID, text)
        check()
    records = json.loads(_records(tdir, "mixed"))
    assert [r["colorization_type"] for r in records] == ["BG", "FG", "BG"]
    assert records[1]["proc_bg_text"] == records[0]["proc_bg_text"]
    assert records[2]["proc_bg_text"] == \
        "the sky is red and the ground is brown"


class _JaxBackground:
    """The JAX BG engine behind the port's ``BGColorizeEngine.colorize``."""

    def __init__(self, engine):
        self.engine = engine

    def colorize(self, fg_image_uint8, text, want_region=True):
        out, region = self.engine.colorize(fg_image_uint8, text, want_region)
        return np.array(out), region


def test_sky_gradient_chain_matches_jax_given_equal_background(sessions):
    (js, jdir), (_, tdir) = sessions
    js, ts = _rebind(sessions, "gradient", color_gradient=True,
                     bg=_JaxBackground(js.bg))
    for text in ("the sky is blue", "the ground is green", None,
                 "the sky is cyan and the ground is brown"):
        for s in (js, ts):
            if text is None:
                s.withdraw(IMAGE_ID)
            else:
                s.colorize(IMAGE_ID, text)
        assert _records(tdir, "gradient") == _records(jdir, "gradient")
        want, got = _results(jdir, "gradient"), _results(tdir, "gradient")
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], name)
