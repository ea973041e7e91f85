"""The port's validation, test and inference procedures
(``sketchyscenecolorization_torch/train/eval_procedures.py``) against the
JAX package's on the same weights, on the CPU.

The JAX FG procedures draw each item's noise row from a ``PRNGKey``
chain (``fg_validation`` and ``fg_test``: ``rng, k = split(rng)`` then
``normal(k, (1, noise_dim))`` per item; ``fg_inference``:
``normal(PRNGKey(seed))``); ``jax_rows`` recomputes those rows and the
port's procedures take them as ``noise``.  ``bg_test`` draws nothing.
The generators come from JAX's fresh states through the bridge.  Every
PNG either side writes must exist on the other and be within 1 u8 LSB
(measured: at most 1, with 99.97-100% of the output bytes equal; the test
prints the share); the inputs and targets are byte-equal."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from sketchyscenecolorization_tpu import data as jdata
from sketchyscenecolorization_tpu.config import BGGanConfig, FGGanConfig
from sketchyscenecolorization_tpu.pipeline.engines import \
    BGColorizeEngine as JBGColorizeEngine
from sketchyscenecolorization_tpu.train import eval_procedures as jproc
from sketchyscenecolorization_tpu.train.bg_gan import create_bg_gan_state
from sketchyscenecolorization_tpu.train.fg_gan import create_fg_gan_state
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch import data as tdata
from sketchyscenecolorization_torch.models import bg_gan as t_bg
from sketchyscenecolorization_torch.models import fg_gan as t_fg
from sketchyscenecolorization_torch.pipeline.engines import BGColorizeEngine
from sketchyscenecolorization_torch.text import load_vocab
from sketchyscenecolorization_torch.train import eval_procedures as tproc
from sketchyscenecolorization_torch.utils.bridge import load_jax_tree
from test_torch_gan_harness import write_bg_data, write_fg_data
from test_torch_train_fg_gan import one_torch_thread  # noqa: F401

LSB = 1
FG_KW = dict(batch_size=1, image_size=64, vocab_size=58, max_len=15,
             base_channels=4, noise_dim=8)
BG_KW = dict(batch_size=1, image_size=32, vocab_size=18, ngf=4, ndf=4,
             multi_residual=False)
SEED = 3


def jax_rows(seed, n, noise_dim):
    """The JAX procedures' noise rows of ``n`` items, [n, noise_dim]
    (JAX ``train/eval_procedures.py:47-56,98,163-185``)."""
    rng = jax.random.PRNGKey(seed)
    rows = []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        rows.append(np.asarray(jax.random.normal(k, (1, noise_dim),
                                                 jnp.float32))[0])
    return np.stack(rows)


def assert_pngs_close(want_dir, got_dir):
    """Every PNG of ``want_dir`` is in ``got_dir`` and no other; outputs
    within LSB, everything else byte-equal.  Returns the share of equal
    output bytes."""
    names = sorted(os.listdir(want_dir))
    assert names and names == sorted(os.listdir(got_dir))
    equal = total = 0
    for name in names:
        want = np.array(Image.open(os.path.join(want_dir, name)), np.int16)
        got = np.array(Image.open(os.path.join(got_dir, name)), np.int16)
        assert got.shape == want.shape, name
        if "output" not in name:
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        assert np.abs(got - want).max() <= LSB, name
        equal += int((got == want).sum())
        total += got.size
    print(f"{want_dir}: {equal / total:.2%} of the output bytes equal")
    return equal / total


@pytest.fixture(scope="module")
def fg(tmp_path_factory):
    """(JAX cfg, JAX g_params, the port's generator on them, data dir)."""
    base = str(tmp_path_factory.mktemp("fg_data"))
    write_fg_data(base)
    cfg = FGGanConfig(**FG_KW)
    params = create_fg_gan_state(jax.random.PRNGKey(0), cfg).g_params
    gen = load_jax_tree(t_fg.build_generator(tconfig.FGGanConfig(**FG_KW)),
                        jax.tree.map(np.asarray, params))
    return cfg, params, gen, base


def _shards(base):
    shard_dir = os.path.join(base, "records", "val")
    return [os.path.join(shard_dir, n) for n in sorted(os.listdir(shard_dir))]


def test_fg_validation_matches_jax(fg, tmp_path):
    cfg, params, gen, base = fg
    shards = _shards(base)
    n = jproc.fg_validation(cfg, params, shards, str(tmp_path / "jax"),
                            seed=SEED)
    assert n == 6
    got = tproc.fg_validation(tconfig.FGGanConfig(**FG_KW), gen, shards,
                              str(tmp_path / "port"), seed=SEED,
                              device="cpu",
                              noise=jax_rows(SEED, n, cfg.noise_dim))
    assert got == n
    assert_pngs_close(str(tmp_path / "jax" / "with_text"),
                      str(tmp_path / "port" / "with_text"))


def test_fg_test_matches_jax(fg, tmp_path):
    cfg, params, gen, base = fg
    vocab = load_vocab(os.path.join(base, "vocab.txt"))
    n = jproc.fg_test(cfg, params, base, str(tmp_path / "jax"), vocab,
                      seed=SEED)
    assert n == 2
    assert tproc.fg_test(tconfig.FGGanConfig(**FG_KW), gen, base,
                         str(tmp_path / "port"), vocab, seed=SEED,
                         device="cpu",
                         noise=jax_rows(SEED, n, cfg.noise_dim)) == n
    assert_pngs_close(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_fg_inference_matches_jax(fg, tmp_path):
    cfg, params, gen, base = fg
    vocab = load_vocab(os.path.join(base, "vocab.txt"))
    sketch = os.path.join(base, "images", "car", "sketch", "s0.png")
    categories = ["bus", "car", "cat"]
    want = jproc.fg_inference(cfg, params, sketch, "car", categories,
                              "the car is blue", vocab,
                              str(tmp_path / "jax"), seed=SEED)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                         (1, cfg.noise_dim), jnp.float32))
    got = tproc.fg_inference(tconfig.FGGanConfig(**FG_KW), gen, sketch,
                             "car", categories, "the car is blue", vocab,
                             str(tmp_path / "port"), seed=SEED,
                             device="cpu", noise=noise)
    assert os.path.basename(got) == os.path.basename(want)
    assert_pngs_close(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_fg_noise_rows_run_out(fg, tmp_path):
    """Fewer rows than items raises; without ``noise`` the torch generator
    draws, as before."""
    cfg, _, gen, base = fg
    with pytest.raises(ValueError, match="noise"):
        tproc.fg_validation(tconfig.FGGanConfig(**FG_KW), gen, _shards(base),
                            str(tmp_path / "short"), device="cpu",
                            noise=np.zeros((2, cfg.noise_dim), np.float32))
    assert tproc.fg_validation(tconfig.FGGanConfig(**FG_KW), gen,
                               _shards(base), str(tmp_path / "default"),
                               device="cpu") == 6


def test_bg_test_matches_jax(tmp_path):
    base = str(tmp_path / "bg_data")
    write_bg_data(base, BG_KW["image_size"], splits=("test",))
    cfg = BGGanConfig(**BG_KW)
    params = create_bg_gan_state(jax.random.PRNGKey(0), cfg).g_params
    vocab = load_vocab(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "bg_vocab.txt"))
    gen = load_jax_tree(t_bg.build_generator(tconfig.BGGanConfig(**BG_KW)),
                        jax.tree.map(np.asarray, params))

    def dataset(mod):
        return mod.BGDataset(
            os.path.join(base, "captions", "test.json"),
            os.path.join(base, "foreground", "test"),
            os.path.join(base, "background", "test"),
            os.path.join(base, "segment", "test"), vocab,
            image_size=cfg.image_size, max_len=cfg.max_len)
    n = jproc.bg_test(cfg, JBGColorizeEngine(cfg, params, vocab),
                      dataset(jdata), str(tmp_path / "jax"))
    assert n == 3
    engine = BGColorizeEngine(tconfig.BGGanConfig(**BG_KW), gen, vocab,
                              device="cpu")
    assert tproc.bg_test(tconfig.BGGanConfig(**BG_KW), engine,
                         dataset(tdata), str(tmp_path / "port")) == n
    assert_pngs_close(str(tmp_path / "jax"), str(tmp_path / "port"))
