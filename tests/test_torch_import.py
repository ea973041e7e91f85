"""The port imports nothing of the JAX package: with ``jax`` and
``sketchyscenecolorization_tpu`` both blocked it imports (the CLIs, the
RecurAttn op, the BG generator and the visualization copy included),
builds a small session at the default ``PipelineConfig`` (device
compositing on) and runs one BG and one FG command on the synthetic
fixtures, takes one matching, one FG GAN and one BG GAN train step, runs
the word-attention and
RecurAttn fusions once, the Inception-v4 perceptual loss and the
evaluation's metrics, the SegNet matcher at bfloat16 and a train step of
the Residual FG variant, and ``python -m sketchyscenecolorization_torch
--help`` runs.  Its own copies of the JAX package's jax-free modules
(``config``, ``text``, ``data``) agree with the originals."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np

from sketchyscenecolorization_tpu import config as jconfig
from sketchyscenecolorization_tpu import data as jdata
from sketchyscenecolorization_tpu import text as jtext
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch import data as tdata
from sketchyscenecolorization_torch import text as ttext
from test_pipeline import write_fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for blocked in ("jax", "flax", "sketchyscenecolorization_tpu"):
        sys.modules[blocked] = None      # any import of them now raises
    import numpy as np
    import torch
    import sketchyscenecolorization_torch.cli
    import sketchyscenecolorization_torch.cli_bg_gan
    import sketchyscenecolorization_torch.cli_fg_gan
    import sketchyscenecolorization_torch.cli_matching
    import sketchyscenecolorization_torch.data.bg_dataset
    import sketchyscenecolorization_torch.data.fg_records
    import sketchyscenecolorization_torch.data.im_ops
    import sketchyscenecolorization_torch.evaluation
    import sketchyscenecolorization_torch.models.inception_v4
    import sketchyscenecolorization_torch.train.eval_procedures
    import sketchyscenecolorization_torch.models.bg_gan
    import sketchyscenecolorization_torch.models.backbones
    import sketchyscenecolorization_torch.models.fg_gan_variants
    import sketchyscenecolorization_torch.ops.recur_attn
    import sketchyscenecolorization_torch.utils.visualization
    from sketchyscenecolorization_torch.config import (
        BGGanConfig, FGGanConfig, FrameworkConfig, MatchingConfig,
        PipelineConfig)
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.pipeline import build_session
    from sketchyscenecolorization_torch.train import (
        create_matching_state, make_matching_train_step)
    matching = MatchingConfig(vf_h=4, vf_w=4, H=32, W=32, vocab_size=16,
                              w_emb_dim=8, v_emb_dim=8, m_rnn_size=8,
                              w_rnn_size=8, max_len=6)
    base = sys.argv[1]
    cfg = FrameworkConfig(
        matching=MatchingConfig(vf_h=8, vf_w=8, H=64, W=64, vocab_size=16,
                                w_emb_dim=8, v_emb_dim=8, m_rnn_size=8,
                                w_rnn_size=8, max_len=6),
        fg_gan=FGGanConfig(image_size=64, vocab_size=16, max_len=6,
                           base_channels=4, noise_dim=8),
        bg_gan=BGGanConfig(image_size=64, vocab_size=16, ngf=4,
                           multi_residual=False),
        pipeline=PipelineConfig(
            data_base_dir=base + "/examples",
            results_base_dir=base + "/outputs", match_vocab_path="",
            fg_vocab_path="", bg_vocab_path="", match_ckpt_dir="",
            fg_ckpt_dir="", bg_ckpt_dir="", image_size=64, instance_size=64))
    assert cfg.pipeline.device_compositing      # the default serving path
    session = build_session(cfg, seed=0, device="cpu")
    out = session.colorize(7, "the sky is blue")
    assert out.endswith("7_1.png"), out
    out = session.colorize_foreground(7, "the bus is yellow", [0],
                                      "7_2.png", "7_1.png")
    assert out.endswith("7_2.png"), out
    state = session._state(7)
    assert state.compositor is not None and state.last_result_dev is not None
    state = create_matching_state(RMI(matching), matching)
    rng = np.random.RandomState(0)
    batch = {
        "image": torch.from_numpy(rng.randn(1, 32, 32, 3).astype(np.float32)),
        "words": torch.tensor([[2, 3, 4, 0, 0, 0]], dtype=torch.int32),
        "seq_len": torch.tensor([3], dtype=torch.int32),
        "target_mask": torch.ones(1, 32, 32, 1)}
    state, metrics = make_matching_train_step(matching)(state, batch)
    assert state.step == 1 and np.isfinite(float(metrics["cost"]))
    from sketchyscenecolorization_torch.train import (
        create_bg_gan_state, create_fg_gan_state, make_bg_gan_train_step,
        make_fg_gan_train_step)
    fg = FGGanConfig(batch_size=2, image_size=32, vocab_size=16, max_len=4,
                     base_channels=4, noise_dim=8)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3))
                           .astype(np.float32))
    fg_batch = {"images": img, "sketches": img, "images_d": img,
                "class_id": torch.tensor([1, 2]),
                "class_id_d": torch.tensor([3, 4]),
                "tokens": torch.tensor([[0, 2, 3, 4], [5, 6, 7, 8]])}
    fg_state, metrics = make_fg_gan_train_step(fg)(
        create_fg_gan_state(fg, device="cpu"), fg_batch, fg_batch)
    assert fg_state.step == 1 and not bool(metrics["nan"])
    bg = BGGanConfig(image_size=32, vocab_size=16, ngf=4, ndf=4,
                     multi_residual=False)
    bg_batch = {"inputs": img[:1], "targets": img[1:],
                "tokens": torch.tensor([[0, 0, 2, 3, 4, 5, 6, 7]]),
                "labels": torch.ones(1, 32, 32, dtype=torch.long)}
    bg_state, metrics = make_bg_gan_train_step(bg)(
        create_bg_gan_state(bg, device="cpu"), bg_batch)
    assert bg_state.step == 1 and not bool(metrics["nan"])
    for variant in (dict(use_attn=True), dict(fusion_type="RecurAttn")):
        kw = dict(matching.__dict__, **variant)
        with torch.no_grad():
            up = RMI(MatchingConfig(**kw))(batch["image"], batch["words"].long(),
                                           batch["seq_len"].long()).up
        assert up.shape == (1, 32, 32, 1) and torch.isfinite(up).all()
    kw = dict(matching.__dict__, backbone="segnet", compute_dtype="bfloat16")
    with torch.no_grad():
        up = RMI(MatchingConfig(**kw))(batch["image"], batch["words"].long(),
                                       batch["seq_len"].long()).up
    assert up.dtype == torch.float32 and torch.isfinite(up).all()
    res = FGGanConfig(batch_size=2, image_size=32, vocab_size=16, max_len=4,
                      base_channels=4, noise_dim=8, block_type="Residual")
    res_state, metrics = make_fg_gan_train_step(res)(
        create_fg_gan_state(res, device="cpu"), fg_batch, fg_batch)
    assert res_state.step == 1 and not bool(metrics["nan"])
    from sketchyscenecolorization_torch.evaluation import (
        MatchingEvaluator, inception_score)
    from sketchyscenecolorization_torch.models.inception_v4 import (
        InceptionV4, perceptual_loss)
    with torch.no_grad():
        loss = perceptual_loss(InceptionV4("Mixed_5b"), img[:1], -img[:1])
    assert float(loss) > 0
    evaluator = MatchingEvaluator(compute_mask_ap=False)
    evaluator.add(np.ones((4, 4)), np.ones((4, 4)))
    assert evaluator.result().cum_iou == 1.0
    assert inception_score(np.full((4, 3), 1 / 3), splits=1)[0] == 1.0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "sketchyscenecolorization_tpu")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    print("ok", type(session).__name__)
""")


def test_port_imports_and_builds_without_jax(tmp_path):
    write_fixtures(str(tmp_path / "examples"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok ColorizationSession"
    blocked = ("import sys\nfor m in ('jax', 'flax', "
               "'sketchyscenecolorization_tpu'):\n    sys.modules[m] = None\n"
               "import runpy\nsys.argv = ['sketchyscenecolorization_torch', "
               "'--help']\nrunpy.run_module('sketchyscenecolorization_torch', "
               "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", blocked], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--instructions" in proc.stdout


def test_config_copy_matches_jax():
    """Every config class of the copy takes the JAX class's fields and
    defaults; the same keyword arguments give the same tree."""
    for name in ("MatchingConfig", "FGGanConfig", "BGGanConfig",
                 "PipelineConfig", "FrameworkConfig"):
        jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
        assert [f.name for f in dataclasses.fields(tcls)] == \
            [f.name for f in dataclasses.fields(jcls)], name
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls()), name
    kw = dict(vf_h=6, vf_w=6, H=48, W=48, fusion_type="RecurAttn")
    assert dataclasses.asdict(tconfig.MatchingConfig(**kw)) == \
        dataclasses.asdict(jconfig.MatchingConfig(**kw))


def test_text_and_data_copies_match_jax(tmp_path):
    vocab = jtext.load_vocab(os.path.join(ROOT, "data", "match_vocab.txt"))
    assert ttext.load_vocab(os.path.join(ROOT, "data", "match_vocab.txt")) \
        == vocab
    for text in ("the yellow bus with gray windows.", "a red car", "sky"):
        assert ttext.matching_encode(text, vocab, 15) == \
            jtext.matching_encode(text, vocab, 15)
        assert ttext.colorization_encode(text, vocab, 15) == \
            jtext.colorization_encode(text, vocab, 15)
        assert ttext.judge_colorize_type(text) == \
            jtext.judge_colorize_type(text)
    import random
    assert ttext.augment_caption_with_attr("the bus", random.Random(3)) == \
        jtext.augment_caption_with_attr("the bus", random.Random(3))
    im = np.random.RandomState(0).randint(0, 256, (30, 20, 3)).astype(
        np.uint8)
    for fn in ("resize_and_pad", "resize_and_crop"):
        np.testing.assert_array_equal(getattr(tdata, fn)(im, 16, 24),
                                      getattr(jdata, fn)(im, 16, 24))
    mask = np.zeros((8, 8, 2), np.uint8)
    mask[2:5, 1:3, 0] = 1
    np.testing.assert_array_equal(tdata.extract_bboxes(mask),
                                  jdata.extract_bboxes(mask))
    for mod, sub in ((tdata, "port"), (jdata, "jax")):
        base = str(tmp_path / sub)
        for text in ("the bus is red", "the sky is blue"):
            new, _, _, summary = mod.fetch_records(1, base)
            mod.update_records(1, text, base, "foreground", new, "", summary)
    assert (tmp_path / "port" / "update_records" / "1_records.json"
            ).read_bytes() == \
        (tmp_path / "jax" / "update_records" / "1_records.json").read_bytes()
    assert tdata.fetch_records(1, str(tmp_path / "port")) == \
        jdata.fetch_records(1, str(tmp_path / "jax"))


def test_entry_points_default_to_the_card():
    """Nothing runs on the CPU unless the caller asks for it."""
    import inspect

    from sketchyscenecolorization_torch import (cli, cli_bg_gan, cli_fg_gan,
                                                cli_matching)
    from sketchyscenecolorization_torch.pipeline import (
        BGColorizeEngine, FGColorizeEngine, MatchingEngine, build_session)
    from sketchyscenecolorization_torch.train import (
        create_bg_gan_state, create_fg_gan_state, eval_procedures,
        train_bg_gan, train_fg_gan, train_matching)
    for fn in (build_session, MatchingEngine, FGColorizeEngine,
               BGColorizeEngine, train_matching, train_fg_gan, train_bg_gan,
               create_fg_gan_state, create_bg_gan_state,
               eval_procedures.fg_validation, eval_procedures.fg_test,
               eval_procedures.fg_inference):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for mod in (cli, cli_matching, cli_fg_gan, cli_bg_gan):
        assert mod.make_parser().get_default("device") == "cuda"
    assert cli_matching.make_parser().parse_args(
        ["--mode", "eval"]).device == "cuda"
