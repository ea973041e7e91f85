"""The port's GAN data, harnesses, CLIs and serving of trained generators,
on the CPU at small sizes:
- ``FGPairedDataset`` and ``BGDataset`` batches byte-equal to the JAX
  package's for the same seed, on synthetic record shards and image
  directories (``make_batch`` called synchronously, in the same order);
- ``train_fg_gan`` and ``train_bg_gan`` with snapshots and latest-step
  resume (mirrors of ``tests/test_data_and_harness.py``), and the FG
  harness's NaN abort (status -1);
- every mode of ``cli_fg_gan`` (train, val, test, inference) and
  ``cli_bg_gan`` (train, test) with ``--device cpu``, at narrow widths;
- ``build_session`` restoring both generators from the port's snapshots,
  then serving a BG and a FG command; an orbax step directory raises,
  naming ``scripts/orbax_to_torch.py``;
- every entry point (``build_session``, the four CLIs' ``main`` with
  ``--device cpu`` at narrow widths, the three trainers) turns TF32 off
  for cuDNN and cuBLAS, with both flags on before it."""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sketchyscenecolorization_tpu import data as jdata
from sketchyscenecolorization_torch import cli_bg_gan, cli_fg_gan
from sketchyscenecolorization_torch import config as tconfig
from sketchyscenecolorization_torch import data as tdata
from sketchyscenecolorization_torch.pipeline import build_session
from sketchyscenecolorization_torch.text import load_vocab
from sketchyscenecolorization_torch.train import train_bg_gan, train_fg_gan
from sketchyscenecolorization_torch.utils.checkpoint import (
    latest_checkpoint, list_checkpoint_steps, restore_checkpoint)
from test_pipeline import small_config, write_fixtures
from test_torch_session import port_config
from test_torch_train_fg_gan import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATEGORIES = (("bus", 0), ("car", 3))


def write_fg_data(base, text_len=15, n=3, vocab_size=58):
    """records/{train,val}/<category>.npz shards (384^2 cartoons and
    sketches), and for the test mode captions/<category>/test.json,
    images/<category>/sketch/<key> and vocab.txt."""
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        for cat, cid in CATEGORIES:
            cartoons = rng.randint(0, 256, (n, 384, 384, 3)).astype(np.uint8)
            sketches = np.full((n, 384, 384, 3), 255, np.uint8)
            sketches[:, 100:300:7] = 0
            tokens = rng.randint(1, vocab_size, (n, text_len)).astype(np.uint8)
            tokens[:, :4] = 0
            tdata.write_record_shard(
                os.path.join(base, "records", split, f"{cat}.npz"),
                [f"{cat}{i}.png" for i in range(n)], cartoons, sketches,
                cat, np.full(n, cid), ["red"] * n, tokens)
    vocab = ["<pad>", "<unk>", "the", "bus", "is", "red", "car", "blue"]
    with open(os.path.join(base, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    for cat, _ in CATEGORIES:
        os.makedirs(os.path.join(base, "captions", cat))
        os.makedirs(os.path.join(base, "images", cat, "sketch"))
        with open(os.path.join(base, "captions", cat, "test.json"), "w") as f:
            json.dump([{"key": "s0.png", "color_text": f"the {cat} is red"}],
                      f)
        sketch = np.full((100, 80, 3), 255, np.uint8)
        sketch[20:80, 10:70:5] = 0
        Image.fromarray(sketch).save(
            os.path.join(base, "images", cat, "sketch", "s0.png"))
    return [os.path.join(base, "records", "train", f"{c}.npz")
            for c, _ in CATEGORIES]


def write_bg_data(base, size, splits=("train", "test"), n=3):
    """captions/<split>.json and the foreground, background and segment
    PNGs of each entry."""
    rng = np.random.RandomState(1)
    for split in splits:
        entries = []
        for i in range(n):
            name = f"{split}{i}.png"
            for d in ("foreground", "background"):
                os.makedirs(os.path.join(base, d, split), exist_ok=True)
                Image.fromarray(rng.randint(0, 256, (size + 8, size, 3))
                                .astype(np.uint8)).save(
                    os.path.join(base, d, split, name))
            seg = np.zeros((size, size), np.uint8)
            seg[: size // 2] = 128
            seg[size // 2:] = 255
            seg[size // 4: size // 2, size // 4: size // 2] = 0
            os.makedirs(os.path.join(base, "segment", split), exist_ok=True)
            Image.fromarray(np.repeat(seg[:, :, None], 3, 2)).save(
                os.path.join(base, "segment", split, name))
            entries.append({"fg_name": name, "bg_name": name,
                            "color_text": "the sky is blue and the grass is "
                                          "green"})
        os.makedirs(os.path.join(base, "captions"), exist_ok=True)
        with open(os.path.join(base, "captions", f"{split}.json"), "w") as f:
            json.dump(entries, f)


def _bg_dataset(mod, base, size, seed=0):
    """``mod.BGDataset`` (the port's ``data`` or the JAX package's) over
    the train split, with the vendored BG vocabulary."""
    words = load_vocab(os.path.join(ROOT, "data", "bg_vocab.txt"))
    return mod.BGDataset(
        os.path.join(base, "captions", "train.json"),
        os.path.join(base, "foreground", "train"),
        os.path.join(base, "background", "train"),
        os.path.join(base, "segment", "train"), words, image_size=size,
        max_len=8, seed=seed)


# ------------------------------------------------------------ data

@pytest.mark.parametrize("distance_map", [False, True])
def test_fg_paired_batches_equal_jax(tmp_path, distance_map):
    shards = write_fg_data(str(tmp_path))
    for a, b in zip(tdata.read_record_shard(shards[0]).values(),
                    jdata.read_record_shard(shards[0]).values()):
        np.testing.assert_array_equal(a, b)
    port = tdata.FGPairedDataset(shards, 2, 64, distance_map, seed=4)
    ref = jdata.FGPairedDataset(shards, 2, 64, distance_map, seed=4)
    for step in range(3):
        got, want = port.make_batch(step), ref.make_batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key


def test_bg_batches_equal_jax(tmp_path):
    write_bg_data(str(tmp_path), 32, splits=("train",))
    port = _bg_dataset(tdata, str(tmp_path), 32, seed=2)
    ref = _bg_dataset(jdata, str(tmp_path), 32, seed=2)
    for step in range(4):
        got, want = port.make_batch(step), ref.make_batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key
    assert set(np.unique(got["labels"])) == {0, 1, 2}


# ------------------------------------------------------------ harnesses

FG_TINY = tconfig.FGGanConfig(batch_size=2, image_size=32, vocab_size=58,
                              max_len=15, base_channels=4, noise_dim=8,
                              max_iters=3, snapshot_interval=2)
BG_TINY = tconfig.BGGanConfig(batch_size=1, image_size=32, vocab_size=18,
                              ngf=4, ndf=4, multi_residual=False,
                              max_steps=3, snapshot_interval=2)


def test_fg_harness_resumes_and_aborts_on_nan(tmp_path):
    shards = write_fg_data(str(tmp_path / "data"))
    ds = tdata.FGPairedDataset(shards, FG_TINY.batch_size,
                               FG_TINY.image_size)
    run = str(tmp_path / "run")
    assert train_fg_gan(FG_TINY, ds, run, max_iters=2, log_every=1,
                        device="cpu") == 0
    assert list_checkpoint_steps(os.path.join(run, "snapshot")) == [2]
    assert train_fg_gan(FG_TINY, ds, run, log_every=1, device="cpu") == 0
    step, path = latest_checkpoint(os.path.join(run, "snapshot"))
    saved = restore_checkpoint(path)
    assert step == 3 and saved["step"] == 3
    assert saved["g_opt"]["count"] == 3 and saved["d_opt"]["count"] == 3
    rows = [json.loads(l) for l in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r["loss_d"]) and np.isfinite(r["loss_g"])
               for r in rows)

    make = ds.make_batch

    def poisoned(step):
        batch = make(step)
        batch["images_d"] = batch["images_d"] * np.nan
        return batch
    ds.make_batch = poisoned
    assert train_fg_gan(FG_TINY, ds, str(tmp_path / "nan_run"), max_iters=2,
                        device="cpu") == -1


def test_bg_harness_resumes(tmp_path):
    write_bg_data(str(tmp_path / "data"), 32, splits=("train",))
    ds = _bg_dataset(tdata, str(tmp_path / "data"), 32)
    run = str(tmp_path / "run")
    state = train_bg_gan(BG_TINY, ds, run, max_steps=2, progress_every=1,
                         device="cpu")
    assert state.step == 2
    state = train_bg_gan(BG_TINY, ds, run, progress_every=1, device="cpu")
    assert state.step == 3
    assert list_checkpoint_steps(os.path.join(run, "snapshot")) == [2, 3]
    saved = restore_checkpoint(latest_checkpoint(
        os.path.join(run, "snapshot"))[1])
    for k, v in saved["ema_losses"].items():
        assert float(v) == float(state.ema_losses[k]) and np.isfinite(
            float(v)), k
    rows = [json.loads(l) for l in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]


# ------------------------------------------------------------ CLIs

def test_cli_fg_gan_every_mode(tmp_path, monkeypatch):
    """At base 4 and noise 8 (the CLI's widths are the reference's)."""
    monkeypatch.setattr(cli_fg_gan, "FGGanConfig", functools.partial(
        tconfig.FGGanConfig, base_channels=4, noise_dim=8))
    base = str(tmp_path / "data")
    write_fg_data(base)
    common = ["--data_base_dir", base, "--small_img", "1", "--device", "cpu"]
    out = str(tmp_path / "outputs")
    assert cli_fg_gan.main(["--mode", "train", "--output_base_dir", out,
                            "--max_iter_step", "1"] + common) == 0
    (run_name,) = os.listdir(out)
    run = os.path.join(out, run_name)
    assert cli_fg_gan.main(["--mode", "train", "--resume_from", run,
                            "--max_iter_step", "2"] + common) == 0
    assert list_checkpoint_steps(os.path.join(run, "snapshot")) == [1, 2]
    assert json.load(open(os.path.join(run, "params.json")))[
        "image_size"] == 64
    assert cli_fg_gan.main(["--mode", "val", "--resume_from", run]
                           + common) == 0
    val = sorted(os.listdir(os.path.join(run, "results", "with_text")))
    assert len(val) == 3 * 3 * len(CATEGORIES) and "bus_bus0_output.png" \
        in val
    assert cli_fg_gan.main(["--mode", "test", "--resume_from", run]
                           + common) == 0
    assert sorted(os.listdir(os.path.join(run, "test_results"))) == [
        "bus_s0_input.png", "bus_s0_output.png", "car_s0_input.png",
        "car_s0_output.png"]
    monkeypatch.chdir(tmp_path)
    os.makedirs("examples")
    Image.open(os.path.join(base, "images", "car", "sketch", "s0.png")).save(
        os.path.join("examples", "car.png"))
    assert cli_fg_gan.main(["--mode", "inference", "--resume_from", run,
                            "--image_name", "car.png", "--instruction",
                            "the car is blue"] + common) == 0
    out_png = np.array(Image.open(os.path.join(run, "results",
                                               "car_output.png")))
    assert out_png.shape == (64, 64, 3)


def test_cli_bg_gan_every_mode(tmp_path, monkeypatch):
    """At ngf = ndf = 4 without ``multi_residual``."""
    monkeypatch.setattr(cli_bg_gan, "BGGanConfig", functools.partial(
        tconfig.BGGanConfig, ngf=4, ndf=4, multi_residual=False))
    base = str(tmp_path / "data")
    write_bg_data(base, 32)
    run = str(tmp_path / "run")
    common = ["--data_base_dir", base, "--run_dir", run, "--image_size", "32",
              "--device", "cpu"]
    assert cli_bg_gan.main(["--mode", "train", "--max_steps", "1"]
                           + common) == 0
    assert cli_bg_gan.main(["--mode", "train", "--max_steps", "2"]
                           + common) == 0
    assert list_checkpoint_steps(os.path.join(run, "snapshot")) == [1, 2]
    assert cli_bg_gan.main(["--mode", "test"] + common) == 0
    names = sorted(os.listdir(os.path.join(run, "test_results")))
    assert len(names) == 9 and "test0-outputs.png" in names
    out = np.array(Image.open(os.path.join(run, "test_results",
                                           "test0-outputs.png")))
    inputs = np.array(Image.open(os.path.join(run, "test_results",
                                              "test0-inputs.png")))
    fg = np.zeros((32, 32), bool)
    fg[8:16, 8:16] = True                   # segment 0: pasted back
    np.testing.assert_array_equal(out[fg], inputs[fg])


# ------------------------------------------------------------ serving

def test_session_serves_trained_generators(tmp_path):
    cfg = small_config(tmp_path)
    write_fixtures(str(tmp_path / "examples"))
    fg_data = write_fg_data(str(tmp_path / "fg_data"), text_len=6,
                            vocab_size=16)
    write_bg_data(str(tmp_path / "bg_data"), 64, splits=("train",), n=1)
    fg_run, bg_run = str(tmp_path / "fg_run"), str(tmp_path / "bg_run")
    train_fg_gan(dataclasses.replace(cfg.fg_gan, max_iters=1),
                 tdata.FGPairedDataset(fg_data, 2, cfg.fg_gan.image_size),
                 fg_run, device="cpu")
    train_bg_gan(dataclasses.replace(cfg.bg_gan, max_steps=1),
                 _bg_dataset(tdata, str(tmp_path / "bg_data"), 64), bg_run,
                 device="cpu")
    fg_ckpt, bg_ckpt = (os.path.join(r, "snapshot") for r in (fg_run, bg_run))
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, fg_ckpt_dir=fg_ckpt, bg_ckpt_dir=bg_ckpt))
    session = build_session(cfg, seed=0, device="cpu")
    for engine, ckpt in ((session.fg, fg_ckpt), (session.bg, bg_ckpt)):
        saved = restore_checkpoint(latest_checkpoint(ckpt)[1])["generator"]
        got = engine.model.state_dict()
        assert sorted(got) == sorted(saved)
        for key, value in saved.items():
            assert torch.equal(got[key], value), key
    assert session.colorize(7, "the sky is blue").endswith("7_1.png")
    assert session.colorize_foreground(7, "the bus is yellow", [0], "7_2.png",
                                       "7_1.png").endswith("7_2.png")

    os.makedirs(os.path.join(fg_ckpt, "step_9"))          # orbax-style
    with pytest.raises(ValueError, match="orbax_to_torch"):
        build_session(cfg, seed=0, device="cpu")


# ------------------------------------------------ the f32 policy (C3)

@pytest.fixture
def tf32_on():
    """Both TF32 flags on before the test (cuDNN's is on by default in
    torch), restored after it."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _run_build_session(tmp_path, monkeypatch):
    write_fixtures(str(tmp_path / "examples"))
    build_session(port_config(small_config(tmp_path)), device="cpu")


def _run_cli(tmp_path, monkeypatch):
    """``cli.main`` at the fixtures' 64^2 widths: one BG command."""
    from sketchyscenecolorization_torch import cli
    write_fixtures(str(tmp_path / "examples"))
    monkeypatch.setattr(cli, "FrameworkConfig",
                        lambda: port_config(small_config(tmp_path)))
    monkeypatch.setattr(cli, "PipelineConfig", functools.partial(
        tconfig.PipelineConfig, image_size=64, instance_size=64))
    empty = ["--match_ckpt_dir", "", "--fg_ckpt_dir", "", "--bg_ckpt_dir", "",
             "--match_vocab_path", "", "--fg_vocab_path", "",
             "--bg_vocab_path", ""]
    assert cli.main(["--image_id", "7", "--instruction", "the sky is blue",
                     "--data_base_dir", str(tmp_path / "examples"),
                     "--results_base_dir", str(tmp_path / "outputs"),
                     "--device", "cpu"] + empty) == 0


def _run_cli_matching(tmp_path, monkeypatch):
    from sketchyscenecolorization_torch import cli_matching
    from sketchyscenecolorization_torch.data import matching_dataset as md
    from test_torch_evaluation import write_val_split
    monkeypatch.setattr(md, "IMAGE_SIZE", md.IMAGE_SIZE)        # restored
    write_val_split(str(tmp_path))
    assert cli_matching.main([
        "--mode", "eval", "--no_mask_ap", "--data_base_dir", str(tmp_path),
        "--captions_base_dir", str(tmp_path), "--vocab_path",
        os.path.join(ROOT, "data", "match_vocab.txt"), "--run_dir",
        str(tmp_path / "run"), "--image_size", "48", "--model_scale",
        "0.016", "--device", "cpu"]) == 0


def _run_cli_fg_gan(tmp_path, monkeypatch):
    monkeypatch.setattr(cli_fg_gan, "FGGanConfig", functools.partial(
        tconfig.FGGanConfig, base_channels=4, noise_dim=8))
    write_fg_data(str(tmp_path / "data"), n=1)
    assert cli_fg_gan.main(["--mode", "val", "--resume_from",
                            str(tmp_path / "run"), "--data_base_dir",
                            str(tmp_path / "data"), "--small_img", "1",
                            "--device", "cpu"]) == 0


def _run_cli_bg_gan(tmp_path, monkeypatch):
    monkeypatch.setattr(cli_bg_gan, "BGGanConfig", functools.partial(
        tconfig.BGGanConfig, ngf=4, ndf=4, multi_residual=False))
    write_bg_data(str(tmp_path / "data"), 32, splits=("test",), n=1)
    assert cli_bg_gan.main(["--mode", "test", "--data_base_dir",
                            str(tmp_path / "data"), "--run_dir",
                            str(tmp_path / "run"), "--image_size", "32",
                            "--device", "cpu"]) == 0


def _run_train_matching(tmp_path, monkeypatch):
    from sketchyscenecolorization_torch.data import matching_dataset as md
    from sketchyscenecolorization_torch.models.rmi import RMI
    from sketchyscenecolorization_torch.train import train_matching
    from test_data_and_harness import _write_matching_corpus
    from test_torch_evaluation import CLI_KW
    monkeypatch.setattr(md, "IMAGE_SIZE", 48)
    base, caps = _write_matching_corpus(tmp_path)
    cfg = tconfig.MatchingConfig(**CLI_KW)
    ds = tdata.MatchingTrainDataset(
        base, caps, load_vocab(os.path.join(ROOT, "data", "match_vocab.txt")),
        max_len=cfg.max_len)
    train_matching(cfg, ds, RMI(cfg), str(tmp_path / "run"), max_iters=1,
                   device="cpu")


def _run_train_fg_gan(tmp_path, monkeypatch):
    shards = write_fg_data(str(tmp_path / "data"), n=1)
    ds = tdata.FGPairedDataset(shards, FG_TINY.batch_size, FG_TINY.image_size)
    assert train_fg_gan(FG_TINY, ds, str(tmp_path / "run"), max_iters=1,
                        device="cpu") == 0


def _run_train_bg_gan(tmp_path, monkeypatch):
    write_bg_data(str(tmp_path / "data"), 32, splits=("train",), n=1)
    train_bg_gan(BG_TINY, _bg_dataset(tdata, str(tmp_path / "data"), 32),
                 str(tmp_path / "run"), max_steps=1, device="cpu")


ENTRY_POINTS = {"build_session": _run_build_session, "cli": _run_cli,
                "cli_matching": _run_cli_matching,
                "cli_fg_gan": _run_cli_fg_gan, "cli_bg_gan": _run_cli_bg_gan,
                "train_matching": _run_train_matching,
                "train_fg_gan": _run_train_fg_gan,
                "train_bg_gan": _run_train_bg_gan}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_run_in_f32(entry, tmp_path, monkeypatch, tf32_on):
    """With no flag set by the caller, every entry point turns TF32 off
    for cuDNN convolutions and cuBLAS matmuls (``ops/conv.py:
    apply_compute_dtype``), as the f32 reference computes."""
    ENTRY_POINTS[entry](tmp_path, monkeypatch)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
