"""The FG GAN configuration brings its own driver, control and reference
kind as new files, found by name: ``control.control`` reaches
``drivers/train_fg_gan.py:control`` through the configuration's
``driver``, and ``reference.build`` the discriminator through
``reference/fg_disc.py``, on a seed stream of its own."""
from benchmark import control, harness, reference
from benchmark.drivers import train_fg_gan
from benchmark.reference import fg_disc
from benchmark.tests.test_bench_fg_gan import (SEED, tiny_gan_config,
                                               tiny_gan_traffic)


def test_the_cell_finds_its_driver_and_control(monkeypatch):
    cell, config, traffic = harness.cell_files("fg_gan_train")
    assert config["driver"] == "train_fg_gan"
    assert cell["config"] == config["name"] == "train_fg_gan_mru192"
    config, traffic = tiny_gan_config(), tiny_gan_traffic()
    monkeypatch.setattr(harness, "cell_files",
                        lambda name: (cell, config, traffic))
    got = control.control("fg_gan_train", SEED, "cpu", "float32")
    want = train_fg_gan.control(cell, config, traffic, SEED, "cpu",
                                "float32")
    assert got == want
    # at the configuration's own precision the reference in the program's
    # place is correct
    limits = harness.load_json("limits", "fg_gan_train.json")
    assert set(got) == set(limits)
    assert all(got[k] <= limits[k] for k in got), got


def test_the_discriminator_is_a_kind_of_its_own():
    cls, stream = reference.model_of("fg_disc")
    assert cls is fg_disc.MRUDiscriminator and stream == fg_disc.STREAM
    streams = [s for _, s in reference.MODELS.values()] + [stream]
    assert len(set(streams)) == len(streams)
    f = tiny_gan_config()["framework"]["fg_gan"]
    _, disc = reference.build("fg_disc", f, SEED, "cpu")
    _, gen = reference.build("fg_gan", f, SEED, "cpu")
    # the two models' first conv kernels have one shape, other draws
    a, b = disc["h0.weights"], gen["enc_h0.weights"]
    assert a.shape == b.shape and not (a == b).all()
    skeleton = reference.skeleton("fg_disc", f)
    assert skeleton.h0.weights.device.type == "meta"
