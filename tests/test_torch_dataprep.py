"""Port parity of the offline tools: ``sketchyscenecolorization_torch/
dataprep`` (the caption engine and the dataset generators) and the
instance visualizations of ``utils/visualization.py``, against the JAX
package's, on the CPU.

- The caption engine on the seeded random and dense scenes of
  ``tests/test_caption_engine.py:97,154`` (and its three fixed scenes),
  with JAX's engine as the oracle: the same caption, the same sentences in
  the same order and the same instance lists (JAX's engine is
  deterministic, so the test holds the order, not only the sentence ->
  instance-set multiset); ``png2text`` on a ``colorMapC46.mat``.
- ``matching_data_generation``, ``vocabulary_generation``,
  ``fg_data_preparation``, ``bg_data_generation`` and
  ``matching_data_visualization`` on synthetic fixtures write the files
  JAX's write: JSON, vocabularies and PNGs byte for byte, the FG record
  shards member by member (a zip's own timestamps aside); the port's
  ``vocabulary_generation`` over the vendored
  ``data/sentence_instance_*.json`` gives the token set of
  ``data/match_vocab.txt``.
- ``visualize_inst_seg`` and ``visualize_sem_inst_mask`` write PNGs byte
  equal to JAX's; ``generate_colors`` is JAX's."""
import json
import os
import zipfile

import numpy as np
import pytest
import scipy.io
from PIL import Image

from sketchyscenecolorization_tpu import dataprep as jdp
from sketchyscenecolorization_tpu.data import matching_dataset as jmd
from sketchyscenecolorization_tpu.dataprep import caption_engine as jce
from sketchyscenecolorization_tpu.utils import visualization as jviz
from sketchyscenecolorization_torch import dataprep as tdp
from sketchyscenecolorization_torch.data import matching_dataset as tmd
from sketchyscenecolorization_torch.dataprep import caption_engine as tce
from sketchyscenecolorization_torch.utils import visualization as tviz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")


# ------------------------------------------------------------ caption engine

def _items(mod, boxes, cats):
    return [mod.SceneItem(category=cat, id=i, left=box[1], top=box[0],
                          width=box[3] - box[1], height=box[2] - box[0])
            for i, (box, cat) in enumerate(zip(boxes, cats))]


def _random_scene(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(2, 8)
    cats = list(rng.choice(
        ["house", "bus", "tree", "dog", "cat", "cloud", "sun", "grass",
         "road", "people", "bird"], size=n))
    boxes = []
    for _ in range(n):
        y1, x1 = rng.randint(0, 600), rng.randint(0, 600)
        boxes.append((y1, x1, y1 + rng.randint(40, 160),
                      x1 + rng.randint(40, 160)))
    return boxes, cats


def _dense_scene(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(6, 15)
    pool = ["house", "house", "bus", "tree", "tree", "tree", "dog", "dog",
            "cat", "sheep", "cloud", "sun", "star", "grass", "road",
            "people", "bird", "butterfly", "bench", "chicken"]
    cats = list(rng.choice(pool, size=n))
    boxes = []
    for _ in range(n):
        y1, x1 = rng.randint(0, 640), rng.randint(0, 640)
        boxes.append((y1, x1, y1 + rng.randint(30, 128),
                      x1 + rng.randint(30, 128)))
    return boxes, cats


FIXED_SCENES = {
    "simple": ([(50, 60, 150, 200), (40, 400, 160, 560), (500, 100, 700, 260),
                (480, 520, 690, 680)], ["sun", "cloud", "house", "tree"]),
    "groups": ([(400, 100, 600, 200), (420, 230, 610, 330),
                (350, 400, 640, 600), (600, 50, 700, 120),
                (580, 620, 700, 740), (700, 0, 768, 768), (650, 0, 700, 768)],
               ["tree", "tree", "house", "dog", "dog", "grass", "road"]),
    "sky": ([(10, 100, 80, 180), (20, 300, 90, 380), (15, 500, 85, 580),
             (5, 650, 60, 720)], ["cloud", "cloud", "star", "star"]),
}
SCENES = ([f"fixed_{k}" for k in FIXED_SCENES]
          + [f"random_{s}" for s in range(6)]
          + [f"dense_{s}" for s in range(100, 108)])


def _scene(name):
    kind, key = name.split("_", 1)
    if kind == "fixed":
        return FIXED_SCENES[key]
    return (_random_scene if kind == "random" else _dense_scene)(int(key))


@pytest.mark.parametrize("scene", SCENES)
def test_caption_engine_matches_jax(scene):
    boxes, cats = _scene(scene)
    got = tce.SceneDescriber(_items(tce, boxes, cats)).get_text()
    want = jce.SceneDescriber(_items(jce, boxes, cats)).get_text()
    caption, _, sen_map = got
    assert caption == want[0]
    assert sen_map == want[2]
    assert got == want
    assert caption.count(".") == len(sen_map) > 0


def _write_color_map(path, names):
    cm = np.empty((46, 2), dtype=object)
    for i in range(46):
        cm[i, 0] = np.array([names[i]])
        cm[i, 1] = np.array([[120, 120, 120]], np.uint8)
    scipy.io.savemat(path, {"colorMap": cm})


CATS46 = [f"others{i}" for i in range(46)]
for _i, _name in enumerate(("bus", "tree", "house", "dog", "cloud", "sun",
                            "grass", "car")):
    CATS46[_i] = _name


def test_png2text_and_categories_map(tmp_path):
    _write_color_map(str(tmp_path / "colorMapC46.mat"), CATS46)
    assert tce.load_categories_map(str(tmp_path)) == \
        jce.load_categories_map(str(tmp_path))
    boxes = [[40, 40, 200, 300], [300, 500, 600, 700], [10, 10, 80, 90],
             [650, 0, 768, 768]]
    ids = [1, 2, 5, 7]
    assert tce.png2text(boxes, ids, str(tmp_path)) == \
        jce.png2text(boxes, ids, str(tmp_path))


# ---------------------------------------------------------------- generators

GT_SIZE = 64
# (class id of CATS46 + 1, box) per instance; scene 3 holds an invalid
# category and is excluded
GT_SCENES = {
    1: [(1, (8, 8, 24, 30)), (2, (30, 40, 60, 60)), (7, (56, 0, 63, 63))],
    2: [(3, (20, 10, 50, 40)), (4, (40, 44, 58, 60)), (4, (44, 2, 60, 16)),
        (5, (2, 30, 10, 50))],
    3: [(1, (8, 8, 24, 30)), (12, (30, 30, 50, 50))],
    4: [(8, (30, 4, 50, 30)), (8, (32, 34, 52, 60)), (6, (2, 2, 12, 12)),
        (2, (10, 40, 28, 60))],
}


def _write_gt_split(base):
    split = os.path.join(base, "train")
    for d in ("DRAWING_GT", "CLASS_GT", "INSTANCE_GT"):
        os.makedirs(os.path.join(split, d), exist_ok=True)
    for image_id, instances in GT_SCENES.items():
        img = np.full((GT_SIZE, GT_SIZE, 3), 255, np.uint8)
        inst = np.zeros((GT_SIZE, GT_SIZE), np.uint8)
        cls = np.zeros((GT_SIZE, GT_SIZE), np.uint8)
        for k, (cat, (y1, x1, y2, x2)) in enumerate(instances):
            img[y1, x1:x2] = img[y2, x1:x2] = 0
            img[y1:y2, x1] = img[y1:y2, x2] = 0
            inst[y1:y2 + 1, x1:x2 + 1] = 2 * k + 3
            cls[y1:y2 + 1, x1:x2 + 1] = cat
        Image.fromarray(img).save(os.path.join(
            split, "DRAWING_GT", f"L0_sample{image_id}.png"))
        scipy.io.savemat(os.path.join(
            split, "INSTANCE_GT", f"sample_{image_id}_instance.mat"),
            {"INSTANCE_GT": inst})
        scipy.io.savemat(os.path.join(
            split, "CLASS_GT", f"sample_{image_id}_class.mat"),
            {"CLASS_GT": cls})


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _assert_same_files(port_root, jax_root):
    got, want = _files(port_root), _files(jax_root)
    assert sorted(got) == sorted(want)
    assert got
    for name, data in want.items():
        if name.endswith(".npz"):
            assert _npz_members(os.path.join(port_root, name)) == \
                _npz_members(os.path.join(jax_root, name)), name
        else:
            assert got[name] == data, name


def test_matching_generation_vocabulary_and_visualization(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(jmd, "IMAGE_SIZE", GT_SIZE)
    monkeypatch.setattr(tmd, "IMAGE_SIZE", GT_SIZE)
    _write_gt_split(str(tmp_path))
    counts = {"train": len(GT_SCENES)}
    for mod, side in ((tdp, "port"), (jdp, "jax")):
        out = str(tmp_path / side)
        res = mod.matching_data_generation(str(tmp_path), ["train"], CATS46,
                                           save_dir=out, image_counts=counts)
        assert [e["key"] for e in res["train"]] == [1, 2, 4]
        caps = os.path.join(out, "sentence_instance_train.json")
        vocab = mod.vocabulary_generation([caps], os.path.join(out,
                                                               "vocab.txt"))
        assert vocab[:2] == ["<pad>", "<unk>"] and "bus" in vocab
        assert mod.matching_data_visualization(
            str(tmp_path), "train", caps, os.path.join(out, "vis")) == \
            sum(len(e["sen_instIdx_map"]) for e in res["train"])
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_vocabulary_generation_reproduces_released_vocab():
    """Twin of ``tests/test_vendored_data.py:27`` on the port."""
    paths = [os.path.join(DATA, f"sentence_instance_{s}.json")
             for s in ("train", "val", "test")]
    regenerated = tdp.vocabulary_generation(paths)
    released = open(os.path.join(DATA, "match_vocab.txt")).read().split()
    assert len(regenerated) == len(released) == 76
    assert set(regenerated) == set(released)
    assert regenerated[:2] == released[:2] == ["<pad>", "<unk>"]
    assert regenerated == jdp.vocabulary_generation(paths)


def _write_fg_sources(base):
    """Per-category captions and 384^2 cartoon/edgemap PNGs, plus
    ``vocab.txt`` (the vendored FG vocabulary)."""
    rng = np.random.RandomState(0)
    entries = {"bus": {"train": ["b1.png", "b2.png"], "test": ["b3.png"]},
               "tree": {"train": ["t1.png"], "test": []}}
    for cat, splits in entries.items():
        for sub in ("cartoon", "edgemap"):
            os.makedirs(os.path.join(base, "images", cat, sub), exist_ok=True)
        os.makedirs(os.path.join(base, "captions", cat), exist_ok=True)
        for split, names in splits.items():
            with open(os.path.join(base, "captions", cat, f"{split}.json"),
                      "w") as f:
                json.dump([{"key": n, "color_text": f"the {cat} is red and "
                            "blue"} for n in names], f)
            for n in names:
                for sub in ("cartoon", "edgemap"):
                    Image.fromarray(rng.randint(0, 256, (384, 384, 3),
                                                dtype=np.uint8)).save(
                        os.path.join(base, "images", cat, sub, n))
    with open(os.path.join(DATA, "fg_vocab.txt")) as src, \
            open(os.path.join(base, "vocab.txt"), "w") as dst:
        dst.write(src.read())


def test_fg_data_preparation_writes_jax_shards(tmp_path):
    _write_fg_sources(str(tmp_path))
    for mod, side in ((tdp, "port"), (jdp, "jax")):
        written = mod.fg_data_preparation(str(tmp_path), ["train", "test"],
                                          out_subdir=f"records_{side}")
        assert len(written) == 4
    _assert_same_files(str(tmp_path / "records_port"),
                       str(tmp_path / "records_jax"))


def test_bg_data_generation_writes_jax_files(tmp_path):
    from sketchyscenecolorization_torch.dataprep.generators import \
        BG_COLOR_MAP
    size = 24
    rng = np.random.RandomState(1)
    sources = {}
    for split in ("train", "test"):
        for name in ("a.png", "b.png"):
            paint = np.zeros((size, size, 3), np.uint8)
            cut = rng.randint(8, 16)
            paint[:cut] = BG_COLOR_MAP["blue"]
            paint[cut:] = BG_COLOR_MAP["green"]
            mask = np.full((size, size, 3), 255, np.uint8)
            mask[6:14, 4:18] = 0
            fg = rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
            for d, im in (("user_paint", paint), ("foreground", fg),
                          ("inner_mask", mask)):
                sources[os.path.join(d, split, name)] = im
    for side in ("port", "jax"):
        for rel, im in sources.items():
            path = tmp_path / side / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(im).save(path)
    got = tdp.bg_data_generation(str(tmp_path / "port"), aug_num=3, seed=5)
    want = jdp.bg_data_generation(str(tmp_path / "jax"), aug_num=3, seed=5)
    assert got == want
    assert len(got["train"]) == 8
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


# ------------------------------------------------------------ visualization

def test_instance_visualizations_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    masks = np.zeros((48, 64, 3), np.int32)
    masks[4:20, 6:30, 0] = 1
    masks[25:40, 10:50, 1] = 1
    masks[30:45, 40:60, 2] = 1
    sem = masks.max(axis=2)
    boxes = np.array([[4, 6, 19, 29], [25, 10, 39, 49], [0, 0, 0, 0]])
    class_ids = np.array([1, 2, 1])
    names = ["bg", "bus", "tree"]
    scores = np.array([0.91, 0.5, 0.25])
    assert tviz.generate_colors(7, seed=3) == jviz.generate_colors(7, seed=3)
    assert tviz.generate_colors(4, bright=False, shuffle=False) == \
        jviz.generate_colors(4, bright=False, shuffle=False)
    for mod, side in ((tviz, "port"), (jviz, "jax")):
        out = tmp_path / side
        out.mkdir()
        mod.visualize_inst_seg(img, masks, "the bus", str(out / "inst.png"))
        mod.visualize_inst_seg(img, np.zeros((0, 0, 0)), "",
                               str(out / "empty.png"))
        for with_scores in (False, True):
            comp = mod.visualize_sem_inst_mask(
                img, sem, boxes, masks, class_ids, names, "the bus",
                scores=scores if with_scores else None,
                save_path=str(out / f"comp_{with_scores}.png"), seed=4)
            assert comp.shape == (48, 128, 3)
    _assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
