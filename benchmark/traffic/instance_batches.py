"""Generator of FG GAN training batches: instances of SketchyScene's 25
colorization classes, each with a colour caption, as the FG training
loader pairs them (``obj_lib/input_pipeline.py``: one queue for the G
batch, one for the D batch, each batch of paired sketches and colour
images plus real images of other instances for the discriminator).

Parameters (a traffic file with ``"kind": "instance_batches"``):

- ``pool_batches``: pairs of (D batch, G batch) drawn from the seed; the
  steps cycle through them;
- ``batch``: instances a batch, each with a real image of another
  instance beside it (``images_d``);
- ``classes``: the number of colorization classes, drawn uniformly;
- ``side_px``: [largest, smallest] box side of an instance in its 768^2
  scene, drawn uniformly between them.

An instance's caption is one of the serving cell's FG templates with two
distinct colours; its colour image (made by the driver) fills the
instance with the first colour and draws its strokes in the second where
the caption names an edge, else in black.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..reference.text import CATEGORY_LIST
from .session_commands import FG_COLORS, FG_TEMPLATES


@dataclass
class Instance:
    class_id: int                   # 0 .. classes - 1
    side: int
    fill: str                       # colour names of FG_COLORS
    edge: Optional[str]
    caption: Optional[str] = None   # None for a real image of D


@dataclass
class Batch:
    pairs: List[Instance]           # sketch, colour image, caption
    reals: List[Instance]           # images_d, class_id_d


@dataclass
class BatchPair:
    d: Batch
    g: Batch


def _instance(rng, p: dict, captioned: bool) -> Instance:
    cls = int(rng.integers(p["classes"]))
    big, small = p["side_px"]
    side = int(rng.integers(small, big + 1))
    c, c2 = (str(x) for x in rng.choice(FG_COLORS, 2, replace=False))
    template = FG_TEMPLATES[int(rng.integers(len(FG_TEMPLATES)))]
    edge = c2 if "{c2}" in template else None
    caption = template.format(n=CATEGORY_LIST[cls], v="is", c=c, c2=c2) \
        if captioned else None
    return Instance(cls, side, c, edge, caption)


def _batch(rng, p: dict) -> Batch:
    return Batch([_instance(rng, p, True) for _ in range(p["batch"])],
                 [_instance(rng, p, False) for _ in range(p["batch"])])


def make_plan(p: dict, seed: int) -> List[BatchPair]:
    rng = np.random.default_rng([seed, 5])
    return [BatchPair(_batch(rng, p), _batch(rng, p))
            for _ in range(p["pool_batches"])]
