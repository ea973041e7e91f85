"""Offline dataset tooling: the caption engine and the dataset generators.
Copy of ``sketchyscenecolorization_tpu/dataprep/``."""
from .caption_engine import (
    SceneItem, SceneGroup, GroundCollection, SceneDescriber,
    png2text, init_all_items,
    CATEGORIES_UNMOVABLE, CATEGORIES_TREE, CATEGORIES_MOVABLE, INSTANCE,
)
from .generators import (
    matching_data_generation, vocabulary_generation,
    fg_data_preparation, bg_data_generation, bg_caption,
    matching_data_visualization,
)
