"""Scene-layout -> referring-expression caption engine (offline dataset
tooling).  Copy of ``sketchyscenecolorization_tpu/dataprep/caption_engine.py``
(the port imports nothing of the JAX package); pure Python.

Behavioral reimplementation of the reference's caption generator
(``Instance_Matching/data_preparation/png_to_text.py`` +
``data_preparation/data_generation_util.py``): given instance boxes and
class ids for a scene sketch, emit every (sentence, instance-index-set) pair
the matching model trains on.  The rules preserved exactly:

- sky singles first (sun -> moon -> cloud -> star) with the/both/all
  variants (``png_to_text.py:42-168``);
- ground items by big category (unmovable -> tree -> movable), with
  same-category items within NEAR_DISTANCE=200px edge distance merged into
  groups (BFS, ``data_generation_util.py:1138-1175``);
- per category-list naming: 1 -> "the noun"; 2 -> direction vs the other +
  opposite; >2 -> "the left noun" for all (``:467-501,775-800``);
- reference selection per mode: nearest earlier unmovable; trees prefer
  unmovable references; movables prefer unmovable+tree, else chain to the
  previous group (``:932-1005``);
- direction predicates over bottom-center angles (horizontal <=30 deg,
  vertical >=60 deg) with tree-specific "among"/"around"
  (``:1010-1080``);
- group-internal directions: house left->right; 2 items left/right; 3-5 by
  horizontal-vs-vertical spread with rank names; movables search for a
  'near' unmovable/tree landmark (closer by >=50px and <=50px away)
  (``:795-881``);
- the full sentence-emission sequence of ``ItemCollection.get_description``
  (``:1209-1424``) including its sentence->instance bookkeeping;
- grass/road sentences last (``png_to_text.py:207-246``).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

IMAGE_LENGTH = 768
NEAR_DISTANCE = 200

CATEGORIES_UNMOVABLE = ["house", "bus", "truck", "car", "bench", "chair"]
CATEGORIES_TREE = ["tree"]
CATEGORIES_MOVABLE = ["people", "horse", "cow", "sheep", "pig", "cat", "dog",
                      "chicken", "duck", "rabbit", "bird", "butterfly"]
GROUND_CATEGORIES = CATEGORIES_UNMOVABLE + CATEGORIES_TREE + CATEGORIES_MOVABLE
INSTANCE = GROUND_CATEGORIES + ["cloud", "sun", "moon", "star"] \
    + ["road", "grass"] + ["others"]

NUMBER = [" ", "two", "three", "four", "five", "six", "Seven", "Eight",
          "Nine", "Ten", "Eleven", "Twelve", "Thirteen", "Fourteen",
          "Fifteen", "Sixteen", "Seventeen", "Eighteen", "Nineteen", "Twenty"]

RELATIVE_DIRECTIONS = ["left front", "front", "right front", "right", "left",
                       "left back", "back", "right back"]
DIRECTIONS = ["on the left front of", "in front of", "on the right front of",
              "on the right of", "on", "under", "on the left of",
              "on the left back of", "behind", "on the right back of"]
PSEUDO_DIRECTIONS = ["around", "among"]
HORIZONTAL_DIRECTIONS = ["leftmost", "left second", "middle", "right second",
                         "rightmost"]
VERTICAL_DIRECTIONS = ["topmost", "top second", "middle", "bottom second",
                       "bottommost"]


def opposite_relative_direction(d: str) -> str:
    return RELATIVE_DIRECTIONS[len(RELATIVE_DIRECTIONS) - 1
                               - RELATIVE_DIRECTIONS.index(d)]


def opposite_direction(d: str) -> str:
    if d in DIRECTIONS:
        return DIRECTIONS[len(DIRECTIONS) - 1 - DIRECTIONS.index(d)]
    if d in PSEUDO_DIRECTIONS:
        return PSEUDO_DIRECTIONS[1 - PSEUDO_DIRECTIONS.index(d)]
    raise ValueError(f"undefined direction {d}")


def single_noun(category: str) -> str:
    return "person" if category == "people" else category


def plural_noun(category: str) -> str:
    if category in ("people", "sheep"):
        return category
    if category.endswith("y"):
        return category[:-1] + "ies"
    if category.endswith("s") or category.endswith("ch"):
        return category + "es"
    return category + "s"


def _spread_indices(total_slots: int, count: int) -> List[int]:
    """Pick rank-name slots for ``count`` items out of 5 positions."""
    return {1: [0], 2: [0, 4], 3: [0, 2, 4], 4: [0, 1, 3, 4],
            5: [0, 1, 2, 3, 4]}[count]


def _angle_deg(ax, ay, bx, by) -> float:
    dx = abs(ax - bx)
    dy = abs(ay - by)
    if dx == 0:
        return 90.0
    return math.atan(dy / dx) / math.pi * 180.0


@dataclass
class SceneItem:
    """One instance: bbox geometry + naming state."""
    category: str
    id: int
    left: float
    top: float
    width: float
    height: float
    is_grouped: bool = False
    num: int = 1
    name: Optional[str] = None
    reference: Optional[Union["SceneItem", "SceneGroup"]] = None
    direction: Optional[str] = None

    # ---- geometry
    @property
    def right(self):
        return self.left + self.width

    @property
    def bottom(self):
        return self.top + self.height

    @property
    def center(self) -> Tuple[float, float]:
        return (self.left + self.width / 2, self.top + self.height / 2)

    @property
    def bottom_center(self) -> Tuple[float, float]:
        return (self.left + self.width / 2, self.bottom)

    def degree_to(self, other: "SceneItem") -> float:
        a, b = self.bottom_center, other.bottom_center
        return _angle_deg(a[0], a[1], b[0], b[1])

    def edge_distance(self, other) -> float:
        other_real_top = other.top if isinstance(other, SceneItem) else other.real_top
        dy = 0.0
        if self.top > other.bottom:
            dy = self.top - other.bottom
        elif self.bottom < other_real_top:
            dy = other_real_top - self.bottom
        dx = 0.0
        if self.left > other.right:
            dx = self.left - other.right
        elif self.right < other.left:
            dx = other.left - self.right
        return math.hypot(dx, dy)

    def is_near(self, other) -> bool:
        return self.edge_distance(other) <= NEAR_DISTANCE

    def is_center_right_of(self, other) -> bool:
        return self.center[0] > other.center[0]

    def is_center_left_of(self, other) -> bool:
        return not self.is_center_right_of(other)

    def is_bottom_edge_below(self, other) -> bool:
        return self.bottom > other.bottom

    def is_bottom_edge_above(self, other) -> bool:
        return not self.is_bottom_edge_below(other)

    def is_center_horizontally_inside(self, other) -> bool:
        return other.left <= self.center[0] <= other.right

    def is_foot_vertically_inside(self, group: "SceneGroup") -> bool:
        return (not self.is_bottom_edge_below(group)
                and self.bottom > group.top)

    def is_horizontal_to(self, other) -> bool:
        if isinstance(other, SceneItem):
            return self.degree_to(other) <= 30
        return other.top <= self.bottom <= other.bottom

    def is_vertical_to(self, other) -> bool:
        if isinstance(other, SceneItem):
            return self.degree_to(other) >= 60
        return self.is_center_horizontally_inside(other)

    # ---- language
    @property
    def be_verb(self):
        return "is"

    def get_single_noun(self):
        return single_noun(self.category)

    def get_noun(self):
        return self.get_single_noun()

    def get_noun_with_num(self, is_sentence_head=False):
        n = self.get_single_noun()
        return n, "a", n

    @property
    def image_position(self) -> str:
        thirds = self.center[0] / (IMAGE_LENGTH / 3.0)
        if thirds <= 1.25:
            pos = "left"
        elif thirds >= 1.75:
            pos = "right"
        else:
            pos = "middle"
        return ("in the " + pos) if pos == "middle" else ("on the " + pos)

    def position_to(self, ref) -> Optional[str]:
        """Relative direction label vs a same-category item/group."""
        if isinstance(ref, SceneGroup):
            return self._position_to_group(ref)
        degree = self.degree_to(ref)
        if self.is_bottom_edge_above(ref):
            if degree > 65:
                return "back"
            if 30 <= degree <= 65:
                return "right back" if self.is_center_right_of(ref) else "left back"
        elif self.is_bottom_edge_below(ref):
            if degree > 65:
                return "front"
            if 30 <= degree <= 65:
                return "right front" if self.is_center_right_of(ref) else "left front"
        if self.is_center_right_of(ref):
            return "right"
        if self.is_center_left_of(ref):
            return "left"
        return None

    def _position_to_group(self, group: "SceneGroup") -> str:
        if self.is_vertical_to(group):
            return "back" if self.is_bottom_edge_above(group) else "front"
        if self.is_horizontal_to(group):
            return "right" if self.is_center_right_of(group) else "left"
        if self.is_center_right_of(group):
            return "right back" if self.is_bottom_edge_above(group) else "right front"
        return "left back" if self.is_bottom_edge_above(group) else "left front"

    def get_name(self, is_sentence_head=False):
        return self.name if not is_sentence_head else "the" + self.name[3:]

    def assign_name(self, num_total, reference=None, index=None,
                    opposite: Optional[str] = None):
        noun = self.get_single_noun()
        if opposite is not None:
            self.name = f"the {opposite_relative_direction(opposite)} {noun}"
            return None
        if num_total == 1:
            self.name = f"the {noun}"
            return None
        if num_total == 2:
            direction = self.position_to(reference)
            self.name = f"the {direction} {noun}"
            return direction
        self.name = f"the left {noun}"
        return None


class SceneGroup:
    """>=2 near same-category items described together."""

    def __init__(self, items: List[SceneItem]):
        assert items
        self.items = items
        self.category = items[0].category
        self.right = max(i.right for i in items)
        self.left = min(i.left for i in items)
        self.real_top = min(i.top for i in items)
        self.top = min(i.bottom for i in items)       # top-most foot
        self.bottom = max(i.bottom for i in items)
        cx = sum(i.left + i.width / 2 for i in items) / len(items)
        cy = sum(i.top + i.height / 2 for i in items) / len(items)
        self._center = (cx, cy)
        self.name: Optional[str] = None
        self.reference = None
        self.direction: Optional[str] = None
        self.near_found = False

    # ---- geometry
    @property
    def num(self):
        return len(self.items)

    @property
    def center(self):
        return self._center

    def degree_to(self, other) -> float:
        a, b = self.center, other.center
        return _angle_deg(a[0], a[1], b[0], b[1])

    edge_distance = SceneItem.edge_distance
    is_near = SceneItem.is_near
    is_center_left_of = SceneItem.is_center_left_of
    is_center_right_of = SceneItem.is_center_right_of

    def is_bottom_edge_above(self, group) -> bool:
        return self.bottom < group.bottom

    def is_center_horizontally_cover(self, other) -> bool:
        return self.left <= other.center[0] <= self.right

    def is_center_horizontally_inside(self, other) -> bool:
        return other.left <= self.center[0] <= other.right

    def is_foot_vertically_cover(self, group) -> bool:
        return self.top <= group.bottom <= self.bottom

    def is_foot_vertically_inside(self, group) -> bool:
        return group.top <= self.bottom <= group.bottom

    def is_around(self, other) -> bool:
        return (self.is_center_horizontally_cover(other)
                and self.is_foot_vertically_cover(other))

    def is_among(self, group: "SceneGroup") -> bool:
        return (self.is_center_horizontally_inside(group)
                and self.is_foot_vertically_inside(group))

    def is_vertical_to(self, other) -> bool:
        if isinstance(other, SceneItem):
            return self.degree_to(other) >= 60
        return (self.is_center_horizontally_cover(other)
                or self.is_center_horizontally_inside(other))

    def is_horizontal_to(self, other) -> bool:
        if isinstance(other, SceneItem):
            return self.degree_to(other) <= 30
        return other.top <= self.center[1] <= other.bottom

    # ---- language
    @property
    def be_verb(self):
        return "are"

    def get_plural_noun(self):
        return plural_noun(self.category)

    def get_noun(self):
        return self.get_plural_noun()

    def get_noun_with_num(self, is_sentence_head=False):
        count = NUMBER[self.num - 1] if self.num < 6 else ""
        return f"{count} {self.get_plural_noun()}", count, self.get_plural_noun()

    image_position = SceneItem.image_position

    def position_to(self, other) -> str:
        if isinstance(other, SceneItem):
            return opposite_relative_direction(other.position_to(self))
        if self.is_vertical_to(other):
            return "back" if self.is_bottom_edge_above(other) else "front"
        return "right" if self.is_center_right_of(other) else "left"

    def get_name(self, is_sentence_head=False):
        return self.name if not is_sentence_head else "the" + self.name[3:]

    def assign_name(self, num_total, reference=None, index=None,
                    opposite: Optional[str] = None):
        noun = self.get_plural_noun()
        if opposite is not None:
            self.name = f"the {opposite_relative_direction(opposite)} {noun}"
            return None
        if num_total == 1:
            self.name = f"the {noun}"
            return None
        if num_total == 2:
            direction = self.position_to(reference)
            self.name = f"the {direction} {noun}"
            return direction
        self.name = f"the left {noun}"
        return None

    # ---- internal reference assignment
    def _spread_is_horizontal(self) -> bool:
        height = self.bottom - self.real_top
        by_bottom = sorted(self.items, key=lambda i: i.bottom)
        gap = sum(by_bottom[k].bottom - by_bottom[k - 1].bottom
                  for k in range(1, len(by_bottom)))
        return not gap > 0.5 * height

    def assign_member_directions(self, reference_candidates=None,
                                 sibling_groups=None):
        """Per-item direction labels (+ optional 'near' landmark for
        movables) -- reference ``ItemGroup.find_reference``."""
        n = len(self.items)
        if self.category == "house" and n < 6:
            self.items.sort(key=lambda i: i.left)
            slots = _spread_indices(5, n)
            for idx, item in enumerate(self.items):
                item.direction = HORIZONTAL_DIRECTIONS[slots[idx]]
            if n == 2:
                self.items[0].direction = "left"
                self.items[1].direction = "right"
        elif self.category in GROUND_CATEGORIES and n < 6:
            if n == 2:
                self.items.sort(key=lambda i: i.left)
                self.items[0].direction = "left"
                self.items[1].direction = "right"
            else:
                if self._spread_is_horizontal():
                    self.items.sort(key=lambda i: i.left)
                    names = HORIZONTAL_DIRECTIONS
                else:
                    self.items.sort(key=lambda i: i.bottom)
                    names = VERTICAL_DIRECTIONS
                slots = _spread_indices(5, n)
                for idx, item in enumerate(self.items):
                    item.direction = names[slots[idx]]

                if self.category in CATEGORIES_MOVABLE:
                    self.near_found = False
                    for idx, item in enumerate(self.items):
                        others = [o for k, o in enumerate(self.items) if k != idx]
                        for pool in (reference_candidates, sibling_groups):
                            if pool is None or self.near_found:
                                continue
                            for landmark in pool:
                                if not isinstance(landmark, SceneItem):
                                    continue
                                other_min = min(landmark.edge_distance(o)
                                                for o in others)
                                mine = landmark.edge_distance(item)
                                if other_min - mine >= 50 and mine <= 50:
                                    item.reference = landmark
                                    self.near_found = True
                                    break
                        if self.near_found:
                            break


Entity = Union[SceneItem, SceneGroup]


def direction_of(this: Entity, that: Entity) -> str:
    """Direction phrase of ``that`` relative to ``this``
    (reference ``ItemCollection.get_dir_of``)."""
    if isinstance(that, SceneItem):
        if (this.category == "tree" and isinstance(this, SceneGroup)
                and that.is_center_horizontally_inside(this)
                and that.is_foot_vertically_inside(this)):
            return "among"
        if that.is_vertical_to(this):
            return "behind" if that.is_bottom_edge_above(this) else "in front of"
        if that.is_horizontal_to(this):
            return ("on the right of" if that.is_center_right_of(this)
                    else "on the left of")
        if that.is_center_right_of(this):
            return ("on the right back of" if that.is_bottom_edge_above(this)
                    else "on the right front of")
        return ("on the left back of" if that.is_bottom_edge_above(this)
                else "on the left front of")

    # that: group
    if isinstance(this, SceneItem):
        return opposite_direction(direction_of(that, this))
    if that.category == "tree" and that.is_around(this):
        return "around"
    if this.category == "tree" and that.is_among(this):
        return "among"
    if that.is_vertical_to(this):
        return "behind" if that.is_bottom_edge_above(this) else "in front of"
    return "on the right of" if that.is_center_right_of(this) else "on the left of"


def _group_near_items(items: List[SceneItem]) -> Dict[str, List[Entity]]:
    """BFS-merge near same-category items (reference ``_merge_same_item``)."""
    groups: Dict[str, List[Entity]] = {}
    remaining = set(range(len(items)))
    order = sorted(remaining)
    while remaining:
        seed = min(remaining)
        remaining.discard(seed)
        members = [seed]
        frontier = [seed]
        cat = items[seed].category
        while frontier:
            cur = frontier.pop(0)
            for j in sorted(remaining):
                if (items[j].category == cat
                        and items[j].is_near(items[cur])
                        and not items[j].is_grouped):
                    items[j].is_grouped = True
                    members.append(j)
                    frontier.append(j)
            remaining -= set(members)
        groups.setdefault(cat, [])
        if len(members) > 1:
            groups[cat].append(SceneGroup([items[m] for m in members]))
        else:
            groups[cat].append(items[members[0]])
    return groups


def _sorted_collection(groups: Dict[str, List[Entity]]) -> List[Entity]:
    out: List[Entity] = []
    for cat in GROUND_CATEGORIES:
        if cat in groups:
            out.extend(sorted(groups[cat], key=lambda e: e.left))
    return out


def _assign_names(groups: Dict[str, List[Entity]]) -> None:
    for cat, lst in groups.items():
        if len(lst) == 1:
            lst[0].assign_name(1)
        elif len(lst) == 2:
            direction = lst[0].assign_name(2, reference=lst[1])
            lst[1].assign_name(2, opposite=direction)
        else:
            for idx, e in enumerate(sorted(lst, key=lambda x: x.bottom)):
                e.assign_name(len(lst), index=idx)


class GroundCollection:
    """One big category's entities + reference wiring + description emission
    (reference ``ItemCollection``)."""

    def __init__(self, groups: Dict[str, List[Entity]],
                 unmovable_refs: Optional[List[Entity]] = None,
                 tree_refs: Optional[List[Entity]] = None):
        self.groups = groups
        if not groups:
            self.collection: List[Entity] = []
            return
        _assign_names(groups)
        self.collection = _sorted_collection(groups)

        if unmovable_refs is None and tree_refs is None:
            self._wire_unmovable()
        elif tree_refs is None:
            self._wire_tree(unmovable_refs)
        else:
            self._wire_movable(unmovable_refs + tree_refs)

    # ---- reference wiring per mode
    def _wire_unmovable(self):
        for idx, cur in enumerate(self.collection):
            if idx != 0:
                nearest = min(self.collection[:idx],
                              key=lambda x: cur.edge_distance(x))
                cur.direction = direction_of(nearest, cur)
                cur.reference = nearest
            if isinstance(cur, SceneGroup):
                cur.assign_member_directions()

    def _wire_tree(self, unmovable_refs):
        if not unmovable_refs:
            for idx, cur in enumerate(self.collection):
                if idx != 0:
                    nearest = min(self.collection[:idx],
                                  key=lambda x: cur.edge_distance(x))
                    cur.direction = direction_of(nearest, cur)
                    cur.reference = nearest
                if isinstance(cur, SceneGroup) and len(cur.items) > 1:
                    cur.assign_member_directions()
        else:
            for cur in self.collection:
                nearest = min(unmovable_refs,
                              key=lambda x: cur.edge_distance(x))
                cur.direction = direction_of(nearest, cur)
                cur.reference = nearest
                if isinstance(cur, SceneGroup) and len(cur.items) > 1:
                    cur.assign_member_directions()

    def _wire_movable(self, candidates):
        if not candidates:
            for idx, cur in enumerate(self.collection):
                if idx >= 1:
                    former = self.collection[idx - 1]
                    cur.direction = direction_of(former, cur)
                    cur.reference = former
                if isinstance(cur, SceneGroup):
                    cur.assign_member_directions()
        else:
            for idx, cur in enumerate(self.collection):
                nearest = min(candidates, key=lambda x: cur.edge_distance(x))
                cur.direction = direction_of(nearest, cur)
                cur.reference = nearest
                if isinstance(cur, SceneGroup):
                    siblings = [e for k, e in enumerate(self.collection)
                                if k != idx]
                    cur.assign_member_directions(candidates, siblings)

    # ---- emission
    @staticmethod
    def _ids(e: Entity) -> List[int]:
        return [e.id] if isinstance(e, SceneItem) else [i.id for i in e.items]

    def describe(self) -> Dict[str, list]:
        sorted_indices: List[int] = []
        sentence_map: List[List[int]] = []
        sentences: List[str] = []

        if not self.collection:
            return {"des": "", "sorted_indices": [], "sen_instIdx_map": []}

        # categories split into >=2 entities get a both/all-the-plural line
        for cat, lst in self.groups.items():
            if len(lst) > 1:
                all_ids = [i for e in lst for i in self._ids(e)]
                _, _, noun = lst[0].get_noun_with_num(is_sentence_head=True)
                word = "both" if len(all_ids) == 2 else "all"
                sentences.append(f" {word} the {noun}.")
                sentence_map.append(all_ids)

        for entity in self.collection:
            noun_with_num, num_phrase, noun_phrase = \
                entity.get_noun_with_num(is_sentence_head=True)
            description = ""

            if entity.reference is not None:
                if (entity.category == "tree"
                        and entity.reference.category == "tree"):
                    d = entity.direction
                    if "of" in d:
                        d = d[:-3]
                    if "behind" in d:
                        d = "on " + d
                    description += f"the {noun_with_num} {d}."
                elif entity.category in ("bird", "butterfly"):
                    description += (f"the {noun_with_num} near "
                                    f"{entity.reference.get_name()}.")
                else:
                    description += (f"the {noun_with_num} {entity.direction} "
                                    f"{entity.reference.get_name()}.")
                sentence_map.append(self._ids(entity))

            description += f" the {noun_with_num} {entity.image_position}."
            sorted_indices.extend(self._ids(entity))
            sentence_map.append(self._ids(entity))

            if isinstance(entity, SceneItem):
                if len(self.groups[entity.category]) == 1:
                    description += f" the {noun_with_num}."
                    sentence_map.append([entity.id])
            else:
                if len(self.groups[entity.category]) == 1:
                    word = "both" if num_phrase == "two" else "all"
                    description += f" {word} the {noun_with_num}."
                    sentence_map.append(self._ids(entity))
                    description += f" {word} the {noun_phrase}."
                    sentence_map.append(self._ids(entity))
                    description += f" the {noun_with_num}."
                    sentence_map.append(self._ids(entity))
                    description += f" the {noun_phrase}."
                    sentence_map.append(self._ids(entity))

                if len(entity.items) < 6:
                    description += self._describe_members(entity, sentence_map)

            sentences.append(description)

        return {"des": " ".join(sentences),
                "sorted_indices": sorted_indices,
                "sen_instIdx_map": sentence_map}

    def _describe_members(self, group: SceneGroup,
                          sentence_map: List[List[int]]) -> str:
        description = ""
        group_dir_ref = ""
        if group.reference is not None and len(self.groups[group.category]) > 1:
            group_dir_ref = f"{group.direction} {group.reference.get_name()}"

        many = len(group.items) > 2
        for item in group.items:
            noun = item.get_noun()
            direction = item.direction
            sentence_map.append([item.id])

            if item.category == "house" or (
                    item.category in GROUND_CATEGORIES and many):
                if item.reference is not None:
                    description += (f" the {noun} near "
                                    f"{item.reference.get_name()}.")
                elif group_dir_ref != "":
                    if direction in (HORIZONTAL_DIRECTIONS
                                     + VERTICAL_DIRECTIONS
                                     + ["left", "right"]):
                        description += (f" the {direction} {noun} "
                                        f"{group_dir_ref}.")
                else:
                    if len(self.groups[group.category]) == 1:
                        if "second" not in direction:
                            prep = "in" if direction == "middle" else "on"
                            description += f" the {noun} {prep} the {direction}."
                            description += f" the {direction} {noun}."
                            sentence_map.append([item.id])
                        else:
                            side = direction[:direction.find("second") - 1]
                            description += (f" the second {noun} on the "
                                            f"{side}.")
                    else:
                        sentence_map.pop()
            else:
                # two-item groups
                if item.reference is not None:
                    description += (f" the {noun} {direction} "
                                    f"{item.reference.get_name()}.")
                elif group_dir_ref != "":
                    description += f" the {direction} {noun} {group_dir_ref}."
                else:
                    if len(self.groups[group.category]) == 1:
                        if "of" in direction:
                            description += f" the {noun} {direction[:-3]}."
                        elif "behind" in direction:
                            description += f" the {noun} on {direction}."
                        elif "left" in direction or "right" in direction:
                            description += f" the {noun} on the {direction}."
                            description += f" the {direction} {noun}."
                            sentence_map.append([item.id])
                    else:
                        sentence_map.pop()
        return description


class SceneDescriber:
    """Full-scene caption emission (reference ``ImageToText``)."""

    def __init__(self, items: List[SceneItem]):
        self.items = items
        self.sorted_indices: List[int] = []
        self.sen_instIdx_map: List[List[int]] = []

    def _emit(self, texts: List[str], sentence: str, ids: List[int]):
        texts.append(sentence)
        self.sen_instIdx_map.append(ids)
        self.sorted_indices.extend(ids)

    def _sky_singles(self) -> str:
        by_cat = {c: [i.id for i in self.items if i.category == c]
                  for c in ("sun", "moon", "cloud", "star")}
        texts: List[str] = []
        for cat in ("sun", "moon", "cloud"):
            ids = by_cat[cat]
            if len(ids) == 1:
                self._emit(texts, f"the {cat} in the sky.", ids)
                self._emit(texts, f"the {cat}.", ids)
            elif len(ids) >= 2:
                self._emit(texts, f"the {plural_noun(cat)}.", ids)
                word = "both" if len(ids) == 2 else "all"
                self._emit(texts, f"{word} the {plural_noun(cat)}.", ids)
        star_ids = by_cat["star"]
        if len(star_ids) == 1:
            self._emit(texts, "the star in the sky.", star_ids)
            self._emit(texts, "the star.", star_ids)
        elif len(star_ids) >= 2:
            self._emit(texts, "the stars in the sky.", star_ids)
            self._emit(texts, "the stars.", star_ids)
            word = "both" if len(star_ids) == 2 else "all"
            self._emit(texts, f"{word} the stars.", star_ids)
        return " ".join(texts)

    def _ground_items(self) -> str:
        ground = [i for i in self.items if i.category in GROUND_CATEGORIES]
        unmovable = _group_near_items(
            [i for i in ground if i.category in CATEGORIES_UNMOVABLE])
        trees = _group_near_items(
            [i for i in ground if i.category in CATEGORIES_TREE])
        movable = _group_near_items(
            [i for i in ground if i.category in CATEGORIES_MOVABLE])

        unmov_coll = GroundCollection(unmovable)
        tree_coll = GroundCollection(trees,
                                     _sorted_collection(unmovable))
        mov_coll = GroundCollection(movable,
                                    _sorted_collection(unmovable),
                                    _sorted_collection(trees))

        parts = []
        for coll in (unmov_coll, tree_coll, mov_coll):
            res = coll.describe()
            self.sorted_indices.extend(res["sorted_indices"])
            self.sen_instIdx_map.extend(res["sen_instIdx_map"])
            if res["des"]:
                parts.append(res["des"])
        return " ".join(parts)

    def _grass_road(self) -> str:
        grass_ids = [i.id for i in self.items if i.category == "grass"]
        road_ids = [i.id for i in self.items if i.category == "road"]
        texts: List[str] = []
        if len(grass_ids) == 1:
            self._emit(texts, "the grass.", grass_ids)
        elif len(grass_ids) >= 2:
            self._emit(texts, "the grasses.", grass_ids)
            word = "both" if len(grass_ids) == 2 else "all"
            self._emit(texts, f"{word} the grass.", grass_ids)
        if road_ids:
            self._emit(texts, "the road.", road_ids)
        return " ".join(texts)

    def get_text(self) -> Tuple[str, List[int], List[List[int]]]:
        self.sorted_indices = []
        self.sen_instIdx_map = []
        parts = [self._sky_singles(), self._ground_items(), self._grass_road()]
        return (" ".join(p for p in parts if p),
                self.sorted_indices, self.sen_instIdx_map)


def load_categories_map(dataset_base_dir: str) -> Dict[int, str]:
    """1-based class-id -> name from colorMapC46.mat
    (reference ``init_categories_map``)."""
    import scipy.io
    color_map = scipy.io.loadmat(
        os.path.join(dataset_base_dir, "colorMapC46.mat"))["colorMap"]
    return {i + 1: color_map[i][0][0] for i in range(len(color_map))}


def init_all_items(pred_boxes, pred_class_ids,
                   categories_map: Dict[int, str]) -> List[SceneItem]:
    """Boxes [N, (y1,x1,y2,x2)] + 1-based class ids -> valid SceneItems."""
    items = []
    for i in range(len(pred_class_ids)):
        category = categories_map[int(pred_class_ids[i])]
        if category in INSTANCE:
            y1, x1, y2, x2 = (float(v) for v in pred_boxes[i])
            items.append(SceneItem(category=category, id=i, left=x1, top=y1,
                                   width=x2 - x1, height=y2 - y1))
    return items


def png2text(pred_boxes, pred_class_ids, dataset_base_dir: str):
    """Scene layout -> (full caption, sorted instance order,
    sentence->instance map)."""
    items = init_all_items(pred_boxes, pred_class_ids,
                           load_categories_map(dataset_base_dir))
    return SceneDescriber(items).get_text()
