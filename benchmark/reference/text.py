"""The reference system's text handling, frozen for the benchmark: the two
sentence encodings (matching: end-padded with its true length;
colorization: front-padded, 'a' and 'the' dropped), the FG/BG router, the
FG text split and the BG sky/ground merge (``Instance_Matching`` and
``Pipeline_utils`` of "Language-based Colorization of Scene Sketches").
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_SPLIT = re.compile(r"(\W+)")

CATEGORY_LIST = [
    "bench", "bird", "bus", "butterfly", "car", "cat", "chair", "chicken",
    "cloud", "cow", "dog", "duck", "horse", "house", "grass", "moon",
    "person", "pig", "rabbit", "road", "sheep", "star", "sun", "tree",
    "truck"]
CATEGORY_ES_LIST = [
    "benches", "birds", "buses", "butterflies", "cars", "cats", "chairs",
    "chickens", "clouds", "cows", "dogs", "ducks", "horses", "houses",
    "grasses", "moons", "people", "pigs", "rabbits", "roads", "sheep",
    "stars", "suns", "trees", "trucks"]
ES_ATTR = ["both", "all", "two", "three", "four", "five", "six"]
SIMPLE_COLOR_LIST = ["brown", "gray", "black", "red", "green", "blue",
                     "yellow", "orange", "pink", "purple", "cyan", "white"]
BG_COLORS = ["blue", "green", "cyan", "red", "orange", "yellow", "brown",
             "purple", "pink", "black", "gray"]
DEFAULT_BG_TEXT = "the sky is blue and the ground is green"


def load_vocab(path: str) -> Dict[str, int]:
    with open(path) as f:
        return {w.strip(): i for i, w in enumerate(f.readlines())}


def words_of(sentence: str, drop_dash: bool = False) -> List[str]:
    out = [w.lower() for w in _SPLIT.split(sentence.strip())
           if len(w.strip()) > 0]
    return [w for w in out if w != "-"] if drop_dash else out


def matching_encode(sentence: str, vocab, max_len: int) -> Tuple[List[int], int]:
    words = words_of(sentence, drop_dash=True)
    if words and words[-1] == ".":
        words = words[:-1]
    idx = [vocab.get(w, vocab["<unk>"]) for w in words][:max_len]
    return idx + [vocab["<pad>"]] * (max_len - len(idx)), len(idx)


def colorization_encode(sentence: str, vocab, max_len: int) -> List[int]:
    words = words_of(sentence)
    if words and words[-1] == ".":
        words = words[:-1]
    if words and words[0] == "a":
        words = words[1:]
    words = ["and" if w in (",", ", ") else w for w in words if w != "the"]
    idx = [vocab.get(w, vocab["<unk>"]) for w in words][:max_len]
    return [vocab["<pad>"]] * (max_len - len(idx)) + idx


def category_of(caption: str):
    for w in words_of(caption, drop_dash=True):
        if w in CATEGORY_LIST:
            return w
        if w in CATEGORY_ES_LIST:
            return CATEGORY_LIST[CATEGORY_ES_LIST.index(w)]
    return None


def is_fg(text: str) -> bool:
    return category_of(text) is not None


def _has_color(text: str) -> bool:
    return any(w in SIMPLE_COLOR_LIST for w in words_of(text, drop_dash=True))


def fg_color_text(user_text: str) -> str:
    """'the bus on the left is yellow' -> 'the bus is yellow'."""
    cate = category_of(user_text)
    words = words_of(user_text)
    for verb in ("has", "have", "is", "are"):
        if verb in user_text and not ("with" in words and verb in words and
                                      words.index("with") < words.index(verb)):
            i = user_text.index(verb)
            if _has_color(user_text[:i]):
                return user_text
            if _has_color(user_text[i:]):
                return "the " + cate + " " + user_text[i:]
            return user_text
    return user_text


def bg_text_type(text: str) -> str:
    w = words_of(text)
    sky = "sky" in w
    ground = any(g in w for g in ("ground", "floor", "land"))
    return ("None", "ground", "sky", "both")[2 * sky + ground]


def merge_bg_text(new: str, previous: str) -> str:
    kind, prev_kind = bg_text_type(new), bg_text_type(previous)
    if kind == "both":
        return new
    if kind == "sky":
        if prev_kind == "ground":
            return new + " and " + previous
        return new + " " + previous[previous.index("and"):]
    if prev_kind == "sky":
        return previous + " and " + new
    return previous[:previous.index("and")] + "and " + new
