"""Needle-in-a-haystack corpus generator.

Port of ``hydragen_tpu.data.haystack``, character for character (the same
seeded ``random`` draws, the same document and needle positions): a long
filler document with deterministic dog-fur "needle" facts interleaved at even
character intervals (sentence-aligned), each with a question, a one-word
answer, and its fractional position in the document — used to measure
long-context accuracy by depth decile while the haystack sits in a shared
prefix cache.

Differences by design: needle names are generated combinatorially (the
original benchmark ships a hand-picked list), and the filler text
comes from a corpus file if provided (e.g. a public-domain book) or from a
deterministic synthetic generator — the repo does not vendor a 3.2 MB text.
"""

from __future__ import annotations

import dataclasses
import random
from pathlib import Path
from typing import List, Optional, Tuple

COLORS = ["black", "white", "brown", "yellow", "orange", "red", "green", "blue"]

# Combinatorial two-syllable names, deterministic and collision-free.
_ONSETS = [
    "Bar", "Cal", "Dor", "Fen", "Gar", "Hol", "Jas", "Kel", "Lor", "Mar",
    "Nor", "Pax", "Quin", "Ros", "Sel", "Tor", "Vel", "Wes", "Yor", "Zan",
]
_CODAS = ["by", "den", "fer", "ko", "lan", "mir", "nex", "rick", "son", "ton", "vik", "well", "zer", "dale", "ley"]


def _names(n: int) -> List[str]:
    out = []
    for coda in _CODAS:
        for onset in _ONSETS:
            out.append(onset + coda)
            if len(out) == n:
                return out
    raise ValueError(f"can generate at most {len(_ONSETS) * len(_CODAS)} names")


@dataclasses.dataclass
class Needle:
    sentence: str
    question: str
    answer: str
    position_in_doc: Optional[float] = None


def _build_needles(num: int, seed: int = 9) -> List[Needle]:
    rng = random.Random(seed)
    needles = []
    for name in _names(num):
        color = rng.choice(COLORS)
        needles.append(
            Needle(
                sentence=f"The dog named {name} has fur that is {color}.",
                question=f"What color is the fur of the dog named {name}?",
                answer=color.title(),
            )
        )
    rng.shuffle(needles)
    return needles


def _synthetic_filler(n_chars: int, seed: int = 9) -> str:
    """Deterministic filler prose (used when no corpus file is available)."""
    rng = random.Random(seed + 1)
    subjects = ["the river", "a traveler", "the old mill", "the village", "a merchant",
                "the winter", "the orchard", "a letter", "the festival", "the road"]
    verbs = ["wound through", "remembered", "overlooked", "welcomed", "carried",
             "outlasted", "sheltered", "reached", "followed", "crossed"]
    objects = ["the valley", "distant hills", "a quiet harbor", "the northern woods",
               "an early frost", "the market square", "a narrow bridge", "the open plain"]
    parts = []
    total = 0
    while total < n_chars:
        s = f"In those days {rng.choice(subjects)} {rng.choice(verbs)} {rng.choice(objects)}."
        parts.append(s)
        total += len(s) + 1
    return " ".join(parts)


def make_needle_haystack(
    target_context_length: int,
    num_needles: int,
    corpus_path: Optional[str] = None,
) -> Tuple[str, List[Needle]]:
    """Build (document, needles).

    Needle 0 opens the document; the rest are interleaved every
    ``target_context_length // (num_needles - 1)`` chars, aligned to sentence
    boundaries of the filler. Each needle records its fractional position.
    """
    assert num_needles > 2

    if corpus_path is not None:
        content = Path(corpus_path).read_text()
    else:
        content = _synthetic_filler(target_context_length * 2)

    needles = _build_needles(num_needles)
    results = [needles[0].sentence]
    block = target_context_length // (num_needles - 1)

    # The interleave walk consumes up to target + one block (plus a sentence
    # boundary search); a short corpus would index past the end — extend it
    # with synthetic filler (which is sentence-terminated) instead.
    need = target_context_length + 2 * block + 1024
    if len(content) < need:
        content = content.rstrip() + ". " + _synthetic_filler(need - len(content))

    lo, hi = 0, block
    positions = [0]
    for needle in needles[1:]:
        while content[hi] != ".":
            hi += 1
        results.append(content[lo : hi + 1])
        positions.append(sum(len(x) for x in results))
        results.append(needle.sentence)
        lo = hi + 1
        hi += block + 1

    doc = " ".join(results).replace("\n", " ").replace("  ", " ").strip()
    for needle, pos in zip(needles, positions):
        needle.position_in_doc = pos / len(doc)
    return doc, needles
