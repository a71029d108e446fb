"""Sentence METEOR — a copy of nltk 3.10.0's
`nltk/translate/meteor_score.py` (Lavie and Agarwal, 2007): `str.lower`
on every token, then the exact, Porter-stem and wordnet-synonym stages
in that order, each matching hypothesis words from the last one back to
the highest still-unused reference position of the same form (which
decides ties between repeated words); the chunk count of the sorted
matches; F-mean with alpha 0.9 and the fragmentation penalty
gamma · frag^beta with beta 3 and gamma 0.5; the max over references.

`wordnet` is any object with nltk's `synsets(word)` (synsets with
`lemmas()`, lemmas with `name()`): `nltk.corpus.wordnet` where that
corpus is installed, else `EmptyWordnet`, whose synonym stage finds
nothing (the caller chooses, `eval/scorer.py`).
"""

from __future__ import annotations

from collections import defaultdict
from itertools import chain
from typing import Iterable, List, Tuple

from imagecaptioning_tpu_torch.eval.porter import PorterStemmer

Enum = List[Tuple[int, str]]


class EmptyWordnet:
    """A wordnet with no synsets: METEOR aligns by its exact and stem
    stages only."""

    def synsets(self, word):
        return []


def _generate_enums(hypothesis: Iterable[str], reference: Iterable[str]):
    if isinstance(hypothesis, str):
        raise TypeError('"hypothesis" expects pre-tokenized hypothesis '
                        f"(Iterable[str]): {hypothesis}")
    if isinstance(reference, str):
        raise TypeError('"reference" expects pre-tokenized reference '
                        f"(Iterable[str]): {reference}")
    return (list(enumerate(map(str.lower, hypothesis))),
            list(enumerate(map(str.lower, reference))))


def _unmatched(enum: Enum, matched: set) -> Enum:
    return [pair for i, pair in enumerate(enum) if i not in matched]


def _match_enums(hyp: Enum, ref: Enum):
    """Exact matches: each hypothesis word, last first, takes the highest
    unused reference position of the same form → (matches, unmatched
    hypothesis, unmatched reference)."""
    word_match = []
    ref_positions = defaultdict(list)
    for j, (_, ref_word) in enumerate(ref):
        ref_positions[ref_word].append(j)
    matched_hyp, matched_ref = set(), set()
    for i in range(len(hyp))[::-1]:
        positions = ref_positions.get(hyp[i][1])
        if positions:
            j = positions.pop()
            matched_hyp.add(i)
            matched_ref.add(j)
            word_match.append((hyp[i][0], ref[j][0]))
    return word_match, _unmatched(hyp, matched_hyp), _unmatched(ref,
                                                                matched_ref)


def _enum_stem_match(hyp: Enum, ref: Enum, stemmer):
    return _match_enums([(i, stemmer.stem(w)) for i, w in hyp],
                        [(j, stemmer.stem(w)) for j, w in ref])


def _enum_wordnetsyn_match(hyp: Enum, ref: Enum, wordnet):
    """Synonym matches: a hypothesis word (last first) takes the highest
    unused reference position whose word is one of its synonyms (lemma
    names without '_') or itself."""
    word_match = []
    ref_positions = defaultdict(list)
    for j, (_, ref_word) in enumerate(ref):
        ref_positions[ref_word].append(j)
    matched_hyp, matched_ref = set(), set()
    for i in range(len(hyp))[::-1]:
        syns = set(chain.from_iterable(
            (lemma.name() for lemma in synset.lemmas()
             if lemma.name().find("_") < 0)
            for synset in wordnet.synsets(hyp[i][1]))).union({hyp[i][1]})
        best_j, best_word = -1, None
        for syn in syns:
            positions = ref_positions.get(syn)
            if positions and positions[-1] > best_j:
                best_j, best_word = positions[-1], syn
        if best_word is not None:
            ref_positions[best_word].pop()
            matched_hyp.add(i)
            matched_ref.add(best_j)
            word_match.append((hyp[i][0], ref[best_j][0]))
    return word_match, _unmatched(hyp, matched_hyp), _unmatched(ref,
                                                                matched_ref)


def _enum_align_words(hyp: Enum, ref: Enum, stemmer, wordnet):
    """The three stages in nltk's order → (matches sorted by hypothesis
    position, unmatched hypothesis, unmatched reference)."""
    exact, hyp, ref = _match_enums(hyp, ref)
    stem, hyp, ref = _enum_stem_match(hyp, ref, stemmer)
    syn, hyp, ref = _enum_wordnetsyn_match(hyp, ref, wordnet)
    return sorted(exact + stem + syn, key=lambda pair: pair[0]), hyp, ref


def _count_chunks(matches) -> int:
    """The fewest chunks of matches adjacent in both sentences."""
    i, chunks = 0, 1
    while i < len(matches) - 1:
        if (matches[i + 1][0] == matches[i][0] + 1
                and matches[i + 1][1] == matches[i][1] + 1):
            i += 1
            continue
        i += 1
        chunks += 1
    return chunks


_STEMMER = PorterStemmer()
ALPHA, BETA, GAMMA = 0.9, 3.0, 0.5


def single_meteor_score(reference: Iterable[str], hypothesis: Iterable[str],
                        wordnet=None) -> float:
    """METEOR of one tokenized hypothesis against one reference; 0.0
    where nothing matches."""
    wordnet = EmptyWordnet() if wordnet is None else wordnet
    alpha, beta, gamma = ALPHA, BETA, GAMMA
    enum_hyp, enum_ref = _generate_enums(hypothesis, reference)
    translation_length = len(enum_hyp)
    reference_length = len(enum_ref)
    matches, _, _ = _enum_align_words(enum_hyp, enum_ref, _STEMMER, wordnet)
    matches_count = len(matches)
    try:
        precision = float(matches_count) / translation_length
        recall = float(matches_count) / reference_length
        fmean = (precision * recall) / (alpha * precision
                                        + (1 - alpha) * recall)
        chunk_count = float(_count_chunks(matches))
        frag_frac = chunk_count / matches_count
    except ZeroDivisionError:
        return 0.0
    penalty = gamma * frag_frac ** beta
    return (1 - penalty) * fmean


def meteor_score(references: Iterable[Iterable[str]],
                 hypothesis: Iterable[str], wordnet=None) -> float:
    """The best `single_meteor_score` over the references."""
    return max(single_meteor_score(reference, hypothesis, wordnet=wordnet)
               for reference in references)
