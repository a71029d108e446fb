"""METEOR for the dense evaluators — copy of `meteor_pair` and
`scorer_provenance` in `imagecaptioning_tpu/eval/scorer.py:20-57`
(NLTK's sentence METEOR, the reference's protocol). `nltk` is imported
only when a score is asked for.
"""

from __future__ import annotations

from typing import Dict

_PROVENANCE_CACHE: Dict = {}


class _EmptyWordnet:
    """Wordnet stand-in when the NLTK corpus is unavailable offline:
    METEOR still aligns via its exact and Porter-stem stages, only the
    synonym stage finds nothing."""

    def synsets(self, word):
        return []


def scorer_provenance() -> Dict:
    """Which METEOR path this host runs: with the wordnet corpus, or the
    `_EmptyWordnet` degradation. Stamped into every eval result, since
    scores without wordnet run a touch lower and must not be compared
    with scores with it."""
    if not _PROVENANCE_CACHE:
        import nltk
        try:
            from nltk.corpus import wordnet
            wordnet.synsets("dog")
            available = True
        except LookupError:
            available = False
        _PROVENANCE_CACHE.update({"wordnet_available": available,
                                  "nltk": nltk.__version__})
    return dict(_PROVENANCE_CACHE)


def meteor_pair(references_tok, candidate_tok) -> float:
    from nltk.translate.meteor_score import meteor_score
    try:
        return float(meteor_score(references_tok, candidate_tok))
    except LookupError:      # no wordnet corpus on this host
        return float(meteor_score(references_tok, candidate_tok,
                                  wordnet=_EmptyWordnet()))
