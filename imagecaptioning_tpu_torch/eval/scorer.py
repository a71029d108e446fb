"""Caption scoring — copy of `imagecaptioning_tpu/eval/scorer.py`, over
the port's own METEOR and BLEU (`eval/meteor.py`, `eval/bleu.py`,
`eval/porter.py`: nltk 3.10.0's algorithms, to the last bit).

- `meteor_pair` and `scorer_provenance`: sentence METEOR, the
  reference's protocol, for the dense evaluators and the AlexCap one.
  Its synonym stage reads `nltk.corpus.wordnet` where nltk and that
  corpus import, else it finds nothing (`EmptyWordnet`), as the JAX
  package does on a host without the corpus; a host without nltk at all
  counts as one without the corpus.
- `score_captions` and `CaptioningEvaluator`: the AlexCap protocol
  (`AlexCap/eval/eval_resnet.py:108-123`): per (candidate, references)
  pair, `meteor_score` and `sentence_bleu(smoothing_function=method4)`,
  averaged over the records (an empty candidate scores 0), beside the
  corpus BLEU-4 (method1 smoothing) and CIDEr-D of the JAX package. The
  pairs are scored in a thread pool.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from imagecaptioning_tpu_torch.eval.bleu import (SmoothingFunction,
                                                 corpus_bleu, sentence_bleu)
from imagecaptioning_tpu_torch.eval.cider import CiderD
from imagecaptioning_tpu_torch.eval.meteor import EmptyWordnet, meteor_score

_HOST: Dict = {}


def _host() -> Dict:
    """nltk's version (None without nltk) and its wordnet corpus where it
    loads, else an `EmptyWordnet`; looked up once."""
    if not _HOST:
        try:
            import nltk
            version = nltk.__version__
        except ImportError:
            version = None
        wordnet = EmptyWordnet()
        if version is not None:
            try:
                from nltk.corpus import wordnet as corpus
                corpus.synsets("dog")
                wordnet = corpus
            except LookupError:
                pass
        _HOST.update(nltk=version, wordnet=wordnet)
    return _HOST


def scorer_provenance() -> Dict:
    """Which METEOR path this host runs: with the wordnet corpus, or
    without its synonym stage. Stamped into every eval result, since
    scores without wordnet run a touch lower and must not be compared
    with scores with it."""
    host = _host()
    return {"wordnet_available": not isinstance(host["wordnet"],
                                                EmptyWordnet),
            "nltk": host["nltk"]}


def meteor_pair(references_tok, candidate_tok) -> float:
    return float(meteor_score(references_tok, candidate_tok,
                              wordnet=_host()["wordnet"]))


def _score_pair(candidate: str, references: Sequence[str]):
    cand_tok = candidate.split()
    refs_tok = [r.split() for r in references]
    if not cand_tok or not any(refs_tok):
        return 0.0, 0.0
    meteor = meteor_pair(refs_tok, cand_tok)
    bleu = sentence_bleu(refs_tok, cand_tok,
                         smoothing_function=SmoothingFunction().method4)
    return float(meteor), float(bleu)


def _corpus_scores(records: Sequence[Dict]) -> Dict:
    """Corpus BLEU-4 (method1 smoothing) and CIDEr-D. Records with an
    empty candidate count (scored 0, as pycocoevalcap does); records with
    no non-empty reference are dropped."""
    cands = [r["candidate"].split() for r in records]
    refs = [[x.split() for x in r["references"]] for r in records]
    pairs = [(c, [r for r in rs if r]) for c, rs in zip(cands, refs)
             if any(rs)]
    if not pairs or not any(c for c, _ in pairs):
        return {"bleu4": 0.0, "cider": 0.0}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bleu4 = float(corpus_bleu(
            [rs for _, rs in pairs], [c for c, _ in pairs],
            smoothing_function=SmoothingFunction().method1))
    cider = CiderD()
    for c, rs in pairs:
        cider.add(c, rs)
    return {"bleu4": bleu4, "cider": cider.compute()[0]}


def score_captions(records: Sequence[Dict], num_workers: int = 8) -> Dict:
    """records [{'candidate': str, 'references': [str, ...]}, ...] →
    {'meteor': mean, 'bleu': mean sentence BLEU, 'bleu4': corpus BLEU-4,
    'cider': CIDEr-D, 'scorer': provenance}."""
    if not records:
        return {"meteor": 0.0, "bleu": 0.0, "bleu4": 0.0, "cider": 0.0,
                "scorer": scorer_provenance()}
    _host()                     # once, before the threads
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        scores = list(pool.map(
            lambda r: _score_pair(r["candidate"], r["references"]), records))
    n = len(scores)
    return {"meteor": sum(s[0] for s in scores) / n,
            "bleu": sum(s[1] for s in scores) / n,
            **_corpus_scores(records),
            "scorer": scorer_provenance()}


@dataclass
class CaptioningEvaluator:
    """Accumulates (prediction, references) records across eval batches
    (the reference's `addResult` contract, `eval_resnet.py:14-26`)."""

    records: List[Dict] = field(default_factory=list)

    def add_result(self, predictions: Sequence[str],
                   references: Sequence[Sequence[str]],
                   ids: Sequence = ()) -> None:
        ids = list(ids) or [None] * len(predictions)
        for pred, refs, rid in zip(predictions, references, ids):
            if isinstance(refs, str):
                refs = [refs]
            self.records.append({"candidate": pred,
                                 "references": list(refs), "id": rid})

    def evaluate(self) -> Dict:
        return score_captions(self.records)
