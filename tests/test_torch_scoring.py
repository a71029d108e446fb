"""The port's caption scoring (`eval/porter.py`, `eval/meteor.py`,
`eval/bleu.py`, `eval/scorer.py`, dense `score_records`) against nltk
3.10.0 and the JAX package, bitwise: nltk is the oracle for the
algorithms, the JAX package for the scorers' protocols on this host."""

import glob
import json
import os
import sys
import warnings

import numpy as np
import pytest

nltk = pytest.importorskip("nltk")
from nltk.stem.porter import PorterStemmer as NltkPorter  # noqa: E402
from nltk.translate import bleu_score as nltk_bleu  # noqa: E402
from nltk.translate import meteor_score as nltk_meteor  # noqa: E402

from imagecaptioning_tpu_torch.eval import bleu, meteor  # noqa: E402
from imagecaptioning_tpu_torch.eval import dense_eval, scorer  # noqa: E402
from imagecaptioning_tpu_torch.eval.porter import PorterStemmer  # noqa: E402
import torch_threads  # noqa: E402,F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# irregular forms of the pool, nltk's four-letter -ies/-ied rules, step
# 1c's y, 2's alli/fulli/logi, 4's ion, 5's ll, one- and two-letter
# words, runs of y, upper case and the ties METEOR must break alike
EDGE_FORMS = (
    "sky skies dying lying tying news innings inning outings canning "
    "howe proceed exceed succeed dies died ties tied spies spied flies "
    "happy enjoy spy fly try sly by y yy yyyy syzygy toy boy "
    "radically fully hopefully geology theology archaeology logi "
    "adoption communism controlling roll rolling hopping hissing fizzed "
    "failing filing conflated troubled sized feed agreed bled sing "
    "caresses ponies cats caress relational conditional rational "
    "valenci hesitanci digitizer conformabli differentli vileli "
    "analogousli vietnamization predication operator feudalism "
    "decisiveness hopefulness callousness formaliti sensitiviti "
    "sensibiliti triplicate formative formalize electriciti electrical "
    "hopeful goodness revival allowance inference airliner gyroscopic "
    "adjustable defensible irritant replacement adjustment dependent "
    "homologou activate angulariti homologous effective bowdlerize "
    "probate rate cease controll is as at on a I RIDING Rides men man "
    "riding rides rode generously generalizations oed eed ied ies ing "
    "being seeing quietly ok xx aa"
).split()


def _caption_words(node, out):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "candidate" and isinstance(v, str):
                out.update(v.split())
            elif k == "references" and isinstance(v, list):
                for r in v:
                    if isinstance(r, str):
                        out.update(r.split())
            else:
                _caption_words(v, out)
    elif isinstance(node, list):
        for v in node:
            _caption_words(v, out)


def _words(source):
    from imagecaptioning_tpu_torch.data import synthetic
    if source == "face2text_vocab":
        _, info = synthetic.make_learnable_face2text_arrays(
            num_images=256, image_hw=(24, 20))
        return sorted(info["token_to_idx"])
    if source == "vg_vocab":
        _, info = synthetic.make_learnable_vg_arrays(num_images=64,
                                                     image_size=64)
        return sorted(info["token_to_idx"])
    if source == "evidence_captions":
        words = set()
        for path in glob.glob(os.path.join(REPO, "runs", "evidence",
                                           "*.json")):
            with open(path) as f:
                _caption_words(json.load(f), words)
        assert words, "no captions in runs/evidence"
        return sorted(words)
    return list(EDGE_FORMS) + list(synthetic._WORDS)


@pytest.mark.parametrize("source", ["face2text_vocab", "vg_vocab",
                                    "evidence_captions", "edge_forms"])
def test_porter_equals_nltk(source):
    words = _words(source)
    ours, theirs = PorterStemmer(), NltkPorter()
    got = [ours.stem(w) for w in words]
    want = [theirs.stem(w) for w in words]
    assert got == want


class _Lemma:
    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name


class _Synset:
    def __init__(self, names):
        self._lemmas = [_Lemma(n) for n in names]

    def lemmas(self):
        return self._lemmas


class FakeWordnet:
    """Synonym groups over the test vocabulary (multi-word lemmas with
    '_' included, which both must skip)."""

    GROUPS = (("man", "guy", "bloke", "male_person"),
              ("woman", "lady"), ("big", "large", "great"),
              ("small", "little", "tiny"), ("riding", "sitting"),
              ("photo", "picture", "image"), ("happy", "cheerful", "glad"))

    def synsets(self, word):
        return [_Synset(g) for g in self.GROUPS if word in g]


VOCAB = ("a the man men woman women guy lady is are riding rides rode "
         "sitting on a horse horses big large small little tiny photo "
         "picture of with and happy cheerful glad smiling smile The A "
         "Man RIDING").split()


def _captions(seed, n):
    """Seeded (hypothesis, references) pairs: repeated words, colliding
    stems and synonyms, one to three references, some empty."""
    rng = np.random.RandomState(seed)
    pairs = []
    for _ in range(n):
        def sent():
            k = int(rng.randint(1, 10))
            return [VOCAB[i] for i in rng.randint(0, len(VOCAB), k)]
        hyp = sent()
        if rng.rand() < 0.3:        # repeat a word
            hyp = hyp + [hyp[int(rng.randint(len(hyp)))]]
        refs = [sent() for _ in range(int(rng.randint(1, 4)))]
        pairs.append((hyp, refs))
    return pairs


@pytest.mark.parametrize("wordnet", ["empty", "fake"])
def test_meteor_bitwise(wordnet):
    wn_ours = meteor.EmptyWordnet() if wordnet == "empty" else FakeWordnet()
    wn_theirs = scorer_jax_empty() if wordnet == "empty" else FakeWordnet()
    cases = _captions(7, 400) + [
        # ties between repeated words and colliding stems
        (["the", "man", "rides", "the", "horse", "the"],
         [["the", "men", "riding", "a", "horse", "the", "man"]]),
        (["riding", "rides", "rode", "riding"],
         [["rides", "riding", "riding"]]),
        (["a", "big", "man", "a", "big", "man"],
         [["a", "large", "guy", "a", "man"], ["big", "a", "man"]]),
        (["The", "MAN"], [["the", "man", "the", "man"]]),
    ]
    for hyp, refs in cases:
        got = meteor.meteor_score(refs, hyp, wordnet=wn_ours)
        want = nltk_meteor.meteor_score(refs, hyp, wordnet=wn_theirs)
        assert got == want, (hyp, refs, got, want)
        for ref in refs:
            assert meteor.single_meteor_score(ref, hyp, wordnet=wn_ours) \
                == nltk_meteor.single_meteor_score(ref, hyp,
                                                   wordnet=wn_theirs)


def scorer_jax_empty():
    from imagecaptioning_tpu.eval.scorer import _EmptyWordnet
    return _EmptyWordnet()


def test_meteor_alignment_equals_nltk():
    for hyp, refs in _captions(11, 100):
        for ref in refs:
            h = list(enumerate(w.lower() for w in hyp))
            r = list(enumerate(w.lower() for w in ref))
            got = meteor._enum_align_words(h, r, PorterStemmer(),
                                           FakeWordnet())
            want = nltk_meteor._enum_align_words(h, r, NltkPorter(),
                                                 FakeWordnet())
            assert got == want
            assert meteor._count_chunks(got[0]) == \
                nltk_meteor._count_chunks(want[0])


def test_sentence_bleu_method4_bitwise():
    ours, theirs = bleu.SmoothingFunction(), nltk_bleu.SmoothingFunction()
    for hyp, refs in _captions(3, 400):
        got = bleu.sentence_bleu(refs, hyp, smoothing_function=ours.method4)
        want = nltk_bleu.sentence_bleu(refs, hyp,
                                       smoothing_function=theirs.method4)
        assert got == want, (hyp, refs)
        for n in (1, 2, 3, 4):
            g = bleu.modified_precision(refs, hyp, n)
            w = nltk_bleu.modified_precision(refs, hyp, n)
            assert (g.numerator, g.denominator) == (w.numerator,
                                                    w.denominator)
        assert bleu.closest_ref_length(refs, len(hyp)) == \
            nltk_bleu.closest_ref_length(refs, len(hyp))


@pytest.mark.parametrize("smoothing", ["method1", "method4", "none"])
def test_corpus_bleu_bitwise(smoothing):
    pairs = _captions(5, 300)
    refs = [r for _, r in pairs]
    hyps = [h for h, _ in pairs]
    ours = (getattr(bleu.SmoothingFunction(), smoothing)
            if smoothing != "none" else None)
    theirs = (getattr(nltk_bleu.SmoothingFunction(), smoothing)
              if smoothing != "none" else None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for lo, hi in ((0, 300), (0, 7), (13, 14), (100, 160)):
            got = bleu.corpus_bleu(refs[lo:hi], hyps[lo:hi],
                                   smoothing_function=ours)
            want = nltk_bleu.corpus_bleu(refs[lo:hi], hyps[lo:hi],
                                         smoothing_function=theirs)
            assert got == want, (lo, hi)
        # other orders
        for w in ((0.5, 0.5), (1 / 3, 1 / 3, 1 / 3)):
            assert bleu.corpus_bleu(refs, hyps, w, ours) == \
                nltk_bleu.corpus_bleu(refs, hyps, w, theirs)
    for c, h in ((12, 12), (13, 12), (2, 12), (5, 0), (0, 3)):
        assert bleu.brevity_penalty(c, h) == nltk_bleu.brevity_penalty(c, h)


def _records(seed, n):
    rng = np.random.RandomState(seed)
    recs = []
    for hyp, refs in _captions(seed, n):
        cand = " ".join(hyp) if rng.rand() > 0.05 else ""
        recs.append({"candidate": cand,
                     "references": [" ".join(r) for r in refs]})
    return recs


def test_score_captions_equals_jax():
    from imagecaptioning_tpu.eval import scorer as jax_scorer
    records = _records(17, 120)
    got = scorer.score_captions(records)
    want = jax_scorer.score_captions(records)
    for key in ("meteor", "bleu", "bleu4", "cider"):
        assert got[key] == want[key], key
    assert got["scorer"] == want["scorer"]
    assert set(scorer.scorer_provenance()) == set(
        jax_scorer.scorer_provenance())
    empty = scorer.score_captions([])
    assert empty == jax_scorer.score_captions([])


def test_dense_score_records_equals_jax():
    from imagecaptioning_tpu.eval import dense_eval as jax_dense
    records = _records(19, 150) + [{"candidate": "a man",
                                    "references": []}]
    got = dense_eval.score_records(records)
    want = jax_dense.score_records(records)
    assert got["scores"] == want["scores"]
    assert got["average_score"] == want["average_score"]


def test_scoring_without_nltk(monkeypatch):
    """A host with no nltk at all (the card's): provenance says so, and
    the scores are the corpus-less ones."""
    records = _records(23, 40)
    with_nltk = scorer.score_captions(records)
    dense_with = dense_eval.score_records(records)
    monkeypatch.setitem(sys.modules, "nltk", None)
    monkeypatch.setattr(scorer, "_HOST", {})
    monkeypatch.setattr(dense_eval, "_TOKENIZER", {})
    assert scorer.scorer_provenance() == {"wordnet_available": False,
                                          "nltk": None}
    without = scorer.score_captions(records)
    assert {k: without[k] for k in ("meteor", "bleu", "bleu4", "cider")} \
        == {k: with_nltk[k] for k in ("meteor", "bleu", "bleu4", "cider")}
    assert dense_eval.score_records(records) == dense_with
