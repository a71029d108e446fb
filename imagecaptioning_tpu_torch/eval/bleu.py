"""BLEU — a copy of nltk 3.10.0's `nltk/translate/bleu_score.py`
(Papineni et al., 2002; smoothing after Chen and Cherry, 2014):
`sentence_bleu`, `corpus_bleu`, `modified_precision`,
`closest_ref_length`, `brevity_penalty` and `SmoothingFunction`'s
methods 0, 1 and 4, in nltk's operation order, so that the scores are
nltk's to the last bit:
- the corpus sums each order's clipped counts and n-gram counts apart,
  as unnormalised fractions;
- the brevity penalty is exp(1 − r/c) over the summed closest-reference
  and hypothesis lengths;
- method 4 divides 1 / (2^k · 5 / ln(c)) by the denominator for the
  k-th order without a match (c the summed hypothesis length);
- the score is bp · exp(fsum(w_i · ln p_i)) over the positive p_i.
"""

from __future__ import annotations

import math
import sys
import warnings
from collections import Counter
from fractions import Fraction as _Fraction
from itertools import tee


class Fraction(_Fraction):
    """A fraction that keeps its numerator and denominator as given
    (nltk's `_normalize=False`): the corpus sums them unreduced."""

    def __new__(cls, numerator=0, denominator=None):
        self = super().__new__(cls, numerator, denominator)
        self._original_numerator = numerator
        self._original_denominator = denominator
        return self

    @property
    def numerator(self):
        return self._original_numerator

    @property
    def denominator(self):
        return self._original_denominator


def ngrams(sequence, n):
    """The n-grams of `sequence`, as tuples (nltk.util.ngrams without
    padding)."""
    iterables = tee(iter(sequence), n)
    for i, sub_iterable in enumerate(iterables):
        for _ in range(i):
            next(sub_iterable, None)
    return zip(*iterables)


def sentence_bleu(references, hypothesis, weights=(0.25, 0.25, 0.25, 0.25),
                  smoothing_function=None):
    """BLEU of one hypothesis: `corpus_bleu` over a corpus of one."""
    return corpus_bleu([references], [hypothesis], weights,
                       smoothing_function)


def corpus_bleu(list_of_references, hypotheses,
                weights=(0.25, 0.25, 0.25, 0.25), smoothing_function=None):
    """Corpus BLEU of one weight tuple: clipped n-gram counts and n-gram
    counts summed over the corpus before the division."""
    p_numerators = Counter()
    p_denominators = Counter()
    hyp_lengths, ref_lengths = 0, 0
    assert len(list_of_references) == len(hypotheses), (
        "The number of hypotheses and their reference(s) should be the same ")
    max_weight_length = len(weights)

    for references, hypothesis in zip(list_of_references, hypotheses):
        for i in range(1, max_weight_length + 1):
            p_i = modified_precision(references, hypothesis, i)
            p_numerators[i] += p_i.numerator
            p_denominators[i] += p_i.denominator
        hyp_len = len(hypothesis)
        hyp_lengths += hyp_len
        ref_lengths += closest_ref_length(references, hyp_len)

    bp = brevity_penalty(ref_lengths, hyp_lengths)
    p_n = [Fraction(p_numerators[i], p_denominators[i])
           for i in range(1, max_weight_length + 1)]
    # no unigram match: no match of any order
    if p_numerators[1] == 0:
        return 0
    if not smoothing_function:
        smoothing_function = SmoothingFunction().method0
    # the last pair's references and hypothesis, as nltk passes them
    p_n = smoothing_function(p_n, references=references,
                             hypothesis=hypothesis, hyp_len=hyp_lengths)
    s = (w_i * math.log(p_i) for w_i, p_i in zip(weights, p_n) if p_i > 0)
    return bp * math.exp(math.fsum(s))


def modified_precision(references, hypothesis, n):
    """Clipped n-gram precision as an unreduced fraction: the
    hypothesis's n-gram counts, each clipped to its most in any one
    reference, over the hypothesis's n-gram count (at least 1)."""
    counts = (Counter(ngrams(hypothesis, n)) if len(hypothesis) >= n
              else Counter())
    max_counts = {}
    for reference in references:
        reference_counts = (Counter(ngrams(reference, n))
                            if len(reference) >= n else Counter())
        for ngram in counts:
            max_counts[ngram] = max(max_counts.get(ngram, 0),
                                    reference_counts[ngram])
    clipped_counts = {ngram: min(count, max_counts[ngram])
                      for ngram, count in counts.items()}
    numerator = sum(clipped_counts.values())
    denominator = max(1, sum(counts.values()))
    return Fraction(numerator, denominator)


def closest_ref_length(references, hyp_len):
    """The reference length closest to `hyp_len`, the shorter on a tie."""
    ref_lens = (len(reference) for reference in references)
    return min(ref_lens,
               key=lambda ref_len: (abs(ref_len - hyp_len), ref_len))


def brevity_penalty(closest_ref_len, hyp_len):
    if hyp_len > closest_ref_len:
        return 1
    if hyp_len == 0:
        return 0
    return math.exp(1 - closest_ref_len / hyp_len)


class SmoothingFunction:
    """Chen and Cherry's smoothing methods 0 (none), 1 and 4, with
    nltk's defaults epsilon 0.1 and k 5."""

    def __init__(self, epsilon=0.1, k=5):
        self.epsilon = epsilon
        self.k = k

    def method0(self, p_n, *args, **kwargs):
        """No smoothing: an order without a match counts as the smallest
        float, with nltk's warning."""
        p_n_new = []
        for i, p_i in enumerate(p_n):
            if p_i.numerator != 0:
                p_n_new.append(p_i)
            else:
                warnings.warn(
                    f"\nThe hypothesis contains 0 counts of {i + 1}-gram "
                    "overlaps.\nTherefore the BLEU score evaluates to 0, "
                    "independently of\nhow many N-gram overlaps of lower "
                    "order it contains.\nConsider using lower n-gram order "
                    "or use SmoothingFunction()")
                p_n_new.append(sys.float_info.min)
        return p_n_new

    def method1(self, p_n, *args, **kwargs):
        """Add epsilon to the numerator of an order without a match."""
        return [(p_i.numerator + self.epsilon) / p_i.denominator
                if p_i.numerator == 0 else p_i for p_i in p_n]

    def method4(self, p_n, references, hypothesis, hyp_len=None, *args,
                **kwargs):
        """The k-th order without a match counts 1 / (2^k · K / ln(c)) over
        its denominator (c the hypothesis length, K = `k`)."""
        incvnt = 1
        hyp_len = hyp_len if hyp_len else len(hypothesis)
        for i, p_i in enumerate(p_n):
            if p_i.numerator == 0 and hyp_len > 1:
                numerator = 1 / (2 ** incvnt * self.k / math.log(hyp_len))
                p_n[i] = numerator / p_i.denominator
                incvnt += 1
        return p_n
