"""CIDEr-D scorer — copy of `imagecaptioning_tpu/eval/cider.py`
(Vedantam et al., CVPR 2015), self-contained pure Python.

The reference scores captions with NLTK sentence METEOR and smoothed
sentence BLEU only (`AlexCap/eval/eval_resnet.py:108-123`); the JAX
package adds corpus BLEU-4 and this CIDEr-D, the variant of the COCO
caption server: TF-IDF-weighted n-gram (n = 1..4) cosine similarity with
candidate-count clipping and a Gaussian length penalty, averaged over
references and n, scaled by 10.

For each n and reference s of image i with candidate c:

    sim_n(c, s) = exp(-(|c|-|s|)^2 / (2 sigma^2))
                  * <min(g_n(c), g_n(s)), g_n(s)> / (||g_n(c)|| ||g_n(s)||)

where g_n(x) is the vector of n-gram counts weighted by
idf = log(N_images / df), df = number of images whose reference set
contains the n-gram (clipped at 1 per image). CIDEr-D =
10 * mean_n mean_s sim_n.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from math import exp, log, sqrt
from typing import Dict, List, Sequence, Tuple

N_MAX = 4
SIGMA = 6.0


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n])
                   for i in range(len(tokens) - n + 1))


def _counts(tokens: Sequence[str]) -> List[Counter]:
    return [_ngrams(tokens, n + 1) for n in range(N_MAX)]


def _tfidf(counts: Counter, idf: Dict[Tuple, float],
           log_n_images: float) -> Tuple[Dict[Tuple, float], float]:
    """Weighted vector + its L2 norm. Unseen n-grams get df=1 (the
    pycocoevalcap convention: idf defaults to log(N))."""
    vec = {g: c * idf.get(g, log_n_images) for g, c in counts.items()}
    norm = sqrt(sum(v * v for v in vec.values()))
    return vec, norm


class CiderD:
    """Corpus scorer: collect per-image (candidate, references) token
    lists, then `compute()` → (corpus_mean, per_image_scores)."""

    def __init__(self, sigma: float = SIGMA):
        self.sigma = sigma
        self.images: List[Tuple[List[Counter], int,
                                List[Tuple[List[Counter], int]]]] = []

    def add(self, candidate_tokens: Sequence[str],
            references_tokens: Sequence[Sequence[str]]) -> None:
        cand = (_counts(candidate_tokens), len(candidate_tokens))
        refs = [(_counts(r), len(r)) for r in references_tokens]
        self.images.append((cand[0], cand[1], refs))

    def _document_frequencies(self) -> Dict[int, Dict[Tuple, float]]:
        df: Dict[int, Dict[Tuple, float]] = {
            n: defaultdict(float) for n in range(N_MAX)}
        for _, _, refs in self.images:
            for n in range(N_MAX):
                seen = set()
                for ref_counts, _ in refs:
                    seen.update(ref_counts[n].keys())
                for g in seen:
                    df[n][g] += 1.0
        return df

    def compute(self) -> Tuple[float, List[float]]:
        if not self.images:
            return 0.0, []
        n_images = len(self.images)
        log_n = log(max(n_images, 1))
        df = self._document_frequencies()
        idf = {n: {g: log_n - log(d) for g, d in df[n].items()}
               for n in range(N_MAX)}

        scores: List[float] = []
        for cand_counts, cand_len, refs in self.images:
            per_n = [0.0] * N_MAX
            for n in range(N_MAX):
                c_vec, c_norm = _tfidf(cand_counts[n], idf[n], log_n)
                for ref_counts, ref_len in refs:
                    r_vec, r_norm = _tfidf(ref_counts[n], idf[n], log_n)
                    if c_norm == 0.0 or r_norm == 0.0:
                        continue
                    # candidate counts clipped to the reference's
                    num = sum(min(c_vec[g], r_vec.get(g, 0.0)) *
                              r_vec.get(g, 0.0) for g in c_vec)
                    penalty = exp(-((cand_len - ref_len) ** 2) /
                                  (2.0 * self.sigma ** 2))
                    per_n[n] += penalty * num / (c_norm * r_norm)
                per_n[n] /= max(len(refs), 1)
            scores.append(10.0 * sum(per_n) / N_MAX)
        return sum(scores) / len(scores), scores
