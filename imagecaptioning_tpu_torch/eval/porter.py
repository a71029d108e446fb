"""The Porter stemmer of METEOR's stem stage — a copy of nltk 3.10.0's
`nltk.stem.porter.PorterStemmer` in its default `NLTK_EXTENSIONS` mode
(Porter, "An algorithm for suffix stripping", Program 14.3 (1980),
130-137, with Martin Porter's and NLTK's extensions): its pool of
irregular forms, the `-ies`/`-ied` rules for four-letter words, step
1c's consonant condition, step 2's `alli` re-run and `fulli`/`logi`
rules, and the two-letter `*o` condition. The other two modes of nltk's
class are not copied: METEOR runs this one.
"""

from __future__ import annotations

IRREGULAR_FORMS = {
    "sky": ["sky", "skies"],
    "die": ["dying"],
    "lie": ["lying"],
    "tie": ["tying"],
    "news": ["news"],
    "inning": ["innings", "inning"],
    "outing": ["outings", "outing"],
    "canning": ["cannings", "canning"],
    "howe": ["howe"],
    "proceed": ["proceed"],
    "exceed": ["exceed"],
    "succeed": ["succeed"],
}


class PorterStemmer:
    """`stem(word)` as nltk's `PorterStemmer().stem(word)`."""

    def __init__(self):
        self.pool = {val: key for key, vals in IRREGULAR_FORMS.items()
                     for val in vals}
        self.vowels = frozenset("aeiou")

    def _is_consonant(self, word, i):
        """A letter other than a, e, i, o, u, and other than a y preceded
        by a consonant (a run of y's is resolved without recursion)."""
        if word[i] in self.vowels:
            return False
        if word[i] == "y":
            negate = False
            while i > 0 and word[i] == "y":
                negate = not negate
                i -= 1
            return (word[i] not in self.vowels) != negate
        return True

    def _measure(self, stem):
        """m of [C](VC){m}[V]: the count of 'vc' in the word's c/v
        string."""
        cv = "".join("c" if self._is_consonant(stem, i) else "v"
                     for i in range(len(stem)))
        return cv.count("vc")

    def _has_positive_measure(self, stem):
        return self._measure(stem) > 0

    def _contains_vowel(self, stem):
        return any(not self._is_consonant(stem, i) for i in range(len(stem)))

    def _ends_double_consonant(self, word):
        """Condition *d."""
        return (len(word) >= 2 and word[-1] == word[-2]
                and self._is_consonant(word, len(word) - 1))

    def _ends_cvc(self, word):
        """Condition *o: cvc with the last c not w, x or y; or (an NLTK
        extension) a two-letter vowel-consonant word."""
        return (
            len(word) >= 3
            and self._is_consonant(word, len(word) - 3)
            and not self._is_consonant(word, len(word) - 2)
            and self._is_consonant(word, len(word) - 1)
            and word[-1] not in ("w", "x", "y")
        ) or (
            len(word) == 2
            and not self._is_consonant(word, 0)
            and self._is_consonant(word, 1)
        )

    @staticmethod
    def _replace_suffix(word, suffix, replacement):
        assert word.endswith(suffix), "Given word doesn't end with given suffix"
        if suffix == "":
            return word + replacement
        return word[: -len(suffix)] + replacement

    def _apply_rule_list(self, word, rules):
        """The first rule whose suffix matches decides: it applies when its
        condition holds, and no later rule is tried either way."""
        for suffix, replacement, condition in rules:
            if suffix == "*d" and self._ends_double_consonant(word):
                stem = word[:-2]
                if condition is None or condition(stem):
                    return stem + replacement
                return word
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                if condition is None or condition(stem):
                    return stem + replacement
                return word
        return word

    def _step1a(self, word):
        if word.endswith("ies") and len(word) == 4:
            return self._replace_suffix(word, "ies", "ie")
        return self._apply_rule_list(word, [("sses", "ss", None),
                                            ("ies", "i", None),
                                            ("ss", "ss", None),
                                            ("s", "", None)])

    def _step1b(self, word):
        if word.endswith("ied"):
            if len(word) == 4:
                return self._replace_suffix(word, "ied", "ie")
            return self._replace_suffix(word, "ied", "i")
        if word.endswith("eed"):
            stem = self._replace_suffix(word, "eed", "")
            if self._measure(stem) > 0:
                return stem + "ee"
            return word
        rule_2_or_3_succeeded = False
        for suffix in ["ed", "ing"]:
            if word.endswith(suffix):
                intermediate_stem = self._replace_suffix(word, suffix, "")
                if self._contains_vowel(intermediate_stem):
                    rule_2_or_3_succeeded = True
                    break
        if not rule_2_or_3_succeeded:
            return word
        return self._apply_rule_list(intermediate_stem, [
            ("at", "ate", None),
            ("bl", "ble", None),
            ("iz", "ize", None),
            ("*d", intermediate_stem[-1],
             lambda stem: intermediate_stem[-1] not in ("l", "s", "z")),
            ("", "e",
             lambda stem: self._measure(stem) == 1 and self._ends_cvc(stem)),
        ])

    def _step1c(self, word):
        # y -> i only after a consonant, and not for a single consonant
        return self._apply_rule_list(word, [(
            "y", "i",
            lambda stem: len(stem) > 1 and self._is_consonant(stem,
                                                              len(stem) - 1))])

    def _step2(self, word):
        # ALLI -> AL first; where it applies, step 2 again on the result
        if word.endswith("alli") and self._has_positive_measure(
                self._replace_suffix(word, "alli", "")):
            return self._step2(self._replace_suffix(word, "alli", "al"))
        pos = self._has_positive_measure
        rules = [
            ("ational", "ate", pos),
            ("tional", "tion", pos),
            ("enci", "ence", pos),
            ("anci", "ance", pos),
            ("izer", "ize", pos),
            ("bli", "ble", pos),
            ("alli", "al", pos),
            ("entli", "ent", pos),
            ("eli", "e", pos),
            ("ousli", "ous", pos),
            ("ization", "ize", pos),
            ("ation", "ate", pos),
            ("ator", "ate", pos),
            ("alism", "al", pos),
            ("iveness", "ive", pos),
            ("fulness", "ful", pos),
            ("ousness", "ous", pos),
            ("aliti", "al", pos),
            ("iviti", "ive", pos),
            ("biliti", "ble", pos),
            ("fulli", "ful", pos),
            # the 'l' of 'logi' stays with the stem for the measure
            ("logi", "log", lambda stem: pos(word[:-3])),
        ]
        return self._apply_rule_list(word, rules)

    def _step3(self, word):
        pos = self._has_positive_measure
        return self._apply_rule_list(word, [("icate", "ic", pos),
                                            ("ative", "", pos),
                                            ("alize", "al", pos),
                                            ("iciti", "ic", pos),
                                            ("ical", "ic", pos),
                                            ("ful", "", pos),
                                            ("ness", "", pos)])

    def _step4(self, word):
        def gt1(stem):
            return self._measure(stem) > 1
        return self._apply_rule_list(word, [
            ("al", "", gt1),
            ("ance", "", gt1),
            ("ence", "", gt1),
            ("er", "", gt1),
            ("ic", "", gt1),
            ("able", "", gt1),
            ("ible", "", gt1),
            ("ant", "", gt1),
            ("ement", "", gt1),
            ("ment", "", gt1),
            ("ent", "", gt1),
            ("ion", "",
             lambda stem: self._measure(stem) > 1 and stem[-1] in ("s", "t")),
            ("ou", "", gt1),
            ("ism", "", gt1),
            ("ate", "", gt1),
            ("iti", "", gt1),
            ("ous", "", gt1),
            ("ive", "", gt1),
            ("ize", "", gt1),
        ])

    def _step5a(self, word):
        # both conditions are tried, so no rule list here
        if word.endswith("e"):
            stem = self._replace_suffix(word, "e", "")
            if self._measure(stem) > 1:
                return stem
            if self._measure(stem) == 1 and not self._ends_cvc(stem):
                return stem
        return word

    def _step5b(self, word):
        return self._apply_rule_list(
            word, [("ll", "l", lambda stem: self._measure(word[:-1]) > 1)])

    def stem(self, word):
        stem = word.lower()
        if stem in self.pool:
            return self.pool[stem]
        if len(word) <= 2:
            # one- and two-letter words are not stemmed
            return stem
        for step in (self._step1a, self._step1b, self._step1c, self._step2,
                     self._step3, self._step4, self._step5a, self._step5b):
            stem = step(stem)
        return stem
