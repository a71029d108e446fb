"""Optional external METEOR-1.5 scorer (subprocess stdio bridge) — copy
of `imagecaptioning_tpu/eval/meteor_bridge.py`.

The reference ships `DenseCap/eval/meteor_bridge.py`, a wrapper around
the METEOR-1.5 Java jar speaking its `-stdio` protocol, as a legacy
alternative to its NLTK path (the call site is commented out at
`DenseCap/eval/eval_utils.py:253-256`); the jar itself is in neither the
reference nor this repository. This module gives the same capability,
gated: `available()` reports whether a jar and a JVM exist, the scorer
raises a clear error otherwise, and the port's scorer (`eval/scorer.py`,
with its own METEOR in `eval/meteor.py`) stays the default; no trainer
calls the bridge. Protocol (METEOR 1.5 manual):

    > SCORE ||| ref 1 ||| ... ||| ref n ||| hypothesis
    < <stats line>
    > EVAL ||| <stats line>
    < <float score>

Batch mode keeps the reference's `__main__` contract: read a JSON list of
{'candidate', 'references'} records, write {'scores', 'average_score'}:

  python -m imagecaptioning_tpu_torch.eval.meteor_bridge in.json out.json \
      [--jar meteor-1.5.jar]      (or $METEOR_JAR)
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

_DEFAULT_JAR = os.environ.get("METEOR_JAR", "")


def _sanitize(text: str) -> str:
    """The stdio protocol is line-based with '|||' field delimiters —
    strip both newlines and the delimiter (and the double spaces
    stripping leaves) from payload text."""
    text = text.replace("\n", " ").replace("\r", " ")
    return text.replace("|||", "").replace("  ", " ").strip()


def available(jar_path: str = _DEFAULT_JAR) -> bool:
    """True iff an external METEOR run could work on this host."""
    return bool(jar_path) and os.path.isfile(jar_path) and (
        shutil.which("java") is not None)


class ExternalMeteor:
    """Persistent METEOR scorer process, thread-safe.

    Pass `jar_path` to run the real jar (`java -Xmx2G -jar <jar> - -
    -stdio -l en -norm`), or `cmd` (argv list) to run any process
    speaking the same stdio protocol — which is how the tests exercise
    this bridge without a JVM.
    """

    def __init__(self, jar_path: str = _DEFAULT_JAR,
                 cmd: Optional[Sequence[str]] = None):
        if cmd is None:
            if not available(jar_path):
                raise RuntimeError(
                    "external METEOR unavailable: need meteor-1.5.jar "
                    "(set METEOR_JAR) and a `java` on PATH; the default "
                    "scorer (eval/scorer.py) needs neither")
            cmd = ["java", "-Xmx2G", "-jar", jar_path,
                   "-", "-", "-stdio", "-l", "en", "-norm"]
        self._proc = subprocess.Popen(
            list(cmd), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1)
        self._lock = threading.Lock()

    def _roundtrip(self, line: str) -> str:
        assert self._proc.stdin and self._proc.stdout
        self._proc.stdin.write(line + "\n")
        self._proc.stdin.flush()
        reply = self._proc.stdout.readline()
        if not reply:
            raise RuntimeError("METEOR process closed its stdout")
        return reply.strip()

    def score(self, candidate: str, references: Sequence[str]) -> float:
        """Single-segment METEOR of candidate vs the reference set."""
        fields = ["SCORE", *[_sanitize(r) for r in references],
                  _sanitize(candidate)]
        with self._lock:
            stats = self._roundtrip(" ||| ".join(fields))
            return float(self._roundtrip(f"EVAL ||| {stats}"))

    def score_records(self, records: Sequence[Dict]) -> Dict:
        """Reference batch contract: records of {'candidate',
        'references'} → {'scores': [...], 'average_score': mean}."""
        scores: List[float] = [
            self.score(r["candidate"], r["references"]) for r in records]
        avg = sum(scores) / len(scores) if scores else 0.0
        return {"scores": scores, "average_score": avg}

    def close(self) -> None:
        if self._proc.poll() is None:
            if self._proc.stdin:
                self._proc.stdin.close()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    def __enter__(self) -> "ExternalMeteor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """`python -m imagecaptioning_tpu_torch.eval.meteor_bridge in.json
    out.json` — the reference's file-based batch mode."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_json")
    p.add_argument("output_json")
    p.add_argument("--jar", default=_DEFAULT_JAR,
                   help="path to meteor-1.5.jar (or $METEOR_JAR)")
    args = p.parse_args(argv)
    with open(args.input_json) as f:
        records = json.load(f)
    with ExternalMeteor(jar_path=args.jar) as scorer:
        out = scorer.score_records(records)
    with open(args.output_json, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
