"""Optional TensorBoard channel — port of `imagecaptioning_tpu/utils/tb.py`.

The loss and results history JSONs (`utils/io.py`) stay the record; this
adds an event stream when a config sets `tensorboard_dir`, through torch's
own `SummaryWriter`. Where `torch.utils.tensorboard` does not import (it
needs the `tensorboard` package), the writer is a silent no-op, as in the
JAX package. Off rank 0 of a run of several processes it is a no-op too.
"""

from __future__ import annotations

from typing import Mapping, Optional

from imagecaptioning_tpu_torch.parallel import mesh


class TBWriter:
    """Scalar event writer; a no-op unless `logdir` is set, this process
    writes the run's files and `torch.utils.tensorboard` imports."""

    def __init__(self, logdir: Optional[str]):
        self._writer = None
        if not logdir or not mesh.is_writer():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._writer = SummaryWriter(log_dir=logdir)
        except Exception:                      # no backend: a no-op
            self._writer = None

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalar(self, tag: str, value, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def scalars(self, values: Mapping[str, float], step: int,
                prefix: str = "") -> None:
        """Each scalar-like entry of `values` under `prefix + key`; nested
        dicts, lists, strings and None are skipped."""
        for k, v in values.items():
            if isinstance(v, (dict, list, tuple, str)) or v is None:
                continue
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
