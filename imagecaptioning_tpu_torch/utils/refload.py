"""Loading one file of the reference checkout offline — copy of
`imagecaptioning_tpu/utils/refload.py` (`EasyDict`,
`load_reference_module`).

`load_reference_module` imports one file of the reference's own torch
code with the shims its module scope needs offline: a minimal
`easydict`, an empty `torchvision` (with an empty `torchvision.models`),
and the reference root on `sys.path` while the file runs, so that `from
AlexCap.my_utils import ...` resolves as a namespace package. The
checkout's root is `ref_root`: by default `$REFERENCE_ROOT`, else
`reference/` under the working directory (the JAX module names a fixed
absolute path). The JAX module's `force_cpu` pins JAX's platform and has no counterpart here: the
port's entry points take `device`.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

REF_ROOT = os.environ.get("REFERENCE_ROOT", "reference")


class EasyDict(dict):
    """The two easydict behaviors the reference configs rely on."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def load_reference_module(relpath: str, name: str,
                          ref_root: str = REF_ROOT):
    """Import `<ref_root>/<relpath>` as module `name`."""
    if "easydict" not in sys.modules:
        ed = types.ModuleType("easydict")
        ed.EasyDict = EasyDict
        sys.modules["easydict"] = ed
    if "torchvision" not in sys.modules:
        tv = types.ModuleType("torchvision")
        tv.models = types.ModuleType("torchvision.models")
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.models"] = tv.models
    # the reference root goes on sys.path only while the module runs:
    # left there it would shadow same-named top-level modules of this
    # repository (both trees have a root preprocess.py)
    added = ref_root not in sys.path
    if added:
        sys.path.insert(0, ref_root)
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ref_root, relpath))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    finally:
        if added and ref_root in sys.path:
            sys.path.remove(ref_root)
    return mod
