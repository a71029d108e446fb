"""The port's completeness, checked from the source alone.

Every public module-level function and class of the JAX package
(`imagecaptioning_tpu/**/*.py`) and of its root scripts (the repository's
top-level `.py` files that import `imagecaptioning_tpu`), and every public
method of a public class, has a counterpart in the port: the same name in
the port's corresponding module (`imagecaptioning_tpu/<m>.py` →
`imagecaptioning_tpu_torch/<m>.py`, a root script `<s>.py` →
`imagecaptioning_tpu_torch/<s>.py`), or an entry of `TABLE` that names the
port's counterpart under another name, or says why there is none from a
closed set of reasons. A gap the table does not list fails, and so does a
stale entry: a JAX name that is gone, a name that now has a same-named
counterpart, or a named counterpart that does not exist. Nothing of
either package is imported: the modules are read with `ast`.
"""

from __future__ import annotations

import ast
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Set

import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "imagecaptioning_tpu"
PORT = REPO / "imagecaptioning_tpu_torch"

# Why a JAX name has no same-named counterpart. The first two name the
# port's counterpart; the others cannot.
IDIOM = "a flax/optax/jit idiom with a torch counterpart"
PALLAS = "a Pallas function, ported as a CUDA entry"
REFERENCE = "needs the reference's own torch modules (its checkout)"
BENCHMARK = "belongs to the port's benchmark"
TEST_TWIN = "a torch twin the JAX tests build"
NAMED = {IDIOM, PALLAS}
UNNAMED = {REFERENCE, BENCHMARK, TEST_TWIN}

# "<jax module>:<name>" (or a whole "<jax module>") → "<port module>:<name>"
# (the counterpart under another name) or (reason, counterpart or None).
# Module paths are relative to the package, or a root script's file name.
TABLE = {
    # the dry run's module is named for what it does
    "__graft_entry__.py:entry": "dryrun.py:entry",
    "__graft_entry__.py:dryrun_multichip": "dryrun.py:dryrun_multichip",
    # host helpers under torch-side names
    "data/device_store.py:store_nbytes":
        "data/device_store.py:ResidentStore.nbytes",
    "data/device_store.py:stage": "data/device_store.py:stage_split",
    "models/backbones/vit.py:ViTBlock":
        "models/backbones/vit.py:EncoderBlock",
    "native/build.py:ensure_built": "native/build.py:library",
    "native/build.py:is_available": "native/build.py:library",
    "utils/checkpoint.py:restore_params":
        "utils/checkpoint.py:restore_checkpoint",
    # jit wrappers, shardings, flax state and optax transforms
    "data/device_store.py:make_resident_train_step":
        (IDIOM, "data/device_store.py:gather_batch"),
    "data/device_store.py:shard_resident_train_step":
        (IDIOM, "parallel/mesh.py:DataParallel"),
    "models/api.py:init_cache":
        (IDIOM, "ops/transformer.py:Decoder.init_state"),
    "models/api.py:apply_train": (IDIOM, "models/api.py:make_forward_fn"),
    "ops/rnn.py:LSTMCell": (IDIOM, "ops/rnn.py:lstm_cell_step"),
    "parallel/mesh.py:data_sharding":
        (IDIOM, "parallel/mesh.py:DataParallel.rows"),
    "parallel/mesh.py:replicated":
        (IDIOM, "parallel/mesh.py:infer_param_shardings"),
    "train/optim.py:encoder_label_fn":
        (IDIOM, "train/optim.py:make_optimizer"),
    "train/optim.py:gate_until": (IDIOM, "train/optim.py:make_optimizer"),
    "train/step.py:TrainState": (IDIOM, "utils/checkpoint.py:train_state"),
    "train/step.py:create_train_state":
        (IDIOM, "train/optim.py:make_optimizer"),
    "train/step.py:shard_train_step": (IDIOM, "parallel/mesh.py:DataParallel"),
    "utils/checkpoint.py:state_as_dict":
        (IDIOM, "utils/checkpoint.py:train_state"),
    "utils/checkpoint.py:state_from_dict":
        (IDIOM, "utils/checkpoint.py:load_train_state"),
    "utils/platform.py:honor_jax_platforms_env":
        (IDIOM, "utils/platform.py:resolve_device"),
    "utils/pretrained.py:merge_module":
        (IDIOM, "utils/pretrained.py:module_state_dict"),
    "utils/refload.py:force_cpu": (IDIOM, "utils/platform.py:resolve_device"),
    # flax modules build in `setup` and decode through `apply(method=...)`
    **{f"models/captioners.py:{cls}.setup":
       (IDIOM, f"models/captioners.py:{cls}.__init__")
       for cls in ("LSTMCaptioner", "AttentionCaptioner",
                   "TransformerCaptioner", "ViTCaptioner")},
    **{f"models/captioners.py:{cls}.{m}":
       (IDIOM, "models/api.py:make_step_fn")
       for cls in ("LSTMCaptioner", "AttentionCaptioner",
                   "TransformerCaptioner", "ViTCaptioner")
       for m in ("init_decode", "decode_step")},
    "models/densecap.py:GTDenseCaptioner.setup":
        (IDIOM, "models/densecap.py:GTDenseCaptioner.__init__"),
    "models/densecap.py:GTDenseCaptioner.decode_step":
        (IDIOM, "models/densecap.py:GTDenseCaptioner.init_decode"),
    "models/densecap.py:DenseCapRPN.setup":
        (IDIOM, "models/densecap.py:DenseCapRPN.__init__"),
    "models/heads.py:LanguageHead.setup":
        (IDIOM, "models/heads.py:LanguageHead.__init__"),
    "models/heads.py:AttentionHead.setup":
        (IDIOM, "models/heads.py:AttentionHead.__init__"),
    # the TPU kernels (csrc/roi_align.cu; the backward in roi_align_bwd.cu)
    "ops/roi_align.py:roi_align_pallas_fwd":
        (PALLAS, "ops/roi_align.py:roi_align"),
    "ops/roi_align.py:roi_align_pallas":
        (PALLAS, "ops/roi_align.py:roi_align"),
    "ops/roi_align.py:roi_align_batch_pallas_fwd":
        (PALLAS, "ops/roi_align.py:roi_align_batch_chw"),
    "ops/roi_align.py:roi_align_batch_pallas":
        (PALLAS, "ops/roi_align.py:roi_align_batch"),
    # waits for files or for a PR of its own
    "quality_parity.py": (REFERENCE, None),
    "reference_decode_baseline.py": (REFERENCE, None),
    "bench.py": (BENCHMARK, None),
    "mfu.py": (BENCHMARK, None),
    "utils/torch_port.py:build_torch_vgg_trunk": (TEST_TWIN, None),
}


def _jax_modules() -> Dict[str, Path]:
    """The JAX package's modules and root scripts, keyed as TABLE keys
    them."""
    mods = {p.relative_to(JAX).as_posix(): p
            for p in sorted(JAX.rglob("*.py"))}
    for p in sorted(REPO.glob("*.py")):
        if "imagecaptioning_tpu" in _imports(p):
            mods[p.name] = p
    return mods


def _imports(path: Path) -> Set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _public(path: Path) -> List[str]:
    """Public module-level functions and classes, and `Class.method` for
    each public method of a public class."""
    names = []
    for node in ast.parse(path.read_text(), str(path)).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        names.append(node.name)
        if isinstance(node, ast.ClassDef):
            names += [f"{node.name}.{sub.name}" for sub in node.body
                      if isinstance(sub, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                      and not sub.name.startswith("_")]
    return names


@lru_cache(maxsize=None)
def _defined(module: str) -> Optional[frozenset]:
    """Every name the port module binds at module level (definitions,
    assignments, imports) and every `Class.attr` its classes define; None
    where the module does not exist."""
    path = PORT / module
    if not path.exists():
        return None
    out = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{sub.name}")
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    targets = (sub.targets if isinstance(sub, ast.Assign)
                               else [sub.target])
                    out |= {f"{node.name}.{t.id}" for t in targets
                            if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return frozenset(out)


def _has(ref: str) -> bool:
    module, name = ref.split(":")
    names = _defined(module)
    return names is not None and name in names


@lru_cache(maxsize=None)
def _inventory() -> Dict[str, List[str]]:
    """Every JAX module's public names (read once: the tests share it and
    do not change it)."""
    return {m: _public(path) for m, path in _jax_modules().items()}


def _gaps(inventory: Dict[str, List[str]], has=_has) -> List[str]:
    """JAX names with no same-named counterpart and no TABLE entry."""
    gaps = []
    for module, names in inventory.items():
        if module in TABLE:
            continue
        for name in names:
            key = f"{module}:{name}"
            if key not in TABLE and not has(key):
                gaps.append(key)
    return gaps


def test_every_jax_name_has_a_port_counterpart():
    inventory = _inventory()
    assert "bench.py" in inventory and "data/vg_loader.py" in inventory
    assert "chip_smoke.py" not in inventory      # the port's own script
    assert sum(map(len, inventory.values())) > 400
    assert _gaps(inventory) == []


def test_table_has_no_stale_entry():
    inventory = _inventory()
    stale = []
    for key, value in TABLE.items():
        module, _, name = key.partition(":")
        if module not in inventory:
            stale.append(f"{key}: the JAX module is gone")
        elif name and name not in inventory[module]:
            stale.append(f"{key}: the JAX name is gone")
        elif not name and _defined(module) is not None:
            stale.append(f"{key}: the port has the module now")
        elif name and _has(key):
            stale.append(f"{key}: the port has the same name now")
        reason, target = (None, value) if isinstance(value, str) else value
        if reason is not None and reason not in NAMED | UNNAMED:
            stale.append(f"{key}: reason {reason!r} is not in the set")
        if (reason in UNNAMED) != (target is None):
            stale.append(f"{key}: {reason!r} with counterpart {target!r}")
        if target is not None and not _has(target):
            stale.append(f"{key}: the port has no {target}")
    assert stale == []


def test_only_the_named_scripts_wait():
    waiting = {key: value[0] for key, value in TABLE.items()
               if not isinstance(value, str)
               and value[0] in (REFERENCE, BENCHMARK)}
    assert waiting == {"quality_parity.py": REFERENCE,
                       "reference_decode_baseline.py": REFERENCE,
                       "bench.py": BENCHMARK, "mfu.py": BENCHMARK}


@pytest.mark.parametrize("module", ["eval/meteor_bridge.py",
                                    "utils/refload.py",
                                    "data/vg_loader.py"])
def test_gap_detection_sees_a_missing_name(module):
    """Hide one port name of a module this slice completed: the inventory
    reports exactly that name."""
    inventory = _inventory()
    victim = next(f"{module}:{n}" for n in inventory[module]
                  if f"{module}:{n}" not in TABLE)
    assert _gaps(inventory, lambda k: k != victim and _has(k)) == [victim]
