"""Experiment configuration of the AlexCap caption families — copy of
`imagecaptioning_tpu/config/configs.py` (`CaptionConfig`,
`get_lstm_config` and the other families' factories, `name_model`,
`apply_overrides`, `get_config`).

Every field of the reference's hard-coded edict factories
(``AlexCap/LSTM_opts.py:8-54`` …) is kept, and so is the artifact name
mangling (``name_LSTM_model``, ``LSTM_opts.py:57-82``), so the loss,
result and checkpoint file names are the reference's. The mesh fields
(``mesh_shape``, ``mesh_axis_names``) are the JAX package's, with its
defaults: every data rank of a torchrun launch takes a share of the batch
(`parallel/mesh.py`). Its device fields (``backend``, ``device``) are left
out, and `apply_overrides` refuses them: the entry points take the device
as an argument (``--device``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple


@dataclass
class CaptionConfig:
    """One config object for all four AlexCap model families."""

    # Which model family: 'lstm' | 'lstm_attention' | 'transformer' | 'vitb'
    model_type: str = "lstm"

    # Data input settings
    data_h5: str = "data/face2text-data.h5"
    data_json: str = "data/face2text-dicts.json"
    debug_max_train_images: int = -1

    # Optimization
    use_scheduler: bool = False
    learning_rate: float = 1e-4
    embedding_size: int = 1024
    lstm_size: int = 768          # rnn_size (LSTM families)
    transformer_size: int = 512   # embed dim (transformer family)
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-6
    min_lr: float = 1e-6

    # Model checkpointing / logging
    num_epochs: int = 50
    save_checkpoint_every: int = 8489  # = reference train-set size
    save_path: str = "runs/models/best_model_LSTM.ckpt"
    loss_file: str = "runs/loss_logs/loss_history_LSTM.json"
    result_file: str = "runs/logs/results_history_LSTM.json"
    batch_size: int = 12
    clip_grad: bool = True
    grad_clip_norm: float = 1.0
    iterate: bool = False
    from_checkpoint: bool = False
    use_dropout: bool = False
    drop_value: float = 0.5
    num_layers: int = 1           # LSTM layers / transformer+vit decoder layers
    num_heads: int = 8
    forward_expansion: int = 4
    finetune_cnn: bool = True
    finetuning_after_nepoch: int = 1
    use_vggface: bool = False
    trained_encoder: bool = True  # ViT-B: start from pretrained encoder

    # Misc
    id: str = ""
    seed: int = 123
    gpu: int = 0
    timing: bool = False

    # a torchrun launch's ranks (parallel/mesh.py): -1 = all on 'data'
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)

    # ---- additions of the JAX package (no reference counterpart) ----
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_beam: bool = False
    beam_size: int = 3
    eval_val_batch_size: int = 12
    log_every: int = 0            # loss-log stride; 0 → reference's pad =
                                  # save_checkpoint_every // bs**2
    debug_nans: bool = False
    tensorboard_dir: str = ""     # '' = off
    # k micro-batches averaged into one optimizer update (optax's
    # MultiSteps: `train/optim.py` `Accumulating`)
    grad_accum_steps: int = 1
    # CNN trunk depth override: () = the family default (ResNet-101's
    # (3, 4, 23, 3)); smaller tuples shrink the trunk for CPU runs and tests
    backbone_stages: tuple = ()
    # ViT encoder dims override for the vitb family
    vit_dims: tuple = ()
    # pretrained encoder weights merged into the init (`utils/pretrained.py`)
    encoder_init: str = ""
    # Device-resident dataset (data/device_store.py): stage the uint8 train
    # split on the card once and feed the step index batches. 'auto' = on
    # when the split is RAM-cached and fits the card's free memory budget;
    # 'on' forces it; 'off' keeps the streaming path.
    device_resident_data: str = "auto"

    def replace(self, **kw) -> "CaptionConfig":
        return replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    # dict-style access, as the reference's edict
    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)


def get_lstm_config() -> CaptionConfig:
    """Reference `get_LSTM_config` (AlexCap/LSTM_opts.py:8-54)."""
    return CaptionConfig(
        model_type="lstm",
        use_scheduler=False,
        learning_rate=1e-4,
        embedding_size=1024,
        lstm_size=768,
        weight_decay=1e-6,
        save_path="runs/models/best_model_LSTM.ckpt",
        loss_file="runs/loss_logs/loss_history_LSTM.json",
        result_file="runs/logs/results_history_LSTM.json",
        use_dropout=False,
        drop_value=0.5,
        num_layers=1,
        from_checkpoint=False,
    )


def get_lstm_attention_config() -> CaptionConfig:
    """Reference `get_LSTMwAtt_config` (AlexCap/LSTMwAttention_opts.py)."""
    return CaptionConfig(
        model_type="lstm_attention",
        use_scheduler=True,
        learning_rate=3e-4,
        embedding_size=1024,
        lstm_size=768,
        weight_decay=1e-6,
        save_path="runs/models/best_model_sch_LSTMwAttention.ckpt",
        loss_file="runs/loss_logs/loss_history_sch_LSTMwAttention.json",
        result_file="runs/logs/results_history_sch_LSTMwAttention.json",
        use_dropout=False,
        drop_value=0.5,
        num_layers=1,
    )


def get_transformer_config() -> CaptionConfig:
    """Reference `get_Transformer_config` (AlexCap/Transformer_opts.py)."""
    return CaptionConfig(
        model_type="transformer",
        use_scheduler=True,
        learning_rate=3e-4,
        embedding_size=512,
        transformer_size=512,
        weight_decay=0.1,
        save_path="runs/models/best_model_Transformer.ckpt",
        loss_file="runs/loss_logs/loss_history_Transformer.json",
        result_file="runs/logs/results_history_Transformer.json",
        use_dropout=True,
        drop_value=0.1,
        num_layers=6,
        finetuning_after_nepoch=2,
    )


def get_vitb_config() -> CaptionConfig:
    """Reference `get_vitb_config` (AlexCap/vitb_opts.py)."""
    return CaptionConfig(
        model_type="vitb",
        use_scheduler=True,
        learning_rate=3e-4,
        embedding_size=768,
        transformer_size=768,
        weight_decay=0.1,
        save_path="runs/models/best_model_ViTB.ckpt",
        loss_file="runs/loss_logs/loss_history_ViTB.json",
        result_file="runs/logs/results_history_ViTB.json",
        use_dropout=True,
        drop_value=0.1,
        num_layers=6,
        trained_encoder=True,
    )


_MODEL_TAGS = {
    "lstm": "LSTM",
    "lstm_attention": "LSTMwAttention",
    "transformer": "Transformer",
    "vitb": "ViTB",
}


def _mangle(path: str, tag: str, opt: CaptionConfig) -> str:
    """The reference's sequential string-substitution naming
    (AlexCap/LSTM_opts.py:57-82): each enabled flag rewrites TAG →
    TAG_<flag> in order clip, iter, bs, drop, ft, encoder."""
    out = path
    if opt.clip_grad:
        out = out.replace(tag, f"{tag}_clip")
    if opt.iterate:
        out = out.replace(tag, f"{tag}_iter")
    out = out.replace(tag, f"{tag}_bs{opt.batch_size}")
    if opt.use_dropout:
        out = out.replace(tag, f"{tag}_drop{opt.drop_value}")
    if opt.model_type == "vitb":
        # ViT naming: only the pretrained flag after drop (vitb_opts.py)
        if opt.trained_encoder:
            out = out.replace(tag, f"{tag}_pretrained")
        return out
    if opt.finetune_cnn:
        out = out.replace(tag, f"{tag}_ft")
    if opt.use_vggface:
        out = out.replace(tag, f"{tag}_vggface")
    else:
        out = out.replace(tag, f"{tag}_resnet")
    return out


def name_model(opt: CaptionConfig):
    """(loss_file, result_file, save_path), named the reference's way."""
    tag = _MODEL_TAGS[opt.model_type]
    return (_mangle(opt.loss_file, tag, opt),
            _mangle(opt.result_file, tag, opt),
            _mangle(opt.save_path, tag, opt))


def get_config(model_type: str) -> CaptionConfig:
    factories = {
        "lstm": get_lstm_config,
        "lstm_attention": get_lstm_attention_config,
        "transformer": get_transformer_config,
        "vitb": get_vitb_config,
    }
    return factories[model_type]()


_LEFT_OUT = ("backend", "device")


def parse_tuple(v: str) -> tuple:
    """A comma-separated override: ints where every item is one (a mesh
    shape, the trunk's stages), else strings (the mesh's axis names)."""
    items = tuple(x.strip() for x in v.split(","))
    try:
        return tuple(int(x) for x in items)
    except ValueError:
        return items


def apply_overrides(cfg: CaptionConfig,
                    overrides: Dict[str, Any]) -> CaptionConfig:
    """CLI override helper: strings coerced to the field's declared type
    (a tuple field takes comma-separated ints)."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    kw = {}
    for k, v in overrides.items():
        if k in _LEFT_OUT:
            raise KeyError(f"{k} is a field of the JAX package's config; the "
                           f"port's device is named by --device")
        if k not in fields:
            raise KeyError(f"unknown config field: {k}")
        typ = type(getattr(cfg, k))
        if isinstance(v, str) and typ is not str:
            if typ is bool:
                v = v.lower() in ("1", "true", "yes", "on")
            elif typ is int:
                v = int(v)
            elif typ is float:
                v = float(v)
            elif typ is tuple:
                v = parse_tuple(v)
        kw[k] = v
    return cfg.replace(**kw)
