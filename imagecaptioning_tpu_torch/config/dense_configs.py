"""Configuration for the GT-box dense captioner (copy of
`imagecaptioning_tpu/config/dense_configs.py`).

Mirrors every field of the reference's edict factories
(`AlexGTModel/train_opts.py:10-81`), the `traingt.py` artifact-name
rewrites (`traingt.py:26-37`) and traingt.py's hard-coded
`max_iter=800000` / `pad=500` (`traingt.py:39-40`). Only `backend` and
`device` default to the CUDA card here; every other default is the JAX
package's, so a `--set` override means the same thing in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple


@dataclass
class DenseConfig:
    """One config for GTDenseCaptioner (and, in a later slice, DenseCapRPN)."""

    # 'gt' (AlexGTModel path) | 'rpn' (full DenseCap path)
    model_type: str = "gt"

    backend: str = "cuda"
    device: str = "cuda:0"

    # Model settings (train_opts.py:18-24)
    rpn_hidden_dim: int = 512
    sampler_batch_size: int = 256
    rnn_size: int = 512
    input_encoding_size: int = 512
    sampler_high_thresh: float = 0.7
    sampler_low_thresh: float = 0.3
    train_remove_outbounds_boxes: int = 1

    # Loss weights (train_opts.py:27-33)
    mid_box_reg_weight: float = 0.05
    mid_objectness_weight: float = 0.1
    end_box_reg_weight: float = 0.1
    end_objectness_weight: float = 0.1
    captioning_weight: float = 1.0
    weight_decay: float = 1e-6
    box_reg_decay: float = 5e-5

    # Data input (train_opts.py:36-39)
    data_h5: str = "data/VG-regions.h5"
    data_json: str = "data/VG-regions-dicts.json"
    proposal_regions_h5: str = ""
    debug_max_train_images: int = -1

    # Optimization (train_opts.py:42-50)
    learning_rate: float = 1e-5
    optim_beta1: float = 0.9
    optim_beta2: float = 0.999
    optim_epsilon: float = 1e-8
    drop_prob: float = 0.3
    max_iters: int = 800000          # traingt.py:39
    checkpoint_start_from: str = ""
    finetune_cnn_after: int = -1
    val_images_use: int = 10

    # Checkpointing / artifacts (train_opts.py:53-64)
    save_checkpoint_every: int = 20000
    save_path: str = "runs/models/best_model_transformer_gt.ckpt"
    loss_file: str = "runs/loss_logs/loss_history_transformer_gt.json"
    result_file: str = "runs/logs/results_history_transformer_gt.json"
    from_checkpoint: bool = False
    use_lstm: bool = False
    num_layers: int = 1
    use_curriculum_learning: bool = False
    use_dropout: bool = False
    drop_value: float = 0.5
    finetune_cnn: bool = True

    # Test-time (train_opts.py:66-69)
    test_rpn_nms_thresh: float = 0.7
    test_final_nms_thresh: float = 0.3
    test_num_proposals: int = 1000

    # Visualization / logging (train_opts.py:72-73 + traingt.py:40)
    progress_dump_every: int = 100
    losses_log_every: int = 10
    loss_log_pad: int = 500          # traingt.py 'pad'

    # roi_only: the reference's detection-only RoiModel switch
    # (DenseCap/models.py:12-16)
    roi_only: bool = False

    # Misc (train_opts.py:76-82)
    id: str = ""
    seed: int = 123
    gpu: int = 0
    timing: bool = False
    clip_final_boxes: int = 1
    eval_first_iteration: int = 0

    # ---- additions without a reference counterpart (as in the JAX package) ----
    batch_size: int = 4              # reference is locked to 1 image/step
    max_regions: int = 32            # padded region slab per image
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    compute_dtype: str = "bfloat16"  # VGG trunk + classifier head
    param_dtype: str = "float32"
    eval_batch_size: int = 2
    debug_nans: bool = False
    profile_dir: str = ""        # profiler trace dir ('' = off)
    tensorboard_dir: str = ""    # '' = off; optional TB event stream
    vgg_stages: int = 5          # VGG trunk depth (5 = full; tests shrink)
    # Selects nothing in the port: on a CUDA tensor the ROI wrapper
    # always launches the hand-written kernel (and on a CPU tensor runs
    # its plain version). Kept so JAX-side configs and --set overrides
    # carry over unchanged.
    use_pallas_roi: bool = False
    apply_box_decay: bool = False
    anchor_sizes: Tuple[float, ...] = (64.0, 128.0, 256.0, 512.0)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    grad_accum_steps: int = 1    # micro-batches per optimizer update
    grad_clip_norm: float = 0.0
    encoder_init: str = ""

    def replace(self, **kw) -> "DenseConfig":
        return replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)


def apply_overrides(cfg: DenseConfig, pairs) -> DenseConfig:
    """`KEY=VALUE` strings → config fields, typed like the defaults (the
    root `traingt.py`'s parsing)."""
    for key, value in (kv.split("=", 1) for kv in pairs):
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, (int, float)):
            value = type(cur)(value)
        cfg = cfg.replace(**{key: value})
    return cfg


def get_gt_config() -> DenseConfig:
    """Reference `AlexGTModel/train_opts.get_config` (use_lstm=False)."""
    return DenseConfig(model_type="gt", use_lstm=False)


def name_gt_model(cfg: DenseConfig):
    """The traingt.py artifact rewrites (`traingt.py:26-37`):
    use_lstm → 'transformer'→'lstm'; use_dropout → 'gt'→'gt_drop{v}';
    finetune_cnn → 'gt'→'gt_finetuned' (order matters)."""
    loss_file, result_file, save_path = (cfg.loss_file, cfg.result_file,
                                         cfg.save_path)

    def rewrite(old: str, new: str):
        nonlocal loss_file, result_file, save_path
        loss_file = loss_file.replace(old, new)
        result_file = result_file.replace(old, new)
        save_path = save_path.replace(old, new)

    if cfg.use_lstm:
        rewrite("transformer", "lstm")
    if cfg.use_dropout:
        rewrite("gt", f"gt_drop{cfg.drop_value}")
    if cfg.finetune_cnn:
        rewrite("gt", "gt_finetuned")
    return loss_file, result_file, save_path
