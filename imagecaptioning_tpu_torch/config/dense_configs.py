"""Configuration for the dense captioners, the GT-box model and the RPN
model (copy of `imagecaptioning_tpu/config/dense_configs.py`).

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
from typing import Any, Dict, Optional, Tuple


@dataclass
class DenseConfig:
    """One config for GTDenseCaptioner and DenseCapRPN."""

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
    # a torchrun launch's ranks (parallel/mesh.py): -1 = all on 'data'
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


def _parse_tuple(value: str, like: tuple) -> tuple:
    """A comma-separated override, each item typed like the default's
    (`mesh_shape` ints, `mesh_axis_names` strings, the anchor floats)."""
    typ = type(like[0]) if like else str
    return tuple(typ(x.strip()) for x in value.split(","))


def apply_overrides(cfg: DenseConfig, pairs) -> DenseConfig:
    """`KEY=VALUE` strings → config fields, typed like the defaults (the
    root `traingt.py`'s parsing)."""
    for key, value in (kv.split("=", 1) for kv in pairs):
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, (int, float)):
            value = type(cur)(value)
        elif isinstance(cur, tuple):
            value = _parse_tuple(value, cur)
        cfg = cfg.replace(**{key: value})
    return cfg


def get_gt_config() -> DenseConfig:
    """Reference `AlexGTModel/train_opts.get_config` (use_lstm=False)."""
    return DenseConfig(model_type="gt", use_lstm=False)


def get_densecap_config() -> DenseConfig:
    """Reference `DenseCap/train_opts.get_config` (use_lstm=True)."""
    return DenseConfig(
        model_type="rpn",
        use_lstm=True,
        save_path="runs/models/best_model_densecap.ckpt",
        loss_file="runs/loss_logs/loss_history_densecap.json",
        result_file="runs/logs/results_history_densecap.json",
    )


@dataclass
class RegionLMConfig(DenseConfig):
    """The GT-box captioner with a decoder-only language model as its
    caption head (`models/densecap.GTRegionLMCaptioner`): the language
    model's keys as its published config names them, and the fixed prompt
    that follows each region token. Defaults: Kimi-VL-A3B-Instruct's
    language model (huggingface.co/moonshotai/Kimi-VL-A3B-Instruct,
    config.json's `text_config`), the one configuration it is built for;
    `models/moe_lm.LMSpec.from_config` refuses values it does not compute.
    """

    vocab_size: int = 163840
    max_position_embeddings: int = 131072
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    ep_size: int = 1
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    seq_aux: bool = True
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    prompt_length: int = 16


def get_gt_kimivl_config() -> RegionLMConfig:
    """The GT captioner with Kimi-VL-A3B's language model, served in bf16
    (trunk, classifier, projectors and language model)."""
    return RegionLMConfig(model_type="gt", use_lstm=False,
                          param_dtype="bfloat16")


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
