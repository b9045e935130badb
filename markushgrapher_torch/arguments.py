"""Run-configuration schema + YAML parsing.

Mirrors the reference's HfArgumentParser-over-YAML bootstrap
(DS4SD/MarkushGrapher:markushgrapher/core/common/begin.py:32-58) and its argument
dataclasses (core/common/arguments.py: DataTrainingArguments :5-189,
ModelArguments :190-334). Key names are preserved so reference config YAMLs
(config/train.yaml, config/predict.yaml) port with minimal edits; unknown
keys are reported, not silently dropped.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from markushgrapher_torch.config import (
    MarkushGrapherConfig,
    SwinConfig,
    TrainConfig,
    VTLConfig,
)


@dataclass
class DataArguments:
    """Data/task knobs (reference DataTrainingArguments)."""

    datasets_config: str = ""            # path to datasets YAML
    dataset_name: str = ""               # entry in the datasets YAML
    image_size: int = 512                # arguments.py:126
    max_seq_length: int = 512            # arguments.py:132
    max_seq_length_decoder: int = 512    # arguments.py:139
    max_eval_samples: Optional[int] = None  # arguments.py:170
    use_pretrained_molscribe: bool = True   # arguments.py:182
    # curriculum knobs (arguments.py:19-42)
    curriculum: bool = False
    curriculum_patience: int = 3
    augment_train: bool = True
    # debug figures per eval run (reference writes <=100 PNGs)
    save_visualizations: int = 0
    # tracker task name (reference arguments.py:176; used when
    # report_to=clearml)
    clearml_task_name: str = "markushgrapher"


@dataclass
class ModelArguments:
    """Model knobs (reference ModelArguments)."""

    model_name_or_path: str = ""
    architecture_variant: str = "me-lf-stack-1"   # arguments.py:258
    beam_search: bool = False                     # arguments.py:264
    normalize_bbox: bool = True                   # arguments.py:270
    eval_benchmarks: Tuple[str, ...] = (
        "wildmol_m", "uspto_clean", "uspto_markush", "ip5_m")  # arguments.py:276-286
    # submodule weight paths + freeze flags (arguments.py:287-334)
    molscribe_weights: str = ""
    projector_weights: str = ""
    decoder_weights: str = ""
    freeze_molscribe_encoder: bool = True     # config/train.yaml:26-28
    freeze_molscribe_projector: bool = False
    freeze_decoder: bool = False
    loss_fct: str = "CE"                      # arguments.py:252
    # serving quantization (rebuild extension; no reference analog — the
    # reference serves full-precision per-image HF generate)
    quant_kv: bool = False        # int8 cross+self KV caches during decode
    quant_weights: bool = False   # int8 decode-step weights (+lm_head)
    int4_cross: bool = False      # int4 cross KV (coarser; needs quant_kv)
    # static packed lengths (0 = off): bias_int8 slab + encoder/cross-cache
    # packing (decode.generate.pack_encoder_for_cross, model
    # encoder_pack_len). Size via models.markushgrapher.encoder_valid_max
    # on a representative batch, rounded up to 256.
    bias_int8: bool = False       # int8 encoder bias slab (serving)
    bias_kernel: bool = False     # one-hot MXU bias builder (needs bias_int8)
    encoder_pack_len: int = 0     # packed VTL encoder bucket
    cross_pack_len: int = 0       # packed decode cross-cache bucket
    # architecture sizing (UDOP-large defaults)
    vocab_size: int = 33201
    d_model: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    d_ff: int = 4096


@dataclass
class TrainingArguments:
    """Trainer knobs (HF TrainingArguments subset used by config/train.yaml)."""

    output_dir: str = "output"
    learning_rate: float = 5e-4
    lr_scheduler_type: str = "inverse_sqrt"
    warmup_steps: int = 1000
    max_steps: int = 50000
    per_device_train_batch_size: int = 3
    per_device_eval_batch_size: int = 3
    gradient_accumulation_steps: int = 3
    eval_steps: int = 1000
    save_steps: int = 1000
    save_total_limit: int = 10
    logging_steps: int = 50
    bf16: bool = True
    seed: int = 42
    resume_from_checkpoint: Optional[str] = None
    metric_for_best_model: str = "mdu_ip5_m_ar_cxsmi_equality"
    report_to: str = "none"
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0


KNOWN_FIELDS = {
    f.name: cls
    for cls in (DataArguments, ModelArguments, TrainingArguments)
    for f in dataclasses.fields(cls)
}


def parse_yaml_config(path: str
                      ) -> Tuple[ModelArguments, DataArguments, TrainingArguments]:
    """One YAML file -> the three argument groups (begin.py:32-58 pattern).
    Unknown keys raise, listing them (the reference silently accepts any key
    HfArgumentParser knows; here the schema is explicit)."""
    import yaml

    with open(path) as f:
        raw: Dict[str, Any] = yaml.safe_load(f) or {}

    groups = {DataArguments: {}, ModelArguments: {}, TrainingArguments: {}}
    unknown = []
    for key, value in raw.items():
        cls = KNOWN_FIELDS.get(key)
        if cls is None:
            unknown.append(key)
        else:
            if key == "eval_benchmarks" and isinstance(value, list):
                value = tuple(value)
            groups[cls][key] = value
    if unknown:
        raise ValueError(
            f"unknown config keys {unknown} in {path}; known keys: "
            f"{sorted(KNOWN_FIELDS)}")
    return (ModelArguments(**groups[ModelArguments]),
            DataArguments(**groups[DataArguments]),
            TrainingArguments(**groups[TrainingArguments]))


def build_model_config(margs: ModelArguments, dargs: DataArguments
                       ) -> MarkushGrapherConfig:
    return MarkushGrapherConfig(
        vtl=VTLConfig(
            vocab_size=margs.vocab_size, d_model=margs.d_model,
            num_layers=margs.num_layers, num_decoder_layers=margs.num_layers,
            num_heads=margs.num_heads, d_ff=margs.d_ff,
            image_size=dargs.image_size),
        swin=SwinConfig(),
        architecture_variant=margs.architecture_variant,
        max_seq_length=dargs.max_seq_length,
        max_seq_length_decoder=dargs.max_seq_length_decoder,
    )


def build_train_config(targs: TrainingArguments, dargs: DataArguments,
                       margs: "ModelArguments" = None) -> TrainConfig:
    return TrainConfig(
        loss_fct=margs.loss_fct if margs is not None else "CE",
        learning_rate=targs.learning_rate,
        lr_schedule=targs.lr_scheduler_type,
        warmup_steps=targs.warmup_steps,
        max_steps=targs.max_steps,
        per_device_batch_size=targs.per_device_train_batch_size,
        gradient_accumulation_steps=targs.gradient_accumulation_steps,
        weight_decay=targs.weight_decay,
        max_grad_norm=targs.max_grad_norm,
        seed=targs.seed,
        dtype="bfloat16" if targs.bf16 else "float32",
        eval_steps=targs.eval_steps,
        save_steps=targs.save_steps,
        save_total_limit=targs.save_total_limit,
        curriculum=dargs.curriculum,
        curriculum_patience=dargs.curriculum_patience,
    )


def frozen_prefixes(margs: ModelArguments) -> Tuple[Tuple[str, ...], ...]:
    """Freeze-flag -> param-tree prefixes (begin.py:141-172 semantics)."""
    out = []
    if margs.freeze_molscribe_encoder:
        out.append(("molscribe_encoder",))
    if margs.freeze_molscribe_projector:
        out.append(("molscribe_projector",))
    if margs.freeze_decoder:
        out.append(("decoder",))
        out.append(("lm_head",))
    return tuple(out)


def train_settings(path: str) -> Tuple[TrainConfig, Tuple[Tuple[str, ...], ...]]:
    """(TrainConfig, frozen prefixes) of a training YAML such as
    configs/train.yaml."""
    margs, dargs, targs = parse_yaml_config(path)
    return build_train_config(targs, dargs, margs), frozen_prefixes(margs)
