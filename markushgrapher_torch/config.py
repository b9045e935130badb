"""Model / run configuration dataclasses.

Mirrors the capability surface of the reference configs
(`DS4SD/MarkushGrapher:config/train.yaml`, `config/predict.yaml`) and the UDOP
config schema (transformers configuration_udop.py:89-113), re-expressed as
plain frozen dataclasses. The port's own copy of
`markushgrapher_tpu.config`, so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class VTLConfig:
    """Vision-text-layout (UDOP-style) encoder-decoder configuration.

    Defaults follow the UDOP-large backbone used by the reference model
    (transformers/models/udop/configuration_udop.py defaults; image_size
    overridden to 512 per DS4SD/MarkushGrapher:config/train.yaml and
    begin.py:106-109).
    """

    vocab_size: int = 33201
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 4096
    num_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    # horizontal / vertical 2D biases use coordinate scaling x100 and
    # max_distance 100 (modeling_udop.py RelativePositionBiasHorizontal/Vertical)
    rel2d_scaling_factor: int = 100
    rel2d_max_distance: int = 100
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" | "gated-gelu"
    max_2d_position_embeddings: int = 1024
    # UdopCellEmbeddings table size = max_2d_position_embeddings
    # (modeling_udop.py UdopStack: UdopCellEmbeddings(config.max_2d_position_embeddings, ...))
    cell_embeddings_size: int = 1024
    image_size: int = 512
    patch_size: int = 16
    num_channels: int = 3
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    tie_word_embeddings: bool = False  # UDOP uses untied lm_head

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_side ** 2


@dataclass(frozen=True)
class SwinConfig:
    """Swin transformer config for the OCSR (MolScribe-style) vision encoder.

    Swin-B layout (README.md:212 of the reference: MolScribe Swin-B encoder).
    """

    image_size: int = 384
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 128
    depths: Sequence[int] = (2, 2, 18, 2)
    num_heads: Sequence[int] = (4, 8, 16, 32)
    window_size: int = 12
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-5

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


@dataclass(frozen=True)
class MarkushGrapherConfig:
    """Full two-branch model: OCSR pipeline (Swin -> projector -> e1) +
    VTL pipeline (UDOP encoder -> e2), concatenated ("me-lf-stack-1",
    README.md:210-215 of the reference) and decoded by the T5 decoder.
    """

    vtl: VTLConfig = field(default_factory=VTLConfig)
    swin: SwinConfig = field(default_factory=SwinConfig)
    # "me-lf-stack-1" = both branches; "me-lf-stack-1-molscribe-only" drops VTL;
    # "none" = VTL only (utils_model_loading.py:20-42 of the reference).
    architecture_variant: str = "me-lf-stack-1"
    # MLP projector from swin features to d_model
    projector_hidden: int = 2048
    # number of OCSR tokens after projection (Swin 384/32=12 -> 144 tokens)
    max_seq_length: int = 512
    max_seq_length_decoder: int = 512

    @property
    def ocsr_tokens(self) -> int:
        side = self.swin.image_size // (self.swin.patch_size * 2 ** (len(self.swin.depths) - 1))
        return side * side

    @property
    def encoder_total_len(self) -> int:
        """Encoder output length seen by the decoder cross-attention."""
        vtl_len = self.max_seq_length + self.vtl.num_patches
        if self.architecture_variant == "me-lf-stack-1-molscribe-only":
            return self.ocsr_tokens
        if self.architecture_variant == "none":
            return vtl_len
        return self.ocsr_tokens + vtl_len


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: config/train.yaml:36-63)."""

    learning_rate: float = 5e-4
    lr_schedule: str = "inverse_sqrt"
    warmup_steps: int = 1000
    max_steps: int = 50000
    per_device_batch_size: int = 3
    gradient_accumulation_steps: int = 3
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    label_smoothing: float = 0.0
    # "CE" (model-internal cross-entropy) or "huber" (train/losses.py;
    # reference arguments.py:252 loss_fct)
    loss_fct: str = "CE"
    seed: int = 0
    dtype: str = "bfloat16"
    eval_steps: int = 1000
    save_steps: int = 1000
    save_total_limit: int = 10
    # curriculum (reference arguments.py:19-42; off by default like train.yaml:66)
    curriculum: bool = False
    curriculum_patience: int = 3
    curriculum_threshold: float = 0.0
    remat: bool = True  # jax.checkpoint the encoder/decoder blocks


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
