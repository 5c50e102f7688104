"""Backbone configuration.

Port of ``ViTConfig`` from vit_research_tpu/utils/configs.py, with the
same fields and defaults, so a configuration reads the same in both
packages. The port's backbone refuses the fields it does not implement
(``remat``, ``attn_layout='bthd'``) and does not read
``use_flash_attention``: its attention kernel is the default
(models/vit.py). ``tome_r``, ``gemm_quant`` and ``gemm_quant_scales``
are the fast profile's (ops/tome.py, ops/quant.py).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ViTConfig:
    """Vision Transformer backbone hyperparameters: the random-init
    patch-32 model at 432x768 and google/vit-base-patch16-224 at 224x224
    are both instances."""

    image_size: tuple = (224, 224)  # (H, W)
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout_rate: float = 0.0
    attention_dropout_rate: float = 0.0
    pooler: str = "token"  # 'token' | 'gap' | 'none'
    representation_size: int | None = None  # pre_logits dense, None = identity
    layer_norm_eps: float = 1e-6
    # 'exact' matches HF ViT (erf GELU); 'tanh' is the cheaper approximation.
    gelu_approximate: bool = False
    dtype: str = "float32"  # compute dtype: 'float32' | 'bfloat16'
    use_flash_attention: bool = False
    # Attention-softmax compute dtype: 'float32' (parity) or 'bfloat16'.
    softmax_dtype: str = "float32"
    attn_layout: str = "bhtd"
    output_attention_scores: bool = False
    remat: bool = False
    tome_r: int = 0
    gemm_quant_scales: tuple = ()
    gemm_quant: str | None = None

    @property
    def grid(self) -> tuple:
        return (self.image_size[0] // self.patch_size,
                self.image_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw
