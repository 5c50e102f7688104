"""TemporalHead: a 1-D CNN over per-frame embedding sequences.

Port of vit_research_tpu/models/temporal_head.py (the reference's side
classifier, nba_proj/smarter_generate_clips.py:189-214): five Conv1d
layers 768->256->256->128->64->3 with kernels 9/7/5/3/1 and ReLU, 'same'
padding, giving per-frame left/right/none logits. The public layout is
the JAX package's: (B, T, D) in, (B, T, 3) out. Training takes the
cross-entropy with ``ignore_index=-1`` (:func:`masked_cross_entropy`;
train/train_temporal.py).

On a CUDA device the convolutions run on cuDNN, whose float32 default
is TF32 (``torch.backends.cudnn.allow_tf32`` is True, unlike matmul's
flag). The JAX package computes float32, so the forward runs inside
:func:`f32_convolutions`, whatever the global flag says; training keeps
its backward inside the same scope. None of this ports a Pallas kernel:
the reference's head is XLA convolutions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_research_tpu_torch.models.vit import _lecun_normal_

#: (out channels, kernel) of the four hidden layers
SPECS = ((256, 9), (256, 7), (128, 5), (64, 3))


def f32_convolutions():
    """A scope in which cuDNN convolutions compute in float32 (TF32 off)
    and the global flags are restored after."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


class TemporalHead(nn.Module):
    """(B, T, D) embeddings -> (B, T, num_classes) per-frame logits.

    Modules ``conv_0`` .. ``conv_3`` and ``conv_out`` carry the flax
    names; weights cross with models/convert.py's
    ``temporal_head_to_state_dict`` / ``temporal_head_to_params``. The
    seeded init (a ``torch.Generator``: flax's lecun-normal kernels, zero
    biases) draws other numbers than ``jax.random``."""

    def __init__(self, embed_dim: int = 768, num_classes: int = 3, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [embed_dim] + [f for f, _ in SPECS]
        for i, (feat, k) in enumerate(SPECS):
            setattr(self, f"conv_{i}",
                    nn.Conv1d(dims[i], feat, k, padding="same"))
        self.conv_out = nn.Conv1d(dims[-1], num_classes, 1)
        with torch.no_grad():
            for conv in self.convs():
                _lecun_normal_(conv.weight, conv.in_channels
                               * conv.kernel_size[0], generator)
                conv.bias.zero_()

    def convs(self) -> list:
        return [getattr(self, f"conv_{i}") for i in range(len(SPECS))] + \
            [self.conv_out]

    def forward(self, x):
        with f32_convolutions():
            x = x.to(torch.float32).transpose(1, 2)  # (B, D, T)
            for conv in self.convs()[:-1]:
                x = F.relu(conv(x))
            return self.conv_out(x).transpose(1, 2)


def masked_cross_entropy(logits, labels, ignore_index: int = -1):
    """Mean cross-entropy over the frames whose label is not
    ``ignore_index`` (0 when every frame is ignored), as the reference's
    ``CrossEntropyLoss(ignore_index=-1)``
    (nba_proj/smarter_generate_clips.py:251)."""
    logits = logits.reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1).to(torch.int64)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    nll = -torch.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)
