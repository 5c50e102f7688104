"""Host uint8 frames through ``EmbeddingEngine.embed_batch`` with SigLIP's
vision tower: the pinned staging and copy, kernel A at P = 14 (K = 588),
27 blocks with heads of 72 (kernel B zero-pads them to 96) and the
4,304-wide MLP, the attention-pooling head, the pooled row
L2-normalised, and the readback.

Every call embeds the whole pool of distinct frames (several engine
batches). What is compared: from every call a sample of rows drawn from
the seed, and every row of the last call, against the reference's
embeddings of the same frames (``harness/siglip.py``).
"""

from __future__ import annotations

import torch

from harness import compare, cost, seeds, siglip, traffic
from harness.entries import Clock
from harness.entries import embed


def vit_config(cfg: dict):
    """The program's ``ViTConfig`` for a SigLIP configuration file: no
    class token, the ``map`` pooler (a program without them refuses
    here, before anything is drawn)."""
    from vit_research_tpu_torch.utils.configs import ViTConfig

    return ViTConfig(
        image_size=cost.image_hw(cfg), patch_size=cfg["patch_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["intermediate_size"],
        layer_norm_eps=cfg["layer_norm_eps"], pooler="map",
        class_token=False,
        gelu_approximate=cfg["hidden_act"] == "gelu_pytorch_tanh",
        dtype=cfg["dtype"])


class Entry(embed.Entry):
    span = "embed_batch"

    def __init__(self, cfg: dict, t: dict, seed: int, device):
        from vit_research_tpu_torch.data.preprocess import PreprocessSpec
        from vit_research_tpu_torch.models.vit import VisionTransformer
        from vit_research_tpu_torch.ops import attention, linear, patch_embed
        from vit_research_tpu_torch.parallel.embed import EmbeddingEngine

        vcfg = vit_config(cfg)
        self.cfg, self.t, self.device = cfg, t, torch.device(device)
        clock = Clock()
        self.weights = siglip.weights(cfg, seed, self.device)
        clock("weights")
        self.frames = traffic.frames(cost.image_hw(cfg), t, seed, self.device)
        clock("frames")
        with torch.device(self.device):
            model = VisionTransformer(vcfg)
        clock("model_init")
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(self.weights[name])
        clock("model_load")
        pre = cfg["preprocess"]
        spec = PreprocessSpec(size=cost.image_hw(cfg),
                              rescale=pre["rescale"], mean=tuple(pre["mean"]),
                              std=tuple(pre["std"]),
                              interpolation=pre["interpolation"])
        self.engine = EmbeddingEngine(model, spec, device=self.device,
                                      batch_size=cfg["batch"],
                                      endpoint="pooled", l2_normalize=True)
        clock("engine")
        self._attention = attention.multi_head_attention
        self._route = linear.route
        self._counters = {"kernel_b": attention.multi_head_attention,
                          "kernel_a": patch_embed.fused_patch_embed,
                          "linear": linear.linear}
        self._sample = seeds.rng(seed, "sample")
        self.kept, self.last = [], None
        self.engine.embed_batch(self.frames)  # warm-up: the window's call
        clock("warmup")
        self.setup_phases = clock.phases
        self._counts0 = self._counts()
        self._padded0 = self._attention.padded_launches
        self._declined0 = self._route.declined_shape

    def run_info(self, calls: list) -> dict:
        info = super().run_info(calls)
        batch = self.cfg["batch"]
        info["launches"]["kernel_b_padded"] = (
            self._attention.padded_launches - self._padded0)
        # products ops/linear.py's rule sent to the library for K or N
        info["launches"]["linear_declined_shape"] = (
            self._route.declined_shape - self._declined0)
        info.update(flops_per_frame=siglip.flops_per_frame(self.cfg),
                    linear_bound_s=siglip.linear_bound_s(self.cfg, batch),
                    attention_bound_s=siglip.attention_bound_s(self.cfg,
                                                               batch))
        return info

    def checks(self) -> dict:
        want = siglip.embed_frames(self.weights, self.cfg, self.frames,
                                   self.device)
        return {"embed_gap": self._gap(want)}

    def control(self) -> dict:
        """The reference in TF32 in the program's place, held to the same
        comparison."""
        want = siglip.embed_frames(self.weights, self.cfg, self.frames,
                                   self.device)
        low = siglip.embed_frames(self.weights, self.cfg, self.frames,
                                  self.device, tf32=True)
        return {"embed_gap": compare.embed_gap(low, want)}
