"""Batched frame-embedding engine on one device.

Port of vit_research_tpu/parallel/embed.py::EmbeddingEngine for the
embedding main path:

- host threads decode JPEGs into uint8 batches (the only host work); a
  producer thread decodes ahead of the device (``embed_paths``);
- batches go to the card through pinned host buffers with
  ``non_blocking`` copies, so the copy overlaps the previous batch's work;
- on the device, normalise + patchify + project run fused
  (ops/patch_embed.py), then the ViT encoder (models/vit.py), then the
  chosen endpoint, optionally L2-normalised;
- one batch stays in flight while the next is decoded and dispatched.

Ragged tails run at their true size. The reference pads them to
power-of-two transfer buckets (``_transfer_bucket``) only to bound jit
retraces; eager PyTorch traces nothing, so the port has no buckets.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from vit_research_tpu_torch.data.preprocess import (
    HF_VIT_SPEC,
    LUMA_WEIGHTS,
    PreprocessSpec,
    load_frames,
)
from vit_research_tpu_torch.utils.configs import ViTConfig
from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.models.hf_import import HF_VIT_B16_224
from vit_research_tpu_torch.ops.patch_embed import fused_patch_embed


def grayscale_u8(images: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 -> luminance replicated over 3 channels, uint8, with
    the host oracle's semantics (data/preprocess.py::to_grayscale_3ch:
    f32 dot with LUMA_WEIGHTS, clip, truncating cast).

    The sum is taken as (r*w0 + b*w2) + g*w1 in f32, with no fused
    multiply-add: over all 2^24 colours that order matches the oracle's
    numpy/BLAS result on (..., W, 3) frames but for about one colour in
    10^7, which is as close as the oracle itself comes to its own result
    on arrays of another shape."""
    w = torch.tensor(LUMA_WEIGHTS, dtype=torch.float32, device=images.device)
    x = images.to(torch.float32)
    gray = (x[..., 0] * w[0] + x[..., 2] * w[2]) + x[..., 1] * w[1]
    gray = gray.clamp(0, 255).to(torch.uint8)
    return gray.unsqueeze(-1).expand(*gray.shape, 3).contiguous()


class EmbeddingEngine:
    """(N, H, W, 3) uint8 frames -> (N, ...) float32 embeddings.

    Args:
      model: models/vit.py::VisionTransformer (moved to ``device``).
      spec: host preprocessing spec; ``spec.size`` is the frame size.
      device: where the model runs (``'cuda'`` runs the CUDA kernels).
      endpoint: which endpoint of the model to return.
    """

    def __init__(self, model, spec: PreprocessSpec, *, device,
                 batch_size: int = 256, endpoint: str = "pooled",
                 l2_normalize: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = spec
        self.batch_size = batch_size
        self.endpoint = endpoint
        self.l2_normalize = l2_normalize
        c = model.config
        self.grid = (spec.size[0] // c.patch_size,
                     spec.size[1] // c.patch_size)
        #: per-example output shape (keeps the (N, ...) contract for N == 0)
        self.out_trailing = self._out_trailing(c)
        #: output embedding width (last axis)
        self.out_dim = self.out_trailing[-1]
        self._pinned: list[torch.Tensor] = []
        self._copied: list = []
        self._slot = 0

    def _out_trailing(self, c: ViTConfig) -> tuple:
        tokens = (self.grid[0] * self.grid[1] + 1, c.hidden_size)
        pooled = tokens if c.pooler == "none" else (c.hidden_size,)
        if self.endpoint in ("tokens_before_encoder", "encoded_tokens"):
            return tokens
        if self.endpoint == "pooled":
            return pooled
        if self.endpoint == "pre_logits":
            if c.representation_size is None or c.pooler == "none":
                return pooled
            return (c.representation_size,)
        raise ValueError(f"unknown endpoint {self.endpoint!r}")

    # ------------------------------------------------------------- forward

    @torch.inference_mode()
    def _forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the engine's device -> (B, ...) f32."""
        spec = self.spec
        model = self.model
        if spec.grayscale:
            images_u8 = grayscale_u8(images_u8)
        pe = model.patch_embed
        tokens = fused_patch_embed(
            images_u8, pe.weight.to(torch.float32),
            pe.bias.to(torch.float32), patch_size=model.config.patch_size,
            rescale=spec.rescale, mean=spec.mean, std=spec.std,
            out_dtype=model.compute_dtype)
        out = model.encode_patch_tokens(tokens, self.grid)
        emb = out[self.endpoint].to(torch.float32)
        if self.l2_normalize:
            emb = emb / torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True).clamp_min(1e-12)
        return emb

    def _to_device(self, batch_u8: np.ndarray) -> torch.Tensor:
        """Host uint8 batch -> device tensor. On CUDA it goes through one
        of two pinned buffers with a non-blocking copy; a buffer is reused
        only after its previous copy has completed."""
        host = torch.from_numpy(np.ascontiguousarray(batch_u8, np.uint8))
        if self.device.type != "cuda":
            return host
        n = host.shape[0]
        if not self._pinned or self._pinned[0].shape[0] < n:
            shape = (max(n, self.batch_size), *host.shape[1:])
            self._pinned = [torch.empty(shape, dtype=torch.uint8,
                                        pin_memory=True) for _ in range(2)]
            self._copied = [torch.cuda.Event(), torch.cuda.Event()]
        slot = self._slot
        self._slot ^= 1
        self._copied[slot].synchronize()
        buf = self._pinned[slot][:n]
        buf.copy_(host)
        dev = buf.to(self.device, non_blocking=True)
        self._copied[slot].record(torch.cuda.current_stream(self.device))
        return dev

    def _dispatch(self, batch_u8: np.ndarray):
        if tuple(batch_u8.shape[1:]) != (*self.spec.size, 3):
            raise ValueError(f"frames must be {(*self.spec.size, 3)}, got "
                             f"{tuple(batch_u8.shape[1:])}")
        return self._forward(self._to_device(batch_u8)), len(batch_u8)

    # --------------------------------------------------------------- entry

    def warmup(self) -> None:
        """Run one full zero batch: builds the CUDA kernels and the
        library handles before the first real batch is timed."""
        self.embed_batch(np.zeros((self.batch_size, *self.spec.size, 3),
                                  np.uint8))

    def embed_batch(self, batch_u8: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, ...) float32. B can exceed the engine
        batch size; sub-batches keep one batch in flight."""
        return self._drain(batch_u8[s:s + self.batch_size]
                           for s in range(0, len(batch_u8), self.batch_size))

    def embed_paths(self, paths, num_workers: int = 8,
                    use_native: bool = False,
                    prefetch: int = 2) -> np.ndarray:
        """Decode -> embed with host/device overlap: a producer thread
        decodes up to ``prefetch`` batches ahead into a bounded queue while
        the main thread dispatches and reads back. ``use_native`` decodes
        JPEGs with the libjpeg decoder (native/jpeg.py) where it is
        available, else with PIL, as data/preprocess.py::load_frames does.
        ``prefetch=0`` decodes inline."""
        if len(paths) == 0:
            return np.zeros((0, *self.out_trailing), np.float32)

        def load(s):
            return load_frames(paths[s:s + self.batch_size], self.spec,
                               num_workers=num_workers,
                               use_native=use_native)

        starts = range(0, len(paths), self.batch_size)
        if prefetch <= 0:
            return self._drain(load(s) for s in starts)

        q: queue.Queue = queue.Queue(maxsize=prefetch)
        done = object()
        stop = threading.Event()  # set when the consumer abandons the run

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for s in starts:
                    if not put(load(s)):
                        return
                put(done)
            except BaseException as e:  # surfaced on the consumer side
                put(e)

        t = threading.Thread(target=produce, daemon=True,
                             name="embed-decode-prefetch")
        t.start()

        def consume():
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        try:
            return self._drain(consume())
        finally:
            # On an early exit unblock the producer and drop parked batches.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=30.0)

    def _drain(self, batches) -> np.ndarray:
        """Dispatch uint8 batches, reading back batch i only after batch
        i+1 has been dispatched (the device never waits on the host)."""
        outs, pending = [], None
        for batch in batches:
            nxt = self._dispatch(batch)
            if pending is not None:
                outs.append(pending[0].cpu().numpy()[:pending[1]])
            pending = nxt
        if pending is not None:
            outs.append(pending[0].cpu().numpy()[:pending[1]])
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, *self.out_trailing), np.float32))


def make_hf_frame_embedder(state_dict=None, *, device, spec=None,
                           batch_size: int = 256, seed: int = 0,
                           grayscale: bool = False,
                           dtype: str = "float32") -> EmbeddingEngine:
    """ViT-B/16 @224, CLS token, L2-normalised: the ``hf_vit_embed_batch``
    capability as one engine. Loads ``state_dict`` (e.g. from
    models/convert.py) when given, else the port's seeded init.
    ``grayscale`` embeds luminance-converted frames (ignored when an
    explicit ``spec`` is passed; set it there). ``dtype='bfloat16'`` runs
    the encoder in bf16, a speed setting, not a parity one. A
    ``transformers.ViTModel`` state dict loads after
    models/hf_import.py::hf_state_dict_to_state_dict."""
    from vit_research_tpu_torch.models.vit import init_vit

    if spec is None and grayscale:
        spec = dataclasses.replace(HF_VIT_SPEC, grayscale=True)
    cfg = (HF_VIT_B16_224 if dtype == "float32"
           else dataclasses.replace(HF_VIT_B16_224, dtype=dtype))
    model = init_vit(cfg, seed=seed, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return EmbeddingEngine(model, spec or HF_VIT_SPEC, device=device,
                           batch_size=batch_size, endpoint="pooled",
                           l2_normalize=True)
