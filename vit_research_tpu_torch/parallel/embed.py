"""Batched frame-embedding engine on one device or a mesh of them.

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

Spans (utils/profiling.py, recorded while a ``torch.profiler`` session
runs or aggregated under ``VRT_PROFILE``): ``engine.embed`` around a
call, with ``engine.slot_wait``, ``engine.stage`` (the host's copy into
a pinned buffer), ``engine.h2d``, ``engine.dispatch`` and
``engine.readback`` under it; ``engine.decode`` and
``engine.queue_wait`` in ``embed_paths``. ``batch`` counts the engine's
batches, so the spans of one batch share it.

Ragged tails run at their true size. The reference pads them to
power-of-two transfer buckets (``_transfer_bucket``) only to bound jit
retraces; eager PyTorch traces nothing, so the port has no buckets.

With ``mesh=`` (parallel/mesh.py) the engine is data-parallel, as the
reference's batch-sharded jit: the batch size is padded to a multiple of
the ``data`` axis, every device of that axis holds a replica of the model
(one replica a distinct device), each batch is split into one contiguous
share a device (a ragged batch at its true size: the shares differ by at
most a frame), each share runs kernels A and B on its device, and the
outputs come back in order on the mesh's first device.

The fast profile's models (ToMe, int8 GEMMs) run through the same
engine: kernel A, then ``encode_patch_tokens``. :func:`embed_video_strided`
embeds every Nth frame and interpolates between, with novelty-gated
refinement; :func:`strided_interp_device` is its interpolation as tensor
code on any device.
"""

from __future__ import annotations

import copy
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from vit_research_tpu_torch.data.preprocess import (
    HF_VIT_SPEC,
    LUMA_WEIGHTS,
    SIGLIP_SPEC,
    PreprocessSpec,
    load_frames,
)
from vit_research_tpu_torch.utils.configs import ViTConfig
from vit_research_tpu_torch.models.hf_import import (
    HF_VIT_B16_224,
    SIGLIP_SO400M_P14_384,
)
from vit_research_tpu_torch.ops.patch_embed import fused_patch_embed
from vit_research_tpu_torch.ops.tome import merged_token_counts
from vit_research_tpu_torch.parallel import mesh as mesh_lib
from vit_research_tpu_torch.utils import profiling


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
      mesh: in place of ``device``, a parallel/mesh.py ``Mesh`` with a
        ``data`` axis: the batch is split over its devices, each with a
        replica of the model.
      endpoint: which endpoint of the model to return.
    """

    def __init__(self, model, spec: PreprocessSpec, *, device=None,
                 mesh=None, batch_size: int = 256, endpoint: str = "pooled",
                 l2_normalize: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if (mesh is None) == (device is None):
            raise TypeError("EmbeddingEngine takes a device or a mesh")
        self.mesh = mesh
        #: the data-axis devices a batch is split over ([device] without
        #: a mesh); outputs gather on the first
        self.devices = ([mesh_lib.canonical_device(device)] if mesh is None
                        else mesh.axis_devices("data"))
        if mesh is not None:
            # whole per-device shares of a full batch
            batch_size = mesh_lib.pad_to_multiple(batch_size,
                                                  len(self.devices))
        self.device = self.devices[0]
        self.model = model.to(self.device).eval()
        #: one replica a distinct device (the first is ``model`` itself)
        self.replicas = {self.device: self.model}
        for dev in self.devices[1:]:
            if dev not in self.replicas:
                self.replicas[dev] = copy.deepcopy(self.model).to(dev)
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
        #: batches dispatched so far (the ``batch`` count of the spans)
        self._batches = 0

    def _out_trailing(self, c: ViTConfig) -> tuple:
        n = self.grid[0] * self.grid[1] + int(self.model.class_token)
        tokens = (n, c.hidden_size)
        if self.endpoint == "encoded_tokens" and c.tome_r:
            tokens = (merged_token_counts(n, c.tome_r, c.num_layers)[-1],
                      c.hidden_size)
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
    def encode(self, images_u8: torch.Tensor) -> dict:
        """(B, H, W, 3) uint8 on one of the engine's devices -> the
        endpoints dict of that device's replica (kernel A, then the
        encoder)."""
        spec = self.spec
        model = self.replicas[images_u8.device]
        if spec.grayscale:
            images_u8 = grayscale_u8(images_u8)
        pe = model.patch_embed
        tokens = fused_patch_embed(
            images_u8, pe.weight.to(torch.float32),
            pe.bias.to(torch.float32), patch_size=model.config.patch_size,
            rescale=spec.rescale, mean=spec.mean, std=spec.std,
            out_dtype=model.compute_dtype)
        return model.encode_patch_tokens(tokens, self.grid)

    @torch.inference_mode()
    def _forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the engine's device -> (B, ...) f32."""
        emb = self.encode(images_u8)[self.endpoint].to(torch.float32)
        if self.l2_normalize:
            emb = emb / torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True).clamp_min(1e-12)
        return emb

    def _to_device(self, batch_u8: np.ndarray, batch: int) -> torch.Tensor:
        """Host uint8 batch -> device tensor. On CUDA it goes through one
        of two pinned buffers with a non-blocking copy; a buffer is reused
        only after its previous copy has completed."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(batch_u8, np.uint8))
        n = len(batch_u8)
        if not self._pinned or self._pinned[0].shape[0] < n:
            shape = (max(n, self.batch_size), *batch_u8.shape[1:])
            self._pinned = [torch.empty(shape, dtype=torch.uint8,
                                        pin_memory=True) for _ in range(2)]
            self._copied = [torch.cuda.Event(), torch.cuda.Event()]
        slot = self._slot
        self._slot ^= 1
        with profiling.span("engine.slot_wait"):
            self._copied[slot].synchronize()
        buf = self._pinned[slot][:n]
        with profiling.span("engine.stage", bytes=buf.nbytes, batch=batch):
            buf.copy_(torch.from_numpy(
                np.ascontiguousarray(batch_u8, np.uint8)))
        with profiling.span("engine.h2d", bytes=buf.nbytes, batch=batch):
            dev = buf.to(self.device, non_blocking=True)
            self._copied[slot].record(torch.cuda.current_stream(self.device))
        return dev

    def _dispatch(self, batch_u8: np.ndarray):
        """Enqueue one batch: (its device output, its frames, its
        ``batch`` number)."""
        if tuple(batch_u8.shape[1:]) != (*self.spec.size, 3):
            raise ValueError(f"frames must be {(*self.spec.size, 3)}, got "
                             f"{tuple(batch_u8.shape[1:])}")
        n, batch = len(batch_u8), self._batches
        self._batches += 1
        if self.mesh is None:
            dev = self._to_device(batch_u8, batch)
            with profiling.span("engine.dispatch", frames=n, batch=batch):
                return self._forward(dev), n, batch
        # one contiguous share a data-axis device, each embedded on its
        # device, gathered in order on the first
        with profiling.span("engine.dispatch", frames=n, batch=batch):
            outs = [self._forward(torch.from_numpy(
                        np.ascontiguousarray(share, np.uint8)).to(dev))
                    for share, dev in zip(
                        np.array_split(batch_u8, len(self.devices)),
                        self.devices) if len(share)]
            return torch.cat([o.to(self.device) for o in outs]), n, batch

    # --------------------------------------------------------------- entry

    def warmup(self) -> None:
        """Run one full zero batch (a share on every device of a mesh):
        builds the CUDA kernels and the library handles before the first
        real batch is timed."""
        self.embed_batch(np.zeros((self.batch_size, *self.spec.size, 3),
                                  np.uint8))

    def embed_batch(self, batch_u8: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, ...) float32. B can exceed the engine
        batch size; sub-batches keep one batch in flight."""
        with profiling.span("engine.embed", frames=len(batch_u8)):
            return self._drain(
                batch_u8[s:s + self.batch_size]
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
        with profiling.span("engine.embed", frames=len(paths)):
            return self._embed_paths(paths, num_workers, use_native,
                                     prefetch)

    def _embed_paths(self, paths, num_workers, use_native, prefetch):
        def load(s):
            chunk = paths[s:s + self.batch_size]
            with profiling.span("engine.decode", frames=len(chunk)):
                return load_frames(chunk, self.spec, num_workers=num_workers,
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
                with profiling.span("engine.queue_wait") as wait:
                    item = q.get()
                    if isinstance(item, np.ndarray):
                        wait.set(frames=len(item))
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
        i+1 has been dispatched. The copy back is queued behind batch
        i+1's kernels, so ``engine.readback`` waits until batch i+1 is
        done, and the card then idles while the host stages the next
        batch (``engine.stage``): of a call's batches only the second is
        staged while the card works."""
        outs, pending = [], None
        for batch in batches:
            nxt = self._dispatch(batch)
            if pending is not None:
                outs.append(self._read_back(*pending))
            pending = nxt
        if pending is not None:
            outs.append(self._read_back(*pending))
        return (np.concatenate(outs, axis=0) if outs
                else np.zeros((0, *self.out_trailing), np.float32))

    @staticmethod
    def _read_back(out: torch.Tensor, n: int, batch: int) -> np.ndarray:
        with profiling.span("engine.readback", bytes=out.nbytes, batch=batch):
            return out.cpu().numpy()[:n]


# Default novelty gate for refined strided embedding: the cosine distance
# between a gap's two bounding keyframe embeddings above which the gap's
# interior frames are embedded exactly instead of interpolated (the
# reference's constant).
REFINE_THRESHOLD_DEFAULT = 0.05


def embed_video_strided(engine: EmbeddingEngine, paths, *, stride: int = 2,
                        interpolate: bool = True, num_workers: int = 8,
                        use_native: bool = False,
                        refine_threshold: float | None = None,
                        refine_radius: int = 0,
                        stats: dict | None = None) -> np.ndarray:
    """Embed every ``stride``-th frame exactly (and the last) and linearly
    interpolate the frames between: consecutive broadcast frames are
    nearly identical, and the kNN votes and HMM smoothing downstream are
    smooth in embedding space.

    ``refine_threshold`` (novelty-gated refinement): every gap whose two
    bounding keyframe embeddings differ by more than that cosine distance
    gets its interior frames embedded exactly in one extra pass;
    ``refine_radius`` also refines that many neighbouring gaps on each
    side. The gate only sees keyframes: an event shorter than ``stride``
    that lies strictly inside one gap is invisible to it, so choose
    ``stride`` <= the shortest event to localize. ``stats``, if given,
    receives ``gaps`` / ``refined_gaps`` / ``refined_frames`` / ``keys``
    / ``keys_s`` (and ``refine_embed_s``, ``novelty_p50``,
    ``novelty_max`` where they apply; times on the host clock).

    Returns (N, D) embeddings aligned with ``paths``, L2-normalised when
    the engine normalises."""
    if stride <= 0:
        raise ValueError(f"stride must be positive, got {stride}")
    if refine_radius < 0:
        raise ValueError(f"refine_radius must be >= 0, got {refine_radius}")
    n = len(paths)
    if n == 0:
        return np.zeros((0, engine.out_dim), np.float32)
    key_idx = list(range(0, n, stride))
    if key_idx[-1] != n - 1:
        key_idx.append(n - 1)
    t0 = time.monotonic()
    key_embs = engine.embed_paths([paths[i] for i in key_idx],
                                  num_workers=num_workers,
                                  use_native=use_native)
    t_keys = time.monotonic() - t0
    d = key_embs.shape[1]

    refined: dict[int, np.ndarray] = {}
    novelty = None
    refine_idx: list[int] = []
    hot_gaps = 0
    if refine_threshold is not None and len(key_idx) > 1:
        a, b = key_embs[:-1], key_embs[1:]
        den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
        novelty = 1.0 - np.sum(a * b, axis=1) / np.maximum(den, 1e-12)
        hot = novelty > refine_threshold
        if refine_radius and hot.any():
            dilated = hot.copy()
            for off in range(1, refine_radius + 1):
                dilated[off:] |= hot[:-off]
                dilated[:-off] |= hot[off:]
            hot = dilated
        hot_gaps = int(hot.sum())
        refine_idx = [i for j in np.nonzero(hot)[0]
                      for i in range(key_idx[j] + 1, key_idx[j + 1])]
        if refine_idx:
            t0 = time.monotonic()
            exact = engine.embed_paths([paths[i] for i in refine_idx],
                                       num_workers=num_workers,
                                       use_native=use_native)
            t_refine = time.monotonic() - t0
            refined = dict(zip(refine_idx, exact))
    if stats is not None:
        stats.update(gaps=max(len(key_idx) - 1, 0), refined_gaps=hot_gaps,
                     refined_frames=len(refine_idx), keys=len(key_idx),
                     keys_s=round(t_keys, 3))
        if refined:
            stats["refine_embed_s"] = round(t_refine, 3)
        if novelty is not None:
            stats.update(novelty_p50=float(np.median(novelty)),
                         novelty_max=float(novelty.max()))

    out = np.empty((n, d), np.float32)
    if not interpolate:
        # hold each keyframe's embedding until the next (zero-order hold)
        for j, i in enumerate(key_idx):
            end = key_idx[j + 1] if j + 1 < len(key_idx) else n
            out[i:end] = key_embs[j]
        for i, e in refined.items():
            out[i] = e
        return out
    for j in range(len(key_idx) - 1):
        i0, i1 = key_idx[j], key_idx[j + 1]
        span = i1 - i0
        w = np.arange(span, dtype=np.float32)[:, None] / span
        out[i0:i1] = (1.0 - w) * key_embs[j] + w * key_embs[j + 1]
    out[n - 1] = key_embs[-1]
    for i, e in refined.items():
        out[i] = e
    if engine.l2_normalize:
        out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
    return out


def strided_interp_device(key_embs: torch.Tensor, stride: int, n: int,
                          l2_normalize: bool = True) -> torch.Tensor:
    """:func:`embed_video_strided`'s interpolation as tensor code, on
    ``key_embs``' device. ``key_embs``: (K, D) embeddings of the key
    positions ``[0, stride, ..., n - stride, n - 1]`` (the layout
    embed_video_strided uses when ``stride`` divides ``n``; at
    ``stride == 1`` every frame, n keys). Returns (n, D) f32."""
    if n % stride != 0:
        raise ValueError(f"stride {stride} must divide n {n}")

    def normed(out):
        if not l2_normalize:
            return out
        return out / torch.clamp_min(
            torch.linalg.vector_norm(out, dim=1, keepdim=True), 1e-12)

    if stride == 1:
        if key_embs.shape[0] != n:
            raise ValueError(f"expected {n} keys for n={n} stride=1, "
                             f"got {key_embs.shape[0]}")
        return normed(key_embs.to(torch.float32))
    u = n // stride  # uniform keys; key_embs has u + 1 rows (tail key)
    if key_embs.shape[0] != u + 1:
        raise ValueError(f"expected {u + 1} keys for n={n} stride={stride}, "
                         f"got {key_embs.shape[0]}")
    dev = key_embs.device
    uni = key_embs[:u].to(torch.float32)
    last = key_embs[-1].to(torch.float32)
    w = torch.arange(stride, dtype=torch.float32, device=dev)[:, None] \
        / stride
    body = (uni[:-1, None, :] * (1.0 - w) + uni[1:, None, :] * w)
    body = body.reshape((u - 1) * stride, key_embs.shape[1])
    wt = (torch.arange(stride - 1, dtype=torch.float32, device=dev)[:, None]
          / max(stride - 1, 1))
    tail = uni[-1] * (1.0 - wt) + last * wt
    return normed(torch.cat([body, tail, last[None]], dim=0))


def make_hf_frame_embedder(state_dict=None, *, device, spec=None,
                           batch_size: int = 256, seed: int = 0,
                           grayscale: bool = False,
                           dtype: str = "float32", tome_r: int = 0,
                           gemm_quant: str | None = None,
                           gemm_quant_scales=()) -> EmbeddingEngine:
    """ViT-B/16 @224, CLS token, L2-normalised: the ``hf_vit_embed_batch``
    capability as one engine. Loads ``state_dict`` (e.g. from
    models/convert.py) when given, else the port's seeded init.
    ``grayscale`` embeds luminance-converted frames (ignored when an
    explicit ``spec`` is passed; set it there). ``dtype='bfloat16'`` runs
    the encoder in bf16, a speed setting, not a parity one. ``tome_r``
    merges tokens (ops/tome.py) and ``gemm_quant`` runs int8 encoder
    GEMMs (ops/quant.py; ``'int8-static'`` with ``gemm_quant_scales``):
    the fast profile's speed settings, on the same weights. A
    ``transformers.ViTModel`` state dict loads after
    models/hf_import.py::hf_state_dict_to_state_dict."""
    from vit_research_tpu_torch.models.vit import init_vit

    if spec is None and grayscale:
        spec = dataclasses.replace(HF_VIT_SPEC, grayscale=True)
    cfg = dataclasses.replace(HF_VIT_B16_224, dtype=dtype, tome_r=tome_r,
                              gemm_quant=gemm_quant,
                              gemm_quant_scales=tuple(gemm_quant_scales))
    model = init_vit(cfg, seed=seed, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return EmbeddingEngine(model, spec or HF_VIT_SPEC, device=device,
                           batch_size=batch_size, endpoint="pooled",
                           l2_normalize=True)


def make_siglip_frame_embedder(state_dict=None, *, device,
                               batch_size: int = 64, grayscale: bool = False
                               ) -> EmbeddingEngine:
    """SigLIP so400m/14 at 384's vision tower (no class token, the
    attention-pooling head), its pooled output L2-normalised: 1,152-wide
    rows. Kernel A runs at P = 14, then the encoder. Loads ``state_dict``
    (a ``transformers.SiglipVisionModel``'s after
    models/hf_import.py::siglip_state_dict_to_port) when given, else the
    port's seeded init."""
    from vit_research_tpu_torch.models.vit import init_vit

    spec = dataclasses.replace(SIGLIP_SPEC, grayscale=grayscale)
    model = init_vit(SIGLIP_SO400M_P14_384, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return EmbeddingEngine(model, spec, device=device, batch_size=batch_size,
                           endpoint="pooled", l2_normalize=True)
