"""Structured, serializable experiment configuration.

Port of vit_research_tpu/utils/configs.py, with the same fields, defaults,
JSON form, run ids and presets, so a configuration reads the same in both
packages and a ``config.json`` written by either loads in the other. The
port's backbone refuses the ``ViTConfig`` fields it does not implement
(``remat``, ``attn_layout='bthd'``) and does not read
``use_flash_attention``: its attention kernel is the default
(models/vit.py). ``tome_r``, ``gemm_quant`` and ``gemm_quant_scales``
are the fast profile's (ops/tome.py, ops/quant.py). ``ViTConfig`` has
fields the reference lacks (``class_token``, for the SigLIP-class
backbone); such a field is marked ``port_only`` and is left out of the
dict and JSON forms while it holds its default, so every configuration
the reference can express reads and writes as the reference's does.
"""

from __future__ import annotations

import dataclasses
import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any


def _asdict(obj: Any) -> Any:
    """Dataclasses to dicts, tuples to lists (JSON's form); a
    ``port_only`` field at its default is left out."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if not (f.metadata.get("port_only")
                        and getattr(obj, f.name) == f.default)}
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    return obj


class _Serializable:
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict):
        """Unknown keys are dropped; nested config dicts are rebuilt into
        their dataclasses and lists into tuples where the field is one."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            sub = _CONFIG_TYPES.get(
                str(fields[k].type).split(".")[-1].strip("'\" "))
            if sub is not None and isinstance(v, dict):
                v = sub.from_dict(v)
            if isinstance(v, list) and _is_tuple_field(fields[k]):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


def _is_tuple_field(f: dataclasses.Field) -> bool:
    t = str(f.type)
    return "tuple" in t or "Tuple" in t


@dataclass(frozen=True)
class ViTConfig(_Serializable):
    """Vision Transformer backbone hyperparameters: the random-init
    patch-32 model at 432x768 and google/vit-base-patch16-224 at 224x224
    are both instances, and so is SigLIP's vision tower (no class token,
    the ``map`` pooler: models/vit.py::MAPHead)."""

    image_size: tuple = (224, 224)  # (H, W)
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout_rate: float = 0.0
    attention_dropout_rate: float = 0.0
    pooler: str = "token"  # 'token' | 'gap' | 'map' | 'none'
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
    # a learned class token before the patch tokens (the position table
    # then has num_patches + 1 rows); SigLIP has none
    class_token: bool = field(default=True, metadata={"port_only": True})

    @property
    def grid(self) -> tuple:
        return (self.image_size[0] // self.patch_size,
                self.image_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw


VIT_B16_224 = ViTConfig(image_size=(224, 224), patch_size=16)
VIT_P32_432x768 = ViTConfig(image_size=(432, 768), patch_size=32)


@dataclass(frozen=True)
class ChunkEncoderConfig(_Serializable):
    """Stage-1 temporal chunk encoder: hidden 768, 3 layers, 8 heads
    (head width 96), inner dim 4x, at most 24 frames a chunk."""

    embed_dim: int = 768
    num_layers: int = 3
    num_heads: int = 8
    mlp_dim: int = 3072
    max_len: int = 24  # >= chunk_size: the pos table is sized to it
    dropout_rate: float = 0.1
    dtype: str = "float32"


@dataclass(frozen=True)
class HeadConfig(_Serializable):
    """RAG/RATT head family."""

    embed_dim: int = 768
    num_layers: int = 2
    num_heads: int = 4
    mlp_dim: int = 128  # RATTHeadV2's classifier width
    num_queries: int = 4  # RetrievalMultiQueryPooler learned queries
    max_tokens: int = 128  # RATTHead pos-emb budget
    hidden_dim: int = 256  # classifier hidden (Dense 256 -> 1)
    dropout_rate: float = 0.0
    classifier_dropout: float = 0.2
    dtype: str = "float32"
    k_sim: int = 6
    k_contrast: int = 6
    k_temporal: int = 4


@dataclass(frozen=True)
class RetrievalConfig(_Serializable):
    """Retriever and cache knobs."""

    collection: str = "ragdb"
    top_k: int = 5
    search_k: int = 50
    search_k_content: int = 64
    search_k_temporal: int = 32
    future_chunk_step: int = 2
    hard_negative_ratio: float = 0.30
    candidates_per_bin: int = 48
    query_mult: int = 4
    per_video_cap: int = 8
    global_cap: int = 24
    min_time_gap: float = 0.02
    lambda_global: float = 0.35
    time_window: float = 0.2  # t_norm window half-width fallback


@dataclass(frozen=True)
class TrainConfig(_Serializable):
    """Optimization knobs shared by the training loops."""

    batch_size: int = 8
    num_epochs: int = 24
    lr_phase1: float = 1e-4
    lr_phase2: float = 1e-5
    phase_split: float = 0.5  # fraction of epochs on phase-1 LR
    accum_steps: int = 4  # gradient accumulation
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    label_smoothing: float = 0.0
    contrastive_weight: float = 0.1
    # the contrastive coefficient after the phase boundary; None keeps
    # contrastive_weight for the whole run
    contrastive_weight_phase2: float | None = None
    margin: float = 0.2
    pos_weight: str = "sqrt"  # 'sqrt' => sqrt(neg/pos)
    rebuild_every: int = 4  # epochs between vector-DB rebuilds
    seed: int = 1234
    chunk_size: int = 12
    chunk_stride: int = 4
    mesh_shape: tuple = (1,)  # data-parallel axis sizes
    mesh_axes: tuple = ("data",)


@dataclass(frozen=True)
class ExperimentConfig(_Serializable):
    """One named experiment line."""

    name: str = "rag"
    vit: ViTConfig = field(default_factory=lambda: VIT_B16_224)
    chunk_encoder: ChunkEncoderConfig = field(
        default_factory=ChunkEncoderConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    train_vids: tuple = (1, 2, 3, 4, 5, 6)
    test_vids: tuple = (7, 8)
    # a previous run's weights to continue from; empty = a fresh run
    pinned_run_id: str = ""

    def run_id(self) -> str:
        return make_run_id(self)


_CONFIG_TYPES = {
    "ViTConfig": ViTConfig,
    "ChunkEncoderConfig": ChunkEncoderConfig,
    "HeadConfig": HeadConfig,
    "RetrievalConfig": RetrievalConfig,
    "TrainConfig": TrainConfig,
    "ExperimentConfig": ExperimentConfig,
}


def make_run_id(cfg: ExperimentConfig, now: float | None = None) -> str:
    """Run id that encodes the hyperparameters: name, UTC time of ``now``
    (default: the current time), a random 6-hex suffix, then the test
    vids, collection, k, chunking, head shape, batch, LRs and rebuild
    cadence."""
    ts = time.strftime("%Y%m%d-%H%M%S", time.gmtime(now))
    short = uuid.uuid4().hex[:6]
    t = cfg.train
    h = cfg.head
    r = cfg.retrieval
    return (
        f"{cfg.name}_{ts}_{short}"
        f"_tv{'-'.join(map(str, cfg.test_vids))}"
        f"_col-{r.collection}_k{r.top_k}"
        f"_cs{t.chunk_size}x{t.chunk_stride}"
        f"_L{h.num_layers}H{h.num_heads}"
        f"_b{t.batch_size}_lr{t.lr_phase1:g}-{t.lr_phase2:g}"
        f"_rb{t.rebuild_every}"
    )


def save_config(cfg, path: str) -> None:
    with open(path, "w") as f:
        f.write(cfg.to_json())


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        return ExperimentConfig.from_json(f.read())


def preset(name: str) -> ExperimentConfig:
    """The named experiment lines: rag, cls_only, ratt, chunks,
    chunks_cached, stage2, fast, stage3 (KeyError for another name)."""
    presets: dict[str, ExperimentConfig] = {
        "rag": ExperimentConfig(name="rag"),
        "cls_only": ExperimentConfig(name="cls_only"),
        "ratt": ExperimentConfig(
            name="ratt",
            retrieval=RetrievalConfig(collection="ratt_db", top_k=8),
        ),
        "chunks": ExperimentConfig(
            name="chunks",
            head=HeadConfig(num_layers=6, num_heads=8, num_queries=12),
            train=TrainConfig(num_epochs=12, rebuild_every=3,
                              lr_phase1=1e-5, lr_phase2=1e-6,
                              chunk_size=12),
            retrieval=RetrievalConfig(collection="ratt_db", top_k=12,
                                      search_k=300),
        ),
        "chunks_cached": ExperimentConfig(
            name="chunks_cached",
            train=TrainConfig(chunk_size=8, chunk_stride=2),
            retrieval=RetrievalConfig(collection="ratt_db_chunks", top_k=8),
        ),
        "stage2": ExperimentConfig(
            name="stage2",
            train=TrainConfig(chunk_size=8, chunk_stride=2, num_epochs=30),
            retrieval=RetrievalConfig(collection="ratt_db_s2", top_k=6),
        ),
        # the fast profile documents its backbone here; the engine reads
        # the env (VRT_TOME_R, VRT_GEMM_QUANT, VRT_GEMM_SCALES)
        "fast": ExperimentConfig(
            name="fast",
            vit=dataclasses.replace(VIT_B16_224, tome_r=16,
                                    dtype="bfloat16"),
        ),
        "stage3": ExperimentConfig(
            name="stage3",
            train=TrainConfig(chunk_size=8, chunk_stride=2, num_epochs=10),
            retrieval=RetrievalConfig(collection="ratt_db_s2", top_k=6),
            pinned_run_id="<set-to-a-stage2-run-id>",
        ),
    }
    return presets[name]
