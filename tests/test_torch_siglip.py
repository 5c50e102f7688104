"""SigLIP's vision tower on the port (no class token, the attention-pooling
head, heads 72 wide, a tanh-GELU MLP off the GEMM's tiles) against
``tests/siglip_plain.py``, the published forward in plain torch, at a tiny
size on seeded weights; against ``transformers.SiglipVisionModel`` where it
imports; through the engine, the CLI's backbone selector and the weight
mapping. The ``cuda`` test runs the engine at the published widths and a
reduced depth on the card.

Tolerance: 2e-6 on the L2-normalised embeddings (unit rows), f32 against
f32 through two layers and the head in another order of summation
(measured 1.3e-7-2.1e-7 on four seeds); exact GELU in place of tanh moves
them by 4.6e-5-6.2e-5 and bf16's rounding (2^-8 relative) by far more, and
both are held to fail it. On the card (published widths, the kernels'
3xTF32 products) the limit is 2e-5, the benchmark's ViT-B limit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import siglip_plain
from vit_research_tpu_torch.data.preprocess import SIGLIP_SPEC
from vit_research_tpu_torch.models import convert, hf_import, vit
from vit_research_tpu_torch.ops import attention as attn_ops
from vit_research_tpu_torch.ops import linear as lin
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.utils.configs import ViTConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 2e-6
CARD_TOL = 2e-5
#: 2 heads of 72 (kernel B's padded width), an MLP of 172 (K and N off
#: the GEMM's 32 / 128 tiles), patch 14 on a 4 x 4 grid
TINY = dict(hidden_size=144, num_attention_heads=2, intermediate_size=172,
            num_hidden_layers=2, patch_size=14, image_size=56,
            layer_norm_eps=1e-6, rescale=1 / 255, mean=(0.5, 0.5, 0.5),
            std=(0.5, 0.5, 0.5))
CFG = ViTConfig(image_size=(56, 56), patch_size=14, hidden_size=144,
                num_layers=2, num_heads=2, mlp_dim=172, layer_norm_eps=1e-6,
                gelu_approximate=True, pooler="map", class_token=False)


def _frames(n=3, seed=0, size=56):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _normalised(frames):
    x = torch.from_numpy(frames).to(torch.float32) / 255.0
    return (x - 0.5) / 0.5


def _port(cfg=CFG, w=None, seed=1):
    w = siglip_plain.seeded_weights(TINY, seed) if w is None else w
    model = vit.VisionTransformer(cfg)
    model.load_state_dict(hf_import.siglip_state_dict_to_port(w, cfg))
    return model.eval(), w


def _engine(w, cfg=CFG, device="cpu", batch_size=2):
    """What make_siglip_frame_embedder builds, around a tower of ``cfg``
    (the factory builds the published one): SIGLIP_SPEC at its image
    size, pooled rows L2-normalised."""
    model = vit.init_vit(cfg, device="cpu")
    model.load_state_dict(hf_import.siglip_state_dict_to_port(w, cfg))
    spec = dataclasses.replace(SIGLIP_SPEC, size=tuple(cfg.image_size))
    return embed.EmbeddingEngine(model, spec, device=device,
                                 batch_size=batch_size, endpoint="pooled",
                                 l2_normalize=True)


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _gap(model, w, frames, dtype=torch.float32):
    with torch.no_grad():
        got = model(_normalised(frames).to(dtype))["pooled"].float()
        want = siglip_plain.siglip_embed(w, TINY, torch.from_numpy(frames))
    return float((_unit(got) - want).abs().max())


def test_port_matches_the_plain_reference():
    model, w = _port()
    frames = _frames()
    assert _gap(model, w, frames) <= TOL
    # the no-class-token layout: a position row a patch, no cls parameter
    sd = model.state_dict()
    assert "cls" not in sd and sd["pos_embedding"].shape == (1, 16, 144)
    with torch.no_grad():
        out = model(_normalised(frames))
    assert out["encoded_tokens"].shape == (3, 16, 144)
    assert out["pooled"].shape == (3, 144)


def test_bf16_forward_fails_the_tolerance():
    model, w = _port(dataclasses.replace(CFG, dtype="bfloat16"))
    model = model.to(torch.bfloat16)
    assert _gap(model, w, _frames()) > TOL


def test_a_class_token_fails_the_comparison():
    cfg = dataclasses.replace(CFG, class_token=True)
    w = siglip_plain.seeded_weights(TINY, 1)
    sd = hf_import.siglip_state_dict_to_port(w, CFG)
    sd["cls"] = torch.zeros(1, 1, 144)
    sd["pos_embedding"] = torch.cat([torch.zeros(1, 1, 144),
                                     sd["pos_embedding"]], dim=1)
    model = vit.VisionTransformer(cfg)
    model.load_state_dict(sd)
    assert _gap(model.eval(), w, _frames()) > TOL


def test_dropping_the_heads_mlp_residual_fails(monkeypatch):
    model, w = _port()
    head = model.head

    def no_residual(x):
        full = vit.MAPHead.forward(head, x)
        # the same head with y = MLP(LN(a)) in place of a + MLP(LN(a))
        b, t, d = x.shape
        h, dh = head.num_heads, d // head.num_heads
        q = head.query(head.probe[0]).reshape(h, dh)
        k = head.key(x).reshape(b, t, h, dh)
        v = head.value(x).reshape(b, t, h, dh)
        p = torch.softmax(torch.einsum("hd,bthd->bht", q, k) * dh ** -0.5,
                          dim=-1)
        a = head.out(torch.einsum("bht,bthd->bhd", p, v).reshape(b, d))
        assert torch.allclose(full, a + head.mlp(head.norm(a)), atol=1e-6)
        return head.mlp(head.norm(a))

    monkeypatch.setattr(head, "forward", no_residual)
    assert _gap(model, w, _frames()) > TOL


@pytest.mark.parametrize("change", ["exact_gelu", "gap_pooler"])
def test_tanh_gelu_and_map_pooling_are_what_matches(change):
    """Exact GELU in the port's MLPs, or mean pooling in place of the
    head, moves the embedding off the reference."""
    model, w = _port()
    frames = _frames(seed=4)
    if change == "exact_gelu":
        for mod in model.modules():
            if isinstance(mod, vit.MlpBlock):
                mod.gelu_approximate = "none"
    else:
        model.config = dataclasses.replace(CFG, pooler="gap")
    assert _gap(model, w, frames) > TOL


def test_heads_of_72_take_kernel_b_padded_to_96(monkeypatch):
    """dh = 72 is not too wide for kernel B: the backbone routes each
    layer's attention to it (no plain path), where the card runs it
    zero-padded to the compiled 96 as attn_f32<96> (the rule's one f32
    kernel past 32 keys); padding leaves the result as it is."""
    assert not vit.head_too_wide_for_kernel(72)
    assert attn_ops.kernel_head_dim(72) == 96
    assert attn_ops.f32_variant(729, 96, False) is None
    assert attn_ops.kernel_name(torch.float32, 729, 96, False) == \
        "attn_f32<96>"
    calls = []
    real = attn_ops.multi_head_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn_ops, "multi_head_attention", spy)
    model, w = _port()
    assert _gap(model, w, _frames()) <= TOL
    assert calls == [(3, 2, 16, 72)] * 2
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 2, 16, 72, generator=g) for _ in range(3))
    want = attn_ops.attention_plain(q, k, v)
    got = attn_ops.attention_plain(*(attn_ops.pad_head_dim(x, 96)
                                     for x in (q, k, v)),
                                   scale=72 ** -0.5)[..., :72]
    assert torch.allclose(got, want, atol=1e-6)


def test_engine_embeds_uint8_frames_as_the_reference():
    w = siglip_plain.seeded_weights(TINY, 2)
    eng = _engine(w)
    assert eng.spec.size == (56, 56) and eng.out_trailing == (144,)
    assert (eng.spec.rescale, eng.spec.mean, eng.spec.std) == (
        1 / 255, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    frames = _frames(5, seed=6)
    got = eng.embed_batch(frames)
    want = siglip_plain.siglip_embed(w, TINY, torch.from_numpy(frames))
    assert got.shape == (5, 144)
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert np.abs(got - want.numpy()).max() <= TOL
    tokens = embed.EmbeddingEngine(eng.model, eng.spec, device="cpu",
                                   endpoint="encoded_tokens")
    assert tokens.out_trailing == (16, 144)


def test_factory_builds_the_published_tower(monkeypatch):
    """make_siglip_frame_embedder: the published configuration with the
    given state dict loaded, SIGLIP_SPEC, pooled rows L2-normalised (a
    tiny tower stands in for the 428 M-parameter one)."""
    small, _ = _port()
    built = []
    monkeypatch.setattr(vit, "init_vit", lambda cfg, device: built.append(
        (cfg, device)) or small)
    sd = {k: torch.zeros_like(v) for k, v in small.state_dict().items()}
    eng = embed.make_siglip_frame_embedder(sd, device="cpu", batch_size=3)
    assert built == [(hf_import.SIGLIP_SO400M_P14_384, "cpu")]
    assert eng.model is small
    assert all(float(v.abs().max()) == 0 for v in small.state_dict().values())
    assert eng.spec == SIGLIP_SPEC and eng.spec.size == (384, 384)
    assert (eng.endpoint, eng.l2_normalize, eng.batch_size) == (
        "pooled", True, 3)


def test_published_configuration():
    c = hf_import.SIGLIP_SO400M_P14_384
    assert (c.hidden_size, c.num_layers, c.num_heads, c.mlp_dim) == (
        1152, 27, 16, 4304)
    assert c.hidden_size // c.num_heads == 72
    assert (c.image_size, c.patch_size, c.grid) == ((384, 384), 14, (27, 27))
    assert (c.class_token, c.pooler, c.gelu_approximate,
            c.layer_norm_eps) == (False, "map", True, 1e-6)
    # its JSON form carries the port-only key; a default ViT's does not
    assert c.to_dict()["class_token"] is False
    assert "class_token" not in ViTConfig().to_dict()
    assert ViTConfig.from_dict(c.to_dict()) == c


def test_convert_refuses_what_the_jax_package_cannot_hold():
    model, _ = _port()
    with pytest.raises(ValueError, match="class token"):
        convert.state_dict_to_params(model.state_dict(), CFG)
    with pytest.raises(ValueError, match="class token"):
        convert.params_to_state_dict({}, dataclasses.replace(
            CFG, class_token=True))
    with pytest.raises(ValueError, match="class_token=False"):
        vit.VisionTransformer(dataclasses.replace(CFG, pooler="token"))
    with pytest.raises(ValueError, match="class_token=False"):
        vit.VisionTransformer(dataclasses.replace(CFG, pooler="gap",
                                                  tome_r=2))


def test_transformers_siglip_pooler_output():
    transformers = pytest.importorskip("transformers")
    hcfg = transformers.SiglipVisionConfig(
        hidden_size=144, intermediate_size=172, num_hidden_layers=2,
        num_attention_heads=2, image_size=56, patch_size=14,
        layer_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh")
    torch.manual_seed(0)
    hf = transformers.SiglipVisionModel(hcfg).eval()
    with torch.no_grad():  # no parameter left at 0 or 1
        for _, p in hf.named_parameters():
            p.add_(0.02 * torch.randn_like(p))
    model = vit.VisionTransformer(CFG)
    model.load_state_dict(hf_import.siglip_state_dict_to_port(
        hf.state_dict(), CFG))
    model.eval()
    frames = _frames(seed=8)
    x = _normalised(frames)
    with torch.no_grad():
        ref = hf(pixel_values=x.permute(0, 3, 1, 2)).pooler_output
        got = model(x)["pooled"]
    assert float((_unit(got) - _unit(ref)).abs().max()) <= TOL
    # the plain reference reads the tower's own state dict
    sd = {k.removeprefix("vision_model."): v
          for k, v in hf.state_dict().items()}
    want = siglip_plain.siglip_embed(sd, TINY, torch.from_numpy(frames))
    assert float((_unit(ref) - want).abs().max()) <= TOL


def test_cli_backbone_selector(monkeypatch):
    from vit_research_tpu_torch.cli import common

    for var in ("VRT_BACKBONE", "VRT_TINY", "VRT_TOME_R", "VRT_GEMM_QUANT",
                "VRT_GEMM_SCALES", "VRT_GRAYSCALE"):
        monkeypatch.delenv(var, raising=False)
    assert common.engine_profile() == "torch|tome0|quant-none|gray0"
    built = []
    monkeypatch.setattr(embed, "make_siglip_frame_embedder",
                        lambda **kw: built.append(kw) or "siglip")
    monkeypatch.setenv("VRT_BACKBONE", "siglip-so400m-p14-384")
    assert common._engine(64, "cpu") == "siglip"
    assert built == [{"device": "cpu", "batch_size": 64,
                      "grayscale": False}]
    assert common.engine_profile() == \
        "torch|siglip-so400m-p14-384|tome0|quant-none|gray0"
    monkeypatch.setenv("VRT_TINY", "1")  # the tiny ViT, whatever the backbone
    assert common.engine_profile() == "torch|tiny|tome0|quant-none|gray0"
    monkeypatch.delenv("VRT_TINY")
    monkeypatch.setenv("VRT_TOME_R", "4")
    with pytest.raises(SystemExit, match="parity path"):
        common._engine(64, "cpu")
    monkeypatch.setenv("VRT_BACKBONE", "vit-h14")
    with pytest.raises(SystemExit, match="VRT_BACKBONE"):
        common.engine_profile()


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_engine_on_the_card_at_published_widths(cuda):
    """Two layers at every published width (1,152, heads of 72, MLP
    4,304, patch 14 at 384, T = 729): the engine's rows against the
    plain reference on the card (TF32 off), and the launches the rule
    gives: kernel A at K = 588, attn_f32<96> padded, gemm_f32_wg for
    q/k/v/out and the head's k/v, the MLP on the library by its shape."""
    pub = hf_import.SIGLIP_SO400M_P14_384
    cfg = dataclasses.replace(pub, num_layers=2)
    tiny = dict(TINY, hidden_size=1152, num_attention_heads=16,
                intermediate_size=4304, image_size=384)
    w = siglip_plain.seeded_weights(tiny, 5)
    eng = _engine(w, cfg, device=cuda, batch_size=4)
    frames = _frames(4, seed=7, size=384)
    before = (dict(lin.linear.launches_by_kernel),
              dict(attn_ops.multi_head_attention.launches_by_kernel),
              attn_ops.multi_head_attention.padded_launches,
              lin.route.declined_shape)
    got = eng.embed_batch(frames)
    torch.cuda.synchronize()
    lin_now = dict(lin.linear.launches_by_kernel)
    att_now = dict(attn_ops.multi_head_attention.launches_by_kernel)
    assert lin_now.get("gemm_f32_wg", 0) - before[0].get(
        "gemm_f32_wg", 0) == 4 * 2 + 2
    assert set(lin_now) == {"gemm_f32_wg"}
    assert lin.route.declined_shape - before[3] == 2 * 2
    assert att_now.get("attn_f32<96>", 0) - before[1].get(
        "attn_f32<96>", 0) == 2
    assert attn_ops.multi_head_attention.padded_launches - before[2] == 2
    with torch.no_grad():
        want = siglip_plain.siglip_embed(
            {k: v.to(cuda) for k, v in w.items()}, tiny,
            torch.from_numpy(frames).to(cuda)).cpu().numpy()
    assert got.shape == (4, 1152)
    assert np.abs(got - want).max() <= CARD_TOL
