"""The heads in bf16 over f32 parameters (ChunkEncoder, RAGHead,
RATTHead, RATTHeadV2) against the JAX package's flax modules in bf16.

Weights are drawn by flax from fixed seeds and cross through
models/convert.py; inputs come from numpy seeds.

Bounds. bf16 (8 significant bits, an ulp 2^-8 of a value's scale): both
packages round each bf16 op's output (the elementwise ops and scalars
follow JAX's op by op, tests/test_torch_bf16_parity.py), but the dense
products and the LayerNorm statistics sum in other orders, and a value
that falls apart by an ulp moves the layers after it, so a
forward output is held within ``BF16_OUT`` = 2^-5 of its largest
magnitude (8 ulps there), and the gradients of the f32 parameters to a
relative L2 error of ``BF16_GRAD`` over all of them, and of
``BF16_GRAD_PARAM`` for any one (a ReLU unit of a classifier near zero
can switch between the two: its weights' gradient row changes whole).
The key projections' biases are left out: their gradient is zero (the
softmax removes a per-query constant), so what either side returns is
rounding noise. The port's bf16 must also differ from its own f32 by
more than ``BF16_SEEN`` (it does compute in bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.models import ratt_v2 as jax_ratt_v2
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch.models import convert, heads, ratt_v2
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.utils import configs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BF16_OUT = 2 ** -5
BF16_GRAD = 3e-2
BF16_GRAD_PARAM = 0.25
BF16_SEEN = 1e-3
D = 64
B = 16
KS, KC, KT = 3, 3, 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(kind: str):
    rng = np.random.default_rng(0)
    if kind == "chunk":
        return [rng.standard_normal((B, 8, D)).astype(np.float32)]
    cls = rng.standard_normal((B, D)).astype(np.float32)
    if kind == "v2":
        return [cls] + [rng.standard_normal((B, k, D)).astype(np.float32)
                        for k in (KS, KC, KT)]
    return [cls, rng.standard_normal((B, 6, D)).astype(np.float32)]


def _head_kw(dtype):
    return dict(embed_dim=D, num_layers=2, num_heads=2, mlp_dim=16,
                dtype=dtype, dropout_rate=0.0, classifier_dropout=0.0,
                k_sim=KS, k_contrast=KC, k_temporal=KT)


# kind -> (JAX module, port module, weight map, outputs compared: the
# logits and the embedding each head returns)
def _modules(kind, dtype):
    if kind == "chunk":
        kw = dict(embed_dim=D, num_layers=2, num_heads=2, mlp_dim=128,
                  max_len=8, dtype=dtype, dropout_rate=0.0)
        return (jax_heads.ChunkEncoder(jax_configs.ChunkEncoderConfig(**kw)),
                heads.ChunkEncoder(configs.ChunkEncoderConfig(**kw)),
                convert.chunk_encoder_to_state_dict, (1, 0))
    kw = _head_kw(dtype)
    jcfg, cfg = jax_configs.HeadConfig(**kw), configs.HeadConfig(**kw)
    if kind == "rag":
        return (jax_heads.RAGHead(jcfg), heads.RAGHead(cfg),
                convert.rag_head_to_state_dict, (0, 1))
    if kind == "ratt":
        return (jax_heads.RATTHead(jcfg), heads.RATTHead(cfg),
                convert.ratt_head_to_state_dict, (0, 2))
    return (jax_ratt_v2.RATTHeadV2(jcfg), ratt_v2.RATTHeadV2(cfg),
            convert.ratt_v2_to_state_dict, (0, 1))


def _port_run(tmod, sd, x, outs, w):
    """The port module with ``sd`` loaded: its compared outputs and the
    gradients of the weighted sum ``w`` of them."""
    tmod.load_state_dict(sd)
    tout = tmod.eval()(*map(torch.from_numpy, x))
    sum((tout[i].float() * torch.from_numpy(wi)).sum()
        for i, wi in zip(outs, w)).backward()
    return ([tout[i] for i in outs],
            {n: p.grad.numpy() for n, p in tmod.named_parameters()})


def _run_both(kind):
    """One bf16 forward and the gradients of a fixed weighted sum of the
    compared outputs, in both packages from the same weights, and the
    port's f32 run of the same: (JAX outputs, port outputs, JAX grads,
    port grads, port f32 outputs, port f32 grads), the grads numpy in the
    port's state_dict names."""
    jmod, tmod, to_sd, outs = _modules(kind, "bfloat16")
    x = _inputs(kind)
    params = _np_tree(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                         *map(jnp.asarray, x)))
    shapes = [o.shape for o in jax.tree_util.tree_leaves(
        [jax.eval_shape(jmod.apply, params, *map(jnp.asarray, x))[i]
         for i in outs])]
    rng = np.random.default_rng(7)
    w = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def jloss(p):
        out = jmod.apply(p, *map(jnp.asarray, x))
        return sum(jnp.sum(out[i].astype(jnp.float32) * wi)
                   for i, wi in zip(outs, w)), [out[i] for i in outs]

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    sd = to_sd(params)
    tout, tgrad = _port_run(tmod, sd, x, outs, w)
    fout, fgrad = _port_run(_modules(kind, "float32")[1], sd, x, outs, w)
    return ([np.asarray(o, np.float32) for o in jout], tout,
            {k: v.numpy() for k, v in to_sd(_np_tree(jgrad)).items()},
            tgrad, fout, fgrad)


def _grad_errs(got: dict, want: dict):
    """(relative L2 error over all parameters, the largest of any one),
    key projections' biases left out."""
    names = [n for n in want if not n.endswith("attn.key.bias")]
    per = [np.linalg.norm(got[n] - want[n])
           / max(np.linalg.norm(want[n]), 1e-30) for n in names]
    g = np.concatenate([got[n].ravel() for n in names])
    w = np.concatenate([want[n].ravel() for n in names])
    return np.linalg.norm(g - w) / np.linalg.norm(w), max(per)


@pytest.mark.parametrize("kind", ["chunk", "rag", "ratt", "v2"])
def test_bf16_heads_match_jax(kind):
    """ChunkEncoder, RAGHead, RATTHead and RATTHeadV2 with dtype
    'bfloat16' against flax's bf16 on the same f32 weights: the outputs'
    dtypes (the logits bf16, the embeddings after the f32 final LayerNorm
    f32), the forward within BF16_OUT, the f32 parameters' gradients
    within BF16_GRAD / BF16_GRAD_PARAM, and the port's bf16 away from its
    own f32 by more than BF16_SEEN."""
    jout, tout, jgrad, tgrad, fout, fgrad = _run_both(kind)
    assert [o.dtype for o in tout] == [torch.bfloat16, torch.float32]
    for got, want in zip(tout, jout):
        got = got.detach().float().numpy()
        assert np.abs(got - want).max() <= BF16_OUT * np.abs(want).max()
    assert {g.dtype for g in tgrad.values()} == {np.dtype(np.float32)}
    total, worst = _grad_errs(tgrad, jgrad)
    assert total <= BF16_GRAD and worst <= BF16_GRAD_PARAM, (total, worst)
    emb, f_emb = tout[1].detach().numpy(), fout[1].detach().numpy()
    assert np.abs(emb - f_emb).max() > BF16_SEEN * np.abs(f_emb).max()
    assert _grad_errs(tgrad, fgrad)[0] > BF16_SEEN


def test_bf16_chunk_encoder_trains_f32_weights_through_attention():
    """One AdamW step of a bf16 ChunkEncoder in training mode at dropout
    0 (the route that launches kernel B's bf16 instantiation on a card,
    through _Attention when the inputs require grad): the parameters stay
    f32 and move; the input's gradient is f32."""
    cfg = configs.ChunkEncoderConfig(embed_dim=D, num_layers=2, num_heads=2,
                                     mlp_dim=128, max_len=8,
                                     dtype="bfloat16", dropout_rate=0.0)
    model = heads.ChunkEncoder(cfg, generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = torch.from_numpy(_inputs("chunk")[0]).requires_grad_(True)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    emb, logit = model.train()(x)
    torch.nn.functional.binary_cross_entropy_with_logits(
        logit.reshape(-1).float(), torch.ones(B)).backward()
    assert x.grad.dtype == torch.float32 and x.grad.abs().sum() > 0
    opt.step()
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])]
    assert "blocks.0.attn.query.weight" in moved and "cls_token" in moved


def test_encoder_block_bf16_follows_flax_promotion():
    """EncoderBlock(dtype=bf16) over f32 weights: a bf16 stream stays
    bf16 (the residual adds bf16 to bf16), the LayerNorms see f32, the
    weights stay f32."""
    blk = tvit.EncoderBlock(D, 2, 128, dtype=torch.bfloat16)
    seen = []
    blk.ln1.register_forward_hook(lambda m, i, o: seen.append(
        (i[0].dtype, o.dtype)))
    x = torch.randn(2, 5, D, generator=torch.Generator().manual_seed(0))
    y, _ = blk(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert seen == [(torch.float32, torch.float32)]
    assert {p.dtype for p in blk.parameters()} == {torch.float32}
