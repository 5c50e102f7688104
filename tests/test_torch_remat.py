"""The backbone's ``remat`` (each encoder block under
torch.utils.checkpoint, the reference's ``nn.remat``) and
``attn_layout='bthd'`` against the JAX package, and against the port's
own blocks without them.

Weights are drawn by flax from fixed seeds and cross through
models/convert.py; inputs come from numpy seeds. Bounds (f32): outputs
1e-5; gradients 1e-5 of each parameter's largest gradient (the key
projections' biases, whose gradient is zero, of the model's largest);
the port's remat against the port without it: exact (the same ops on the
same inputs, the dropout masks replayed).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.utils import configs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = 1e-5  # of the gradient's largest magnitude


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


TINY = dict(image_size=(32, 32), patch_size=8, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128)


def _images(n=4, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _port_grads(cfg, sd, images, generator_seed=None):
    """The port's pooled-embedding loss and its gradients in training
    mode; dropout masks from a generator seeded with ``generator_seed``."""
    model = tvit.VisionTransformer(cfg)
    model.load_state_dict(sd)
    model.train()
    if generator_seed is not None:
        tvit.set_dropout_generator(
            model, torch.Generator().manual_seed(generator_seed))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (images.shape[0], cfg.hidden_size)).astype(np.float32))
    loss = (model(torch.from_numpy(images))["pooled"] * w).sum()
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


def test_remat_gradients_match_jax_and_the_unchecked_blocks():
    """Dropout 0: the port's remat gradients equal JAX's remat gradients
    (1e-5) and the port's own without remat (exactly)."""
    jcfg = jax_configs.ViTConfig(**TINY, remat=True)
    model, params = jax_vit.init_vit(jcfg, seed=0)
    images = _images()
    w = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)

    def loss(p):
        return jnp.sum(model.apply(p, jnp.asarray(images), train=True)
                       ["pooled"] * w)

    jgrad = convert.params_to_state_dict(
        _np_tree(jax.jit(jax.grad(loss))(params)), configs.ViTConfig(**TINY))
    sd = convert.params_to_state_dict(params, configs.ViTConfig(**TINY))
    _, remat = _port_grads(configs.ViTConfig(**TINY, remat=True), sd, images)
    _, plain = _port_grads(configs.ViTConfig(**TINY), sd, images)
    largest = max(float(np.abs(g.numpy()).max()) for g in jgrad.values())
    for name, want in jgrad.items():
        want = want.numpy()
        err = np.abs(remat[name].numpy() - want).max()
        # the key biases' gradient is zero: both sides return rounding
        # noise, held to the model's largest gradient
        scale = (largest if name.endswith("attn.key.bias")
                 else np.abs(want).max())
        assert err <= F32_GRAD * scale, (name, err)
        assert torch.equal(remat[name], plain[name]), name


def test_remat_replays_the_dropout_generators_masks():
    """Dropout 0.1 (and attention dropout 0.1) with the masks drawn from
    an explicit generator: remat's loss and gradients equal those without
    remat exactly, because the recompute replays the generator's state.
    The control: the same blocks checkpointed without the replay draw new
    masks in the recompute, and the gradients differ."""
    base = dict(TINY, dropout_rate=0.1, attention_dropout_rate=0.1)
    cfg = configs.ViTConfig(**base)
    sd = tvit.VisionTransformer(
        cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    images = _images()
    loss_r, remat = _port_grads(configs.ViTConfig(**base, remat=True), sd,
                                images, generator_seed=5)
    loss_p, plain = _port_grads(cfg, sd, images, generator_seed=5)
    assert loss_r == loss_p
    for name, g in plain.items():
        assert torch.equal(remat[name], g), name

    original = tvit._checkpointed
    try:
        tvit._checkpointed = lambda block, *a: torch.utils.checkpoint \
            .checkpoint(block, *a, use_reentrant=False)
        _, naive = _port_grads(configs.ViTConfig(**base, remat=True), sd,
                               images, generator_seed=5)
    finally:
        tvit._checkpointed = original
    assert any(not torch.equal(naive[n], g) for n, g in plain.items())


@pytest.mark.parametrize("scores", [False, True])
def test_bthd_equals_bhtd_and_jax(scores):
    """attn_layout='bthd' (einsums on the projections' order, the plain
    path) equals 'bhtd' and JAX's 'bthd' forward, attention scores
    included."""
    jcfg = jax_configs.ViTConfig(**TINY, attn_layout="bthd",
                                 output_attention_scores=scores)
    model, params = jax_vit.init_vit(jcfg, seed=3)
    images = _images(seed=4)
    want = jax.jit(model.apply)(params, jnp.asarray(images))
    sd = convert.params_to_state_dict(params, configs.ViTConfig(**TINY))
    outs = {}
    for layout in ("bthd", "bhtd"):
        m = tvit.VisionTransformer(configs.ViTConfig(
            **TINY, attn_layout=layout, output_attention_scores=scores))
        m.load_state_dict(sd)
        with torch.no_grad():
            outs[layout] = m.eval()(torch.from_numpy(images))
    keys = ["encoded_tokens", "pooled"] + (["attention_scores"] if scores
                                           else [])
    for k in keys:
        np.testing.assert_allclose(outs["bthd"][k].numpy(),
                                   outs["bhtd"][k].numpy(), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(outs["bthd"][k].numpy(),
                                   np.asarray(want[k]), **TOL, err_msg=k)


def test_bthd_takes_the_plain_path(monkeypatch):
    """As in the reference, 'bthd' never reaches the kernel wrapper."""
    from vit_research_tpu_torch.ops import attention

    def refuse(*a, **k):
        raise AssertionError("bthd reached multi_head_attention")

    monkeypatch.setattr(attention, "multi_head_attention", refuse)
    m = tvit.VisionTransformer(configs.ViTConfig(**TINY, attn_layout="bthd"))
    with torch.no_grad():
        m.eval()(torch.from_numpy(_images()))
    bhtd = tvit.VisionTransformer(configs.ViTConfig(**TINY))
    with pytest.raises(AssertionError, match="bthd reached"):
        with torch.no_grad():
            bhtd.eval()(torch.from_numpy(_images()))
