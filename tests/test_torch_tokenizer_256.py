"""TOKENIZER_256 and remat in the PyTorch port, on the CPU in fp32:

- the port's TOKENIZER_256 is the JAX package's, field for field;
- at a five-level narrow config shaped like TOKENIZER_256 (channels
  doubling then widening, a latent 16x smaller than the frame, cross-
  attention at the three coarsest levels), the training forward's
  gradients with remat equal those without it bit for bit, and equal the
  JAX model's with ``remat=True`` (``nn.remat`` over the same blocks)
  within 1e-3 of each gradient's largest element, as the no-remat parity
  of ``tests/test_torch_tokenizer_train.py`` holds them.

The gradient is that of one fixed weighted sum of the forward's outputs
(the frames, both commit losses), so it runs through every block that
remat wraps and every one it leaves alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ivideogpt_tpu.configs import TOKENIZER_256 as JAX_TOKENIZER_256
from ivideogpt_tpu.configs import CompressiveVQConfig
from ivideogpt_tpu_torch.configs import TOKENIZER_256
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.utils import checkpoint as port_ckpt
from tests.test_torch_checkpoint import make_tokenizer, port_config
from tests.test_torch_discriminator import pixels

NARROW = CompressiveVQConfig(
    block_out_channels=(8, 16, 16, 16, 24), layers_per_block=1,
    latent_channels=8, num_vq_embeddings=32, num_dyn_embeddings=32,
    norm_num_groups=4, mid_block_add_attention=False, context_length=2,
    resolution=64, max_att_resolution=8, patch_size=4,
    cross_attn_dropout=0.0, remat=True)
B, T = 2, 4
CTX = NARROW.context_length
RES = NARROW.resolution


def test_tokenizer_256_matches_the_jax_config():
    assert TOKENIZER_256 == port_config(JAX_TOKENIZER_256)
    assert TOKENIZER_256.to_json() == JAX_TOKENIZER_256.to_json()
    assert TOKENIZER_256.remat and TOKENIZER_256.latent_resolution == 16


def _inputs(seed):
    px = pixels(seed, (B, T, RES, RES, 3))
    rng = np.random.default_rng(seed + 1)
    w_dec = rng.normal(size=(B * (T - CTX), RES, RES, 3)).astype(np.float32)
    w_ref = rng.normal(size=(B * CTX, RES, RES, 3)).astype(np.float32)
    return (px[:, :CTX].reshape(-1, RES, RES, 3),
            px[:, CTX:].reshape(-1, RES, RES, 3), w_dec, w_ref)


def _port_grads(port, inputs):
    ctx, fut, w_dec, w_ref = (torch.from_numpy(x) for x in inputs)
    dec, ref_dec, commit, dyn_commit = port(ctx, fut, T - CTX,
                                            deterministic=True)
    loss = ((dec * w_dec).sum() + (ref_dec * w_ref).sum() + commit
            + dyn_commit)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    return dict(zip(names, grads))


def test_remat_gradients_equal_no_remat_and_match_jax():
    model, params, port = make_tokenizer(NARROW, seed=4, T=T)
    inputs = _inputs(5)
    assert all(b.remat for b in (port.encoder, port.decoder,
                                 port.cond_encoder, port.cond_decoder))
    ours = _port_grads(port.train(), inputs)

    plain = CompressiveVQModel(port_config(NARROW.replace(remat=False)))
    plain.load_state_dict(port.state_dict())
    ref = _port_grads(plain.train(), inputs)
    for name, g in ours.items():
        assert torch.equal(g, ref[name]), name

    ctx, fut, w_dec, w_ref = (jnp.asarray(x) for x in inputs)

    def loss(p):
        dec, ref_dec, commit, dyn_commit = model.apply(
            p, ctx, fut, T - CTX, deterministic=True)
        return ((dec * w_dec).sum() + (ref_dec * w_ref).sum() + commit
                + dyn_commit)
    jgrads = jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray,
                                                            params))
    want = port_ckpt.tokenizer_state_dict(
        jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(want) == sorted(ours)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, g in ours.items():
        # fp32 sums in another order, as the no-remat gradients' 1e-3
        np.testing.assert_allclose(
            g.numpy(), want[name].numpy(), rtol=0,
            atol=1e-3 * float(want[name].abs().max()) + 1e-6 * gmax,
            err_msg=name)
