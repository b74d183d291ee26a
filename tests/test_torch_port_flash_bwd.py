"""The backward of the port's two kernel wrappers on the CPU: the plain
flash-attention backward against the JAX package's Pallas backward kernels
(interpret mode), against jax.vjp of jax.nn.dot_product_attention and against
torch autograd through the plain forward; the GroupNorm+SiLU autograd
function against autograd through its plain version. fp32 (f64 for
gradcheck), inputs made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.ops import flash_attention as JFA
from omgsr_tpu_torch.ops import flash_attention as TFA
from omgsr_tpu_torch.ops import fused_groupnorm as TGN
from tests.torch_port_helpers import assert_close, t


@pytest.fixture(autouse=True)
def _interpret_on_cpu():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _operands(shape, skv, seed):
    rng = np.random.default_rng(seed)
    b, _, h, d = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, g


# 2e-3 is the JAX flash test's own bound for the forward (the Pallas kernels
# and the plain versions sum in different block orders); the gradients are
# held to the same bound, relative to 1 or to the value, whichever is larger.
FLASH_TOL = 2e-3

SHAPES = [
    pytest.param((1, 256, 2, 64), 256, None, id="self"),
    pytest.param((1, 256, 2, 64), 77, None, id="cross77"),
    pytest.param((2, 300, 3, 64), 300, None, id="ragged"),
    pytest.param((1, 128, 1, 128), 128, 0.5, id="d128-scale"),
]


def _plain_grads(q, k, v, g, scale):
    out, lse = TFA.flash_attention_plain(t(q), t(k), t(v), scale, return_lse=True)
    return TFA.flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(g), scale)


@pytest.mark.parametrize("shape,skv,scale", SHAPES)
def test_flash_bwd_plain_matches_pallas_interpret(shape, skv, scale):
    q, k, v, g = _operands(shape, skv, 0)
    _, vjp = jax.vjp(lambda a, b, c: JFA.flash_attention_bshd(a, b, c, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    for name, got, want in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, g, scale), ref):
        assert_close(got, want, FLASH_TOL, name)


@pytest.mark.parametrize("shape,skv,scale", SHAPES)
def test_flash_bwd_plain_matches_jax_dot_product_attention(shape, skv, scale):
    q, k, v, g = _operands(shape, skv, 1)
    _, vjp = jax.vjp(lambda a, b, c: jax.nn.dot_product_attention(a, b, c, scale=scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    for name, got, want in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, g, scale), ref):
        assert_close(got, want, FLASH_TOL, name)


@pytest.mark.parametrize("shape,skv,scale", SHAPES)
def test_flash_bwd_plain_matches_torch_autograd(shape, skv, scale):
    """1e-5: the same f32 formulas, summed in another order."""
    q, k, v, g = _operands(shape, skv, 2)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    ref = torch.autograd.grad(TFA.flash_attention_plain(*leaves, scale), leaves, t(g))
    for name, got, want in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, g, scale), ref):
        assert_close(got, want, 1e-5, name)


def test_flash_attention_under_autograd_uses_the_paired_backward(monkeypatch):
    """The wrapper's autograd function saves (q, k, v, out, lse) and calls
    flash_attention_bwd; on CPU tensors no kernel is counted."""
    q, k, v, g = _operands((2, 40, 2, 64), 24, 3)
    seen = []
    real = TFA.flash_attention_bwd

    def spy(*args):
        seen.append([tuple(a.shape) for a in args[:6]])
        return real(*args)

    monkeypatch.setattr(TFA, "flash_attention_bwd", spy)
    before = (TFA.launches.count, TFA.dq_launches.count, TFA.dkv_launches.count)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    # dout arrives with other strides than q's
    out = TFA.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, t(g.transpose(0, 2, 1, 3).copy()).permute(0, 2, 1, 3))
    assert seen == [[(2, 40, 2, 64), (2, 24, 2, 64), (2, 24, 2, 64), (2, 40, 2, 64), (4, 40, 1), (2, 40, 2, 64)]]
    leaves2 = [t(a).requires_grad_() for a in (q, k, v)]
    ref = torch.autograd.grad(TFA.flash_attention_plain(*leaves2), leaves2, t(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert_close(a, b, 1e-5, name)
    assert before == (TFA.launches.count, TFA.dq_launches.count, TFA.dkv_launches.count)
    # without grad the function is not entered, and lse is not differentiable
    with torch.no_grad():
        assert not TFA.flash_attention(*leaves).requires_grad
    _, lse = TFA.flash_attention(*leaves, return_lse=True)
    assert not lse.requires_grad


def test_flash_bwd_wrapper_refuses_operands_that_do_not_belong():
    q, k, v, g = (t(a) for a in _operands((1, 16, 1, 64), 8, 4))
    out, lse = TFA.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k, v, out, lse[:, :8], g)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k, v, out[:, :8], lse, g)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k[:, :, :, :32], v, out, lse, g)


def _gn_inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(dtype)
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(dtype)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(dtype)
    dy = rng.standard_normal(shape).astype(dtype)
    return x, w, b, dy


@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_function_gradcheck_f64(apply_silu):
    x, w, b, _ = (t(a).requires_grad_() for a in _gn_inputs((2, 3, 4, 8), 5, np.float64))
    assert torch.autograd.gradcheck(
        lambda x, w, b: TGN.fused_group_norm_silu(x, w, b, 4, 1e-6, apply_silu), (x, w, b))


@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("shape,groups", [((1, 16, 16, 32), 4), ((2, 8, 24, 16), 8), ((1, 30, 10, 32), 32)])
def test_group_norm_silu_function_matches_autograd_through_plain(shape, groups, apply_silu):
    """1e-5 of the largest gradient: the explicit backward and autograd's
    take the same f32 sums in another order."""
    x, w, b, dy = _gn_inputs(shape, 6)
    a = [t(v).requires_grad_() for v in (x, w, b)]
    r = [t(v).requires_grad_() for v in (x, w, b)]
    got = torch.autograd.grad(TGN.fused_group_norm_silu(*a, groups, 1e-6, apply_silu), a, t(dy))
    ref = torch.autograd.grad(TGN.group_norm_silu_plain(*r, groups, 1e-6, apply_silu), r, t(dy))
    for name, g, want in zip(("dx", "dweight", "dbias"), got, ref):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert (g - want).abs().max() <= 1e-5 * max(1.0, want.abs().max().item()), name
    # from the partial sums of the stats half, as the card's backward gets them
    partial = TGN.group_norm_stats(t(x), groups)
    again = TGN.group_norm_silu_bwd(t(x), partial, t(w), t(b), t(dy), groups, 1e-6, apply_silu)
    for g, want in zip(again, got):
        assert_close(g, want.numpy(), 1e-6)


# bf16 at D = 512: both sides round q, k, v, the output and the gradients to
# bf16 and the Pallas kernels also round P and dS for their second products;
# two bf16 steps of the largest value (found: 7.8e-4 forward, 1.9e-3 backward)
D512_BF16_TOL = 2.0 ** -7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_d512_matches_pallas_interpret(dtype):
    """The VAE mid block's single 512-wide head, ragged (300 tokens): the
    port's forward and, under autograd, its backward (the wrapper's autograd
    function, plain versions on the CPU) against flash_attention_bshd in
    interpret mode and jax.vjp of it."""
    q, k, v, g = _operands((1, 300, 1, 512), 300, 5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out_ref, vjp = jax.vjp(JFA.flash_attention_bshd, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    grads_ref = vjp(jnp.asarray(g, jdt))
    assert TFA.supports(512, dtype)
    leaves = [t(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = TFA.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, t(g).to(dtype))
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out.detach(), *grads), (out_ref, *grads_ref)):
        assert got.dtype == dtype, name
        want = np.asarray(want.astype(jnp.float32))
        if dtype == torch.float32:
            assert_close(got, want, FLASH_TOL, name)
        else:
            err = np.abs(got.float().numpy() - want).max()
            assert err <= D512_BF16_TOL * np.abs(want).max(), (name, err)


def test_encoder_mid_attention_gradient_goes_through_flash(monkeypatch):
    """The training path's VAE-encoder mid attention (one 512-wide head) under
    autograd: dot_product_attention sends it to the flash wrapper, whose
    autograd function calls flash_attention_bwd at D = 512; the gradient with
    respect to the block's input agrees with jax.vjp of the JAX package's
    _mid_attention (1e-4: GroupNorm, four dense layers and the attention, f32
    sums in another order)."""
    from omgsr_tpu.models import vae as JV
    from omgsr_tpu_torch.models import vae as TV
    from tests.torch_port_helpers import bridge, jax_init

    jp = jax_init(lambda key, ch: JV._init_attn(key, ch, jnp.float32), 0, 512)
    tp = bridge(jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 6, 5, 512)).astype(np.float32)
    g = rng.standard_normal((1, 6, 5, 512)).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda a: JV._mid_attention(jp, a, 32), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    seen = []
    real = TFA.flash_attention_bwd

    def spy(*args):
        seen.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(TFA, "flash_attention_bwd", spy)
    xt = t(x).requires_grad_()
    out = TV._mid_attention(tp, xt, 32)
    (dx,) = torch.autograd.grad(out, xt, t(g))
    assert seen == [(1, 30, 1, 512)]
    assert_close(out.detach(), ref_out, 1e-4, "out")
    assert_close(dx, ref_dx, 1e-4, "dx")
