"""Shared helpers of the tests/test_torch_port_*.py files: tiny configs on
both sides and the weight bridge from a JAX parameter tree."""

import contextlib
import json

import jax
import numpy as np
import torch

from omgsr_tpu.models.configs import UNetConfig as JUNetConfig
from omgsr_tpu.models.configs import VAEConfig as JVAEConfig
from omgsr_tpu_torch.convert.params import from_jax_tree
from omgsr_tpu_torch.models.configs import UNetConfig, VAEConfig

# Both resolutions of the VAE, the mid block with its attention, one resnet per
# encoder block and two per decoder block: every code path of the SD2.1 VAE.
_TINY_VAE = dict(block_out_channels=(8, 16), norm_num_groups=4, latent_channels=4, layers_per_block=1)
# Every block type of SD2.1's UNet at one resnet (and one transformer) per down
# block, two per up block: the same code paths at half the depth, which halves
# what the JAX side traces and compiles in every test that runs the UNet.
_TINY_UNET = dict(
    block_out_channels=(8, 16, 16, 16),
    num_attention_heads=(1, 2, 2, 2),
    cross_attention_dim=16,
    norm_num_groups=4,
    layers_per_block=1,
)
J_TINY_VAE, T_TINY_VAE = JVAEConfig(**_TINY_VAE), VAEConfig(**_TINY_VAE)
J_TINY_UNET, T_TINY_UNET = JUNetConfig(**_TINY_UNET), UNetConfig(**_TINY_UNET)


# XLA's CPU backend at optimisation level 0. Run op by op, a JAX reference
# compiles every primitive apart and dispatches it from Python; as one jit at
# level 0 it compiles in a fraction of that time and computes the same
# function (the two agree to a few f32 ulps).
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_once(fn, *args):
    """``fn(*args)`` as one jax.jit compiled at optimisation level 0; static
    arguments go into ``fn`` as a closure."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


@contextlib.contextmanager
def _recording_draws(recorded):
    """While a function is traced, each ``jax.random.uniform`` / ``normal`` /
    ``poisson`` call made through the public module appends its result to
    ``recorded`` (jax's own internals call their private functions)."""
    saved = {name: getattr(jax.random, name) for name in ("uniform", "normal", "poisson")}

    def wrap(fn):
        def draw(*a, **k):
            out = fn(*a, **k)
            recorded.append(out)
            return out

        return draw

    for name, fn in saved.items():
        setattr(jax.random, name, wrap(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(jax.random, name, fn)


def jax_with_draws(fn, *args):
    """``fn(*args)`` as one jit at optimisation level 0 -> (its output, every
    draw it took from ``jax.random`` in call order as f32 numpy arrays): what
    the port's ``ops.noise.ReplayDraws`` hands to its side."""

    def traced(*a):
        recorded = []
        with _recording_draws(recorded):
            out = fn(*a)
        return out, [r.astype(jax.numpy.float32) for r in recorded]

    out, draws = jax_once(traced, *args)
    return out, [np.asarray(d) for d in draws]


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def bridge(jax_tree):
    """JAX parameter tree -> the port's parameters on the CPU, fp32."""
    return from_jax_tree(to_numpy_tree(jax_tree), dtype=torch.float32, device="cpu")


def t(a):
    """numpy -> CPU tensor (a copy, so neither side can alias the other)."""
    return torch.from_numpy(np.array(a, copy=True))


def assert_close(port_out, jax_out, tol, what=""):
    a = port_out.detach().cpu().numpy() if isinstance(port_out, torch.Tensor) else np.asarray(port_out)
    b = np.asarray(jax_out)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=what)


def jax_init(init_fn, seed, cfg):
    """A parameter tree with the structure and shapes of the JAX package's
    initialiser (taken with jax.eval_shape, which allocates and compiles
    nothing) and values drawn with numpy from a seed: kernels uniform in
    +-1/sqrt(fan_in) like the initialiser's, biases and norm parameters
    perturbed so that no affine term is trivially 0 or 1. Returned as jnp
    arrays; ``bridge`` carries it to the port."""
    shapes = jax.eval_shape(lambda k: init_fn(k, cfg), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            a = rng.uniform(-bound, bound, leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return jax.numpy.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_lora_tree(jax_params, rank, seed, targets=None):
    """A LoRA tree with the structure of the JAX package's init_lora_tree for
    ``jax_params`` and values drawn with numpy: A ~ N(0,1)/rank and, unlike
    the initialiser, B != 0, so the low-rank branch changes the output."""
    from omgsr_tpu.lora import SD_TARGET_MODULES, init_lora_tree

    shapes = jax.eval_shape(
        lambda k: init_lora_tree(k, jax_params, targets or SD_TARGET_MODULES, rank), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        scale = 1.0 / rank if path[-1].key == "lora_A" else 0.3
        return jax.numpy.asarray((rng.standard_normal(leaf.shape) * scale).astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _diffaug_raw(key, shape):
    b, h, w, _ = shape
    ks = jax.random.split(key, 8)
    uniforms = [jax.random.uniform(ks[i], (b, 1, 1, 1), jax.numpy.float32) for i in range(3)]
    sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
    k1, k2 = jax.random.split(ks[3])
    ty = jax.random.randint(k1, (b, 1, 1), -sh, sh + 1)
    tx = jax.random.randint(k2, (b, 1, 1), -sw, sw + 1)
    ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
    k1, k2 = jax.random.split(ks[4])
    oy = jax.random.randint(k1, (b, 1, 1), 0, h + (1 - ch % 2))
    ox = jax.random.randint(k2, (b, 1, 1), 0, w + (1 - cw % 2))
    return (*uniforms, ty, tx, oy, ox)


def jax_diffaug_draws(key, shape):
    """The seven draws that omgsr_tpu.losses.diffaug.diff_augment(key, x) makes
    for x of ``shape`` under its default policy, replayed key by key in its
    order, as the port's DiffAugDraws of CPU tensors. They are drawn as one jit
    per shape: the same bits as op by op, where each primitive compiles apart."""
    from omgsr_tpu_torch.losses.diffaug import DiffAugDraws

    raw = [np.asarray(a) for a in jax.jit(_diffaug_raw, static_argnums=1)(key, tuple(shape))]
    uniforms, (ty, tx, oy, ox) = raw[:3], raw[3:]
    return DiffAugDraws(*(t(a) for a in uniforms), *(t(a).long() for a in (ty, tx, oy, ox)))


def jit_unoptimised(fn, *args):
    """``fn(*args)`` through one XLA compile with the optimisation passes
    switched off: on the CPU that is several times quicker than running a
    large function op by op (each primitive compiles on its own) and than
    the fully optimised compile, and the numbers are the same f32 sums."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return compiled(*args)


# ----------------------------------------------------------------------------
# a tiny SD2.1-layout checkpoint directory that both packages' porters read
# ----------------------------------------------------------------------------

# ConvNeXt and CLIP text tower at a few channels: every leaf kind of the published models
J_TINY_CONVNEXT_KW = dict(depths=(1, 1, 1, 1), dims=(8, 8, 8, 8))
TINY_MERGES = 600  # the synthetic vocabulary: 512 byte symbols + merges + BOS/EOS
TINY_CLIP_KW = dict(vocab_size=512 + TINY_MERGES + 2, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                    num_attention_heads=2, eos_token_id=512 + TINY_MERGES + 1)


def torch_layout(tree):
    """A JAX-layout tree -> the flat HF state dict of numpy arrays, as
    tests/test_porters._to_torch_layout writes it (embedding tables stay)."""
    from tests.test_porters import _to_torch_layout

    return _to_torch_layout(to_numpy_tree(tree))


def write_tiny_checkpoint(root, seed=0):
    """Write, under ``root`` (a pathlib.Path), an SD2.1-layout checkpoint of the
    tiny configs from numpy draws, with the ``safetensors`` package and JAX's
    adapter writer, as a published directory and the JAX CLIs hold it:

        vae/ (one file), unet/ (two shards + index), text_encoder/ (with the
        position-id buffer and a text projection the porter drops), tokenizer/,
        lora/{vae_encoder_lora_adapter, unet_lora_adapter}/, dinov3_convnext.pth
        (the filtered keys and the ``norms.3`` alias besides), prompt.npz

    Returns the JAX-layout trees written: vae, unet, clip, convnext, lora_vae, lora_unet."""
    from safetensors.numpy import save_file

    from omgsr_tpu.lora import save_adapter as jax_save_adapter
    from omgsr_tpu.lora import SD_TARGET_MODULES
    from omgsr_tpu.models import clip_text as JC
    from omgsr_tpu.models import convnext as JCN
    from omgsr_tpu.models import unet_sd as JU
    from omgsr_tpu.models import vae as JV
    from omgsr_tpu.models.configs import CLIPTextConfig as JCLIPTextConfig
    from omgsr_tpu.models.configs import ConvNeXtConfig as JConvNeXtConfig
    from omgsr_tpu_torch.tools.sd_checkpoint import synthetic_bpe, write_tokenizer

    trees = {
        "vae": jax_init(JV.init_vae, seed, J_TINY_VAE),
        "unet": jax_init(JU.init_unet, seed + 1, J_TINY_UNET),
        "clip": jax_init(JC.init_clip_text, seed + 2, JCLIPTextConfig(**TINY_CLIP_KW)),
        "convnext": jax_init(lambda k, c: JCN.init_convnext(k, c, with_final_norm=True), seed + 3,
                             JConvNeXtConfig(**J_TINY_CONVNEXT_KW)),
    }
    trees["lora_vae"] = jax_lora_tree(trees["vae"]["encoder"], 2, seed + 4)
    trees["lora_unet"] = jax_lora_tree(trees["unet"], 2, seed + 5)
    trees = {k: to_numpy_tree(v) for k, v in trees.items()}

    for sub in ("vae", "unet", "text_encoder"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    save_file(torch_layout(trees["vae"]), str(root / "vae" / "diffusion_pytorch_model.safetensors"))
    unet = torch_layout(trees["unet"])
    keys = sorted(unet)
    shards = {"diffusion_pytorch_model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "diffusion_pytorch_model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        save_file({k: unet[k] for k in ks}, str(root / "unet" / name))
    (root / "unet" / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: name for name, ks in shards.items() for k in ks}}))
    clip = torch_layout(trees["clip"])
    clip["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    clip["text_projection.weight"] = np.ones((4, TINY_CLIP_KW["hidden_size"]), np.float32)
    save_file(clip, str(root / "text_encoder" / "model.safetensors"))

    (root / "vae" / "config.json").write_text(json.dumps(
        {"block_out_channels": [8, 16], "norm_num_groups": 4, "latent_channels": 4, "layers_per_block": 1,
         "scaling_factor": 0.18215}))
    (root / "unet" / "config.json").write_text(json.dumps(
        {"block_out_channels": [8, 16, 16, 16], "attention_head_dim": [1, 2, 2, 2], "cross_attention_dim": 16,
         "norm_num_groups": 4, "layers_per_block": 1}))
    (root / "text_encoder" / "config.json").write_text(json.dumps(TINY_CLIP_KW))
    write_tokenizer(str(root / "tokenizer"), *synthetic_bpe(TINY_MERGES, seed))

    for name, tree in (("vae_encoder_lora_adapter", trees["lora_vae"]), ("unet_lora_adapter", trees["lora_unet"])):
        jax_save_adapter(tree, str(root / "lora" / name), rank=2, targets=SD_TARGET_MODULES)

    cn = {k: torch.from_numpy(np.array(v)) for k, v in torch_layout(trees["convnext"]).items()}
    cn["norms.3.weight"], cn["norms.3.bias"] = cn["norm.weight"], cn["norm.bias"]
    cn["head.weight"] = torch.zeros(2, 8)
    torch.save({"model": cn}, root / "dinov3_convnext.pth")
    np.savez(root / "prompt.npz",
             prompt_embeds=np.random.default_rng(seed).normal(size=(1, 7, 16)).astype(np.float32))
    return trees


# ----------------------------------------------------------------------------
# a tiny FLUX.1-dev-layout checkpoint directory that both packages' porters read
# ----------------------------------------------------------------------------

# the FLUX VAE's 16 latent channels, shift and no quant convs at the tiny VAE's widths
_TINY_FLUX_VAE = dict(_TINY_VAE, latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                      use_quant_conv=False, use_post_quant_conv=False)
# tests/test_models.py's TINY_FLUX: head dim 8, so its attention takes the matmul route
_TINY_FLUX = dict(num_layers=2, num_single_layers=2, attention_head_dim=8, num_attention_heads=4,
                  joint_attention_dim=16, pooled_projection_dim=8, axes_dims_rope=(2, 4, 2))


# FLUX's text towers at the tiny DiT's widths: CLIP-L's pooled output feeds pooled_projection_dim (8),
# T5's hidden states joint_attention_dim (16); every leaf kind and both T5 position-bias regimes
TINY_T5_PIECES = 400  # the synthetic Unigram vocabulary; ids 400-499 are the extra ids
TINY_FLUX_CLIP_KW = dict(vocab_size=512 + TINY_MERGES + 2, hidden_size=8, intermediate_size=16, num_hidden_layers=2,
                         num_attention_heads=2, hidden_act="quick_gelu", eos_token_id=512 + TINY_MERGES + 1)
TINY_T5_KW = dict(vocab_size=512, d_model=16, d_kv=8, d_ff=32, num_layers=2, num_heads=2,
                  relative_attention_num_buckets=8, relative_attention_max_distance=20)


def tiny_text_configs():
    """(JAX CLIP-L, port CLIP-L, JAX T5, port T5) tiny configs of FLUX's text towers."""
    from omgsr_tpu.models.configs import CLIPTextConfig as JCLIPTextConfig
    from omgsr_tpu.models.configs import T5Config as JT5Config
    from omgsr_tpu_torch.models.configs import CLIPTextConfig, T5Config

    return (JCLIPTextConfig(**TINY_FLUX_CLIP_KW), CLIPTextConfig(**TINY_FLUX_CLIP_KW), JT5Config(**TINY_T5_KW),
            T5Config(**TINY_T5_KW))


def charsmap_rules():
    """A small charsmap: full-width letters and digits, the ideographic space
    and two other spaces, a ligature, compositions of accented letters, a
    mapping of a plain letter (so a grapheme of a base letter and combining
    marks has a shortest-prefix match), a deletion and a tab to a space."""
    import unicodedata

    rules = {chr(c): unicodedata.normalize("NFKC", chr(c)) for c in [*range(0xFF10, 0xFF1A), *range(0xFF21, 0xFF3B),
                                                                      *range(0xFF41, 0xFF5B)]}
    rules.update({"\u3000": " ", "\u2002": " ", "\u00a0": " ", "\ufb01": "fi", "\t": " ", "\x07": "",
                  "e\u0301": "\u00e9", "a\u0300": "\u00e0", "o\u0308": "\u00f6", "q": "Q", "k\u0301\u0301": "K"})
    return rules


def tiny_flux_configs():
    """(JAX VAE, port VAE, JAX FLUX, port FLUX) tiny configs."""
    from omgsr_tpu.models.configs import FluxConfig as JFluxConfig
    from omgsr_tpu_torch.models.configs import FluxConfig

    return (JVAEConfig(**_TINY_FLUX_VAE), VAEConfig(**_TINY_FLUX_VAE), JFluxConfig(**_TINY_FLUX),
            FluxConfig(**_TINY_FLUX))


def write_tiny_flux_checkpoint(root, seed=0):
    """Write, under ``root`` (a pathlib.Path), a FLUX.1-dev-layout checkpoint of
    the tiny configs from numpy draws with the ``safetensors`` package, as
    tests/test_e2e_cli.make_fake_flux_checkpoint does, and the adapters with the
    JAX package's writer:

        vae/ (one file), transformer/ (two shards + index), lora/{flux_adapter,
        vae_encoder_adapter}/ (rank 2), prompt.npz (prompt_embeds (1, 5, 16),
        pooled_prompt_embeds (1, 8)), text_encoder/ (CLIP-L at the tiny
        widths, with the position-id buffer the porter drops), tokenizer/ (the
        synthetic BPE vocabulary, pad <|endoftext|>), text_encoder_2/ (T5 in two
        shards + index, with the embed_tokens alias the porter drops),
        tokenizer_2/ (a synthetic Unigram vocabulary with ``charsmap_rules``)

    Returns the JAX-layout trees written: vae, flux, lora_flux, lora_vae, clip, t5."""
    from safetensors.numpy import save_file

    from omgsr_tpu.lora import FLUX_TARGET_MODULES, SD_TARGET_MODULES
    from omgsr_tpu.lora import save_adapter as jax_save_adapter
    from omgsr_tpu.models import clip_text as JC
    from omgsr_tpu.models import flux as JF
    from omgsr_tpu.models import t5 as JT5
    from omgsr_tpu.models import vae as JV
    from omgsr_tpu_torch.tools.flux_checkpoint import precompiled_charsmap, synthetic_unigram, write_t5_tokenizer
    from omgsr_tpu_torch.tools.sd_checkpoint import synthetic_bpe, write_tokenizer

    jvae, _, jflux, _ = tiny_flux_configs()
    jclip, _, jt5, _ = tiny_text_configs()
    trees = {"vae": jax_init(JV.init_vae, seed, jvae), "flux": jax_init(JF.init_flux, seed + 1, jflux)}
    trees["lora_flux"] = jax_lora_tree(trees["flux"], 2, seed + 2, FLUX_TARGET_MODULES)
    trees["lora_vae"] = jax_lora_tree(trees["vae"]["encoder"], 2, seed + 3)
    trees["clip"] = jax_init(JC.init_clip_text, seed + 4, jclip)
    trees["t5"] = jax_init(JT5.init_t5_encoder, seed + 5, jt5)
    trees = {k: to_numpy_tree(v) for k, v in trees.items()}

    for sub in ("vae", "transformer", "text_encoder", "text_encoder_2"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    save_file(torch_layout(trees["vae"]), str(root / "vae" / "diffusion_pytorch_model.safetensors"))
    flux = torch_layout(trees["flux"])
    keys = sorted(flux)
    shards = {"diffusion_pytorch_model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "diffusion_pytorch_model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        save_file({k: flux[k] for k in ks}, str(root / "transformer" / name))
    (root / "transformer" / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: name for name, ks in shards.items() for k in ks}}))
    (root / "vae" / "config.json").write_text(json.dumps(
        {"block_out_channels": [8, 16], "norm_num_groups": 4, "latent_channels": 16, "layers_per_block": 1,
         "scaling_factor": 0.3611, "shift_factor": 0.1159, "use_quant_conv": False, "use_post_quant_conv": False}))
    (root / "transformer" / "config.json").write_text(json.dumps(
        {**_TINY_FLUX, "axes_dims_rope": list(_TINY_FLUX["axes_dims_rope"]), "in_channels": 64}))
    jax_save_adapter(trees["lora_flux"], str(root / "lora" / "flux_adapter"), rank=2, targets=FLUX_TARGET_MODULES)
    jax_save_adapter(trees["lora_vae"], str(root / "lora" / "vae_encoder_adapter"), rank=2,
                     targets=SD_TARGET_MODULES)
    rng = np.random.default_rng(seed)
    np.savez(root / "prompt.npz", prompt_embeds=rng.normal(size=(1, 5, 16)).astype(np.float32),
             pooled_prompt_embeds=rng.normal(size=(1, 8)).astype(np.float32))

    clip = torch_layout(trees["clip"])
    clip["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    save_file(clip, str(root / "text_encoder" / "model.safetensors"))
    (root / "text_encoder" / "config.json").write_text(json.dumps(TINY_FLUX_CLIP_KW))
    write_tokenizer(str(root / "tokenizer"), *synthetic_bpe(TINY_MERGES, seed), pad_token="<|endoftext|>")
    t5 = torch_layout(trees["t5"])
    t5["encoder.embed_tokens.weight"] = t5["shared.weight"]
    keys = sorted(t5)
    shards = {"model-00001-of-00002.safetensors": keys[: len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        save_file({k: t5[k] for k in ks}, str(root / "text_encoder_2" / name))
    (root / "text_encoder_2" / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: name for name, ks in shards.items() for k in ks}}))
    (root / "text_encoder_2" / "config.json").write_text(json.dumps(TINY_T5_KW))
    write_t5_tokenizer(str(root / "tokenizer_2"), synthetic_unigram(TINY_T5_PIECES, seed),
                       precompiled_charsmap(charsmap_rules()))
    return trees
