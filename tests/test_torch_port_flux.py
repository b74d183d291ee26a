"""The port's OMGSR-F slice against the JAX package on the CPU: packing and
RoPE ids (exact), RoPE and RMSNorm (1e-5), one dual and one single block and
flux_apply in f32 (1e-4: the timestep embedding's sinusoid at 244 * 1000
radians carries about 1e-5 through the blocks), flux_apply in bf16 (held to the
JAX package in f32 within BF16_REL of the output's largest value), init_flux's
tree, a scan-stacked JAX tree through from_jax_tree, the pipeline (tiled and
exact tiled VAE, 1e-3 as the -S pipeline), the porters and the config reader
(equal), infer_omgsr_f.main (PNGs within 1 uint8 step, posterior mean on both
sides; with --prompt through the directory's T5 and CLIP-L too), one serve
--pipeline f request, mid_timestep_flux.main (the same t on the same
batches), and the raises of what is not ported."""

import io
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.cli import infer_omgsr_f as JCLI
from omgsr_tpu.cli import mid_timestep_flux as JCALIB
from omgsr_tpu.convert import hf_config as JHF
from omgsr_tpu.convert import porters as JPORT
from omgsr_tpu.diffusion import packing as JP
from omgsr_tpu.inference.pipeline_f import OMGSRFPipeline as JPipeline
from omgsr_tpu.inference.pipeline_f import flux_auto_tile_batch as j_flux_auto_tile_batch
from omgsr_tpu.inference.tiled import auto_tile_batch as j_auto_tile_batch
from omgsr_tpu.models import flux as JF
from omgsr_tpu.models import layers as JL
from omgsr_tpu.models import vae as JV
from omgsr_tpu.models.configs import FluxConfig as JFluxConfig
from omgsr_tpu_torch.cli import infer_omgsr_f as CLI
from omgsr_tpu_torch.cli import mid_timestep_flux as CALIB
from omgsr_tpu_torch.cli import serve
from omgsr_tpu_torch.convert import hf_config as HF
from omgsr_tpu_torch.convert import porters as PORT
from omgsr_tpu_torch.convert.params import from_jax_tree, init_flux, to_jax_tree
from omgsr_tpu_torch.diffusion import packing as TP
from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline, flux_tile_batch
from omgsr_tpu_torch.models import flux as TF
from omgsr_tpu_torch.models import layers as TL
from omgsr_tpu_torch.models.configs import FluxConfig
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import (
    assert_close,
    bridge,
    jax_init,
    jax_once,
    t,
    tiny_flux_configs,
    write_tiny_flux_checkpoint,
)

OP_TOL = 1e-5
MODEL_TOL = 1e-4
PIPE_TOL = 1e-3
# bf16 on the port's side, f32 on the JAX side: every activation rounded to 8 bits of mantissa
# through 4 blocks; max |difference| over the output's largest value
BF16_REL = 0.02

J_VAE, T_VAE, J_FLUX, T_FLUX = tiny_flux_configs()
# head dim 64: the joint attention goes through the flash wrapper (its plain branch on the CPU)
_HD64 = dict(num_layers=1, num_single_layers=1, attention_head_dim=64, num_attention_heads=2,
             joint_attention_dim=16, pooled_projection_dim=8, axes_dims_rope=(8, 28, 28))
CONFIGS = {"head dim 8": (J_FLUX, T_FLUX), "head dim 64": (JFluxConfig(**_HD64), FluxConfig(**_HD64))}
COMMON = ["--process_size", "64", "--upscale", "4", "--align_method", "wavelet", "--weight_dtype", "fp32"]


def _flux_inputs(cfg, seed, b=2, grid=(4, 4), s_txt=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, grid[0] * grid[1], cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((b, s_txt, cfg.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((b, cfg.pooled_projection_dim)).astype(np.float32)
    img_ids = np.asarray(JP.latent_image_ids(*grid))
    return x, ctx, pooled, np.zeros((s_txt, 3), np.float32), img_ids


@pytest.fixture(scope="module")
def flux_params():
    return {name: jax_init(JF.init_flux, 1, jc) for name, (jc, _) in CONFIGS.items()}


@pytest.mark.parametrize("shape", [(2, 8, 6, 16), (1, 4, 12, 3)])
def test_packing_and_ids_are_the_jax_package_s(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    packed = TP.pack_latents(t(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JP.pack_latents(jnp.asarray(x))))
    np.testing.assert_array_equal(TP.unpack_latents(packed, *shape[1:3]).numpy(), x)
    h, w = shape[1] // 2, shape[2] // 2
    np.testing.assert_array_equal(TP.latent_image_ids(h, w).numpy(), np.asarray(JP.latent_image_ids(h, w)))


def test_rope_and_rms_norm_match():
    rng = np.random.default_rng(1)
    ids = np.concatenate([np.zeros((5, 3), np.float32), np.asarray(JP.latent_image_ids(6, 10))])
    axes = (16, 56, 56)
    jc, js = JF.rope_cos_sin(jnp.asarray(ids), axes)
    tc, ts = TF.rope_cos_sin(t(ids), axes)
    assert_close(tc, jc, OP_TOL, "cos")
    assert_close(ts, js, OP_TOL, "sin")
    x = (3 * rng.standard_normal((2, 65, 3, 128))).astype(np.float32)
    assert_close(TF.apply_rope(t(x), tc, ts), JF.apply_rope(jnp.asarray(x), jc, js), OP_TOL, "rope")
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    assert_close(TL.rms_norm({"weight": t(scale)}, t(x)), JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
                 OP_TOL, "rms_norm")
    # bf16: statistics in f32, the result in x's dtype
    y = TL.rms_norm({"weight": t(scale).bfloat16()}, t(x).bfloat16())
    assert y.dtype == torch.bfloat16
    ref = JL.rms_norm({"scale": jnp.asarray(scale).astype(jnp.bfloat16)}, jnp.asarray(x).astype(jnp.bfloat16))
    assert_close(y.float(), ref.astype(jnp.float32), 1e-2)


@pytest.mark.parametrize("block", ["dual", "single"])
def test_one_block_matches(flux_params, block):
    jc, tc = CONFIGS["head dim 64"]
    jp = flux_params["head dim 64"]
    tp = bridge(jp)
    x, ctx, _, txt_ids, img_ids = _flux_inputs(jc, 2)
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 16, jc.inner_dim)).astype(np.float32)
    txt = rng.standard_normal((2, 5, jc.inner_dim)).astype(np.float32)
    temb = rng.standard_normal((2, jc.inner_dim)).astype(np.float32)
    ids = np.concatenate([txt_ids, img_ids])
    jcos, jsin = JF.rope_cos_sin(jnp.asarray(ids), jc.axes_dims_rope)
    tcos, tsin = TF.rope_cos_sin(t(ids), tc.axes_dims_rope)
    if block == "dual":
        ref = jax_once(lambda p, i, x_, e: JF._dual_block(p, jc, i, x_, e, jcos, jsin),
                       jp["transformer_blocks"]["0"], img, txt, temb)
        out = TF._dual_block(tp["transformer_blocks"]["0"], tc, t(img), t(txt), t(temb), tcos, tsin)
        assert_close(out[0], ref[0], MODEL_TOL, "image stream")
        assert_close(out[1], ref[1], MODEL_TOL, "text stream")
    else:
        seq = np.concatenate([txt, img], axis=1)
        ref = jax_once(lambda p, s, e: JF._single_block(p, jc, s, e, jcos, jsin),
                       jp["single_transformer_blocks"]["0"], seq, temb)
        assert_close(TF._single_block(tp["single_transformer_blocks"]["0"], tc, t(seq), t(temb), tcos, tsin), ref,
                     MODEL_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flux_apply_matches_in_f32(flux_params, name):
    jc, tc = CONFIGS[name]
    jp = flux_params[name]
    x, ctx, pooled, txt_ids, img_ids = _flux_inputs(jc, 4)
    ref = jax_once(lambda p, x_, c, pl: JF.flux_apply(p, jc, x_, 0.37, 1.0, pl, c, jnp.asarray(txt_ids),
                                                      jnp.asarray(img_ids)), jp, x, ctx, pooled)
    out = TF.flux_apply(bridge(jp), tc, t(x), 0.37, 1.0, t(pooled), t(ctx), t(txt_ids), t(img_ids))
    assert out.shape == (2, 16, 64) and out.dtype == torch.float32
    assert_close(out, ref, MODEL_TOL)


def test_flux_apply_in_bf16_stays_near_f32(flux_params):
    jc, tc = CONFIGS["head dim 64"]
    jp = flux_params["head dim 64"]
    x, ctx, pooled, txt_ids, img_ids = _flux_inputs(jc, 5)
    ref = np.asarray(jax_once(lambda p, x_, c, pl: JF.flux_apply(
        p, jc, x_, 0.37, 1.0, pl, c, jnp.asarray(txt_ids), jnp.asarray(img_ids)), jp, x, ctx, pooled))
    tp = from_jax_tree(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16, device="cpu")
    out = TF.flux_apply(tp, tc, t(x).bfloat16(), 0.37, 1.0, t(pooled).bfloat16(), t(ctx).bfloat16(), t(txt_ids),
                        t(img_ids))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= BF16_REL, err


def test_init_flux_has_the_jax_tree_and_init_family():
    shapes = jax.eval_shape(lambda k: JF.init_flux(k, J_FLUX), jax.random.key(0))
    want = {p: tuple(np.shape(v)) for p, v in flatten_dict(jax.tree.map(lambda s: np.zeros(s.shape), shapes)).items()}
    tree = init_flux(0, T_FLUX, torch.float32, "cpu")
    got = {p: tuple(v.shape) for p, v in flatten_dict(to_jax_tree(tree)).items()}
    assert got == want
    # the JAX initialiser's bounds: weights U(+-sqrt(3 / fan_in)), biases U(+-1 / sqrt(fan_in)), RMS scales 1
    q = tree["transformer_blocks"]["0"]["attn"]["to_q"]
    fan_in = J_FLUX.inner_dim
    assert q["weight"].abs().max() <= (3 / fan_in) ** 0.5 and q["weight"].abs().max() > 1 / fan_in ** 0.5
    assert q["bias"].abs().max() <= 1 / fan_in ** 0.5
    assert torch.equal(tree["single_transformer_blocks"]["1"]["attn"]["norm_k"]["weight"], torch.ones(8))
    assert sum(v.numel() for v in flatten_dict(init_flux(0, FluxConfig(), torch.bfloat16, "meta")).values()) \
        == 11_901_408_320


def test_a_stacked_jax_tree_unstacks(flux_params):
    jp = flux_params["head dim 8"]
    stacked = jax.tree.map(np.asarray, JF.stack_block_params(jp))
    assert set(stacked["transformer_blocks"]) == {"stacked"}
    got = flatten_dict(from_jax_tree(stacked, device="cpu"))
    want = flatten_dict(bridge(jp))
    assert set(got) == set(want)
    assert all(torch.equal(got[p], want[p]) for p in want)


@pytest.fixture(scope="module")
def pipes():
    vp = jax_init(JV.init_vae, 0, J_VAE)
    fp = jax_init(JF.init_flux, 1, J_FLUX)
    rng = np.random.default_rng(2)
    prompt = rng.standard_normal((1, 5, 16)).astype(np.float32)
    pooled = rng.standard_normal((1, 8)).astype(np.float32)
    return vp, fp, bridge(vp), bridge(fp), prompt, pooled


@pytest.mark.parametrize("vae_tile,vae_stats", [(None, "fast"), (16, "exact")])
def test_pipeline_matches(pipes, vae_tile, vae_stats):
    """A 32x32 input: a 16x16 latent in 9 overlapping tiles of 8 (three DiT
    calls of 3); the exact tiled VAE beyond a 16-px tile."""
    vp, fp, tvp, tfp, prompt, pooled = pipes
    jpipe = JPipeline(vp, fp, J_VAE, J_FLUX, vae_tile=vae_tile, vae_stats=vae_stats)
    tpipe = OMGSRFPipeline(tvp, tfp, T_VAE, T_FLUX, vae_tile=vae_tile, vae_stats=vae_stats, device="cpu")
    lq = np.random.default_rng(3).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    if vae_stats == "exact":  # host-orchestrated on the JAX side: its own jits
        ref = jpipe(jnp.asarray(lq), jnp.asarray(prompt), jnp.asarray(pooled), 8, 4)
    else:
        ref = jax_once(lambda x, p, pl: jpipe(x, p, pl, 8, 4), jnp.asarray(lq), jnp.asarray(prompt),
                       jnp.asarray(pooled))
    calls = []
    apply = TF.flux_apply
    TF.flux_apply = lambda p, c, x, *a: calls.append(x.shape[0]) or apply(p, c, x, *a)
    try:
        out = tpipe(lq, prompt, pooled, 8, 4)
    finally:
        TF.flux_apply = apply
    assert calls == [3, 3, 3], calls
    assert out.shape == (1, 32, 32, 3) and float(out.min()) >= -1.0 and float(out.max()) <= 1.0
    assert_close(out, ref, PIPE_TOL)


@pytest.mark.parametrize("tile_size", [64, 96, 128])
def test_flux_tile_batch_rule(tile_size):
    """Below 4096 tokens a tile (512 text tokens) the JAX package's default,
    the padding-free divisor; from 4096, where the JAX package takes one tile a
    forward, that divisor where it divides the tile count, else one."""
    tokens = (tile_size // 2) ** 2 + 512
    got = [flux_tile_batch(n, tokens) for n in range(1, 50)]
    if j_flux_auto_tile_batch(tile_size, 512) is None:
        assert got == [j_auto_tile_batch(n) for n in range(1, 50)]
    else:
        assert got[:16] == [1, 2, 3, 4, 5, 6, 7, 8, 3, 5, 1, 6, 1, 7, 5, 8], got
        assert all(n % tb == 0 for n, tb in enumerate(got, 1)), got


@pytest.mark.parametrize("hw,calls", [((256, 256), [3] * 3), ((128, 832), [6] * 2), ((128, 896), [1] * 13),
                                      ((96, 608), [6] * 2)])
def test_pipeline_default_tile_batch(pipes, monkeypatch, hw, calls):
    """The DiT calls of latent_mid with tile_batch=None, 128-latent tiles and
    512 text tokens: 9, 12 and 13 tiles of 4608 tokens; a 96-latent image
    clamps the tile to 2816 tokens (12 tiles)."""
    _, _, tvp, tfp, _, _ = pipes
    pipe = OMGSRFPipeline(tvp, tfp, T_VAE, T_FLUX, device="cpu")
    seen = []
    monkeypatch.setattr(TF, "flux_apply", lambda p, c, x, *a: seen.append(x.shape[0]) or torch.zeros_like(x))
    pipe.latent_mid(torch.zeros((1, *hw, 16)), torch.zeros((1, 512, 16)), torch.zeros((1, 8)), 128, 64)
    assert seen == calls, seen


def test_unported_parts_raise(pipes, tmp_path, capsys):
    _, _, tvp, tfp, _, _ = pipes
    # multi-GPU serving is ported (tests/test_torch_port_parallel.py); an unknown strategy is refused
    with pytest.raises(ValueError, match="strategy"):
        OMGSRFPipeline(tvp, tfp, T_VAE, T_FLUX, device="cpu").shard_for_mesh(None, strategy="pipeline")
    base = ["--input_image", str(tmp_path), "--output_dir", str(tmp_path), "--flux_path", str(tmp_path),
            "--device", "cpu"]
    # the prompt encoders are ported: without --prompt_npz the prompt needs the checkpoint's encoders
    with pytest.raises(ValueError, match="--flux_path"):
        CLI.prompt_embeddings(CLI.parse_args(base[:4] + ["--flux_path", ""]), torch.float32, "cpu")
    # the quantised DiT is ported (tests/test_torch_port_quantize.py): --quantize reaches the directory
    with pytest.raises(FileNotFoundError):
        CLI.build_pipeline(CLI.parse_args(base + ["--quantize", "int8"]), torch.float32, "cpu")
    # --shard in one process without a process group runs unsharded, as the JAX CLI does with one device
    with pytest.raises(FileNotFoundError, match="p.npz"):
        CLI.main(CLI.parse_args(base + ["--shard", "tiles", "--prompt_npz", "p.npz"]))
    assert "--shard tiles: only one device visible — running unsharded" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--flux_path"):
        serve.build_server(serve.parse_args(["--pipeline", "f", "--device", "cpu", "--prompt_npz", "p.npz"]))


# ----------------------------------------------------------------------------
# the load path and the CLIs, on one tiny checkpoint directory
# ----------------------------------------------------------------------------

INPUTS = {"a.png": (20, 16), "b.png": (12, 18)}


# encoded into the fixture's prompt.npz by the JAX package's encoders
PROMPT = "a photo with ｆｕｌｌ-width words <extra_id_1>"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny directory; its prompt.npz holds the JAX package's
    encode_prompt_flux embeddings of PROMPT (its T5 in f32, the tiny
    encoders' configs handed to it: it reads FLUX_CLIP_L / FLUX_T5_XXL)."""
    import functools

    import omgsr_tpu.convert as JCONV
    import omgsr_tpu.models.configs as JCFG
    from omgsr_tpu.cli.prompts import encode_prompt_flux as j_encode
    from tests.torch_port_helpers import tiny_text_configs

    root = tmp_path_factory.mktemp("tiny_flux")
    trees = write_tiny_flux_checkpoint(root)
    jclip, _, jt5, _ = tiny_text_configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JCFG, "FLUX_CLIP_L", jclip)
        mp.setattr(JCFG, "FLUX_T5_XXL", jt5)
        mp.setattr(JCONV, "port_t5_encoder", functools.partial(JCONV.port_t5_encoder, dtype=jnp.float32))
        embeds, pooled, _ = j_encode(str(root), PROMPT, dtype=jnp.float32)
    np.savez(root / "prompt.npz", prompt_embeds=np.asarray(embeds), pooled_prompt_embeds=np.asarray(pooled))
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name, (w, h) in INPUTS.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(imgs / name)
    return root, trees


def test_porters_and_config_match_the_jax_ones(ckpt):
    root, _ = ckpt
    cfg = HF.flux_config_from_json(str(root / "transformer"))
    jcfg = JHF.flux_config_from_json(str(root / "transformer"))
    assert cfg == T_FLUX and {k: getattr(jcfg, k) for k in vars(cfg)} == vars(cfg)
    got = PORT.port_flux_transformer(str(root / "transformer"), cfg=cfg, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in flatten_dict(got).values())
    ref = JPORT.port_flux_transformer(str(root / "transformer"), cfg=jcfg)
    got = flatten_dict(to_jax_tree(got))
    want = flatten_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), ref))
    assert set(got) == set(want)
    assert all(np.array_equal(got[p], want[p]) for p in want)
    with pytest.raises(ValueError, match="flux port mismatch"):
        PORT.port_flux_transformer(str(root / "transformer"), cfg=FluxConfig(**{**vars(cfg), "num_layers": 3}),
                                   device="cpu")


@pytest.fixture(scope="module")
def cli_outputs(ckpt, tmp_path_factory):
    """Both CLIs on the same directory, each pipeline call patched to take the
    posterior mean of the latent (both CLIs sample it, from their own noise)."""
    root, _ = ckpt
    out = tmp_path_factory.mktemp("out_f")
    args = ["--input_image", str(root / "imgs"), "--flux_path", str(root), "--lora_path", str(root / "lora"),
            "--prompt_npz", str(root / "prompt.npz"), *COMMON]
    call = JPipeline.__call__
    JPipeline.__call__ = lambda self, *a, **k: call(self, *a, **{**k, "sample_latent": False})
    jax.config.update("jax_disable_most_optimizations", True)  # compile time, not the sums, is what drops
    try:
        JCLI.main(JCLI.parse_args(args + ["--output_dir", str(out / "jax")]))
    finally:
        JPipeline.__call__ = call
        jax.config.update("jax_disable_most_optimizations", False)
    port_call = OMGSRFPipeline.__call__
    OMGSRFPipeline.__call__ = lambda self, *a, **k: port_call(self, *a, **{**k, "sample_latent": False})
    try:
        CLI.main(CLI.parse_args(args + ["--output_dir", str(out / "port"), "--device", "cpu"]))
    finally:
        OMGSRFPipeline.__call__ = port_call
    return out


def test_infer_cli_matches_the_jax_cli(cli_outputs):
    for name, (w, h) in INPUTS.items():
        ours = np.asarray(Image.open(cli_outputs / "port" / name))
        ref = np.asarray(Image.open(cli_outputs / "jax" / name))
        assert ours.shape == ref.shape == (4 * h, 4 * w, 3), name
        assert ours.std() > 1.0, name
        d = np.abs(ours.astype(int) - ref.astype(int))
        assert d.max() <= 1, (name, d.max(), d.mean())


def test_infer_cli_encodes_the_prompt_as_the_jax_cli(ckpt, cli_outputs, tmp_path, monkeypatch):
    """--prompt in place of --prompt_npz: the port's CLI encodes PROMPT with the
    directory's T5 and CLIP-L (T5 in f32) and gives the JAX CLI's PNGs, which
    were made from the JAX package's encode_prompt_flux embeddings of PROMPT
    (the ``ckpt`` fixture's prompt.npz): within 1 uint8 step (posterior mean)."""
    import functools

    root, _ = ckpt
    monkeypatch.setattr(PORT, "port_t5_encoder", functools.partial(PORT.port_t5_encoder, dtype=torch.float32))
    port_call = OMGSRFPipeline.__call__
    monkeypatch.setattr(OMGSRFPipeline, "__call__",
                        lambda self, *a, **k: port_call(self, *a, **{**k, "sample_latent": False}))
    CLI.main(CLI.parse_args(["--input_image", str(root / "imgs"), "--flux_path", str(root), "--lora_path",
                             str(root / "lora"), "--prompt", *PROMPT.split(" "), *COMMON,
                             "--output_dir", str(tmp_path), "--device", "cpu"]))
    for name in INPUTS:
        ours = np.asarray(Image.open(tmp_path / name))
        ref = np.asarray(Image.open(cli_outputs / "jax" / name))
        assert ours.shape == ref.shape and ours.std() > 1.0, name
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1, name


def test_serve_pipeline_f_answers_with_the_cli_image(ckpt, cli_outputs):
    root, _ = ckpt
    args = serve.parse_args(["--pipeline", "f", "--flux_path", str(root), "--lora_path", str(root / "lora"),
                             "--prompt_npz", str(root / "prompt.npz"), "--device", "cpu", "--latent", "mean",
                             "--port", "0", *COMMON])
    assert args.mid_timestep == 244
    server, httpd = serve.main(args, serve_forever=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        host, port = httpd.server_address[:2]
        body = (root / "imgs" / "a.png").read_bytes()
        req = urllib.request.Request(f"http://{host}:{port}/v1/sr?align=wavelet", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        httpd.shutdown()
        server.shutdown()
    ref = np.asarray(Image.open(cli_outputs / "port" / "a.png"))
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_mid_timestep_flux_main_gives_the_jax_t(ckpt, tmp_path, monkeypatch, capsys):
    """Both CLIs on the same VAE directory and the same batches (their loaders
    draw their own degradations, so both are handed one list of pairs), each
    encoder at the posterior mean."""
    import omgsr_tpu.data.dataset as JDS
    import omgsr_tpu_torch.data.dataset as TDS
    import omgsr_tpu_torch.models.vae as TV

    root, _ = ckpt
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        hq = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
        batches.append({"hq": hq, "lq": np.clip(hq + 0.3 * rng.normal(size=hq.shape), -1, 1).astype(np.float32)})
    for mod in (JDS, TDS):
        monkeypatch.setattr(mod, "PairedLoader", lambda *a, **k: batches)
    j_encode, t_encode = JV.vae_encode, TV.vae_encode
    monkeypatch.setattr(JV, "vae_encode", lambda p, c, x, rng=None: j_encode(p, c, x))
    monkeypatch.setattr(TV, "vae_encode", lambda p, c, x, generator=None: t_encode(p, c, x, sample=False))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    from omgsr_tpu_torch.data.degradation import DEFAULT_PARAMS

    argv = ["--dataset_txt_or_dir_paths", str(root / "imgs"), "--flux_path", str(root), "--resolution", "32",
            "--degradation_params", DEFAULT_PARAMS]
    JCALIB.main(argv)
    ref_t = int(capsys.readouterr().out.split("Optimal timestep t: ")[1].split()[0])
    t_best, avg = CALIB.main(argv + ["--device", "cpu"])
    assert t_best == ref_t and 0 <= t_best < 1000 and np.isfinite(avg).all() and avg.shape == (1000,)
