"""The port's quantised DiT against the JAX package on the CPU: int8 and int4
codes and scales bit for bit (per channel and per group of 128), their
unpacking and dequantisation (equal), the tree rules (min_params,
W8A8_EXCLUDE, the w8a8 upgrade, the refusals; every leaf equal to the JAX
tree's across the bridge), the bridge both ways with a scan-stacked tree,
the tiny FLUX forward under int8, int4 and w8a8 in f32, one TrainerF step on
an int4 base, and infer_omgsr_f --quantize int8 against the JAX CLI."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.cli import infer_omgsr_f as JCLI
from omgsr_tpu.diffusion import packing as JP
from omgsr_tpu.inference.pipeline_f import OMGSRFPipeline as JPipeline
from omgsr_tpu.models import flux as JF
from omgsr_tpu.utils import quantize as JQ
from omgsr_tpu_torch.cli import infer_omgsr_f as CLI
from omgsr_tpu_torch.cli import serve
from omgsr_tpu_torch.convert.params import from_jax_tree, init_flux, to_jax_tree
from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline
from omgsr_tpu_torch.lora import FLUX_TARGET_MODULES, attach_lora, init_lora_tree, merge_lora
from omgsr_tpu_torch.models import flux as TF
from omgsr_tpu_torch.models import layers as TL
from omgsr_tpu_torch.utils import quantize as TQ
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import (
    assert_close,
    bridge,
    jax_init,
    jax_once,
    t,
    tiny_flux_configs,
    to_numpy_tree,
    write_tiny_flux_checkpoint,
)

_, _, J_FLUX, T_FLUX = tiny_flux_configs()
MIN = 1 << 6  # the tiny DiT's layers hold 2,048-20,480 weights
# the f32 forward's bound, as tests/test_torch_port_flux.py holds the float DiT
MODEL_TOL = 1e-4
# w8a8: an activation code that lands on a .5 tie in one package and off it in the other rounds the
# other way, and moves its outputs by one code step times the two scales, about 1e-2 here; no code did
# on this input. Measured on the tiny DiT (4 blocks, the fixture's inputs): max |difference| 1.1e-06
# over an output of max 1.95 (int8 7.2e-07, int4 g16 7.7e-07), so the float DiT's bound holds
W8A8_TOL = MODEL_TOL
MODES = {"int8": dict(bits=8), "int4 g16": dict(bits=4, group_size=16), "int8_w8a8": dict(act_quant=True)}


def _np_tree(tree):
    return {"/".join(p): np.asarray(v) for p, v in flatten_dict(to_numpy_tree(tree)).items()}


def _assert_trees_equal(port_tree, jax_tree):
    got, want = _np_tree(to_jax_tree(port_tree)), _np_tree(jax_tree)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind,shape", [("int8", (256, 48)), ("int4 per group", (256, 48)),
                                        ("int4 per channel", (96, 40)), ("int4 per channel", (128, 16))])
def test_codes_and_scales_are_the_jax_package_s(kind, shape):
    """(in, out) weights on the JAX side, (out, in) on the port's: codes and
    scales bit for bit, int4 group-wise only where 128 divides a larger in dim.
    The JAX package quantises op by op (not under jit, where XLA may turn
    the division by 127 into a product with its reciprocal), so its
    functions run eagerly here."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[3, :] *= 40  # an outlier row: its group's scale differs from the others'
    if kind == "int8":
        jq, js = JQ.quantize_kernel_int8(jnp.asarray(w))
        q, s = TQ.quantize_kernel_int8(t(w.T))
        key = "kernel_q"
    else:
        jq, js = JQ.quantize_kernel_int4(jnp.asarray(w))
        q, s = TQ.quantize_kernel_int4(t(w.T))
        key = "kernel_q4"
        np.testing.assert_array_equal(TQ.unpack_int4(q).numpy().T, np.asarray(jax_once(JQ.unpack_int4, jq)))
    assert s.dim() == (2 if kind == "int4 per group" else 1)
    assert q.dtype == (torch.int8 if kind == "int8" else torch.uint8)
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().T, np.asarray(js))
    p = {"weight_q4" if key == "kernel_q4" else "weight_q": q, "weight_scale": s}
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(jax_once(lambda q_, s_: JQ.dequantize_kernel({key: q_, "kernel_scale": s_}, jdtype).astype(
            jnp.float32), jq, js))
        np.testing.assert_array_equal(TQ.dequantize_weight(p, dtype).float().numpy().T, ref)


def _jax_tree(seed=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)  # noqa: E731
    return {"big": {"kernel": f(512, 256), "bias": f(256), "inner": {"kernel": f(64, 32)}},
            "odd": {"kernel": f(33, 64)}, "small": {"kernel": f(8, 8)}, "conv": {"kernel": f(3, 3, 64, 64)},
            "norm1": {"linear": {"kernel": f(64, 64)}, "scale": f(64)}}


@pytest.mark.parametrize("mode", ["int8", "int4", "int8_w8a8", "int8 then w8a8"])
def test_tree_rules_are_the_jax_package_s(mode):
    """Every leaf of the port's quantised tree equals the JAX package's across
    the bridge: which weights are quantised (min_params, 2-D only, the sibling
    inside a quantised module), int4's int8 fallback at an odd in dim, the
    markers outside W8A8_EXCLUDE, and the upgrade of a weight-only tree."""
    jtree = _jax_tree()
    port = bridge(jtree)
    kw = dict(min_params=1 << 10)
    if mode == "int4":
        jq, q = JQ.quantize_tree_int4(jtree, **kw), TQ.quantize_tree_int4(port, **kw)
        assert "weight_q4" in q["big"] and "weight_q" in q["odd"]  # 33 rows cannot pack
    elif mode == "int8 then w8a8":
        jq = JQ.quantize_tree_int8(JQ.quantize_tree_int8(jtree, **kw), act_quant=True, **kw)
        q = TQ.quantize_tree_int8(TQ.quantize_tree_int8(port, **kw), act_quant=True, **kw)
        assert "act_quant" in q["big"]
    else:
        jq = JQ.quantize_tree_int8(jtree, act_quant=mode == "int8_w8a8", **kw)
        q = TQ.quantize_tree_int8(port, act_quant=mode == "int8_w8a8", **kw)
    _assert_trees_equal(q, jq)
    assert "weight" in q["small"] and "weight" in q["conv"] and "weight" not in q["big"]["inner"]
    assert "act_quant" not in q["norm1"]["linear"]  # W8A8_EXCLUDE
    assert TQ.tree_bytes(q) < TQ.tree_bytes(port) and TQ.tree_bytes(q) == JQ.tree_bytes(jq)


def test_refusals_are_the_jax_package_s():
    port = bridge(_jax_tree())
    q4 = TQ.quantize_tree_int4(port, min_params=1 << 10)
    with pytest.raises(ValueError, match="act_quant requested on an int4"):
        TQ.quantize_tree_int8(q4, act_quant=True, min_params=1 << 10)
    with pytest.raises(ValueError, match="requires int8 codes"):
        TQ.quantize_tree_int8(port, act_quant=True, bits=4)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        TQ.quantize_tree_int8(port, bits=2)
    with pytest.raises(ValueError, match="even in dim"):
        TQ.quantize_kernel_int4(torch.zeros(4, 33))
    lora = {"big": {"lora_A": torch.zeros(2, 512), "lora_B": torch.zeros(256, 2)}}
    with pytest.raises(ValueError, match="cannot merge LoRA into a quantized kernel at big"):
        merge_lora(q4, lora)
    with pytest.raises(ValueError, match="inference-only"):
        TL.dense(TQ.quantize_tree_int8(port, act_quant=True, min_params=1 << 10)["big"],
                 torch.zeros(2, 512, requires_grad=True))


def test_bridge_carries_stacked_quantised_trees_both_ways():
    """A scan-stacked JAX tree quantised (int8 w8a8 and int4 g16) unstacks
    into the port's per-block layout with the codes, scales and markers of
    each block, and goes back to the unstacked JAX tree's leaves."""
    jp = jax_init(JF.init_flux, 1, J_FLUX)
    kept = ("kernel_q", "kernel_q4", "kernel_scale", "act_quant")
    for kw in (dict(act_quant=True), dict(bits=4, group_size=16)):
        stacked, flat = jax_once(lambda p: (JQ.quantize_tree_int8(JF.stack_block_params(p), min_params=MIN, **kw),
                                            JQ.quantize_tree_int8(p, min_params=MIN, **kw)), jp)
        port = from_jax_tree(to_numpy_tree(stacked), dtype=torch.bfloat16, device="cpu")
        # float leaves are cast to bf16 by the bridge; codes, scales and markers keep their dtypes
        _assert_trees_equal(port, jax.tree_util.tree_map_with_path(
            lambda p, a: a if p[-1].key in kept else a.astype(jnp.bfloat16).astype(jnp.float32), flat))
        blk = port["transformer_blocks"]["1"]["attn"]["to_q"]
        assert blk["weight_scale"].dtype == torch.float32  # scales stay f32 whatever dtype says
        assert (blk["weight_q4"] if "bits" in kw else blk["act_quant"]).dtype in (torch.uint8, torch.int8)


@pytest.fixture(scope="module")
def tiny_flux():
    jp = jax_init(JF.init_flux, 1, J_FLUX)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 16)).astype(np.float32)
    pooled = rng.standard_normal((2, 8)).astype(np.float32)
    ids = (np.zeros((5, 3), np.float32), np.asarray(JP.latent_image_ids(4, 4)))
    return jp, (x, ctx, pooled, *ids)


@pytest.mark.parametrize("mode", list(MODES))
def test_tiny_flux_forward_matches(tiny_flux, mode):
    jp, (x, ctx, pooled, txt_ids, img_ids) = tiny_flux
    ref = jax_once(lambda p, a, c, e: JF.flux_apply(JQ.quantize_tree_int8(p, min_params=MIN, **MODES[mode]), J_FLUX,
                                                    a, 0.5, 1.0, e, c, txt_ids, img_ids), jp, x, ctx, pooled)
    q = TQ.quantize_tree_int8(bridge(jp), min_params=MIN, **MODES[mode])
    with torch.no_grad():
        out = TF.flux_apply(q, T_FLUX, t(x), 0.5, 1.0, t(pooled), t(ctx), t(txt_ids), t(img_ids))
    assert_close(out, ref, W8A8_TOL if mode == "int8_w8a8" else MODEL_TOL, mode)
    with torch.no_grad():
        full = TF.flux_apply(bridge(jp), T_FLUX, t(x), 0.5, 1.0, t(pooled), t(ctx), t(txt_ids), t(img_ids))
    assert 0 < (out - full).norm() / full.norm() < 0.1  # quantised, and close to the float DiT


def test_quantized_init_and_serving_function_place_only_codes():
    """init_flux_quantized draws init_flux's numbers and quantises block by
    block; quantize_flux_for_serving gives the same tree; LoRA on the codes
    gets bf16 factors (int4: the in dim doubled from the packed bytes) and
    trains through the dequantising autograd function."""
    q = TQ.init_flux_quantized(3, T_FLUX, torch.float32, "cpu", bits=4, min_params=MIN)
    ref = TQ.quantize_flux_for_serving(init_flux(3, T_FLUX, torch.float32, "cpu"), bits=4, min_params=MIN,
                                       device="cpu")
    got, want = flatten_dict(q), flatten_dict(ref)
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    to_q = q["transformer_blocks"]["0"]["attn"]["to_q"]
    assert set(to_q) == {"weight_q4", "weight_scale", "bias"} and to_q["weight_q4"].shape == (32, 16)
    lora = init_lora_tree(torch.Generator().manual_seed(0), q, FLUX_TARGET_MODULES, 2)
    a = lora["transformer_blocks"]["0"]["attn"]["to_q"]["lora_A"]
    assert a.dtype == torch.bfloat16 and a.shape == (2, 32)
    flat = {p: v.float().requires_grad_() for p, v in flatten_dict(lora).items()}
    from omgsr_tpu_torch.utils.tree import unflatten_dict

    x = torch.randn(1, 16, 64, requires_grad=True)
    out = TF.flux_apply(attach_lora(q, unflatten_dict(flat)), dataclasses.replace(T_FLUX, remat_blocks=True), x,
                        0.5, 1.0, torch.randn(1, 8), torch.randn(1, 5, 16), torch.zeros(5, 3),
                        t(np.asarray(JP.latent_image_ids(4, 4))))
    out.square().mean().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert all(v.grad is not None for v in flat.values())


# ----------------------------------------------------------------------------
# TrainerF on an int4 base, and the CLI
# ----------------------------------------------------------------------------


def test_train_f_step_on_an_int4_base_matches_jax():
    """One micro-step (accumulation 1) of TrainerF on an int4 (g16) frozen DiT
    with the same numpy LoRA, batch and noise as the JAX TrainerF on its
    int4 tree: the ten metrics, pred and the updated LoRA within the float
    step's STEP_TOL (1e-3 relative)."""
    from omgsr_tpu.config import TrainConfig as JTrainConfig
    from omgsr_tpu.training.trainer import TrainerF as JTrainerF
    from omgsr_tpu_torch.config import TrainConfig
    from omgsr_tpu_torch.training.trainer import TrainerF
    from tests.test_torch_port_train_f import KW, LATENT, _batch, _port_bundle, bundle
    from tests.test_torch_port_trainer import METRICS, STEP_TOL, _assert_tree_close, _replay_noise

    frozen, lora, disc = bundle._get_wrapped_function()()
    tfrozen, tlora, tdisc = _port_bundle((frozen, lora, disc))
    kw = dict(min_params=MIN, bits=4, group_size=16)
    frozen = dict(frozen, flux=JQ.quantize_tree_int8(frozen["flux"], **kw))
    tfrozen["flux"] = TQ.quantize_tree_int8(tfrozen["flux"], **kw)
    _assert_trees_equal(tfrozen["flux"], frozen["flux"])
    cfg = dict(KW, gradient_accumulation_steps=1)
    jtr = JTrainerF(JTrainConfig(**cfg), frozen, lora, disc)
    ttr = TrainerF(TrainConfig(**cfg), tfrozen, tlora, tdisc)
    batch = _batch(10)
    key = jax.random.key(20)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(jtr._train_step).lower(jtr.state, jb, key, jtr._frozen_arrays).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    jstate, (jmetrics, jpred) = jstep(jtr.state, jb, key, jtr._frozen_arrays)
    metrics, pred = ttr.train_step({k: t(v) for k, v in batch.items()},
                                   _replay_noise(key, batch["hq"].shape, LATENT))
    for name in METRICS:
        want = float(jmetrics[name])
        assert abs(float(metrics[name]) - want) <= STEP_TOL * max(abs(want), 1e-6), (name, float(metrics[name]), want)
    assert_close(pred, jpred, STEP_TOL, "pred")
    _assert_tree_close(ttr.state["gen"]["lora"], jstate["gen"]["lora"], STEP_TOL, "lora")


def test_infer_cli_quantize_int8_matches_the_jax_cli(tmp_path):
    """infer_omgsr_f --quantize int8 from a tiny FLUX.1-dev directory (the
    DiT ported on the CPU, the flux_adapter merged there, then quantised)
    against the JAX CLI with the same flags: PNGs within 1 uint8 step
    (posterior mean on both sides); serve --pipeline f --quantize int8 on
    the same directory gives the CLI's image."""
    root = tmp_path / "flux"
    write_tiny_flux_checkpoint(root)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (12, 18, 3), dtype=np.uint8)).save(imgs / "a.png")
    args = ["--input_image", str(imgs), "--flux_path", str(root), "--lora_path", str(root / "lora"),
            "--prompt_npz", str(root / "prompt.npz"), "--process_size", "64", "--upscale", "4",
            "--align_method", "wavelet", "--weight_dtype", "fp32", "--quantize", "int8",
            "--quantize_min_params", str(MIN)]
    call = JPipeline.__call__
    JPipeline.__call__ = lambda self, *a, **k: call(self, *a, **{**k, "sample_latent": False})
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        JCLI.main(JCLI.parse_args(args + ["--output_dir", str(tmp_path / "jax")]))
    finally:
        JPipeline.__call__ = call
        jax.config.update("jax_disable_most_optimizations", False)
    seen = {}
    port_call = OMGSRFPipeline.__call__

    def mean_call(self, *a, **k):
        seen["flux"] = self.flux_params
        return port_call(self, *a, **{**k, "sample_latent": False})

    OMGSRFPipeline.__call__ = mean_call
    try:
        CLI.main(CLI.parse_args(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"]))
    finally:
        OMGSRFPipeline.__call__ = port_call
    to_q = seen["flux"]["transformer_blocks"]["0"]["attn"]["to_q"]
    assert set(to_q) == {"weight_q", "weight_scale", "bias"} and to_q["weight_q"].dtype == torch.int8
    ours = np.asarray(Image.open(tmp_path / "port" / "a.png"))
    ref = np.asarray(Image.open(tmp_path / "jax" / "a.png"))
    assert ours.shape == ref.shape == (48, 72, 3) and ours.std() > 1.0
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1

    server = serve.build_server(serve.parse_args(
        ["--pipeline", "f", *args[2:], "--device", "cpu", "--latent", "mean"]))
    try:
        got = np.asarray(Image.open(io.BytesIO(server.process_image((imgs / "a.png").read_bytes(), "wavelet"))))
    finally:
        server.shutdown()
    assert got.shape == ours.shape and np.abs(got.astype(int) - ours.astype(int)).max() <= 1
