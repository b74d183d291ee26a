"""The port's load path against the JAX package's: the safetensors reader and
writer against the ``safetensors`` package, the HF config readers, the
porters on one checkpoint directory that both packages read, and LoRA
adapters across the two packages. Every comparison is exact (the porters copy
bits; only a cast rounds, and both round to nearest even)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from omgsr_tpu import convert as JP
from omgsr_tpu.convert import hf_config as JH
from omgsr_tpu.lora import adapter_io as JA
from omgsr_tpu.models.configs import CLIPTextConfig as JCLIPTextConfig
from omgsr_tpu.models.configs import ConvNeXtConfig as JConvNeXtConfig
from omgsr_tpu.utils.tree import flatten_dict as jflatten
from omgsr_tpu_torch.config import TrainConfig
from omgsr_tpu_torch.convert import hf_config as H
from omgsr_tpu_torch.convert import porters as P
from omgsr_tpu_torch.convert import safetensors_io as S
from omgsr_tpu_torch.convert.params import to_hf_state_dict, to_jax_tree
from omgsr_tpu_torch.lora import FLUX_TARGET_MODULES, SD_TARGET_MODULES
from omgsr_tpu_torch.lora import adapter_io as A
from omgsr_tpu_torch.models.configs import CLIPTextConfig, ConvNeXtConfig
from omgsr_tpu_torch.training import checkpoint as CK
from tests.torch_port_helpers import (
    J_TINY_CONVNEXT_KW,
    T_TINY_UNET,
    T_TINY_VAE,
    TINY_CLIP_KW,
    write_tiny_checkpoint,
)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_sd")
    return root, write_tiny_checkpoint(root)


# the CLIP embedding tables: (rows, width) under ``weight`` in both packages, where
# to_jax_tree would make a dense layer's ``kernel`` of a 2-D weight
TABLES = ("token_embedding", "position_embedding")


def assert_trees_equal(port_tree, jax_tree, what=""):
    got = jflatten(to_jax_tree(port_tree))
    for p, t in jflatten(port_tree).items():
        if len(p) > 1 and p[-2] in TABLES:
            del got[p[:-1] + ("kernel",)]
            got[p] = t.float().numpy()
    want = jflatten(jax_tree)
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    for p in want:
        a, b = np.asarray(got[p]), np.asarray(want[p], np.float32)
        assert a.shape == b.shape and np.array_equal(a, b), (what, p)


# ----------------------------------------------------------------------------
# safetensors
# ----------------------------------------------------------------------------

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.uint8, torch.bool,
          torch.float64]


def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    base = torch.randn(3, 5, 7, generator=g) * 100
    out = {"a.weight": base, "b.bias": base[0, :, 1:2].flatten().clone(), "scalar": base[1, 2, 3].clone(),
           "empty": base[:0].clone()}
    if dtype == torch.bool:
        return {k: v > 0 for k, v in out.items()}
    return {k: v.to(dtype) for k, v in out.items()}


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(torch.uint8) if a.dim() else a,
                                                                   b.view(torch.uint8) if b.dim() else b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_reads_what_the_package_writes(tmp_path, dtype):
    from safetensors.torch import save_file

    tensors = _tensors(dtype)
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = S.load_file(str(tmp_path / "x.safetensors"))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert _same_bits(got[k], v), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_package_reads_what_the_writer_writes(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import load_file

    tensors = _tensors(dtype)
    # a non-contiguous view and a channels_last conv weight are written as their contiguous values
    tensors["view"] = tensors["a.weight"].transpose(0, 2)
    tensors["conv"] = tensors["a.weight"][None].contiguous(memory_format=torch.channels_last)
    S.save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt", "step": 3})
    got = load_file(str(tmp_path / "x.safetensors"))
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert _same_bits(got[k], v.contiguous()), k
    with safe_open(str(tmp_path / "x.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt", "step": "3"}
    # and the port reads it back the same
    again = S.load_file(str(tmp_path / "x.safetensors"))
    assert all(_same_bits(again[k], v.contiguous()) for k, v in tensors.items())


def test_reader_maps_the_file_and_copies_nothing(tmp_path):
    S.save_file({"x": torch.arange(6, dtype=torch.float32)}, str(tmp_path / "x.safetensors"))
    a = S.load_file(str(tmp_path / "x.safetensors"))["x"]
    b = S.load_file(str(tmp_path / "x.safetensors"))["x"]
    a += 1  # a private map: neither the file nor another reader sees the write
    assert b.tolist() == [0, 1, 2, 3, 4, 5]
    assert S.load_file(str(tmp_path / "x.safetensors"))["x"].tolist() == [0, 1, 2, 3, 4, 5]
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 16)
    with pytest.raises(ValueError, match="header length"):
        S.load_file(str(tmp_path / "bad.safetensors"))


# ----------------------------------------------------------------------------
# HF configs
# ----------------------------------------------------------------------------

CONFIGS = [
    ("vae", {}),
    ("vae", {"block_out_channels": [8, 16], "norm_num_groups": 4, "latent_channels": 16, "shift_factor": 0.1159,
             "use_quant_conv": False, "mid_block_add_attention": False}),
    ("unet", {}),
    ("unet", {"block_out_channels": [8, 16, 16, 16], "attention_head_dim": [1, 2, 2, 2], "norm_eps": 1e-6}),
    ("unet", {"attention_head_dim": 8, "num_attention_heads": None, "transformer_layers_per_block": 2}),
    ("clip", {}),
    ("clip", {"hidden_size": 768, "num_hidden_layers": 12, "hidden_act": "quick_gelu", "eos_token_id": 2}),
]


@pytest.mark.parametrize("kind,config", CONFIGS, ids=[f"{k}{i}" for i, (k, _) in enumerate(CONFIGS)])
def test_config_readers_match_the_jax_readers(tmp_path, kind, config):
    (tmp_path / "config.json").write_text(json.dumps(config))
    port = getattr(H, f"{kind}_config_from_json")(str(tmp_path))
    ref = getattr(JH, f"{kind}_config_from_json")(str(tmp_path))
    ref = dataclasses.asdict(ref)
    for k, v in dataclasses.asdict(port).items():
        if k in ref:
            assert v == ref[k], (kind, k, v, ref[k])


# ----------------------------------------------------------------------------
# porters
# ----------------------------------------------------------------------------


def test_load_safetensors_dir_reads_the_index_and_a_plain_directory(ckpt, tmp_path):
    root, _ = ckpt
    sharded = P.load_safetensors_dir(str(root / "unet"))
    ref = JP.load_safetensors_dir(str(root / "unet"))
    assert set(sharded) == set(ref) and len(ref) > 100
    for k in ref:
        assert np.array_equal(sharded[k].numpy(), np.asarray(ref[k])), k
    # without an index every *.safetensors file is read, in sorted order
    for name in ("a.safetensors", "b.safetensors"):
        S.save_file({"x": torch.full((2,), float(name == "b.safetensors")), name[0]: torch.ones(1)},
                    str(tmp_path / name))
    plain = P.load_safetensors_dir(str(tmp_path))
    assert sorted(plain) == ["a", "b", "x"] and plain["x"].tolist() == [1.0, 1.0]
    # a file is read as it is
    vae_file = str(root / "vae" / "diffusion_pytorch_model.safetensors")
    assert set(P.load_safetensors_dir(vae_file)) == set(JP.load_safetensors_dir(str(root / "vae")))
    with pytest.raises(FileNotFoundError):
        P.load_safetensors_dir(str(root / "lora"))


def _port_both(root, kind, dtype_t=torch.float32, dtype_j=None):
    import jax.numpy as jnp

    dtype_j = dtype_j or jnp.float32
    if kind == "vae":
        return (P.port_diffusers_vae(str(root / "vae"), T_TINY_VAE, dtype_t, device="cpu"),
                JP.port_diffusers_vae(str(root / "vae"), _jax_config("vae", root), dtype_j))
    if kind == "unet":
        return (P.port_diffusers_unet(str(root / "unet"), T_TINY_UNET, dtype_t, device="cpu"),
                JP.port_diffusers_unet(str(root / "unet"), _jax_config("unet", root), dtype_j))
    if kind == "clip":
        return (P.port_clip_text(str(root / "text_encoder"), CLIPTextConfig(**TINY_CLIP_KW), dtype_t, device="cpu"),
                JP.port_clip_text(str(root / "text_encoder"), JCLIPTextConfig(**TINY_CLIP_KW), dtype_j))
    return (P.port_dinov3_convnext(str(root / "dinov3_convnext.pth"), ConvNeXtConfig(**J_TINY_CONVNEXT_KW), dtype_t,
                                   device="cpu"),
            JP.port_dinov3_convnext(str(root / "dinov3_convnext.pth"), JConvNeXtConfig(**J_TINY_CONVNEXT_KW), dtype_j))


def _jax_config(kind, root):
    return getattr(JH, f"{kind}_config_from_json")(str(root / kind))


@pytest.mark.parametrize("kind", ["vae", "unet", "clip", "convnext"])
def test_porters_match_the_jax_porters(ckpt, kind):
    root, trees = ckpt
    port, ref = _port_both(root, kind)
    assert_trees_equal(port, ref, kind)
    assert_trees_equal(port, trees[kind], kind)  # and both hold what was written
    for path, t in jflatten(port).items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        if t.dim() == 4:
            assert t.is_contiguous(memory_format=torch.channels_last), path
    if kind != "convnext":  # to_hf_state_dict is the porters' inverse: the written file's keys and values
        written = P.load_safetensors_dir(str(root / {"clip": "text_encoder"}.get(kind, kind)))
        for k, v in to_hf_state_dict(port).items():
            assert torch.equal(v, written[k]), k


@pytest.mark.parametrize("kind", ["vae", "clip"])
def test_porters_cast_as_the_jax_porters_do(ckpt, kind):
    import jax.numpy as jnp

    root, _ = ckpt
    port, ref = _port_both(root, kind, torch.bfloat16, jnp.bfloat16)
    ref = jflatten(ref)
    for path, t in jflatten(port).items():
        assert t.dtype == torch.bfloat16
        jkey = path
        if path not in ref:
            jkey = path[:-1] + (("kernel",) if t.dim() in (2, 4) else ("scale",))
        want = torch.from_numpy(np.asarray(ref[jkey]).astype(np.float32)).to(torch.bfloat16)
        if t.dim() == 4:
            want = want.permute(3, 2, 0, 1)
        elif t.dim() == 2 and jkey[-1] == "kernel":
            want = want.t()
        assert torch.equal(t.contiguous(), want.contiguous()), path


def test_validate_against_names_a_missing_key(ckpt, tmp_path):
    root, _ = ckpt
    tensors = P.load_safetensors_dir(str(root / "vae"))
    removed = sorted(tensors)[0]
    del tensors[removed]
    S.save_file(tensors, str(tmp_path / "diffusion_pytorch_model.safetensors"))
    with pytest.raises(ValueError, match="missing") as e:
        P.port_diffusers_vae(str(tmp_path), T_TINY_VAE, device="cpu")
    assert str(tuple(removed.split("."))) in str(e.value)
    # a wrong config names the shapes; validate=False lets the tree through as it is
    with pytest.raises(ValueError, match="wrong_shapes|missing|extra"):
        P.port_diffusers_vae(str(root / "vae"), dataclasses.replace(T_TINY_VAE, latent_channels=8), device="cpu")
    assert "encoder" in P.port_diffusers_vae(str(tmp_path), T_TINY_VAE, validate=False, device="cpu")


# ----------------------------------------------------------------------------
# adapters and their export
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["lora_vae", "lora_unet"])
def test_jax_adapter_loads_in_the_port(ckpt, which):
    root, trees = ckpt
    name = {"lora_vae": "vae_encoder_lora_adapter", "lora_unet": "unet_lora_adapter"}[which]
    tree, meta = A.load_adapter(str(root / "lora" / name), device="cpu")
    assert meta["format"] == "omgsr-tpu" and meta["r"] == 2
    assert_trees_equal(tree, trees[which], what=which)


@pytest.mark.parametrize("which", ["lora_vae", "lora_unet"])
def test_port_adapter_loads_in_the_jax_package(ckpt, tmp_path, which):
    root, trees = ckpt
    name = {"lora_vae": "vae_encoder_lora_adapter", "lora_unet": "unet_lora_adapter"}[which]
    tree, _ = A.load_adapter(str(root / "lora" / name), device="cpu")
    A.save_adapter(tree, str(tmp_path / name), rank=2, targets=("conv1", "to_q"), extra_meta={"note": "x"})
    back, meta = JA.load_adapter(str(tmp_path / name))
    assert meta == {"r": 2, "lora_alpha": 2, "target_modules": ["conv1", "to_q"], "format": "omgsr-tpu", "note": "x"}
    want = jflatten(trees[which])
    got = jflatten(back)
    assert set(got) == set(want)
    for p in want:
        assert np.array_equal(np.asarray(got[p]), want[p]), p
    # the files agree byte for byte with the JAX package's own
    JA.save_adapter(trees[which], str(tmp_path / "jax"), rank=2, targets=("conv1", "to_q"))
    from safetensors.numpy import load_file

    ours, theirs = load_file(str(tmp_path / name / A.WEIGHTS)), load_file(str(tmp_path / "jax" / A.WEIGHTS))
    assert set(ours) == set(theirs) and all(np.array_equal(ours[k], theirs[k]) for k in theirs)


@pytest.mark.parametrize("alpha", [2, 8])
def test_peft_import_matches_the_jax_import(tmp_path, alpha):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(alpha)
    r = 2
    tensors = {
        "base_model.model.mid_block.attentions.0.to_q.lora_A.weight": rng.normal(size=(r, 8)),
        "base_model.model.mid_block.attentions.0.to_q.lora_B.weight": rng.normal(size=(8, r)),
        "base_model.model.down_blocks.0.resnets.0.conv1.lora_A.default.weight": rng.normal(size=(r, 4, 3, 3)),
        "base_model.model.down_blocks.0.resnets.0.conv1.lora_B.default.weight": rng.normal(size=(6, r, 1, 1)),
        "base_model.conv_in.lora_A.weight": rng.normal(size=(r, 3, 3, 3)),
        "base_model.conv_in.lora_B.weight": rng.normal(size=(5, r, 1, 1)),
        "base_model.model.time_embedding.linear_1.base_layer.weight": rng.normal(size=(4, 4)),
    }
    save_file({k: v.astype(np.float32) for k, v in tensors.items()}, str(tmp_path / "adapter_model.safetensors"))
    (tmp_path / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": alpha}))
    tree, meta = A.import_peft_adapter(str(tmp_path), device="cpu")
    ref, ref_meta = JA.import_peft_adapter(str(tmp_path))
    assert meta == ref_meta
    assert_trees_equal(tree, ref, what="peft")
    conv = tree["down_blocks"]["0"]["resnets"]["0"]["conv1"]
    assert conv["lora_A"].shape == (r, 4, 3, 3) and conv["lora_A"].is_contiguous(memory_format=torch.channels_last)


def test_export_adapters_and_pruning_lay_out_the_reference_directories(ckpt, tmp_path):
    root, trees = ckpt
    gen_lora = {"vae_encoder": A.load_adapter(str(root / "lora" / "vae_encoder_lora_adapter"), device="cpu")[0],
                "denoiser": A.load_adapter(str(root / "lora" / "unet_lora_adapter"), device="cpu")[0]}
    cfg = TrainConfig(output_dir=str(tmp_path), vae_lora_rank=2, unet_lora_rank=2)
    names = {"vae_encoder": "vae_encoder_lora_adapter", "denoiser": "unet_lora_adapter"}
    path = CK.export_adapters(str(tmp_path), 7, gen_lora, cfg, names)
    assert path == str(tmp_path / "weight-7")
    assert sorted(p.name for p in (tmp_path / "weight-7").iterdir()) == sorted(names.values())
    for part, name in names.items():
        assert sorted(p.name for p in (tmp_path / "weight-7" / name).iterdir()) == [A.CONFIG, A.WEIGHTS]
        back, meta = JA.load_adapter(str(tmp_path / "weight-7" / name))
        assert meta["r"] == 2 and meta["target_modules"] == list(SD_TARGET_MODULES)
        want = jflatten(trees["lora_vae" if part == "vae_encoder" else "lora_unet"])
        assert all(np.array_equal(np.asarray(v), want[p]) for p, v in jflatten(back).items())
    # -F (ported): FLUX's targets and flux_transformer_lora_rank for the denoiser, the -F names
    f_names = {"vae_encoder": "vae_encoder_adapter", "denoiser": "flux_adapter"}
    f_cfg = dataclasses.replace(cfg, model="omgsr_f_1024", flux_transformer_lora_rank=3)
    CK.export_adapters(str(tmp_path / "f"), 1, gen_lora, f_cfg, f_names)
    metas = {part: JA.load_adapter(str(tmp_path / "f" / "weight-1" / name))[1] for part, name in f_names.items()}
    assert metas["denoiser"]["r"] == 3 and metas["denoiser"]["target_modules"] == list(FLUX_TARGET_MODULES)
    assert metas["vae_encoder"]["r"] == 2 and metas["vae_encoder"]["target_modules"] == list(SD_TARGET_MODULES)

    state = {"step": 0, "x": torch.zeros(2)}
    for step in (5, 10, 15, 20):
        CK.save_train_state(str(tmp_path), state, step)
    CK.keep_last_n_checkpoints(str(tmp_path), None)
    assert CK._checkpoint_steps(str(tmp_path)) == [5, 10, 15, 20]
    CK.keep_last_n_checkpoints(str(tmp_path), 2)
    assert CK._checkpoint_steps(str(tmp_path)) == [15, 20]
    assert CK.latest_checkpoint(str(tmp_path)).endswith("checkpoint-20.pt")
    assert (tmp_path / "weight-7").is_dir()  # adapters are not checkpoints: pruning leaves them
