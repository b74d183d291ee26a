"""The port's -S CLIs from a checkpoint directory on disk, against the JAX
package's on the same directory: infer_omgsr_s (PNGs within 1 uint8 step,
fp32, with adapters and batches of 2), serve --sd_path (one HTTP request
answered with the CLI's image), build_frozen_s (the same trees), and
train_omgsr_s.main from a config file: without images it names the dataset
option; with a folder of images it trains two optimizer steps."""

import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.cli import infer_omgsr_s as JCLI
from omgsr_tpu.cli import train_omgsr_s as JTRAIN
from omgsr_tpu.config import TrainConfig as JTrainConfig
from omgsr_tpu.inference.pipeline_s import OMGSRSPipeline as JPipeline
from omgsr_tpu.models import configs as JCFG
from omgsr_tpu_torch.cli import infer_omgsr_s as CLI
from omgsr_tpu_torch.cli import serve
from omgsr_tpu_torch.cli import train_omgsr_s as TRAIN
from omgsr_tpu_torch.config import TrainConfig
from omgsr_tpu_torch.convert.params import to_jax_tree
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
from omgsr_tpu_torch.models import configs as CFG
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import J_TINY_CONVNEXT_KW, write_tiny_checkpoint

# a 20x16 input becomes a 64x80 one, reflect-padded to the 64 px size bucket (64x128, a 32x64 latent in
# 105 tiles of 8): two of them make one batch of 2
INPUTS = {name: (20, 16) for name in ("a.png", "b.png")}
COMMON = ["--process_size", "64", "--upscale", "4", "--align_method", "wavelet", "--weight_dtype", "fp32"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_sd")
    trees = write_tiny_checkpoint(root)
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name, (w, h) in INPUTS.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(imgs / name)
    return root, trees


@pytest.fixture(scope="module")
def cli_outputs(ckpt, tmp_path_factory):
    """Both CLIs on the same directory, each with its pipeline call patched to
    take the posterior mean of the latent (both CLIs sample it, from their own
    noise)."""
    root, _ = ckpt
    out = tmp_path_factory.mktemp("out")
    args = ["--input_image", str(root / "imgs"), "--sd_path", str(root), "--lora_path", str(root / "lora"),
            "--prompt_npz", str(root / "prompt.npz"), "--batch_size", "2", *COMMON]
    call = JPipeline.__call__
    JPipeline.__call__ = lambda self, *a, **k: call(self, *a, **{**k, "sample_latent": False})
    jax.config.update("jax_disable_most_optimizations", True)  # compile time, not the sums, is what drops
    try:
        JCLI.main(JCLI.parse_args(args + ["--output_dir", str(out / "jax")]))
    finally:
        JPipeline.__call__ = call
        jax.config.update("jax_disable_most_optimizations", False)
    calls = []
    port_call = OMGSRSPipeline.__call__

    def spy(self, lq, *a, **k):
        calls.append(tuple(lq.shape))
        return port_call(self, lq, *a, **{**k, "sample_latent": False})

    OMGSRSPipeline.__call__ = spy
    try:
        avg = CLI.main(CLI.parse_args(args + ["--output_dir", str(out / "port"), "--device", "cpu"]))
    finally:
        OMGSRSPipeline.__call__ = port_call
    return out, calls, avg


def test_infer_cli_matches_the_jax_cli(cli_outputs):
    out, calls, avg = cli_outputs
    assert calls == [(2, 64, 128, 3)], calls
    assert avg > 0
    for name, (w, h) in INPUTS.items():
        ours = np.asarray(Image.open(out / "port" / name))
        ref = np.asarray(Image.open(out / "jax" / name))
        assert ours.shape == ref.shape == (4 * h, 4 * w, 3), name
        assert ours.std() > 1.0, name
        d = np.abs(ours.astype(int) - ref.astype(int))
        assert d.max() <= 1, (name, d.max(), d.mean())


def test_serve_from_sd_path_answers_with_the_cli_image(ckpt, cli_outputs):
    root, _ = ckpt
    out, _, _ = cli_outputs
    args = serve.parse_args(["--sd_path", str(root), "--lora_path", str(root / "lora"), "--prompt_npz",
                             str(root / "prompt.npz"), "--device", "cpu", "--latent", "mean", "--port", "0",
                             *COMMON])
    server, httpd = serve.main(args, serve_forever=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        host, port = httpd.server_address[:2]
        body = (root / "imgs" / "a.png").read_bytes()  # the server applies the CLI's resize protocol
        req = urllib.request.Request(f"http://{host}:{port}/v1/sr?align=wavelet", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        httpd.shutdown()
        server.shutdown()
    ref = np.asarray(Image.open(out / "port" / "a.png"))
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.fixture
def micro_convnext(monkeypatch):
    """A ConvNeXt size the dinov3_convnext.pth of the tiny checkpoint has, in both packages."""
    monkeypatch.setitem(JCFG.CONVNEXT_SIZES, "micro", JCFG.ConvNeXtConfig(**J_TINY_CONVNEXT_KW))
    monkeypatch.setitem(CFG.CONVNEXT_SIZES, "micro", CFG.ConvNeXtConfig(**J_TINY_CONVNEXT_KW))


def test_build_frozen_s_matches_the_jax_one(ckpt, micro_convnext):
    root, trees = ckpt
    kw = dict(sd_path=str(root), dinov3_convnext_size="micro",
              extra={"dinov3_weights_path": str(root / "dinov3_convnext.pth")})
    frozen, cn_cfg = TRAIN.build_frozen_s(TrainConfig(**kw), torch.float32, device="cpu")
    ref, ref_cn = JTRAIN.build_frozen_s(JTrainConfig(**kw), jnp.float32)
    assert tuple(cn_cfg.dims) == tuple(ref_cn.dims)
    assert frozen["dists"]["channels"] == ref["dists"]["channels"] == [3, 8, 8, 8]
    for key in ("vae_cfg", "unet_cfg"):
        assert {k: v for k, v in vars(frozen[key]).items() if k != "fused_resblocks"} == \
            {k: v for k, v in vars(ref[key]).items() if k in vars(frozen[key]) and k != "fused_resblocks"}
    for key in ("vae", "unet", "backbone"):
        got, want = flatten_dict(to_jax_tree(frozen[key])), flatten_dict(jax.tree.map(np.asarray, ref[key]))
        assert set(got) == set(want), key
        assert all(np.array_equal(got[p], want[p]) for p in want), key
    assert frozen["dists"]["backbone"] is frozen["backbone"]
    # bf16: the written f32 weights after the cast
    bf16, _ = TRAIN.build_frozen_s(TrainConfig(**kw), torch.bfloat16, device="cpu")
    for p, t in flatten_dict(bf16["unet"]).items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, flatten_dict(frozen["unet"])[p].to(torch.bfloat16)), p
    # without weights the backbone comes from a seed, with the structure of the published one less its final norm
    seeded, _ = TRAIN.build_frozen_s(TrainConfig(**{**kw, "extra": {}}), torch.float32, device="cpu")
    shapes = {p: tuple(v.shape) for p, v in flatten_dict(seeded["backbone"]).items()}
    assert shapes == {p: tuple(v.shape) for p, v in flatten_dict(frozen["backbone"]).items() if p[0] != "norm"}


def test_train_main_reads_sd_path_and_stops_at_the_loader(ckpt, micro_convnext, tmp_path):
    root, _ = ckpt
    out = tmp_path / "run"
    cfg = {"sd_path": str(root), "output_dir": str(out), "dinov3_convnext_size": "micro",
           "dinov3_weights_path": str(root / "dinov3_convnext.pth"), "fixed_prompt": "a photo",
           "mixed_precision": "no", "resolution": 64, "vae_lora_rank": 2, "unet_lora_rank": 2}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    seen = {}
    real = TRAIN.encode_fixed_prompt

    def spy(*a, **k):
        seen["prompt"] = real(*a, **k)
        return seen["prompt"]

    TRAIN.encode_fixed_prompt = spy
    try:
        # no images: the loader would yield no batch, and the dataset option is named
        with pytest.raises(ValueError, match="dataset_txt_or_dir_paths"):
            TRAIN.main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu", "seed=5"])
    finally:
        TRAIN.encode_fixed_prompt = real
    assert seen["prompt"].shape == (1, 77, 16) and torch.isfinite(seen["prompt"]).all()
    assert os.path.exists(out / "cfg.yml")
    from omgsr_tpu_torch.config import load_config

    assert load_config(str(out / "cfg.yml")).seed == 5
    with pytest.raises(RuntimeError, match="cuda"):
        TRAIN.main(["--config", str(tmp_path / "cfg.json")])
    # the prompt from a .npz, as the reference's fixed_prompt_path
    npz = TRAIN.encode_fixed_prompt(TrainConfig(fixed_prompt_path=str(root / "prompt.npz")), torch.float32, "cpu")
    assert npz.shape == (1, 7, 16)


def test_train_main_trains_from_a_folder_of_images(ckpt, micro_convnext, tmp_path, monkeypatch):
    """Two optimizer steps (accumulation 2) from a YAML config, the tiny
    checkpoint and four images of other sizes and formats, on the CPU: the
    Real-ESRGAN pairs come from the loader, the metrics are finite, the
    checkpoint and the adapters are written."""
    import yaml

    import omgsr_tpu_torch.convert.params as P

    # discriminator heads of one stride-1 conv each: the published ones need the 512-px feature maps
    real_init = P.init_discriminator
    monkeypatch.setattr(P, "init_discriminator", lambda seed, ch, res, dtype, device: real_init(
        seed, ch, res, dtype, device, configs=[([0.5], [1])] * 3))
    root, _ = ckpt
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(4)
    for name, (h, w) in {"a.png": (96, 80), "b.jpg": (64, 120), "c.png": (48, 70), "d.jpeg": (90, 90)}.items():
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(imgs / name)
    out = tmp_path / "run"
    cfg = {"sd_path": str(root), "output_dir": str(out), "dinov3_convnext_size": "micro",
           "dinov3_weights_path": str(root / "dinov3_convnext.pth"), "fixed_prompt_path": str(root / "prompt.npz"),
           "dataset_txt_or_dir_paths": [str(imgs)], "mixed_precision": "no", "resolution": 64,
           "vae_lora_rank": 2, "unet_lora_rank": 2, "train_batch_size": 1, "gradient_accumulation_steps": 2,
           "max_train_steps": 2, "lr_warmup_steps": 0, "checkpointing_steps": 1000, "save_img_steps": 1,
           "metrics_jsonl": str(tmp_path / "metrics.jsonl")}
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    seen = []
    from omgsr_tpu_torch.training import trainer as TT

    real = TT.TrainerS.train_step

    def spy(self, batch, noise):
        seen.append({k: v.clone() for k, v in batch.items()})
        return real(self, batch, noise)

    TT.TrainerS.train_step = spy
    try:
        TRAIN.main(["--config", str(tmp_path / "cfg.yml"), "--device", "cpu"])
    finally:
        TT.TrainerS.train_step = real
    assert len(seen) == 4
    for b in seen:
        assert b["hq"].shape == b["lq"].shape == (1, 64, 64, 3) and b["hq"].dtype == torch.float32
        assert b["lq"].min() >= -1 and b["lq"].max() <= 1 and not torch.equal(b["lq"], b["hq"])
    lines = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [1, 2]
    assert all(np.isfinite(v) for line in lines for v in line.values())
    assert sorted(os.listdir(out / "weight-2")) == ["unet_lora_adapter", "vae_encoder_lora_adapter"]
    assert (out / "checkpoints" / "checkpoint-2.pt").exists() and (out / "img-2.jpg").exists()
