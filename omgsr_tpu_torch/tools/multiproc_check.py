"""Multi-process check of the data-parallel train step.

    python -m omgsr_tpu_torch.tools.multiproc_check [--nprocs 2] [--device cuda|cpu]

Starts ``--nprocs`` OS processes that form a process group through the
production bootstrap (``parallel.distributed.initialize``), each of which
builds the same tiny OMGSR-S trainer from seeds on a ``{"data": N}`` mesh
(``parallel.create_mesh``) and takes one step on its rows of a global batch
of N images (``data_rows``, ``step_noise_rows``). This process takes the
same step alone on the whole batch. The ten metrics and a LoRA fingerprint
(the sum of the absolute values of every leaf after the step) must agree at
rtol 2e-3: the gradient mean of N halves differs from the gradient of the
whole batch only in the order of its f32 sums. Exits 0 on a match, 1 on a
mismatch; a rank that fails ends the world within the group's timeout.

``--device cuda`` (the default; it raises without a card) runs every step
on the GPU through the port's kernels, in f32 with TF32 off: NCCL with one
card a rank where there are ``--nprocs`` cards, else gloo with every rank on
card 0. ``--device cpu`` runs gloo processes on the host, where the kernels
take their plain versions. Every attention site has head dim 64, which the
flash-attention kernels take.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import sys
import tempfile
import traceback

import numpy as np
import torch

from omgsr_tpu_torch.utils.devices import resolve_device

RES = 64
RTOL = 2e-3
TIMEOUT_S = 120.0
METRICS = ("loss_total_G", "loss_total_D", "loss_LRR", "loss_Dv3D", "loss_L1", "loss_G", "loss_D_fake",
           "loss_D_real", "grad_norm_G", "grad_norm_D")


def tiny_trainer(device, mesh=None):
    """A tiny OMGSR-S trainer drawn from fixed seeds (the same on every
    process), f32 on ``device``."""
    from omgsr_tpu_torch.config import TrainConfig
    from omgsr_tpu_torch.convert.params import init_convnext, init_discriminator, init_unet, init_vae
    from omgsr_tpu_torch.lora import SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.losses.dists import init_dists
    from omgsr_tpu_torch.models.configs import ConvNeXtConfig, UNetConfig, VAEConfig
    from omgsr_tpu_torch.training.trainer import TrainerS

    # one head of 64 channels in the VAE's mid block and in both UNet attention blocks
    vae_cfg = VAEConfig(block_out_channels=(32, 64), norm_num_groups=4, latent_channels=4, layers_per_block=1)
    unet_cfg = UNetConfig(block_out_channels=(64, 64), num_attention_heads=(1, 1), cross_attention_dim=16,
                          norm_num_groups=4, layers_per_block=1,
                          down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                          up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
    cn_cfg = ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))
    backbone = init_convnext(2, cn_cfg, torch.float32, device)
    vae, unet = init_vae(0, vae_cfg, torch.float32, device), init_unet(1, unet_cfg, torch.float32, device)
    frozen = {"vae": vae, "vae_cfg": vae_cfg, "unet": unet, "unet_cfg": unet_cfg, "backbone": backbone,
              "dists": init_dists(backbone, cn_cfg.dims),
              "prompt_embeds": torch.from_numpy(np.random.default_rng(3).standard_normal((1, 7, 16)).astype(
                  np.float32)).to(device)}
    gen = torch.Generator(device=device).manual_seed(4)
    lora = {"vae_encoder": init_lora_tree(gen, vae["encoder"], SD_TARGET_MODULES, 2),
            "denoiser": init_lora_tree(gen, unet, SD_TARGET_MODULES, 2)}
    disc = init_discriminator(gen, cn_cfg.dims[:3], RES, torch.float32, device, configs=[([0.5], [1])] * 3)
    cfg = TrainConfig(gradient_accumulation_steps=1, lr_warmup_steps=0, learning_rate=1e-3)
    return TrainerS(cfg, frozen, lora, disc, mesh)


def global_inputs(n: int, device):
    """The global batch of ``n`` 64-px pairs and its noise, on ``device``."""
    from omgsr_tpu_torch.training.trainer import draw_step_noise

    rng = np.random.default_rng(10)
    batch = {k: torch.from_numpy(np.tanh(rng.standard_normal((n, RES, RES, 3))).astype(np.float32)).to(device)
             for k in ("lq", "hq")}
    noise = draw_step_noise(torch.Generator(device=device).manual_seed(5), (n, RES, RES, 3),
                            (n, RES // 2, RES // 2, 4), device, torch.float32)
    return batch, noise


def fingerprint(trainer, metrics) -> dict:
    from omgsr_tpu_torch.utils.tree import flatten_dict

    leaves = flatten_dict(trainer.state["gen"]["lora"]).values()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "lora_abs_sum": float(sum(v.detach().double().abs().sum() for v in leaves)), "lora_n": len(leaves)}


def step(n: int, device, mesh=None) -> dict:
    """One step of the tiny trainer on the global batch of ``n`` on
    ``device``: this rank's rows on a mesh, the whole batch without one."""
    from omgsr_tpu_torch.parallel.sharding import data_rows
    from omgsr_tpu_torch.training.trainer import step_noise_rows

    trainer = tiny_trainer(device, mesh)
    batch, noise = global_inputs(n, device)
    start, count = data_rows(n, mesh)
    metrics, _ = trainer.train_step({k: v[start:start + count] for k, v in batch.items()},
                                    step_noise_rows(noise, start, count))
    return fingerprint(trainer, metrics)


def rank_device(device: str, rank: int, world: int) -> tuple[str, str | None]:
    """(this rank's device, the backend): the host over gloo; card ``rank``
    over NCCL where there is a card a rank; card 0 over gloo otherwise."""
    if device == "cpu":
        return "cpu", None
    if torch.cuda.device_count() >= world:
        return f"cuda:{rank}", None
    return "cuda:0", "gloo"


def f32_exact():
    """f32 products and convolutions in f32 (no TF32), as on the host."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def run_rank(rank: int, world: int, port: int, out_dir: str, device: str):
    """One rank: the production bootstrap, the step on its rows; rank 0
    writes the fingerprint, a failing rank its traceback."""
    from omgsr_tpu_torch.parallel import create_mesh, distributed

    torch.set_num_threads(1)
    try:
        dev, backend = rank_device(device, rank, world)
        if device == "cuda":
            f32_exact()
        distributed.initialize(f"127.0.0.1:{port}", world, rank, device=dev, backend=backend, timeout_s=TIMEOUT_S)
        out = step(world, dev, create_mesh({"data": world}))
        if rank == 0:
            with open(os.path.join(out_dir, "world.json"), "w") as f:
                json.dump(out, f)
        distributed.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def compare(single: dict, multi: dict) -> list[str]:
    """The mismatches between two fingerprints at RTOL (empty on a match)."""
    bad = [] if single["lora_n"] == multi["lora_n"] else [f"lora_n {single['lora_n']} vs {multi['lora_n']}"]
    for k in METRICS:
        if not np.isclose(multi["metrics"][k], single["metrics"][k], rtol=RTOL, atol=0.0):
            bad.append(f"{k}: one process {single['metrics'][k]} vs the world {multi['metrics'][k]}")
    if not np.isclose(multi["lora_abs_sum"], single["lora_abs_sum"], rtol=RTOL, atol=0.0):
        bad.append(f"lora_abs_sum: one process {single['lora_abs_sum']} vs the world {multi['lora_abs_sum']}")
    return bad


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    n = args.nprocs
    if resolve_device(args.device).type == "cuda":
        f32_exact()
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=run_rank, args=(r, n, port, out_dir, args.device), daemon=True)
                 for r in range(n)]
        for proc in procs:
            proc.start()
        single = step(n, rank_device(args.device, 0, n)[0])  # the one-process step, while the world runs
        for proc in procs:
            proc.join(TIMEOUT_S)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        errs = "".join(open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                       if f.endswith(".err"))
        codes = [proc.exitcode for proc in procs]
        if any(codes) or errs:
            print(f"the world of {n} failed: exit codes {codes}\n{errs}", file=sys.stderr)
            return 1
        with open(os.path.join(out_dir, "world.json")) as f:
            multi = json.load(f)
    bad = compare(single, multi)
    for line in bad:
        print(f"MISMATCH {line}")
    print(json.dumps({"nprocs": n, "device": args.device, "match": not bad, "single": single, "multi": multi}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
