"""The spawned ranks of tests/test_torch_port_train_dist.py: one world of two
processes over gloo on the CPU runs every multi-rank training case of the
port (imports torch and the port only). ``spawn_world`` starts the ranks;
``torch_port_ranks.join_world`` waits for them and reads rank 0's results.

Each case builds its trainer on every rank from the same inputs, takes one
step on its rows (``parallel.sharding.data_rows``), and rank 0 keeps the
metrics and the state after the step; ``same on both ranks`` entries say
whether the two ranks' LoRA, heads and spectral-norm u are equal bit for bit
after the step (every rank applies the same averaged update). Once the
worlds are done the ranks also take the one-process steps they are held to
(``ref`` entries), while the parent compiles the JAX reference."""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import traceback

import numpy as np
import torch

from omgsr_tpu_torch.tools import multiproc_check
from tests.torch_port_ranks import COLLECTIVE_TIMEOUT_S, free_port

METRICS = ("loss_total_G", "loss_total_D", "loss_LRR", "loss_Dv3D", "loss_L1", "loss_G", "loss_D_fake",
           "loss_D_real", "grad_norm_G", "grad_norm_D")
S_KW = dict(mid_timestep=273, gradient_accumulation_steps=1, lr_warmup_steps=0, learning_rate=1e-3)
F_KW = dict(model="omgsr_f_1024", mid_timestep=244, gradient_accumulation_steps=1, lr_warmup_steps=0,
            learning_rate=1e-3, gradient_checkpointing=True)
F_RES, F_BATCH = 64, 2
MIN_SIZE = 64  # the tiny models' leaves hold 100s to 10,000s of elements, below the default 2**18


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def numpy_tree(tree):
    """Tensors -> numpy arrays (strides kept) through dicts, tuples and
    named tuples; ``torch_tree`` is the inverse."""
    return _map(tree, lambda t: t.numpy() if isinstance(t, torch.Tensor) else t)


def torch_tree(tree):
    return _map(tree, lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map(v, fn) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree)


def f_bundle():
    """The tiny -F frozen bundle, LoRA and discriminator from the port's
    initialisers and seeds (the same on every process), f32 on the CPU: one
    dual and one single block at head dim 64, so both attention sites go
    through the flash-attention autograd function."""
    from omgsr_tpu_torch.convert.params import init_convnext, init_discriminator, init_flux, init_vae
    from omgsr_tpu_torch.lora import FLUX_TARGET_MODULES, SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.losses.dists import init_dists
    from omgsr_tpu_torch.models.configs import ConvNeXtConfig, FluxConfig, VAEConfig

    vae_cfg = VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, latent_channels=16, layers_per_block=1,
                        scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False, use_post_quant_conv=False)
    flux_cfg = FluxConfig(num_layers=1, num_single_layers=1, attention_head_dim=64, num_attention_heads=2,
                          joint_attention_dim=16, pooled_projection_dim=8, axes_dims_rope=(8, 28, 28))
    cn_cfg = ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))
    bp = init_convnext(2, cn_cfg, torch.float32, "cpu")
    vae, flux = init_vae(0, vae_cfg, torch.float32, "cpu"), init_flux(1, flux_cfg, torch.float32, "cpu")
    rng = np.random.default_rng(3)
    frozen = {"vae": vae, "vae_cfg": vae_cfg, "flux": flux, "flux_cfg": flux_cfg, "backbone": bp,
              "dists": init_dists(bp, cn_cfg.dims),
              "prompt_embeds": torch.from_numpy(rng.standard_normal((1, 5, 16)).astype(np.float32)),
              "pooled_prompt_embeds": torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))}
    gen = torch.Generator().manual_seed(4)
    lora = {"vae_encoder": init_lora_tree(gen, vae["encoder"], SD_TARGET_MODULES, 2),
            "denoiser": init_lora_tree(gen, flux, FLUX_TARGET_MODULES, 2)}
    disc = init_discriminator(gen, cn_cfg.dims[:3], F_RES, torch.float32, "cpu", configs=[([0.5], [1])] * 3)
    return frozen, lora, disc


def f_inputs():
    """The global -F batch and its noise."""
    from omgsr_tpu_torch.training.trainer import draw_step_noise

    rng = np.random.default_rng(20)
    batch = {k: torch.from_numpy(np.tanh(rng.standard_normal((F_BATCH, F_RES, F_RES, 3))).astype(np.float32))
             for k in ("lq", "hq")}
    noise = draw_step_noise(torch.Generator().manual_seed(21), (F_BATCH, F_RES, F_RES, 3),
                            (F_BATCH, F_RES // 2, F_RES // 2, 16), "cpu", torch.float32)
    return batch, noise


def quantized(frozen):
    """``frozen`` with the DiT quantised to int8 (the port's codes, as the
    JAX package's __graft_entry__ places an int8 base)."""
    from omgsr_tpu_torch.utils.quantize import quantize_flux_for_serving

    return {**frozen, "flux": quantize_flux_for_serving(frozen["flux"], min_params=MIN_SIZE, device="cpu")}


def step(trainer_cls, kw, bundle, batch, noise, mesh=None, key=None):
    """One step of a fresh trainer on this rank's rows; ``key`` ("unet" or
    "flux") is placed by FSDP on a mesh with "fsdp". Returns (metrics, the
    trainer)."""
    from omgsr_tpu_torch.config import TrainConfig
    from omgsr_tpu_torch.parallel.sharding import data_rows, shard_params_fsdp, uses_fsdp
    from omgsr_tpu_torch.training.trainer import step_noise_rows

    frozen, lora, disc = bundle
    frozen = dict(frozen)
    if uses_fsdp(mesh):
        frozen[key] = shard_params_fsdp(frozen[key], mesh, min_size=MIN_SIZE)
    trainer = trainer_cls(TrainConfig(**kw), frozen, clone_tree(lora), (clone_tree(disc[0]), clone_tree(disc[1]),
                                                                       disc[2]), mesh)
    start, count = data_rows(batch["hq"].shape[0], mesh)
    metrics, _ = trainer.train_step({k: v[start:start + count] for k, v in batch.items()},
                                    step_noise_rows(noise, start, count))
    return metrics, trainer


def state_arrays(trainer, tag) -> dict:
    """The metrics and the state after a step, as numpy arrays keyed
    ``"{tag} lora|heads|u <path>"``."""
    from omgsr_tpu_torch.utils.tree import flatten_dict

    out = {}
    for what, tree in (("lora", trainer.state["gen"]["lora"]), ("heads", trainer.state["disc"]["params"]),
                       ("u", trainer.state["disc"]["sn"])):
        out.update({f"{tag} {what} {'.'.join(p)}": v.detach().numpy() for p, v in flatten_dict(tree).items()})
    return out


def same_on_all_ranks(tree) -> bool:
    """Whether every rank holds ``tree`` bit for bit (one all-gather)."""
    from omgsr_tpu_torch.parallel.distributed import all_gather
    from omgsr_tpu_torch.utils.tree import flatten_dict

    flat = torch.cat([v.detach().reshape(-1).float() for v in flatten_dict(tree).values()])
    parts = all_gather(flat, None)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _record(res, tag, metrics, trainer):
    res[f"{tag} metrics"] = np.asarray([float(metrics[k]) for k in METRICS])
    res.update(state_arrays(trainer, tag))
    res[f"{tag} same on both ranks"] = np.asarray(
        [same_on_all_ranks(trainer.state["gen"]["lora"]), same_on_all_ranks(trainer.state["disc"]["params"]),
         same_on_all_ranks(trainer.state["disc"]["sn"])])


def _cli(world, payload, res):
    """train_omgsr_s.main on mesh {data: 2} (the micro ConvNeXt size set by
    ``run_cases``): two optimizer steps, then a second run that resumes from
    the latest checkpoint and goes on to step 4.
    Every file write of the CLI is counted per rank; the state each rank
    restores is reduced to its micro-step and a digest."""
    import omgsr_tpu_torch.convert.params as P
    from omgsr_tpu_torch.cli import train_omgsr_s as TCLI
    from omgsr_tpu_torch.parallel.distributed import all_gather
    from omgsr_tpu_torch.training import checkpoint as CK
    from omgsr_tpu_torch.utils.tree import flatten_dict

    cfg_path, _ = payload["cli"]
    saved = {(P, "init_discriminator"): P.init_discriminator, (CK, "restore_train_state"): CK.restore_train_state,
             **{(m, n): getattr(m, n) for m, n in ((TCLI, "save_config"), (TCLI, "save_triptych"),
                                                   (TCLI, "append_metrics_jsonl"), (CK, "save_train_state"),
                                                   (CK, "export_adapters"))}}
    real_init = P.init_discriminator
    P.init_discriminator = lambda seed, ch, res_, dtype, device: real_init(seed, ch, res_, dtype, device,
                                                                          configs=[([0.5], [1])] * 3)
    writes = []

    def counted(real, name):
        def call(*a, **k):
            writes.append(name)
            return real(*a, **k)

        return call

    for module, name in list(saved)[2:]:
        setattr(module, name, counted(saved[module, name], name))
    restored = []
    real_restore = CK.restore_train_state

    def restore(path, state):
        state = real_restore(path, state)
        leaves = [v for v in flatten_dict(state).values() if isinstance(v, torch.Tensor)]
        restored.append((path, state["step"], float(sum(v.detach().double().abs().sum() for v in leaves))))
        return state

    CK.restore_train_state = restore
    try:
        tr = TCLI.main(["--config", cfg_path, "--device", "cpu", "mesh_shape={data: 2}"])
        res["cli first run micro-step"] = np.asarray(tr.state["step"])
        tr = TCLI.main(["--config", cfg_path, "--device", "cpu", "mesh_shape={data: 2}",
                        "resume_from_checkpoint=latest", "max_train_steps=4"])
        res["cli second run micro-step"] = np.asarray(tr.state["step"])
        try:  # a global batch that does not split over "data"
            TCLI.main(["--config", cfg_path, "--device", "cpu", "mesh_shape={data: 2}", "train_batch_size=3"])
        except ValueError as e:
            res["cli refused batch"] = np.asarray(str(e))
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    (path, micro, digest), = restored
    res["cli restored"] = torch.stack(all_gather(torch.tensor([micro, digest], dtype=torch.float64), None)).numpy()
    res["cli restored path"] = np.asarray(os.path.basename(path))
    res["cli writes"] = torch.stack(all_gather(torch.tensor([len(writes)]), None)).numpy()
    res["cli lora same on both ranks"] = np.asarray(same_on_all_ranks(tr.state["gen"]["lora"]))


def one_process_refs(world, payload) -> dict:
    """The one-process steps the worlds are held to, once the worlds are
    done, spread over the ranks without a collective between them (rank 0:
    -S and the multiproc_check step; rank 1: -F float and int8), then
    gathered; rank 0's dict holds them all."""
    import torch.distributed as dist

    from omgsr_tpu_torch.training.trainer import TrainerF, TrainerS

    out = {}
    if dist.get_rank() == 0:
        tfrozen, tlora, tdisc, batch, noise = torch_tree(payload["s"])
        m, tr = step(TrainerS, S_KW, (tfrozen, tlora, tdisc), batch, noise)
        out.update(_refs("s", m, tr))
        out["multiproc_check one process"] = np.asarray(json.dumps(multiproc_check.step(world, "cpu")))
    if dist.get_rank() == world - 1:
        fb = f_bundle()
        fbatch, fnoise = f_inputs()
        for name, bundle in (("f", fb), ("f int8", (quantized(fb[0]),) + fb[1:])):
            m, tr = step(TrainerF, F_KW, bundle, fbatch, fnoise)
            out.update(_refs(name, m, tr))
    parts = [None] * world
    dist.all_gather_object(parts, out)
    return {k: v for part in parts for k, v in part.items()}


def _refs(tag, metrics, trainer):
    return {f"ref {tag} metrics": np.asarray([float(metrics[k]) for k in METRICS]),
            **{f"ref {k}": v for k, v in state_arrays(trainer, tag).items()}}


def run_cases(world, payload) -> dict:
    from omgsr_tpu_torch.cli import train_omgsr_s as TCLI
    from omgsr_tpu_torch.parallel import sharding as S
    from omgsr_tpu_torch.parallel.sharding import create_mesh, gather_tree
    from omgsr_tpu_torch.training.trainer import TrainerF, TrainerS
    from omgsr_tpu_torch.utils.tree import flatten_dict

    res = {}
    tfrozen, tlora, tdisc, batch, noise = torch_tree(payload["s"])
    for tag, shape in (("s data", {"data": world}), ("s fsdp", {"fsdp": world})):
        metrics, trainer = step(TrainerS, S_KW, (tfrozen, tlora, tdisc), batch, noise, create_mesh(shape), "unet")
        _record(res, tag, metrics, trainer)

    res["multiproc_check world"] = np.asarray(json.dumps(multiproc_check.step(world, "cpu", create_mesh({"data": world}))))

    fb = f_bundle()
    fbatch, fnoise = f_inputs()
    for tag, shape, bundle in (("f data", {"data": world}, fb), ("f fsdp", {"fsdp": world}, fb),
                               ("f fsdp int8", {"fsdp": world}, (quantized(fb[0]),) + fb[1:])):
        metrics, trainer = step(TrainerF, F_KW, bundle, fbatch, fnoise, create_mesh(shape), "flux")
        _record(res, tag, metrics, trainer)

    # the frozen UNet of a checkpoint directory, ported by build_frozen_s and placed by place_frozen:
    # chunks, gathered whole
    from omgsr_tpu_torch.config import load_config
    from omgsr_tpu_torch.models import configs as CFG

    cfg_path, micro_kw = payload["cli"]
    CFG.CONVNEXT_SIZES["micro"] = CFG.ConvNeXtConfig(**micro_kw)
    cfg = load_config(cfg_path)
    real_place = S.shard_params_fsdp  # the tiny UNet's leaves are below the default min_size
    S.shard_params_fsdp = lambda *a, **k: real_place(*a, **{**k, "min_size": MIN_SIZE})
    try:
        fsdp_mesh = create_mesh({"fsdp": world})
        placed, _ = TCLI.build_frozen_s(cfg, torch.float32, "cpu", fsdp_mesh)
        TCLI.place_frozen(placed, "unet", fsdp_mesh, "cpu")
    finally:
        S.shard_params_fsdp = real_place
    whole, _ = TCLI.build_frozen_s(cfg, torch.float32, "cpu")
    got, want = flatten_dict(gather_tree(placed["unet"])), flatten_dict(whole["unet"])
    res["checkpoint UNet placed"] = np.asarray([
        sum(type(v).__name__ == "FSDPLeaf" for v in flatten_dict(placed["unet"]).values()), len(want),
        int(set(got) == set(want) and all(torch.equal(got[p], want[p]) for p in want))])

    try:
        create_mesh({"data": world + 1})
    except ValueError as e:
        res["mesh refused"] = np.asarray(str(e))
    _cli(world, payload, res)
    res.update(one_process_refs(world, payload))
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in res.items()}


def run_rank(rank, world, port, out_dir):
    from omgsr_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # the parent compiles the JAX reference meanwhile
    try:
        distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
        with open(os.path.join(out_dir, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        res = run_cases(world, payload)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"world{world}.npz"), **res)
        distributed.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"world{world}.rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(world, payload, out_dir):
    """Start the ranks of one world (``torch_port_ranks.join_world`` waits).
    ``payload`` (numpy and plain values, ``numpy_tree``) goes through a file
    in ``out_dir``: through the start pipe, a payload larger than its buffer
    holds the parent until each child has started and read it."""
    with open(os.path.join(out_dir, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=run_rank, args=(r, world, port, out_dir), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs
