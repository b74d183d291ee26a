"""The port's multi-process LoRA-GAN training against the JAX package and
against the port's one-process step, on the CPU.

One world of two processes over gloo (``tests/torch_port_train_ranks.py``)
runs every multi-rank case once, and then the port's one-process steps they
are held to, started when the module's fixture is; the JAX reference
compiles here meanwhile (once, at XLA optimisation level 0):

- -S ``{data: 2}``: each rank takes one row of a global batch of 2 and its
  rows of the global noise (the JAX draws replayed into ``StepNoise``); the
  ten metrics equal the JAX ``TrainerS`` step on the whole batch at rtol
  2e-4 / atol 1e-5 (``tests/test_trainer.py``'s data-parallel bound), and
  the LoRA, heads and u after the step the port's one-process step within
  1e-5 in rel L2 (see ``_assert_like_one_process``);
- -S ``{fsdp: 2}`` (the UNet placed, the batch replicated), -F ``{data: 2}``
  and ``{fsdp: 2}`` under per-block recompute, and ``{fsdp: 2}`` on an int8
  DiT: metrics within 1e-5 and state within 1e-5 in rel L2 of the port's
  one-process step (no
  second JAX -F compile: ``test_torch_port_train_f.py`` holds that step
  against the JAX package);
- every world leaves LoRA, heads and u bit for bit equal on both ranks;
- ``shard_params_fsdp``'s split dims on the UNet equal the JAX package's
  ``shard_params_fsdp`` specs leaf by leaf (shapes only), and
  ``build_frozen_s`` places the UNet of a checkpoint directory so that its
  gather is the unplaced tree;
- ``train_omgsr_s.main`` with ``mesh_shape={data: 2}``: rank 0 alone writes,
  and a second run resumes both ranks at the same micro-step and state and
  goes on to step 4;
- refusals: a global batch that does not split over "data", a mesh that
  does not match the world, a mesh with "fsdp" and no process group;
- the loader's shares of each global batch, and ``multiproc_check``'s step
  in the world against its one-process step.
"""

import os
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from omgsr_tpu.config import TrainConfig as JTrainConfig
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.parallel import create_mesh as j_create_mesh
from omgsr_tpu.parallel import shard_params_fsdp as j_shard_params_fsdp
from omgsr_tpu.training.trainer import TrainerS as JTrainerS
from omgsr_tpu_torch.convert.params import to_jax_tree
from omgsr_tpu_torch.data.dataset import PairedLoader, rank_seed
from omgsr_tpu_torch.parallel.sharding import _fsdp_spec, cli_train_mesh
from omgsr_tpu_torch.tools import multiproc_check
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.test_torch_port_trainer import _batch, _bridge_bundle, _jax_bundle, _replay_noise
from tests.torch_port_helpers import J_TINY_CONVNEXT_KW, J_TINY_UNET, bridge, jax_once, write_tiny_checkpoint
from tests.torch_port_ranks import join_world
from tests.torch_port_train_ranks import METRICS, S_KW, numpy_tree, spawn_world

JAX_RTOL, JAX_ATOL = 2e-4, 1e-5  # tests/test_trainer.py:267-270, the 8-way data-parallel step
ONE_PROCESS_TOL = 1e-5
WORLD_TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def world():
    """Rank 0's results of the world of two (with the port's one-process
    references), the JAX step's metrics, and what the CLI left on disk."""
    frozen, lora, disc = _jax_bundle()
    tfrozen, tlora, tdisc = _bridge_bundle(frozen, lora, disc)
    batch = _batch(10)
    key = jax.random.key(20)
    noise = _replay_noise(key, batch["hq"].shape, (2, 32, 32, 4))
    with tempfile.TemporaryDirectory() as d:
        out_dir, root = os.path.join(d, "out"), os.path.join(d, "ckpt")
        os.makedirs(out_dir)
        cfg = {"sd_path": root, "output_dir": os.path.join(d, "run"), "dinov3_convnext_size": "micro",
               "dinov3_weights_path": os.path.join(root, "dinov3_convnext.pth"),
               "fixed_prompt_path": os.path.join(root, "prompt.npz"), "dataset_txt_or_dir_paths": [
                   os.path.join(d, "imgs")], "mixed_precision": "no", "resolution": 64, "vae_lora_rank": 2,
               "unet_lora_rank": 2, "train_batch_size": 2, "gradient_accumulation_steps": 2, "max_train_steps": 2,
               "lr_warmup_steps": 0, "checkpointing_steps": 1, "save_img_steps": 1,
               "metrics_jsonl": os.path.join(d, "metrics.jsonl")}
        cfg_path = os.path.join(d, "cfg.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        # numpy, not tensors: a spawned process receives a tensor through a shared-memory file of its own
        payload = {"s": numpy_tree((tfrozen, tlora, tdisc, batch, noise)), "cli": (cfg_path, J_TINY_CONVNEXT_KW)}
        write_tiny_checkpoint(pathlib.Path(root))
        os.makedirs(cfg["dataset_txt_or_dir_paths"][0])
        rng = np.random.default_rng(4)
        for name, (h, w) in {"a.png": (96, 80), "b.png": (64, 120), "c.png": (70, 70), "d.png": (90, 90)}.items():
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(cfg["dataset_txt_or_dir_paths"][0], name))
        procs = spawn_world(2, payload, out_dir)
        try:
            jtr = JTrainerS(JTrainConfig(**S_KW), frozen, lora, disc)
            _, (jmetrics, _) = jax_once(jtr._train_step, jtr.state, {k: jnp.asarray(v) for k, v in batch.items()},
                                        key, jtr._frozen_arrays)
            res = join_world(2, procs, out_dir, WORLD_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
        files = {name: sorted(os.listdir(os.path.join(cfg["output_dir"], name)))
                 for name in ("checkpoints", "weight-4")}
        files["run"] = sorted(os.listdir(cfg["output_dir"]))
        with open(cfg["metrics_jsonl"]) as f:
            files["metrics steps"] = [yaml.safe_load(line)["step"] for line in f]
        saved = torch.load(os.path.join(cfg["output_dir"], "checkpoints", "checkpoint-2.pt"), weights_only=True)
        leaves = [v for v in flatten_dict(saved).values() if isinstance(v, torch.Tensor)]
        files["checkpoint-2 digest"] = float(sum(v.double().abs().sum() for v in leaves))
    return res, {k: float(v) for k, v in jmetrics.items()}, files


def _assert_like_one_process(res, tag, ref):
    """The ten metrics within ONE_PROCESS_TOL (relative, absolute below 1)
    and each of LoRA, heads and u after the step within ONE_PROCESS_TOL in
    rel L2 of the one-process step's; bit for bit the same on both ranks.
    The state is held in L2 because Adam's first update is lr * g / (|g| +
    eps) entry by entry: where |g| is near eps, a gradient that differs in
    its last f32 bits moves that entry by a visible share of lr."""
    for k, v, want in zip(METRICS, res[f"{tag} metrics"], res[f"ref {ref} metrics"]):
        assert abs(v - want) <= ONE_PROCESS_TOL * max(abs(want), 1.0), (tag, k, v, want)
    for what in ("lora", "heads", "u"):
        keys = [k for k in res if k.startswith(f"ref {ref} {what} ")]
        assert keys, (tag, what)
        want = np.concatenate([res[k].reshape(-1) for k in keys])
        got = np.concatenate([res[tag + k[len(f"ref {ref}"):]].reshape(-1) for k in keys])
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= ONE_PROCESS_TOL, (tag, what, rel)
    assert res[f"{tag} same on both ranks"].all(), (tag, res[f"{tag} same on both ranks"])


def test_s_data_parallel_step_matches_jax_and_the_one_process_step(world):
    res, jmetrics, _ = world
    for k, v in zip(METRICS, res["s data metrics"]):
        assert abs(v - jmetrics[k]) <= JAX_ATOL + JAX_RTOL * abs(jmetrics[k]), (k, v, jmetrics[k])
    _assert_like_one_process(res, "s data", "s")


def test_s_fsdp_step_matches_the_one_process_step(world):
    res, _, _ = world
    _assert_like_one_process(res, "s fsdp", "s")
    n_placed, n_leaves, same = res["checkpoint UNet placed"]
    assert 0 < n_placed < n_leaves and same, res["checkpoint UNet placed"]


@pytest.mark.parametrize("tag,ref", [("f data", "f"), ("f fsdp", "f"), ("f fsdp int8", "f int8")])
def test_f_worlds_match_the_one_process_step(world, tag, ref):
    res, _, _ = world
    _assert_like_one_process(res, tag, ref)


@pytest.mark.parametrize("fsdp,min_size", [(2, 64), (4, 1024)])
def test_fsdp_split_dims_of_the_unet_equal_the_jax_specs(fsdp, min_size):
    """Shapes only: each leaf's split dim of the tiny UNet, carried to the JAX
    layout by ``to_jax_tree`` (a leaf that counts up along its split dim),
    is the dim the JAX package's ``shard_params_fsdp`` names on an {fsdp: N}
    mesh, ties between equal in and out dims included."""
    shapes = jax.eval_shape(lambda k: JU.init_unet(k, J_TINY_UNET), jax.random.key(0))
    jspecs = j_shard_params_fsdp(shapes, j_create_mesh({"fsdp": fsdp}, devices=jax.devices()[:fsdp]),
                                 min_size=min_size)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = bridge(zeros)

    def marked(t):
        spec = _fsdp_spec(t.shape, fsdp, min_size)
        if "fsdp" not in spec:
            return torch.zeros_like(t)
        d = spec.index("fsdp")
        idx = [1] * t.dim()
        idx[d] = t.shape[d]
        return torch.arange(1, t.shape[d] + 1, dtype=torch.float32).reshape(idx).expand(t.shape).clone()

    got = flatten_dict(to_jax_tree(jax.tree.map(marked, port)))
    want = flatten_dict(jax.tree.map(lambda s: tuple(s.spec), jspecs))
    assert set(got) == set(want)
    n_split = 0
    for path, spec in want.items():
        a = got[path]
        dims = [i for i in range(a.ndim) if a.shape[i] > 1 and np.ptp(a, axis=i).max() > 0]
        want_dims = [i for i, s in enumerate(spec) if s == "fsdp"]
        assert dims == want_dims, (".".join(path), a.shape, spec)
        n_split += bool(want_dims)
    assert n_split > 0


def test_cli_on_a_world_writes_on_rank_0_and_resumes_both_ranks(world):
    res, _, files = world
    assert int(res["cli first run micro-step"]) == 4 and int(res["cli second run micro-step"]) == 8
    writes = res["cli writes"].reshape(-1)
    assert writes[0] > 0 and writes[1] == 0, writes  # only rank 0 wrote
    restored = res["cli restored"]  # (micro-step, digest) of each rank after the restore
    assert str(res["cli restored path"]) == "checkpoint-2.pt"
    assert (restored[:, 0] == 4).all() and restored[0, 1] == restored[1, 1], restored
    assert abs(restored[0, 1] - files["checkpoint-2 digest"]) <= 1e-9 * files["checkpoint-2 digest"]
    assert bool(res["cli lora same on both ranks"])
    assert files["checkpoints"] == [f"checkpoint-{i}.pt" for i in (1, 2, 3, 4)]
    assert files["weight-4"] == ["unet_lora_adapter", "vae_encoder_lora_adapter"]
    assert files["metrics steps"] == [1, 2, 3, 4]
    assert {"cfg.yml", "img-1.jpg", "img-4.jpg"} <= set(files["run"])


def test_refusals(world, capsys):
    res, _, _ = world
    assert "does not match" in str(res["mesh refused"])
    assert "train_batch_size" in str(res["cli refused batch"])
    # no process group here: "fsdp" refuses, "data" trains unsharded with the JAX CLIs' message. A test module
    # that ran before this one in the same process may have left a one-rank gloo group behind (the reference
    # fixtures of tests/test_ssl_losses.py, test_ssl_meta_arch.py and test_eval_probes.py form one and keep it)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match="fsdp"):
        cli_train_mesh({"fsdp": 2}, "cpu")
    assert cli_train_mesh({"data": 2}, "cpu") is None
    assert "only one device visible — running unsharded" in capsys.readouterr().out
    assert cli_train_mesh(None, "cpu") is None


class _Indices:
    """A dataset whose item is its index."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return np.full((1,), i)


def test_loader_shares_make_up_the_global_batch():
    whole = PairedLoader(_Indices(), 4, seed=7, device="cpu")
    shares = [PairedLoader(_Indices(), 4, seed=7, device="cpu", rank=r, world=2) for r in range(2)]
    assert len(whole) == len(shares[0]) == len(shares[1]) == 2
    order = [b["hq"].reshape(-1).tolist() for b in whole]
    parts = [[b["hq"].reshape(-1).tolist() for b in loader] for loader in shares]
    for i, batch in enumerate(order):
        assert parts[0][i] + parts[1][i] == batch and not set(parts[0][i]) & set(parts[1][i])
    with pytest.raises(ValueError, match="train_batch_size"):
        PairedLoader(_Indices(), 3, device="cpu", rank=0, world=2)
    # rank 0 draws with the seed itself, so one process crops and degrades as before
    assert rank_seed(7, 0) == 7 and len({rank_seed(7, r) for r in range(4)}) == 4


def test_multiproc_check_step_matches_in_the_world(world):
    """multiproc_check's step on the world's {data: 2} mesh against its
    one-process step, by the tool's own comparison (``main`` runs the same
    two on a world of its own)."""
    import json

    res, _, _ = world
    single, multi = (json.loads(str(res[k])) for k in ("multiproc_check one process", "multiproc_check world"))
    assert multiproc_check.compare(single, multi) == []

