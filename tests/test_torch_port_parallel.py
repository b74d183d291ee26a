"""The port's multi-GPU serving paths against the JAX package on the CPU.

Placement: the port's FSDP and TP rules (``parallel/sharding.placement_spec``)
against ``omgsr_tpu.parallel.shard_params_fsdp`` / ``shard_params_flux_tp``
leaf by leaf, on a FLUX tree in the port's layout (float, int8, w8a8, int4),
no process spawned.

Ranks: one world of two processes over gloo (``tests/torch_port_ranks.py``)
runs every case once, and one world of one process runs the same code on a
group of one rank; both start when the module does and run while the JAX
references compile here. Each case is held against the JAX function on a
2-device mesh of the 8 virtual CPU devices (``tests/conftest.py``) and
against the port's unsharded run:

- -S ``tiles``: the tiled UNet's ``latent_mid`` over 15 tiles (odd, so one
  padded tile);
- -F ``tiles``, ``fsdp``, ``tp``, and ``tp`` on the int8, w8a8 and int4 trees:
  ``latent_mid`` over 9 tiles of a DiT at head dim 128 with 2 heads, so the
  int4 scales are group-wise (g = 128) and split on whole groups; ``tp`` on a
  mesh of two axes, {"tp": 2, "fsdp": 1}, whose other leaves take the fsdp
  rule over groups of one rank; a mesh that does not match the world refused;
- the single block's row-parallel ``proj_out`` on the w8a8 tree, one shared
  input: the per-token scale is the maximum over the ranks and the int32
  products are summed before the scales;
- ``sharded_vae_encode`` / ``sharded_vae_decode`` of the tiny SD VAE;
- a 2-rank ``serve --shard tiles`` answers over HTTP as a 1-rank one does,
  across a ``/v1/reload`` broadcast to every rank; then rank 1's dispatch
  raises on one request, and rank 0 answers it with 502 at once;
- on two ranks every leaf that ``fsdp`` or ``tp`` splits holds storage of
  its own size, not a view that keeps the whole leaf alive;
- a 2-rank ``infer_omgsr_s --shard tiles`` on a tiny checkpoint: rank 0 alone
  writes, the images of the 1-rank run.

Tolerances: MODEL_TOL (1e-4, as tests/test_torch_port_flux.py holds the f32
DiT, tests/test_torch_port_quantize.py the quantised one and
tests/test_torch_port_tiled_vae.py the VAE); on one rank the DiT and UNet
strategies give the unsharded numbers bit for bit (the same products in the
same order), the VAE within MODEL_TOL (its mid-attention GroupNorm goes
through the K3 pair on the band).

The w8a8 DiT: on this input the unsharded port already differs from the JAX
package by 7.2e-4 at 33 of 4096 outputs, where one activation code lands on
a .5 tie in one package and rounds the other way (the divergence
tests/test_torch_port_quantize.py describes), while the JAX package's
sharded and unsharded runs agree bit for bit. So the sharded w8a8 DiT is held
to the JAX function plus the port's unsharded deviation, within MODEL_TOL,
and the w8a8 row-parallel product to the JAX function on a shared input.
"""

import io
import os
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from omgsr_tpu.inference import tiled_vae as JTV
from omgsr_tpu.inference.pipeline_f import OMGSRFPipeline as JFPipeline
from omgsr_tpu.inference.pipeline_s import OMGSRSPipeline as JSPipeline
from omgsr_tpu.models import flux as JF
from omgsr_tpu.models import layers as JL
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu.models.configs import FluxConfig as JFluxConfig
from omgsr_tpu.parallel import create_mesh as j_create_mesh
from omgsr_tpu.parallel import shard_params_flux_tp, shard_params_fsdp
from omgsr_tpu_torch.convert.params import to_jax_tree
from omgsr_tpu_torch.models.configs import FluxConfig
from omgsr_tpu_torch.parallel.sharding import placement_spec
from omgsr_tpu_torch.utils.quantize import quantize_flux_for_serving
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import (
    J_TINY_UNET,
    J_TINY_VAE,
    T_TINY_UNET,
    T_TINY_VAE,
    assert_close,
    bridge,
    jax_init,
    jax_once,
    tiny_flux_configs,
    write_tiny_checkpoint,
)
from tests.torch_port_ranks import join_world, spawn_world, unsharded_cases

MODEL_TOL = 1e-4
# every rank of both worlds within this many seconds, the JAX references included
WORLD_TIMEOUT_S = 180.0

_TP_FLUX = dict(num_layers=1, num_single_layers=1, attention_head_dim=128, num_attention_heads=2,
                joint_attention_dim=16, pooled_projection_dim=8, axes_dims_rope=(16, 56, 56))
J_FLUX, T_FLUX = JFluxConfig(**_TP_FLUX), FluxConfig(**_TP_FLUX)
J_FVAE, T_FVAE = tiny_flux_configs()[:2]
MODES = {"int8": dict(bits=8), "int8_w8a8": dict(act_quant=True), "int4": dict(bits=4)}
CLI_INPUTS = {"a.png": (20, 16), "b.png": (18, 12)}  # (W, H)
DIT_CASES = ["f tiles", "f fsdp", "f tp"] + [f"f tp {m}" for m in MODES] + ["f tp fsdp"]
CASES = ["s tiles"] + DIT_CASES + ["w8a8 row product", "vae encode", "vae decode"]
# held to the JAX function as it is; the w8a8 DiT in its own test (see above)
JAX_CASES = [c for c in CASES if c != "f tp int8_w8a8"]
# the JAX mesh of each case
J_MESH = {"s tiles": {"data": 2}, "f tiles": {"data": 2}, "f fsdp": {"fsdp": 2}, "vae encode": {"data": 2},
          "vae decode": {"data": 2}, **{f"f tp{m}": {"tp": 2} for m in ["", *[" " + m for m in MODES]]}}


def _mode(case):
    """The tree of a DiT case: "float" or a quantisation mode."""
    return next((m for m in MODES if case.endswith(m)), "float")


def _quantized(tree, mode):
    """The port's quantised tree (codes equal the JAX quantiser's,
    tests/test_torch_port_quantize.py) in the JAX layout."""
    return to_jax_tree(quantize_flux_for_serving(tree, min_params=64, device="cpu", **MODES[mode]))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(7)
    # written by the spawned fixture once the ranks have started
    ckpt, images = tmp_path_factory.mktemp("tiny_sd"), tmp_path_factory.mktemp("cli_inputs")
    s_vae, s_unet = jax_init(JV.init_vae, 0, J_TINY_VAE), jax_init(JU.init_unet, 1, J_TINY_UNET)
    f_vae, flux = jax_init(JV.init_vae, 2, J_FVAE), jax_init(JF.init_flux, 3, J_FLUX)
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    trees = {"float": np_tree(flux)}
    trees.update({m: _quantized(bridge(flux), m) for m in MODES})
    png = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(png, format="PNG")
    return {
        "s": (np_tree(s_vae), np_tree(s_unet), T_TINY_VAE, T_TINY_UNET,
              rng.standard_normal((1, 16, 24, 4)).astype(np.float32),  # 3 x 5 tiles of 8
              rng.standard_normal((1, 7, 16)).astype(np.float32)),
        "f": (np_tree(f_vae), trees, T_FVAE, T_FLUX, rng.standard_normal((1, 16, 16, 16)).astype(np.float32),
              rng.standard_normal((1, 5, 16)).astype(np.float32), rng.standard_normal((1, 8)).astype(np.float32)),
        "vae": (np_tree(s_vae), T_TINY_VAE, rng.uniform(-1, 1, (1, 32, 24, 3)).astype(np.float32),
                rng.standard_normal((1, 16, 12, 4)).astype(np.float32)),
        "serve": (np_tree(s_vae), np_tree(s_unet), T_TINY_VAE, T_TINY_UNET,
                  rng.standard_normal((1, 7, 16)).astype(np.float32), png.getvalue()),
        # the input of the single block's proj_out: attention (256) then MLP (1024) columns
        "w8a8": (rng.standard_normal((1, 21, 1280)).astype(np.float32),),
        "cli": (str(ckpt), str(images), str(tmp_path_factory.mktemp("cli_outputs"))),
    }


@pytest.fixture(scope="module")
def spawned(inputs):
    """Both worlds, started before the JAX references are computed; the CLI
    case's checkpoint and images are written while they run."""
    import multiprocessing

    out_dir = tempfile.mkdtemp(prefix="omgsr_ranks_")
    cli_ready = multiprocessing.get_context("spawn").Event()
    procs = {world: spawn_world(world, inputs, out_dir, cli_ready) for world in (2, 1)}
    ckpt, images, _ = inputs["cli"]
    write_tiny_checkpoint(pathlib.Path(ckpt))
    rng = np.random.default_rng(8)
    for name, (w, h) in CLI_INPUTS.items():  # served at 4x in the 64 x 128 bucket: 105 latent tiles of 8
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(os.path.join(images, name))
    cli_ready.set()
    return out_dir, procs


@pytest.fixture(scope="module")
def jax_refs(inputs, spawned):
    """Each case's JAX function on a mesh of 2 of the virtual devices."""
    devices = jax.devices()[:2]
    refs = {}
    vae, unet, _, _, z, prompt = inputs["s"]
    jpipe = JSPipeline(vae, unet, J_TINY_VAE, J_TINY_UNET)
    jpipe.shard_for_mesh(j_create_mesh(J_MESH["s tiles"], devices))
    refs["s tiles"] = jax_once(lambda z_, p: jpipe._latent_mid(jpipe.unet_params, z_, p, tile_size=8, tile_overlap=4),
                               z, prompt)
    fvae, trees, _, _, fz, ctx, pooled = inputs["f"]
    for case in DIT_CASES[:-1]:
        strategy = case.split()[1]
        tree = jax.tree.map(jnp.asarray, trees[_mode(case)])
        jpipe = JFPipeline(fvae, tree, J_FVAE, J_FLUX)
        jpipe.shard_for_mesh(j_create_mesh(J_MESH[case], devices), strategy=strategy, min_size=64)
        refs[case] = jax_once(lambda z_, c, p, jp=jpipe: jp._latent_mid(jp.flux_params, z_, c, p, tile_size=8,
                                                                        tile_overlap=4), fz, ctx, pooled)
    refs["f tp fsdp"] = refs["f tp"]  # an "fsdp" axis of one rank changes no number of the JAX function
    jpipe = JFPipeline(fvae, jax.tree.map(jnp.asarray, trees["int8_w8a8"]), J_FVAE, J_FLUX)
    refs["f int8_w8a8 unsharded"] = jax_once(
        lambda z_, c, p: jpipe._latent_mid(jpipe.flux_params, z_, c, p, tile_size=8, tile_overlap=4), fz, ctx, pooled)
    tree = jax.tree.map(jnp.asarray, trees["int8_w8a8"])
    tree = jax.device_put(tree, shard_params_flux_tp(tree, j_create_mesh({"tp": 2}, devices), 64))
    proj_out = tree["single_transformer_blocks"]["0"]["proj_out"]
    refs["w8a8 row product"] = jax_once(lambda x_: JL.dense(proj_out, x_), *inputs["w8a8"])
    vae, _, x, zl = inputs["vae"]
    mesh = j_create_mesh(J_MESH["vae encode"], devices)
    refs["vae encode"] = JTV.sharded_vae_encode(vae, J_TINY_VAE, jnp.asarray(x), mesh)
    refs["vae decode"] = JTV.sharded_vae_decode(vae, J_TINY_VAE, jnp.asarray(zl), mesh)
    return {k: np.asarray(v) for k, v in refs.items()}


@pytest.fixture(scope="module")
def port_refs(inputs):
    """Each case unsharded in the port (this process, no process group)."""
    return unsharded_cases(inputs)


@pytest.fixture(scope="module")
def worlds(spawned, jax_refs):
    out_dir, procs = spawned
    return {world: join_world(world, p, out_dir, WORLD_TIMEOUT_S) for world, p in procs.items()}


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_ranks_match_the_jax_package(worlds, jax_refs, case):
    assert_close(worlds[2][case], jax_refs[case], MODEL_TOL, case)


def test_two_ranks_w8a8_dit_deviates_from_jax_only_as_unsharded(worlds, jax_refs, port_refs):
    """The w8a8 DiT under tp on two ranks: the JAX package's output under tp
    plus the unsharded port's deviation from the unsharded JAX package."""
    case = "f tp int8_w8a8"
    own = port_refs[case] - jax_refs["f int8_w8a8 unsharded"]
    assert_close(worlds[2][case], jax_refs[case] + own, MODEL_TOL, case)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_match_the_unsharded_port(worlds, port_refs, case):
    assert_close(worlds[2][case], port_refs[case], MODEL_TOL, case)


@pytest.mark.parametrize("case", CASES)
def test_one_rank_runs_the_sharded_code_as_the_unsharded_port(worlds, case):
    """Against the unsharded run in the same process (CPU products depend on
    the thread count)."""
    ref = worlds[1][f"unsharded {case}"]
    if case.startswith("vae"):
        assert_close(worlds[1][case], ref, MODEL_TOL, case)
    else:
        np.testing.assert_array_equal(worlds[1][case], ref, err_msg=case)


def test_a_mesh_that_does_not_match_the_world_is_refused(worlds):
    assert int(worlds[2]["mesh refused"]) == int(worlds[1]["mesh refused"]) == 1


def test_two_rank_serve_answers_as_one_rank_does(worlds):
    """Both worlds served the same request before and after a /v1/reload of
    the mid-timestep that rank 0 broadcast; within one uint8 step (the UNet
    ran other tile batches), and the reload changed the output."""
    for key in ("serve_before", "serve_after"):
        a, b = worlds[2][key].astype(int), worlds[1][key].astype(int)
        assert a.shape == b.shape == (64, 64, 3), (key, a.shape, b.shape)
        assert np.abs(a - b).max() <= 1, key
    before, after = worlds[2]["serve_before"].astype(int), worlds[2]["serve_after"].astype(int)
    assert np.abs(before - after).mean() > 0.5
    assert int(worlds[2]["serve_world"]) == 2  # rank 0 answered both requests


@pytest.mark.parametrize("case", DIT_CASES[1:])
def test_two_ranks_keep_only_their_part_of_each_split_leaf(worlds, case):
    split, views = worlds[2][f"{case} split leaves, views"]
    assert split > 0 and views == 0, (case, split, views)


def test_a_failure_on_rank_1_is_a_502_on_rank_0_at_once(worlds):
    """Rank 1's dispatch raised before the tiles' all-gather that rank 0 was
    waiting in: rank 0 answered 502 well within the group's 60 s timeout, as
    it did the next request, /healthz names the failure, and rank 0's
    dispatcher left the all-gather once rank 1 had gone."""
    res = worlds[2]
    assert float(res["serve_failure_s"]) < 10.0, float(res["serve_failure_s"])
    assert str(res["serve_failure_health"]).startswith("failed: rank 1: RuntimeError: injected failure"), \
        str(res["serve_failure_health"])
    assert bool(res["serve_dispatcher_ended"])


def test_two_rank_cli_writes_on_rank_0_only(inputs, worlds):
    """Both ranks ran every image; rank 0 wrote them, within one uint8 step
    of the 1-rank run's, and rank 1 wrote nothing."""
    out_root = inputs["cli"][2]
    names = sorted(k for k in worlds[2] if k.startswith("cli "))
    assert names == sorted(k for k in worlds[1] if k.startswith("cli ")) == [f"cli {n}" for n in sorted(CLI_INPUTS)]
    for name in names:
        a, b = worlds[2][name].astype(int), worlds[1][name].astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
    assert not os.path.exists(os.path.join(out_root, "world2_rank1"))


# ----------------------------------------------------------------------------
# placement rules, leaf by leaf against the JAX package's
# ----------------------------------------------------------------------------


def _jax_leaf(name, ndim):
    if name == "weight":
        return "kernel" if ndim >= 2 else "scale"
    return name.replace("weight", "kernel") if name.startswith("weight_") else name


@pytest.fixture(scope="module")
def placement_trees():
    flux = bridge(jax_init(JF.init_flux, 3, J_FLUX))
    trees = {"bf16": {k: v.bfloat16() for k, v in flatten_dict(flux).items()}}
    for mode in MODES:
        trees[mode] = flatten_dict(quantize_flux_for_serving(flux, min_params=64, device="cpu", **MODES[mode]))
    return trees


@pytest.mark.parametrize("strategy,shape", [("fsdp", {"fsdp": 8}), ("fsdp", {"data": 2, "fsdp": 4}),
                                            ("tp", {"tp": 2}), ("tp", {"tp": 2, "fsdp": 4})])
@pytest.mark.parametrize("mode", ["bf16", *MODES])
def test_placement_matches_jax(placement_trees, mode, strategy, shape):
    """The spec of every leaf in the port's layout is the JAX spec of the same
    leaf in its layout, a rank-2 leaf's spec reversed with the leaf."""
    flat = placement_trees[mode]
    jax_tree = {}
    for path, leaf in flat.items():
        node = jax_tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[_jax_leaf(path[-1], leaf.dim())] = jax.ShapeDtypeStruct(tuple(reversed(leaf.shape)) if leaf.dim() == 2
                                                                    else tuple(leaf.shape), jnp.float32)
    mesh = j_create_mesh(shape, jax.devices()[: int(np.prod(list(shape.values())))])
    min_size = 4096  # some leaves of the small tree above it and some below
    jspecs = (shard_params_flux_tp(jax_tree, mesh, min_size) if strategy == "tp"
              else shard_params_fsdp(jax_tree, mesh, min_size))
    jflat = flatten_dict(jax.tree.map(lambda s: tuple(s.spec), jspecs, is_leaf=lambda s: hasattr(s, "spec")))
    split = 0
    for path, leaf in flat.items():
        want = jflat[path[:-1] + (_jax_leaf(path[-1], leaf.dim()),)]
        want = tuple(reversed(want)) if leaf.dim() == 2 and want else want
        got = placement_spec(path, tuple(leaf.shape), strategy == "tp", shape.get("fsdp"), min_size)
        assert got == want, (path, tuple(leaf.shape), got, want)
        split += bool(got)
    assert split > 20, split
