"""The spawned ranks of tests/test_torch_port_parallel.py: one world of
processes over gloo on the CPU runs every multi-rank case of the port
(imports torch and the port only, so a rank starts in about two seconds).

``spawn_world(world, payload, out_dir, cli_ready)`` starts ``world``
processes, each of which forms the process group with a finite timeout, runs
``run_cases`` and leaves; rank 0 writes the results to
``out_dir/world{world}.npz``. A rank that fails writes its traceback beside
it, and a world that does not end within ``timeout_s`` is killed."""

from __future__ import annotations

import io
import json
import multiprocessing
import os
import socket
import threading
import traceback
import urllib.error
import urllib.request

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 60.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, body, expect=200):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=COLLECTIVE_TIMEOUT_S) as r:
            code, data = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, data = e.code, e.read()
    assert code == expect, (url, code, data[:300])
    return data


def _png(h, w, seed):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


FAILING_PNG_HW = (16, 32)  # served at 64 x 128: the request whose dispatch raises on the last rank of a world of two


def _fail_on_last_rank():
    """Make the infer functions of this rank's server raise on a FAILING_PNG_HW
    request (before any collective: the other ranks wait in the tiles'
    all-gather)."""
    from omgsr_tpu_torch.cli import serve

    make = serve._make_infer_fn

    def failing(*a, **k):
        def wrap(fn):
            def call(lq, *rest):
                if lq.shape[2] == 4 * FAILING_PNG_HW[1]:
                    raise RuntimeError("injected failure")
                return fn(lq, *rest)

            return None if fn is None else call

        return tuple(wrap(fn) for fn in make(*a, **k))

    serve._make_infer_fn = failing


def _serve(world, payload, res):
    """serve --shard tiles with in-memory -S parameters: one request, a
    /v1/reload of the mid-timestep (broadcast to every rank), a refused
    reload, one request again. Rank 0 answers over HTTP. In a world of two
    the last rank's dispatch then raises on one request: rank 0 answers it
    and the next one with 502 at once, /healthz names the failure, and its
    dispatcher leaves the all-gather once that rank has left."""
    import time

    import torch.distributed as dist
    from PIL import Image

    from omgsr_tpu_torch.cli import serve
    from omgsr_tpu_torch.convert.params import from_jax_tree

    vae, unet, vc, uc, prompt, png = payload["serve"]
    args = serve.parse_args(["--device", "cpu", "--weight_dtype", "fp32", "--process_size", "64", "--upscale", "4",
                             "--align_method", "adain", "--latent", "mean", "--port", "0", "--shard", "tiles"])
    params = (from_jax_tree(vae, device="cpu"), from_jax_tree(unet, device="cpu"))
    if world > 1 and dist.get_rank() == world - 1:
        _fail_on_last_rank()
    server, httpd = serve.main(args, serve_forever=False, params=params, configs=(vc, uc), prompt_embeds=prompt)
    if httpd is None:  # a follower: it returned when rank 0 shut down, or when its dispatch raised
        return
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % httpd.server_address[:2]
    try:
        res["serve_before"] = np.asarray(Image.open(io.BytesIO(_post(f"{base}/v1/sr", png))))
        reply = json.loads(_post(f"{base}/v1/reload", json.dumps({"mid_timestep": 300}).encode()))
        assert reply == {"status": "reloaded", "mid_timestep": 300}, reply
        _post(f"{base}/v1/reload", json.dumps({"sd_path": "/x"}).encode(), expect=400)
        res["serve_after"] = np.asarray(Image.open(io.BytesIO(_post(f"{base}/v1/sr", png))))
        res["serve_world"] = np.asarray(server.metrics()["requests"])
        if world > 1:
            t0 = time.monotonic()
            first = json.loads(_post(f"{base}/v1/sr", _png(*FAILING_PNG_HW, seed=1), expect=502))
            res["serve_failure_s"] = np.asarray(time.monotonic() - t0)
            assert "injected failure" in first["error"], first
            _post(f"{base}/v1/sr", png, expect=502)
            with urllib.request.urlopen(f"{base}/healthz", timeout=COLLECTIVE_TIMEOUT_S) as r:
                res["serve_failure_health"] = np.asarray(json.loads(r.read())["status"])
    finally:
        server.shutdown()
    if world > 1:  # the dispatcher is free once the failed rank's process has gone
        server._dispatcher.join(COLLECTIVE_TIMEOUT_S)
        res["serve_dispatcher_ended"] = np.asarray(not server._dispatcher.is_alive())


def _cli(world, payload, res, cli_ready):
    """infer_omgsr_s --shard tiles on a tiny checkpoint, once the parent has
    written it (``cli_ready``): every rank runs each image, rank 0 alone
    writes (into ``world{N}_rank{r}`` of the output root)."""
    from PIL import Image

    import torch.distributed as dist

    from omgsr_tpu_torch.cli import infer_omgsr_s

    ckpt, images, out_root = payload["cli"]
    if not cli_ready.wait(COLLECTIVE_TIMEOUT_S):
        raise TimeoutError("the tiny checkpoint was not written in time")
    out = os.path.join(out_root, f"world{world}_rank{dist.get_rank()}")
    infer_omgsr_s.main(infer_omgsr_s.parse_args(
        ["--input_image", images, "--output_dir", out, "--sd_path", ckpt, "--lora_path", os.path.join(ckpt, "lora"),
         "--prompt_npz", os.path.join(ckpt, "prompt.npz"), "--device", "cpu", "--weight_dtype", "fp32",
         "--process_size", "64", "--shard", "tiles"]))
    if dist.get_rank() == 0:
        for name in sorted(os.listdir(out)):
            res[f"cli {name}"] = np.asarray(Image.open(os.path.join(out, name)))


def unsharded_cases(payload) -> dict:
    """Every case of ``run_cases`` (but serving and the CLI) through the
    unsharded port, as numpy arrays."""
    from omgsr_tpu_torch.convert.params import from_jax_tree
    from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.models import vae as V
    from omgsr_tpu_torch.models.layers import dense

    refs = {}
    with torch.inference_mode():
        vae, unet, vc, uc, z, prompt = payload["s"]
        pipe = OMGSRSPipeline(from_jax_tree(vae, device="cpu"), from_jax_tree(unet, device="cpu"), vc, uc,
                              device="cpu")
        refs["s tiles"] = pipe.latent_mid(torch.from_numpy(z), torch.from_numpy(prompt), 8, 4)
        fvae, trees, fvc, fc, fz, ctx, pooled = payload["f"]
        fvae = from_jax_tree(fvae, device="cpu")
        for case, mode in _dit_cases(trees):
            pipe = OMGSRFPipeline(fvae, from_jax_tree(trees[mode], device="cpu"), fvc, fc, device="cpu")
            refs[case] = pipe.latent_mid(torch.from_numpy(fz), torch.from_numpy(ctx), torch.from_numpy(pooled), 8, 4)
        proj_out = from_jax_tree(trees["int8_w8a8"], device="cpu")["single_transformer_blocks"]["0"]["proj_out"]
        refs["w8a8 row product"] = dense(proj_out, torch.from_numpy(payload["w8a8"][0]))
        vae, vcfg, x, zl = payload["vae"]
        vae = from_jax_tree(vae, device="cpu")
        refs["vae encode"] = V.vae_encode(vae, vcfg, torch.from_numpy(x), sample=False)
        refs["vae decode"] = V.vae_decode(vae, vcfg, torch.from_numpy(zl))
    return {k: v.numpy() for k, v in refs.items()}


def _dit_cases(trees):
    """(case, tree) of each -F case."""
    return ([("f tiles", "float"), ("f fsdp", "float"), ("f tp", "float")]
            + [(f"f tp {mode}", mode) for mode in trees if mode != "float"] + [("f tp fsdp", "float")])


def _views_of_split_leaves(placed, whole) -> tuple[int, int]:
    """(split leaves, split leaves that are views into a larger storage) of a
    placed tree against the tree it was placed from."""
    from omgsr_tpu_torch.parallel.sharding import FSDPLeaf

    split = views = 0
    for k, v in placed.items():
        if isinstance(v, dict):
            s, n = _views_of_split_leaves(v, whole[k])
            split, views = split + s, views + n
            continue
        t = v.local if isinstance(v, FSDPLeaf) else v
        if t.shape != whole[k].shape:
            split += 1
            views += t.untyped_storage().nbytes() != t.numel() * t.element_size()
    return split, views


def run_cases(world, payload, cli_ready) -> dict:
    """Every case on every rank; returns rank 0's outputs as numpy arrays."""
    from omgsr_tpu_torch.convert.params import from_jax_tree
    from omgsr_tpu_torch.inference import tiled_vae
    from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.models.layers import dense
    from omgsr_tpu_torch.parallel import create_mesh
    from omgsr_tpu_torch.parallel.sharding import _tp_slice, shard_flux_params

    res = {}
    with torch.inference_mode():
        vae, unet, vc, uc, z, prompt = payload["s"]
        pipe = OMGSRSPipeline(from_jax_tree(vae, device="cpu"), from_jax_tree(unet, device="cpu"), vc, uc,
                              device="cpu").shard_for_mesh(create_mesh({"data": world}))
        res["s tiles"] = pipe.latent_mid(torch.from_numpy(z), torch.from_numpy(prompt), 8, 4)

        fvae, trees, fvc, fc, fz, ctx, pooled = payload["f"]
        fvae = from_jax_tree(fvae, device="cpu")
        ports = {mode: from_jax_tree(tree, device="cpu") for mode, tree in trees.items()}
        # "f tp fsdp" on two axes: the "fsdp" axis of one rank each is a group per rank, formed collectively
        meshes = {"f tiles": {"data": world}, "f fsdp": {"fsdp": world}, "f tp fsdp": {"tp": world, "fsdp": 1}}
        for name, mode in _dit_cases(trees):
            strategy, shape = name.split()[1], meshes.get(name, {"tp": world})
            pipe = OMGSRFPipeline(fvae, ports[mode], fvc, fc, device="cpu")
            pipe.shard_for_mesh(create_mesh(shape), strategy, min_size=64)
            if strategy != "tiles":
                res[f"{name} split leaves, views"] = np.asarray(_views_of_split_leaves(pipe.flux_params, ports[mode]))
            res[name] = pipe.latent_mid(torch.from_numpy(fz), torch.from_numpy(ctx), torch.from_numpy(pooled), 8, 4)

        # the single block's row-parallel proj_out on the w8a8 tree, on one shared input: each rank
        # takes its attention and MLP columns of x
        (x_row,) = payload["w8a8"]
        placed, sharding = shard_flux_params(ports["int8_w8a8"], fc, create_mesh({"tp": world}), "tp", 64)
        keys = ("single_transformer_blocks", "0", "proj_out")
        x_local = _tp_slice(keys, torch.from_numpy(x_row), 2, world, sharding.tp_rank, fc)
        res["w8a8 row product"] = dense(placed[keys[0]][keys[1]][keys[2]], x_local, sharding)

        try:
            create_mesh({"data": world + 1})
        except ValueError as e:
            assert "does not match" in str(e), e
            res["mesh refused"] = np.asarray(1)

        vae_p, vcfg, x, zl = payload["vae"]
        vae_p = from_jax_tree(vae_p, device="cpu")
        mesh = create_mesh({"data": world})
        res["vae encode"] = tiled_vae.sharded_vae_encode(vae_p, vcfg, torch.from_numpy(x), mesh)
        res["vae decode"] = tiled_vae.sharded_vae_decode(vae_p, vcfg, torch.from_numpy(zl), mesh)
    if world == 1:  # bit for bit against the unsharded run in this process
        res.update({f"unsharded {k}": v for k, v in unsharded_cases(payload).items()})
    _cli(world, payload, res, cli_ready)
    _serve(world, payload, res)  # last: in a world of two it ends with a rank's failure
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in res.items()}


def run_rank(rank, world, port, payload, out_dir, cli_ready):
    from omgsr_tpu_torch.parallel import distributed

    torch.set_num_threads(1)  # the parent compiles the JAX references meanwhile
    try:
        distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
        res = run_cases(world, payload, cli_ready)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"world{world}.npz"), **res)
        distributed.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"world{world}.rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_world(world, payload, out_dir, cli_ready):
    """Start the ranks of one world; returns the processes (``join_world``).
    ``cli_ready``: an event of the spawn context, set once ``payload["cli"]``'s
    checkpoint is written."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=run_rank, args=(r, world, port, payload, out_dir, cli_ready), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(world, procs, out_dir, timeout_s) -> dict:
    """Wait for the ranks (all of them within ``timeout_s``), then rank 0's
    results; raises with the ranks' tracebacks on a failure or a timeout."""
    import time

    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = "".join(open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
                   if f.startswith(f"world{world}.") and f.endswith(".err"))
    codes = [p.exitcode for p in procs]
    if hung or any(codes) or errs:
        raise RuntimeError(f"world of {world}: ranks {hung} did not end within {timeout_s} s, exit codes {codes}\n"
                           f"{errs}")
    with np.load(os.path.join(out_dir, f"world{world}.npz")) as f:
        return dict(f)
