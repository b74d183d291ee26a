"""OMGSR serving daemon: a long-lived HTTP process around the -S or the -F
pipeline.

    python -m omgsr_tpu_torch.cli.serve --pipeline s \
        --sd_path /ckpts/sd21 --lora_path /ckpts/omgsr_s --port 8000 --warmup 128x128
    python -m omgsr_tpu_torch.cli.serve --pipeline f \
        --flux_path /ckpts/FLUX.1-dev --lora_path /ckpts/omgsr_f --prompt_npz prompt.npz

    curl -X POST --data-binary @lq.png \
        "http://localhost:8000/v1/sr?align=adain" -o sr.png

The pipeline is built as the inference CLI builds it
(``cli/infer_omgsr_s.build_pipeline`` from ``--sd_path``,
``cli/infer_omgsr_f.build_pipeline`` from ``--flux_path``; the adapters of
``--lora_path`` merged). -S's prompt embeddings come from ``--prompt_npz`` or
from ``--prompt`` through the checkpoint's text encoder, -F's from
``--prompt_npz`` or from ``--prompt`` through its T5-XXL and CLIP-L.
``build_server`` also takes the parameters and the embeddings in memory from
its caller. ``--process_size`` and
``--mid_timestep`` default to 512 / 273 for -S and 1024 / 244 for -F.
Dispatch defaults to serial batch-1 with opt-in fixed-size micro-batching.
``--vae_tile N`` sends the VAE stages of images larger than N pixels through
the tiled VAE, with ``--vae_stats fast|exact|auto`` (see
``inference/pipeline_s.py``). ``--quantize int8 | int8_w8a8 | int4`` serves
-F on a quantised DiT (``cli/infer_omgsr_f.quantize_flux``, also over
in-memory parameters; -S takes no quantisation, as in the JAX server).

``POST /v1/reload {"lora_path": ..., "mid_timestep": ..., "guidance_scale":
...}`` rebuilds the pipeline with those arguments changed and swaps it in
behind the dispatcher; the old pipeline is freed first (two 12B DiTs do not
fit one card), requests during the rebuild fail fast with 502, and a failed
rebuild restores the committed arguments' pipeline.

Multi-GPU, one process per GPU under torchrun:

    torchrun --nproc_per_node=8 -m omgsr_tpu_torch.cli.serve --pipeline f --shard tp ...

``--shard tiles`` splits the tiles of the tiled denoiser over the ranks (-S
and -F), ``--shard fsdp`` / ``tp`` the -F DiT (``inference/pipeline_f.py``).
Rank 0 answers HTTP; the other ranks mirror its dispatches
(``serving/server.RankSync``). Started without torchrun (one process, no
process group) the server runs unsharded.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os

import torch

from omgsr_tpu_torch.models.configs import FLUX_DEV, FLUX_VAE, SD21_UNET, SD21_VAE
from omgsr_tpu_torch.parallel.distributed import local_device
from omgsr_tpu_torch.parallel.sharding import cli_mesh
from omgsr_tpu_torch.serving.server import RankSync, ServeOptions, SRServer, make_fused_infer
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.dtypes import resolve_dtype


def _pipeline_s(args, dtype, device, params, configs, prompt_embeds):
    from omgsr_tpu_torch.cli.infer_omgsr_s import build_pipeline, prompt_embeddings
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline

    if params is None and not args.sd_path:
        raise ValueError("build_server needs --sd_path or an in-memory (vae_params, unet_params) pair")
    if prompt_embeds is None:
        if not (args.prompt_npz or args.sd_path):
            raise ValueError("build_server needs --prompt_npz, --sd_path (whose text encoder encodes "
                             "--prompt) or in-memory prompt embeddings")
        prompt_embeds = prompt_embeddings(args, dtype, device)
    embeds = (torch.as_tensor(prompt_embeds).to(device=device, dtype=dtype),)
    if params is None:
        return build_pipeline(args, dtype, device), embeds
    vae_cfg, unet_cfg = configs or (SD21_VAE, SD21_UNET)
    return OMGSRSPipeline(
        *params, vae_cfg, unet_cfg, mid_timestep=args.mid_timestep, vae_tile=args.vae_tile,
        vae_stats=args.vae_stats, device=device,
    ), embeds


def _pipeline_f(args, dtype, device, params, configs, prompt_embeds):
    from omgsr_tpu_torch.cli.infer_omgsr_f import build_pipeline, prompt_embeddings, quantize_flux
    from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline

    if params is None and not args.flux_path:
        raise ValueError("build_server --pipeline f needs --flux_path or an in-memory (vae_params, flux_params) "
                         "pair")
    if prompt_embeds is None:
        prompt_embeds = prompt_embeddings(args, dtype, device)
    embeds = tuple(torch.as_tensor(e).to(device=device, dtype=dtype) for e in prompt_embeds)
    if params is None:
        return build_pipeline(args, dtype, device), embeds
    vae_cfg, flux_cfg = configs or (FLUX_VAE, FLUX_DEV)
    vae_params, flux_params = params
    if args.quantize != "none":  # a tree quantised already keeps its codes (w8a8 adds its markers)
        flux_params = quantize_flux(flux_params, args.quantize, args.quantize_min_params, device)
    return OMGSRFPipeline(
        vae_params, flux_params, vae_cfg, flux_cfg, mid_timestep=args.mid_timestep, guidance_scale=args.guidance_scale,
        vae_tile=args.vae_tile, vae_stats=args.vae_stats, device=device,
    ), embeds


def _make_infer_fn(args, dtype, device, params, configs, prompt_embeds, mesh=None):
    """Build the pipeline (placed on ``mesh`` by ``--shard``) and return
    (infer_fn, fused_infer_fn | None). Called again by /v1/reload.

    The fused function folds the colour fix into the request's dispatch; as
    in the JAX server there is none under ``--vae_tile``, where the colour fix
    runs on the handler thread after the SR step."""
    tile_size = args.process_size // 8
    tile_overlap = tile_size // 2
    build = _pipeline_f if args.pipeline == "f" else _pipeline_s
    pipe, embeds = build(args, dtype, device, params, configs, prompt_embeds)
    if mesh is not None:
        pipe.shard_for_mesh(mesh, args.shard)
    sample = args.latent == "sample"

    def pipe_call(lq, i):
        gen = None
        if sample:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(i))
        return pipe(lq, *embeds, tile_size, tile_overlap, generator=gen, sample_latent=sample)

    def infer_fn(lq, i):
        return pipe_call(torch.as_tensor(lq).to(device=device, dtype=dtype), i)

    if args.vae_tile:
        return infer_fn, None
    return infer_fn, make_fused_infer(pipe_call, dtype, device)


def build_server(args, params=None, configs=None, prompt_embeds=None) -> SRServer:
    """``params``: an in-memory ``(vae_params, unet_params)`` pair (-S) or
    ``(vae_params, flux_params)`` pair (-F) in the port's layout, with their
    ``configs`` (default: SD2.1's or FLUX.1-dev's), in place of ``--sd_path``
    / ``--flux_path``. ``prompt_embeds`` overrides ``--prompt_npz`` and
    ``--prompt``: (1, S, C) for -S, a (prompt_embeds, pooled_prompt_embeds)
    pair for -F."""
    dtype = resolve_dtype(args.weight_dtype)
    mesh = cli_mesh(args.shard, args.device)
    device = resolve_device(local_device(args.device))
    warmup = tuple(tuple(int(v) for v in s.split("x")) for s in (args.warmup or []))
    opts = ServeOptions(
        process_size=args.process_size,
        upscale=args.upscale,
        align_method=args.align_method,
        size_bucket=args.size_bucket,
        max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms,
        queue_depth=args.queue_depth,
        warmup_sizes=warmup,
    )
    infer_fn, fused_fn = _make_infer_fn(args, dtype, device, params, configs, prompt_embeds, mesh)
    sync = RankSync() if mesh is not None else None
    server = SRServer(infer_fn, opts, fused_infer_fn=fused_fn, device=device, sync=sync)

    def rebuild(a):
        if a.lora_path and not os.path.isdir(a.lora_path):  # the build would serve without adapters
            raise FileNotFoundError(f"lora_path {a.lora_path!r} is not a directory")
        return _make_infer_fn(a, dtype, device, params, configs, prompt_embeds, mesh)

    server.post_routes["/v1/reload"] = _reload_route(server, args, rebuild, in_memory=params is not None)
    return server


RELOAD_FIELDS = ("lora_path", "mid_timestep", "guidance_scale")


def _reload_route(server, args, rebuild, in_memory: bool):
    """POST /v1/reload {"lora_path": ..., "mid_timestep": n, "guidance_scale":
    g} (any of them): rebuild the pipeline with these arguments and swap it
    in. Other fields are refused. The old pipeline is freed before the new
    build (two 12B DiTs do not fit one card); requests that arrive during the
    rebuild fail fast with 502. A failed rebuild restores a pipeline from the
    committed arguments, which change only on success. On a multi-rank
    server rank 0 broadcasts the call, every rank rebuilds, and the outcome
    is agreed over the ranks. Parameters handed over in memory are reused;
    only a server built from a checkpoint directory takes a new
    ``lora_path``."""

    def unavailable(message):
        def stub(*a):
            raise RuntimeError(message)

        stub.unavailable = True
        return stub

    def free():
        gc.collect()
        if server.device.type == "cuda":
            torch.cuda.empty_cache()

    def route(body: bytes) -> dict:
        req = json.loads(body or b"{}")
        unknown = set(req) - set(RELOAD_FIELDS)
        if unknown:
            raise ValueError(f"unknown reload fields: {sorted(unknown)}; allowed: {list(RELOAD_FIELDS)}")
        if in_memory and "lora_path" in req:
            raise ValueError("lora_path: this server's parameters were handed over in memory, not read from "
                             "--sd_path / --flux_path")
        if server.rank_failure() is not None:  # the process group cannot be used again
            raise RuntimeError(f"a rank failed ({server.rank_failure()}); restart the server")
        new_args = copy.copy(args)  # a failed rebuild must not touch the committed args
        for k, v in req.items():
            setattr(new_args, k, v)
        sync = server._sync
        with server._reload_lock:
            server.swap_infer_fn(unavailable("model reloading, retry shortly"))
            with server._dispatch_busy:  # waits out the dispatch in flight
                if sync is not None and sync.rank == 0:
                    sync.send_post("/v1/reload", body)
                free()  # the swap dropped the server's references to the old pipeline
                error, fns = None, None
                try:
                    fns = rebuild(new_args)
                except Exception as e:  # noqa: BLE001 — restored below, then raised
                    error = e
                ok = sync.all_ok(error is None) if sync is not None else error is None
                if ok:
                    server.swap_infer_fn(*fns)
                    args.__dict__.update(new_args.__dict__)
                    return {"status": "reloaded", **req}
                fns = None
                free()
                restored = None
                try:
                    restored = rebuild(args)
                except Exception as e:  # noqa: BLE001
                    error = error or e
                if sync is not None and not sync.all_ok(restored is not None):
                    restored = None
                if restored is None:
                    restored = (unavailable(f"model reload failed and its restore failed ({error}); "
                                            "restart the server"),)
                server.swap_infer_fn(*restored)
        raise error if error is not None else RuntimeError("the reload failed on another rank")

    return route


def main(args=None, serve_forever: bool = True, **build_kwargs):
    if args is None:
        args = parse_args()
    server = build_server(args, **build_kwargs)
    if server.follower:  # a rank other than 0 of a multi-rank server: mirror rank 0 until it stops
        server.follow()
        return server, None
    httpd = server.make_httpd(args.host, args.port)
    if server.opts.warmup_sizes:
        print(f"warming {list(server.opts.warmup_sizes)} ...", flush=True)
        server.warmup()
    host, port = httpd.server_address[:2]
    print(f"omgsr-tpu-torch serving on http://{host}:{port} "
          f"(pipeline={args.pipeline}, process_size={args.process_size}, device={server.device})",
          flush=True)
    if serve_forever:
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
    return server, httpd


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="OMGSR serving daemon (PyTorch/CUDA)")
    parser.add_argument("--pipeline", type=str, default="s", choices=["s", "f"])
    parser.add_argument("--sd_path", type=str, default=None, help="SD2.1 dir (HF layout), -S")
    parser.add_argument("--flux_path", type=str, default=None, help="FLUX.1-dev dir (HF layout), -F")
    parser.add_argument("--lora_path", type=str, default=None,
                        help="dir holding vae_encoder_lora_adapter/ and unet_lora_adapter/ (-S) or "
                        "flux_adapter/ and vae_encoder_adapter/ (-F)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no CUDA device is present")
    parser.add_argument("--process_size", type=int, default=None, help="default: 512 (-S), 1024 (-F)")
    parser.add_argument("--upscale", type=int, default=4)
    parser.add_argument("--align_method", type=str, default="adain",
                        choices=["wavelet", "adain", "nofix"])
    parser.add_argument("--weight_dtype", type=str, default="bf16",
                        choices=["fp32", "bf16"],
                        help="the CUDA kernels take bf16 and f32")
    parser.add_argument("--prompt", type=str, nargs="*", default="")
    parser.add_argument("--prompt_npz", type=str, default=None)
    parser.add_argument("--mid_timestep", type=int, default=None, help="default: 273 (-S), 244 (-F)")
    parser.add_argument("--guidance_scale", type=float, default=1.0, help="-F only")
    parser.add_argument("--quantize", type=str, default="none", choices=["none", "int8", "int8_w8a8", "int4"],
                        help="-F only: int8 weight-only DiT storage, int8_w8a8 with int8 products, int4 "
                        "group-wise (g=128) storage, the minimum-memory mode")
    parser.add_argument("--quantize_min_params", type=int, default=1 << 16,
                        help="-F only: quantize dense weights with at least this many elements")
    parser.add_argument("--vae_tile", type=int, default=None,
                        help="tile the VAE stages of images whose larger side exceeds this many pixels")
    parser.add_argument("--vae_stats", type=str, default="fast", choices=["fast", "exact", "auto"],
                        help="GroupNorm statistics of the tiled VAE: from a downsampled copy (fast), "
                        "exact over the whole image (exact), or exact past a downsample ratio of 4 (auto)")
    parser.add_argument("--shard", type=str, default="none", choices=["none", "fsdp", "tp", "tiles"],
                        help="multi-GPU under torchrun: tiles (-S, -F) splits the denoiser's tiles over the "
                        "ranks; fsdp / tp (-F) place the DiT over them")
    parser.add_argument("--size_bucket", type=int, default=64)
    parser.add_argument("--max_batch", type=int, default=1)
    parser.add_argument("--batch_window_ms", type=float, default=5.0)
    parser.add_argument("--queue_depth", type=int, default=64)
    parser.add_argument("--latent", type=str, default="sample", choices=["sample", "mean"],
                        help="mean = deterministic output per input (no per-request noise draw)")
    parser.add_argument("--warmup", type=str, nargs="*", default=None,
                        metavar="HxW", help="input sizes to run once at startup, e.g. 128x128")
    args = parser.parse_args(argv)
    if args.process_size is None:
        args.process_size = 512 if args.pipeline == "s" else 1024
    if args.mid_timestep is None:
        args.mid_timestep = 273 if args.pipeline == "s" else 244
    return args


if __name__ == "__main__":
    main()
