"""OMGSR serving daemon: a long-lived HTTP process around the -S pipeline.

    python -m omgsr_tpu_torch.cli.serve --pipeline s \
        --sd_path /ckpts/sd21 --prompt_npz prompts.npz --port 8000 --warmup 128x128

    curl -X POST --data-binary @lq.png \
        "http://localhost:8000/v1/sr?align=adain" -o sr.png

The checkpoint load path is not ported yet, so ``--sd_path`` raises; until
then ``build_server`` takes the pipeline's parameters (and optionally the
prompt embeddings) in memory from its caller. Dispatch defaults to serial
batch-1 with opt-in fixed-size micro-batching. ``--vae_tile N`` sends the VAE
stages of images larger than N pixels through the tiled VAE, with
``--vae_stats fast|exact|auto`` (see ``inference/pipeline_s.py``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
from omgsr_tpu_torch.models.configs import SD21_UNET, SD21_VAE
from omgsr_tpu_torch.serving.server import ServeOptions, SRServer, make_fused_infer
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.dtypes import resolve_dtype


def load_prompt_npz(path: str) -> dict:
    """Pre-computed embeddings: npz with a prompt_embeds array."""
    data = np.load(path)
    return {k: torch.from_numpy(data[k]) for k in data.files}


def _make_infer_fn(args, dtype, device, params, configs, prompt_embeds):
    """Build the pipeline and return (infer_fn, fused_infer_fn | None).

    The fused function folds the colour fix into the request's dispatch; as
    in the JAX server there is none under ``--vae_tile``, where the colour fix
    runs on the handler thread after the SR step."""
    tile_size = args.process_size // 8
    tile_overlap = tile_size // 2

    if params is None:
        if args.sd_path:
            raise NotImplementedError(
                "--sd_path: loading SD2.1 checkpoints and LoRA adapters is not ported yet "
                "(load-path slice); hand build_server the parameters in memory"
            )
        raise ValueError("build_server needs --sd_path or an in-memory (vae_params, unet_params) pair")
    if prompt_embeds is None:
        if not args.prompt_npz:
            raise NotImplementedError(
                "text encoding is not ported yet (load-path slice): pass --prompt_npz "
                "or in-memory prompt embeddings"
            )
        prompt_embeds = load_prompt_npz(args.prompt_npz)["prompt_embeds"]
    prompt_embeds = torch.as_tensor(prompt_embeds).to(device=device, dtype=dtype)

    vae_params, unet_params = params
    vae_cfg, unet_cfg = configs
    pipe = OMGSRSPipeline(
        vae_params, unet_params, vae_cfg, unet_cfg, mid_timestep=args.mid_timestep,
        vae_tile=args.vae_tile, vae_stats=args.vae_stats, device=device,
    )
    sample = args.latent == "sample"

    def pipe_call(lq, i):
        gen = None
        if sample:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(i))
        return pipe(lq, prompt_embeds, tile_size, tile_overlap, generator=gen, sample_latent=sample)

    def infer_fn(lq, i):
        return pipe_call(torch.as_tensor(lq).to(device=device, dtype=dtype), i)

    if args.vae_tile:
        return infer_fn, None
    return infer_fn, make_fused_infer(pipe_call, dtype, device)


def build_server(args, params=None, configs=(SD21_VAE, SD21_UNET), prompt_embeds=None) -> SRServer:
    """``params``: an in-memory ``(vae_params, unet_params)`` pair in the
    port's layout, with their ``configs``; required until ``--sd_path`` can
    be loaded. ``prompt_embeds`` (1, S, C) overrides ``--prompt_npz``."""
    dtype = resolve_dtype(args.weight_dtype)
    device = resolve_device(args.device)
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
    infer_fn, fused_fn = _make_infer_fn(args, dtype, device, params, configs, prompt_embeds)
    return SRServer(infer_fn, opts, fused_infer_fn=fused_fn, device=device)


def main(args=None, serve_forever: bool = True, **build_kwargs):
    if args is None:
        args = parse_args()
    server = build_server(args, **build_kwargs)
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
    parser.add_argument("--pipeline", type=str, default="s", choices=["s"],
                        help="only the -S pipeline is ported")
    parser.add_argument("--sd_path", type=str, default=None, help="SD2.1 dir (not loadable yet)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no CUDA device is present")
    parser.add_argument("--process_size", type=int, default=512)
    parser.add_argument("--upscale", type=int, default=4)
    parser.add_argument("--align_method", type=str, default="adain",
                        choices=["wavelet", "adain", "nofix"])
    parser.add_argument("--weight_dtype", type=str, default="bf16",
                        choices=["fp32", "bf16"],
                        help="the CUDA kernels take bf16 and f32")
    parser.add_argument("--prompt_npz", type=str, default=None)
    parser.add_argument("--mid_timestep", type=int, default=273)
    parser.add_argument("--vae_tile", type=int, default=None,
                        help="tile the VAE stages of images whose larger side exceeds this many pixels")
    parser.add_argument("--vae_stats", type=str, default="fast", choices=["fast", "exact", "auto"],
                        help="GroupNorm statistics of the tiled VAE: from a downsampled copy (fast), "
                        "exact over the whole image (exact), or exact past a downsample ratio of 4 (auto)")
    parser.add_argument("--size_bucket", type=int, default=64)
    parser.add_argument("--max_batch", type=int, default=1)
    parser.add_argument("--batch_window_ms", type=float, default=5.0)
    parser.add_argument("--queue_depth", type=int, default=64)
    parser.add_argument("--latent", type=str, default="sample", choices=["sample", "mean"],
                        help="mean = deterministic output per input (no per-request noise draw)")
    parser.add_argument("--warmup", type=str, nargs="*", default=None,
                        metavar="HxW", help="input sizes to run once at startup, e.g. 128x128")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
