"""Long-lived HTTP serving for the OMGSR pipelines.

Stage the weights once, build the kernels once, and answer requests from a
long-lived process: a stdlib-only HTTP server around an
``infer_fn(lq_batch, index)`` contract.

One dispatcher thread owns the device: requests are dispatched serially at
batch 1 by default, with host decode/encode overlapped in handler threads.
Fixed-size padded micro-batches (``max_batch > 1``) are opt-in.

Endpoints:
  GET  /healthz      -> {"status": "ok", backend, device, warm size list}
  GET  /metrics      -> request/error/batch counters + latency percentiles
  POST /v1/sr?align=adain|wavelet|nofix  (body: png/jpeg bytes) -> png bytes

``SRServer.process_array`` is the same request path below the image codec
(pre-resized uint8 H x W x 3 in, uint8 out); ``process_image`` decodes,
calls it and encodes.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from omgsr_tpu_torch.ops.color import (
    ALIGN_IDX,
    adain_color_fix,
    switched_color_fix_batch,
    wavelet_color_fix,
)
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.image_io import (
    array_to_sr_input,
    finalize_output,
    prepare_input,
    prepared_hw,
    sr_output_to_uint8,
)

ALIGN_METHODS = ("adain", "wavelet", "nofix")


@dataclass
class ServeOptions:
    process_size: int = 512
    upscale: int = 4
    align_method: str = "adain"  # per-request override via ?align=
    size_bucket: int = 64
    max_batch: int = 1
    batch_window_ms: float = 5.0  # max wait for co-batchable arrivals (max_batch>1)
    queue_depth: int = 64  # back-pressure: 503 beyond this many queued requests
    warmup_sizes: tuple = ()  # (H, W) input sizes to run once at startup
    request_timeout_s: float = 900.0  # 504 after this


@dataclass
class _Request:
    lq: np.ndarray  # (1, H, W, 3) in [-1, 1], bucket-padded
    index: int
    true_hw: tuple = (0, 0)  # valid extent before bucket padding
    align: str = "nofix"  # resolved per-request method (fused dispatch)
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None  # device tensor slice (1, H, W, 3) when done
    error: Exception | None = None
    # which path the dispatcher ACTUALLY ran (set in _dispatch_group). The
    # handler must postprocess based on this, not on a submit-time snapshot:
    # a swap_infer_fn between submit and dispatch would otherwise make the
    # handler treat an un-color-fixed [-1,1] canvas as already-[0,1]
    fused_used: bool = False


class SRServer:
    """Owns the dispatcher thread; handlers only decode/encode images.

    infer_fn(lq (B,H,W,3) float32 ndarray in [-1,1], index) -> SR batch
    tensor in [-1,1] on the serving device.
    """

    def __init__(self, infer_fn, opts: ServeOptions | None = None, fused_infer_fn=None, device="cuda"):
        """fused_infer_fn (optional): ``(lq (B,H,W,3) [-1,1], index, hw (B,2)
        int32, align_idx (B,) int32) -> color-fixed batch in [0,1]``: the SR
        step AND the per-request color fix in one dispatch (the fix runs
        masked on the bucket-padded canvas, equal to crop-then-fix; see
        ops/color.py). When absent, the two-dispatch path (infer_fn, then
        the fix on the handler thread) is used. ``device`` is the device the
        infer functions compute on; it is reported by /healthz."""
        self.device = resolve_device(device)
        self.infer_fn = infer_fn
        self.fused_infer_fn = fused_infer_fn
        self.opts = opts or ServeOptions()
        self._fix = {"adain": adain_color_fix, "wavelet": wavelet_color_fix}
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._latencies: deque = deque(maxlen=2048)  # seconds, end-to-end
        self._stats = {"requests": 0, "errors": 0, "batches": 0, "batched_images": 0}
        self._in_flight = 0
        self._t0 = time.time()
        self._warm: list = []
        self._seq = 0
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._dispatcher.start()
        self._httpd: ThreadingHTTPServer | None = None

    # ---- dispatch -----------------------------------------------------------

    def _dispatch_loop(self):
        opts = self.opts
        held = None  # a different-bucket request becomes the NEXT group's
        # first (keeps FIFO fairness: re-queuing it behind later arrivals
        # would let sustained same-bucket traffic starve it)
        while not self._stop.is_set():
            if held is not None:
                first, held = held, None
            else:
                try:
                    first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            group = [first]
            if opts.max_batch > 1:
                deadline = time.perf_counter() + opts.batch_window_ms / 1e3
                while len(group) < opts.max_batch:
                    wait = deadline - time.perf_counter()
                    if wait <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=wait)
                    except queue.Empty:
                        break
                    if nxt.lq.shape == first.lq.shape:
                        group.append(nxt)
                    else:
                        held = nxt
                        break
            try:
                self._dispatch_group(group)
            except Exception as e:  # noqa: BLE001 — keep the dispatcher alive
                for r in group:
                    r.error = DispatchError(f"{type(e).__name__}: {e}")
                    r.done.set()
        # stop: fail everything still queued so no handler blocks forever
        leftovers = [held] if held is not None else []
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            r.error = DispatchError("server shutting down")
            r.done.set()

    def _dispatch_group(self, group):
        opts = self.opts
        n = len(group)
        # read BOTH fns once: a concurrent swap_infer_fn must not be observed
        # half-way
        fused_fn, plain_fn = self.fused_infer_fn, self.infer_fn
        # pad to the fixed batch so every dispatch of a bucket has one shape
        b = opts.max_batch if opts.max_batch > 1 else 1
        pad = [group[-1]] * (b - n)
        lq = np.concatenate([r.lq for r in group + pad]).astype(np.float32)
        try:
            if fused_fn is not None:
                hw = np.asarray([r.true_hw for r in group + pad], np.int32)
                align = np.asarray([ALIGN_IDX[r.align] for r in group + pad], np.int32)
                out = fused_fn(lq, group[0].index, hw, align)
            else:
                out = plain_fn(lq, group[0].index)
            for j, r in enumerate(group):
                r.result = out[j : j + 1]
                r.fused_used = fused_fn is not None
        except Exception as e:  # noqa: BLE001 — a device/model fault, not bad input
            for r in group:
                r.error = DispatchError(f"{type(e).__name__}: {e}")
        for r in group:
            r.done.set()
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batched_images"] += n

    # ---- request path -------------------------------------------------------

    def _run_array(self, arr_u8: np.ndarray, align: str | None) -> np.ndarray:
        """Enqueue one pre-resized image, wait for the dispatcher, crop, fix
        and quantise. Runs on the caller's (handler) thread."""
        opts = self.opts
        method = align if align is not None else opts.align_method
        if method not in ALIGN_METHODS:
            raise ValueError(f"unknown align {method!r}")
        arr_u8 = np.asarray(arr_u8)
        if arr_u8.ndim != 3 or arr_u8.shape[0] % 8 or arr_u8.shape[1] % 8:
            raise ValueError(
                f"expected a pre-resized (H, W, 3) image with H and W multiples of 8, got {arr_u8.shape}"
            )
        lq, src01, true_hw = array_to_sr_input(arr_u8, opts.size_bucket)
        with self._lock:
            if self._stop.is_set():
                raise DispatchError("server shutting down")
            if self._in_flight >= opts.queue_depth:
                raise OverloadedError(self._in_flight)
            self._in_flight += 1
            self._seq += 1
            req = _Request(lq=lq, index=self._seq, true_hw=true_hw, align=method)
        try:
            self._queue.put(req)
            if not req.done.wait(timeout=opts.request_timeout_s):
                raise RequestTimeout(f"no result within {opts.request_timeout_s}s")
            if req.error is not None:
                raise req.error
            fused = req.fused_used  # the path the dispatcher ACTUALLY ran
            try:
                return sr_output_to_uint8(
                    req.result, src01, true_hw,
                    None if fused else self._fix.get(method), already01=fused,
                )
            except FloatingPointError as e:  # a model fault, not bad input
                raise DispatchError(str(e)) from e
        finally:
            with self._lock:
                self._in_flight -= 1

    def _record(self, t_start: float) -> None:
        with self._lock:
            self._stats["requests"] += 1
            self._latencies.append(time.perf_counter() - t_start)

    def process_array(self, arr_u8: np.ndarray, align: str | None = None) -> np.ndarray:
        """The request path below the image codec: a uint8 (H, W, 3) image
        that is already resized to its output size (H and W multiples of 8)
        -> the uint8 (H, W, 3) SR image."""
        t_start = time.perf_counter()
        out = self._run_array(arr_u8, align)
        self._record(t_start)
        return out

    def process_image(self, body: bytes, align: str | None = None) -> bytes:
        """Decode -> resize -> process -> undo the resize -> encode PNG."""
        from PIL import Image

        t_start = time.perf_counter()
        opts = self.opts
        img = Image.open(io.BytesIO(body)).convert("RGB")
        inp, resize_flag, orig = prepare_input(img, opts.process_size, opts.upscale)
        out_u8 = self._run_array(np.asarray(inp, np.uint8), align)
        out_pil = finalize_output(Image.fromarray(out_u8), resize_flag, orig, opts.upscale)
        buf = io.BytesIO()
        out_pil.save(buf, format="PNG")
        self._record(t_start)
        return buf.getvalue()

    def warmup(self):
        """Run each configured (H, W) input size once (at the size the
        resize protocol gives it) so the first real request does not pay the
        kernel build and the libraries' first-call set-up. Uses a noise
        image (a constant one would degenerate adain's per-channel std)."""
        rng = np.random.default_rng(0)
        opts = self.opts
        for h, w in opts.warmup_sizes:
            ph, pw = prepared_hw(h, w, opts.process_size, opts.upscale)
            self._run_array(rng.integers(0, 255, (ph, pw, 3), dtype=np.uint8), None)
            self._warm.append([h, w])

    def swap_infer_fn(self, infer_fn, fused_infer_fn=None):
        """Replace the model behind the dispatcher. In-flight groups finish
        on the old fn; queued requests take the new one."""
        # order matters for lock-free readers: requests dispatched between
        # these two assignments run the OLD fused fn or the NEW plain fn —
        # both are complete models, never a mixed half-swap
        self.fused_infer_fn = fused_infer_fn
        self.infer_fn = infer_fn

    # ---- introspection ------------------------------------------------------

    def health(self) -> dict:
        dev = self.device
        is_cuda = dev.type == "cuda"
        return {
            "status": "ok",
            "backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if is_cuda else "cpu",
            "devices": torch.cuda.device_count() if is_cuda else 1,
            "warm": list(self._warm),
            "uptime_s": round(time.time() - self._t0, 1),
        }

    def metrics(self) -> dict:
        with self._lock:
            lats = sorted(self._latencies)
            stats = dict(self._stats)
            in_flight = self._in_flight

        def q(p):
            return round(lats[min(int(p * len(lats)), len(lats) - 1)] * 1e3, 2) if lats else None

        return {
            **stats,
            "in_flight": in_flight,
            "avg_batch": round(stats["batched_images"] / stats["batches"], 3)
            if stats["batches"]
            else None,
            "latency_ms_p50": q(0.50),
            "latency_ms_p90": q(0.90),
            "latency_ms_p99": q(0.99),
            "uptime_s": round(time.time() - self._t0, 1),
        }

    # ---- HTTP layer ---------------------------------------------------------

    def make_httpd(self, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default; metrics cover it
                pass

            def _send(self, code, body: bytes, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, obj):
                self._send(code, json.dumps(obj).encode())

            def _fail(self, code, message):
                with server._lock:
                    server._stats["errors"] += 1
                self._send_json(code, {"error": message})

            def do_GET(self):
                if self.path.split("?")[0] == "/healthz":
                    self._send_json(200, server.health())
                elif self.path.split("?")[0] == "/metrics":
                    self._send_json(200, server.metrics())
                else:
                    self._send_json(404, {"error": "not found"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path != "/v1/sr":
                    self._send_json(404, {"error": "not found"})
                    return
                params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
                align = params.get("align")
                if align is not None and align not in ALIGN_METHODS:
                    self._send_json(400, {"error": f"unknown align {align!r}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    png = server.process_image(body, align=align)
                    self._send(200, png, ctype="image/png")
                except OverloadedError as e:
                    self._fail(503, f"overloaded ({e.args[0]} queued)")
                except RequestTimeout as e:
                    self._fail(504, str(e))
                except DispatchError as e:  # device/model fault — retryable 5xx
                    self._fail(502, str(e))
                except Exception as e:  # noqa: BLE001 — bad input (undecodable image, ...)
                    self._fail(400, f"{type(e).__name__}: {e}")

        httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd = httpd
        return httpd

    def shutdown(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._dispatcher.join(timeout=5)


def make_fused_infer(pipeline_call, model_dtype, device="cuda"):
    """Build the fused serving contract from a pipeline call
    (``pipeline_call(lq, index) -> SR batch in [-1,1]``) as plain
    composition.

    Returns ``fused_fn(lq (B,H,W,3) f32 [-1,1], index, hw (B,2), align_idx
    (B,)) -> color-fixed batch in [0,1]``: SR + per-request masked color
    fix in one dispatch. lq enters as float32 so the fix statistics see the
    same source precision as the two-dispatch path; the SR step gets it in
    ``model_dtype``."""
    device = resolve_device(device)

    @torch.inference_mode()
    def fused_fn(lq, index, hw, align_idx):
        lq32 = torch.as_tensor(lq, dtype=torch.float32).to(device)
        out = pipeline_call(lq32.to(model_dtype), index)
        out01 = out.float() * 0.5 + 0.5
        src01 = lq32 * 0.5 + 0.5
        return switched_color_fix_batch(out01, src01, hw, align_idx)

    return fused_fn


class OverloadedError(RuntimeError):
    """Queue depth exceeded -> 503."""


class DispatchError(RuntimeError):
    """Device/model fault during dispatch (not a client error) -> 502."""


class RequestTimeout(RuntimeError):
    """No result within request_timeout_s -> 504."""
