"""The port's serving daemon on the CPU with the tiny pipeline: the
array-level request path, the HTTP surface over a real socket on an
ephemeral port, the error paths, fused against two-dispatch colour fix,
cli.serve, and one PNG answered by both the JAX server and the port."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.inference.pipeline_s import OMGSRSPipeline as JPipeline
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu.serving import ServeOptions as JServeOptions
from omgsr_tpu.serving import SRServer as JSRServer
from omgsr_tpu_torch.cli import serve as serve_cli
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
from omgsr_tpu_torch.serving import ServeOptions, SRServer
from omgsr_tpu_torch.serving.server import DispatchError, OverloadedError, make_fused_infer
from omgsr_tpu_torch.utils import image_io
from tests.torch_port_helpers import (
    J_TINY_UNET,
    J_TINY_VAE,
    T_TINY_UNET,
    T_TINY_VAE,
    bridge,
    jax_init,
)

OPTS = dict(process_size=32, upscale=4, size_bucket=16)


@pytest.fixture(scope="module")
def model():
    vp = jax_init(JV.init_vae, 0, J_TINY_VAE)
    up = jax_init(JU.init_unet, 1, J_TINY_UNET)
    prompt = np.random.default_rng(2).standard_normal((1, 7, 16)).astype(np.float32)
    return vp, up, prompt


def _port_fns(model):
    vp, up, prompt = model
    pipe = OMGSRSPipeline(bridge(vp), bridge(up), T_TINY_VAE, T_TINY_UNET, device="cpu")

    def pipe_call(lq, i):
        return pipe(lq, prompt, 16, 8, sample_latent=False)

    def infer_fn(lq, i):
        return pipe_call(torch.as_tensor(lq, dtype=torch.float32), i)

    return infer_fn, make_fused_infer(pipe_call, torch.float32, device="cpu")


def _png_bytes(h, w, seed=0):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _serve(srv):
    httpd = srv.make_httpd("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    host, port = httpd.server_address[:2]
    return f"http://{host}:{port}"


def _post(url, data):
    return urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"), timeout=120)


@pytest.fixture(scope="module")
def server(model):
    infer_fn, fused_fn = _port_fns(model)
    srv = SRServer(infer_fn, ServeOptions(**OPTS, warmup_sizes=((8, 8),)), fused_infer_fn=fused_fn, device="cpu")
    base = _serve(srv)
    srv.warmup()
    assert srv.metrics()["requests"] == 0  # warmup is not served traffic
    yield srv, base
    srv.shutdown()


class TestArrayPath:
    def test_round_trip_and_metrics(self, server):
        srv, _ = server
        rng = np.random.default_rng(1)
        before = srv.metrics()["requests"]
        a = srv.process_array(rng.integers(0, 255, (32, 24, 3), dtype=np.uint8), "adain")
        b = srv.process_array(rng.integers(0, 255, (32, 24, 3), dtype=np.uint8), "adain")
        assert a.shape == b.shape == (32, 24, 3) and a.dtype == np.uint8  # bucket pad cropped
        assert a.std() > 0 and np.abs(a.astype(int) - b.astype(int)).mean() > 1
        m = srv.metrics()
        assert m["requests"] == before + 2 and m["errors"] == 0 and m["latency_ms_p50"] is not None

    @pytest.mark.parametrize("bad", [np.zeros((30, 24, 3), np.uint8), np.zeros((32, 24), np.uint8),
                                     np.zeros((32, 24, 3), np.float32)])
    def test_rejects_what_is_not_a_resized_uint8_image(self, server, bad):
        with pytest.raises(ValueError):
            server[0].process_array(bad)

    def test_unknown_align(self, server):
        with pytest.raises(ValueError):
            server[0].process_array(np.zeros((32, 24, 3), np.uint8), "bogus")

    def test_concurrent_clients(self, server):
        srv, _ = server
        outs = {}

        def call(seed):
            img = np.random.default_rng(seed).integers(0, 255, (32, 32, 3), dtype=np.uint8)
            outs[seed] = srv.process_array(img, "nofix")

        ts = [threading.Thread(target=call, args=(s,)) for s in range(4)]
        [th.start() for th in ts]
        [th.join(timeout=120) for th in ts]
        assert not any(th.is_alive() for th in ts) and len(outs) == 4
        assert np.abs(outs[0].astype(int) - outs[1].astype(int)).mean() > 1


class TestHTTP:
    def test_healthz_reports_the_torch_device(self, server):
        _, base = server
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["backend"] == "cpu" and h["warm"] == [[8, 8]]

    def test_sr_roundtrip_png(self, server):
        srv, base = server
        with _post(f"{base}/v1/sr?align=wavelet", _png_bytes(8, 6)) as r:
            assert r.headers["Content-Type"] == "image/png"
            out = Image.open(io.BytesIO(r.read()))
        assert out.size == (24, 32)  # 8x6 -> x4, snapped to multiples of 8
        assert np.asarray(out).std() > 0
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            assert json.loads(r.read())["requests"] >= 1

    def test_bad_body_is_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{server[1]}/v1/sr", b"not an image")
        assert e.value.code == 400

    def test_unknown_align_is_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{server[1]}/v1/sr?align=bogus", _png_bytes(8, 8))
        assert e.value.code == 400

    @pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/v1/nope")])
    def test_unknown_path_is_404(self, server, method, path):
        with pytest.raises(urllib.error.HTTPError) as e:
            if method == "GET":
                urllib.request.urlopen(f"{server[1]}{path}", timeout=30)
            else:
                _post(f"{server[1]}{path}", b"")
        assert e.value.code == 404

    def test_metrics_endpoint(self, server):
        with urllib.request.urlopen(f"{server[1]}/metrics?x=1", timeout=30) as r:
            m = json.loads(r.read())
        assert {"requests", "errors", "batches", "in_flight", "latency_ms_p99"} <= set(m)


class TestDispatch:
    def _one(self, infer_fn, **opts):
        srv = SRServer(infer_fn, ServeOptions(**{**OPTS, **opts}), device="cpu")
        return srv, _serve(srv)

    def test_device_fault_is_502(self):
        def boom(lq, i):
            raise RuntimeError("backend fell over")

        srv, base = self._one(boom)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/sr", _png_bytes(8, 8))
            assert e.value.code == 502 and srv.metrics()["errors"] == 1
            with pytest.raises(DispatchError):
                srv.process_array(np.zeros((32, 32, 3), np.uint8))
        finally:
            srv.shutdown()

    def test_non_finite_output_is_502(self):
        srv, base = self._one(lambda lq, i: torch.full((1, 32, 32, 3), float("nan")))
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/sr?align=nofix", _png_bytes(8, 8))
            assert e.value.code == 502
        finally:
            srv.shutdown()

    def test_backpressure_503(self, model):
        srv, base = self._one(_port_fns(model)[0], queue_depth=0)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/sr", _png_bytes(8, 8))
            assert e.value.code == 503 and srv.metrics()["errors"] == 1
            with pytest.raises(OverloadedError):
                srv.process_array(np.zeros((32, 32, 3), np.uint8))
        finally:
            srv.shutdown()

    def test_timeout_is_504(self):
        def slow(lq, i):
            time.sleep(1.0)
            raise AssertionError("unreached by the handler")

        srv, base = self._one(slow, request_timeout_s=0.05)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/sr", _png_bytes(8, 8))
            assert e.value.code == 504
        finally:
            srv.shutdown()

    def test_shutdown_fails_queued_requests(self):
        def slow(lq, i):
            time.sleep(0.5)
            raise RuntimeError("never completes in time")

        srv = SRServer(slow, ServeOptions(**OPTS), device="cpu")
        errors = []

        def call():
            try:
                srv.process_array(np.zeros((32, 32, 3), np.uint8), "nofix")
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        ts = [threading.Thread(target=call) for _ in range(3)]
        [th.start() for th in ts]
        time.sleep(0.1)  # let one dispatch start, leave the rest queued
        srv.shutdown()
        [th.join(timeout=10) for th in ts]
        assert not any(th.is_alive() for th in ts)
        assert len(errors) == 3

    def test_micro_batch_groups_and_pads(self, model):
        seen = []
        infer_fn = _port_fns(model)[0]

        def counting(lq, i):
            seen.append(lq.shape[0])
            return infer_fn(lq, i)

        srv = SRServer(counting, ServeOptions(**OPTS, max_batch=2, batch_window_ms=2000.0), device="cpu")
        try:
            srv.process_array(np.zeros((32, 32, 3), np.uint8), "nofix")  # a lone request is padded to 2
            base_batches = srv.metrics()["batches"]
            results = {}

            def call(seed):
                img = np.random.default_rng(seed).integers(0, 255, (32, 32, 3), dtype=np.uint8)
                results[seed] = srv.process_array(img, "nofix")

            ts = [threading.Thread(target=call, args=(s,)) for s in (1, 2)]
            [th.start() for th in ts]
            [th.join(timeout=120) for th in ts]
            assert srv.metrics()["batches"] == base_batches + 1  # grouped, not 2 dispatches
            assert seen == [2, 2]
            assert np.abs(results[1].astype(int) - results[2].astype(int)).mean() > 1
        finally:
            srv.shutdown()

    def test_swap_infer_fn(self, model):
        infer_fn, fused_fn = _port_fns(model)
        srv = SRServer(lambda lq, i: torch.zeros(1, 32, 32, 3), ServeOptions(**OPTS), device="cpu")
        try:
            img = np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8)
            assert srv.process_array(img, "nofix").std() == 0
            srv.swap_infer_fn(infer_fn, fused_fn)
            assert srv.process_array(img, "nofix").std() > 0
        finally:
            srv.shutdown()


def test_fused_matches_two_dispatch_path(model):
    """The fused SR + masked colour fix must reproduce the two-dispatch path
    (fix on the cropped image) for every align method, on an input whose
    bucket pad is real (32x24 padded to 32x32)."""
    infer_fn, fused_fn = _port_fns(model)
    srv_a = SRServer(infer_fn, ServeOptions(**OPTS), device="cpu")
    srv_b = SRServer(infer_fn, ServeOptions(**OPTS), fused_infer_fn=fused_fn, device="cpu")
    img = np.random.default_rng(3).integers(0, 255, (32, 24, 3), dtype=np.uint8)
    try:
        for align in ("nofix", "adain", "wavelet"):
            a, b = srv_a.process_array(img, align), srv_b.process_array(img, align)
            assert a.shape == b.shape
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, align
    finally:
        srv_a.shutdown()
        srv_b.shutdown()


@pytest.mark.parametrize("align", ["adain", "wavelet", "nofix"])
def test_one_png_answered_by_both_servers(model, align):
    """The same PNG through the JAX server and the port, shared weights,
    posterior-mean latent: the images agree within one uint8 step (the
    pipelines agree to 1e-3 in [-1,1], far below half a step, so only a
    value sitting on a rounding boundary can differ)."""
    vp, up, prompt = model
    jpipe = JPipeline(vp, up, J_TINY_VAE, J_TINY_UNET)
    jsrv = JSRServer(
        lambda lq, i: jpipe(jnp.asarray(lq, jnp.float32), jnp.asarray(prompt), 16, 8, sample_latent=False),
        JServeOptions(**OPTS), np_dtype=np.float32,
    )
    infer_fn, fused_fn = _port_fns(model)
    tsrv = SRServer(infer_fn, ServeOptions(**OPTS), fused_infer_fn=fused_fn, device="cpu")
    body = _png_bytes(8, 6, seed=5)
    try:
        a = np.asarray(Image.open(io.BytesIO(jsrv.process_image(body, align=align))))
        b = np.asarray(Image.open(io.BytesIO(tsrv.process_image(body, align=align))))
        assert a.shape == b.shape == (32, 24, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


class TestImageIO:
    def test_array_halves_equal_the_pil_protocol(self):
        img = Image.fromarray(np.random.default_rng(0).integers(0, 255, (9, 7, 3), dtype=np.uint8))
        lq, src01, flag, orig, true_hw = image_io.preprocess_sr_input(img, 32, 4, 16)
        assert flag and orig == (7, 9) and true_hw == image_io.prepared_hw(9, 7, 32, 4)
        assert lq.shape[1] % 16 == 0 and lq.shape[2] % 16 == 0 and src01.shape[1:3] == true_hw
        assert lq.min() >= -1 and lq.max() <= 1 and src01.min() >= 0
        for hw in ((8, 8), (100, 37), (5, 300)):
            w, h = image_io.prepare_input(Image.new("RGB", (hw[1], hw[0])), 32, 4)[0].size
            assert (h, w) == image_io.prepared_hw(*hw, 32, 4)

    def test_output_half(self):
        out = torch.linspace(-1.2, 1.2, 32 * 32 * 3).reshape(1, 32, 32, 3)
        u8 = image_io.sr_output_to_uint8(out, None, (20, 24))
        assert u8.shape == (20, 24, 3) and u8.dtype == np.uint8 and u8.min() == 0
        same = image_io.sr_output_to_uint8(out * 0.5 + 0.5, None, (20, 24), already01=True)
        np.testing.assert_array_equal(u8, same)
        with pytest.raises(FloatingPointError):
            image_io.sr_output_to_uint8(out * float("inf"), None, (20, 24))

    def test_pil_halves(self):
        u8 = np.random.default_rng(1).integers(0, 255, (16, 24, 3), dtype=np.uint8)
        img = Image.fromarray(u8)
        pm1, a01 = image_io.pil_to_array_pm1(img), image_io.pil_to_array_01(img)
        assert pm1.shape == a01.shape == (1, 16, 24, 3)
        np.testing.assert_allclose(pm1, a01 * 2 - 1, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(image_io.array01_to_pil(a01)), u8)
        # postprocess: [-1,1] device batch -> PIL, colour fix applied, resize undone
        from omgsr_tpu_torch.ops.color import adain_color_fix

        out = image_io.postprocess_sr_output(
            torch.from_numpy(pm1), a01, (16, 24), adain_color_fix, True, (5, 3), 4)
        assert out.size == (20, 12)
        same = image_io.postprocess_sr_output(torch.from_numpy(pm1), a01, (16, 24), None, False, (5, 3), 4)
        np.testing.assert_array_equal(np.asarray(same), u8)


class TestServeCLI:
    def _args(self, tmp_path, *extra):
        rng = np.random.default_rng(0)
        np.savez(tmp_path / "prompt.npz", prompt_embeds=rng.normal(size=(1, 7, 16)).astype(np.float32))
        return serve_cli.parse_args([
            "--pipeline", "s", "--prompt_npz", str(tmp_path / "prompt.npz"),
            "--process_size", "64", "--upscale", "4", "--size_bucket", "16",
            "--weight_dtype", "fp32", "--port", "0", "--device", "cpu", *extra,
        ])

    def test_build_and_drive(self, model, tmp_path):
        vp, up, _ = model
        args = self._args(tmp_path, "--latent", "mean", "--warmup", "4x4")
        assert args.mid_timestep == 273 and args.align_method == "adain"
        server, httpd = serve_cli.main(
            args, serve_forever=False, params=(bridge(vp), bridge(up)), configs=(T_TINY_VAE, T_TINY_UNET)
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        host, port = httpd.server_address[:2]
        try:
            assert server.fused_infer_fn is not None and server.health()["warm"] == [[4, 4]]
            outs = []
            for _ in range(2):
                with _post(f"http://{host}:{port}/v1/sr", _png_bytes(12, 8)) as r:
                    outs.append(np.asarray(Image.open(io.BytesIO(r.read()))))
            assert outs[0].shape == (48, 32, 3)
            np.testing.assert_array_equal(outs[0], outs[1])  # --latent mean: deterministic
        finally:
            server.shutdown()

    def test_sampled_latent_follows_the_request_index(self, model, tmp_path):
        vp, up, _ = model
        server = serve_cli.build_server(
            self._args(tmp_path, "--latent", "sample", "--align_method", "nofix"),
            params=(bridge(vp), bridge(up)), configs=(T_TINY_VAE, T_TINY_UNET),
        )
        try:
            img = np.random.default_rng(1).integers(0, 255, (32, 32, 3), dtype=np.uint8)
            a, b = server.process_array(img), server.process_array(img)
            assert np.abs(a.astype(int) - b.astype(int)).max() > 0  # request 1 and 2 draw different noise
        finally:
            server.shutdown()

    def test_needs_parameters_and_a_prompt(self, model, tmp_path):
        vp, up, _ = model
        args = self._args(tmp_path)
        with pytest.raises(ValueError):
            serve_cli.build_server(args)
        args.prompt_npz = None
        with pytest.raises(NotImplementedError, match="load-path slice"):
            serve_cli.build_server(args, params=(bridge(vp), bridge(up)), configs=(T_TINY_VAE, T_TINY_UNET))
