"""``POST /v1/reload`` of the port's ``serve`` on the CPU, as
tests/test_serving.py holds the JAX server's: a served tiny SD2.1 checkpoint
(``torch_port_helpers.write_tiny_checkpoint``) hot-swaps to a second adapter
written by the JAX package's writer, and the output changes to what a server
built on that adapter gives, to the uint8 (the build path is held to the JAX
package in tests/test_torch_port_cli.py); unknown fields and an unusable
``lora_path`` are refused with 400, the latter restoring the committed model
exactly; requests that arrive during a rebuild fail fast with 502."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from omgsr_tpu.lora import SD_TARGET_MODULES
from omgsr_tpu.lora import save_adapter as jax_save_adapter
from omgsr_tpu_torch.cli import serve
from tests.torch_port_helpers import jax_lora_tree, write_tiny_checkpoint


def _png(h=8, w=8, seed=0):
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, timeout=60):
    """(status, body bytes) of one POST."""
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny directory, and a second adapter pair (B != 0) beside it."""
    root = tmp_path_factory.mktemp("tiny_sd_reload")
    trees = write_tiny_checkpoint(root)
    lora2 = root / "lora2"
    for name, tree in (("vae_encoder_lora_adapter", jax_lora_tree(trees["vae"]["encoder"], 2, 11)),
                       ("unet_lora_adapter", jax_lora_tree(trees["unet"], 2, 12))):
        jax_save_adapter(tree, str(lora2 / name), rank=2, targets=SD_TARGET_MODULES)
    return root, lora2


def _args(root, lora):
    return serve.parse_args(["--sd_path", str(root), "--lora_path", str(lora), "--prompt_npz",
                             str(root / "prompt.npz"), "--process_size", "64", "--upscale", "4", "--weight_dtype",
                             "fp32", "--device", "cpu", "--port", "0", "--align_method", "nofix",
                             "--latent", "mean"])  # deterministic: only the model changes the output


class _Served:
    def __init__(self, args):
        self.args = args
        self.server, self.httpd = serve.main(args, serve_forever=False)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.base = "http://%s:%d" % self.httpd.server_address[:2]

    def sr(self):
        code, body = _post(f"{self.base}/v1/sr", _png())
        assert code == 200, body[:300]
        return np.asarray(Image.open(io.BytesIO(body))).astype(int)

    def reload(self, fields):
        code, body = _post(f"{self.base}/v1/reload", json.dumps(fields).encode())
        return code, json.loads(body)


@pytest.fixture(scope="module")
def served(ckpt):
    root, _ = ckpt
    s = _Served(_args(root, root / "lora"))
    yield s
    s.server.shutdown()


@pytest.fixture(scope="module")
def swapped(ckpt, served):
    """The image before and after reloading the second adapter."""
    _, lora2 = ckpt
    before = served.sr()
    np.testing.assert_array_equal(before, served.sr())
    code, reply = served.reload({"lora_path": str(lora2)})
    assert (code, reply) == (200, {"status": "reloaded", "lora_path": str(lora2)})
    return before, served.sr()


def test_reload_hot_swaps_the_adapter(ckpt, served, swapped):
    root, lora2 = ckpt
    before, after = swapped
    assert np.abs(before - after).mean() > 0.5
    assert served.args.lora_path == str(lora2)  # committed on success
    fresh = _Served(_args(root, lora2))
    try:
        np.testing.assert_array_equal(after, fresh.sr())
    finally:
        fresh.server.shutdown()


@pytest.mark.parametrize("fields", [{"sd_path": "/x"}, {"lora_path": "/x", "process_size": 128}])
def test_reload_refuses_unknown_fields(served, swapped, fields):
    code, reply = served.reload(fields)
    assert code == 400 and "unknown reload fields" in reply["error"], reply
    np.testing.assert_array_equal(served.sr(), swapped[1])


@pytest.mark.parametrize("fields", [{"lora_path": "/nowhere"}, {"mid_timestep": "nope"}])
def test_failed_rebuild_restores_the_committed_model(ckpt, served, swapped, fields):
    code, reply = served.reload(fields)
    assert code == 400, reply
    np.testing.assert_array_equal(served.sr(), swapped[1])
    assert served.args.lora_path == str(ckpt[1]) and served.args.mid_timestep == 273  # not poisoned


def test_requests_during_a_rebuild_fail_fast_with_502(ckpt, served, swapped, monkeypatch):
    """A rebuild held open: a request meanwhile gets 502 at once, and the
    server answers as before once the rebuild ends."""
    started, release = threading.Event(), threading.Event()
    build = serve._pipeline_s

    def slow_build(*a, **kw):
        started.set()
        release.wait(60)
        return build(*a, **kw)

    monkeypatch.setattr(serve, "_pipeline_s", slow_build)
    result = {}
    t = threading.Thread(target=lambda: result.update(reply=served.reload({"lora_path": str(ckpt[1])})))
    t.start()
    try:
        assert started.wait(60)
        code, body = _post(f"{served.base}/v1/sr", _png(), timeout=30)
        assert code == 502 and b"reloading" in body, body[:300]
    finally:
        release.set()
        t.join(60)
    assert result["reply"][0] == 200
    np.testing.assert_array_equal(served.sr(), swapped[1])
