"""The port's CLIP text encoder against the JAX package's, on shared numpy
weights (f32, 1e-5 on the hidden states and the pooled state), and its
tokenizer against transformers' CLIPTokenizer on files written here (the
ids equal on every prompt)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.models import clip_text as JC
from omgsr_tpu.models.configs import CLIPTextConfig as JCLIPTextConfig
from omgsr_tpu_torch.cli.prompts import encode_prompt_sd
from omgsr_tpu_torch.models import clip_text as C
from omgsr_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from omgsr_tpu_torch.models.configs import CLIPTextConfig
from omgsr_tpu_torch.tools.sd_checkpoint import synthetic_bpe, write_tokenizer
from tests.torch_port_helpers import TINY_CLIP_KW, assert_close, bridge, jax_init, jax_once, write_tiny_checkpoint

TOL = 1e-5


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_apply_matches_jax(act):
    kw = dict(TINY_CLIP_KW, hidden_act=act)
    jcfg, cfg = JCLIPTextConfig(**kw), CLIPTextConfig(**kw)
    jp = jax_init(JC.init_clip_text, 7, jcfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size - 2, (3, 77)).astype(np.int32)
    # BOS, then EOS at different places; the second row also holds EOS twice (the first one pools)
    ids[:, 0] = cfg.eos_token_id - 1
    for row, at in enumerate((5, 40, 76)):
        ids[row, at:] = 0
        ids[row, at] = cfg.eos_token_id
    ids[1, 60] = cfg.eos_token_id
    hidden_j, pooled_j = jax_once(lambda p, i: JC.clip_text_apply(p, jcfg, i), jp, jnp.asarray(ids))
    hidden, pooled = C.clip_text_apply(bridge(jp), cfg, torch.from_numpy(ids))
    assert_close(hidden, hidden_j, TOL, "hidden")
    assert_close(pooled, pooled_j, TOL, "pooled")
    assert np.abs(np.asarray(hidden_j)).max() > 0.5  # not a trivially small state


def test_attention_is_causal():
    """A later token changes no earlier position's state."""
    cfg = CLIPTextConfig(**TINY_CLIP_KW)
    params = C.init_clip_text(0, cfg, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (1, 12), generator=torch.Generator().manual_seed(0))
    other = ids.clone()
    other[0, 8:] = (other[0, 8:] + 1) % cfg.vocab_size
    a, _ = C.clip_text_apply(params, cfg, ids)
    b, _ = C.clip_text_apply(params, cfg, other)
    assert torch.equal(a[:, :8], b[:, :8]) and not torch.allclose(a[:, 8:], b[:, 8:])
    meta = C.init_clip_text(0, dataclasses.replace(cfg, num_hidden_layers=23), device="meta")
    assert len(meta["text_model"]["encoder"]["layers"]) == 23


PROMPTS = {
    "empty": "",
    "ascii": "a photo of a cat sitting on a red sofa",
    "punctuation": "Hello, World! It's a dog's life; they'll (maybe) re-run it... ok?!",
    "digits": "1234 apples and 56.7% of 89, at 10:30pm",
    "accents": "café naïve résumé Ünïcödé ñandú Ångström",
    "numerals": "x² ½ Ⅻ ٣ ① ١٢٣",
    "underscores": "foo_bar__baz snake_case",
    "special tokens": "<|endoftext|> inside <|startoftext|> text",
    "pad token inside": "hello!!  !wow!",
    "cjk": "日本語のテキスト 中文 한국어",
    "whitespace and controls": "tab\tnew\nline\r end\x00\x07 zero​width",
    "contractions": "don't I'M WE'RE you'VE she'd we'll",
    "emoji": "emoji 😀 🐱‍👤 ✨",
    "over-long": " ".join(["wordy"] * 120),
    "over-long unbroken": "A" * 400,
}


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    from transformers import CLIPTokenizer as HFTokenizer

    out = {}
    for pad in ("!", "<|endoftext|>"):
        d = tmp_path_factory.mktemp("tokenizer")
        write_tokenizer(str(d), *synthetic_bpe(3000, seed=1), pad_token=pad)
        out[pad] = (CLIPTokenizer.from_pretrained(str(d)), HFTokenizer.from_pretrained(str(d)))
    return out


@pytest.mark.parametrize("name", list(PROMPTS))
def test_tokenizer_gives_transformers_ids(tokenizers, name):
    prompt = PROMPTS[name]
    for pad, (ours, ref) in tokenizers.items():
        want = ref(prompt, max_length=ref.model_max_length, padding="max_length", truncation=True).input_ids
        got = ours(prompt, max_length=ours.model_max_length)
        assert got.dtype == torch.int64 and got.shape == (1, 77)
        assert got[0].tolist() == want, (pad, name)


def test_pad_token_comes_from_the_files(tokenizers):
    sd21, ref = tokenizers["!"]
    assert (sd21.pad_token_id, sd21.bos_token_id, sd21.eos_token_id) == (0, 512 + 3000, 512 + 3001)
    assert ref.pad_token_id == 0 and sd21.model_max_length == ref.model_max_length == 77
    ids = sd21("a cat")[0].tolist()
    assert ids[0] == sd21.bos_token_id and ids.count(sd21.eos_token_id) == 1 and ids[-1] == 0
    other, _ = tokenizers["<|endoftext|>"]
    assert other.pad_token_id == other.eos_token_id and other("a cat")[0].tolist()[-3:] == [other.eos_token_id] * 3


def test_encode_prompt_sd_reads_the_checkpoint(tmp_path):
    """The tokenizer and text encoder of a checkpoint directory, through the
    port's CLI function, against the JAX text encoder on the same ids."""
    trees = write_tiny_checkpoint(tmp_path)
    jcfg = JCLIPTextConfig(**TINY_CLIP_KW)
    ids = CLIPTokenizer.from_pretrained(str(tmp_path / "tokenizer"))("A photo, of cats!").numpy().astype(np.int32)
    want, _ = jax_once(lambda p, i: JC.clip_text_apply(p, jcfg, i), trees["clip"], jnp.asarray(ids))
    got = encode_prompt_sd(str(tmp_path), "A photo, of cats!", torch.float32, device="cpu")
    assert got.shape == (1, 77, 16) and got.dtype == torch.float32
    assert_close(got, want, TOL, "prompt embeddings")
    bf16 = encode_prompt_sd(str(tmp_path), "A photo, of cats!", torch.bfloat16, device="cpu")
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, got.to(torch.bfloat16))
    with pytest.raises(RuntimeError, match="cuda"):
        encode_prompt_sd(str(tmp_path), "x")
