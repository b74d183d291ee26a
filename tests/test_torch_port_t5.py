"""FLUX's prompt encoders in the port, on the CPU: the T5 encoder and its
position bias against the JAX package (f32, 1e-5), the porter and the config
reader on a directory written here (equal), the port's T5 tokenizer against
``tokenizers`` and transformers' ``T5TokenizerFast`` (the same ids) on a
synthetic vocabulary and many random prompts, the ``Precompiled`` charsmap
against ``tokenizers.normalizers.Precompiled`` (the same strings), and
``encode_prompt_flux`` against the JAX function on a tiny FLUX.1-dev
directory (f32 1e-5; the default bf16 T5 within 2 * 2^-7 of the largest
value: two bf16 steps at its magnitude, where both sides round every layer's
activations to bf16 in their own order)."""

import functools
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.convert import hf_config as JHF
from omgsr_tpu.convert import porters as JPORT
from omgsr_tpu.models import t5 as JT5
from omgsr_tpu_torch.cli.prompts import encode_prompt_flux
from omgsr_tpu_torch.convert import hf_config as HF
from omgsr_tpu_torch.convert import porters as PORT
from omgsr_tpu_torch.convert.params import init_t5_encoder, to_hf_state_dict
from omgsr_tpu_torch.models import t5 as TT5
from omgsr_tpu_torch.models.t5_tokenizer import Precompiled, T5Tokenizer, graphemes
from omgsr_tpu_torch.tools.flux_checkpoint import (
    nfkc_charsmap_rules,
    precompiled_charsmap,
    synthetic_unigram,
    t5_config_json,
    write_t5_tokenizer,
)
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import (
    TINY_T5_PIECES,
    assert_close,
    bridge,
    charsmap_rules,
    jax_init,
    jax_once,
    tiny_text_configs,
    write_tiny_flux_checkpoint,
)

TOL = 1e-5
_, _, J_T5, T_T5 = tiny_text_configs()


@pytest.fixture(scope="module")
def t5_tree():
    return jax_init(JT5.init_t5_encoder, 0, J_T5)


@pytest.mark.parametrize("seq,masked", [(7, False), (40, True)])
def test_t5_encode_and_position_bias_match_jax(t5_tree, seq, masked):
    """Both bucket regimes (exact below half the buckets, log-spaced beyond,
    clipped past max_distance 20) and a padding mask."""
    rng = np.random.default_rng(seq)
    ids = rng.integers(0, J_T5.vocab_size, (2, seq))
    mask = (np.arange(seq)[None] < np.array([[seq], [seq - 5]])).astype(np.int32) if masked else None
    params = bridge(t5_tree)
    assert_close(TT5.t5_position_bias(params, T_T5, seq), JT5.t5_position_bias(t5_tree, J_T5, seq), TOL, "bias")
    want = jax_once(lambda p, i, m: JT5.t5_encode(p, J_T5, i, m), t5_tree, jnp.asarray(ids),
                    None if mask is None else jnp.asarray(mask))
    got = TT5.t5_encode(params, T_T5, torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    assert_close(got, want, TOL, "t5_encode")


def test_t5_porter_config_and_init_match_the_jax_ones(t5_tree, tmp_path):
    """A text_encoder_2/ written here from the bridged tree (to_hf_state_dict
    and the embed_tokens alias): both porters read the same values, both
    config readers the same config, and the port's initialiser gives the
    JAX tree's structure."""
    from safetensors.torch import save_file

    state = to_hf_state_dict(bridge(t5_tree))
    state["encoder.embed_tokens.weight"] = state["shared.weight"].clone()
    save_file(state, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(t5_config_json(T_T5)))
    cfg, jcfg = HF.t5_config_from_json(str(tmp_path)), JHF.t5_config_from_json(str(tmp_path))
    assert cfg == T_T5 and {k: getattr(jcfg, k) for k in vars(cfg)} == vars(cfg)
    got = PORT.port_t5_encoder(str(tmp_path), cfg=cfg, dtype=torch.float32, device="cpu")
    assert PORT.port_t5_encoder(str(tmp_path), cfg=cfg, device="cpu")["shared"]["weight"].dtype == torch.bfloat16
    ref = bridge(JPORT.port_t5_encoder(str(tmp_path), cfg=jcfg, dtype=jnp.float32))
    assert set(flatten_dict(got)) == set(flatten_dict(ref))
    assert all(torch.equal(v, flatten_dict(ref)[p]) for p, v in flatten_dict(got).items())
    shapes = {p: tuple(v.shape) for p, v in flatten_dict(init_t5_encoder(0, cfg, device="meta")).items()}
    assert shapes == {p: tuple(v.shape) for p, v in flatten_dict(got).items()}
    with pytest.raises(ValueError, match="t5 port mismatch"):
        PORT.port_t5_encoder(str(tmp_path), cfg=type(cfg)(**{**vars(cfg), "num_layers": 3}), device="cpu")


# ----------------------------------------------------------------------------
# the tokenizer
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tokenizers_dir(tmp_path_factory):
    """tokenizer_2/ with a synthetic Unigram vocabulary and the NFKC-style
    charsmap of tools/flux_checkpoint.py, read by all three tokenizers."""
    from tokenizers import Tokenizer
    from transformers import T5TokenizerFast

    path = tmp_path_factory.mktemp("tokenizer_2")
    pieces = synthetic_unigram(2000, 3)
    write_t5_tokenizer(str(path), pieces, precompiled_charsmap(nfkc_charsmap_rules()))
    return (T5Tokenizer.from_pretrained(str(path)), Tokenizer.from_file(str(path / "tokenizer.json")),
            T5TokenizerFast.from_pretrained(str(path)), pieces)


def _prompts(seed, words, n):
    """Random prompts: vocabulary words, runs of spaces, tabs and newlines,
    characters the vocabulary lacks, full-width forms, ideographic spaces,
    combining marks, added tokens (and near misses), and prompts far past
    512 tokens."""
    r = random.Random(seed)
    odd = [chr(c) for c in [*range(0x21, 0x7F), *range(0xA0, 0x180), *range(0x300, 0x310), *range(0x2000, 0x2070),
                            *range(0x3000, 0x3040), *range(0xFF01, 0xFF5F), 0x01, 0x09, 0x0A, 0x0D, 0x200D, 0x1F600,
                            0x4E00, 0x9000, 0x0416, 0xAC00, 0x1F1E6]]
    out = []
    for i in range(n):
        parts = []
        for _ in range(r.randint(0, 30) if i % 50 else 700):
            k = r.random()
            if k < 0.5:
                parts.append(r.choice(words))
            elif k < 0.6:
                parts.append(r.choice([" ", "  ", "   ", "\t", "　", " \n "]))
            elif k < 0.7:
                parts.append(f"<extra_id_{r.randint(0, 105)}>")
            elif k < 0.75:
                parts.append(r.choice(["</s>", "<pad>", "<unk>", "<extra_id_", "<", "＜pad＞"]))
            else:
                parts.append("".join(r.choice(odd) for _ in range(r.randint(1, 5))))
            parts.append(" " if r.random() < 0.7 else "")
        out.append("".join(parts))
    return out + ["", " ", "  leading and trailing  ", "\t\n"]


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenizer_matches_tokenizers_and_transformers(tokenizers_dir, seed):
    ours, ref, fast, pieces = tokenizers_dir
    words = [p.lstrip("▁") for p, _ in pieces[3:] if len(p) > 2]
    prompts = _prompts(seed, words, 300)
    assert max(len(ours.encode(p)) for p in prompts) > 1000  # past 512 tokens
    for p in prompts:
        got = ours.encode_padded(p, 512)
        assert got == fast(p, max_length=512, padding="max_length", truncation=True).input_ids, repr(p)
        assert ours.encode(p) + [1] == ref.encode(p).ids, repr(p)
    assert ours(prompts[:2], max_length=512).shape == (2, 512)
    assert ours.encode("<extra_id_0> <extra_id_99>") == [len(pieces) + 99, len(pieces)]


def test_precompiled_charsmap_matches_tokenizers():
    """The charsmap of torch_port_helpers.charsmap_rules: replacements of one
    character and of a base letter with combining marks, a plain letter
    mapped (a grapheme that starts with it is replaced whole, by its shortest
    matching prefix, when it is shorter than 6 bytes), a deletion."""
    from tokenizers import normalizers

    blob = precompiled_charsmap(charsmap_rules())
    ours, ref = Precompiled(blob), normalizers.Precompiled(list(blob))
    r = random.Random(5)
    pool = [*map(chr, [*range(0x61, 0x7B), *range(0xFF10, 0xFF1A), *range(0xFF21, 0xFF5B), 0x300, 0x301, 0x308,
                       0x3000, 0x2002, 0xA0, 0xFB01, 0x09, 0x07, 0x0D, 0x0A, 0x200D, 0xAC00, 0x1100, 0x1161, 0x11A8]),
            "é", "q́", "ḱ́", "ḱ́́"]
    cases = ["".join(r.choice(pool) for _ in range(r.randint(1, 12))) for _ in range(2000)]
    for s in cases + ["q́z", "é́́", "\r\n", "\U0001F1E6\U0001F1E7"]:
        assert ours(s) == ref.normalize_str(s), ascii(s)
    assert graphemes("éx\r\n각") == ["é", "x", "\r\n", "각"]


def test_tokenizer_refuses_what_it_cannot_read(tmp_path):
    pieces = synthetic_unigram(50, 0)
    write_t5_tokenizer(str(tmp_path), pieces, precompiled_charsmap({"a": "b"}))
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    for where, value, what in (("normalizer", {"type": "NFKD"}, "normalizer type"),
                               ("normalizer", {"type": "Replace", "pattern": {"String": "a"}, "content": "b"},
                                "normalizer type"),
                               ("pre_tokenizer", {"type": "WhitespaceSplit"}, "pre-tokenizer type"),
                               ("pre_tokenizer", None, "pre-tokenizer type"),
                               ("pre_tokenizer", {"type": "Metaspace", "prepend_scheme": "first"}, "prepend_scheme"),
                               ("post_processor", {"type": "BertProcessing"}, "post-processor type")):
        with pytest.raises(NotImplementedError, match=what):
            T5Tokenizer({**spec, where: value})
    with pytest.raises(NotImplementedError, match="model type"):
        T5Tokenizer({**spec, "model": {"type": "BPE"}})
    for option in ("lstrip", "normalized"):
        with pytest.raises(NotImplementedError, match="added token options"):
            T5Tokenizer({**spec, "added_tokens": [{**spec["added_tokens"][0], option: True}]})


# ----------------------------------------------------------------------------
# encode_prompt_flux on a tiny FLUX.1-dev directory
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flux_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_flux_text")
    write_tiny_flux_checkpoint(root)
    return root


@pytest.fixture
def t5_in(monkeypatch):
    """The JAX function reads FLUX_CLIP_L / FLUX_T5_XXL, not the directory's
    config.json: hand it the tiny ones. ``t5_in(dtype)``: both packages' T5
    porters default to that dtype (bf16 as published)."""
    import omgsr_tpu.convert as JCONV
    import omgsr_tpu.models.configs as JCFG

    jclip, _, jt5, _ = tiny_text_configs()
    monkeypatch.setattr(JCFG, "FLUX_CLIP_L", jclip)
    monkeypatch.setattr(JCFG, "FLUX_T5_XXL", jt5)
    real, port_real = JCONV.port_t5_encoder, PORT.port_t5_encoder

    def use(jdtype, dtype):
        monkeypatch.setattr(JCONV, "port_t5_encoder", functools.partial(real, dtype=jdtype))
        monkeypatch.setattr(PORT, "port_t5_encoder", functools.partial(port_real, dtype=dtype))

    return use


def test_encode_prompt_flux_matches_jax(flux_dir, t5_in):
    from omgsr_tpu.cli.prompts import encode_prompt_flux as j_encode

    t5_in(jnp.float32, torch.float32)
    prompts = ["", "a photo of a cat ｗｉｔｈ　full-width words", "</s> <extra_id_3> x" * 90]
    for prompt in prompts:
        want = j_encode(str(flux_dir), prompt, dtype=jnp.float32)
        got = encode_prompt_flux(str(flux_dir), prompt, dtype=torch.float32, device="cpu")
        assert got[0].shape == (1, 512, 16) and got[1].shape == (1, 8) and got[2].shape == (512, 3)
        for g, w, what in zip(got, want, ("prompt_embeds", "pooled", "txt_ids")):
            assert_close(g, w, TOL, f"{what} of {prompt[:20]!r}")
    # the default: T5 in bf16 on both sides, within two bf16 steps of the largest value (2 * 2^-7 of it)
    t5_in(jnp.bfloat16, torch.bfloat16)
    want = np.asarray(j_encode(str(flux_dir), prompts[1], dtype=jnp.float32)[0])
    got = encode_prompt_flux(str(flux_dir), prompts[1], dtype=torch.float32, device="cpu")[0].numpy()
    assert np.abs(got - want).max() <= 2 * 2.0**-7 * np.abs(want).max()
    ids = T5Tokenizer.from_pretrained(str(flux_dir / "tokenizer_2"))(prompts[1])
    assert ids.shape == (1, 512) and int(ids.max()) < TINY_T5_PIECES + 100
