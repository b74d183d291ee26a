"""CLIP text encoder (transformers CLIPTextModel layout).

SD2.1's OpenCLIP ViT-H text tower (hidden 1024, 23 layers, exact GELU)
encodes the prompt that conditions the UNet (train/train_omgsr_s.py:172-199,
infer/infer_omgsr_s.py:24-42). Parameter paths mirror the HF keys under
``text_model.*``; the embedding tables stay (rows, width) as HF stores them.
Attention is causal (each position attends to itself and the ones before
it): the JAX package computes it with ``jax.nn.dot_product_attention(
is_causal=True)`` beside its kernel dispatch, and here it goes to
``ops/attention.matmul_attention`` with a causal bias, since the flash kernel
takes no mask. The pooled output is the final-layer-norm hidden state at
each sequence's first EOS token. FLUX's CLIP-L (``configs.FLUX_CLIP_L``,
quick GELU) gives the pooled embedding of OMGSR-F (``cli/prompts.
encode_prompt_flux``).
"""

from __future__ import annotations

import torch

from omgsr_tpu_torch.convert.params import _Init
from omgsr_tpu_torch.models.configs import CLIPTextConfig
from omgsr_tpu_torch.models.layers import dense, gelu, layer_norm
from omgsr_tpu_torch.ops.attention import matmul_attention


def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: gelu(x, approximate=False)


def init_clip_text(seed, cfg: CLIPTextConfig, dtype=torch.float32, device="cuda"):
    """Random CLIPTextModel parameters with the HF tree structure: embeddings
    N(0, 0.02), dense layers torch's default, norms 1 / 0."""
    it = _Init(seed, dtype, device)
    d = cfg.hidden_size

    def layer():
        return {
            "layer_norm1": it.norm(d),
            "self_attn": {name: it.dense(d, d) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": it.norm(d),
            "mlp": {"fc1": it.dense(d, cfg.intermediate_size), "fc2": it.dense(cfg.intermediate_size, d)},
        }

    return {
        "text_model": {
            "embeddings": {
                "token_embedding": {"weight": it.normal((cfg.vocab_size, d), 0.02)},
                "position_embedding": {"weight": it.normal((cfg.max_position_embeddings, d), 0.02)},
            },
            "encoder": {"layers": {str(i): layer() for i in range(cfg.num_hidden_layers)}},
            "final_layer_norm": it.norm(d),
        }
    }


def causal_bias(s: int, device) -> torch.Tensor:
    """(1, 1, s, s) f32: 0 where a query may attend to a key, -inf above the diagonal."""
    return torch.full((s, s), float("-inf"), device=device).triu(1)[None, None]


def _attn(p, x, heads, bias):
    b, s, d = x.shape
    hd = d // heads
    q = dense(p["q_proj"], x).reshape(b, s, heads, hd)
    k = dense(p["k_proj"], x).reshape(b, s, heads, hd)
    v = dense(p["v_proj"], x).reshape(b, s, heads, hd)
    o = matmul_attention(q, k, v, bias=bias, scale=hd**-0.5)
    return dense(p["out_proj"], o.reshape(b, s, d))


def clip_text_apply(params, cfg: CLIPTextConfig, input_ids):
    """input_ids (B, S) integers -> (last_hidden_state (B, S, D), pooled (B, D))."""
    tm = params["text_model"]
    act = _act(cfg.hidden_act)
    emb = tm["embeddings"]
    input_ids = torch.as_tensor(input_ids, device=emb["token_embedding"]["weight"].device).long()
    x = emb["token_embedding"]["weight"][input_ids]
    x = x + emb["position_embedding"]["weight"][None, : x.shape[1]]
    bias = causal_bias(x.shape[1], x.device)

    for i in sorted(tm["encoder"]["layers"], key=int):
        lp = tm["encoder"]["layers"][i]
        h = layer_norm(lp["layer_norm1"], x, cfg.layer_norm_eps)
        x = x + _attn(lp["self_attn"], h, cfg.num_attention_heads, bias)
        h = layer_norm(lp["layer_norm2"], x, cfg.layer_norm_eps)
        x = x + dense(lp["mlp"]["fc2"], act(dense(lp["mlp"]["fc1"], h)))

    x = layer_norm(tm["final_layer_norm"], x, cfg.layer_norm_eps)
    # pooled = hidden state at the first EOS token of each sequence (transformers' semantics)
    eos_idx = (input_ids == cfg.eos_token_id).int().argmax(dim=1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eos_idx]
    return x, pooled
